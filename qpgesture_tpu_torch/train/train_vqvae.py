"""VQ-VAE trainer: one GPU, or data-parallel over a process group.

The reference trains with Adam(3e-5, betas (0.5, 0.999)) + MultiStepLR
([100, 200] epochs, gamma 0.1), batch 256 and best-validation
checkpointing (codebook/train.py:53-148); the JAX package's
``train/train_vqvae.py`` does the same as one jitted data-parallel step.
Here a step is the model's training forward (whose EMA codebook update
runs in place), one backward and one Adam update, with the learning rate
set from the update count exactly as optax's
``piecewise_constant_schedule`` at the boundaries m * steps_per_epoch.
A step reads nothing back to the host: losses and metrics stay 0-d device
tensors, and ``fit`` reads them only every ``log_every`` steps. Its
convolutions run under ``device.cudnn_autotune``.

Data-parallel over a torch.distributed group (the JAX package's shard_map
step over the 'data' mesh axis, train_vqvae.py:79-124): every rank holds
the same model and takes its contiguous block of each batch; the gradients,
the loss and the metrics are averaged across the group (all_reduce, then
divided by the world size) and the EMA codebook update sums its batch
statistics and gathers its restart pool across it, so every rank applies
the same update. The data-parallel width is the group's world size; a
``TrainConfig.mesh_shape`` that says otherwise raises. Only rank 0 writes
checkpoints and the scalar history.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig, VQVAEConfig
from ..device import DeviceLike, cudnn_autotune, resolve_device, to_device
from ..models import bottleneck as bn
from ..models.vqvae import VQVAE, eval_pose_error
from ..parallel import dist
from ..parallel.dist import (broadcast, data_parallel_group, local_block,
                             pmean)
from .checkpoints import Checkpointed, save_checkpoint


def lr_at(cfg: TrainConfig, steps_per_epoch: int, step: int) -> float:
    """MultiStepLR at epoch milestones (train.py:85) by update count: the
    value of optax.piecewise_constant_schedule(lr, {m * steps_per_epoch:
    gamma}) at ``step``, a scale applying from its boundary on."""
    boundaries = {int(m) * steps_per_epoch: cfg.gamma
                  for m in cfg.milestones}
    lr = cfg.lr
    for boundary, scale in boundaries.items():
        if step >= boundary:
            lr *= scale
    return lr


def seeded_init(build, seed: int):
    """build() under torch's global generator seeded with ``seed``, the
    caller's generator state left as it was: the same seed gives the same
    weights on every device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def average_gradients(params: List[torch.Tensor], group) -> None:
    """Replace each parameter's gradient by its mean across ``group`` (one
    all_reduce of all of them); a parameter without one counts as zero."""
    if group is None:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p, g in zip(params, pmean(grads, group)):
        p.grad = g


class DataParallel:
    """What the data-parallel trainers share: ``group`` (None in a world of
    one) and ``rank``, this rank's block of a batch, and rank 0's duty of
    writing files."""

    group = None
    rank = 0

    def set_group(self, group) -> None:
        self.group = group
        self.rank = 0 if group is None else dist.rank(group)

    def shard(self, batch):
        """This rank's contiguous block of a host batch (arrays, tensors or
        tuples of them): P('data')'s split. Raises when the batch does not
        divide by the world size."""
        if self.group is None:
            return batch
        if isinstance(batch, tuple):
            return tuple(local_block(b, self.group) for b in batch)
        return local_block(batch, self.group)

    @property
    def writes(self) -> bool:
        return self.rank == 0


class VQVAETrainer(DataParallel, Checkpointed):
    """Owns the model (on ``device``), the Adam optimizer, the update count
    and the generator that draws dead-code restarts (in the same state on
    every rank). ``group``: the process group to train data-parallel over
    (None: the default group, or one device outside any group)."""

    def __init__(self, model_cfg: VQVAEConfig, train_cfg: TrainConfig,
                 steps_per_epoch: int = 1, device: DeviceLike = "cuda",
                 seed: int = 0, group=None):
        self.set_group(data_parallel_group(group, train_cfg.mesh_shape))
        self.device = resolve_device(device)
        self.cfg = train_cfg
        self.steps_per_epoch = steps_per_epoch
        self.model = seeded_init(lambda: VQVAE(model_cfg, device="cpu"),
                                 seed).to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=train_cfg.lr,
                                    betas=tuple(train_cfg.betas), eps=1e-8)
        self.model.codebook_block.group = self.group
        self.step = 0

    # -- state ----------------------------------------------------------------
    @torch.no_grad()
    def init_codebook(self, batch) -> None:
        """Data-dependent codebook init from the first batch (init_k,
        bottleneck.py:39-49), drawn on the device. Data-parallel: every rank
        draws from the whole batch and takes rank 0's draw, so the replicas
        start equal to the bit."""
        h = self.model.encoders[0](self._input(batch))
        k, k_sum, k_elem = bn.init_codebook(
            h.reshape(-1, h.shape[-1]), self.model.cfg.l_bins, self.generator)
        if self.group is not None:
            k = broadcast(k, 0, self.group)
            k_sum = k.clone()
        self.model.codebook_block.set_state(k, k_sum, k_elem)

    def module_state(self, attr: str) -> Dict[str, torch.Tensor]:
        """The model under the reference's names, with the codebook's EMA
        statistics."""
        block = self.model.codebook_block
        return {**self.model.state_dict(),
                "bottleneck.level_blocks.0.k_sum": block.k_sum,
                "bottleneck.level_blocks.0.k_elem": block.k_elem}

    # -- steps ----------------------------------------------------------------
    def _input(self, batch) -> torch.Tensor:
        return to_device(batch, self.device, torch.float32)

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict]:
        """One update on a whole batch (this rank takes its block of it).
        Returns (loss, metrics) as device tensors, averaged across the
        group; the parameters' ``.grad`` hold this step's averaged
        gradients afterwards."""
        return self.train_block(self.shard(batch))

    def train_block(self, block) -> Tuple[torch.Tensor, Dict]:
        """train_step on this rank's block of the batch (the whole batch
        on one device)."""
        with cudnn_autotune():
            _, loss, metrics = self.model(self._input(block), train=True,
                                          generator=self.generator)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        if self.group is not None:
            average_gradients(list(self.model.parameters()), self.group)
            names = list(metrics)
            loss, *values = pmean([loss.detach(),
                                   *(metrics[k] for k in names)], self.group)
            metrics = dict(zip(names, values))
        lr = lr_at(self.cfg, self.steps_per_epoch, self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return loss.detach(), metrics

    @torch.no_grad()
    def eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, mean per-joint error) of the eval forward, averaged over
        the ranks' blocks of the batch."""
        x = self._input(self.shard(batch))
        x_out, loss, _ = self.model(x, train=False)
        err = eval_pose_error(x, x_out, self.model.cfg.joint_channel)
        loss, err = pmean([loss, err], self.group) \
            if self.group is not None else (loss, err)
        return loss, err

    # -- loop -----------------------------------------------------------------
    def fit(self, train_batches: Iterable, val_batches: Optional[Iterable]
            = None, epochs: Optional[int] = None, log_every: int = 50,
            checkpoint_dir: Optional[str] = None,
            history_path: Optional[str] = None, start_epoch: int = 1,
            initial_best: Optional[Tuple[float, int]] = None
            ) -> Tuple[float, int]:
        """The JAX package's epoch loop (train_vqvae.py:133-215): validate at
        each epoch's start and once after the last; save ``best`` on a better
        val_err, ``latest`` after every epoch and ``{epoch:03d}`` every
        save_per_epochs; the loss (and its non-finite check) and the metrics
        read on the host every ``log_every`` steps; the scalar history in
        <checkpoint_dir>/scalars.jsonl by default. ``initial_best`` (the prior
        (val_err, epoch)) keeps a resumed run from overwriting ``best`` with
        a worse epoch. Data-parallel: every rank runs the loop on its blocks
        of the same batches and reaches the same numbers; rank 0 alone
        writes. Returns the best (val_err, epoch)."""
        from ..utils.metrics_log import ScalarHistory
        from .data import device_prefetch

        best = initial_best if initial_best is not None else (float("inf"), 0)
        epochs = epochs or self.cfg.epochs
        if history_path is None and checkpoint_dir:
            history_path = os.path.join(checkpoint_dir, "scalars.jsonl")
        hist = ScalarHistory(history_path) \
            if history_path and self.writes else None
        checkpoint_dir = checkpoint_dir if self.writes else None

        def validate(epoch):
            nonlocal best
            errs = torch.stack([self.eval_step(b)[1] for b in val_batches])
            val_err = float(errs.mean())
            if val_err < best[0]:
                best = (val_err, epoch)
                if checkpoint_dir:
                    save_checkpoint(checkpoint_dir, self.state_dict(epoch),
                                    name="best")
            logging.info("epoch %d val_err %.5f (best %.5f @ %d)",
                         epoch, val_err, best[0], best[1])
            if hist:
                hist.log(epoch=epoch, val_err=val_err, best_val_err=best[0])

        try:
            for epoch in range(start_epoch, epochs + 1):
                if val_batches is not None:
                    validate(epoch)
                for bi, block in enumerate(device_prefetch(
                        map(self.shard, train_batches), self.device)):
                    loss, metrics = self.train_block(block)
                    if bi % log_every == 0:
                        loss_v = float(loss)
                        if not np.isfinite(loss_v):
                            raise FloatingPointError(
                                f"non-finite loss at epoch {epoch} step {bi}")
                        logging.info("epoch %d step %d loss %.5f", epoch, bi,
                                     loss_v)
                        if hist:
                            hist.log(epoch=epoch, step=bi, loss=loss_v,
                                     **{k: float(v)
                                        for k, v in metrics.items()})
                if checkpoint_dir:
                    state = self.state_dict(epoch)
                    save_checkpoint(checkpoint_dir, state, name="latest")
                    if epoch % self.cfg.save_per_epochs == 0:
                        save_checkpoint(checkpoint_dir, state,
                                        name=f"{epoch:03d}")
            if val_batches is not None:
                validate(epochs + 1)
        finally:
            if hist:
                hist.close()
        return best
