"""VQ-VAE trainer on one GPU.

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

One device: a ``TrainConfig.mesh_shape`` of more than one device raises.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig, VQVAEConfig
from ..device import DeviceLike, cudnn_autotune, resolve_device, to_device
from ..models import bottleneck as bn
from ..models.vqvae import VQVAE, eval_pose_error
from .checkpoints import Checkpointed, save_checkpoint


def check_one_device(mesh_shape) -> None:
    if mesh_shape is not None and math.prod(mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape={tuple(mesh_shape)}: multi-GPU data parallelism is "
            "not ported yet (one GPU only)")


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


class VQVAETrainer(Checkpointed):
    """Owns the model (on ``device``), the Adam optimizer, the update count
    and the generator that draws dead-code restarts."""

    def __init__(self, model_cfg: VQVAEConfig, train_cfg: TrainConfig,
                 steps_per_epoch: int = 1, device: DeviceLike = "cuda",
                 seed: int = 0):
        check_one_device(train_cfg.mesh_shape)
        self.device = resolve_device(device)
        self.cfg = train_cfg
        self.steps_per_epoch = steps_per_epoch
        self.model = seeded_init(lambda: VQVAE(model_cfg, device="cpu"),
                                 seed).to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=train_cfg.lr,
                                    betas=tuple(train_cfg.betas), eps=1e-8)
        self.step = 0

    # -- state ----------------------------------------------------------------
    @torch.no_grad()
    def init_codebook(self, batch) -> None:
        """Data-dependent codebook init from the first batch (init_k,
        bottleneck.py:39-49), drawn on the device."""
        h = self.model.encoders[0](self._input(batch))
        self.model.codebook_block.set_state(*bn.init_codebook(
            h.reshape(-1, h.shape[-1]), self.model.cfg.l_bins,
            self.generator))

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
        """One update. Returns (loss, metrics) as device tensors; the
        parameters' ``.grad`` hold this step's gradients afterwards."""
        with cudnn_autotune():
            _, loss, metrics = self.model(self._input(batch), train=True,
                                          generator=self.generator)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        lr = lr_at(self.cfg, self.steps_per_epoch, self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return loss.detach(), metrics

    @torch.no_grad()
    def eval_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, mean per-joint error) of the eval forward."""
        x = self._input(batch)
        x_out, loss, _ = self.model(x, train=False)
        return loss, eval_pose_error(x, x_out, self.model.cfg.joint_channel)

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
        a worse epoch. Returns the best (val_err, epoch)."""
        from ..utils.metrics_log import ScalarHistory
        from .data import device_prefetch

        best = initial_best if initial_best is not None else (float("inf"), 0)
        epochs = epochs or self.cfg.epochs
        if history_path is None and checkpoint_dir:
            history_path = os.path.join(checkpoint_dir, "scalars.jsonl")
        hist = ScalarHistory(history_path) if history_path else None

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
                for bi, batch in enumerate(device_prefetch(train_batches,
                                                           self.device)):
                    loss, metrics = self.train_step(batch)
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
