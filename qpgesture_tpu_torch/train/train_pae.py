"""PAE trainer: AdamW + cosine warm restarts on velocity windows, on one GPU
or data-parallel over a process group.

The reference envelope (codebook/PAE.py:273-474), as the JAX package's
``train/train_pae.py`` sets it: AdamW(1e-4, weight decay 1e-4),
CyclicLRWithRestarts (cosine, restart period 10 epochs, t_mult 2), MSE x 300
on frame-difference velocity windows. torch's AdamW decays decoupled from
the pre-update parameter, p - lr * (adam + wd * p) as optax.adamw does;
the learning rate is set each update from the update count. The
BatchNorms (``models/batchnorm``) update their running statistics in
training as flax's do. A step reads nothing back to the host; its
convolutions run under ``device.cudnn_autotune``.

Data-parallel as the JAX trainer (train_pae.py:77-105): each rank takes
its contiguous block of the batch, and its BatchNorms normalise with that
block's statistics (the JAX step runs flax's BatchNorm per shard, without
an axis name); the gradients and the loss are averaged across the group,
and so are the running statistics after the step.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..core.config import PAEConfig
from ..device import DeviceLike, cudnn_autotune, resolve_device, to_device
from ..models.batchnorm import average_running_stats
from ..models.pae import PAE, velocity_input
from ..parallel.dist import data_parallel_group, pmean
from .checkpoints import Checkpointed
from .train_vqvae import DataParallel, average_gradients, seeded_init


def cyclic_cosine_restarts(base_lr: float, steps_per_epoch: int,
                           restart_period: int = 10, t_mult: float = 2.0,
                           n_cycles: int = 8) -> Callable[[int], float]:
    """CyclicLRWithRestarts(policy='cosine') by update count, as the JAX
    package builds it from optax: ``n_cycles`` cosine decays
    (lr = base * 0.5 * (1 + cos(pi * t / period)), reaching 0 at the end of
    a period and holding it), joined at boundaries whose periods grow by
    t_mult (Library/AdamWR/cyclic_scheduler.py:48). Computed in float64;
    optax's float32 values differ by rounding only."""
    starts, decays = [], []
    start, period = 0, restart_period * steps_per_epoch
    for _ in range(n_cycles):
        starts.append(start)
        decays.append(max(period, 1))
        start += period
        period = int(period * t_mult)

    def schedule(step: int) -> float:
        i = max(j for j, s in enumerate(starts) if j == 0 or step >= s)
        t = min(step - (starts[i] if i else 0), decays[i])
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decays[i]))

    return schedule


def pae_loss(model: PAE, pose_windows: torch.Tensor) -> torch.Tensor:
    """loss_weight * mean((y - x)^2) on the velocity input."""
    x = velocity_input(pose_windows)
    y = model(x)[0]
    return model.cfg.loss_weight * ((y - x) ** 2).mean()


class PAETrainer(DataParallel, Checkpointed):
    """Owns the PAE (on ``device``), AdamW and the update count. ``group``:
    the process group to train data-parallel over (None: the default group,
    or one device outside any group)."""

    def __init__(self, cfg: PAEConfig, steps_per_epoch: int = 1,
                 device: DeviceLike = "cuda", seed: int = 0, group=None):
        self.set_group(data_parallel_group(group))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = seeded_init(lambda: PAE(cfg, device="cpu"),
                                 seed).to(self.device)
        self.schedule = cyclic_cosine_restarts(
            cfg.learning_rate, steps_per_epoch, cfg.restart_period,
            cfg.restart_mult)
        self.opt = torch.optim.AdamW(self.model.parameters(),
                                     lr=cfg.learning_rate, eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.step = 0

    def _input(self, batch) -> torch.Tensor:
        return to_device(batch, self.device, torch.float32)

    def train_step(self, pose_windows) -> torch.Tensor:
        """One update on (B, frames, C) pose windows (this rank takes its
        block of them); returns the loss as a device tensor, averaged across
        the group."""
        return self.train_block(self.shard(pose_windows))

    def train_block(self, block) -> torch.Tensor:
        """train_step on this rank's block of the batch (the whole batch
        on one device)."""
        self.model.train()
        with cudnn_autotune():
            loss = pae_loss(self.model, self._input(block))
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        if self.group is not None:
            average_gradients(list(self.model.parameters()), self.group)
            average_running_stats(self.model, self.group)
            loss, = pmean([loss.detach()], self.group)
        lr = self.schedule(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, pose_windows) -> torch.Tensor:
        self.model.eval()
        loss = pae_loss(self.model, self._input(self.shard(pose_windows)))
        return pmean([loss], self.group)[0] if self.group is not None \
            else loss
