"""BatchNorm1d whose training step updates its running statistics as flax's
``nn.BatchNorm`` does.

The JAX package's PAE and GRU baseline hold flax BatchNorm (momentum 0.9,
epsilon 1e-5). In training, flax moves ``running_var`` towards the *biased*
batch variance, where ``torch.nn.BatchNorm1d`` uses the unbiased one (8
rows already differ by 1/7), and flax takes a batch of one, where torch
raises. This subclass keeps torch's parameter and buffer names (so
reference checkpoints load unchanged) and torch's evaluation path; in
training it normalizes with the batch mean and biased variance, as torch
does, and updates ``running_mean`` / ``running_var`` with torch's momentum
0.1 (flax's 0.9) from the biased variance.

``sync_batchnorm`` gives a module's BatchNorms the synchronised mode of
flax's ``axis_name`` (the JAX ResyncNet's generator in data-parallel
training), in flax's ``_compute_stats``: each rank's mean and mean square,
averaged across the group in one all_reduce (whose gradient is the
all_reduce of the gradients), and the variance max(0, E[x^2] - E[x]^2).
That variance equals the two-pass one in exact arithmetic and differs from
it in rounding (it cancels where a channel's mean is large against its
spread), so the one-device counterpart of a synchronised step is the same
formula on one process: ``sync_batchnorm`` without a group.
``torch.nn.SyncBatchNorm`` computes other statistics and is not used.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.dist import all_reduce_sum_autograd, world_size


class BatchNorm1d(nn.BatchNorm1d):
    # sync_batchnorm's mode: flax's statistics, shared across ``group``
    # when one is set (None: this process's batch)
    synced = False
    group = None

    def _batch_stats(self, x: torch.Tensor, dims):
        """(mean, biased variance) over the batch: two-pass over this
        process's batch, or flax's formula (synced) over the group's."""
        if not self.synced:
            mean = x.mean(dims)
            return mean, ((x - mean.view(self._shape(x))) ** 2).mean(dims)
        moments = torch.stack((x.mean(dims), (x * x).mean(dims)))
        if self.group is not None:
            moments = all_reduce_sum_autograd(moments, self.group) / \
                world_size(self.group)
        mean, mean2 = moments
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        mean, var = self._batch_stats(x, dims)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        y = (x - mean.view(self._shape(x))) * torch.rsqrt(
            var.view(self._shape(x)) + self.eps)
        return y * self.weight.view(self._shape(x)) \
            + self.bias.view(self._shape(x))

    @staticmethod
    def _shape(x: torch.Tensor):
        return (1, -1) + (1,) * (x.dim() - 2)


def sync_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """Every BatchNorm1d in ``module`` computes flax's statistics in
    training, averaged across the data-parallel ``group`` when one is given
    (None: over this process's batch, the same formula on one device).
    Returns the module."""
    for m in module.modules():
        if isinstance(m, BatchNorm1d):
            m.synced, m.group = True, group
    return module


def average_running_stats(module: nn.Module, group) -> None:
    """Average the running mean and variance of every BatchNorm1d in
    ``module`` across ``group``: what the JAX PAE and GRU trainers do with
    their per-shard statistics after a step (lax.pmean of batch_stats)."""
    from ..parallel.dist import pmean
    bufs = [b for m in module.modules() if isinstance(m, BatchNorm1d)
            for b in (m.running_mean, m.running_var)]
    with torch.no_grad():
        for b, avg in zip(bufs, pmean(bufs, group)):
            b.copy_(avg)
