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
"""
from __future__ import annotations

import torch
from torch import nn


class BatchNorm1d(nn.BatchNorm1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = ((x - mean.view(self._shape(x))) ** 2).mean(dims)
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
