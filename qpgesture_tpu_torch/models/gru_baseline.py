"""End-to-end GRU baseline ("w/o motion matching" ablation), inference path.

The port of ``qpgesture_tpu/models/gru_baseline.py`` with the reference's
parameter names (codebook/generate/generate.py:9-60, 312-350), so a
reference ``end2end_*.bin`` loads with ``load_state_dict``
(``models/convert.load_generator_gru_checkpoint``): raw 4 s wav (64000
samples) -> the WavEncoder's five strided Conv1d (``feat_extractor.{0,3,6,
9,12}``, BatchNorm at ``.{1,4,7,10}``, LeakyReLU 0.3) -> (B, 30, 32) -> a
2-layer bidirectional ``nn.GRU(32, 200)`` (``project``) with its two
directions summed -> LayerNorm (eps 1e-5, ``norm``) -> Linear(512) code
logits (``out``). ``sample`` takes the argmax per slot (the first maximum
on ties, as ``jnp.argmax``).

``forward(wav, targets)`` also returns the training loss, the mean
negative log-likelihood of the target codes under ``log_softmax``
(gru_baseline.py:96-106 of the JAX package); ``train/train_end2end.py``
trains the model. In training the BatchNorms (``models/batchnorm``) update
their running statistics as flax's do, and dropout (0.1) sits between the
GRU layers, where ``nn.GRU(dropout=...)`` applies it, with its mask drawn
from the caller's ``torch.Generator``. In evaluation BatchNorm runs on its
running statistics. The convs, the GRU and the Linear run in true float32
(TF32 off package-wide, which also keeps cuDNN's RNN on FMA math).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import constants as C
from ..device import DeviceLike, resolve_device
from .batchnorm import BatchNorm1d


class WavEncoder(nn.Module):
    """Conv1d(1->8->16->32->64->32, k=16, strides 3/3/6/6/6), BatchNorm +
    LeakyReLU(0.3) between layers (generate.py:9-31). 64000 -> (30, 32)."""

    def __init__(self):
        super().__init__()
        layers = []
        specs = [(1, 8, 3), (8, 16, 3), (16, 32, 6), (32, 64, 6)]
        for cin, cout, stride in specs:
            layers += [nn.Conv1d(cin, cout, 16, stride=stride),
                       BatchNorm1d(cout), nn.LeakyReLU(0.3)]
        layers.append(nn.Conv1d(64, 32, 16, stride=6))
        self.feat_extractor = nn.Sequential(*layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) -> (B, frames, 32)."""
        return self.feat_extractor(wav[:, None]).transpose(1, 2)


class _Generator(nn.Module):
    """Shared device placement, eval mode and sampling."""

    def _place(self, device: DeviceLike) -> None:
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def sample(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 64000) windows -> (B, 30) int64 codes, argmax per slot."""
        if self.training:
            raise ValueError(f"{type(self).__name__} must be in eval mode "
                             "(BatchNorm on its running statistics)")
        return torch.argmax(self(wav), dim=-1)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the target codes."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


class GeneratorGRU(_Generator):
    """WavEncoder + 2-layer BiGRU + LayerNorm + Linear (generate.py:312-350).
    ``forward(wav)`` returns (B, 30, output) logits; ``forward(wav,
    targets)`` returns (logits, loss)."""

    def __init__(self, hidden: int = 200, output: int = C.CODEBOOK_SIZE,
                 layers: int = 2, dropout: float = 0.1,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.hidden = hidden
        self.dropout = dropout
        self.WavEncoder = WavEncoder()
        self.project = nn.GRU(32, hidden, layers, batch_first=True,
                              bidirectional=True)
        self.norm = nn.LayerNorm(hidden, eps=1e-5)
        self.out = nn.Linear(hidden, output)
        self._place(device)
        self.project.flatten_parameters()

    def _gru_dropout(self, x: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The GRU a layer at a time, with dropout on each layer's output but
        the last: nn.GRU(dropout=p) in training, with the mask drawn from
        ``generator`` (cuDNN's own dropout cannot take one)."""
        gru, p = self.project, self.dropout
        per_layer = len(gru._flat_weights) // gru.num_layers
        for layer in range(gru.num_layers):
            h0 = x.new_zeros(2, x.shape[0], gru.hidden_size)
            x = torch._VF.gru(
                x, h0, gru._flat_weights[layer * per_layer:
                                         (layer + 1) * per_layer],
                gru.bias, 1, 0.0, True, True, True)[0]
            if layer < gru.num_layers - 1:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) >= p
                x = x * keep / (1.0 - p)
        return x

    def forward(self, wav: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.WavEncoder(wav)
        if self.training and self.dropout > 0:
            x = self._gru_dropout(x, generator)
        else:
            x, _ = self.project(x)
        x = x[..., :self.hidden] + x[..., self.hidden:]   # sum directions
        logits = self.out(self.norm(x))
        if targets is None:
            return logits
        return logits, _nll(logits, targets)


class GeneratorLinear(_Generator):
    """The legacy linear variant (Generator_linear, generate.py:34-60):
    WavEncoder -> LayerNorm(32) -> bias-free Linear(512) per code slot."""

    def __init__(self, output: int = C.CODEBOOK_SIZE,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.WavEncoder = WavEncoder()
        self.norm = nn.LayerNorm(32, eps=1e-5)
        self.project = nn.Linear(32, output, bias=False)
        self._place(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.project(self.norm(self.WavEncoder(wav)))
