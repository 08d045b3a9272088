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

Inference only: BatchNorm runs on its running statistics, and the convs,
the GRU and the Linear run in true float32 (TF32 off package-wide, which
also keeps cuDNN's RNN on FMA math).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import constants as C
from ..device import DeviceLike, resolve_device


class WavEncoder(nn.Module):
    """Conv1d(1->8->16->32->64->32, k=16, strides 3/3/6/6/6), BatchNorm +
    LeakyReLU(0.3) between layers (generate.py:9-31). 64000 -> (30, 32)."""

    def __init__(self):
        super().__init__()
        layers = []
        specs = [(1, 8, 3), (8, 16, 3), (16, 32, 6), (32, 64, 6)]
        for cin, cout, stride in specs:
            layers += [nn.Conv1d(cin, cout, 16, stride=stride),
                       nn.BatchNorm1d(cout), nn.LeakyReLU(0.3)]
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


class GeneratorGRU(_Generator):
    """WavEncoder + 2-layer BiGRU + LayerNorm + Linear (generate.py:312-350).
    Returns (B, 30, output) logits."""

    def __init__(self, hidden: int = 200, output: int = C.CODEBOOK_SIZE,
                 layers: int = 2, device: DeviceLike = "cuda"):
        super().__init__()
        self.hidden = hidden
        self.WavEncoder = WavEncoder()
        self.project = nn.GRU(32, hidden, layers, batch_first=True,
                              bidirectional=True)
        self.norm = nn.LayerNorm(hidden, eps=1e-5)
        self.out = nn.Linear(hidden, output)
        self._place(device)
        self.project.flatten_parameters()

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x, _ = self.project(self.WavEncoder(wav))
        x = x[..., :self.hidden] + x[..., self.hidden:]   # sum directions
        return self.out(self.norm(x))


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
