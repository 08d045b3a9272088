"""VQ-VAE encoder/decoder conv stacks (nn.Modules).

Same topology as the reference (codebook/models/encdec.py:8-136,
resnet.py:27-77): EncoderConvBlock = down_t x [Conv1d(k=2s, stride s, pad s/2)
+ Resnet1D(width, depth, dilation growth 3)] + Conv1d(k3) projection;
DecoderConvBock mirrors it with transposed convs and reversed dilations.

Module and parameter names are the reference's, so a reference
``codebook_checkpoint_best.bin`` loads with ``load_state_dict``
(models/convert.py). Internally the convs run NCT, PyTorch's layout; the
public ``Encoder``/``Decoder`` take and return NTC, the JAX package's layout.
``VQVAEConfig.checkpoint_res`` recomputes each residual block in the
backward pass instead of storing its activations (the reference's
checkpoint_res, resnet.py:63-75; ``nn.remat`` in the JAX package).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import VQVAEConfig


class ResConv1DBlock(nn.Module):
    """ReLU -> Conv(k3, dilated) -> ReLU -> Conv(k1), residual
    (resnet.py:27-46). The convs sit at model.1 and model.3."""

    def __init__(self, n_in: int, n_state: int, dilation: int = 1,
                 res_scale: float = 1.0, checkpoint_res: bool = False):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReLU(), nn.Conv1d(n_in, n_state, 3, 1, dilation, dilation),
            nn.ReLU(), nn.Conv1d(n_state, n_in, 1, 1, 0))
        self.res_scale = res_scale
        self.checkpoint_res = checkpoint_res

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res_scale * self.model(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.checkpoint_res and torch.is_grad_enabled():
            return checkpoint(self._block, x, use_reentrant=False)
        return self._block(x)


class Resnet1D(nn.Module):
    """Stack of dilated residual blocks; dilation = growth^depth, optionally
    reversed for the decoder (resnet.py:48-77)."""

    def __init__(self, n_in: int, n_depth: int, m_conv: float = 1.0,
                 dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None,
                 reverse_dilation: bool = False, res_scale: bool = False,
                 checkpoint_res: bool = False):
        super().__init__()

        def get_depth(depth):
            return depth if dilation_cycle is None else depth % dilation_cycle

        scale = 1.0 if not res_scale else 1.0 / (n_depth ** 0.5)
        blocks = [ResConv1DBlock(n_in, int(m_conv * n_in),
                                 dilation=dilation_growth_rate
                                 ** get_depth(depth), res_scale=scale,
                                 checkpoint_res=checkpoint_res)
                  for depth in range(n_depth)]
        if reverse_dilation:
            blocks = blocks[::-1]
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class EncoderConvBlock(nn.Module):
    def __init__(self, input_emb_width: int, output_emb_width: int,
                 down_t: int, stride_t: int, width: int, depth: int,
                 m_conv: float, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None,
                 checkpoint_res: bool = False):
        super().__init__()
        filter_t, pad_t = stride_t * 2, stride_t // 2
        blocks = []
        for i in range(down_t):
            blocks.append(nn.Sequential(
                nn.Conv1d(input_emb_width if i == 0 else width, width,
                          filter_t, stride_t, pad_t),
                Resnet1D(width, depth, m_conv, dilation_growth_rate,
                         dilation_cycle, checkpoint_res=checkpoint_res)))
        blocks.append(nn.Conv1d(width, output_emb_width, 3, 1, 1))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class DecoderConvBock(nn.Module):
    """(sic: the reference's class name.)"""

    def __init__(self, input_emb_width: int, output_emb_width: int,
                 down_t: int, stride_t: int, width: int, depth: int,
                 m_conv: float, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None,
                 reverse_decoder_dilation: bool = False,
                 checkpoint_res: bool = False):
        super().__init__()
        filter_t, pad_t = stride_t * 2, stride_t // 2
        blocks = [nn.Conv1d(output_emb_width, width, 3, 1, 1)]
        for i in range(down_t):
            out_ch = input_emb_width if i == down_t - 1 else width
            blocks.append(nn.Sequential(
                Resnet1D(width, depth, m_conv, dilation_growth_rate,
                         dilation_cycle,
                         reverse_dilation=reverse_decoder_dilation,
                         checkpoint_res=checkpoint_res),
                nn.ConvTranspose1d(width, out_ch, filter_t, stride_t,
                                   pad_t)))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _check_supported(cfg: VQVAEConfig) -> None:
    if cfg.levels != 1:
        raise NotImplementedError(f"levels={cfg.levels}: only the "
                                  "reference's single-level VQ-VAE is ported")
    if cfg.conv_precision != "highest":
        raise NotImplementedError(
            f"conv_precision={cfg.conv_precision!r} is not ported (the port "
            "runs its convolutions in true float32)")


class Encoder(nn.Module):
    """Single-level encoder (encdec.py:53-90); level_blocks.0 is the conv
    block. NTC in, NTC out (the level-0 embedding)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _check_supported(cfg)
        mult = cfg.hvqvae_multipliers[0]
        self.level_blocks = nn.ModuleList([EncoderConvBlock(
            cfg.input_dim, cfg.emb_width, cfg.downs_t[0], cfg.strides_t[0],
            width=cfg.width * mult, depth=cfg.depth * mult,
            m_conv=cfg.m_conv,
            dilation_growth_rate=cfg.dilation_growth_rate,
            dilation_cycle=cfg.dilation_cycle,
            checkpoint_res=cfg.checkpoint_res)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.level_blocks[0](x.transpose(1, 2)).transpose(1, 2)


class Decoder(nn.Module):
    """Single-level decode path (the reference always decodes from the
    lowest level, vqvae.py:147-148). NTC in, NTC out."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _check_supported(cfg)
        mult = cfg.hvqvae_multipliers[0]
        self.level_blocks = nn.ModuleList([DecoderConvBock(
            cfg.emb_width, cfg.emb_width, cfg.downs_t[0], cfg.strides_t[0],
            width=cfg.width * mult, depth=cfg.depth * mult,
            m_conv=cfg.m_conv,
            dilation_growth_rate=cfg.dilation_growth_rate,
            dilation_cycle=cfg.dilation_cycle,
            reverse_decoder_dilation=cfg.vqvae_reverse_decoder_dilation,
            checkpoint_res=cfg.checkpoint_res)])
        self.out = nn.Conv1d(cfg.emb_width, cfg.input_dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.level_blocks[0](x.transpose(1, 2))
        return self.out(h).transpose(1, 2)
