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

``VQVAEConfig.conv_precision`` is the JAX package's: "highest" runs every
conv through cuDNN in true float32 (TF32 off); "default" rounds both
operands of each conv to bfloat16 and "high" splits them (bf16x3), with
float32 sums and outputs, forward and backward alike (``Conv1d``: GEMMs
over the unfolded windows; ``ConvTranspose1d``: a GEMM of the frames and
an overlap-add; both through ``ops/precision``'s products). cuDNN's
bfloat16 convolutions are not used: they write bfloat16 and would round
every output again.

``levels > 1`` chains the levels as the JAX package does: level l > 0 takes
the previous level's ``emb_width`` output, and the encoder returns the
deepest level's. The decoder is level 0's alone (the reference decodes
from the lowest level, vqvae.py:147-148).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import VQVAEConfig
from ..ops.precision import matmul_lp, product_f32, split_operands

PRECISIONS = ("highest", "high", "default")


def _windows(h: torch.Tensor, k: int, s: int, p: int, d: int
             ) -> torch.Tensor:
    """(B, T, C) -> the conv's (B * T', C * k) input windows, channel-major
    within a window (the order of the (out, C, k) weight)."""
    if p:
        h = F.pad(h, (0, 0, p, p))
    if k == 1 and s == 1:
        return h.reshape(-1, h.shape[2])
    cols = h.unfold(1, (k - 1) * d + 1, s)[..., ::d]         # (B, T', C, k)
    return cols.reshape(-1, cols.shape[2] * k)


def _overlap_add(cols: torch.Tensor, length: int, s: int, d: int
                 ) -> torch.Tensor:
    """(B, L, C, k) window values -> (B, length, C): tap j of window t adds
    into position t * s + j * d (col2im as k strided adds: F.fold launches
    one kernel per batch row)."""
    B, L, C, k = cols.shape
    out = cols.new_zeros(B, length, C)
    for j in range(k):
        out[:, j * d:j * d + (L - 1) * s + 1:s] += cols[..., j]
    return out


class _LowPrecisionConv1d(torch.autograd.Function):
    """conv1d below "highest" as GEMMs over the unfolded windows: the input
    is rounded (split) once at its own size, then unfolded in bfloat16;
    the backward recomputes the windows from the saved bfloat16 input,
    runs its two products at the same precision and sums the overlapping
    windows' input gradients in float32 (``_overlap_add``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, geom, precision):
        B, C, T = x.shape
        xs = split_operands(x.transpose(1, 2), precision)    # (B, T, C)
        ws = split_operands(weight.reshape(weight.shape[0], -1).t(),
                            precision)                       # (C*k, out)
        y = product_f32([_windows(t, *geom) for t in xs], ws) + bias
        ctx.geom, ctx.shape, ctx.precision, ctx.n = geom, (B, C, T), \
            precision, len(xs)
        ctx.save_for_backward(*xs, *ws)
        return y.view(B, -1, weight.shape[0]).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        k, s, p, d = ctx.geom
        B, C, T = ctx.shape
        saved = ctx.saved_tensors
        xs, ws = saved[:ctx.n], saved[ctx.n:]
        out = g.shape[1]
        g2 = g.transpose(1, 2).reshape(-1, out)             # (B*T', out)
        gs = split_operands(g2, ctx.precision)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dcols = product_f32(gs, [w.t() for w in ws])     # (B*T', C*k)
            if k == 1 and s == 1 and p == 0:
                dx = dcols.view(B, T, C).transpose(1, 2)
            else:
                dx = _overlap_add(dcols.view(B, -1, C, k), T + 2 * p, s,
                                  d)[:, p:p + T].transpose(1, 2)
        if ctx.needs_input_grad[1]:
            dw = product_f32([_windows(t, k, s, p, d).t() for t in xs], gs
                             ).t().reshape(out, C, k)
        if ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db, None, None


class Conv1d(nn.Conv1d):
    """nn.Conv1d (its parameter names) at ``precision``. Below "highest"
    it computes in the channels-last layout and returns an NCT view of a
    channels-last tensor, so a chain of them and the elementwise ops
    between copies no activation to transpose it."""

    def __init__(self, *args, precision: str = "highest", **kwargs):
        super().__init__(*args, **kwargs)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "highest":
            return super().forward(x)
        geom = (self.kernel_size[0], self.stride[0], self.padding[0],
                self.dilation[0])
        return _LowPrecisionConv1d.apply(x, self.weight, self.bias, geom,
                                         self.precision)


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d (its parameter names) at ``precision``. Below
    "highest": one GEMM of the input frames with the (in, out * k) kernel,
    then the overlapping taps summed in float32 into the output
    (``_overlap_add``); channels-last, returned as an NCT view."""

    def __init__(self, *args, precision: str = "highest", **kwargs):
        super().__init__(*args, **kwargs)
        self.precision = precision

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "highest":
            return super().forward(x)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        B, C, T = x.shape
        rows = x.transpose(1, 2).reshape(B * T, C)
        taps = matmul_lp(rows, self.weight.reshape(C, -1), self.precision)
        y = _overlap_add(taps.view(B, T, self.out_channels, k),
                         (T - 1) * s + k, s, 1)
        t_out = (T - 1) * s - 2 * p + k
        return (y[:, p:p + t_out] + self.bias).transpose(1, 2)


class ResConv1DBlock(nn.Module):
    """ReLU -> Conv(k3, dilated) -> ReLU -> Conv(k1), residual
    (resnet.py:27-46). The convs sit at model.1 and model.3."""

    def __init__(self, n_in: int, n_state: int, dilation: int = 1,
                 res_scale: float = 1.0, checkpoint_res: bool = False,
                 precision: str = "highest"):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReLU(), Conv1d(n_in, n_state, 3, 1, dilation, dilation,
                              precision=precision),
            nn.ReLU(), Conv1d(n_state, n_in, 1, 1, 0, precision=precision))
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
                 checkpoint_res: bool = False, precision: str = "highest"):
        super().__init__()

        def get_depth(depth):
            return depth if dilation_cycle is None else depth % dilation_cycle

        scale = 1.0 if not res_scale else 1.0 / (n_depth ** 0.5)
        blocks = [ResConv1DBlock(n_in, int(m_conv * n_in),
                                 dilation=dilation_growth_rate
                                 ** get_depth(depth), res_scale=scale,
                                 checkpoint_res=checkpoint_res,
                                 precision=precision)
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
                 checkpoint_res: bool = False, precision: str = "highest"):
        super().__init__()
        filter_t, pad_t = stride_t * 2, stride_t // 2
        blocks = []
        for i in range(down_t):
            blocks.append(nn.Sequential(
                Conv1d(input_emb_width if i == 0 else width, width,
                       filter_t, stride_t, pad_t, precision=precision),
                Resnet1D(width, depth, m_conv, dilation_growth_rate,
                         dilation_cycle, checkpoint_res=checkpoint_res,
                         precision=precision)))
        blocks.append(Conv1d(width, output_emb_width, 3, 1, 1,
                             precision=precision))
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
                 checkpoint_res: bool = False, precision: str = "highest"):
        super().__init__()
        filter_t, pad_t = stride_t * 2, stride_t // 2
        blocks = [Conv1d(output_emb_width, width, 3, 1, 1,
                         precision=precision)]
        for i in range(down_t):
            out_ch = input_emb_width if i == down_t - 1 else width
            blocks.append(nn.Sequential(
                Resnet1D(width, depth, m_conv, dilation_growth_rate,
                         dilation_cycle,
                         reverse_dilation=reverse_decoder_dilation,
                         checkpoint_res=checkpoint_res,
                         precision=precision),
                ConvTranspose1d(width, out_ch, filter_t, stride_t, pad_t,
                                precision=precision)))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _check_precision(cfg: VQVAEConfig) -> None:
    if cfg.conv_precision not in PRECISIONS:
        raise ValueError(f"conv_precision must be one of {PRECISIONS}, got "
                         f"{cfg.conv_precision!r}")


class Encoder(nn.Module):
    """The level chain (encdec.py:53-90); level_blocks.{l} is level l's
    conv block, whose input is the previous level's output. NTC in, NTC
    out (the deepest level's embedding)."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _check_precision(cfg)
        self.level_blocks = nn.ModuleList([EncoderConvBlock(
            cfg.input_dim if level == 0 else cfg.emb_width, cfg.emb_width,
            cfg.downs_t[level], cfg.strides_t[level],
            width=cfg.width * cfg.hvqvae_multipliers[level],
            depth=cfg.depth * cfg.hvqvae_multipliers[level],
            m_conv=cfg.m_conv,
            dilation_growth_rate=cfg.dilation_growth_rate,
            dilation_cycle=cfg.dilation_cycle,
            checkpoint_res=cfg.checkpoint_res,
            precision=cfg.conv_precision) for level in range(cfg.levels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for block in self.level_blocks:
            h = block(h)
        return h.transpose(1, 2)


class Decoder(nn.Module):
    """Single-level decode path (the reference always decodes from the
    lowest level, vqvae.py:147-148). NTC in, NTC out."""

    def __init__(self, cfg: VQVAEConfig):
        super().__init__()
        _check_precision(cfg)
        mult = cfg.hvqvae_multipliers[0]
        self.level_blocks = nn.ModuleList([DecoderConvBock(
            cfg.emb_width, cfg.emb_width, cfg.downs_t[0], cfg.strides_t[0],
            width=cfg.width * mult, depth=cfg.depth * mult,
            m_conv=cfg.m_conv,
            dilation_growth_rate=cfg.dilation_growth_rate,
            dilation_cycle=cfg.dilation_cycle,
            reverse_decoder_dilation=cfg.vqvae_reverse_decoder_dilation,
            checkpoint_res=cfg.checkpoint_res,
            precision=cfg.conv_precision)])
        self.out = Conv1d(cfg.emb_width, cfg.input_dim, 3, 1, 1,
                          precision=cfg.conv_precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.level_blocks[0](x.transpose(1, 2))
        return self.out(h).transpose(1, 2)
