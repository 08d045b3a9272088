"""Random weights under the published parameter names, drawn on the device
from the run's seed in one call per model.

Each model's parameters are listed as (name, shape, kind) from its
configuration file (an encoder's by ``models/<model>.py``, the VQ-VAE's
here); one normal draw of their total size is cut into them
and scaled by kind, so that activations keep a unit scale through the
depth of the network. The same seed gives the same weights on every
device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def vqvae_spec(v: dict) -> Spec:
    """The whole VQ-VAE (encoder, decoder, codebook), the names of
    QPGesture's checkpoint; only the decoder and the codebook serve."""
    w, e, depth = v["width"], v["emb_width"], v["depth"]
    kt = 2 * v["stride_t"]

    def res(prefix):
        out = []
        for j in range(depth):
            r = f"{prefix}.model.{j}.model"
            out += [(f"{r}.1.weight", (w, w, 3), "fan_in"),
                    (f"{r}.1.bias", (w,), "bias"),
                    (f"{r}.3.weight", (w, w, 1), "res_out"),
                    (f"{r}.3.bias", (w,), "bias")]
        return out

    s: Spec = []
    p = "encoders.0.level_blocks.0.model"
    for i in range(v["down_t"]):
        s += [(f"{p}.{i}.0.weight", (w, v["input_dim"] if i == 0 else w, kt),
               "fan_in"), (f"{p}.{i}.0.bias", (w,), "bias")]
        s += res(f"{p}.{i}.1")
    s += [(f"{p}.{v['down_t']}.weight", (e, w, 3), "fan_in"),
          (f"{p}.{v['down_t']}.bias", (e,), "bias")]
    p = "decoders.0.level_blocks.0.model"
    s += [(f"{p}.0.weight", (w, e, 3), "fan_in"), (f"{p}.0.bias", (w,), "bias")]
    for i in range(v["down_t"]):
        out = e if i == v["down_t"] - 1 else w
        s += res(f"{p}.{i + 1}.0")
        s += [(f"{p}.{i + 1}.1.weight", (w, out, kt), "transpose"),
              (f"{p}.{i + 1}.1.bias", (out,), "bias")]
    s += [("decoders.0.out.weight", (v["input_dim"], e, 3), "fan_in"),
          ("decoders.0.out.bias", (v["input_dim"],), "bias"),
          ("bottleneck.level_blocks.0.k", (v["l_bins"], e), "unit")]
    return s


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from (seed, tag)."""
    state = np.random.SeedSequence([seed, tag]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def draw(spec: Spec, seed: int, tag: int, device,
         stride: int = 2) -> Dict[str, torch.Tensor]:
    """Float32 tensors of ``spec`` on ``device``, cut from one normal draw
    of their total size."""
    total = sum(int(np.prod(shape)) for _, shape, _ in spec)
    buf = torch.randn(total, generator=generator(seed, tag, device),
                      device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        x = buf[off:off + n].view(shape)
        off += n
        if kind == "fan_in":
            x = x * float(1.0 / np.sqrt(np.prod(shape[1:])))
        elif kind == "res_out":      # the residual branch's last conv
            x = x * float(0.3 / np.sqrt(np.prod(shape[1:])))
        elif kind == "transpose":    # (in, out, k) at stride `stride`
            x = x * float(1.0 / np.sqrt(shape[0] * shape[2] / stride))
        elif kind == "ln_w":
            x = 1.0 + 0.05 * x
        elif kind == "bias":
            x = 0.02 * x
        elif kind in ("unit", "weight_g"):   # weight_g: set from weight_v
            x = x.clone()
        else:
            raise ValueError(f"unknown init kind {kind!r} of {name}")
        out[name] = x
    for name, _, kind in spec:
        if kind == "weight_g":
            v = out[name[:-len("weight_g")] + "weight_v"]
            out[name] = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    return out
