"""The system under test: qpgesture_tpu_torch's serving path built from a
configuration file, with the benchmark's weights and database, and the
forward hooks the benchmark places on its encoder and decoder modules.

Nothing here reaches into the program beyond its public constructors and
``load_state_dict``; the entry a traffic mix names (``entries/<entry>.py``)
makes the call, and the configuration's model (``models/<model>.py``)
builds the encoder.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from . import weights


def set_precision(cfg: dict) -> None:
    """The configuration's float32 products: TF32 on or off in cuBLAS and
    cuDNN as it states (the reference runs under the same flags)."""
    if cfg["precision"] != "float32":
        raise ValueError(f"the benchmark runs float32 configurations; "
                         f"{cfg['name']} states {cfg['precision']!r}")
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])


def encoder_weights(cfg: dict, model, seed: int, device):
    return weights.draw(model.spec(cfg), seed, 1, device)


def vqvae_weights(cfg: dict, seed: int, device):
    v = cfg["vqvae"]
    return weights.draw(weights.vqvae_spec(v), seed, 2, device,
                        stride=v["stride_t"])


class Program:
    """The port's server for one configuration, and what the mix's entry
    calls (``target``)."""

    def __init__(self, cfg: dict, model, entry, traffic: dict, seed: int,
                 device, db):
        from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
        from qpgesture_tpu_torch.core.schemas import (CodebookSignature,
                                                      DatabaseBundle)
        from qpgesture_tpu_torch.match.database import stage_database
        from qpgesture_tpu_torch.match.engine import CodeKNNEngine
        from qpgesture_tpu_torch.models.vqvae import VQVAE
        from qpgesture_tpu_torch.serve import RawWavServer

        m = cfg["match"]
        mcfg = MATCH_PRESETS[m["preset"]]
        for key in ("audio_mode", "use_aud", "use_txt", "use_phase",
                    "freq_weight", "codebook_size", "unmatched_dist"):
            if getattr(mcfg, key) != m[key]:
                raise ValueError(f"preset {m['preset']!r} has {key}="
                                 f"{getattr(mcfg, key)!r}, the "
                                 f"configuration states {m[key]!r}")
        set_precision(cfg)
        bundle = DatabaseBundle(context=db.context, phase=db.phase)
        signature = CodebookSignature(code=None, poses=None,
                                      signature=db.signature)
        staged = stage_database(mcfg, bundle, db.codes, signature,
                                **{model.AUDIO: db.audio})
        self.engine = CodeKNNEngine(mcfg, staged, device)
        self.engine.devdb                      # stage the database now
        v = cfg["vqvae"]
        vcfg = VQVAEConfig(width=v["width"], depth=v["depth"],
                           l_bins=v["l_bins"], emb_width=v["emb_width"],
                           downs_t=(v["down_t"],), strides_t=(v["stride_t"],),
                           dilation_growth_rate=v["dilation_growth_rate"],
                           input_dim=v["input_dim"],
                           sample_length=v["sample_length"])
        with torch.device(device):
            self.vqvae = VQVAE(vcfg, device=device)
            self.vqvae.load_state_dict(vqvae_weights(cfg, seed, device))
            self.encoder = model.program(cfg, device)
            self.encoder.load_state_dict(
                encoder_weights(cfg, model, seed, device))
        self.server = RawWavServer(self.engine, self.vqvae, self.encoder,
                                   db.data_mean, db.data_std)
        self.entry = entry
        self.target = entry.build(self, traffic, cfg, seed)

    @property
    def decoder(self) -> torch.nn.Module:
        return self.vqvae.decoders[0]

    def state(self):
        """What the entry carries from unit to unit, on the device, or
        None."""
        state = getattr(self.entry, "state", None)
        return state(self.target) if state else None

    def run(self, u):
        """One unit through the mix's entry: (codes, poses or None) as host
        arrays."""
        return self.entry.call(self.target, u)


class Hooks:
    """Forward pre/post hooks on a module: callbacks at its entry and exit,
    and, while ``capture`` is set, each output kept for the comparison."""

    def __init__(self, module: torch.nn.Module):
        self.on_enter: List[Callable[[], None]] = []
        self.on_exit: List[Callable[[], None]] = []
        self.capture = False
        self.captured: List[torch.Tensor] = []
        self._handles = [module.register_forward_pre_hook(self._pre),
                         module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        for f in self.on_enter:
            f()

    def _post(self, module, args, out):
        if self.capture:
            self.captured.append(out)
        for f in self.on_exit:
            f()

    def take(self):
        """The outputs captured since the last take, as one tensor of
        their rows (None when there were none)."""
        out, self.captured = self.captured, []
        return torch.cat(out) if out else None

    def remove(self):
        for h in self._handles:
            h.remove()


def host(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.detach().cpu().numpy()
