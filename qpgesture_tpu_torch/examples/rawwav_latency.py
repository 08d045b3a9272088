"""Raw-audio -> gesture latency on the card (serve.RawWavServer).

The bench's staged figures start from host features; this probe measures
the whole ingress at production scale: full-size WavLM-Large (K2) or
vq-wav2vec encoders with random seeded weights (the compute does not depend
on them), a speaker-10-scale database (J=1024), a 24 s clip of six 4 s
int16 windows and the full-size VQ-VAE decode. It reports the e2e p50
(host clock through the host copies), the first call's wall, and the
device time of the encoder (with device staging), the match and the
decode, each alone (``enc_ms`` / ``match_ms`` / ``decode_ms``, CUDA events
through ``utils/devtime.py``), with the counted FLOPs of the three.

    python -m qpgesture_tpu_torch.examples.rawwav_latency
        [wavvq|wavlm[_split][:highest|high|default] ...]
        [--warm-only] [--parity] [--device cuda]

The port has one eager path, so ``_split`` only names the mode as the JAX
example names its two-dispatch variant; every mode reports the three parts.
``:default`` runs WavLM's GEMMs and K2 in bfloat16, ``:high`` its GEMMs as
bf16x3. --warm-only stops after the first call: the load-and-first-call
wall, the kernels' build included (nothing else compiles). --parity also
serves 5 clips (``RandomState(100 + k)``) at the mode's precision and at
"highest" with the same weights, and reports the agreement of the selected
indices.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import bench
from ..core import constants as C
from ..serve import RawWavServer
from ..utils import devtime

J, W, N_SAMPLES = 1024, 6, 64000
PARITY_CLIPS = 5


def parse_mode(mode: str):
    """'wavvq' | 'wavlm' [+ '_split'] [+ ':precision'] -> (base, split,
    precision); raises ValueError for any other."""
    base, precision = bench._rawwav_mode(mode)
    return base, mode.partition(":")[0].endswith("_split"), precision


def encoder_parity(cfg, engine, model, server, base: str,
                   n_clips: int = PARITY_CLIPS, device="cuda") -> dict:
    """Selected-index agreement of ``server``'s encoder against the same
    weights at "highest" over n_clips clips."""
    ref = RawWavServer(engine, model, bench._encoder(base, "highest",
                                                     device))
    n_same = n_total = n_clips_same = 0
    for k in range(n_clips):
        prng = np.random.RandomState(100 + k)
        pw = (prng.randn(W, N_SAMPLES) * 3000).astype(np.int16)
        pc = prng.randn(W, 30, C.CONTEXT_DIM).astype(np.float32)
        got, _ = server.serve(pw, pc, init_code=7,
                              rng=np.random.RandomState(cfg.seed))
        want, _ = ref.serve(pw, pc, init_code=7,
                            rng=np.random.RandomState(cfg.seed))
        n_same += int((got == want).sum())
        n_total += got.size
        n_clips_same += int((got == want).all())
    return {"clips": n_clips, "clips_identical": n_clips_same,
            "index_agreement": round(n_same / n_total, 4)}


def run(mode: str, device="cuda", warm_only: bool = False,
        parity: bool = False, J: int = J) -> dict:
    base, _, precision = parse_mode(mode)
    rng = np.random.RandomState(0)
    cfg, engine, model, server = bench._rawwav_setup(mode, rng, J, W,
                                                     device=device)
    wav = (rng.randn(W, N_SAMPLES) * 3000).astype(np.int16)
    ctx = rng.randn(W, 30, C.CONTEXT_DIM).astype(np.float32)

    agreement = None
    if parity and base != "wavvq" and precision != "highest":
        agreement = encoder_parity(cfg, engine, model, server, base,
                                   device=device)

    t0 = time.perf_counter()
    codes_out, poses = server.serve(wav, ctx, init_code=7)
    first_call_s = time.perf_counter() - t0
    if codes_out.shape != (W, 30) or poses.shape != (W * 240, C.POSE_DIM) \
            or not np.isfinite(poses).all():
        raise RuntimeError(f"{mode}: codes {codes_out.shape}, poses "
                           f"{poses.shape}")
    out = {"mode": mode, "first_call_wall_s": round(first_call_s, 2)}
    if agreement is not None:
        out["encoder_parity_vs_highest"] = agreement
    if warm_only:
        out["warm_only"] = True
        return out

    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        server.serve(wav, ctx, init_code=7)
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    out.update({"e2e_p50_ms": round(p50 * 1e3, 2),
                "gest_s_per_s": round(W * 4.0 / p50, 1)})
    if engine.device.type != "cuda":
        return out  # the CPU has no device time

    enc_s, match_s, dec_s, flops = bench._rawwav_device(
        cfg, engine, model, server, wav, ctx, W)
    dev_s = enc_s + match_s + dec_s
    out.update({"device_ms": round(dev_s * 1e3, 2),
                "enc_ms": round(enc_s * 1e3, 2),
                "match_ms": round(match_s * 1e3, 2),
                "decode_ms": round(dec_s * 1e3, 2),
                "gest_s_per_device_s": round(W * 4.0 / dev_s, 1)
                if dev_s > 0 else None,
                "flops": flops})
    _, peak = devtime.peak_flops_per_s()
    if flops and dev_s > 0:
        out["tflops_effective"] = round(flops / dev_s / 1e12, 2)
        u = devtime.mfu(flops, dev_s, peak)
        if u is not None:
            out["mfu_bf16_peak"] = round(u, 4)
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("modes", nargs="*", default=["wavvq", "wavlm"])
    p.add_argument("--warm-only", action="store_true")
    p.add_argument("--parity", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for m in args.modes:
        parse_mode(m)
    for m in args.modes:
        print(json.dumps(run(m, args.device, args.warm_only, args.parity)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
