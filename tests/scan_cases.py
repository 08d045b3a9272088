"""Seeded inputs of the engine's fusion scan (match/engine.py
_fuse_scan_clips) for every flag combination, both pair sources, any lane
count, clip length and reset pattern. Imports no JAX, so the card's tests
use it too."""
import dataclasses

import numpy as np
import torch

from qpgesture_tpu_torch.core.config import MATCH_PRESETS
from qpgesture_tpu_torch.match import engine as eng

# (use_aud, use_txt, use_phase): the kernel's four modes, the one-side
# phase mode on either side
FLAGS = {"no_phase_aud": (True, False, False),
         "no_phase_both": (True, True, False),
         "phase_aud": (True, False, True),
         "phase_txt": (False, True, True),
         "phase_both": (True, True, True)}
N_STEPS = 8        # the presets' steps a window (seed offset 1)
# few sequences, frames and blocks, so candidates often share a pair and
# their continuities tie; sequence 1 is all zeros (zero norms)
J, T, B = 3, 40, 5


def make_scan_case(seed: int, flags: str, sliced: bool, C: int, W: int,
                   resets: str, P: int = 64):
    """(cfg, n_steps, clips, dev, tables, rand_bits, reset_mask,
    reset_code, reset_phase), _fuse_scan_clips's arguments, on the CPU.
    Ranks are random permutations; each candidate's grid row pos and its
    (seq, start) name the same pair, so grid and sliced agree. resets:
    "none", "start" (each lane's step 0) or "windows" (each window's first
    step)."""
    rng = np.random.RandomState(seed)
    use_aud, use_txt, use_phase = FLAGS[flags]
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], use_aud=use_aud,
                              use_txt=use_txt, use_phase=use_phase,
                              codebook_size=P)
    S, L = cfg.step_sz, W * N_STEPS
    Q = C * L

    def perm(*lead):
        return torch.from_numpy(np.argsort(rng.rand(*lead, P), axis=-1)
                                .astype(np.int32))

    phase = rng.randn(J, T, 8).astype(np.float32)
    amp = rng.rand(J, T, 8).astype(np.float32)
    phase[1] = amp[1] = 0.0
    phase, amp = torch.from_numpy(phase), torch.from_numpy(amp)
    starts = torch.from_numpy(rng.randint(-8, T, B))
    side = {}
    for name, use in (("aud", use_aud), ("txt", use_txt)):
        seq = torch.from_numpy(rng.randint(0, J, (Q, P)))
        blk = torch.from_numpy(rng.randint(0, B, (Q, P)))
        side[name] = dict(
            rank=perm(Q), block=torch.from_numpy(rng.randint(0, P, (Q, P, S))),
            seq=seq, start=starts[blk], pos=seq * B + blk) if use else {}
    tables = eng.DeviceTables(
        **{f"{n}_{k}": side[n].get(k) for n in side
           for k in ("rank", "block", "seq", "start", "pos")},
        n_steps=N_STEPS)
    grids = {}
    if use_phase and not sliced:
        ht = eng._head_tail_grid(phase, amp, starts)
        grids = {f"{n}_ht": ht for n in side if side[n]}
    dev = eng.DeviceDatabase(
        sig_rank=perm(P), freq_rank=perm(),
        phase=phase if use_phase and sliced else None,
        amp=amp if use_phase and sliced else None, **grids)

    mask = np.zeros((C, L), bool)
    if resets == "start":
        mask[:, 0] = True
    elif resets == "windows":
        mask[:, ::N_STEPS] = True
    reset_code = rng.randint(0, P, Q).astype(np.int64)
    reset_phase = rng.randn(Q, 8, 16).astype(np.float32)
    reset_phase[::3] = 0.0
    rand_bits = rng.randint(0, 2, Q).astype(np.int32) \
        if flags == "no_phase_both" else None
    return (cfg, N_STEPS, C, dev, tables, rand_bits, mask.reshape(-1),
            reset_code, reset_phase)


def on_device(case, device):
    """case with its DeviceDatabase and DeviceTables tensors on device."""
    def moved(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    cfg, n_steps, C, dev, tables, *rest = case
    return (cfg, n_steps, C, moved(dev), moved(tables), *rest)


def lane(case, c):
    """Lane c of a case as a solo (one-lane) case."""
    cfg, n_steps, C, dev, tables, rand_bits, mask, code, phase = case
    L = len(mask) // C
    part = slice(c * L, (c + 1) * L)
    tables = dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name)[part]
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)})
    return (cfg, n_steps, 1, dev, tables,
            None if rand_bits is None else rand_bits[part], mask[part],
            code[part], phase[part])
