"""The fusion scan's CPU path and the kernel wrapper's refusals.

A CPU engine's scan runs the plain loop (match/engine.py _scan_loop): no
kernel launch and no ``scan_kernel`` counter, and in every mode each lane
equals a solo run of its clip. ``ops/fusion_scan_cuda.fusion_scan`` refuses
CPU tensors and malformed inputs before anything is launched. The kernel
itself is held against the loop on the card (tests/test_torch_cuda.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from qpgesture_tpu_torch.core.config import MATCH_PRESETS
from qpgesture_tpu_torch.match import engine as eng
from qpgesture_tpu_torch.match.database import (stage_database,
                                                stage_test_audio,
                                                stage_test_context)
from qpgesture_tpu_torch.ops import fusion_scan_cuda
from qpgesture_tpu_torch.utils import profiling

from fixtures import make_fixture
from scan_cases import FLAGS, lane, make_scan_case

CASES = [(f, s) for f in sorted(FLAGS) for s in (False, True)
         if FLAGS[f][2] or not s]


@pytest.mark.parametrize("flags,sliced", CASES)
def test_cpu_scan_takes_the_plain_loop(flags, sliced):
    """Four lanes of two windows, reset at every window: no launch, the
    scan span's counters without scan_kernel, each lane == its solo run."""
    case = make_scan_case(3, flags, sliced, 4, 2, "windows")
    before = fusion_scan_cuda.launches
    with profiling.recording() as prof:
        with profiling.span("scan"):
            out = eng._fuse_scan_clips(*case)
    assert fusion_scan_cuda.launches == before
    assert prof.take()[0]["counters"] == {"steps": 16, "lanes": 4}
    solo = [eng._fuse_scan_clips(*lane(case, c)) for c in range(4)]
    for k, x in enumerate(out):
        assert x.device.type == "cpu"
        assert torch.equal(x, torch.cat([s[k] for s in solo]))


@pytest.mark.parametrize("flags", sorted(f for f in FLAGS if FLAGS[f][2]))
def test_cpu_scan_grid_equals_sliced(flags):
    """The same pairs read from the grid or sliced from phase / amp give
    the same blocks, phases and votes."""
    grid, sliced = (eng._fuse_scan_clips(*make_scan_case(
        4, flags, s, 3, 2, "start")) for s in (False, True))
    for a, b in zip(grid, sliced):
        assert torch.equal(a, b)


def test_cpu_engine_launches_no_scan_kernel():
    """CodeKNNEngine on the CPU serves through the loop: predict and
    predict_batch leave fusion_scan_cuda.launches as they found it."""
    engine, ta, tc = _engine()
    before = fusion_scan_cuda.launches
    solo = engine.predict(ta, tc)
    batch = engine.predict_batch(ta[None], tc[None],
                                 init_codes=np.array([0], np.int32))
    assert fusion_scan_cuda.launches == before
    assert solo.codes.shape == batch[0].codes.shape == (2, 30)


def _engine(device="cpu"):
    """A small wavvq engine (64 codes) on device, and its staged queries
    (2 windows)."""
    rng = np.random.RandomState(21)
    fx = make_fixture(rng, n_seq=6, n_test=2, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    return eng.CodeKNNEngine(cfg, db, device=device), ta, tc


def refused_codes(engine, ta, tc, code: int, entry: str) -> None:
    """Raise ValueError through `entry` (predict, predict_batch or a
    streaming pool) with the init code `code`, outside [0, 64)."""
    from qpgesture_tpu_torch.serve import StreamingPool
    with pytest.raises(ValueError, match=r"codes must lie in \[0, 64\)"):
        if entry == "predict":
            engine.predict(ta, tc, init_code=code)
        elif entry == "predict_batch":
            engine.predict_batch(np.stack([ta, ta]), np.stack([tc, tc]),
                                 init_codes=np.array([3, code], np.int32))
        else:
            StreamingPool(engine, 2, init_codes=[code, 3])


@pytest.mark.parametrize("entry", ["predict", "predict_batch", "pool"])
@pytest.mark.parametrize("code", [-1, 64])
def test_out_of_range_init_codes_are_refused(entry, code):
    """An init code outside the codebook is refused on the host before any
    scan: the kernel indexes the selection rows with the carried code
    unchecked. The CPU path refuses it the same way."""
    engine, ta, tc = _engine()
    before = fusion_scan_cuda.launches
    refused_codes(engine, ta, tc, code, entry)
    assert fusion_scan_cuda.launches == before


def test_scan_refuses_out_of_range_reset_codes():
    """_fuse_scan_clips refuses a host reset code past the codebook at a
    reset step, and ignores the codes of steps that do not reset."""
    case = list(make_scan_case(2, "phase_both", False, 2, 2, "windows"))
    case[7] = case[7].copy()
    case[7][1] = 10 ** 6                 # not a reset step: ignored
    eng._fuse_scan_clips(*case)
    case[7][8] = 64                      # the second window's reset
    with pytest.raises(ValueError, match="reset codes"):
        eng._fuse_scan_clips(*case)


def _wrapper_args(flags="phase_both", sliced=False):
    """fusion_scan's keyword arguments for a two-lane case, on the CPU."""
    cfg, n_steps, C, dev, tables, rand, mask, code, phase = make_scan_case(
        2, flags, sliced, 2, 1, "start")
    sel_a, sel_b = eng._tabulate_selection(cfg, dev, tables,
                                           eng._int_scale(cfg))
    use_aud, use_txt, use_phase = FLAGS[flags]
    sides = [s for s, use in (("aud", use_aud), ("txt", use_txt)) if use]
    pairs = None
    if use_phase:
        pairs = [fusion_scan_cuda.Sliced(dev.phase, dev.amp,
                                         getattr(tables, f"{s}_seq"),
                                         getattr(tables, f"{s}_start"))
                 if sliced else
                 fusion_scan_cuda.Grid(getattr(dev, f"{s}_ht"),
                                       getattr(tables, f"{s}_pos"))
                 for s in sides]
    return dict(
        lanes=C, n_steps=n_steps, seed_off=1, sel_a=sel_a, sel_b=sel_b,
        blocks=[getattr(tables, f"{s}_block") for s in sides], pairs=pairs,
        mask=torch.from_numpy(mask[:len(mask) // C].astype(np.int32)),
        reset_code=torch.from_numpy(code), reset_phase=torch.from_numpy(phase),
        rand_bits=None if rand is None else torch.from_numpy(rand))


def _set(**kw):
    return lambda a: a.update(kw)


# (name, flags, sliced, change of the valid arguments, error, message)
REFUSALS = [
    ("cpu tensors", "phase_both", False, _set(), ValueError, "CUDA device"),
    ("cpu tensors, sliced", "phase_aud", True, _set(), ValueError,
     "CUDA device"),
    ("cpu tensors, no phase", "no_phase_both", False, _set(), ValueError,
     "CUDA device"),
    ("int32 selection", "phase_both", False,
     lambda a: a.update(sel_a=a["sel_a"].int()), TypeError, "int64"),
    ("bool mask", "phase_both", False,
     lambda a: a.update(mask=a["mask"].bool()), TypeError, "int32"),
    ("mask of another length", "phase_both", False,
     lambda a: a.update(mask=torch.zeros(9, dtype=torch.int32)), ValueError,
     "mask"),
    ("lanes that do not divide the steps", "phase_both", False,
     _set(lanes=3), ValueError, "lanes"),
    ("blocks of two shapes", "phase_both", False,
     lambda a: a["blocks"].__setitem__(1, a["blocks"][1][:, :32]),
     ValueError, "blocks"),
    ("three sides", "phase_both", False,
     lambda a: a["blocks"].append(a["blocks"][0]), ValueError, "sides"),
    ("two sides with pairs without sel_b", "phase_both", False,
     _set(sel_b=None), ValueError, "sel_b"),
    ("a pair source short", "phase_both", False,
     lambda a: a["pairs"].pop(), ValueError, "pair sources"),
    ("grid and sliced mixed", "phase_both", False,
     lambda a: a["pairs"].__setitem__(1, fusion_scan_cuda.Sliced(
         torch.zeros(3, 40, 8), torch.zeros(3, 40, 8), a["pairs"][1].pos,
         a["pairs"][1].pos)), ValueError, "every side"),
    ("float64 grid", "phase_both", False,
     lambda a: a["pairs"].__setitem__(0, fusion_scan_cuda.Grid(
         a["pairs"][0].ht.double(), a["pairs"][0].pos)), TypeError,
     "float32"),
    ("phase of 9 channels", "phase_aud", True,
     lambda a: a["pairs"].__setitem__(0, a["pairs"][0]._replace(
         phase=torch.zeros(3, 40, 9), amp=torch.zeros(3, 40, 9))),
     ValueError, "phase"),
    ("one side without its top-2 order", "phase_aud", False,
     lambda a: a.update(sel_a=a["sel_a"][..., 0].contiguous()), ValueError,
     "sel_a"),
    ("rand bits with pairs", "phase_both", False,
     lambda a: a.update(rand_bits=torch.zeros(16, dtype=torch.int32)),
     ValueError, "rand_bits"),
    ("two sides without pairs or rand bits", "no_phase_both", False,
     _set(rand_bits=None), ValueError, "rand_bits"),
    ("a reset code without its phase", "phase_both", False,
     _set(reset_phase=None), ValueError, "together"),
    ("seed offset past the block", "phase_both", False, _set(seed_off=4),
     ValueError, "seed_off"),
]


@pytest.mark.parametrize("name,flags,sliced,change,error,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses(name, flags, sliced, change, error, match):
    args = _wrapper_args(flags, sliced)
    change(args)
    before = fusion_scan_cuda.launches
    with pytest.raises(error, match=match):
        fusion_scan_cuda.fusion_scan(**args)
    assert fusion_scan_cuda.launches == before
