"""The control of ``correct`` comes out not correct: the reference in the
program's place at TF32 fails one of each cell's numbers. On the CPU at
the rehearsal sizes (TF32 is emulated, so the CPU computes it too); on a
card at the cells' own sizes (marked ``gpu``; a fixture skips it without
one)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = ["wavlm-large-j1024.pool16", "vq-wav2vec-j16384.batch16",
         "wavlm-large-j1024.clip", "vq-wav2vec-j16384.clip"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own sizes")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_rehearsal_sizes(cell):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = control.readings(cell, 2 ** 31 + 77, rehearse=True)
    finally:
        torch.set_num_threads(prev)
    assert r["control_correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "101", "102", "103"], cwd=ROOT, capture_output=True,
        text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3
    assert not any(r["control_correct"] for r in lines)


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vq-wav2vec-j16384.clip", "--seed", "104", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
