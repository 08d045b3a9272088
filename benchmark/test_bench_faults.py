"""The harness with the timed path broken underneath: each fault a cell can
have, planted in the program, turns ``correct`` false (a rehearsal on the
CPU, which skips the look for a card and drives the rest of a run)."""
import json

import numpy as np
import pytest
import torch

from benchmark import harness

from qpgesture_tpu_torch import serve
from qpgesture_tpu_torch.match import engine


def _state_unchanged(monkeypatch):
    """A tick that returns its codes but leaves the carried seeds as they
    were."""
    advance = serve._Streams._advance

    def frozen(self, *a, **k):
        held = self._codes_d, self._phases_d
        out = advance(self, *a, **k)
        self._codes_d, self._phases_d = held
        return out
    monkeypatch.setattr(serve._Streams, "_advance", frozen)


def _altered(monkeypatch):
    """One code altered where the fusion scan produces it."""
    scan = engine.CodeKNNEngine.scan

    def altered(self, *a, **k):
        blocks, phases, votes = scan(self, *a, **k)
        blocks = blocks.clone()
        blocks[0, 0] = (blocks[0, 0] + 1) % self.cfg.codebook_size
        return blocks, phases, votes
    monkeypatch.setattr(engine.CodeKNNEngine, "scan", altered)


def _half_batch(monkeypatch):
    """Half of a batch's clips left out, the other half's answers given in
    their place."""
    serve_batch = serve.RawWavServer.serve_batch

    def half(self, wav, ctx=None, init_codes=None, init_phases=None,
             rng=None):
        h = wav.shape[0] // 2
        codes, poses = serve_batch(self, wav[:h], ctx[:h], init_codes[:h],
                                   init_phases[:h], rng)
        return np.concatenate([codes, codes]), np.concatenate([poses, poses])
    monkeypatch.setattr(serve.RawWavServer, "serve_batch", half)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FAULTS = {"state_unchanged": _state_unchanged, "altered": _altered,
          "half_batch": _half_batch}


@pytest.mark.parametrize("cell,fault", [
    ("wavlm-large-j1024.pool16", "state_unchanged"),
    ("wavlm-large-j1024.pool16", "altered"),
    ("vq-wav2vec-j16384.batch16", "half_batch"),
    ("vq-wav2vec-j16384.batch16", "altered"),
    ("wavlm-large-j1024.clip", "altered"),
    ("vq-wav2vec-j16384.clip", "altered"),
])
def test_fault_turns_correct_false(capsys, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    rc = harness.main(["--workload", cell, "--seed", "123456789",
                       "--seconds", "0.5", "--trace", "0", "--rehearse"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and r["correct"] is False
    assert any(isinstance(c["value"], str) or c["value"] > c["limit"]
               for c in r["checks"].values())
