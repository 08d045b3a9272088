"""K1, the edit-distance matrix: the port's plain PyTorch version against
the JAX package's Pallas kernel (interpret mode), its XLA version and the
NumPy oracle — all exact, since distances are integers. The CUDA kernel
itself is held against the plain version in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.match import engine as jax_engine
from qpgesture_tpu.ops.levenshtein import (levenshtein_matrix as jax_lev,
                                           levenshtein_matrix_np)
from qpgesture_tpu.ops.pallas_kernels import levenshtein_matrix_pallas
from qpgesture_tpu_torch.match import engine as port_engine
from qpgesture_tpu_torch.ops import levenshtein_cuda
from qpgesture_tpu_torch.ops.levenshtein import (
    levenshtein_matrix as port_lev)


def _strings(rng, Q, N, L, vocab):
    a = rng.randint(0, vocab, size=(Q, L)).astype(np.int32)
    b = rng.randint(0, vocab, size=(N, L)).astype(np.int32)
    b[min(3, N - 1)] = a[0]      # at least one exact match (distance 0)
    return a, b


@pytest.mark.parametrize("Q,N,L,vocab", [
    (4, 200, 11, 102400),   # wavvq 'combine' symbols, N ragged vs the tile
    (3, 37, 11, 4),         # tiny vocabulary: many matches and ties
    (5, 64, 7, 320),        # another string length (plain version only)
])
def test_plain_matches_pallas_xla_and_oracle(Q, N, L, vocab):
    rng = np.random.RandomState(Q * 1000 + N)
    a, b = _strings(rng, Q, N, L, vocab)
    want = levenshtein_matrix_np(a, b)
    got = port_lev(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax_lev(jnp.asarray(a), jnp.asarray(b))), want)
    np.testing.assert_array_equal(np.asarray(levenshtein_matrix_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True)), want)


@pytest.mark.parametrize("mode", ["combine", "sum"])
def test_string_distance_matrix_matches_jax(mode):
    """The engine's wavvq dispatch: 'combine' strings (Q, L) vs (J, B, L),
    'sum' per-group strings (Q, G, L) vs (J, B, G, L)."""
    rng = np.random.RandomState(17)
    shape_q = (6, 11) if mode == "combine" else (6, 2, 11)
    shape_db = (3, 26, 11) if mode == "combine" else (3, 26, 2, 11)
    vocab = 102400 if mode == "combine" else 320
    q = rng.randint(0, vocab, size=shape_q).astype(np.int32)
    feat = rng.randint(0, vocab, size=shape_db).astype(np.int32)
    feat[1, 4] = q[2]
    want = np.asarray(jax_engine.string_distance_matrix(
        jnp.asarray(q), jnp.asarray(feat)))
    got = port_engine.string_distance_matrix(torch.from_numpy(q),
                                             torch.from_numpy(feat))
    assert got.dtype == torch.int32 and got.shape == (6, 3 * 26)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrapper_on_cpu_runs_plain_version_and_checks_inputs():
    rng = np.random.RandomState(3)
    a, b = _strings(rng, 2, 9, 11, 50)
    before = levenshtein_cuda.launches
    got = levenshtein_cuda.levenshtein_matrix(torch.from_numpy(a),
                                              torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), levenshtein_matrix_np(a, b))
    assert levenshtein_cuda.launches == before   # no kernel ran
    with pytest.raises(TypeError):
        levenshtein_cuda.levenshtein_matrix(torch.from_numpy(a).long(),
                                            torch.from_numpy(b).long())
    with pytest.raises(ValueError):
        levenshtein_cuda.levenshtein_matrix(torch.from_numpy(a),
                                            torch.from_numpy(b[:, :10]))
