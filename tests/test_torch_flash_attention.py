"""K2, gated flash attention: the port's plain version (what its wrapper
runs on the CPU) against the JAX package's Pallas kernel in interpret mode
and against the JAX eager attention, on the same seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpgesture_tpu.ops.flash_attention import gated_flash_attention as jax_flash
from qpgesture_tpu_torch.ops import flash_attention_cuda

HI = jax.lax.Precision.HIGHEST


def _inputs(B, H, T, hd, gated, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, hd).astype(np.float32) for _ in range(3))
    bias = rng.randn(H, T, T).astype(np.float32)
    gate = (1.0 + rng.rand(B, H, T)).astype(np.float32) if gated else None
    return q, k, v, bias, gate


def _jax_eager(q, k, v, bias, gate, scale):
    """The JAX WavLMAttention 'xla' branch (models/wavlm.py:203-212) in the
    kernel's (B, H, T, hd) layout."""
    s = jnp.einsum("bhtd,bhsd->bhts", q * scale, k, precision=HI)
    b = bias[None] if gate is None else gate[..., None] * bias[None]
    p = jax.nn.softmax(s + b, axis=-1)
    return jnp.einsum("bhts,bhsd->bhtd", p, v, precision=HI)


def _port(q, k, v, bias, gate, scale, dtype):
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, bias, gate)]
    before = flash_attention_cuda.launches
    out = flash_attention_cuda.gated_flash_attention(
        *t, sm_scale=scale, kernel_dtype=dtype)
    assert flash_attention_cuda.launches == before     # CPU: no kernel ran
    assert out.dtype == torch.float32
    return out.numpy()


# float32: the two sides differ in summation order only (1e-5 on outputs of
# magnitude ~1). bfloat16: the inputs are rounded identically on both
# sides; a rounded weight p can land one bfloat16 ulp (2^-8 relative) apart
# where exp() rounds differently, which moves an output by at most
# 2^-8 * p * |v|; 1e-3 (5.6e-5 seen). T = 1, 32, 33 and 65 sit on the
# CUDA kernel's 32-key and 16-/64-query tile edges.
@pytest.mark.parametrize("T", [1, 32, 33, 37, 65, 159])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-3)])
def test_plain_matches_jax_flash_interpret(T, gated, dtype, atol):
    B, H, hd = 2, 4, 16
    q, k, v, bias, gate = _inputs(B, H, T, hd, gated, seed=T + gated)
    scale = hd ** -0.5
    want = np.asarray(jax_flash(
        *(None if x is None else jnp.asarray(x)
          for x in (q, k, v, bias, gate)),
        sm_scale=scale, interpret=True,
        kernel_dtype=jnp.bfloat16 if dtype == torch.bfloat16 else None))
    got = _port(q, k, v, bias, gate, scale, dtype)
    assert got.shape == want.shape == (B, H, T, hd)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("T", [37, 159])
@pytest.mark.parametrize("gated", [True, False])
def test_plain_matches_jax_eager(T, gated):
    """float32 against the eager softmax: the eager path normalises p before
    p @ v, the flash path after, so 1e-5 (summation order and one
    division)."""
    B, H, hd = 2, 4, 16
    q, k, v, bias, gate = _inputs(B, H, T, hd, gated, seed=7 * T)
    scale = hd ** -0.5
    want = np.asarray(_jax_eager(
        *(None if x is None else jnp.asarray(x)
          for x in (q, k, v, bias, gate)), scale))
    got = _port(q, k, v, bias, gate, scale, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_wrapper_rejects_bad_shapes():
    q, k, v, bias, gate = (torch.from_numpy(x) for x in
                           _inputs(1, 2, 8, 16, True, 0))
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention_cuda.gated_flash_attention(q, k, v, bias[:, :4], gate)
    with pytest.raises(ValueError, match="gate must be"):
        flash_attention_cuda.gated_flash_attention(q, k, v, bias, gate[0])
    with pytest.raises(TypeError, match="kernel dtype"):
        flash_attention_cuda.gated_flash_attention(
            q, k, v, bias, gate, kernel_dtype=torch.float16)
