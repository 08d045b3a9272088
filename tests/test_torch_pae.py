"""PAE: a random port model with the reference's parameter names, converted
to flax with the JAX package's own converter, runs like the JAX PAE; the
batched phase extractor gives the JAX extractor's phases; the inverse
converter round-trips; a reference-layout checkpoint loads."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.core.config import PAEConfig as JaxPAEConfig
from qpgesture_tpu.models.pae import PAE as JaxPAE
from qpgesture_tpu.models.pae import PhaseExtractor as JaxPhaseExtractor
from qpgesture_tpu.models.pae import velocity_input as jax_velocity_input
from qpgesture_tpu.models.torch_convert import convert_pae
from qpgesture_tpu_torch.core.config import PAEConfig
from qpgesture_tpu_torch.models.convert import (load_pae_checkpoint,
                                                pae_state_dict_from_jax)
from qpgesture_tpu_torch.models.pae import PAE, PhaseExtractor, velocity_input

# float32 on both sides, other summation orders through the 240-tap convs
# and the FFT; the phase is compared on the circle (p wraps at +-0.5)
ATOL = 1e-4
SMALL = dict(frames=48, joints=3, channels_per_joint=3, phase_channels=4,
             keys=13, window=4.0)
TINY = dict(frames=16, joints=2, channels_per_joint=3, phase_channels=2)


def circular_err(got, want) -> float:
    """Largest distance between two phase arrays on the unit circle."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) % 1
    return float(np.minimum(d, 1 - d).max())


def port_pae(seed: int, **kw) -> PAE:
    """A port PAE with random weights and random BatchNorm statistics."""
    torch.manual_seed(seed)
    model = PAE(PAEConfig(**kw), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
        for name, p in model.named_parameters():
            if name.startswith("bn"):
                p.copy_(float(name.endswith("weight"))
                        + 0.2 * torch.randn(p.shape, generator=g))
    return model


def jax_pae(model: PAE, **kw):
    return JaxPAE(JaxPAEConfig(**kw)), convert_pae(
        model.state_dict(), model.cfg.phase_channels)


@pytest.mark.parametrize("kw", [SMALL, TINY], ids=["small", "tiny"])
def test_forward_matches_jax(kw):
    model = port_pae(0, **kw)
    jmodel, variables = jax_pae(model, **kw)
    cfg = model.cfg
    x = np.random.RandomState(0).randn(
        5, cfg.input_channels * cfg.frames).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name, g, w in zip(("y", "latent", "signal"), got[:3], want[:3]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    (p, f, a, b), (jp, jf, ja, jb) = got[3], want[3]
    assert p.shape == (5, cfg.phase_channels, 1)
    assert circular_err(p.numpy(), jp) <= ATOL
    for name, g, w in (("f", f, jf), ("a", a, ja), ("b", b, jb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_velocity_input_matches_jax():
    x = np.random.RandomState(1).randn(2, 10, 6).astype(np.float32)
    want = np.asarray(jax_velocity_input(jnp.asarray(x)))
    got = velocity_input(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,n,batch", [(TINY, 40, 1024), (TINY, 40, 16),
                                        ({}, 64, 24),
                                        (dict(TINY, frames=241), 40, 16),
                                        (dict(TINY, frames=256), 40, 1024)],
                         ids=["tiny", "tiny-tail", "default", "frames241",
                              "frames256"])
def test_pose_to_phase_matches_jax(kw, n, batch):
    """At PAEConfig(frames=16) the 120 / 119 padding of the default window
    applies all the same; at the default config (240 frames, 15 joints x 9,
    8 channels) a 64-frame pose, with an exact-size tail batch. Windows
    longer than 240 frames (241, 256) read past the padded tail, where the
    JAX package's clamped gather reads zero rows."""
    model = port_pae(2, **kw)
    jmodel, variables = jax_pae(model, **kw)
    cfg = model.cfg
    rng = np.random.RandomState(2)
    pose = rng.randn(n, cfg.input_channels).astype(np.float32)
    mean, std = pose.mean(0), pose.std(0)
    std[0] = 0.001                      # clipped to 0.01 on both sides
    want = JaxPhaseExtractor(jmodel, variables).pose_to_phase(
        pose, mean, std, batch=n)
    got = PhaseExtractor(model, device="cpu").pose_to_phase(
        pose, mean, std, batch=batch)
    assert got.shape == want.shape == (n, 4, cfg.phase_channels)
    assert got.dtype == np.float32
    assert circular_err(got[:, 0], want[:, 0]) <= ATOL
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=ATOL)


def test_state_dict_round_trip_is_exact():
    model = port_pae(3, **SMALL)
    sd = model.state_dict()
    back = pae_state_dict_from_jax(convert_pae(sd, 4), model.cfg)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back)


def test_reference_checkpoint_loads(tmp_path):
    """{'model_dict': ...} with the DataParallel 'module.' prefix, and a
    bare state_dict."""
    src = port_pae(4, **SMALL)
    path = str(tmp_path / "pae.pt")
    torch.save({"model_dict": {f"module.{k}": v for k, v in
                               src.state_dict().items()}, "epoch": 9}, path)
    model = load_pae_checkpoint(path, PAEConfig(**SMALL), device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert not model.training
    torch.save(src.state_dict(), path)
    model = load_pae_checkpoint(path, PAEConfig(**SMALL), device="cpu")
    assert torch.equal(model.conv2.weight, src.conv2.weight)
