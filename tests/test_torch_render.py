"""Offline analysis and rendering: render/analytics.py equal to the JAX
package's; each plot function and the ``plot`` CLI write the files JAX's
write; ``generate --video`` writes an animation of as many frames as JAX's;
the motion helpers (slice_windows, ListStandardScaler, the expmap
conversions) equal JAX's. matplotlib renders at a low dpi here (both
packages alike): the size of a frame is not what is compared."""
import contextlib
import io
import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.motion import pipeline as jpipe
from qpgesture_tpu.motion import rotations as jrot
from qpgesture_tpu.render import analytics as janalytics
from qpgesture_tpu.render import plots as jplots
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.motion import pipeline as ppipe
from qpgesture_tpu_torch.motion import rotations as prot
from qpgesture_tpu_torch.render import analytics, plots
from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory


@pytest.fixture(autouse=True)
def low_dpi(monkeypatch):
    monkeypatch.setitem(matplotlib.rcParams, "figure.dpi", 16)
    monkeypatch.setitem(matplotlib.rcParams, "savefig.dpi", 16)


def _frames(path):
    with Image.open(path) as im:
        return getattr(im, "n_frames", 1)


def test_analytics_match_jax():
    rng = np.random.RandomState(0)
    sig = rng.randn(64, 20)
    for standardize in (True, False):
        np.testing.assert_array_equal(
            analytics.signature_pca(sig, 3, standardize),
            janalytics.signature_pca(sig, 3, standardize))
    codes = rng.randint(0, 12, (9, 30))
    for top in (None, 5):
        assert analytics.code_frequency(codes, top) == \
            janalytics.code_frequency(codes, top)
    vocab = ["so", "we", "move", "hands", "when", "speak", ""]
    words = [[" ".join(rng.choice(vocab, rng.randint(0, 3)))
              for _ in range(rng.randint(25, 31))] for _ in range(9)]
    for min_count in (1, 2):
        assert analytics.code_word_association(codes, words, min_count) == \
            janalytics.code_word_association(codes, words, min_count)


def _history(path):
    with ScalarHistory(path) as hist:
        for epoch in range(1, 4):
            for step in range(0, 20, 5):
                hist.log(epoch, step, loss=1.0 / (epoch + step),
                         fit=0.1 * step)


def _phase(rng, fmt):
    dense = rng.rand(2, 40, 4, 8).astype(np.float32)
    if fmt == "dense":
        return dense
    out = np.empty((2, 40, 4), dtype=object)
    for i in np.ndindex(out.shape):
        out[i] = dense[i].reshape(1, 8, 1)
    return out


def _figs(d, rng, n=3):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i}.png"))
    return os.path.join(d, "{}.png")


def test_plot_functions_write_what_jax_writes(tmp_path):
    rng = np.random.RandomState(1)
    hist = str(tmp_path / "scalars.jsonl")
    _history(hist)
    phase = _phase(rng, "dense")
    wav = rng.randn(8000).astype(np.float32)
    pattern = _figs(str(tmp_path / "figs"), rng)
    written = {}
    for name, mod in (("port", plots), ("jax", jplots)):
        d = tmp_path / name
        d.mkdir()
        written[name] = [
            mod.plot_scalar_history(hist, str(d / "s.png"), tags=["loss"]),
            mod.plot_wav_debug(wav, 16000, str(d / "w.png")),
            mod.plot_phase_channels([phase[0, :16], phase[1, :16]],
                                    str(d / "c.png")),
            mod.plot_phase_manifold(phase[0], str(d / "m.png")),
            mod.merge_frames(pattern, str(d / "merged.mp4"), count=4)]
    assert [os.path.relpath(p, tmp_path / "port") for p in written["port"]] \
        == [os.path.relpath(p, tmp_path / "jax") for p in written["jax"]]
    for p, q in zip(written["port"], written["jax"]):
        assert os.path.getsize(p) > 0
        assert _frames(p) == _frames(q)
    with pytest.raises(ValueError, match="no scalar series"):
        plots.plot_scalar_history(hist, str(tmp_path / "x.png"),
                                  tags=["missing"])


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return buf.getvalue().splitlines()


def test_plot_cli_matches_jax(tmp_path):
    """plot with every flag: --history (a scalars.jsonl the port's
    ScalarHistory writes), --phase (the reference's object npz; the dense
    layout is what the plot functions take above) with --phase-debug,
    --wav (an npz), --merge-figs: the same files."""
    rng = np.random.RandomState(2)
    hist = str(tmp_path / "scalars.jsonl")
    _history(hist)
    np.savez(str(tmp_path / "phase.npz"), phase=_phase(rng, "object"))
    np.savez(str(tmp_path / "wav.npz"),
             wav=rng.randn(8000).astype(np.float32))
    pattern = _figs(str(tmp_path / "figs"), rng)
    lines = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = str(tmp_path / name)
        lines[name] = [ln.replace(out, "<out>") for ln in _run(cli, [
            "plot", "--history", hist, "--phase",
            str(tmp_path / "phase.npz"), "--phase-debug", "--seed", "3",
            "--wav", str(tmp_path / "wav.npz"), "--merge-figs", pattern,
            "--count", "4", "--fps", "10", "--out", out])]
    assert lines["port"] == lines["jax"]
    assert [ln for ln in lines["port"] if ln.startswith("wrote")] == [
        f"wrote <out>/{f}" for f in (
            "scalars.png", "visualize_phase.png", "visualize_phase_3.png",
            "phase_manifold.png", "wav_debug.png", "merged_figs.gif")]
    with pytest.raises(SystemExit, match="pass --history"):
        port_cli(["plot", "--out", str(tmp_path / "none")])


def test_generate_video_frame_count_matches_jax(tmp_path):
    """generate --video (wavvq preset, one 4 s window) through both CLIs:
    the same file name (a GIF here, without ffmpeg) holding as many frames,
    every decoded frame."""
    from fixtures import make_fixture
    from test_torch_rawwav import _write_generate_inputs
    rng = np.random.RandomState(17)
    args = _write_generate_inputs(tmp_path, make_fixture(
        rng, n_seq=4, n_test=1, codebook=64), rng, "wavvq") + ["--video"]
    got = {}
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("jax", jax_cli, [])):
        out = str(tmp_path / name)
        lines = _run(cli, args + ["--out", out] + extra)
        got[name] = lines[-1].replace(out, "<out>")
        got[name + "_frames"] = _frames(lines[-1].split(" ", 1)[1])
    assert got["port"] == got["jax"] == "wrote <out>/g_generated.gif"
    assert got["port_frames"] == got["jax_frames"] == 240


def test_motion_helpers_match_jax():
    rng = np.random.RandomState(4)
    tracks = [rng.randn(n, 5) for n in (100, 30, 64, 10)]
    for overlap in (0.5, 0.25, 0.0):
        np.testing.assert_array_equal(
            ppipe.slice_windows(tracks, 32, overlap),
            jpipe.slice_windows(tracks, 32, overlap))
    assert ppipe.slice_windows([rng.randn(5, 3)], 32).shape == (0, 32, 3)
    same_len = [rng.randn(40, 5) for _ in range(3)]
    scaler, jscaler = ppipe.ListStandardScaler().fit(same_len), \
        jpipe.ListStandardScaler().fit(same_len)
    z = scaler.transform(same_len)
    np.testing.assert_array_equal(z, jscaler.transform(same_len))
    np.testing.assert_array_equal(scaler.inverse_transform(z),
                                  jscaler.inverse_transform(z))
    np.testing.assert_allclose(scaler.inverse_transform(z),
                               np.array(same_len), rtol=0, atol=1e-12)

    euler = rng.uniform(-170, 170, (50, 4, 3))
    ev = prot.euler_to_expmap(euler)
    np.testing.assert_array_equal(ev, jrot.euler_to_expmap(euler))
    np.testing.assert_array_equal(prot.expmap_to_euler(ev),
                                  jrot.expmap_to_euler(ev))
    rv = ev.reshape(50, -1)[:, :3]
    flipped = rv.copy()
    flipped[::3] = flipped[::3] / np.linalg.norm(
        flipped[::3], axis=1, keepdims=True) * (
        np.linalg.norm(flipped[::3], axis=1, keepdims=True) - 2 * np.pi)
    np.testing.assert_array_equal(prot.unroll_expmap(flipped),
                                  jrot.unroll_expmap(flipped))
