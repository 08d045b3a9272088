"""Trinity / GENEA 2020 builder: the port's pipelines/trinity.py against the
JAX package's on tests/test_trinity.py's fixture layout. Subtitles and
rotation clips are equal; position clips (float32 forward kinematics in
torch and in XLA) agree to 1e-5; the stores the two builders write are byte
for byte the same (np.savez stamps each record's zip entry with the clock,
which both builds read from one fixed time) and each package reads the
other's; the CLIs print the same mean/std lines."""
import contextlib
import io
import os
import time
import types
import zipfile

import numpy as np
import pytest

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.motion.bvh import parse_bvh as jax_parse_bvh
from qpgesture_tpu.pipelines import trinity as jt
from qpgesture_tpu.train.data import window_clip as jax_window_clip
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.motion.bvh import parse_bvh
from qpgesture_tpu_torch.pipelines import trinity as pt
from qpgesture_tpu_torch.train.data import window_clip

from test_motion import make_bvh_text
from test_trinity import _fixture_split, _write_subtitle

# float32 forward kinematics, other summation orders, positions of O(10)
POS_ATOL = 1e-5


@pytest.fixture
def fixed_clock(monkeypatch):
    """np.savez's zip entries carry time.localtime(time.time()): both
    builds read one fixed time, so their stores can be compared as bytes."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.6e9, localtime=time.localtime))


def test_read_trinity_subtitle_matches_jax(tmp_path):
    p = str(tmp_path / "t.json")
    _write_subtitle(p, [(0.1, 0.5, "Hello,"), (0.6, 1.0, "shouldn't"),
                        (1.1, 1.2, "&&&"), (1.3, 2.0, "Num6ers")])
    got = pt.read_trinity_subtitle(p)
    assert got == jt.read_trinity_subtitle(p)
    assert got[:2] == [(0.1, 0.5, "hello ,"), (0.6, 1.0, "shouldnt")]


def test_clips_match_jax():
    text = make_bvh_text(np.random.RandomState(0), n_frames=96, fps=120)[0]
    bvh, jbvh = parse_bvh(text), jax_parse_bvh(text)
    for got, want in zip(pt.trinity_rotation_clip(bvh),
                         jt.trinity_rotation_clip(jbvh)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = pt.trinity_position_clip(bvh, device="cpu")
    want = jt.trinity_position_clip(jbvh)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=POS_ATOL)


def _splits(tmp_path, seed):
    rng = np.random.RandomState(seed)
    trn, val = str(tmp_path / "Training_data"), str(tmp_path / "Test_data")
    _fixture_split(trn, rng)
    _fixture_split(val, rng, n_clips=1)
    return trn, val


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def test_rotation_stores_byte_equal_and_mutually_readable(tmp_path,
                                                          fixed_clock):
    """Rotation mode: the store files, index included, are byte-equal;
    stats.npz holds the same arrays; either package reads either store;
    the port's window_clip gives JAX's windows."""
    trn, val = _splits(tmp_path, 1)
    got = pt.build_trinity_dataset(trn, val, mode="rotation",
                                   out_dir=str(tmp_path / "port"),
                                   device="cpu")
    want = jt.build_trinity_dataset(trn, val, mode="rotation",
                                    out_dir=str(tmp_path / "jax"))
    port_files, jax_files = _files(str(tmp_path / "port")), \
        _files(str(tmp_path / "jax"))
    assert port_files.keys() == jax_files.keys()
    for name in port_files:
        if name != "stats.npz":
            assert port_files[name] == jax_files[name], name
    for key in ("mean", "std"):
        np.testing.assert_array_equal(np.load(got["stats"])[key],
                                      np.load(want["stats"])[key])
    for split in ("train", "test"):
        a = pt.load_trinity_store(want[split])      # port reads JAX's
        b = jt.load_trinity_store(got[split])       # JAX reads the port's
        assert len(a) == len(b) == (4 if split == "train" else 2)
        for x, y in zip(a, b):
            assert x["vid"] == y["vid"] and x["words"] == y["words"]
            np.testing.assert_array_equal(x["poses"], y["poses"])
            np.testing.assert_array_equal(x["audio"], y["audio"])
    clip = pt.load_trinity_store(got["train"])[0]
    for g, w in zip(window_clip(clip["poses"], clip["audio"], n_poses=120,
                                stride=60, fps=60),
                    jax_window_clip(clip["poses"], clip["audio"],
                                    n_poses=120, stride=60, fps=60)):
        np.testing.assert_array_equal(g, w)


def test_position_stores_match_jax(tmp_path, fixed_clock):
    """Position mode: the same records and words, poses within POS_ATOL
    (float32 forward kinematics); both packages read both stores."""
    trn, val = _splits(tmp_path, 2)
    got = pt.build_trinity_dataset(trn, val, mode="position",
                                   out_dir=str(tmp_path / "port"),
                                   device="cpu")
    want = jt.build_trinity_dataset(trn, val, mode="position",
                                    out_dir=str(tmp_path / "jax"))
    for split in ("train", "test"):
        a, b = pt.load_trinity_store(got[split]), \
            jt.load_trinity_store(want[split])
        assert len(a) == len(b) == (2 if split == "train" else 1)
        for x, y in zip(a, b):
            assert x["vid"] == y["vid"] and x["words"] == y["words"]
            np.testing.assert_array_equal(x["audio"], y["audio"])
            np.testing.assert_allclose(x["poses"], y["poses"], rtol=0,
                                       atol=POS_ATOL)
        assert len(jt.load_trinity_store(got[split])) == len(a)
    np.testing.assert_allclose(np.load(got["stats"])["mean"],
                               np.load(want["stats"])["mean"], rtol=0,
                               atol=POS_ATOL)


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return buf.getvalue().splitlines()


def test_build_db_trinity_cli_prints_what_jax_prints(tmp_path, fixed_clock):
    """build-db --dataset trinity (rotation): the printed mean/std lines
    equal, the written paths the same under each output directory."""
    trn, val = _splits(tmp_path, 3)
    lines = {}
    for name, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                             ("jax", jax_cli, [])):
        out = str(tmp_path / name)
        lines[name] = [ln.replace(out, "<out>") for ln in _run(cli, [
            "build-db", "--dataset", "trinity", "--trn-path", trn,
            "--val-path", val, "--mode", "rotation", "--out", out] + extra)]
    assert lines["port"] == lines["jax"]
    assert lines["port"][0] == "data mean/std"
    assert lines["port"][-3:] == ["wrote train: <out>/lmdb_train",
                                  "wrote test: <out>/lmdb_test",
                                  "wrote stats: <out>/stats.npz"]
    with pytest.raises(SystemExit, match="--trn-path"):
        port_cli(["build-db", "--dataset", "trinity", "--out",
                  str(tmp_path / "x"), "--device", "cpu"])
