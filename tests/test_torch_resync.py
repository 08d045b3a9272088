"""ResyncNet: a random port module with the reference's parameter names,
converted to flax by the JAX package's convert_resync, runs like JAX's
ResyncNet; predict_resynced_gesture and resync_stats equal JAX's; the
checkpoint loaders; resync-apply and generate --resync through both CLIs on
the same files."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.models.resync import ResyncNet as JaxResyncNet
from qpgesture_tpu.models.resync import \
    predict_resynced_gesture as jax_predict
from qpgesture_tpu.models.resync import resync_stats as jax_stats
from qpgesture_tpu.models.torch_convert import convert_resync
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.models.convert import (load_resync_checkpoint,
                                                resync_state_dict_from_jax)
from qpgesture_tpu_torch.models.resync import (ResyncNet,
                                               predict_resynced_gesture,
                                               resync_stats)
from qpgesture_tpu_torch.motion.bvh import parse_bvh

from fixtures import make_fixture
from test_torch_end2end import (randomize_batchnorm, read_generated,
                                write_end2end_inputs)

# float32 on both sides through 15 convs of 3 taps and 128-512 channels,
# other summation orders
ATOL = 1e-4


def port_resync(seed: int, in_features: int = 148, out_features: int = 135):
    torch.manual_seed(seed)
    model = ResyncNet(in_features, out_features, device="cpu")
    randomize_batchnorm(model, seed)
    return model


@pytest.mark.parametrize("T", [48, 50])
def test_forward_matches_jax(T):
    """T=48 runs the UNet. At T=50 the second pooling drops an odd last
    frame, as both packages' avg_pool1d drop it, so the skip concatenation
    fails in both alike."""
    model = port_resync(0)
    variables = convert_resync(model.state_dict())
    x = np.random.RandomState(T).randn(2, T, 148).astype(np.float32)
    jmodel = JaxResyncNet(out_features=135)
    if T % 8:
        with pytest.raises(Exception):
            jmodel.apply(variables, jnp.asarray(x), train=False)
        with pytest.raises(RuntimeError):
            model(torch.from_numpy(x.transpose(0, 2, 1)))
        return
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, rtol=0,
                               atol=ATOL)


def test_predict_resynced_gesture_matches_jax():
    rng = np.random.RandomState(3)
    model = port_resync(1, in_features=13 + 9, out_features=9)
    variables = convert_resync(model.state_dict())
    train_mfcc = rng.randn(5, 32, 13).astype(np.float32)
    train_motion = (rng.randn(5, 32, 9) * 2 + 0.3).astype(np.float32)
    stats = resync_stats(train_mfcc, train_motion)
    for a, b in zip(stats, jax_stats(train_mfcc, train_motion)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    mfcc = rng.randn(3, 32, 13).astype(np.float32)
    knn = rng.randn(3, 32, 9).astype(np.float32)
    want = jax_predict(JaxResyncNet(out_features=9), variables, mfcc, knn,
                       *stats)
    got = predict_resynced_gesture(model, mfcc, knn, *stats)
    assert got.shape == (3, 32, 9) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * float(stats[3].max()))
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        predict_resynced_gesture(model, mfcc, knn, *stats)


def test_checkpoint_layouts_and_round_trip(tmp_path):
    model = port_resync(2, in_features=13 + 9, out_features=9)
    sd = model.state_dict()
    back = resync_state_dict_from_jax(convert_resync(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 22, 16).astype(np.float32))
    with torch.no_grad():
        want = model(x)
    for name, ckpt in (("best_model", {"model_resync_state_dict": sd,
                                       "iteration": 7}),
                       ("bare", sd),
                       ("parallel", {f"module.{k}": v
                                     for k, v in sd.items()})):
        path = str(tmp_path / f"{name}.pth")
        torch.save(ckpt, path)
        loaded = load_resync_checkpoint(path, device="cpu")
        assert not loaded.training
        with torch.no_grad():
            assert torch.equal(loaded(x), want), name
    # a directory is read as a train-resync output: an orbax directory of
    # the JAX trainer raises, naming the file it lacks and what it holds
    orbax = tmp_path / "orbax_dir"
    (orbax / "latest").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match=r"latest\.pt.*'latest'"):
        load_resync_checkpoint(str(orbax), device="cpu")


def test_resync_apply_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    N, T, J, M = 3, 16, 9, 5
    model = port_resync(3, in_features=M + J, out_features=J)
    ckpt = str(tmp_path / "best_model.pth")
    torch.save({"model_resync_state_dict": model.state_dict()}, ckpt)
    train_path = str(tmp_path / "train.npz")
    np.savez(train_path, mfcc=rng.randn(4, T, M + 1).astype(np.float32),
             body=rng.randn(4, T, J).astype(np.float32))
    test_path = str(tmp_path / "test.npz")
    np.savez(test_path, mfcc=rng.randn(N, T, M + 1).astype(np.float32))
    for layout, knn in (("njt", rng.randn(N, J, T)),
                        ("ntj", rng.randn(N, T, J))):
        knn_path = str(tmp_path / f"knn_{layout}.npz")
        np.savez(knn_path, knn_pred=knn.astype(np.float32))
        for frames in ("0", "2"):
            args = ["resync-apply", "--knn", knn_path, "--test-data",
                    test_path, "--train-database", train_path,
                    "--checkpoint", ckpt, "--n-mfcc", str(M),
                    "--layout", layout, "--frames", frames]
            outs = []
            for name, cli, dev in (("jax", jax_cli, []),
                                   ("port", port_cli, ["--device", "cpu"])):
                out = str(tmp_path / f"{name}_{layout}_{frames}.npz")
                cli(args + ["--out", out] + dev)
                outs.append(np.load(out)["knn_pred"])
            want, got = outs
            assert got.shape == want.shape
            assert got.shape[0] == (2 if frames == "2" else N)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_generate_resync_matches_jax(tmp_path):
    """generate --model end2end --resync: the full-width ResyncNet over the
    decoded motion of each 4 s window, MFCCs from the wav on the host,
    stats from the train database; BVH motion within 1e-3 of JAX's."""
    rng = np.random.RandomState(22)
    args = write_end2end_inputs(tmp_path, rng, seconds=8.5)
    fx = make_fixture(rng, n_seq=3, n_test=1, codebook=64)
    db_path = str(tmp_path / "db.npz")
    fx["bundle"].save(db_path)
    ckpt = str(tmp_path / "best_model.pth")
    torch.save({"model_resync_state_dict": port_resync(4).state_dict()},
               ckpt)
    args += ["--resync", ckpt, "--train-database", db_path]
    texts = []
    for name, cli, dev in (("jax", jax_cli, []),
                           ("port", port_cli, ["--device", "cpu"])):
        out_dir = str(tmp_path / name)
        cli(args + ["--out", out_dir] + dev)
        texts.append(read_generated(out_dir)[0])
    plain = str(tmp_path / "plain")
    port_cli(args[:-4] + ["--out", plain, "--device", "cpu"])
    want, got = parse_bvh(texts[0]), parse_bvh(texts[1])
    assert got.values.shape == want.values.shape == (3 * 240,
                                                     want.values.shape[1])
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-3)
    assert not np.allclose(got.values, parse_bvh(
        read_generated(plain)[0]).values, atol=1e-2)
    assert os.path.exists(os.path.join(plain, "code_e2e.npy"))
