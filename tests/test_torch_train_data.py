"""The trainers' input path: windowing and batches bit-equal to the JAX
package's for the same seed, the device clip store equal to the host
batches, device_prefetch, a RecordStore written by either package (and
either the native or the Python path) read by the other, and the scalar
history read across."""
import io
import os

import numpy as np
import pytest
import torch

from qpgesture_tpu.train import data as jdata
from qpgesture_tpu.utils.metrics_log import ScalarHistory as JaxHistory
from qpgesture_tpu.utils.native import RecordStore as JaxStore
from qpgesture_tpu_torch.train import data as pdata
from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory
from qpgesture_tpu_torch.utils.native import (RecordStore, _PyStore,
                                              _PyStoreWriter, get_lib)


def _clips(rng, audio: bool, c=9):
    out = []
    for n in (300, 410, 90, 241):
        clip = {"poses": rng.randn(n, c).astype(np.float32)}
        if audio:
            clip["audio"] = rng.randn(int(n / 60 * 16000) - 7).astype(
                np.float32)
        out.append(clip)
    return out


@pytest.mark.parametrize("n_poses,stride", [(40, 16), (240, 32), (90, 1)])
def test_window_clip_matches_jax(n_poses, stride):
    rng = np.random.RandomState(n_poses)
    clip = _clips(rng, audio=True)[1]
    got = pdata.window_clip(clip["poses"], clip["audio"], n_poses, stride)
    want = jdata.window_clip(clip["poses"], clip["audio"], n_poses, stride)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stats_dtype", [None, np.float32, np.float64])
def test_windowed_dataset_batches_bit_equal_to_jax(tmp_path, stats_dtype):
    """Every batch of every include, shuffled and not, with and without
    the tail, through save/load (memory-mapped)."""
    rng = np.random.RandomState(1)
    clips = _clips(rng, audio=True)
    kw = {}
    if stats_dtype is not None:
        kw = dict(data_mean=rng.randn(9).astype(stats_dtype),
                  data_std=(0.005 + np.abs(rng.randn(9))).astype(stats_dtype))
    p = pdata.WindowedDataset.from_clips(clips, 40, 16, **kw)
    j = jdata.WindowedDataset.from_clips(clips, 40, 16, **kw)
    p.codes = j.codes = rng.randint(0, 512, (len(p), 30))
    p.save(str(tmp_path / "p"))
    loaded = pdata.WindowedDataset.load(str(tmp_path / "p"))
    jloaded = jdata.WindowedDataset.load(str(tmp_path / "p"))
    n = 0
    for args in (dict(seed=3), dict(seed=4, drop_last=False),
                 dict(shuffle=False)):
        for inc in (("poses",), ("audio", "codes"), ("poses", "codes")):
            for ds, jds in ((p, j), (loaded, jloaded)):
                for got, want in zip(ds.batches(8, include=inc, **args),
                                     jds.batches(8, include=inc, **args),
                                     strict=True):
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        np.testing.assert_array_equal(g, w)
                        n += 1
    assert n > 100


@pytest.mark.parametrize("stats_dtype", [None, np.float32, np.float64])
def test_device_clip_store_bit_equal_to_host_batches(stats_dtype):
    """DeviceClipStore on the CPU: the same windows in the same order, and
    bit-equal to WindowedDataset's normalized batches."""
    rng = np.random.RandomState(2)
    clips = _clips(rng, audio=False)
    kw = {}
    if stats_dtype is not None:
        kw = dict(data_mean=rng.randn(9).astype(stats_dtype),
                  data_std=(0.005 + np.abs(rng.randn(9))).astype(stats_dtype))
    host = pdata.WindowedDataset.from_clips(clips, 40, 16, **kw)
    store = pdata.DeviceClipStore(clips, 40, 16, device="cpu", **kw)
    assert len(store) == len(host) == len(
        jdata.WindowedDataset.from_clips(clips, 40, 16))
    n = 0
    for args in (dict(seed=5), dict(seed=6, drop_last=False)):
        for hb, db in zip(host.batches(8, **args), store.batches(8, **args),
                          strict=True):
            assert db.dtype == torch.float32 and db.device.type == "cpu"
            np.testing.assert_array_equal(db.numpy(), hb)
            n += 1
    assert n == len(host) // 8 + -(-len(host) // 8)


def test_device_clip_store_from_store(tmp_path):
    rng = np.random.RandomState(3)
    clips = _clips(rng, audio=True)
    path = str(tmp_path / "clips.qpg")
    assert pdata.clips_to_store(clips, path) == len(clips)
    store = pdata.DeviceClipStore.from_store(path, 40, 16, device="cpu")
    host = pdata.WindowedDataset.from_clips(
        [{"poses": c["poses"]} for c in clips], 40, 16)
    for hb, db in zip(host.batches(4, seed=1), store.batches(4, seed=1),
                      strict=True):
        np.testing.assert_array_equal(db.numpy(), hb)


def test_device_prefetch_keeps_order_and_tuples():
    rng = np.random.RandomState(4)
    batches = [(rng.randn(4, 8).astype(np.float32),
                rng.randint(0, 9, (4, 3)).astype(np.int32))
               for _ in range(5)]
    out = list(pdata.device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for (a, b), (wa, wb) in zip(out, batches):
        np.testing.assert_array_equal(a.numpy(), wa)
        np.testing.assert_array_equal(b.numpy(), wb)
    on_device = [torch.zeros(2), torch.ones(2)]
    assert all(a is b for a, b in zip(
        pdata.device_prefetch(on_device, "cpu"), on_device))
    assert list(pdata.device_prefetch([], "cpu")) == []


@pytest.mark.parametrize("writer", ["port-native", "port-python", "jax"])
def test_record_store_read_across_packages(tmp_path, writer):
    """A store written by either package, native or Python path, reads back
    byte for byte through every reader; both packages window it alike."""
    if writer == "port-native" and get_lib() is None:
        pytest.skip("the native library does not build here")
    rng = np.random.RandomState(5)
    clips = _clips(rng, audio=True)
    del clips[2]["audio"]
    path = str(tmp_path / "s.qpg")
    if writer == "jax":
        jdata.clips_to_store(clips, path)
    else:
        w = RecordStore.create(path) if writer == "port-native" \
            else _PyStoreWriter(path)
        for clip in clips:
            buf = io.BytesIO()
            np.savez(buf, poses=clip["poses"],
                     audio=clip.get("audio") if clip.get("audio") is not None
                     else np.zeros(0, np.float32))
            w.append(buf.getvalue())
        assert w.finalize() == len(clips)
    readers = [_PyStore(path), JaxStore.open(path)]
    if get_lib() is not None:
        readers.append(RecordStore.open(path))
    blobs = [[r[i] for i in range(len(r))] for r in readers]
    assert all(b == blobs[0] for b in blobs) and len(blobs[0]) == 4
    for r in readers:
        r.close()
    with open(path, "rb") as f:
        raw = f.read()
    # the port's writer writes the JAX writer's bytes
    other = str(tmp_path / "o.qpg")
    pdata.clips_to_store(clips, other)
    with open(other, "rb") as f:
        assert f.read() == raw
    # clips with and without audio would misalign rows: both packages refuse
    with pytest.raises(ValueError, match="misalign"):
        pdata.store_to_dataset(path, 40, 16)
    with pytest.raises(ValueError, match="misalign"):
        jdata.store_to_dataset(path, 40, 16)


def test_store_to_dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    clips = _clips(rng, audio=True)
    path = str(tmp_path / "s.qpg")
    pdata.clips_to_store(clips, path)
    mean, std = np.zeros(9), np.ones(9) * 2
    got = pdata.store_to_dataset(path, 40, 16, data_mean=mean, data_std=std)
    want = jdata.store_to_dataset(path, 40, 16, data_mean=mean, data_std=std)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.audio, want.audio)
    for g, w in zip(got.batches(8, seed=2), want.batches(8, seed=2),
                    strict=True):
        np.testing.assert_array_equal(g, w)


def test_corrupt_store_fails_to_open(tmp_path):
    path = str(tmp_path / "s.qpg")
    pdata.clips_to_store(_clips(np.random.RandomState(7), audio=False), path)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-5])
    with pytest.raises(OSError):
        _PyStore(path)
    if get_lib() is not None:
        with pytest.raises(OSError):
            RecordStore.open(path)


def test_scalar_history_read_across(tmp_path):
    """Each package reads the other's scalars.jsonl, rows in write order."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    with ScalarHistory(a) as h:
        h.log(epoch=1, step=0, loss=0.5, fit=1.25)
        h.log(epoch=2, val_err=0.25, best_val_err=0.25)
    with JaxHistory(b) as h:
        h.log(epoch=1, step=0, loss=0.5, fit=1.25)
        h.log(epoch=2, val_err=0.25, best_val_err=0.25)
    for path in (a, b):
        want = {"loss": [(1, 0, 0.5)], "fit": [(1, 0, 1.25)],
                "val_err": [(2, 0, 0.25)], "best_val_err": [(2, 0, 0.25)]}
        assert ScalarHistory.read(path) == JaxHistory.read(path) == want
        assert ScalarHistory.last(path, "best_val_err") == 0.25
    assert os.path.getsize(a) > 0
