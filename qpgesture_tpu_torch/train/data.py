"""Training input: windowed pose/audio samples from plain arrays.

The port of the JAX package's ``train/data.py`` (the reference's LMDB +
pyarrow cache, codebook/data_loader/lmdb_data_loader.py:20-74 and
data_preprocessor.py:30-106, as a memory-mapped npy store): clips are
windowed with the same MINLEN / stride arithmetic, normalized with the
dataset mean/std (std clipped at 0.01) and batched with a seeded
``np.random.RandomState`` shuffle, so batches are bit-equal to the JAX
package's for the same seed.

``DeviceClipStore`` keeps the raw clips on the device (one upload) and
gathers each batch's windows there from (B,) start indices;
``device_prefetch`` copies host batches from pinned memory with
``non_blocking=True`` so the copy overlaps the step before it.
"""
from __future__ import annotations

import collections
import io
import math
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def window_clip(poses: np.ndarray, audio: Optional[np.ndarray],
                n_poses: int, stride: int, fps: int = 60,
                sr: int = 16000) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Slice one clip into windows (DataPreprocessor.
    _sample_from_clip_allspeakers, data_preprocessor.py:55-106):
    num_subdivision = floor((MINLEN - n_poses) / stride) + 1; audio windows
    are aligned by fraction-of-clip, length n_poses/fps*sr."""
    minlen = len(poses)
    if audio is not None:
        minlen = min(minlen, int(len(audio) * fps / sr))
    n_sub = math.floor((minlen - n_poses) / stride) + 1
    if n_sub <= 0:
        empty_a = None if audio is None else np.zeros((0, 0), audio.dtype)
        return np.zeros((0, n_poses) + poses.shape[1:], poses.dtype), empty_a
    pose_wins = np.stack([poses[i * stride:i * stride + n_poses]
                          for i in range(n_sub)])
    audio_wins = None
    if audio is not None:
        alen = int(n_poses / fps * sr)
        outs = []
        for i in range(n_sub):
            start = math.floor(i * stride / len(poses) * len(audio))
            seg = audio[start:start + alen]
            if len(seg) < alen:
                seg = np.pad(seg, (0, alen - len(seg)))
            outs.append(seg)
        audio_wins = np.stack(outs)
    return pose_wins, audio_wins


def _batch_order(n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool) -> Iterator[np.ndarray]:
    """The row indices of each batch: a RandomState(seed) shuffle, the tail
    dropped unless drop_last is False."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        yield order[s:s + batch_size]


@dataclass
class WindowedDataset:
    """In-memory/memmap window store with z-normalization and batching."""
    poses: np.ndarray                     # (N, n_poses, C)
    audio: Optional[np.ndarray] = None    # (N, samples)
    codes: Optional[np.ndarray] = None    # (N, n_codes)
    data_mean: Optional[np.ndarray] = None
    data_std: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.poses.shape[0]

    def normalized_poses(self) -> np.ndarray:
        if self.data_mean is None:
            return self.poses
        std = np.clip(self.data_std, 0.01, None)
        return (self.poses - self.data_mean) / std

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                include: Sequence[str] = ("poses",)) -> Iterator:
        """Host batches: float32 poses normalized after the gather (a
        memory-mapped store is never copied whole), float32 audio, int32
        codes; one array, or a tuple in ``include``'s order."""
        std = None if self.data_mean is None \
            else np.clip(self.data_std, 0.01, None)
        for idx in _batch_order(len(self), batch_size, shuffle, seed,
                                drop_last):
            out = []
            for key in include:
                if key == "poses":
                    p = np.asarray(self.poses[idx], np.float32)
                    if std is not None:
                        p = (p - self.data_mean) / std
                    out.append(p.astype(np.float32))
                elif key == "audio":
                    out.append(self.audio[idx].astype(np.float32))
                elif key == "codes":
                    out.append(self.codes[idx].astype(np.int32))
            yield out[0] if len(out) == 1 else tuple(out)

    @classmethod
    def from_clips(cls, clips: List[dict], n_poses: int, stride: int,
                   fps: int = 60, data_mean=None, data_std=None
                   ) -> "WindowedDataset":
        """clips: [{'poses': (T, C), 'audio': (S,) or None}, ...]. Audio must
        be given for every clip or for none: mixing would misalign the
        concatenated pose and audio rows."""
        pose_list, audio_list = [], []
        for clip in clips:
            p, a = window_clip(clip["poses"], clip.get("audio"), n_poses,
                               stride, fps)
            if len(p):
                pose_list.append(p)
                if a is not None:
                    audio_list.append(a)
        if audio_list and len(audio_list) != len(pose_list):
            raise ValueError(
                f"{len(audio_list)} of {len(pose_list)} windowed clips have "
                "audio; mixed audio presence would misalign pose/audio rows "
                "— provide audio for every clip or for none")
        poses = np.concatenate(pose_list) if pose_list else \
            np.zeros((0, n_poses, clips[0]["poses"].shape[-1]))
        audio = np.concatenate(audio_list) if audio_list else None
        return cls(poses=poses, audio=audio,
                   data_mean=None if data_mean is None
                   else np.asarray(data_mean),
                   data_std=None if data_std is None
                   else np.asarray(data_std))

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "poses.npy"), self.poses)
        if self.audio is not None:
            np.save(os.path.join(directory, "audio.npy"), self.audio)
        if self.codes is not None:
            np.save(os.path.join(directory, "codes.npy"), self.codes)
        if self.data_mean is not None:
            np.savez(os.path.join(directory, "stats.npz"),
                     mean=self.data_mean, std=self.data_std)

    @classmethod
    def load(cls, directory: str, mmap: bool = True) -> "WindowedDataset":
        mode = "r" if mmap else None

        def opt(name):
            path = os.path.join(directory, name)
            return np.load(path, mmap_mode=mode) if os.path.exists(path) \
                else None

        mean = std = None
        sp = os.path.join(directory, "stats.npz")
        if os.path.exists(sp):
            stats = np.load(sp)
            mean, std = stats["mean"], stats["std"]
        return cls(poses=np.load(os.path.join(directory, "poses.npy"),
                                 mmap_mode=mode),
                   audio=opt("audio.npy"), codes=opt("codes.npy"),
                   data_mean=mean, data_std=std)


def clips_to_store(clips: List[dict], path: str) -> int:
    """Serialize raw clips into a RecordStore: each record is one clip's
    poses (+ audio) as npz bytes. Returns the record count."""
    from ..utils.native import RecordStore

    writer = RecordStore.create(path)
    for clip in clips:
        buf = io.BytesIO()
        np.savez(buf, poses=clip["poses"],
                 audio=clip.get("audio") if clip.get("audio") is not None
                 else np.zeros(0, np.float32))
        writer.append(buf.getvalue())
    return writer.finalize()


def _read_store_clips(path: str) -> List[dict]:
    from ..utils.native import RecordStore

    store = RecordStore.open(path)
    try:
        clips = []
        for i in range(len(store)):
            data = np.load(io.BytesIO(store[i]))
            audio = data["audio"]
            clips.append({"poses": data["poses"],
                          "audio": audio if audio.size else None})
        return clips
    finally:
        store.close()


def store_to_dataset(path: str, n_poses: int, stride: int, fps: int = 60,
                     data_mean=None, data_std=None) -> WindowedDataset:
    """Window every clip in a RecordStore into a WindowedDataset."""
    return WindowedDataset.from_clips(_read_store_clips(path), n_poses,
                                      stride, fps, data_mean, data_std)


class DeviceClipStore:
    """Device-resident training input: the raw clips go to the device once
    and each batch's overlapping windows are gathered there.

    ``WindowedDataset.from_clips`` materializes stride-32 overlapping
    240-frame windows (~n_poses/stride times the raw clips) that would be
    copied to the device every epoch; here one (sum T, C) float32 upload
    serves the whole run, and a batch is an index gather from (B,) start
    indices plus the normalization. The normalization runs in the dtype
    NumPy's promotion gives ``WindowedDataset.batches`` (float64 for float64
    statistics), then rounds to float32, so batches are bit-equal to
    ``WindowedDataset.from_clips(...).batches(...)`` with the same seed.
    """

    def __init__(self, clips: List[dict], n_poses: int, stride: int,
                 data_mean=None, data_std=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        starts: List[int] = []
        offset = 0
        for clip in clips:
            n = len(clip["poses"])
            starts += [offset + i * stride
                       for i in range(max(math.floor((n - n_poses) / stride)
                                          + 1, 0))]
            offset += n
        flat = np.concatenate([np.asarray(c["poses"]) for c in clips]
                              ).astype(np.float32)
        self.n_poses = n_poses
        self._starts = np.asarray(starts, np.int64)
        self._flat = torch.from_numpy(flat).to(self.device)
        self._arange = torch.arange(n_poses, device=self.device)
        self._mean = self._std = None
        if data_mean is not None:
            mean = np.asarray(data_mean)
            std = np.clip(np.asarray(data_std), 0.01, None)
            dtype = np.result_type(np.float32, mean, std)
            self._mean = torch.from_numpy(mean.astype(dtype)).to(self.device)
            self._std = torch.from_numpy(std.astype(dtype)).to(self.device)

    @classmethod
    def from_store(cls, path: str, n_poses: int, stride: int,
                   data_mean=None, data_std=None,
                   device: DeviceLike = "cuda") -> "DeviceClipStore":
        """Build from a raw-clip RecordStore (clips_to_store output)."""
        return cls(_read_store_clips(path), n_poses, stride, data_mean,
                   data_std, device)

    def __len__(self) -> int:
        return len(self._starts)

    def gather(self, starts: torch.Tensor) -> torch.Tensor:
        """(B,) start rows (int64, on the device) -> (B, n_poses, C) float32
        windows, normalized when statistics were given."""
        win = self._flat[starts[:, None] + self._arange[None, :]]
        if self._mean is not None:
            win = ((win.to(self._mean.dtype) - self._mean) / self._std
                   ).to(torch.float32)
        return win

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True) -> Iterator:
        """Yields (B, n_poses, C) device batches, in WindowedDataset's
        order for the same seed."""
        for idx in _batch_order(len(self), batch_size, shuffle, seed,
                                drop_last):
            starts = torch.from_numpy(self._starts[idx])
            yield self.gather(starts.to(self.device, non_blocking=True))


def _to_device(batch, device: torch.device):
    if isinstance(batch, (tuple, list)):
        return tuple(_to_device(b, device) for b in batch)
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(batch))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def device_prefetch(batches, device: DeviceLike, size: int = 2) -> Iterator:
    """Keep ``size`` batches in flight on ``device``: host batches (arrays,
    tensors or tuples of them) are copied from pinned memory with
    ``non_blocking=True``, so the copy of batch i+1 overlaps step i; a batch
    already on the device passes through."""
    dev = resolve_device(device)
    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in it:
        queue.append(_to_device(batch, dev))
        if len(queue) >= size:
            break
    while queue:
        batch = queue.popleft()
        for nxt in it:
            queue.append(_to_device(nxt, dev))
            break
        yield batch


def dataset_stats(clips: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over all frames of all clips — the numbers the
    reference prints for pasting into YAML (beat_data_to_lmdb.py:255-262)."""
    all_poses = np.concatenate([c["poses"] for c in clips], axis=0)
    return all_poses.mean(axis=0), all_poses.std(axis=0)
