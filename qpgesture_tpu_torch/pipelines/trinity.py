"""Trinity / GENEA Challenge 2020 dataset builder.

The reference ships a second-dataset builder alongside BEAT
(process/trinity_data_to_lmdb.py:28-80): per recording it runs the pymo
pipeline (DownSampler 60fps -> hip-centric root -> [Mirror] -> joint
select -> ConstantsRemover) in 'rotation' (euler -> 3x3 rotation matrices,
original + mirrored clips) or 'position' (FK world positions, constant
channels dropped, 3 root zeros re-padded, 15*3 dims) mode, reads the
GENEA Google-Speech-style JSON transcripts (SubtitleWrapper,
utils/data_utils.py:15-48), loads 16 kHz mono audio, and writes
{vid, poses, words, audio_raw} clips to lmdb_train / lmdb_test, printing
the dataset pose mean/std for the training YAML
(trinity_data_to_lmdb.py:84-95).

The port of the JAX package's ``pipelines/trinity.py``: the same motion
pipeline (motion/pipeline.py), the same RecordStore format
(utils/native.py) instead of LMDB+pyarrow, so either package reads the
other's store, and stats.npz beside the printed mean/std. Everything runs
on the host except the 'position' mode's forward kinematics, which runs
on ``device`` (``motion/fk``). A Trinity store feeds the trainers through
train/data.py.
"""
from __future__ import annotations

import glob
import io
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import constants as C
from ..device import DeviceLike
from ..motion.bvh import BVHData, parse_bvh
from ..motion.fk import positions_for_render
from ..motion.pipeline import MotionPipeline, downsample, root_center
from ..motion.rotations import poses_to_matrices
from .transcripts import Word, normalize_string


def read_trinity_subtitle(path: str) -> List[Word]:
    """GENEA transcript JSON (Google-Speech layout: a list of result items,
    each with alternatives[0].words carrying start_time/end_time strings
    with a trailing 's') -> [(start_s, end_s, normalized_word)].

    Word normalization is the reference's normalize_string
    (trinity_data_to_lmdb.py:146-150): empty-after-normalization words are
    dropped."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: List[Word] = []
    for item in data:
        words = item.get("alternatives", [{}])[0].get("words", [])
        for w in words:
            s = float(str(w["start_time"]).rstrip("s"))
            e = float(str(w["end_time"]).rstrip("s"))
            word = normalize_string(str(w["word"]))
            if word:
                out.append((s, e, word))
    return out


def trinity_rotation_clip(bvh: BVHData, pipeline: Optional[MotionPipeline]
                          = None, fps: int = C.FPS
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """'rotation' mode (trinity_data_to_lmdb.py:55-80): 60 fps hip-centric
    euler -> per-joint 3x3 rotation matrices flattened to 9, original and
    X-mirrored tracks. Returns ((T, 9*J), (T, 9*J)).

    The reference fits its sklearn pipeline per file
    (data_pipe.fit_transform, :66); passing pipeline=None replicates that
    (a shared fitted pipeline is accepted for multi-file consistency)."""
    if pipeline is None:
        pipeline = MotionPipeline(fps=fps).fit(bvh)
    euler = pipeline.transform(bvh)
    euler_mirror = pipeline.transform(bvh, mirror=True)
    return (poses_to_matrices(euler).astype(np.float32),
            poses_to_matrices(euler_mirror).astype(np.float32))


def trinity_position_clip(bvh: BVHData, fps: int = C.FPS,
                          target_joints: Optional[List[str]] = None,
                          device: DeviceLike = "cuda") -> np.ndarray:
    """'position' mode (trinity_data_to_lmdb.py:34-53): 60 fps hip-centric
    FK world positions of root + target joints, constant channels removed
    (ConstantsRemover: with the root pinned at the origin its 3 position
    channels — and any joint rigidly attached to it — are constant), then
    3 root zeros re-padded at the front. On the canonical skeleton this is
    (T, 45) = 15*3, the reference's asserted width."""
    pre = root_center(downsample(bvh, fps))
    joints = [bvh.root_name] + [
        j for j in (target_joints or C.TARGET_JOINTS)
        if j in bvh.skeleton]
    pos = positions_for_render(pre, joints, device=device)  # (T, J*3)
    keep = ~np.all(np.isclose(pos, pos[0:1], atol=1e-6), axis=0)
    out = pos[:, keep]
    return np.pad(out.astype(np.float32), ((0, 0), (3, 0)))


def _store_records(clips: List[dict], path: str) -> int:
    """Write Trinity clips (poses + audio + word timeline) to a native
    RecordStore — the LMDB+pyarrow replacement (SURVEY §2.9). Words are
    stored as parallel (starts, ends, unicode) arrays: no pickling."""
    from ..utils.native import RecordStore

    writer = RecordStore.create(path)
    for clip in clips:
        words = clip.get("words") or []
        buf = io.BytesIO()
        np.savez(buf,
                 vid=np.str_(clip["vid"]),
                 poses=clip["poses"],
                 audio=clip.get("audio") if clip.get("audio") is not None
                 else np.zeros(0, np.float32),
                 word_start=np.asarray([w[0] for w in words], np.float64),
                 word_end=np.asarray([w[1] for w in words], np.float64),
                 word_text=np.asarray([w[2] for w in words], np.str_))
        writer.append(buf.getvalue())
    return writer.finalize()


def load_trinity_store(path: str) -> List[dict]:
    """Inverse of _store_records: RecordStore -> clip dicts."""
    from ..utils.native import RecordStore

    store = RecordStore.open(path)
    clips = []
    for i in range(len(store)):
        data = np.load(io.BytesIO(store[i]))
        audio = data["audio"]
        words = list(zip(data["word_start"].tolist(),
                         data["word_end"].tolist(),
                         [str(w) for w in data["word_text"]]))
        clips.append({"vid": str(data["vid"]),
                      "poses": data["poses"],
                      "audio": audio if audio.size else None,
                      "words": words})
    store.close()
    return clips


def build_trinity_split(base_path: str, mode: str = "rotation",
                        fps: int = C.FPS, out_name: str = "lmdb_train",
                        out_dir: Optional[str] = None,
                        device: DeviceLike = "cuda"
                        ) -> Tuple[str, List[np.ndarray]]:
    """One split (the reference's make_lmdb_gesture_dataset,
    trinity_data_to_lmdb.py:100-184): base_path must hold Motion/*.bvh,
    Audio/*.wav, Transcripts/*.json. Returns (store path, pose tracks for
    the split — originals only, matching the reference's all_poses)."""
    from .audio_prep import load_wav_16k

    gesture_path = os.path.join(base_path, "Motion")
    audio_path = os.path.join(base_path, "Audio")
    text_path = os.path.join(base_path, "Transcripts")
    out_dir = out_dir or os.path.join(base_path, "store")
    os.makedirs(out_dir, exist_ok=True)

    clips: List[dict] = []
    all_poses: List[np.ndarray] = []
    for bvh_file in sorted(glob.glob(os.path.join(gesture_path, "*.bvh"))):
        name = os.path.splitext(os.path.basename(bvh_file))[0]
        bvh = parse_bvh(bvh_file)
        words: List[Word] = []
        tpath = os.path.join(text_path, name + ".json")
        if os.path.exists(tpath):
            words = read_trinity_subtitle(tpath)
        audio = None
        apath = os.path.join(audio_path, name + ".wav")
        if os.path.exists(apath):
            audio = load_wav_16k(apath)

        if mode == "rotation":
            poses, poses_mirror = trinity_rotation_clip(bvh, fps=fps)
            clips.append({"vid": name, "poses": poses, "audio": audio,
                          "words": words})
            clips.append({"vid": name, "poses": poses_mirror,
                          "audio": audio, "words": words})
        elif mode == "position":
            poses = trinity_position_clip(bvh, fps=fps, device=device)
            clips.append({"vid": name, "poses": poses, "audio": audio,
                          "words": words})
        else:
            raise ValueError(f"mode must be rotation|position, got {mode!r}")
        all_poses.append(poses)

    store_path = os.path.join(out_dir, out_name)
    _store_records(clips, store_path)
    return store_path, all_poses


def build_trinity_dataset(trn_path: str, val_path: str,
                          mode: str = "rotation", fps: int = C.FPS,
                          out_dir: Optional[str] = None,
                          device: DeviceLike = "cuda") -> Dict[str, str]:
    """Both splits + dataset mean/std over ALL pose tracks (train + val,
    originals only — exactly the reference's accumulation,
    trinity_data_to_lmdb.py:83-95). Writes stats.npz next to the stores
    and prints the mean/std lists the reference prints for YAML pasting."""
    out: Dict[str, str] = {}
    all_poses: List[np.ndarray] = []
    for split, base, name in (("train", trn_path, "lmdb_train"),
                              ("test", val_path, "lmdb_test")):
        store, poses = build_trinity_split(base, mode=mode, fps=fps,
                                           out_name=name, out_dir=out_dir,
                                           device=device)
        out[split] = store
        all_poses.extend(poses)
    stacked = np.vstack(all_poses)
    mean = stacked.mean(axis=0)
    std = stacked.std(axis=0)
    stats_dir = out_dir or os.path.dirname(out["train"])
    stats_path = os.path.join(stats_dir, "stats.npz")
    np.savez(stats_path, mean=mean, std=std)
    out["stats"] = stats_path
    print("data mean/std")
    print(str([f"{e:0.5f}" for e in mean]).replace("'", ""))
    print(str([f"{e:0.5f}" for e in std]).replace("'", ""))
    return out
