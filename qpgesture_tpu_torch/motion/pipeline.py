"""Skeleton preprocessing pipeline: BVH -> normalized euler channel matrix.

Replaces the reference's sklearn Pipeline of PyMO transforms
(process/beat_data_to_lmdb.py:58-65: DownSampler -> RootTransformer
('hip_centric') -> Mirror('X') -> JointSelector -> ConstantsRemover ->
Numpyfier) with one typed, JSON-serializable MotionPipeline. The inverse
path (restore constant channels + skeleton, reorder, write BVH —
process/process_bvh.py:57-83) is `inverse`, and the fitted state serializes
to JSON instead of a pickled joblib .sav.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import TARGET_JOINTS
from .bvh import BVHData


def downsample(data: BVHData, tgt_fps: int) -> BVHData:
    """Integer-rate frame decimation taking the first offset track
    (DownSampler(keep_all=False), preprocessing.py:1082-1114). Note the
    reference slices [0:-1:rate], dropping the final frame."""
    orig_fps = round(1.0 / data.framerate)
    rate = orig_fps // tgt_fps
    if orig_fps % tgt_fps != 0:
        raise ValueError(f"{orig_fps} fps not divisible by {tgt_fps}")
    out = data.clone()
    out.values = data.values[0:-1:rate].copy()
    out.framerate = 1.0 / tgt_fps
    return out


def slice_windows(tracks: List[np.ndarray], window_size: int,
                  overlap: float = 0.5) -> np.ndarray:
    """Equal-size overlapping windows over per-track channel matrices
    (Slicer, preprocessing.py:658-692): overlap_frames = int(overlap *
    window_size); window i starts at (window_size - overlap_frames) * i;
    tracks shorter than one window contribute nothing. Returns
    (n_windows, window_size, channels)."""
    out = []
    channels = None
    for vals in tracks:
        vals = np.asarray(vals)
        channels = vals.shape[1]
        overlap_frames = int(overlap * window_size)
        step = window_size - overlap_frames
        n_seq = (vals.shape[0] - overlap_frames) // step
        for i in range(max(n_seq, 0)):
            out.append(vals[step * i:step * i + window_size])
    if not out:
        return np.zeros((0, window_size, channels or 0))
    return np.array(out)


class ListStandardScaler:
    """Z-score normalization fitted over a LIST of variable-length tracks
    (ListStandardScaler, preprocessing.py:982-1027): stats over the
    concatenated frames, applied per track; inverse_transform restores."""

    def fit(self, tracks: List[np.ndarray]) -> "ListStandardScaler":
        flat = np.concatenate([np.asarray(t) for t in tracks], axis=0)
        self.data_mean_ = flat.mean(axis=0)
        self.data_std_ = flat.std(axis=0)
        return self

    def transform(self, tracks: List[np.ndarray]) -> np.ndarray:
        return np.array([(np.asarray(t) - self.data_mean_) / self.data_std_
                         for t in tracks])

    def inverse_transform(self, tracks: List[np.ndarray]) -> np.ndarray:
        return np.array([np.asarray(t) * self.data_std_ + self.data_mean_
                         for t in tracks])


def root_center(data: BVHData) -> BVHData:
    """'hip_centric': zero the root position and rotation channels
    (RootTransformer, preprocessing.py:765-789)."""
    out = data.clone()
    root = data.root_name
    for ch in ("Xposition", "Yposition", "Zposition",
               "Xrotation", "Yrotation", "Zrotation"):
        col = f"{root}_{ch}"
        if col in out.channel_names:
            out.values[:, out.channel_names.index(col)] = 0.0
    return out


def mirror_x(data: BVHData) -> BVHData:
    """Left/right swap with X-axis sign flips (Mirror('X'),
    preprocessing.py:477-554): root positions negate -signs, Left<->Right
    joints swap rotations with signs (+1,-1,-1), trunk joints get signed
    rotations in place."""
    signs = np.array([1.0, -1.0, -1.0])
    out = data.clone()
    src, dst = data.values, out.values
    names = data.channel_names
    root = data.root_name

    for i, (axis, s) in enumerate(zip("XYZ", signs)):
        col = f"{root}_{axis}position"
        if col in names:
            dst[:, names.index(col)] = -s * src[:, names.index(col)]

    def set_rot(joint_to, joint_from):
        for axis, s in zip("XYZ", signs):
            cto = f"{joint_to}_{axis}rotation"
            cfrom = f"{joint_from}_{axis}rotation"
            if cto in names and cfrom in names:
                dst[:, names.index(cto)] = s * src[:, names.index(cfrom)]

    for joint in data.skeleton:
        if "Nub" in joint:
            continue
        if "Left" in joint:
            set_rot(joint, joint.replace("Left", "Right"))
        elif "Right" in joint:
            set_rot(joint, joint.replace("Right", "Left"))
        else:
            set_rot(joint, joint)
    return out


@dataclass
class MotionPipeline:
    """Fitted forward/inverse channel selection + constant restoration.

    fit() records, from a template BVH: the selected joints' rotation
    channels in order (root + target joints, ConstantsRemover dropping the
    root channels in 'rotation' mode — preprocessing.py:930-948), the
    constant values of every dropped channel, and the skeleton for
    reconstruction.
    """
    target_joints: List[str] = field(
        default_factory=lambda: list(TARGET_JOINTS))
    fps: int = 60
    # fitted state:
    selected_columns: List[str] = field(default_factory=list)
    dropped_values: Dict[str, float] = field(default_factory=dict)
    template: Optional[BVHData] = None

    _CONST_DIMS = ["Hips_Xposition", "Hips_Yposition", "Hips_Zposition",
                   "Hips_Zrotation", "Hips_Xrotation", "Hips_Yrotation"]

    def fit(self, data: BVHData) -> "MotionPipeline":
        pre = root_center(downsample(data, self.fps))
        selected_joints = [data.root_name] + list(self.target_joints)
        cols = []
        for joint in selected_joints:
            cols.extend(c for c in pre.channel_names
                        if c.startswith(joint + "_") and "Nub" not in c)
        # ConstantsRemover (mode='rotation'): drop the 6 root channels
        const = [c for c in self._CONST_DIMS if c in cols]
        if data.root_name != "Hips":
            const = [f"{data.root_name}_{s.split('_')[1]}"
                     for s in self._CONST_DIMS]
            const = [c for c in const if c in cols]
        self.selected_columns = [c for c in cols if c not in const]
        self.dropped_values = {
            c: float(pre.values[0, pre.channel_names.index(c)])
            for c in pre.channel_names
            if c not in self.selected_columns}
        tpl = pre.clone()
        tpl.values = tpl.values[:0]
        self.template = tpl
        return self

    def transform(self, data: BVHData, mirror: bool = False) -> np.ndarray:
        """-> (T, len(selected_columns)) euler channel matrix at fps."""
        pre = root_center(downsample(data, self.fps))
        if mirror:
            pre = mirror_x(pre)
        idx = [pre.channel_names.index(c) for c in self.selected_columns]
        return pre.values[:, idx].copy()

    def inverse(self, euler: np.ndarray) -> BVHData:
        """(T, n_selected) euler values -> full BVHData with constants and
        skeleton restored (the pipeline.inverse_transform equivalent used by
        make_bvh_GENEA2020_BT, process/process_bvh.py:79-83)."""
        T = euler.shape[0]
        out = self.template.clone()
        out.values = np.zeros((T, len(out.channel_names)))
        for j, c in enumerate(self.selected_columns):
            out.values[:, out.channel_names.index(c)] = euler[:, j]
        for c, v in self.dropped_values.items():
            out.values[:, out.channel_names.index(c)] = v
        return out

    # -- JSON snapshot (supersedes the joblib .sav files) ------------------
    def to_json(self) -> str:
        tpl = self.template
        return json.dumps({
            "target_joints": self.target_joints,
            "fps": self.fps,
            "selected_columns": self.selected_columns,
            "dropped_values": self.dropped_values,
            "template": {
                "skeleton": tpl.skeleton,
                "channel_names": tpl.channel_names,
                "framerate": tpl.framerate,
                "root_name": tpl.root_name,
            },
        })

    @classmethod
    def from_json(cls, text: str) -> "MotionPipeline":
        raw = json.loads(text)
        tpl = raw["template"]
        template = BVHData(skeleton=tpl["skeleton"],
                           channel_names=tpl["channel_names"],
                           values=np.zeros((0, len(tpl["channel_names"]))),
                           framerate=tpl["framerate"],
                           root_name=tpl["root_name"])
        return cls(target_joints=raw["target_joints"], fps=raw["fps"],
                   selected_columns=raw["selected_columns"],
                   dropped_values=raw["dropped_values"], template=template)
