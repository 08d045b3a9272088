"""BVH parsing and writing (host side).

Covers the role of the vendored PyMO parser/writer
(process/pymo/parsers.py:76, writers.py:10) with a fresh, line-oriented
implementation: the skeleton is a dict {joint: {parent, channels, offsets,
order, children}} and the motion is a dense (T, n_channels) float64 array
with column names '<joint>_<channel>'. Quirks preserved for dataset compat:
'Frames:' headers are parsed through float() (some BEAT files carry
non-integer counts, parsers.py:228) and End Sites become '<parent>_Nub'
joints.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class BVHData:
    skeleton: Dict[str, dict]
    channel_names: List[str]          # '<joint>_<channel>' per column
    values: np.ndarray                # (T, n_channels) float64
    framerate: float                  # seconds per frame
    root_name: str

    def clone(self) -> "BVHData":
        import copy
        return BVHData(skeleton=copy.deepcopy(self.skeleton),
                       channel_names=list(self.channel_names),
                       values=self.values.copy(),
                       framerate=self.framerate, root_name=self.root_name)

    def column(self, joint: str, channel: str) -> np.ndarray:
        return self.values[:, self.channel_names.index(f"{joint}_{channel}")]


def _new_joint(parent: Optional[str]) -> dict:
    return {"parent": parent, "channels": [], "offsets": [], "order": "",
            "children": []}


def parse_bvh(path_or_text: str, max_frames: Optional[int] = None) -> BVHData:
    """Parse a BVH file path or raw BVH text."""
    if "\n" in path_or_text or "HIERARCHY" in path_or_text[:64]:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    lines = text.split("\n")
    i = 0

    def next_tokens():
        nonlocal i
        while i < len(lines):
            toks = lines[i].split()
            i += 1
            if toks:
                return toks
        return None

    toks = next_tokens()
    if not toks or toks[0] != "HIERARCHY":
        raise ValueError("not a BVH file: missing HIERARCHY")

    skeleton: Dict[str, dict] = {}
    channel_cols: List[str] = []
    root_name = ""
    stack: List[str] = []

    toks = next_tokens()
    while toks is not None and toks[0] != "MOTION":
        kw = toks[0]
        if kw in ("ROOT", "JOINT"):
            name = " ".join(toks[1:])
            parent = stack[-1] if stack else None
            skeleton[name] = _new_joint(parent)
            if parent is None:
                root_name = name
            else:
                skeleton[parent]["children"].append(name)
            stack.append(name)
        elif kw == "End":  # End Site -> '<parent>_Nub'
            name = stack[-1] + "_Nub"
            parent = stack[-1]
            skeleton[name] = _new_joint(parent)
            skeleton[parent]["children"].append(name)
            stack.append(name)
        elif kw == "OFFSET":
            skeleton[stack[-1]]["offsets"] = [float(v) for v in toks[1:4]]
        elif kw == "CHANNELS":
            n = int(toks[1])
            chans = toks[2:2 + n]
            joint = stack[-1]
            skeleton[joint]["channels"] = chans
            order = "".join(c[0] for c in chans if c.endswith("rotation"))
            skeleton[joint]["order"] = order
            channel_cols.extend(f"{joint}_{c}" for c in chans)
        elif kw == "}":
            stack.pop()
        # '{' and anything else: skip
        toks = next_tokens()

    if toks is None:
        raise ValueError("missing MOTION section")

    toks = next_tokens()  # Frames: N
    if toks[0].rstrip(":") != "Frames":
        raise ValueError("missing Frames header")
    n_frames = int(float(toks[-1]))  # float() first: header repair quirk
    toks = next_tokens()  # Frame Time: x
    framerate = float(toks[-1])

    if max_frames is not None:
        n_frames = min(n_frames, max_frames)
    n_ch = len(channel_cols)
    flat = np.array(" ".join(lines[i:]).split(),
                    dtype=np.float64)[:n_frames * n_ch]
    if flat.size < n_frames * n_ch:
        n_frames = flat.size // n_ch  # tolerate short files (header repair)
    values = flat[: n_frames * n_ch].reshape(n_frames, n_ch)

    return BVHData(skeleton=skeleton, channel_names=channel_cols,
                   values=values, framerate=framerate, root_name=root_name)


def write_bvh(data: BVHData, out=None, framerate: Optional[float] = None
              ) -> Optional[str]:
    """Serialize to BVH text. Channel columns are emitted positions-first
    then rotations in the joint's rotation order (pymo writer semantics,
    writers.py:53-66). Returns the text if `out` is None."""
    buf = out or io.StringIO()
    motions: List[np.ndarray] = []

    def emit_joint(joint: str, tab: int):
        info = data.skeleton[joint]
        if info["parent"] is None:
            buf.write(f"ROOT {joint}\n")
        elif info["children"]:
            buf.write("%sJOINT %s\n" % ("\t" * tab, joint))
        else:
            buf.write("%sEnd site\n" % ("\t" * tab))
        buf.write("%s{\n" % ("\t" * tab))
        off = info["offsets"]
        buf.write("%sOFFSET %3.5f %3.5f %3.5f\n"
                  % ("\t" * (tab + 1), off[0], off[1], off[2]))
        rot = [c for c in info["channels"] if "rotation" in c]
        pos = [c for c in info["channels"] if "position" in c]
        if info["children"]:
            ch_str = ""
            for cn in pos:
                motions.append(np.asarray(data.column(joint, cn)))
                ch_str += " " + cn
            for ci in range(len(rot)):
                cn = f"{info['order'][ci]}rotation"
                motions.append(np.asarray(data.column(joint, cn)))
                ch_str += " " + cn
            if rot or pos:
                buf.write("%sCHANNELS %d%s\n"
                          % ("\t" * (tab + 1), len(rot) + len(pos), ch_str))
            for c in info["children"]:
                emit_joint(c, tab + 1)
        buf.write("%s}\n" % ("\t" * tab))

    buf.write("HIERARCHY\n")
    emit_joint(data.root_name, 0)
    buf.write("MOTION\n")
    buf.write("Frames: %d\n" % data.values.shape[0])
    fr = (1.0 / framerate) if framerate else data.framerate
    buf.write("Frame Time: %f\n" % fr)
    mat = np.stack(motions, axis=1)
    np.savetxt(buf, mat, fmt="%.6f", delimiter=" ")
    if out is None:
        return buf.getvalue()
    return None
