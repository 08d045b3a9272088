"""BEAT dataset step-1 assembly: orig-BEAT tree -> Motion/ + Audio/ dirs.

Reproduces make_beat_gesture_audio_dataset + remake_beat_bvh
(process/make_beat_dataset.py:17-96): walk <root>/<speaker>/*.{wav,bvh},
keep only paired recordings, copy into <save_dir>/{Motion,Audio}, then
repair BVH files whose 'Frames:' header disagrees with the actual motion
line count (a known orig-BEAT export bug). The reference repairs by
rewriting the fixed line index 429 with len(file)-431; here the Frames
line is located and the frame count recomputed from the actual lines after
'Frame Time:', which handles arbitrary hierarchy sizes."""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Tuple


def find_paired_recordings(root: str) -> List[Tuple[str, str]]:
    """[(wav_path, bvh_path)] for every recording that has both files
    (unpaired files are dropped, make_beat_dataset.py:46-55)."""
    wavs: Dict[str, str] = {}
    bvhs: Dict[str, str] = {}
    for speaker in sorted(os.listdir(root)):
        sdir = os.path.join(root, speaker)
        if not os.path.isdir(sdir):
            continue
        for item in sorted(os.listdir(sdir)):
            stem = os.path.join(speaker, item[:-4])
            if item.endswith(".wav"):
                wavs[stem] = os.path.join(sdir, item)
            elif item.endswith(".bvh"):
                bvhs[stem] = os.path.join(sdir, item)
    return [(wavs[k], bvhs[k]) for k in sorted(wavs) if k in bvhs]


def repair_bvh_frames_header(path: str) -> bool:
    """Fix a 'Frames:' count that disagrees with the motion data. Returns
    True if the file was rewritten (remake_beat_bvh semantics,
    make_beat_dataset.py:73-96, generalized from the fixed 429/431 line
    offsets to the located header)."""
    with open(path) as f:
        lines = f.readlines()
    frames_i = time_i = None
    for i, line in enumerate(lines):
        s = line.strip()
        if s.startswith("Frames:") and frames_i is None:
            frames_i = i
        elif s.startswith("Frame Time:"):
            time_i = i
            break
    if frames_i is None or time_i is None:
        return False
    actual = sum(1 for ln in lines[time_i + 1:] if ln.strip())
    # int(float(...)): some BEAT files carry non-integer Frames counts
    # (same tolerance as bvh.parse_bvh) — exactly the malformed headers
    # this repair pass exists to fix
    declared = int(float(lines[frames_i].split(":")[1]))
    if declared == actual:
        return False
    lines[frames_i] = f"Frames: {actual}\n"
    with open(path, "w") as f:
        f.writelines(lines)
    return True


def assemble_beat_dataset(root: str, save_dir: str,
                          speakers: List[str] = None) -> dict:
    """Copy paired wav/bvh from an orig-BEAT tree into
    <save_dir>/{Audio,Motion} (optionally restricted to given speaker ids)
    and repair broken Frames headers. Returns a summary dict."""
    audio_dir = os.path.join(save_dir, "Audio")
    motion_dir = os.path.join(save_dir, "Motion")
    os.makedirs(audio_dir, exist_ok=True)
    os.makedirs(motion_dir, exist_ok=True)

    pairs = find_paired_recordings(root)
    if speakers:
        allow = set(str(s) for s in speakers)
        pairs = [(w, b) for (w, b) in pairs
                 if os.path.basename(w).split("_")[0] in allow]

    repaired = []
    for wav_path, bvh_path in pairs:
        shutil.copy(wav_path, audio_dir)
        dst = os.path.join(motion_dir, os.path.basename(bvh_path))
        shutil.copy(bvh_path, dst)
        if repair_bvh_frames_header(dst):
            repaired.append(os.path.basename(dst))
    return {"n_pairs": len(pairs), "repaired": repaired,
            "audio_dir": audio_dir, "motion_dir": motion_dir}
