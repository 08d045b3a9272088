"""Dataset helpers: the per-channel statistics of a speaker's poses.

The rest of the JAX package's ``train/data.py`` (windowed datasets, the
device clip store) waits for the trainers.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dataset_stats(clips: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over all frames of all clips — the numbers the
    reference prints for pasting into YAML (beat_data_to_lmdb.py:255-262)."""
    all_poses = np.concatenate([c["poses"] for c in clips], axis=0)
    return all_poses.mean(axis=0), all_poses.std(axis=0)
