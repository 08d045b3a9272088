"""Style-control masks for the raw-pose GestureKNN.

Port of Speech2GestureMatching/control.py:5-46: 'hand_high'/'hand_low'
masks built from left-wrist height quantiles of the body features (default:
all ones = no control). A copy of the JAX package's ``match/control.py``."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import constants as C


def create_control_filter(feat_train: np.ndarray,
                          control_type: Optional[str] = None,
                          n_aud_feat: int = C.NUM_AUDIO_FEAT,
                          n_body_frames: int = C.NUM_BODY_FEAT_FRAMES,
                          wrist_index: int = 3,
                          height_axis: int = 1) -> np.ndarray:
    """feat_train: (num_seq, num_feat, num_frames) — audio features stacked
    above body features (the load_train_db layout). Returns a (num_seq,
    num_frames) 0/1 mask."""
    num_seq, _, num_frm = feat_train.shape
    mask = np.ones((num_seq, num_frm))
    if control_type is None:
        return mask

    body = feat_train.transpose(0, 2, 1)[:, :, n_aud_feat:]
    n_joint_feat = len(C.BODY_FEAT_IDX)
    body = body.reshape(num_seq, num_frm, n_body_frames, n_joint_feat, -1)
    # y-axis flipped upward by * -1 (control.py:25-27)
    height = body[:, :, 0, wrist_index, height_axis] * -1

    hi = np.quantile(height.reshape(-1), 0.85)
    lo = np.quantile(height.reshape(-1), 0.15)
    if control_type == "hand_high":
        mask = (height >= hi).astype(np.float64)
    elif control_type == "hand_low":
        mask = (height <= lo).astype(np.float64)
    return mask
