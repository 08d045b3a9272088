"""Decode & render: code indices -> rotation poses -> BVH -> positions.

The reference's VisualizeCodebook inference path (VisualizeCodebook.py:
333-370): load result.npz['knn_pred'], VQ-VAE-decode the flattened code
string, denormalize with the dataset stats, smooth, convert rotation
matrices to ZXY eulers, restore the full skeleton through the fitted
pipeline, and write BVH (+ FK positions for the stick-figure video). The
decode and the FK run on the model's device.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import constants as C
from ..models.vqvae import VQVAE
from ..motion.bvh import BVHData, write_bvh
from ..motion.fk import positions_for_render
from ..motion.pipeline import MotionPipeline
from ..motion.rotations import matrices_to_poses


def denormalize(poses: np.ndarray, data_mean: Optional[np.ndarray],
                data_std: Optional[np.ndarray]) -> np.ndarray:
    """poses * clip(std, 0.01) + mean, or poses unchanged without stats."""
    if data_mean is None:
        return poses
    std = np.clip(np.asarray(data_std), 0.01, None)
    return poses * std + np.asarray(data_mean)


def decode_codes(model: VQVAE, codes: np.ndarray,
                 data_mean: Optional[np.ndarray] = None,
                 data_std: Optional[np.ndarray] = None) -> np.ndarray:
    """(W, 30) codes -> (W*240, 135) denormalized rotation-matrix poses.

    The whole flattened code string decodes in one pass, as in the
    reference (VisualizeCodebook.py:139-146), which keeps window boundaries
    smooth through the decoder's receptive field.
    """
    flat = torch.as_tensor(np.asarray(codes).reshape(1, -1).astype(np.int64),
                           device=model.device)
    poses = model.decode(flat)[0].cpu().numpy()
    return denormalize(poses, data_mean, data_std)


def smooth_poses(poses: np.ndarray, savgol: bool = True,
                 gaussian: bool = False) -> np.ndarray:
    """Savitzky-Golay (15, 2) and/or Gaussian (sigma 1.5) smoothing over
    time, per channel (process_bvh.py:63-67, visualization.py:77-81)."""
    out = poses
    if gaussian:
        from scipy.ndimage import gaussian_filter1d
        out = gaussian_filter1d(out, C.FILTER_SMOOTH_STD, axis=0)
    if savgol:
        from scipy.signal import savgol_filter
        out = savgol_filter(out, 15, 2, axis=0)
    return out


def poses_to_bvh(poses: np.ndarray, pipeline: MotionPipeline,
                 smoothing: bool = False) -> BVHData:
    """(T, 135) rotation-matrix poses -> BVHData
    (make_bvh_GENEA2020_BT, process/process_bvh.py:57-83)."""
    if smoothing:
        poses = smooth_poses(poses, savgol=True)
    euler = matrices_to_poses(poses)   # (T, 45) ZXY degrees
    return pipeline.inverse(euler)


def render_result(codes: np.ndarray, model: VQVAE,
                  pipeline: MotionPipeline, out_dir: str, prefix: str,
                  data_mean=None, data_std=None, smoothing: bool = False,
                  write_positions: bool = True
                  ) -> Tuple[str, Optional[str]]:
    """Full decode path; writes '<prefix>_generated.bvh' (+ positions npy).
    Returns (bvh_path, npy_path)."""
    os.makedirs(out_dir, exist_ok=True)
    poses = decode_codes(model, codes, data_mean, data_std)
    bvh = poses_to_bvh(poses, pipeline, smoothing=smoothing)
    bvh_path = os.path.join(out_dir, f"{prefix}_generated.bvh")
    with open(bvh_path, "w") as f:
        write_bvh(bvh, f)
    npy_path = None
    if write_positions:
        pos = positions_for_render(
            bvh, joints_subset=[bvh.root_name] + list(pipeline.target_joints),
            device=model.device)
        npy_path = os.path.join(out_dir, f"{prefix}_generated.npy")
        np.save(npy_path, pos)
    return bvh_path, npy_path
