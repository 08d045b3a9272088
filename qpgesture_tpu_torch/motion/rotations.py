"""Rotation math: euler 'ZXY' <-> rotation matrices (host, numpy).

The canonical pose representation is the per-joint 3x3 rotation matrix of the
*intrinsic* ZXY euler decomposition in degrees (R.from_euler('ZXY', ...,
degrees=True), process/beat_data_to_lmdb.py:79-88), flattened row-major to 9
values -> 135 dims for 15 joints.
"""
from __future__ import annotations

import numpy as np


def _axis_mats(rad: np.ndarray, axis: str) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    o, z = np.ones_like(c), np.zeros_like(c)
    if axis == "x":
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == "y":
        rows = [c, z, s, z, o, z, -s, z, c]
    else:  # z
        rows = [c, -s, z, s, c, z, z, z, o]
    return np.stack(rows, axis=-1).reshape(rad.shape + (3, 3))


def euler_to_matrix(euler, order: str = "ZXY", degrees: bool = True,
                    intrinsic: bool = True) -> np.ndarray:
    """euler: (..., 3) angles in channel order (e.g. Z, X, Y for 'ZXY').
    intrinsic=True matches scipy's uppercase 'ZXY': R = Rz @ Rx @ Ry.
    intrinsic=False is extrinsic (lowercase 'zxy'): R = Ry @ Rx @ Rz.
    """
    e = np.asarray(euler)
    rad = e * (np.pi / 180.0) if degrees else e
    mats = [_axis_mats(rad[..., i], order[i].lower()) for i in range(3)]
    if intrinsic:
        return mats[0] @ mats[1] @ mats[2]
    return mats[2] @ mats[1] @ mats[0]


def matrix_to_euler_zxy(mat: np.ndarray, degrees: bool = True) -> np.ndarray:
    """Inverse of intrinsic-ZXY euler_to_matrix.

    R = Rz(z) @ Rx(x) @ Ry(y); extraction:
      R[2,1] = sin x;  R[0,1] = -sin z cos x;  R[1,1] = cos z cos x;
      R[2,0] = -cos x sin y; R[2,2] = cos x cos y.
    Gimbal lock (|sin x| ~ 1) resolves with y = 0 (scipy convention).
    """
    m = np.asarray(mat, dtype=np.float64)
    sx = np.clip(m[..., 2, 1], -1.0, 1.0)
    x = np.arcsin(sx)
    cx = np.cos(x)
    safe = np.abs(cx) > 1e-7
    z = np.where(safe, np.arctan2(-m[..., 0, 1], m[..., 1, 1]),
                 np.arctan2(m[..., 1, 0], m[..., 0, 0]))
    y = np.where(safe, np.arctan2(-m[..., 2, 0], m[..., 2, 2]), 0.0)
    out = np.stack([z, x, y], axis=-1)
    return np.degrees(out) if degrees else out


def euler_to_expmap(euler: np.ndarray, order: str = "ZXY",
                    degrees: bool = True) -> np.ndarray:
    """(..., 3) euler -> exponential map (rotation vector), the
    parameterization of the GENEA 'BA' pipeline variant
    (process/pymo/rotation_tools.py:22-61, MocapParameterizer('expmap'))."""
    from scipy.spatial.transform import Rotation as R
    e = np.asarray(euler, dtype=np.float64).reshape(-1, 3)
    rv = R.from_euler(order, e, degrees=degrees).as_rotvec()
    return rv.reshape(np.asarray(euler).shape)


def expmap_to_euler(expmap: np.ndarray, order: str = "ZXY",
                    degrees: bool = True) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R
    v = np.asarray(expmap, dtype=np.float64).reshape(-1, 3)
    e = R.from_rotvec(v).as_euler(order, degrees=degrees)
    return e.reshape(np.asarray(expmap).shape)


def unroll_expmap(rotvecs: np.ndarray) -> np.ndarray:
    """Fix discontinuous rotation vectors over time by flipping to the
    2pi-complement representation when it is closer to the previous frame
    (fix_rotvec, process/pymo/preprocessing.py:61-86 semantics)."""
    out = np.asarray(rotvecs, dtype=np.float64).copy()
    for t in range(1, out.shape[0]):
        ang = np.linalg.norm(out[t])
        if ang == 0:
            continue
        alt = out[t] / ang * (ang - 2 * np.pi)
        if np.linalg.norm(alt - out[t - 1]) < np.linalg.norm(
                out[t] - out[t - 1]):
            out[t] = alt
    return out


def poses_to_matrices(euler_frames: np.ndarray, degrees: bool = True
                      ) -> np.ndarray:
    """(T, J*3) euler ZXY channel values -> (T, J*9) flattened rotation
    matrices (beat_data_to_lmdb.process_bvh:79-88)."""
    T = euler_frames.shape[0]
    e = euler_frames.reshape(T, -1, 3)
    m = euler_to_matrix(e, "ZXY", degrees=degrees, intrinsic=True)
    return m.reshape(T, -1)


def matrices_to_poses(mat_frames: np.ndarray, degrees: bool = True
                      ) -> np.ndarray:
    """(T, J*9) -> (T, J*3) euler ZXY (process/process_bvh.py:72-77)."""
    T = mat_frames.shape[0]
    m = mat_frames.reshape(T, -1, 3, 3)
    return matrix_to_euler_zxy(m, degrees=degrees).reshape(T, -1)
