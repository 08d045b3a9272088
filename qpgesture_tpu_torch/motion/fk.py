"""Forward kinematics: euler channel values -> world joint positions.

Replacement for PyMO's per-frame recursive FK
(MocapParameterizer('position')._to_pos, process/pymo/preprocessing.py:
288-368). Its world rotation is W_j = W_parent @ E_j with E_j the extrinsic
euler matrix of the joint's channel order, and p_j = p_parent + W_parent @
(offset + pos). The recurrence runs in torch on ``device``, vectorized over
frames; the per-joint local rotations are built on the host.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bvh import BVHData
from .rotations import euler_to_matrix


def _topo_order(skeleton: Dict[str, dict], root: str) -> List[str]:
    order = []

    def visit(j):
        order.append(j)
        for c in skeleton[j]["children"]:
            visit(c)

    visit(root)
    return order


def fk_tables(data: BVHData):
    """Static FK tables from a skeleton: joint order, parent indices,
    offsets, and per-joint euler column indices (-1 rows for channel-less
    end sites)."""
    joints = _topo_order(data.skeleton, data.root_name)
    parent_idx = np.array(
        [joints.index(data.skeleton[j]["parent"])
         if data.skeleton[j]["parent"] is not None else -1 for j in joints])
    offsets = np.array([data.skeleton[j]["offsets"] or [0.0, 0.0, 0.0]
                        for j in joints], dtype=np.float32)
    rot_cols = np.full((len(joints), 3), -1, dtype=np.int64)
    pos_cols = np.full((len(joints), 3), -1, dtype=np.int64)
    orders = []
    for ji, j in enumerate(joints):
        order = data.skeleton[j]["order"] or "ZXY"
        orders.append(order)
        for ci in range(3):
            rc = f"{j}_{order[ci]}rotation"
            if rc in data.channel_names:
                rot_cols[ji, ci] = data.channel_names.index(rc)
        for ci, ax in enumerate("XYZ"):
            pc = f"{j}_{ax}position"
            if pc in data.channel_names:
                pos_cols[ji, ci] = data.channel_names.index(pc)
    return joints, parent_idx, offsets, rot_cols, pos_cols, orders


def forward_kinematics(data: BVHData,
                       device: DeviceLike = "cuda") -> np.ndarray:
    """-> (T, n_joints, 3) world positions, joints in depth-first order."""
    dev = resolve_device(device)
    joints, parent_idx, offsets, rot_cols, pos_cols, orders = fk_tables(data)
    values = data.values.astype(np.float32)
    T = values.shape[0]
    J = len(joints)

    # per-joint euler angles in channel order (zeros where absent)
    eul = np.zeros((T, J, 3), np.float32)
    pos = np.zeros((T, J, 3), np.float32)
    for ji in range(J):
        for ci in range(3):
            if rot_cols[ji, ci] >= 0:
                eul[:, ji, ci] = values[:, rot_cols[ji, ci]]
            if pos_cols[ji, ci] >= 0:
                pos[:, ji, ci] = values[:, pos_cols[ji, ci]]
    # local rotations: extrinsic in channel order (pymo convention)
    locals_ = np.zeros((T, J, 3, 3), np.float32)
    for ji in range(J):
        locals_[:, ji] = euler_to_matrix(eul[:, ji], orders[ji],
                                         degrees=True, intrinsic=False)

    loc = torch.as_tensor(locals_, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    off = torch.as_tensor(offsets, device=dev)
    world_rot: List[torch.Tensor] = [None] * J
    world_pos: List[torch.Tensor] = [None] * J
    for ji in range(J):
        p = int(parent_idx[ji])
        if p < 0:
            world_rot[ji] = loc[:, ji]
            world_pos[ji] = pos_t[:, ji]
        else:
            world_rot[ji] = world_rot[p] @ loc[:, ji]
            k = off[ji] + pos_t[:, ji]
            world_pos[ji] = world_pos[p] + (world_rot[p]
                                            @ k[..., None])[..., 0]
    return torch.stack(world_pos, dim=1).cpu().numpy()


def positions_for_render(data: BVHData, joints_subset: List[str] | None = None,
                         device: DeviceLike = "cuda") -> np.ndarray:
    """(T, J*3) positions for the selected joints (bvh_to_position.py:68-96
    equivalent: FK then keep the 15 upper-body joints)."""
    joints, *_ = fk_tables(data)
    pos = forward_kinematics(data, device=device)
    if joints_subset is not None:
        idx = [joints.index(j) for j in joints_subset]
        pos = pos[:, idx]
    return pos.reshape(pos.shape[0], -1)
