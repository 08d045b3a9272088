from .bvh import BVHData, parse_bvh, write_bvh
from .fk import forward_kinematics, positions_for_render
from .pipeline import MotionPipeline, downsample, mirror_x, root_center
from .rotations import (euler_to_matrix, matrices_to_poses,
                        matrix_to_euler_zxy, poses_to_matrices)

__all__ = ["BVHData", "parse_bvh", "write_bvh", "forward_kinematics",
           "positions_for_render", "MotionPipeline", "downsample",
           "mirror_x", "root_center", "euler_to_matrix",
           "matrices_to_poses", "matrix_to_euler_zxy", "poses_to_matrices"]
