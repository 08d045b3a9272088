from .decode import decode_codes, poses_to_bvh, render_result, smooth_poses

__all__ = ["decode_codes", "poses_to_bvh", "render_result", "smooth_poses"]
