"""Stick-figure rendering (process/visualize_bvh.py:41-93 equivalent).

Draws the 15-joint upper-body skeleton from FK positions; writes mp4 when an
ffmpeg-backed matplotlib writer is available, else an animated GIF (pillow),
else (when the writer fails) per-frame PNGs. A host copy of the JAX
package's ``render/visualize.py``; matplotlib is imported inside the
function.
"""
from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

# parent index per joint in [root + TARGET_JOINTS] depth-first order
UPPER_BODY_LINKS: List[Tuple[int, int]] = [
    (0, 1),            # root -> Spine
    (1, 2), (2, 3), (3, 4),           # spine chain
    (4, 5), (5, 6), (6, 7),           # neck/head
    (4, 8), (8, 9), (9, 10), (10, 11),   # right arm
    (4, 12), (12, 13), (13, 14), (14, 15),  # left arm
]


def render_positions(positions: np.ndarray, out_path: str, fps: int = 60,
                     links: Optional[Sequence[Tuple[int, int]]] = None,
                     max_frames: Optional[int] = None,
                     codes: Optional[np.ndarray] = None) -> str:
    """positions: (T, J, 3) or (T, J*3). Returns the written path.

    codes: optional flat codebook-index sequence; when given, the current
    code index is painted on every frame (frame i shows codes[i // 8], the
    240-frame/30-code stride — the overlay the reference draws at
    visualize_bvh.py:82)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.animation as animation

    pos = positions.reshape(positions.shape[0], -1, 3)
    if max_frames:
        pos = pos[:max_frames]
    links = list(links) if links is not None else \
        [l for l in UPPER_BODY_LINKS if l[1] < pos.shape[1]]
    center = pos.mean(axis=(0, 1))
    scale = max(float(np.abs(pos - center).max()), 1e-3)
    if codes is not None:
        codes = np.asarray(codes).reshape(-1)

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_axis_off()
    ax.view_init(elev=10, azim=-90)
    for dim in "xyz":
        getattr(ax, f"set_{dim}lim3d")(-scale, scale)
    lines = [ax.plot([], [], [], color="tab:red", lw=2)[0] for _ in links]
    label = ax.text2D(0.05, 0.95, "", transform=ax.transAxes,
                      fontsize=14) if codes is not None else None

    def animate(i):
        p = pos[i] - center
        for ln, (a, b) in zip(lines, links):
            ln.set_data([p[a, 0], p[b, 0]], [p[a, 2], p[b, 2]])
            ln.set_3d_properties([p[a, 1], p[b, 1]])
        if label is not None and i // 8 < len(codes):
            label.set_text(str(int(codes[i // 8])))
            return lines + [label]
        return lines

    ani = animation.FuncAnimation(fig, animate, frames=pos.shape[0],
                                  interval=1000 / fps)
    try:
        if animation.writers.is_available("ffmpeg"):
            ani.save(out_path, fps=fps, writer="ffmpeg")
        else:
            out_path = os.path.splitext(out_path)[0] + ".gif"
            ani.save(out_path, fps=min(fps, 25), writer="pillow")
    except (OSError, RuntimeError, ValueError, subprocess.SubprocessError):
        out_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(out_dir, exist_ok=True)
        for i in range(0, pos.shape[0], max(pos.shape[0] // 16, 1)):
            animate(i)
            fig.savefig(os.path.join(out_dir, f"{i:05d}.png"))
        out_path = out_dir
    finally:
        plt.close(fig)
    return out_path
