"""Offline training plots: scalar-history curves and phase-manifold PCA.

The reference shows live matplotlib windows during training — loss via
PlottingWindow (Library/Utility.py:21-75) and the PAE phase manifold via
Plotting.py PCA2D/Phase2D (PAE.py:438-468). Headless training has no
display, so these render the same views as PNGs after (or during) a run:
loss curves come from the persistent JSONL scalar history
(utils/metrics_log.ScalarHistory, which the port's trainers write), the
manifold from stored phase params. A host copy of the JAX package's
``render/plots.py``; matplotlib is imported inside the functions, so the
port imports without it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_scalar_history(history_path: str, out_path: str,
                        tags: Optional[Sequence[str]] = None) -> str:
    """Render per-tag training curves from a scalars.jsonl file into one
    PNG grid (the PlottingWindow equivalent)."""
    from ..utils.metrics_log import ScalarHistory
    series = ScalarHistory.read(history_path)
    if tags:
        series = {t: series[t] for t in tags if t in series}
    if not series:
        raise ValueError(f"no scalar series found in {history_path}")
    plt = _plt()
    n = len(series)
    cols = min(3, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4.5 * cols, 3 * rows),
                             squeeze=False)
    for ax in axes.flat[n:]:
        ax.axis("off")
    for ax, (tag, rows_) in zip(axes.flat, sorted(series.items())):
        max_step = max(r[1] for r in rows_) + 1
        epochs = [e + s / max(1, max_step) for e, s, _ in rows_]
        values = [v for _, _, v in rows_]
        ax.plot(epochs, values, lw=1.0)
        ax.set_title(tag)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_wav_debug(wav: np.ndarray, sr: int, out_path: str) -> str:
    """Audio debug views (process/visualize_phase.py:13-31): the
    normalized time-domain waveform, plus the frequency-domain magnitude
    spectrum the reference's wav inspection pairs with it."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    peak = np.abs(wav).max()
    if peak > 0:
        wav = wav / peak  # read_wav normalizes to max |amplitude| = 1
    plt = _plt()
    fig, (ax_t, ax_f) = plt.subplots(2, 1, figsize=(8, 5))
    time = np.arange(len(wav)) / sr
    ax_t.plot(time, wav, c="b", lw=0.5)
    ax_t.set_xlabel("time")
    ax_t.set_ylabel("am")
    spec = np.abs(np.fft.rfft(wav))
    freqs = np.fft.rfftfreq(len(wav), d=1.0 / sr)
    ax_f.semilogy(freqs, np.maximum(spec, 1e-8), c="b", lw=0.5)
    ax_f.set_xlabel("frequency (Hz)")
    ax_f.set_ylabel("|X(f)|")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_phase_channels(segments, out_path: str) -> str:
    """Per-frame phase curves, one stacked subplot per channel — the
    Phase2D_mono grid (visualize_phase.py:34-62 via Plotting.py:149-181):
    each curve is amp * sin(2*pi*phase) over the window, y clipped to
    +-0.9, axes hidden. `segments` is a list of (T, 4, C) dense phase
    windows; several segments overlay per axis (the draw_3 'topk' view)."""
    segments = [np.asarray(s, np.float32) for s in segments]
    assert segments and all(s.ndim == 3 and s.shape[1] == 4
                            for s in segments), \
        [s.shape for s in segments]
    channels = segments[0].shape[2]
    plt = _plt()
    fig, axes = plt.subplots(channels, 1,
                             figsize=(1.2 * max(1, len(segments)), 4),
                             squeeze=False)
    for k in range(channels):
        ax = axes[k, 0]
        for seg in segments:
            curve = seg[:, 2, k] * np.sin(2 * np.pi * seg[:, 0, k])
            ax.plot(np.arange(len(curve)), curve)
        ax.set_ylim(-0.9, 0.9)
        ax.axes.xaxis.set_visible(False)
        ax.axes.yaxis.set_visible(False)
    fig.tight_layout()
    fig.subplots_adjust(wspace=0, hspace=0.1)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_phase_manifold(phase: np.ndarray, out_path: str,
                        max_points: int = 5000) -> str:
    """PCA scatter of the phase manifold (the Plotting.py PCA2D view):
    phase: (T, 4, C) dense params [phase, freq, amp, offset] x channels.
    Embeds the 2C-dim manifold points a*sin(2*pi*p), a*cos(2*pi*p) and
    scatters the first two principal components colored by time."""
    phase = np.asarray(phase)
    assert phase.ndim == 3 and phase.shape[1] == 4, phase.shape
    p = phase[:, 0, :]
    a = phase[:, 2, :]
    pts = np.concatenate([a * np.sin(2 * np.pi * p),
                          a * np.cos(2 * np.pi * p)], axis=1)  # (T, 2C)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    centered = pts - pts.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    proj = centered @ vt[:2].T
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    sc = ax.scatter(proj[:, 0], proj[:, 1], s=3,
                    c=np.arange(len(proj)), cmap="viridis", alpha=0.7)
    fig.colorbar(sc, ax=ax, label="frame")
    ax.set_title("phase manifold (PCA)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def merge_frames(pattern: str, out_path: str, count: int,
                 fps: int = 30) -> str:
    """Stitch a numbered image sequence into a video
    (process/merge_figs.py:5-15, which the reference pairs with the
    per-update PAE training snapshots, PAE.py:468). `pattern` is a
    format string with one `{}` slot (e.g. 'figs/{}.jpg'); frames
    0..count-1 that exist on disk are included, missing indices are
    skipped with a note. Writes mp4 via the ffmpeg matplotlib writer
    when available, else an animated GIF (pillow) — the same fallback
    ladder as render/visualize.py."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg
    from matplotlib import animation

    paths = [pattern.format(i) for i in range(count)]
    frames = [p for p in paths if os.path.exists(p)]
    if not frames:
        raise ValueError(f"no frames match {pattern!r} for 0..{count - 1}")
    if len(frames) < count:
        print(f"merge_frames: {count - len(frames)} of {count} frames "
              "missing, skipped")
    first = mpimg.imread(frames[0])
    h, w = first.shape[:2]
    plt = _plt()
    fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_axis_off()
    im = ax.imshow(first)

    def animate(i):
        im.set_data(first if i == 0 else mpimg.imread(frames[i]))
        return [im]

    ani = animation.FuncAnimation(fig, animate, frames=len(frames),
                                  interval=1000 / fps)
    try:
        if animation.writers.is_available("ffmpeg"):
            ani.save(out_path, fps=fps, writer="ffmpeg")
        else:
            out_path = os.path.splitext(out_path)[0] + ".gif"
            ani.save(out_path, fps=min(fps, 25), writer="pillow")
    finally:
        plt.close(fig)
    return out_path
