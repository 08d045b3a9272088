"""Sphinx-III MFCC on the host (NumPy), the database builder's features.

The reference vendors CMU Sphinx's MFCC (Speech2GestureMatching/mfcc.py:
32-173): 40-filter mel bank between 133.3333 and 6855.4976 Hz with
round()-snapped triangle edges, Hamming window of 0.0256 s, pre-emphasis
0.97 whose `prior` carries the *previous frame's last sample* across
(overlapping) frames, power spectrum clipped at 1e-5 before log, and the
'legacy not-quite-DCT' s2dct matrix (mfcc.py:176-183) whose first column is
halved — all preserved exactly, including the np.resize cyclic padding of
the final short frames (mfcc.py:113-115, the zeroing line there is a no-op).

A copy of the host half of the JAX package's ``ops/mfcc.py``, so the stored
features are bit-equal to it; its batched device MFCC is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device


def mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def melinv(m):
    return 700.0 * (np.power(10.0, m / 2595.0) - 1.0)


def mel_filterbank(nfft: int = 512, nfilt: int = 40, samprate: int = 16000,
                   lowerf: float = 133.3333, upperf: float = 6855.4976
                   ) -> np.ndarray:
    """(nfft//2+1, nfilt) triangle bank with Sphinx's integer-snapped edges
    and 2/fwidth peak height."""
    filters = np.zeros((nfft // 2 + 1, nfilt), dtype=np.float64)
    dfreq = samprate / nfft
    melmax, melmin = mel(upperf), mel(lowerf)
    dmelbw = (melmax - melmin) / (nfilt + 1)
    edges = melinv(melmin + dmelbw * np.arange(nfilt + 2, dtype=np.float64))
    for w in range(nfilt):
        leftfr = round(edges[w] / dfreq)
        centerfr = round(edges[w + 1] / dfreq)
        rightfr = round(edges[w + 2] / dfreq)
        fwidth = (rightfr - leftfr) * dfreq
        height = 2.0 / fwidth
        if centerfr != leftfr:
            leftslope = height / (centerfr - leftfr)
        else:
            leftslope = 0
        freq = leftfr + 1
        while freq < centerfr:
            filters[freq, w] = (freq - leftfr) * leftslope
            freq += 1
        if freq == centerfr:
            filters[freq, w] = height
            freq += 1
        if centerfr != rightfr:
            rightslope = height / (centerfr - rightfr)
            while freq < rightfr:
                filters[freq, w] = (freq - rightfr) * rightslope
                freq += 1
    return filters


def s2dctmat(nfilt: int = 40, ncep: int = 13) -> np.ndarray:
    """Sphinx legacy 'not-quite-DCT' (mfcc.py:176-183): cos(pi*i/nfilt *
    (0.5..nfilt-0.5)), first column halved."""
    melcos = np.empty((ncep, nfilt), dtype=np.float64)
    for i in range(ncep):
        freq = np.pi * i / nfilt
        melcos[i] = np.cos(freq * np.arange(0.5, nfilt + 0.5, 1.0))
    melcos[:, 0] *= 0.5
    return melcos


@dataclass
class MFCCConfig:
    nfilt: int = 40
    ncep: int = 13
    lowerf: float = 133.3333
    upperf: float = 6855.4976
    alpha: float = 0.97
    samprate: int = 16000
    frate: int = 60
    wlen_s: float = 0.0256
    nfft: int = 512

    @property
    def wlen(self) -> int:
        return int(self.wlen_s * self.samprate)

    @property
    def fshift(self) -> float:
        return self.samprate / self.frate


def _frame_table(cfg: MFCCConfig, n_samples: int):
    """Start indices per frame (int(round(fr*fshift)),
    sig2s2mfc_energy:161) and the frame count int(len/fshift + 1)."""
    nfr = int(n_samples / cfg.fshift + 1)
    starts = np.array([int(round(fr * cfg.fshift)) for fr in range(nfr)])
    return nfr, starts


def _gather_frames_np(sig: np.ndarray, cfg: MFCCConfig) -> np.ndarray:
    nfr, starts = _frame_table(cfg, len(sig))
    wlen = cfg.wlen
    frames = np.zeros((nfr, wlen), dtype=np.float64)
    for fr, start in enumerate(starts):
        end = min(len(sig), start + wlen)
        frame = sig[start:end]
        if len(frame) < wlen:
            frame = np.resize(frame, wlen)  # cyclic pad (Sphinx quirk)
        frames[fr] = frame
    return frames


def _pre_emphasis_np(frames: np.ndarray, alpha: float) -> np.ndarray:
    """Per-frame pre-emphasis with `prior` = previous frame's last sample
    (mfcc.py:135-142); first frame's prior is 0."""
    out = np.empty_like(frames)
    out[:, 1:] = frames[:, 1:] - alpha * frames[:, :-1]
    priors = np.concatenate([[0.0], frames[:-1, -1]])
    out[:, 0] = frames[:, 0] - alpha * priors
    return out


def sphinx_mfcc_np(sig: np.ndarray, cfg: MFCCConfig | None = None
                   ) -> np.ndarray:
    """Host oracle: (n_samples,) -> (n_frames, ncep)."""
    cfg = cfg or MFCCConfig()
    frames = _gather_frames_np(np.asarray(sig, np.float64), cfg)
    emph = _pre_emphasis_np(frames, cfg.alpha) * np.hamming(cfg.wlen)
    fft = np.fft.rfft(emph, cfg.nfft, axis=1)
    power = fft.real ** 2 + fft.imag ** 2
    fb = mel_filterbank(cfg.nfft, cfg.nfilt, cfg.samprate, cfg.lowerf,
                        cfg.upperf)
    logspec = np.log(np.clip(power @ fb, 1e-5, np.inf))
    return logspec @ s2dctmat(cfg.nfilt, cfg.ncep).T / cfg.nfilt



class SphinxMFCC:
    """Batched MFCC on the device: (B, n_samples) -> (B, n_frames, ncep).

    Frames are gathered on the host (the cyclic padding of the short final
    frames, float64 then float32, as the JAX package does); pre-emphasis,
    the Hamming window, ``rfft``, the power spectrum, the mel bank and the
    DCT run on ``device`` in float32, the two products as true float32
    GEMMs (TF32 off package-wide)."""

    def __init__(self, cfg: MFCCConfig | None = None,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg or MFCCConfig()
        self.device = resolve_device(device)
        c = self.cfg
        self._fb = to_device(mel_filterbank(c.nfft, c.nfilt, c.samprate,
                                            c.lowerf, c.upperf),
                             self.device, torch.float32)
        self._dct = to_device(s2dctmat(c.nfilt, c.ncep).T, self.device,
                              torch.float32)
        self._win = to_device(np.hamming(c.wlen), self.device, torch.float32)

    def compute(self, frames: torch.Tensor, priors: torch.Tensor
                ) -> torch.Tensor:
        """frames (B, n_frames, wlen) and each frame's prior sample (B,
        n_frames), on the device -> (B, n_frames, ncep)."""
        c = self.cfg
        emph = torch.cat((frames[..., :1] - c.alpha * priors[..., None],
                          frames[..., 1:] - c.alpha * frames[..., :-1]), -1)
        spec = torch.fft.rfft(emph * self._win, c.nfft, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        logspec = torch.log(torch.clamp(power @ self._fb, min=1e-5))
        return (logspec @ self._dct) / c.nfilt

    def __call__(self, sigs: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        sigs = np.asarray(sigs, np.float32)
        B = sigs.shape[0]
        frames = np.stack([_gather_frames_np(s.astype(np.float64), cfg)
                           for s in sigs]).astype(np.float32)
        priors = np.concatenate(
            [np.zeros((B, 1), np.float32), frames[:, :-1, -1]], axis=1)
        out = self.compute(to_device(frames, self.device),
                           to_device(priors, self.device))
        return out.cpu().numpy()
