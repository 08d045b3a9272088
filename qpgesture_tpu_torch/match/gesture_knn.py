"""Raw-pose GestureKNN (the Habibie-style frame-matching baseline).

The reference's `main()` path (GestureKNN.py:70-341): autoregressive
frame-block search where each step finds, per database sequence, the nearest
frame to the current pose feature (skipping exact matches, padded tails, and
control-masked frames), rank-sum-fuses that pose distance with the cosine
audio distance of the candidate block's first frame, and copies the selected
8-frame block.

The staging, the NumPy oracles (``search_motion_np``,
``search_fake_motion_np``), ``fake_training_pairs`` (the fake motion that
ResyncNet trains on) and ``desired_k_distribution`` are copies of the JAX
package's ``match/gesture_knn.py``. ``GestureKNNEngine`` keeps the database
resident on the device and runs the search as a host loop over steps, every
step one pass of torch operations over all (K, L) database frames for all
C lanes at once (the JAX package vmaps a ``lax.scan``); a lane computes
exactly what a solo search computes, and nothing is read back before the
last step.

Documented deviation (the JAX package's): database sequences with no valid
candidate are ranked last (+inf distance) instead of being dropped from the
candidate list, which preserves selection for any desired_k below the valid
count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import constants as C
from ..device import DeviceLike, resolve_device, to_device
from ..ops.ranking import rank, rank_np, tree_sum


@dataclass
class GestureKNNData:
    """Staged database: features (K, L, A+P) normalized, motion (K, L, J)."""
    feat: np.ndarray
    motion: np.ndarray
    control_mask: np.ndarray
    n_aud: int
    step_sz: int = 8


def stage_gesture_knn(mfcc: np.ndarray, body: np.ndarray,
                      control_type=None,
                      step_sz: int = 8) -> GestureKNNData:
    """Build the raw-pose database from window npz arrays, matching
    load_train_db (data_processing.py:12-64): audio feature = 6-frame MFCC
    stack (stride 4), body feature = 4-frame stack (stride 4) of the
    BODY_FEAT_IDX joints' 9-dim rotations; features z-normalized with the
    train stats and the test features normalized with the audio slice
    (predict_gesture_from_audio, GestureKNN.py:299-325).

    mfcc: (K, T, >=13); body: (K, T, 135). Returns staged (unnormalized)
    data plus stats — callers normalize via `normalize_gesture_knn`.
    """
    from ..ops.stacking import stack_post
    from .control import create_control_filter

    mfcc = mfcc[:, :, :C.NUM_MFCC_FEAT].astype(np.float64)
    K, T = mfcc.shape[:2]
    motion = body.reshape(K, T, -1, 9)
    slc = np.take(motion, C.BODY_FEAT_IDX, axis=2).reshape(K, T, -1)
    body_feat = stack_post(slc, C.NUM_BODY_FEAT_FRAMES, C.FRAME_INTERVAL)
    audio_feat = stack_post(mfcc, C.NUM_AUDIO_FEAT_FRAMES, C.FRAME_INTERVAL)
    features = np.concatenate([audio_feat, body_feat], axis=2)
    n_aud = audio_feat.shape[2]
    mask = create_control_filter(features.transpose(0, 2, 1), control_type,
                                 n_aud_feat=n_aud)
    return GestureKNNData(feat=features.astype(np.float32),
                          motion=body.astype(np.float32),
                          control_mask=mask, n_aud=n_aud, step_sz=step_sz)


def normalize_gesture_knn(db: GestureKNNData, test_mfcc: np.ndarray
                          ) -> Tuple[GestureKNNData, np.ndarray]:
    """z-normalize the database features with train stats and stage test
    audio features with the audio-slice stats (GestureKNN.py:306-314).
    Returns (normalized db, (W, n_aud, T) normalized test features)."""
    from ..ops.stacking import stack_post

    feat = db.feat.astype(np.float64)
    mean = feat.mean(axis=(0, 1))
    std = feat.std(axis=(0, 1))
    norm = ((feat - mean) / (std + 1e-8)).astype(np.float32)
    test = stack_post(test_mfcc[:, :, :C.NUM_MFCC_FEAT].astype(np.float64),
                      C.NUM_AUDIO_FEAT_FRAMES, C.FRAME_INTERVAL)
    test = ((test - mean[:db.n_aud]) / (std[:db.n_aud] + 1e-8))
    out_db = GestureKNNData(feat=norm, motion=db.motion,
                            control_mask=db.control_mask, n_aud=db.n_aud,
                            step_sz=db.step_sz)
    return out_db, test.transpose(0, 2, 1).astype(np.float32)


def _valid_frames(d: np.ndarray, mask_row: np.ndarray,
                  step: int) -> np.ndarray:
    L = d.shape[0]
    f_idx = np.arange(L)
    ok = (d != 0.0) & (f_idx <= L - step)
    ok &= (mask_row + np.concatenate(
        [mask_row[step - 1:], np.zeros(step - 1)])[:L]) == 2
    # The reference's candidate loop runs `while ctr < len(sorted_idx) - 1`
    # (GestureKNN.py:174) and so never examines the frame that sorts LAST
    # (the max-distance frame) — a sequence whose only valid frame is that
    # one is dropped. Replicate with the stable-tie analogue: exclude the
    # last index among frames achieving the max distance.
    ok[np.where(d == d.max())[0][-1]] = False
    return ok


def search_motion_np(db: GestureKNNData, feat_test: np.ndarray,
                     init_seq: int, init_frm: int,
                     desired_k: int = 0,
                     tie_kind: str = "stable") -> np.ndarray:
    """NumPy oracle for GestureKNN.search_motion (GestureKNN.py:102-211).
    feat_test: (n_aud, n_frames). Returns (n_joints, n_frames).

    tie_kind='reference' uses NumPy's default unstable argsort like the
    reference (rank-sum collisions are frequent with few sequences)."""
    n_aud, step = db.n_aud, db.step_sz
    K, L = db.feat.shape[:2]
    n_frames = feat_test.shape[1]
    feat = np.concatenate([feat_test[:, :1], feat_test], axis=1)
    pose_feat = np.zeros((db.feat.shape[2] - n_aud, feat.shape[1]),
                         np.float32)
    pose_feat[:, 0] = db.feat[init_seq, init_frm, n_aud:]
    pred = np.zeros((db.motion.shape[2], n_frames + 1), np.float32)

    j = 1
    while j < n_frames:
        cur = pose_feat[:, j - 1]
        pos_dist = np.full(K, np.inf, np.float32)
        frame_sel = np.zeros(K, np.int64)
        for k in range(K):
            if db.control_mask[k].sum() == 0:
                continue
            d = np.linalg.norm(db.feat[k, :, n_aud:] - cur, axis=1)
            ok = _valid_frames(d, db.control_mask[k], step)
            if not ok.any():
                continue
            dm = np.where(ok, d, np.inf)
            f = int(np.argmin(dm))
            pos_dist[k] = dm[f]
            frame_sel[k] = f
        aud_q = feat[:n_aud, j]
        aud_dist = np.full(K, np.inf, np.float32)
        for k in range(K):
            if np.isfinite(pos_dist[k]):
                cand = db.feat[k, frame_sel[k], :n_aud]
                na = np.linalg.norm(aud_q) or 1.0
                nb = np.linalg.norm(cand) or 1.0
                aud_dist[k] = 1.0 - np.dot(aud_q / na, cand / nb)
        if tie_kind == "reference":
            def _rank(x):
                return np.asarray(x).argsort().argsort()
            kind = None
        else:
            _rank = rank_np
            kind = "stable"
        combined = (_rank(pos_dist).astype(np.float64)
                    + _rank(aud_dist).astype(np.float64))
        combined = np.where(np.isfinite(pos_dist), combined, np.inf)
        sel = int(np.argsort(combined, kind=kind)[desired_k])
        f = frame_sel[sel]
        blk_feat = db.feat[sel, f:f + step, n_aud:].T       # (P, <=step)
        blk_pose = db.motion[sel, f:f + step].T             # (J, <=step)
        # clamp to the remaining columns: for n_frames % step != 0 the final
        # block overhangs the output buffers (the jitted engine handles this
        # by padding; the oracle must not crash where the engine works)
        w = min(blk_feat.shape[1], pose_feat.shape[1] - j)
        pose_feat[:, j:j + w] = blk_feat[:, :w]
        pred[:, j:j + w] = blk_pose[:, :w]
        j += step
    return pred[:, 1:]


class GestureKNNEngine:
    """Device engine for the raw-pose baseline. The database tensors go to
    ``device`` once at construction and stay resident across searches: the
    pose features as (P, K*L) (the distance reduces over P, the leading
    axis), the audio features (K*L, A), the motion (K*L, J) and the static
    validity mask (K, L): tail frames, control mask, empty sequences."""

    def __init__(self, db: GestureKNNData, device: DeviceLike = "cuda"):
        self.db = db
        self.device = resolve_device(device)
        K, L, F = db.feat.shape
        A, step = db.n_aud, db.step_sz
        feat = db.feat.reshape(K * L, F)
        self._pose_t = to_device(np.ascontiguousarray(feat[:, A:].T),
                                 self.device)
        self._aud = to_device(np.ascontiguousarray(feat[:, :A]), self.device)
        self._motion = to_device(db.motion.reshape(K * L, -1), self.device,
                                 torch.float32)
        mask = db.control_mask.astype(np.float32)
        f_idx = np.arange(L)
        mask_ok = (mask + np.concatenate(
            [mask[:, step - 1:], np.zeros((K, step - 1))], axis=1)[:, :L]) == 2
        static_ok = (f_idx <= L - step)[None, :] & mask_ok & \
            (mask.sum(axis=1) > 0)[:, None]
        self._static_ok = to_device(static_ok, self.device)
        self._f_idx = torch.arange(L, device=self.device)
        self._k_idx = torch.arange(K, device=self.device)
        self._steps = torch.arange(step, device=self.device)

    @property
    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self._pose_t, self._aud, self._motion, self._static_ok))

    def init_frame(self, rng: np.random.RandomState) -> Tuple[int, int]:
        """Random valid start frame (init_frame, GestureKNN.py:91-99)."""
        K, L = self.db.feat.shape[:2]
        while True:
            s, f = rng.randint(0, K), rng.randint(0, L)
            if self.db.control_mask[s, f] == 1:
                return s, f

    def _step(self, cur: torch.Tensor, aud_q: torch.Tensor,
              desired_k: torch.Tensor):
        """One step of every lane: cur (C, P) pose features, aud_q (C, A)
        the step's audio query. Returns (the selected blocks' motion rows
        (C, step, J), the next pose feature (C, P))."""
        K, L = self.db.feat.shape[:2]
        step = self.db.step_sz
        n = cur.shape[0]
        # Direct difference form, not the expanded a2-2ab+b2 matmul: every
        # step's query pose is copied verbatim from the selected block, so
        # an exact-match frame exists, and the `d != 0` skip depends on its
        # distance being exactly zero.
        # pose features leading: each level of the tree adds two
        # contiguous slabs
        diff = self._pose_t[:, None] - cur.T[:, :, None]      # (P, C, KL)
        diff.mul_(diff)
        d = torch.sqrt(tree_sum(diff, 0)).view(n, K, L)
        del diff
        ok = self._static_ok & (d != 0.0)
        # the reference's off-by-one: the max-distance frame (last in sort
        # order; stable-tie analogue = last occurrence of the max) is never
        # a candidate (GestureKNN.py:174)
        last_max = torch.where(d == d.amax(-1, keepdim=True), self._f_idx,
                               -1).amax(-1)                    # (C, K)
        ok &= self._f_idx != last_max[..., None]
        inf = float("inf")
        dm = d.masked_fill(~ok, inf)
        f_sel = dm.argmin(-1)                                  # (C, K)
        pos = dm.gather(-1, f_sel[..., None])[..., 0]
        valid = torch.isfinite(pos)

        cand = self._aud.index_select(
            0, (self._k_idx * L + f_sel).reshape(-1)).view(n, K, -1)
        nq = torch.sqrt(tree_sum(aud_q * aud_q, 1))
        nq = torch.where(nq > 0, nq, torch.ones_like(nq))
        nc = torch.sqrt(tree_sum(cand * cand, 2))
        nc = torch.where(nc > 0, nc, torch.ones_like(nc))
        # true float32 products and a fixed sum, no matmul: distances
        # feed ranks
        aud = 1.0 - tree_sum(cand * (aud_q / nq[:, None])[:, None, :], 2) \
            / nc
        aud = aud.masked_fill(~valid, inf)
        combined = rank(pos.masked_fill(~valid, inf)).float() + \
            rank(aud).float()
        combined = combined.masked_fill(~valid, inf)
        order = torch.sort(combined, dim=-1, stable=True).indices
        sel = order.gather(1, desired_k[:, None])[:, 0]        # (C,)
        f = f_sel.gather(1, sel[:, None])[:, 0]
        rows = (sel * L + f)[:, None] + self._steps            # (C, step)
        blocks = self._motion.index_select(0, rows.reshape(-1)).view(
            n, step, -1)
        return blocks, self._pose_t.index_select(1, rows[:, -1]).T

    def search_motion(self, feat_test: np.ndarray, init_seq: int,
                      init_frm: int, desired_k: int = 0) -> np.ndarray:
        """feat_test: (n_aud, n_frames). Returns (n_joints, n_frames): the
        one-lane call of ``search_motion_batch``."""
        return self.search_motion_batch(
            feat_test[None], np.array([init_seq]), np.array([init_frm]),
            np.array([desired_k]))[0]

    def search_motion_batch(self, feat_tests: np.ndarray,
                            init_seqs: np.ndarray, init_frms: np.ndarray,
                            desired_ks: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """C independent searches as lanes of one host loop over steps.

        feat_tests: (C, n_aud, n_frames), the same length per sequence (the
        reference's test sets are fixed-length windows). Each step advances
        all C lanes with batched operations; each lane equals its solo
        ``search_motion``. Returns (C, n_joints, n_frames)."""
        db = self.db
        step, A = db.step_sz, db.n_aud
        K = db.feat.shape[0]
        C_, _, n_frames = feat_tests.shape
        n_steps = int(np.ceil((n_frames - 1) / step))
        feats = np.concatenate([feat_tests[:, :, :1], feat_tests], axis=2)
        pad = 1 + n_steps * step + step - feats.shape[2]
        if pad > 0:
            feats = np.pad(feats, ((0, 0), (0, 0), (0, pad)))
        if desired_ks is None:
            desired_ks = np.zeros((C_,), np.int64)
        # an index past the candidates takes the last, as JAX's clamps
        ks = to_device(np.clip(np.asarray(desired_ks, np.int64), 0, K - 1),
                       self.device)
        feats_d = to_device(feats.astype(np.float32), self.device)
        cur = to_device(db.feat[np.asarray(init_seqs), np.asarray(init_frms),
                                A:], self.device, torch.float32)
        blocks = []
        for i in range(n_steps):
            blk, cur = self._step(cur, feats_d[:, :, 1 + step * i], ks)
            blocks.append(blk)
        width = max(1 + n_steps * step, n_frames + 1)
        out = np.zeros((C_, db.motion.shape[2], width), np.float32)
        if n_steps:
            flat = torch.cat(blocks, 1).cpu().numpy()      # (C, S*step, J)
            out[:, :, 1:1 + n_steps * step] = flat.transpose(0, 2, 1)
        # pred_motion[:, 1:] (GestureKNN.py:150): drop the init column
        return out[:, :, 1:1 + n_frames]


def search_fake_motion_np(db: GestureKNNData, feat_test: np.ndarray,
                          desired_k: int = 0) -> np.ndarray:
    """Audio-only search (search_fake_motion, GestureKNN.py:214-296), used
    to synthesize mismatched motion for ResyncNet training: per step, rank
    database sequences by the cosine distance between the step's audio
    feature and each sequence's best frame; no pose chaining."""
    n_aud, step = db.n_aud, db.step_sz
    K, L = db.feat.shape[:2]
    n_frames = feat_test.shape[1]
    pred = np.zeros((db.motion.shape[2], n_frames), np.float32)
    j = 0
    while j < n_frames:
        q = feat_test[:, j]
        nq = np.linalg.norm(q) or 1.0
        pos_dist = np.full(K, np.inf, np.float32)
        frame_sel = np.zeros(K, np.int64)
        for k in range(K):
            if db.control_mask[k].sum() == 0:
                continue
            cand = db.feat[k, :, :n_aud]
            nc = np.linalg.norm(cand, axis=1)
            nc = np.where(nc > 0, nc, 1.0)
            d = 1.0 - (cand @ (q / nq)) / nc
            ok = _valid_frames(d, db.control_mask[k], step)
            if not ok.any():
                continue
            dm = np.where(ok, d, np.inf)
            f = int(np.argmin(dm))
            pos_dist[k] = dm[f]
            frame_sel[k] = f
        order = np.argsort(rank_np(pos_dist), kind="stable")
        sel = int(order[min(desired_k, K - 1)])
        f = frame_sel[sel]
        blk = db.motion[sel, f:f + step].T
        w = min(blk.shape[1], n_frames - j)
        pred[:, j:j + w] = blk[:, :w]
        j += step
    return pred


def fake_training_pairs(db: GestureKNNData, feat_tests: np.ndarray,
                        rng: np.random.RandomState) -> np.ndarray:
    """Stochastic-k fake motion for a batch of test features
    (predict_gesture_from_audio fake path, GestureKNN.py:330-335)."""
    ks = desired_k_distribution(feat_tests.shape[0], rng)
    return np.stack([search_fake_motion_np(db, feat_tests[i], int(ks[i]))
                     for i in range(feat_tests.shape[0])])


def desired_k_distribution(n: int, rng: np.random.RandomState) -> np.ndarray:
    """The stochastic k sampling of predict_gesture_from_audio
    (GestureKNN.py:330-331): P(k=0)=0.5, remainder uniform over 1..14."""
    p = [0.5] + [0.5 / 14] * 14
    return rng.choice(15, n, p=p)
