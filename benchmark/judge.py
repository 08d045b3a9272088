"""How ``correct`` is decided: the plain reference (``reference/``) works out
again, from the same weights, database and inputs, what the timed path
produced for a sample of its units, and each number compared is held to
its limit (``limits/<cell>.json``).

  * the encoder, from the unit's wav, by the number its model names
    (``models/<model>.py``): WavLM features by the relative Frobenius
    error of each window (``enc_rel_err``); vq-wav2vec codes by the widest
    gap by which a served code's logit lies below the reference's best
    for that frame and group (``enc_logit_gap``);
  * the matching, from the encoder output the program produced for that
    unit (the stage the encoder check covers is not repeated: features a
    float32 ulp apart, or a code whose logit ties the best to an ulp, can
    change a selection): staging, candidate tables and fusion against the
    reference's own staging of the database, from the unit's seeds, or,
    for an entry that carries state, from the state the program carried
    into the unit; the share of codes that differ (``code_diff``), the
    carried codes counted with them and the carried phases by their
    largest difference (``phase_err``), the entry's first state included.
    Both are exact comparisons: the same inputs select the same
    candidates;
  * the decode, from the codes the program served: the largest difference
    of the poses over the reference's largest pose (``pose_err``).

Beside them, not compared, ``code_diff_own``: the share of served codes
that differ from the reference's whole chain, its matching run from its
own encoder output (a carried unit still starts from the program's carried
state). A selection decided by an ulp of a feature or a logit can make it
nonzero in a sound run.

The reference runs after the window, once the program is freed, in blocks
of windows and of queries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import data as bdata
from . import system
from .reference import matching
from .reference import vqvae as ref_vqvae

ENC_BLOCK = 8          # windows through the reference encoder at once


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits; ties away from
    zero, as cvt.rna.tf32.f32 rounds), kept in float32."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)


class TF32(TorchFunctionMode):
    """Every product in TF32: the operands of each convolution, linear
    layer, matrix product and einsum rounded to TF32, sums in float32,
    which is what the tensor cores compute at TF32, whichever algorithm
    cuDNN or cuBLAS would pick."""

    PAIRS = {"conv1d", "conv_transpose1d", "linear", "matmul", "__matmul__",
             "mm", "bmm"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in self.PAIRS:
            args = (round_tf32(args[0]), round_tf32(args[1])) + tuple(
                args[2:])
        elif name == "einsum":
            args = (args[0],) + tuple(round_tf32(a) for a in args[1:])
        return func(*args, **kwargs)


class Reference:
    """The plain reference of one configuration, its weights drawn again
    from the seed and its database staged from the drawn arrays."""

    def __init__(self, cfg: dict, model, db: bdata.Database, seed: int,
                 device):
        system.set_precision(cfg)
        self.cfg, self.model, self.db, self.device = cfg, model, db, device
        self.w_enc = system.encoder_weights(cfg, model, seed, device)
        self.w_dec = system.vqvae_weights(cfg, seed, device)
        m = cfg["match"]
        self.mdb = matching.stage_database(m, db.codes, db.context, db.phase,
                                           db.signature, db.audio, device)
        self.n_steps = len(self.mdb.geom.step_frame)

    def wav(self, wav: np.ndarray) -> torch.Tensor:
        """int16 windows (..., samples) -> float32 (n, samples) / 32768."""
        x = torch.as_tensor(wav.reshape(-1, wav.shape[-1]),
                            device=self.device)
        return x.float() / 32768.0

    def encode(self, wav: torch.Tensor):
        """(n, samples) -> the model's reference output, in blocks."""
        outs = [self.model.reference(self.w_enc, self.cfg,
                                     wav[s:s + ENC_BLOCK])
                for s in range(0, wav.shape[0], ENC_BLOCK)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def tables(self, enc: torch.Tensor, context: np.ndarray):
        m = self.cfg["match"]
        ctx = torch.as_tensor(context.reshape(-1, *context.shape[-2:]),
                              device=self.device)
        strings = m["audio_mode"] == "wavvq_feat"
        aud = matching.candidate_tables(
            self.mdb.aud, matching.stage_audio_queries(self.mdb, enc),
            m["codebook_size"], m["unmatched_dist"], strings)
        txt = matching.candidate_tables(
            self.mdb.txt, matching.stage_context_queries(self.mdb, ctx),
            m["codebook_size"], m["unmatched_dist"], False)
        return aud, txt

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """(C, W * 30) codes -> (C, W * 240, 135) denormalized poses."""
        c = torch.as_tensor(np.asarray(codes, np.int64), device=self.device)
        poses = ref_vqvae.decode(self.w_dec, self.cfg["vqvae"], c)
        std = np.clip(self.db.data_std, 0.01, None)
        return poses.cpu().numpy() * std + self.db.data_mean


def fuse_clips(ref: Reference, aud, txt, u: bdata.Unit, carry=None):
    """The reference's codes of a unit of clips, each fused over its W
    windows from its own seeds: (codes shaped as the wav's windows + (30,),
    None: nothing carried)."""
    W, S = u.wav.shape[-2], ref.n_steps
    codes = np.stack([matching.fuse(
        ref.mdb, aud, txt, c * W * S, W, int(u.init_codes[c]),
        u.init_phases[c])[0] for c in range(len(u.init_codes))])
    return codes.reshape(u.wav.shape[:-1] + (30,)), None


def fuse_streams(ref: Reference, aud, txt, u: bdata.Unit, carry):
    """The reference's codes of a tick of streams, one window each, from
    the (codes, phases) the streams carry in: ((C, 30) codes, the
    (codes, phases) they carry out)."""
    S = ref.n_steps
    out = [matching.fuse(ref.mdb, aud, txt, i * S, 1, int(carry[0][i]),
                         carry[1][i]) for i in range(len(carry[0]))]
    codes = np.stack([c[0] for c, _ in out])
    return codes, (codes[:, -1].copy(), np.stack([p[0] for _, p in out]))


@dataclass
class Record:
    """What the timed path produced for one sampled unit."""
    unit: bdata.Unit
    enc: Optional[torch.Tensor]            # encoder output, its windows
    codes: np.ndarray                      # (..., 30) served codes
    poses: Optional[np.ndarray] = None     # (..., frames, 135) served poses
    before: Optional[Tuple[np.ndarray, np.ndarray]] = None   # carried in
    after: Optional[Tuple[np.ndarray, np.ndarray]] = None    # carried out


def shapes_ok(entry, traffic: dict, rec: Record) -> bool:
    """A unit's outputs have the shapes its inputs call for (a missing or
    misshapen output is a wrong answer)."""
    lead = rec.unit.wav.shape[:-1]
    ok = (rec.enc is not None
          and rec.enc.shape[0] == int(np.prod(lead))
          and np.shape(rec.codes) == lead + (30,))
    if hasattr(entry, "state"):
        ok = ok and rec.after is not None and \
            np.shape(rec.after[0]) == lead[:1]
    if entry.clips(traffic):
        ok = ok and np.shape(rec.poses) == \
            lead[:-1] + (lead[-1] * 240, 135)
    return ok


def numbers(ref: Reference, entry, traffic: dict, records: List[Record],
            first: Optional[Tuple] = None, start: Optional[Tuple] = None
            ) -> Dict[str, float]:
    """The compared numbers over the sampled units, and ``code_diff_own``.
    For an entry that carries state, ``first`` is the state it was given
    and ``start`` what it held once built."""
    model = ref.model
    carries = hasattr(entry, "state")
    n_clips = entry.clips(traffic)
    names = [model.CHECK, "code_diff"] + (["phase_err"] if carries else []) \
        + (["pose_err"] if n_clips else [])
    if not all(shapes_ok(entry, traffic, rec) for rec in records):
        return {n: float("inf") for n in names}
    enc_val = pose_err = phase_err = 0.0
    diff = total = own = own_total = 0
    if carries:
        diff += int((np.asarray(start[0]) != first[0]).sum())
        total += len(first[0])
        phase_err = float(np.abs(start[1] - first[1]).max())
    for rec in records:
        out = ref.encode(ref.wav(rec.unit.wav))
        enc_val = max(enc_val, model.check(out, rec.enc))
        aud, txt = ref.tables(rec.enc.to(ref.device), rec.unit.context)
        codes, after = entry.fuse(ref, aud, txt, rec.unit, rec.before)
        diff += int((codes != rec.codes).sum())
        total += codes.size
        if carries:
            diff += int((after[0] != rec.after[0]).sum())
            total += len(after[0])
            phase_err = max(phase_err, float(np.abs(
                after[1] - rec.after[1]).max()))
        if n_clips:
            ref_poses = ref.decode(np.asarray(rec.codes).reshape(n_clips, -1))
            served = rec.poses.reshape(ref_poses.shape)
            pose_err = max(pose_err, float(np.abs(served - ref_poses).max()
                                           / np.abs(ref_poses).max()))
        aud, txt = ref.tables(model.served(out), rec.unit.context)
        own_codes, _ = entry.fuse(ref, aud, txt, rec.unit, rec.before)
        own += int((own_codes != rec.codes).sum())
        own_total += own_codes.size
    values = {model.CHECK: enc_val, "code_diff": diff / max(total, 1),
              "code_diff_own": own / max(own_total, 1)}
    if carries:
        values["phase_err"] = phase_err
    if n_clips:
        values["pose_err"] = pose_err
    return values


class Control:
    """The reference put in the program's place at TF32 (``TF32``), the
    step below the configuration's float32 with TF32 off: the same units,
    the same outputs, the same records."""

    def __init__(self, ref: Reference, entry, traffic: dict,
                 carry: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.ref, self.entry, self.traffic = ref, entry, traffic
        self.carry = None if carry is None else \
            (np.array(carry[0]), np.array(carry[1]))

    def state(self):
        return None if self.carry is None else \
            (self.carry[0].copy(), self.carry[1].copy())

    def run(self, u: bdata.Unit) -> Record:
        ref = self.ref
        n = self.entry.clips(self.traffic)
        before = self.state()
        with TF32():
            enc = ref.model.served(ref.encode(ref.wav(u.wav)))
            aud, txt = ref.tables(enc, u.context)
            codes, self.carry = self.entry.fuse(ref, aud, txt, u, before)
            poses = None
            if n:
                poses = ref.decode(codes.reshape(n, -1)).reshape(
                    u.wav.shape[:-2] + (-1, 135))
        return Record(u, enc, codes, poses, before, self.state())


def check(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each number against its limit: correct when none exceeds it and
    every limit has its number. A number that is not finite (a misshapen
    answer) is written as a string, so the result stays plain JSON."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        out[name] = {"value": v if v is None or np.isfinite(v) else str(v),
                     "limit": limit}
        ok = ok and good
    return ok, out
