"""The benchmark's yardstick: published peaks of the card, and the least
work of each kernel and unit, computed from shapes alone.

Every count is a floor on the work, whatever implements it, so that no
sound redesign reads above 100 % of a peak: each input byte is counted
read once and each output byte written once, and the operations are those
the mathematics needs.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit.
H100_SXM = {
    "tf32_flops": 495e12,      # tensor cores, TF32 (and bf16x3-grade f32)
    "f32_flops": 67e12,        # CUDA cores, float32
    "hbm_bytes": 3.35e12,      # HBM3 bytes per second
    "sms": 132,
    "boost_hz": 1.98e9,
    # 32-bit integer lane operations per SM per clock (4 x 32 lanes)
    "int32_lane_ops_per_sm_clock": 128,
}
# Edit-distance DP cells per 32-bit lane operation: two 16-bit cells per
# word (the DPX x2 forms, or two bit-parallel patterns in one word).
K1_CELLS_PER_LANE_OP = 2


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the card named ``device_name``, or None for a
    card they do not describe (then no share of a peak is reported)."""
    if "H100" in device_name and "PCIe" not in device_name:
        return H100_SXM
    return None


def k1_cells_per_s(p: dict) -> float:
    return (K1_CELLS_PER_LANE_OP * p["int32_lane_ops_per_sm_clock"]
            * p["sms"] * p["boost_hz"])


def k1_work(Q: int, N: int, L: int) -> Tuple[float, float]:
    """(DP cells, bytes) of the (Q, L) x (N, L) int32 edit-distance matrix:
    Q N L^2 cells; both string sets read once, the int32 (Q, N) written
    once."""
    return float(Q) * N * L * L, 4.0 * (Q * L + N * L + Q * N)


def k2_work(B: int, H: int, T: int, hd: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of float32 gated attention over (B, H, T, hd): the
    two products, 4 B H T^2 hd; q, k, v, the gate and the (H, T, T) bias
    read once, the float32 output written once."""
    ops = 4.0 * B * H * T * T * hd
    elems = 3 * B * H * T * hd + B * H * T + H * T * T + B * H * T * hd
    return ops, 4.0 * elems


def least_seconds(ops: float, bytes_: float, op_rate: float,
                  byte_rate: float) -> float:
    return max(ops / op_rate, bytes_ / byte_rate)


def conv_out(T: int, k: int, s: int) -> int:
    """Frames out of an unpadded convolution of kernel k and stride s."""
    return (T - k) // s + 1


def conv_frames(cfg: dict, n_samples: int) -> int:
    """Frames out of the configuration's unpadded conv stack."""
    T = n_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        T = conv_out(T, k, s)
    return T


def wavlm_flops(cfg: dict, B: int, n_samples: int) -> Tuple[float, float]:
    """(FLOPs outside attention, attention FLOPs) of WavLM over B windows:
    convolutions, projections and feed-forward as multiply-adds (2 per),
    the gate's projection, and the attention's two products."""
    flops = 0.0
    T, c_in = n_samples, 1
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"],
                         cfg["conv_stride"]):
        T = conv_out(T, k, s)
        flops += 2.0 * c_in * k * dim * T
        c_in = dim
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H = cfg["num_attention_heads"]
    hd = D // H
    groups, kp = cfg["num_conv_pos_embedding_groups"], \
        cfg["num_conv_pos_embeddings"]
    flops += 2.0 * T * c_in * D                       # post_extract_proj
    flops += 2.0 * T * D * (D // groups) * kp         # positional conv
    per_layer = 2.0 * T * (4 * D * D + 2 * D * F) + 2.0 * T * H * hd * 8
    flops += cfg["num_hidden_layers"] * per_layer
    attn = cfg["num_hidden_layers"] * k2_work(1, H, T, hd)[0]
    return B * flops, B * attn


def vq_wav2vec_flops(cfg: dict, B: int, n_samples: int) -> float:
    flops = 0.0
    T, c_in = n_samples, 1
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"],
                         cfg["conv_stride"]):
        T = conv_out(T, k, s)
        flops += 2.0 * c_in * k * dim * T
        c_in = dim
    d_in = c_in
    out = cfg["vq_groups"] * cfg["vq_vars"]
    inner = 2 * c_in
    for _ in range(cfg["vq_depth"] - 1):
        flops += 2.0 * T * d_in * inner
        d_in = inner
    flops += 2.0 * T * d_in * out
    return B * flops


def vqvae_decode_flops(v: dict, n_clips: int, n_codes: int) -> float:
    """The decoder over n_clips code strings of n_codes codes."""
    w, e = v["width"], v["emb_width"]
    L = n_codes
    flops = 2.0 * L * e * w * 3
    for i in range(v["down_t"]):
        flops += v["depth"] * (2.0 * L * w * w * 3 + 2.0 * L * w * w)
        out = e if i == v["down_t"] - 1 else w
        flops += 2.0 * L * w * out * 2 * v["stride_t"]
        L *= v["stride_t"]
    flops += 2.0 * L * e * v["input_dim"] * 3
    return n_clips * flops


def union_seconds(intervals: Iterable[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi) that no interval covers, in time order."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def unit_windows(entry, traffic: dict) -> int:
    """4 s windows a unit of the mix carries."""
    n = 1
    for d in entry.lead(traffic):
        n *= d
    return n


def unit_flops(cfg: dict, model, entry, traffic: dict, steps: int,
               aud_blocks: int, txt_blocks: int) -> float:
    """Floating-point work of one unit: the encoder (attention included),
    the cosine tables (the text side always, the audio side as the model
    says: WavLM's features, none for edit distances, which are integer
    work) and the decode of the unit's clips."""
    n = unit_windows(entry, traffic)
    enc = model.flops(cfg, n, traffic["samples"])
    Q = n * steps
    J = cfg["database"]["windows"]
    tables = 2.0 * Q * J * txt_blocks * cfg["match"]["context_dim"] \
        + model.table_flops(cfg, Q, J * aud_blocks)
    clips = entry.clips(traffic)
    dec = vqvae_decode_flops(cfg["vqvae"], clips,
                             n // max(clips, 1) * cfg["vqvae"]["sample_length"])
    return enc + tables + dec
