"""The plain reference against hand-built cases at small sizes on the CPU,
the TF32 control's rounding, and the weights' names against the program's
modules."""
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import judge, spec, weights
from benchmark.reference import matching
from benchmark.reference import vq_wav2vec as ref_vq
from benchmark.reference import vqvae as ref_vqvae
from benchmark.reference import wavlm as ref_wavlm

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(name, rehearsal=True):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        c = json.load(f)
    if rehearsal:
        from benchmark.spec import merge
        c = merge(c, c["rehearsal"])
    return c


def test_edit_distance_by_hand():
    words = {"kitten": "sitting", "flaw": "lawn", "abc": "abc",
             "abcdefg": "gabcdef"}
    L = 7
    enc = lambda w: [ord(ch) for ch in w] + [0] * (L - len(w))
    a = torch.tensor([enc(w) for w in words])
    b = torch.tensor([enc(w) for w in words.values()])
    d = matching.edit_distance(a, b)
    assert d.diag().tolist() == [3, 2, 0, 2]
    assert d[2, 2] == 0 and d[0, 2] == matching.edit_distance(
        a[:1], b[2:3])[0, 0]


def test_candidate_tables_first_minimum_in_scan_order():
    # four candidates of codes [1, 0, 1, 1]; the query is closest to the
    # 2nd and 4th (equal distance): code 1 keeps the earlier, index 2
    feat = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8], [0.6, 0.8]])
    side = matching.Side(feat=feat, codes=torch.tensor([1, 0, 1, 1]),
                         blocks=np.zeros((4, 4), np.int64),
                         seq=np.zeros(4, np.int64), frame=np.zeros(4))
    t = matching.candidate_tables(side, torch.tensor([[0.0, 2.0]]), 3,
                                  1000.0, strings=False)
    assert t.index.tolist() == [[1, 2, -1]]
    np.testing.assert_allclose(t.dist[0], [0.0, 0.2, 1000.0], atol=1e-6)


def test_geometry_of_both_modes():
    g = matching.geometry("wavvq_feat")
    assert len(g.step_frame) == 8 and len(g.block_code) == 26
    assert g.block_frame[:4].tolist() == [0, 13, 26, 39]  # int(k 398/30)
    assert g.step_frame.tolist() == [0, 53, 106, 159, 212, 265, 318, 371]
    g = matching.geometry("wavlm_feat")
    assert g.n_frames == 180 and len(g.block_code) == 26
    assert g.block_frame[-1] == 150 and g.step_slot.tolist() == list(
        range(0, 30, 4))
    slots, frames = matching.text_slots()
    assert slots.tolist() == list(range(26)) and frames[-1] == 200


def test_interpolation_is_linear_with_aligned_corners():
    x = torch.randn(2, 199, 5)
    y = matching.interpolate(x, 180)
    assert torch.equal(y[:, 0], x[:, 0]) and torch.equal(y[:, -1], x[:, -1])
    c = 90 * 198 / 179                      # output frame 90's coordinate
    lo, w = int(c), np.float32(c - int(c))
    torch.testing.assert_close(y[:, 90], x[:, lo] * (1 - w) + x[:, lo + 1] * w)
    # torch's own, which rounds its weights otherwise
    want = F.interpolate(x.transpose(1, 2), size=180, mode="linear",
                         align_corners=True).transpose(1, 2)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=0)


def test_wavvq_strings_by_hand():
    codes = torch.zeros(1, 398, 2, dtype=torch.long)
    codes[0, :, 0] = torch.arange(398)
    codes[0, :, 1] = 7
    s = matching.wavvq_strings(codes, np.array([0, 100]))
    # shifts -66 -53 -39 -26 -13 0 13 26 39 53 66 (int(j 398/30))
    assert s[0, 0].tolist() == [0] * 5 + [7 + 320 * t for t in
                                          (0, 13, 26, 39, 53, 66)]
    assert s[0, 1].tolist() == [7 + 320 * t for t in
                                (34, 47, 61, 74, 87, 100, 113, 126, 139,
                                 153, 166)]


def test_position_buckets_by_hand():
    b = ref_wavlm.position_buckets(5, 320, 800, "cpu")
    # a key after the query goes to the upper half; small distances exact
    assert b[0].tolist() == [0, 161, 162, 163, 164]
    assert b[4].tolist() == [4, 3, 2, 1, 0]
    far = ref_wavlm.position_buckets(400, 320, 800, "cpu")
    assert far[0, 399] <= 319 and far[399, 0] <= 159


def test_fusion_picks_by_phase_continuity():
    cfg = {"use_phase": True, "use_aud": True, "use_txt": True,
           "freq_weight": 0.05}
    geom = matching.Geometry(398, np.zeros(1, np.int64), np.zeros(1, np.int64),
                             np.zeros(8, np.int64), np.zeros(8, np.int64))
    phase = np.zeros((2, 240, 8), np.float32)
    amp = np.ones((2, 240, 8), np.float32)
    phase[1] = 1.0                   # sequence 1 continues a phase of ones
    side = lambda seq, block: matching.Side(
        feat=None, codes=None, blocks=np.array([block]),
        seq=np.array([seq]), frame=np.array([0]))
    db = matching.Database(cfg=cfg, geom=geom, aud=side(0, [5, 6, 7, 8]),
                           txt=side(1, [9, 10, 11, 12]), phase=phase,
                           amp=amp, sig_dist=np.ones((16, 16), np.float32),
                           freq_rank=np.zeros(16, np.int64))
    # every code but the block's own ties at 1000: the candidate tables
    # rank code 0 first on both sides
    dist = np.full((8, 16), 1000.0, np.float32)
    dist[:, 0] = 0.0
    idx = np.full((8, 16), -1)
    idx[:, 0] = 0
    t = matching.Tables(dist, idx)
    seed_phase = np.ones((8, 16), np.float32)
    codes, last = matching.fuse(db, t, t, 0, 1, 3, seed_phase)
    assert codes[0, :4].tolist() == [9, 10, 11, 12]   # text: phase of ones
    np.testing.assert_array_equal(last[0], np.ones((8, 16)))
    codes, _ = matching.fuse(db, t, t, 0, 1, 3,
                             np.concatenate((np.zeros((8, 8)),
                                             np.ones((8, 8))), 1))
    assert codes[0, :4].tolist() == [5, 6, 7, 8]      # audio: zero phase


def test_continuity_sums_over_a_fixed_tree():
    """Sums pair halves level by level, so their rounding is fixed: here
    the pairs cancel first, where a running sum would lose the ones."""
    x = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    assert matching._tree_sum(x) == 2.0
    odd = np.array([1.0, 2.0, 4.0, 8.0, 16.0], np.float32)
    assert matching._tree_sum(odd) == 31.0         # the fifth joins the first
    prev = np.tile(np.arange(1.0, 17.0, dtype=np.float32), (8, 1))
    assert matching._continuity(prev, prev) == np.float32(0.0)
    head = prev.copy()
    head[:, 8:] *= -1.0
    a = np.concatenate((prev[-5:], head[:3])).reshape(-1)
    b = np.concatenate((prev[-3:], head[:5])).reshape(-1)
    want = 1.0 - a @ b / np.sqrt((a @ a) * (b @ b))
    np.testing.assert_allclose(matching._continuity(prev, head), want,
                               rtol=1e-6)


def test_decoder_of_zero_weights_is_its_bias():
    v = _cfg("wavlm-large-j1024")["vqvae"]
    w = {n: torch.zeros(s) for n, s, _ in weights.vqvae_spec(v)}
    w["decoders.0.out.bias"] = torch.arange(135.0)
    poses = ref_vqvae.decode(w, v, torch.zeros(2, 30, dtype=torch.long))
    assert poses.shape == (2, 240, 135)
    torch.testing.assert_close(poses, torch.arange(135.0).expand(2, 240, 135))


def test_vq_wav2vec_codes_follow_the_projection_bias():
    c = _cfg("vq-wav2vec-j16384")
    w = weights.draw(spec.plugin("models", "vq_wav2vec").spec(c), 1, 1,
                     "cpu")
    last = f"vector_quantizer.weight_proj.{c['vq_depth'] - 1}"
    w[last + ".weight"] = torch.zeros_like(w[last + ".weight"])
    bias = torch.zeros(640)
    bias[17], bias[320 + 5] = 1.0, 1.0
    w[last + ".bias"] = bias
    codes, logits = ref_vq.codes(w, c, torch.randn(1, 64000) * 0.1)
    assert logits.shape == (1, 398, 2, 320)
    assert (codes[..., 0] == 17).all() and (codes[..., 1] == 5).all()


def test_wavlm_of_zero_layers_is_normalized_input_projection():
    c = _cfg("wavlm-large-j1024")
    c["num_hidden_layers"] = 1
    w = weights.draw(spec.plugin("models", "wavlm").spec(c), 2, 1, "cpu")
    f = ref_wavlm.features(w, c, torch.randn(2, 16000))
    assert f.shape == (2, 49, c["hidden_size"])
    # the last LayerNorm leaves each frame at the affine's scale
    g, b = w["encoder.layer_norm.weight"], w["encoder.layer_norm.bias"]
    z = (f - b) / g
    torch.testing.assert_close(z.mean(-1), torch.zeros(2, 49), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("model", ["wavlm", "vq_wav2vec", "vqvae"])
def test_weight_names_load_into_the_program(model):
    """The published names the benchmark draws are the program modules'
    own, every one of them, at the rehearsal sizes."""
    from benchmark import system
    if model == "vqvae":
        from qpgesture_tpu_torch.core.config import VQVAEConfig
        from qpgesture_tpu_torch.models.vqvae import VQVAE
        v = _cfg("wavlm-large-j1024")["vqvae"]
        m = VQVAE(VQVAEConfig(width=v["width"], depth=v["depth"],
                              emb_width=v["emb_width"]), device="cpu")
        w = system.vqvae_weights(_cfg("wavlm-large-j1024"), 3, "cpu")
    else:
        c = _cfg("wavlm-large-j1024" if model == "wavlm"
                 else "vq-wav2vec-j16384")
        mod = spec.plugin("models", model)
        m = mod.program(c, "cpu")
        w = system.encoder_weights(c, mod, 3, "cpu")
    m.load_state_dict(w, strict=True)


def test_round_tf32_by_hand():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      3.0, 0.0])
    assert judge.round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0,
                                            -(1 + 2.0 ** -10), 3.0, 0.0]


def test_tf32_mode_rounds_every_product():
    a = torch.full((1, 4), 1.0 + 2.0 ** -12)
    b = torch.ones(4, 1)
    x, k = a[None], torch.ones(1, 1, 4)
    with judge.TF32():
        out = [a @ b, torch.matmul(a, b), F.linear(a, b.T),
               torch.einsum("ij,jk->ik", a, b), F.conv1d(x, k),
               F.conv_transpose1d(x, torch.ones(1, 1, 1)).sum()]
    assert [o.sum().item() for o in out] == [4.0] * 6
    assert (a @ b).item() == 4.0 + 4 * 2.0 ** -12
