"""Raw-pose GestureKNN and the host extras: staging, normalization and the
control masks bit-equal to the JAX package's; search_motion and
search_motion_batch bit-equal to JAX's engine and to the NumPy oracle
(the exact-match skip, ragged clip lengths, per-lane desired_k, masked
frames); fake_training_pairs from the same seed; warmup --rawpose-batch;
motion/features; the batched device MFCC against SphinxMFCCJax."""
import contextlib
import io

import numpy as np
import pytest

from qpgesture_tpu.match import control as jax_control
from qpgesture_tpu.match import gesture_knn as jgk
from qpgesture_tpu.motion import features as jax_features
from qpgesture_tpu.ops.mfcc import MFCCConfig as JaxMFCCConfig
from qpgesture_tpu.ops.mfcc import SphinxMFCCJax
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.match import control
from qpgesture_tpu_torch.match import gesture_knn as pgk
from qpgesture_tpu_torch.motion import features
from qpgesture_tpu_torch.ops.mfcc import MFCCConfig, SphinxMFCC

from fixtures import make_fixture
from test_torch_rawwav import _write_generate_inputs

# the batched MFCC: rfft (pocketfft in both), float32 products with the mel
# bank and the DCT in other summation orders; values reach ~12
MFCC_ATOL = 2e-5


def _data(rng, K=5, L=64, A=12, P=8, J=15):
    feat = rng.randn(K, L, A + P).astype(np.float32)
    motion = rng.randn(K, L, J).astype(np.float32)
    return feat, motion, np.ones((K, L)), A


def _both(feat, motion, mask, A):
    return (jgk.GestureKNNData(feat=feat, motion=motion,
                               control_mask=mask.copy(), n_aud=A),
            pgk.GestureKNNData(feat=feat, motion=motion,
                               control_mask=mask.copy(), n_aud=A))


@pytest.mark.parametrize("seed,n_frames,desired_k,init",
                         [(3, 64, 0, (1, 10)), (3, 64, 2, (1, 10)),
                          (11, 59, 0, (0, 5)), (7, 48, 0, (2, 3)),
                          (8, 9, 4, (4, 0)), (9, 64, 9, (3, 60))])
def test_search_motion_bit_equal_to_jax_and_oracle(seed, n_frames,
                                                   desired_k, init):
    """59 frames: the final block overhangs; seed 7 is the JAX package's
    exact-match case (each step's query pose is copied from the database,
    so a self-match frame at distance exactly 0 must be skipped); desired_k
    9 is past the 5 candidates (the last is taken, as JAX's indexing
    clamps)."""
    rng = np.random.RandomState(seed)
    feat, motion, mask, A = _data(rng, K=3 if seed == 7 else 5,
                                  L=48 if seed == 7 else 64)
    jdb, pdb = _both(feat, motion, mask, A)
    feat_test = rng.randn(A, n_frames).astype(np.float32)
    want = jgk.GestureKNNEngine(jdb).search_motion(feat_test, *init,
                                                   desired_k=desired_k)
    got = pgk.GestureKNNEngine(pdb, device="cpu").search_motion(
        feat_test, *init, desired_k=desired_k)
    assert got.shape == want.shape == (15, n_frames)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if desired_k < feat.shape[0]:
        np.testing.assert_array_equal(got, pgk.search_motion_np(
            pdb, feat_test, *init, desired_k=desired_k))


def test_search_motion_batch_equals_solo_and_jax():
    """Lanes with their own start frames and desired_k, over a database
    with control-masked frames and one empty sequence: each lane equals
    its solo search_motion and JAX's batched engine bit for bit."""
    rng = np.random.RandomState(21)
    feat, motion, mask, A = _data(rng, K=6)
    mask[1, ::3] = 0
    mask[4] = 0
    jdb, pdb = _both(feat, motion, mask, A)
    C = 4
    feat_tests = rng.randn(C, A, 64).astype(np.float32)
    seqs, frms = np.array([0, 2, 5, 3]), np.array([3, 17, 40, 1])
    ks = np.array([0, 2, 1, 3], np.int32)
    engine = pgk.GestureKNNEngine(pdb, device="cpu")
    got = engine.search_motion_batch(feat_tests, seqs, frms, ks)
    want = jgk.GestureKNNEngine(jdb).search_motion_batch(feat_tests, seqs,
                                                         frms, ks)
    np.testing.assert_array_equal(got, want)
    for c in range(C):
        np.testing.assert_array_equal(got[c], engine.search_motion(
            feat_tests[c], int(seqs[c]), int(frms[c]), int(ks[c])))
    assert engine.resident_bytes == feat.nbytes + motion.nbytes + mask.size
    np.testing.assert_array_equal(
        engine.search_motion_batch(feat_tests, seqs, frms)[0],
        engine.search_motion(feat_tests[0], 0, 3))


def test_init_frame_draws_as_jax():
    rng = np.random.RandomState(0)
    feat, motion, mask, A = _data(rng)
    mask[:, ::2] = 0
    jdb, pdb = _both(feat, motion, mask, A)
    got = pgk.GestureKNNEngine(pdb, device="cpu").init_frame(
        np.random.RandomState(1))
    assert got == jgk.GestureKNNEngine(jdb).init_frame(
        np.random.RandomState(1))
    assert mask[got] == 1


@pytest.mark.parametrize("control_type", [None, "hand_high", "hand_low"])
def test_staging_normalization_and_control_bit_equal(control_type):
    fx = make_fixture(np.random.RandomState(4), n_seq=4, n_test=2)
    mfcc, body = fx["bundle"].mfcc, fx["bundle"].body
    want = jgk.stage_gesture_knn(mfcc, body, control_type)
    got = pgk.stage_gesture_knn(mfcc, body, control_type)
    for name in ("feat", "motion", "control_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.n_aud == want.n_aud == 78 and got.feat.shape[-1] == 78 + 180
    test_mfcc = fx["test_bundle"].mfcc
    gdb, gtest = pgk.normalize_gesture_knn(got, test_mfcc)
    wdb, wtest = jgk.normalize_gesture_knn(want, test_mfcc)
    np.testing.assert_array_equal(gdb.feat, wdb.feat)
    np.testing.assert_array_equal(gtest, wtest)
    feat_t = got.feat.transpose(0, 2, 1)
    np.testing.assert_array_equal(
        control.create_control_filter(feat_t, control_type, n_aud_feat=78),
        jax_control.create_control_filter(feat_t, control_type,
                                          n_aud_feat=78))


def test_fake_training_pairs_and_desired_k_match_jax():
    """Stochastic-k audio-only search (ResyncNet's training data) over a
    staged database, the same RandomState seed on both sides."""
    fx = make_fixture(np.random.RandomState(5), n_seq=5, n_test=3)
    pdb, ptest = pgk.normalize_gesture_knn(
        pgk.stage_gesture_knn(fx["bundle"].mfcc, fx["bundle"].body),
        fx["test_bundle"].mfcc)
    jdb, jtest = jgk.normalize_gesture_knn(
        jgk.stage_gesture_knn(fx["bundle"].mfcc, fx["bundle"].body),
        fx["test_bundle"].mfcc)
    got = pgk.fake_training_pairs(pdb, ptest, np.random.RandomState(9))
    want = jgk.fake_training_pairs(jdb, jtest, np.random.RandomState(9))
    assert got.shape == want.shape == (3, 135, 240)
    np.testing.assert_array_equal(got, want)
    for k in (0, 3):
        np.testing.assert_array_equal(
            pgk.search_fake_motion_np(pdb, ptest[0], k),
            jgk.search_fake_motion_np(jdb, jtest[0], k))
    np.testing.assert_array_equal(
        pgk.desired_k_distribution(500, np.random.RandomState(2)),
        jgk.desired_k_distribution(500, np.random.RandomState(2)))


def test_warmup_rawpose_batch(tmp_path):
    """warmup --rawpose-batch: the batched search over the train database's
    raw poses (staged and normalized as JAX's warmup does), run once."""
    rng = np.random.RandomState(6)
    args = _write_generate_inputs(tmp_path, make_fixture(
        rng, n_seq=3, n_test=1, codebook=64), rng, "wavvq")
    files = dict(zip(args[1::2], args[2::2]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli(["warmup", "--train-database", files["--train-database"],
                  "--train-codebook", files["--train-codebook"],
                  "--codebook-signature", files["--codebook-signature"],
                  "--train-wavvq", files["--train-wavvq"], "--preset",
                  "wavvq", "--buckets", "1", "--rawpose-batch", "3",
                  "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert any(ln.startswith("raw-pose batch C=3: first call")
               for ln in lines)
    assert lines[-1].endswith(", raw-pose batch 3")


def test_motion_features_equal_jax():
    rng = np.random.RandomState(3)
    pos = rng.randn(400, 6, 3).cumsum(0) * 0.05
    np.testing.assert_array_equal(features.joint_velocity(pos),
                                  jax_features.joint_velocity(pos))
    np.testing.assert_array_equal(
        features.plant_frames(pos, 2, 0.1, 3.0),
        jax_features.plant_frames(pos, 2, 0.1, 3.0))
    np.testing.assert_array_equal(features.reverse_time(pos),
                                  jax_features.reverse_time(pos))
    signal = np.sin(np.linspace(0, 30, 900)) + 0.3 + 0.01 * rng.randn(900)
    signal[100:110] = signal[100]           # a plateau
    for fn in ("foot_contact_idxs", "foot_contact_signal"):
        got = getattr(features, fn)(signal, min_dist=40)
        want = getattr(jax_features, fn)(signal, min_dist=40)
        for g, w in zip(np.atleast_2d(got) if fn.endswith("signal")
                        else got, np.atleast_2d(want)
                        if fn.endswith("signal") else want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        features.peak_indexes(signal, 0.2, 30),
        jax_features.peak_indexes(signal, 0.2, 30))


@pytest.mark.parametrize("frate", [20, 60])
def test_batched_mfcc_matches_jax(frate):
    sigs = (np.random.RandomState(frate).randn(3, 16000) * 0.1).astype(
        np.float32)
    got = SphinxMFCC(MFCCConfig(frate=frate), device="cpu")(sigs)
    want = SphinxMFCCJax(JaxMFCCConfig(frate=frate))(sigs)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MFCC_ATOL)
