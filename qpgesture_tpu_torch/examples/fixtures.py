"""Seeded synthetic inputs of the examples, at the reference's tensor shapes
(no real BEAT data ships). Each helper draws from the caller's
``RandomState`` in the order the JAX package's test helpers draw, so the
same seed gives the same arrays."""
from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..core.schemas import CodebookSignature, DatabaseBundle


def make_fixture(rng: np.random.RandomState, n_seq: int = 5,
                 n_test: int = 2, codebook: int = C.CODEBOOK_SIZE) -> dict:
    """A random n_seq-window database and an n_test-window test clip:
    bundle, codes, signature, wavlm (32 wide), wavvq, test_wavlm,
    test_wavvq, test_context, test_bundle (mfcc)."""
    J, W = n_seq, n_test
    bundle = DatabaseBundle(
        body=rng.randn(J, C.NUM_FRAMES, C.POSE_DIM).astype(np.float32),
        mfcc=rng.randn(J, C.NUM_FRAMES, 14).astype(np.float32),
        energy=rng.rand(J, C.NUM_FRAMES).astype(np.float32),
        pitch=rng.rand(J, C.NUM_FRAMES).astype(np.float32),
        volume=rng.rand(J, C.NUM_FRAMES).astype(np.float32),
        context=rng.randn(J, C.NUM_FRAMES_CODE, 1,
                          C.CONTEXT_DIM).astype(np.float32),
        phase=np.stack([
            rng.rand(J, C.NUM_FRAMES, 8),        # phase in [0, 1)
            rng.rand(J, C.NUM_FRAMES, 8) * 4,    # frequency
            rng.rand(J, C.NUM_FRAMES, 8),        # amplitude
            rng.randn(J, C.NUM_FRAMES, 8) * .1,  # offset
        ], axis=2).astype(np.float32),
    )
    codes = rng.randint(0, codebook, size=(J, C.NUM_FRAMES_CODE)
                        ).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(codebook)[:, None], (1, C.NUM_FRAMES_CODE)),
        poses=rng.randn(codebook, C.NUM_FRAMES, C.POSE_DIM
                        ).astype(np.float32),
        signature=rng.randn(codebook, C.POSE_DIM).astype(np.float32))
    wavlm = rng.randn(J, C.WAVLM_FRAMES, 32).astype(np.float32)
    wavvq = rng.randint(0, C.WAVVQ_VOCAB,
                        size=(J, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    test_wavlm = rng.randn(W, C.WAVLM_FRAMES, 32).astype(np.float32)
    test_wavvq = rng.randint(0, C.WAVVQ_VOCAB,
                             size=(W, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    test_context = rng.randn(W, C.NUM_FRAMES_CODE,
                             C.CONTEXT_DIM).astype(np.float32)
    test_bundle = DatabaseBundle(
        mfcc=rng.randn(W, C.NUM_FRAMES, 14).astype(np.float32))
    return dict(bundle=bundle, codes=codes, signature=signature,
                wavlm=wavlm, wavvq=wavvq, test_wavlm=test_wavlm,
                test_wavvq=test_wavvq, test_context=test_context,
                test_bundle=test_bundle)


def make_long_fixture(rng: np.random.RandomState, n_seq: int = 3,
                      n_test: int = 2, codebook: int = 48,
                      num_frames: int = 3600,
                      num_frames_code: int = 450) -> dict:
    """The reference's long-clip mfcc variant (GestureKNN.py:853-854): BVH
    windows of 3600 frames (60 s) with 450 codes, searched in one window of
    113 steps. bundle (mfcc), codes, signature, test_bundle."""
    bundle = DatabaseBundle(
        mfcc=rng.randn(n_seq, num_frames, 14).astype(np.float32))
    codes = rng.randint(0, codebook,
                        size=(n_seq, num_frames_code)).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(codebook)[:, None], (1, num_frames_code)),
        poses=rng.randn(codebook, 8, C.POSE_DIM).astype(np.float32),
        signature=rng.randn(codebook, C.POSE_DIM).astype(np.float32))
    test_bundle = DatabaseBundle(
        mfcc=rng.randn(n_test, num_frames, 14).astype(np.float32))
    return dict(bundle=bundle, codes=codes, signature=signature,
                test_bundle=test_bundle)


def make_beat_like_bvh(rng: np.random.RandomState, n_frames: int,
                       fps: int = 120) -> str:
    """BVH text of a BEAT-like skeleton: Hips, the 15 upper-body target
    joints and a leg (dropped by the motion pipeline), random rotations."""
    def joint(name, children, offset=(0.0, 5.0, 0.0)):
        kids = "".join(children)
        return (f"JOINT {name}\n{{\nOFFSET {offset[0]} {offset[1]} "
                f"{offset[2]}\nCHANNELS 3 Zrotation Xrotation Yrotation\n"
                f"{kids}}}\n")

    end = "End Site\n{\nOFFSET 0.0 2.0 0.0\n}\n"
    head = joint("Head", [end])
    neck1 = joint("Neck1", [head])
    neck = joint("Neck", [neck1])
    rhand = joint("RightHand", [end])
    rfore = joint("RightForeArm", [rhand])
    rarm = joint("RightArm", [rfore], (-3.0, 0.0, 0.0))
    rsh = joint("RightShoulder", [rarm], (-2.0, 4.0, 0.0))
    lhand = joint("LeftHand", [end])
    lfore = joint("LeftForeArm", [lhand])
    larm = joint("LeftArm", [lfore], (3.0, 0.0, 0.0))
    lsh = joint("LeftShoulder", [larm], (2.0, 4.0, 0.0))
    spine3 = joint("Spine3", [neck, rsh, lsh])
    spine2 = joint("Spine2", [spine3])
    spine1 = joint("Spine1", [spine2])
    spine = joint("Spine", [spine1])
    rleg = joint("RightUpLeg", [end], (-3.0, -4.0, 0.0))
    hierarchy = ("HIERARCHY\nROOT Hips\n{\nOFFSET 0 0 0\n"
                 "CHANNELS 6 Xposition Yposition Zposition Zrotation "
                 "Xrotation Yrotation\n" + spine + rleg + "}\nMOTION\n")
    n_ch = 6 + 3 * 17
    vals = np.round(rng.randn(n_frames, n_ch) * 15, 4)
    lines = "\n".join(" ".join("%.4f" % v for v in row) for row in vals)
    return (hierarchy + f"Frames: {n_frames}\nFrame Time: {1/fps:.6f}\n"
            + lines + "\n")
