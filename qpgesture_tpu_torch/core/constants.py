"""Framework-wide constants.

Mirrors the reference's constant table
(codebook/Speech2GestureMatching/constant.py:1-41) so that databases built by
the reference remain loadable and the matching semantics stay identical.
"""

# Audio
SR = 16000
WAV_TEST_SIZE = 409600

# Motion window geometry: 240 frames @ 60 fps = 4 s, quantized to 30 codes.
NUM_FRAMES = 240
NUM_FRAMES_CODE = 30
FPS = 60
CODEBOOK_SIZE = 512

# 15 upper-body joints x 3x3 rotation matrix = 135 channels per frame.
NUM_JOINTS_UPPER = 15
JOINT_CHANNELS = 9
POSE_DIM = NUM_JOINTS_UPPER * JOINT_CHANNELS  # 135

# Matching
STEP_SZ = 4                 # codes appended per matching step
NUM_MFCC_FEAT = 13
NUM_AUDIO_FEAT_FRAMES = 6   # stacked context frames for audio features
NUM_BODY_FEAT_FRAMES = 4
FRAME_INTERVAL = 4
NUM_AUDIO_FEAT = NUM_MFCC_FEAT * 8
BODY_FEAT_IDX = [0, 8, 9, 12, 13]  # Spine, R/L Arm, R/L ForeArm
NUM_BODY_FEAT = 144 + 36
NUM_JOINTS = 135

# vq-wav2vec codes: 398 frames per 4 s window, 2 groups, vocab 320 per group.
WAVVQ_FRAMES = 398
WAVVQ_GROUPS = 2
WAVVQ_VOCAB = 320

# WavLM features: 199 frames per 4 s window (interpolated to 180 = 6*30 for
# matching), hidden width 1024.
WAVLM_FRAMES = 199
WAVLM_DIM = 1024

# Sentence-embedding context: 384-d per code slot.
CONTEXT_DIM = 384

# PAE phase manifold: 8 channels x (phase, freq, amplitude, offset).
PHASE_CHANNELS = 8
PHASE_PARAMS = 4

# The canonical 15-joint upper-body skeleton
# (process/beat_data_to_lmdb.py:16-18).
TARGET_JOINTS = [
    "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Neck1", "Head",
    "RightShoulder", "RightArm", "RightForeArm", "RightHand",
    "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
]

FILTER_SMOOTH_STD = 1.5

UPPERBODY_PARENT = [
    1, 11, 1, 2, 3, 1, 5, 6, 10, 10, 10, 10, 1, 13, 13, 14, 15, 13, 17, 18,
    13, 20, 21, 13, 23, 24, 13, 26, 27, 16, 19, 22, 25, 28, 34, 34, 35, 36,
    34, 38, 39, 34, 41, 42, 34, 44, 45, 34, 47, 48, 37, 40, 43, 46, 49,
]
