"""qpgesture_tpu_torch — the PyTorch/CUDA port of qpgesture_tpu.

The JAX package ``qpgesture_tpu`` is the reference; this package mirrors its
module paths and names so each counterpart is easy to find, and imports
nothing from it. Plain tensor code is PyTorch; the reference's Pallas TPU
kernels become hand-written CUDA kernels for Hopper (``csrc/``), each with a
plain PyTorch version beside it.

Ported so far (serving, matching, database construction and training, on
one GPU or over a torch.distributed process group):

  core/       typed configs + exact npz artifact schemas (copies)
  ops/        ranking, stacking, MFCC; Levenshtein (K1) and WavLM's gated
              flash attention (K2), each as plain torch + a CUDA kernel
              (csrc/, built by ops/cuda_build.py); the bfloat16 / bf16x3
              contractions (ops/precision.py)
  match/      database staging (host numpy), device staging of the
              encoders' output, the CodeKNN engine, the NumPy oracle
  models/     VQ-VAE, WavLM, vq-wav2vec, MiniLM, the PAE, ResyncNet and the
              GRU baseline as nn.Modules with the reference checkpoints'
              parameter names; weight conversion from the JAX parameter
              trees
  motion/     rotations, BVH write/parse, skeleton pipeline, FK
  render/     codes -> poses -> BVH
  pipelines/  wav reading/resampling, test-audio windowing, extraction,
              database construction, verify-release
  train/      windowed datasets and the device clip store, checkpoints,
              the VQ-VAE, PAE and GRU-baseline trainers
  utils/      the native host library (WORLD pitch, the record store), the
              scalar history
  parallel/   process groups in place of the JAX mesh, the database-
              sharded candidate search
  serve.py    ServingPipeline, RawWavServer, the streaming classes
  cli.py      the subcommands listed in its docstring

Precision policy: every float32 contraction runs in true float32. TF32 is
switched off for both matmuls and cuDNN convolutions (cuDNN enables it for
convolutions by default, and the VQ-VAE decoder and both audio encoders'
front ends are convolutions). Contractions below float32 happen only where
a config asks for them (WavLM's and the cosine tables' "high" and
"default", 16-bit feature residency), with float32 sums and outputs.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
