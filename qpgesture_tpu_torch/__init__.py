"""qpgesture_tpu_torch — the PyTorch/CUDA port of qpgesture_tpu.

The JAX package ``qpgesture_tpu`` is the reference; this package mirrors its
module paths and names so each counterpart is easy to find, and imports
nothing from it. Plain tensor code is PyTorch; the reference's Pallas TPU
kernels become hand-written CUDA kernels for Hopper (``csrc/``), each with a
plain PyTorch version beside it.

Ported so far (the staged-feature serving path):

  core/       typed configs + exact npz artifact schemas (copies)
  ops/        ranking, stacking, Levenshtein (plain torch + CUDA kernel)
  match/      database staging (host numpy) + the CodeKNN engine
  models/     VQ-VAE encoder/decoder/bottleneck as nn.Modules, weight
              conversion from the JAX parameter trees
  motion/     rotations, BVH write/parse, skeleton pipeline, FK
  render/     codes -> poses -> BVH
  serve.py    ServingPipeline (match + decode per request)
  cli.py      ``match`` and ``decode``

Precision policy: every float32 contraction runs in true float32. TF32 is
switched off for both matmuls and cuDNN convolutions (cuDNN enables it for
convolutions by default, and the VQ-VAE decoder is all convolutions).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
