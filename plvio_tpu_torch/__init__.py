"""plvio_tpu_torch — the PyTorch + CUDA port of plvio_tpu for one NVIDIA H100.

The JAX package `plvio_tpu` stays the reference; this package mirrors its
layout (`utils`, `solver`, `ops`, `models`) so that every ported function
sits at the same relative path as the JAX function it replaces.  It imports
`torch` and never `jax`.

Hot device stages are hand-written CUDA kernels (`csrc/*.cu`, built with
nvcc for sm_90a at first use, see `cuda.py`).  Each kernel's wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors; there is no silent fallback between the two.

The slices ported so far, from the tracked frames to `System` with loop
closing, are the entry points of `entry.py`.
"""
import torch

# The reference is held in full float32.  cuDNN convolutions default to
# TF32 on Ampere and later (about three decimal digits), and the pyramid,
# blur and Scharr stages are convolutions, so turn TF32 off for both
# matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
