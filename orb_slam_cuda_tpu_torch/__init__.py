"""orb_slam_cuda_tpu_torch — the PyTorch/CUDA port of orb_slam_cuda_tpu.

Each module answers to exactly one module of the JAX package (same
subpackage and file name) and is held against it by the parity tests in
`tests/test_torch_*.py`. The JAX package is the reference; this package
never imports it, nor jax.

Layer map (the monocular track-and-map slice):

  engine/   System facade, tracking, local mapping
  slam_map/ map state (keyframes, points, observation table), map ops
  solvers/  pose-only LM, LM+PCG bundle adjustment, two-view initializer
  matching/ masked Hamming best-two search strategies
  vocab/    BoW vocabulary tree (descent + numpy trainer)
  frontend/ ORB extraction (pyramid, FAST, spatial top-k, rBRIEF)
  ops/      Hamming helpers and the hand-written CUDA FAST kernel
  geometry/ SE3, pinhole camera, triangulation
  utils/    stage timer, ATE evaluation, synthetic scenes, state conversion
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry chains and BA normal equations need full float32: keep TF32
# off for matmuls and convolutions (the counterpart of the reference's
# jax_default_matmul_precision="highest").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
