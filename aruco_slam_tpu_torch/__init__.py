"""aruco_slam_tpu_torch — the marker-SLAM engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper on its hot path.

The JAX package ``aruco_slam_tpu`` beside it is the reference; this package
keeps its module names so each counterpart is easy to find:

- ``ops``       — geometry, camera model, square PnP, the PnP front-end
- ``ops.kernels`` — the CUDA kernels (``csrc/*.cu``) and their wrappers
- ``models``    — the EKF-SLAM core (batch-first)
- ``sim``, ``io``, ``utils`` — numpy-only copies of the generator, the
  sequence container, map I/O, the config system and the float64
  reference EKF; ``utils.device``
- ``runner``    — batched and single-stream replay at every level, sharded
  replay and detection, ``.asq`` streaming
- ``parallel``  — ``torch.distributed`` groups, the rank launcher, the
  distributed BA, the multi-rank dry run and the single-chip entry step
- ``system``, ``viz`` — the streaming ``SlamSystem`` and its output records
- ``pipeline``, ``cli``, ``demo``, ``bench`` — filter -> smoother, the
  command line, the end-to-end demo, the benchmark harness
- ``convert``   — state and config carried across from the JAX package

It imports torch and numpy, never ``jax`` and never ``aruco_slam_tpu``.
Entry points that make tensors put them on the card unless given
``device``.
"""

__version__ = "0.1.0"

import torch as _torch

# A float32 matmul or convolution on Ampere and later may run in TF32 (about
# three decimal digits). That is the GPU form of the TPU's bf16 default:
# the EKF covariance recursion loses positive-definiteness under it and NaNs
# on long runs. Estimation math needs true float32 products.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
