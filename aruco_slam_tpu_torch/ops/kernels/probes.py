"""P1b and P2: the copy probes of the JAX package's CCL and detector
studies as CUDA kernels (``csrc/probes.cu``), one launch a chunk of frames.

- :func:`copy_to_int32` — ``benchmarks/_ccl_fixed_probe.py:68``
  ``copy_kernel``: a float32 chunk ``[N, H, W]`` cast to int32 (truncation
  toward zero), the floor under K4, which reads a frame and writes int32;
- :func:`scale_copy` — ``benchmarks/_det_chain_probe.py:222`` ``kern``:
  the chunk times 1.0000001 in float32, the floor under one detector stage.

Each reads every input byte once and writes every output byte once, so its
time on the card over its bytes is the card's achieved copy rate
(``tools/ccl_probes.py``). Each computes what its plain version beside it
computes, bit for bit: one IEEE multiply by the constant rounded to float32
(:data:`SCALE`), or the C cast. The cast's contract is the probes' values,
[-0.99, 256): the int32 of a value outside int32's range, or of NaN,
differs between XLA, the card's ``cvt.rzi`` and torch's CPU cast, and the
wrapper does not clamp it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

NAMES = ("probe_copy", "probe_scale")
# Kernel launches by name since import (or since a caller reset them): a run
# shows it went through a kernel by its count growing.
LAUNCHES = dict.fromkeys(NAMES, 0)
# JAX's ``x * 1.0000001`` rounds the weak-typed constant to float32
# (1.00000011920928955078125), and so do torch's multiply of a float32
# tensor by a Python float and csrc's ``1.0000001f``.
SCALE = 1.0000001

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = _build.load("probes")
    if lib.probe_copy_launch.argtypes is None:
        for fn in (lib.probe_copy_launch, lib.probe_scale_launch):
            fn.argtypes = [_P, _P, _L, _P]
            fn.restype = _I
        lib.probe_error_string.argtypes = [_I]
        lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _check(img: Tensor) -> bool:
    """Raises on what the kernels do not take; True for the kernel (CUDA),
    False for the plain version (CPU)."""
    if img.dim() != 3:
        raise ValueError(f"img must be [N, H, W], got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"img must be float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    return True


def copy_to_int32_reference(img: Tensor) -> Tensor:
    """P1b's plain version: ``img`` cast to int32."""
    return img.to(torch.int32)


def scale_copy_reference(img: Tensor) -> Tensor:
    """P2's plain version: ``img * 1.0000001`` in float32."""
    return img * SCALE


def copy_to_int32(img: Tensor) -> Tensor:
    """P1b: ``img [N, H, W]`` float32 cast to int32, one launch."""
    if not _check(img):
        return copy_to_int32_reference(img)
    return _launch("probe_copy", img, torch.int32)


def scale_copy(img: Tensor) -> Tensor:
    """P2: ``img [N, H, W]`` float32 times 1.0000001, one launch."""
    if not _check(img):
        return scale_copy_reference(img)
    return _launch("probe_scale", img, torch.float32)


def _launch(name: str, img: Tensor, dtype: torch.dtype) -> Tensor:
    out = torch.empty(img.shape, dtype=dtype, device=img.device)
    lib = _lib()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(img.data_ptr(), out.data_ptr(), img.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.probe_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return out
