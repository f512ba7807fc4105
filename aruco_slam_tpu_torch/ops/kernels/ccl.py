"""K3-K5s: the fused adaptive-threshold / 3x3-close / connected-component
kernel family as one CUDA source (``csrc/ccl.cu``), one thread block per
frame and one launch per chunk of frames.

Counterpart of ``aruco_slam_tpu.ops.kernels.ccl``:

- K3 :func:`threshold_label_union` — threshold, 3x3 closing, CCL of the raw
  mask, then CCL of the closed mask seeded with the raw labels (the
  detector's default, ``closing_union=True``);
- K4 :func:`threshold_label` — threshold, then CCL;
- K5 / K5s :func:`label_components` — CCL of a given mask, from scratch or
  seeded with ``init``.

Each computes what its plain version beside it computes, bit for bit: the
threshold is exact integer arithmetic in float32 until its two divisions
(for integer-valued images), and the labelling is integer min-propagation.
The plain versions are built from ``ops.detector``'s ``adaptive_threshold``,
``binary_close3`` and ``label_components``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The fused threshold needs a power-of-two ``stride`` that divides H
and W (:func:`fused_threshold_ok`); the detector routes other frames to the
plain threshold and close around K5 / K5s, as the JAX detector does.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

# Kernel launches by entry point since import (or since a caller reset
# them): a run shows it went through a kernel by its count growing.
LAUNCHES = {
    "threshold_label_union": 0,  # K3
    "threshold_label": 0,  # K4
    "label_components": 0,  # K5
    "label_components_seeded": 0,  # K5s
}

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _lib():
    lib = _build.load("ccl")
    if lib.ccl_threshold_union_launch.argtypes is None:
        thr = [_P, _I] + [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]
        lib.ccl_threshold_union_launch.argtypes = thr
        lib.ccl_threshold_launch.argtypes = thr
        lib.ccl_label_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.ccl_label_seeded_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        for fn in (lib.ccl_threshold_union_launch, lib.ccl_threshold_launch,
                   lib.ccl_label_launch, lib.ccl_label_seeded_launch):
            fn.restype = _I
        lib.ccl_error_string.argtypes = [_I]
        lib.ccl_error_string.restype = ctypes.c_char_p
    return lib


def fused_threshold_ok(h: int, w: int, stride: int) -> bool:
    """Whether the fused kernels' threshold equals ``adaptive_threshold``:
    the block mean is ``sum * (1 / s^2)``, the division's value only for a
    power-of-two stride, and the block grid must tile the frame."""
    return stride >= 1 and (stride & (stride - 1)) == 0 and h % stride == 0 and w % stride == 0


def _window_radius(radius: int, stride: int) -> int:
    # Python's round() is half-to-even, as in the JAX package
    return max(1, round(radius / stride))


def _check_image(img: Tensor, stride: int) -> None:
    if img.dim() != 3:
        raise ValueError(f"img must be [N, H, W], got {tuple(img.shape)}")
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"img must be uint8 or float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    _, h, w = img.shape
    if not fused_threshold_ok(h, w, stride):
        raise ValueError(
            f"fused threshold needs a power-of-two stride dividing H and W; got "
            f"{h}x{w}, stride {stride}"
        )


def _check_mask(fg: Tensor, init) -> None:
    if fg.dim() != 3:
        raise ValueError(f"fg must be [N, H, W], got {tuple(fg.shape)}")
    if fg.dtype != torch.bool:
        raise TypeError(f"fg must be bool, got {fg.dtype}")
    if not fg.is_contiguous():
        raise ValueError("fg must be contiguous")
    if init is not None:
        if init.shape != fg.shape:
            raise ValueError(f"init must be {tuple(fg.shape)}, got {tuple(init.shape)}")
        if init.dtype != torch.int32:
            raise TypeError(f"init must be int32, got {init.dtype}")
        if init.device != fg.device:
            raise ValueError(f"init on {init.device}, fg on {fg.device}")
        if not init.is_contiguous():
            raise ValueError("init must be contiguous")


def _route(t: Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _raise_on(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.ccl_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def threshold_label_union_reference(img, radius, C, stride, rounds, closed_rounds=None):
    """K3's plain version: (fg [N, H, W] bool, labels [N, H*W] int32,
    fg_closed, labels_closed)."""
    if closed_rounds is None:
        closed_rounds = rounds
    fg = detector.adaptive_threshold(img, radius, C, stride)
    fg_c = detector.binary_close3(fg)
    lab = detector.label_components(fg, rounds)
    lab_c = detector.label_components(fg_c, closed_rounds, init=lab.reshape(fg.shape))
    return fg, lab, fg_c, lab_c


def threshold_label_reference(img, radius, C, stride, rounds):
    """K4's plain version: (fg [N, H, W] bool, labels [N, H*W] int32)."""
    fg = detector.adaptive_threshold(img, radius, C, stride)
    return fg, detector.label_components(fg, rounds)


def label_components_reference(fg, rounds, init=None):
    """K5's (K5s's with ``init``) plain version: labels [N, H*W] int32."""
    return detector.label_components(fg, rounds, init=init)


# ---------------------------------------------------------------------------
# Kernel entry points
# ---------------------------------------------------------------------------


def threshold_label_union(img: Tensor, radius: int, C: float, stride: int, rounds: int,
                          closed_rounds: int | None = None):
    """K3: threshold + 3x3 close + CCL of both masks (the closed one seeded
    with the raw labels) for a chunk of frames ``img [N, H, W]`` (uint8 or
    float32). Returns (fg, labels, fg_closed, labels_closed): masks
    ``[N, H, W]`` bool, labels ``[N, H*W]`` int32."""
    if closed_rounds is None:
        closed_rounds = rounds
    _check_image(img, stride)
    if not _route(img):
        return threshold_label_union_reference(img, radius, C, stride, rounds, closed_rounds)
    return _launch_threshold(img, radius, C, stride, rounds, closed_rounds, union=True)


def threshold_label(img: Tensor, radius: int, C: float, stride: int, rounds: int):
    """K4: threshold + CCL. Returns (fg [N, H, W] bool, labels [N, H*W] int32)."""
    _check_image(img, stride)
    if not _route(img):
        return threshold_label_reference(img, radius, C, stride, rounds)
    return _launch_threshold(img, radius, C, stride, rounds, 0, union=False)


def label_components(fg: Tensor, rounds: int, init: Tensor | None = None) -> Tensor:
    """K5 (K5s with ``init [N, H, W]`` int32): CCL of ``fg [N, H, W]`` bool.
    Returns labels [N, H*W] int32: a foreground pixel's label is the least
    flat index its propagation reached; background keeps its own index."""
    _check_mask(fg, init)
    if not _route(fg):
        return label_components_reference(fg, rounds, init)
    N, h, w = fg.shape
    lab = torch.empty(N, h * w, dtype=torch.int32, device=fg.device)
    tmp = torch.empty_like(lab)
    lib = _lib()
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream(fg.device).cuda_stream
        if init is None:
            err = lib.ccl_label_launch(fg.data_ptr(), None, lab.data_ptr(), tmp.data_ptr(),
                                       N, h, w, rounds, stream)
            name = "label_components"
        else:
            err = lib.ccl_label_seeded_launch(fg.data_ptr(), init.data_ptr(), lab.data_ptr(),
                                              tmp.data_ptr(), N, h, w, rounds, stream)
            name = "label_components_seeded"
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return lab


def _launch_threshold(img, radius, C, stride, rounds, closed_rounds, union):
    N, h, w = img.shape
    dev = img.device
    r_ds = _window_radius(radius, stride) if stride > 1 else radius
    cells = (h // stride) * (w // stride)
    fg = torch.empty(N, h, w, dtype=torch.bool, device=dev)
    lab = torch.empty(N, h * w, dtype=torch.int32, device=dev)
    tmp = torch.empty_like(lab)
    grid = torch.empty(N, 2, cells, dtype=torch.float32, device=dev)
    if union:
        fg_c = torch.empty_like(fg)
        lab_c = torch.empty_like(lab)
        dil = torch.empty_like(fg)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = lib.ccl_threshold_union_launch if union else lib.ccl_threshold_launch
        err = fn(
            img.data_ptr(), int(img.dtype == torch.uint8),
            fg.data_ptr(), lab.data_ptr(),
            fg_c.data_ptr() if union else None, lab_c.data_ptr() if union else None,
            dil.data_ptr() if union else None, tmp.data_ptr(), grid.data_ptr(),
            N, h, w, stride, r_ds, float(C), rounds, closed_rounds, stream,
        )
    name = "threshold_label_union" if union else "threshold_label"
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return (fg, lab, fg_c, lab_c) if union else (fg, lab)
