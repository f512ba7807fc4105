"""K3-K5s: the fused adaptive-threshold / 3x3-close / connected-component
kernel family as one CUDA source (``csrc/ccl.cu``), one launch per chunk of
frames, in two bodies chosen by the frame's shape alone (:func:`body`):

- ``"cluster"``: one frame per cluster of 8 CTAs, each owning a band of
  rows whose labels and masks stay in its shared memory (every frame whose
  band fits 227 KB: the detector's 480x640 bucket);
- ``"block"``: every other frame (1280x720, 1920x1080, any H and W), cut
  into tiles of at most 64 rows by 2048 pixels, a CTA a tile, the tiles of
  a frame a team of CTAs that meets at a barrier in device memory, in one
  cooperative launch that holds as many teams as fit the card
  (:func:`block_plan`). A tile's labels and masks stay in its CTA's shared
  memory where the frame's team fits the card's SMs, else in device memory.

Counterpart of ``aruco_slam_tpu.ops.kernels.ccl``:

- K3 :func:`threshold_label_union` — threshold, 3x3 closing, CCL of the raw
  mask, then CCL of the closed mask seeded with the raw labels (the
  detector's default, ``closing_union=True``);
- K4 :func:`threshold_label` — threshold, then CCL;
- K5 / K5s :func:`label_components` — CCL of a given mask, from scratch or
  seeded with ``init``;
- P1a :func:`threshold_only` — the probe
  ``benchmarks/_ccl_fixed_probe.py:49`` ``thr_only_kernel``: K4's threshold
  stage alone, foreground written as int32. It is K4's own code with the
  labelling compiled out, so that its time is the stage's share of K4's.

Each computes what its plain version beside it computes, bit for bit: the
threshold adds in the plain version's order and divides as it does (exact
integer arithmetic in float32 until its two divisions for integer-valued
images), and the labelling is integer min-propagation.
The plain versions are built from ``ops.detector``'s ``adaptive_threshold``,
``binary_close3`` and ``label_components``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises: a refused launch raises ``RuntimeError`` and nothing retries on the
other body. The fused threshold needs a power-of-two ``stride`` that divides
H and W (:func:`fused_threshold_ok`); the detector routes other frames to
the plain threshold and close around K5 / K5s, as the JAX detector does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

NAMES = (
    "threshold_label_union",  # K3
    "threshold_label",  # K4
    "label_components",  # K5
    "label_components_seeded",  # K5s
    "threshold_only",  # P1a
)
BODIES = ("cluster", "block")
# Kernel launches by "entry point.body" since import (or since a caller
# reset them): a run shows it went through a kernel by its count growing.
LAUNCHES = {f"{name}.{b}": 0 for name in NAMES for b in BODIES}

# The cluster body's geometry (csrc/ccl.cu: kClusterCtas, cluster_layout):
# CTAs per frame, the tallest band and widest row it takes, and the shared
# memory a CTA may use on Hopper (227 KB).
CLUSTER_CTAS = 8
MAX_BAND_ROWS, MAX_ROW_PIXELS = 64, 1024
MAX_SHARED_BYTES = 232_448

# The block body's geometry (csrc/ccl.cu: tile_layout): the tallest and
# widest tile (a tile column's and a lane's share of a tile row's mask bits
# in one 64-bit register), and the SMs of an H100 SXM, which stand in for
# the card's own count where there is no card.
MAX_TILE_ROWS, MAX_TILE_WIDTH = 64, 2048
H100_SMS = 132
# The plan's cost of a team barrier, in tile pixels: about 3 us against
# about 6.5 ns a tile pixel for a whole K3 (the cluster body's 0.26 ms for
# a band of 38,400 pixels), at about 20 barriers a frame.
BARRIER_PIXELS = 9_000

_VARIANTS = {name: i for i, name in enumerate(NAMES)}  # csrc ccl_cluster_plan
_plans: set = set()  # (device index, entry point, h, w, stride) planned
_block_sms: dict = {}  # (device index, entry point): SMs the block body may use
_barriers: dict = {}  # (device index, stream): the block body's team barrier words
MAX_TEAMS = 4096  # teams a barrier buffer serves

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = _build.load("ccl")
    if lib.ccl_threshold_union_launch.argtypes is None:
        block = [_I] * 4 + [_P, _L, _P, _L, _P, _I, _P]  # tile geometry .. body, stream
        thr = [_P, _I] + [_P] * 4 + [_I] * 5 + [_F, _I, _I] + block
        lib.ccl_threshold_union_launch.argtypes = thr
        lib.ccl_threshold_launch.argtypes = thr
        lab = [_P, _P, _P] + [_I] * 4 + block
        lib.ccl_label_launch.argtypes = lab
        lib.ccl_label_seeded_launch.argtypes = lab
        lib.ccl_threshold_only_launch.argtypes = [_P, _I, _P] + [_I] * 5 + [_F] + block
        lib.ccl_cluster_plan.argtypes = [_I] * 4 + [ctypes.POINTER(_I)] * 2
        lib.ccl_block_plan.argtypes = [_I, ctypes.POINTER(_I)]
        for fn in (lib.ccl_threshold_union_launch, lib.ccl_threshold_launch,
                   lib.ccl_label_launch, lib.ccl_label_seeded_launch,
                   lib.ccl_threshold_only_launch, lib.ccl_cluster_plan, lib.ccl_block_plan):
            fn.restype = _I
        lib.ccl_error_string.argtypes = [_I]
        lib.ccl_error_string.restype = ctypes.c_char_p
    return lib


def cluster_shared_bytes(h: int, w: int, stride: int | None = None) -> int | None:
    """Shared bytes per CTA of the cluster body for an ``h x w`` frame
    (``stride``: the fused threshold's block stride, None for K5 / K5s), or
    None where the frame does not take it: h a multiple of 8 (a band of
    ``h / 8`` rows per CTA, at most 64: a band column's mask bits in one
    register), w a multiple of 32 (a mask row in whole 32-bit words) and at
    most 1024, the band a whole number of block rows, and all within 227
    KB. The band's labels, its edge / halo / summary rows, three bit masks,
    and a Jacobi chunk buffer of as many rows as fit (at least one; it
    first holds the threshold's three block grids). Mirrors csrc
    ``cluster_layout``."""
    if h <= 0 or w <= 0 or h % CLUSTER_CTAS or w % 32:
        return None
    rows, wq = h // CLUSTER_CTAS, w // 32
    if rows > MAX_BAND_ROWS or w > MAX_ROW_PIXELS:
        return None
    cells = 0
    if stride is not None:
        if stride < 1 or rows % stride or w % stride:
            return None
        cells = (rows // stride) * (w // stride)
    cap = MAX_SHARED_BYTES // 4
    words = rows * w + 7 * w + 3 * rows * wq + 2 * wq
    if words >= cap:
        return None
    chunk = min(rows, (cap - words) // w)
    if chunk < 1:
        return None
    words += max(chunk * w, 3 * cells)
    return 4 * words if words <= cap else None


def body(h: int, w: int, stride: int | None = None) -> str:
    """The kernel body for ``h x w`` frames, by shape alone: ``"cluster"``
    where :func:`cluster_shared_bytes` takes the frame, else ``"block"``."""
    return "cluster" if cluster_shared_bytes(h, w, stride) is not None else "block"


class BlockPlan(NamedTuple):
    """The block body's launch for a chunk of ``n`` h x w frames."""

    tile_rows: int
    tile_width: int  # a multiple of 32; the last tile across may hold fewer pixels
    tiles_x: int
    tiles_y: int
    teams: int  # frames in flight, a team of CTAs each
    ctas: int  # CTAs a team: its tiles, or ceil(tiles / k) taking k tiles each where spilled
    spilled: bool  # the tiles' workspaces in device memory (more tiles than SMs)
    smem_bytes: int  # a CTA's shared memory (0 where spilled)
    work_words: int  # the spilled workspaces (0 where resident)


def block_tile_words(rows: int, width: int, shared: bool = True) -> int | None:
    """4-byte words of a ``rows x width`` tile's workspace in the block
    body, or None where the tile does not take it: at most 64 rows, a width
    that is a multiple of 32 and at most 2048 and, in shared memory, within
    227 KB. The tile's labels (its pixels while the threshold runs), three
    bit masks with a ring of the neighbours' bits, the halo rows and
    columns, and each 32-pixel word's first and last pre-step label (the
    Jacobi step's); the threshold's window sums and means take the words
    past the raw mask until the labels start, a chunk of cell rows at a
    time (a launch whose tiles hold not even one row's raises: a window
    radius of hundreds of cells at stride 1). Mirrors csrc
    ``tile_layout``."""
    if not (1 <= rows <= MAX_TILE_ROWS and 32 <= width <= MAX_TILE_WIDTH and width % 32 == 0):
        return None
    wq = width // 32
    words = rows * width + 2 * (width + 2) + 2 * rows + (3 * rows + 8) * (wq + 2) + 2 * rows * wq
    return None if shared and words > MAX_SHARED_BYTES // 4 else words


def block_scratch_words(h: int, w: int, plan: BlockPlan, stride: int | None = None) -> int:
    """A team's exchange scratch in 4-byte words: the threshold's two grids
    of block means, for the team's even and odd frames (``stride``: the
    fused threshold's, None for K5 / K5s), each tile row's edge rows and
    run summaries, each tile column's edge columns and run summaries.
    Mirrors csrc ``team_words``."""
    cells = (h // stride) * (w // stride) if stride else 0
    return 2 * cells + 4 * plan.tiles_y * w + 4 * plan.tiles_x * h


def _tile_columns(w: int) -> tuple[int, int]:
    """(tiles across, tile width): tiles as wide as the frame up to 2048
    pixels, wider frames in equal tiles, a multiple of 32 wide."""
    tiles_x = -(-w // MAX_TILE_WIDTH)
    return tiles_x, 32 * -(-(-(-w // tiles_x)) // 32)  # ceil(w / tiles_x) up to whole words


def spilled_plan(h: int, w: int, sms: int = H100_SMS) -> BlockPlan:
    """The block body's plan with the tiles' workspaces in device memory,
    one team of at most ``sms`` CTAs that work through the tiles in turn
    (the kernel's rule: CTA r takes tiles r, r + ctas, ...). Tiles as wide
    as :func:`block_plan`'s; the tile height that gives the busiest CTA the
    least work: its ``k = ceil(tiles / sms)`` tiles times a tile's pixels
    plus ``BARRIER_PIXELS``, the fixed cost that keeps the plan off 1-row
    tiles. The team is ``ceil(tiles / k)`` CTAs, so that each takes k tiles
    or k - 1 and no CTA without a tile meets the barriers. A frame whose
    tiles fit the SMs gets the resident plan's geometry. :func:`block_plan`
    falls back to it where a frame's tiles cannot all be resident at once;
    passed to ``threshold_label(..., plan=)`` it runs a smaller frame
    spilled too."""
    tiles_x, width = _tile_columns(w)
    best = None
    for rows in range(1, min(MAX_TILE_ROWS, h) + 1):
        tiles = tiles_x * -(-h // rows)
        k = -(-tiles // sms)
        cost = k * (rows * width + BARRIER_PIXELS)
        if best is None or cost < best[0]:
            best = (cost, rows, tiles, k)
    _, rows, tiles, k = best
    return BlockPlan(rows, width, tiles_x, tiles // tiles_x, 1, -(-tiles // k), True, 0,
                     tiles * block_tile_words(rows, width, shared=False))


def block_plan(h: int, w: int, n: int, sms: int = H100_SMS) -> BlockPlan:
    """The block body's geometry for ``n`` h x w frames on a card of
    ``sms`` SMs, a CTA on each at most. Tiles as wide as the frame up to
    2048 pixels (wider frames in equal tiles, a multiple of 32 wide); the
    tile height that fills the card best: the fewest waves of frames times
    a wave's cost, a tile's pixels plus ``BARRIER_PIXELS``. Where no tile
    height lets a frame's tiles fit the SMs at once, :func:`spilled_plan`."""
    tiles_x, width = _tile_columns(w)
    best = None
    for rows in range(1, min(MAX_TILE_ROWS, h) + 1):
        words = block_tile_words(rows, width)
        if words is None:
            break
        tiles_y = -(-h // rows)
        tiles = tiles_x * tiles_y
        if tiles > sms:
            continue
        teams = min(n, sms // tiles)
        cost = -(-n // teams) * (rows * width + BARRIER_PIXELS)
        if best is None or cost < best[0]:
            best = (cost, BlockPlan(rows, width, tiles_x, tiles_y, teams, tiles, False,
                                    4 * words, 0))
    return best[1] if best is not None else spilled_plan(h, w, sms)


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


def threshold_only_reference(img, radius, C, stride):
    """P1a's plain version: fg [N, H, W] int32 (1 on the foreground)."""
    return detector.adaptive_threshold(img, radius, C, stride).to(torch.int32)


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
    return _launch_threshold(img, radius, C, stride, rounds, closed_rounds, True,
                             body(*img.shape[1:], stride))


def threshold_label(img: Tensor, radius: int, C: float, stride: int, rounds: int,
                    plan: BlockPlan | None = None):
    """K4: threshold + CCL. Returns (fg [N, H, W] bool, labels [N, H*W] int32).
    ``plan``: the block body's plan (None: :func:`block_plan` on this
    card), for a frame that takes the block body: a frame the cluster body
    takes raises ValueError, and the launch refuses a plan the chunk cannot
    take (csrc ``block_launch``; RuntimeError). The plan changes where the
    tiles' workspaces live and which CTA works on which tile, not the
    result."""
    _check_image(img, stride)
    if plan is not None and body(*img.shape[1:], stride) != "block":
        raise ValueError(f"a {img.shape[1]}x{img.shape[2]} frame takes the cluster body, "
                         f"which reads no plan")
    if not _route(img):
        return threshold_label_reference(img, radius, C, stride, rounds)
    return _launch_threshold(img, radius, C, stride, rounds, 0, False,
                             body(*img.shape[1:], stride), plan)


def threshold_only(img: Tensor, radius: int, C: float, stride: int) -> Tensor:
    """P1a: K4's threshold stage alone for a chunk ``img [N, H, W]`` (uint8
    or float32), in the body K4 takes. Returns fg [N, H, W] int32."""
    _check_image(img, stride)
    if not _route(img):
        return threshold_only_reference(img, radius, C, stride)
    N, h, w = img.shape
    kind = body(h, w, stride)
    fg = torch.empty(N, h, w, dtype=torch.int32, device=img.device)
    lib = _lib()
    with torch.cuda.device(img.device):
        if kind == "cluster":
            _plan_cluster(lib, "threshold_only", h, w, stride)
            block = _NO_BLOCK_ARGS
        else:
            block, _buffers = _block_args(lib, "threshold_only", img, stride)
        err = lib.ccl_threshold_only_launch(
            img.data_ptr(), int(img.dtype == torch.uint8), fg.data_ptr(), N, h, w, stride,
            _window_radius(radius, stride) if stride > 1 else radius, float(C), *block,
            int(kind == "cluster"), _stream(img.device))
    _raise_on(err, lib, f"threshold_only ({kind} body)")
    LAUNCHES[f"threshold_only.{kind}"] += 1
    return fg


def label_components(fg: Tensor, rounds: int, init: Tensor | None = None) -> Tensor:
    """K5 (K5s with ``init [N, H, W]`` int32): CCL of ``fg [N, H, W]`` bool.
    Returns labels [N, H*W] int32: a foreground pixel's label is the least
    flat index its propagation reached; background keeps its own index."""
    _check_mask(fg, init)
    if not _route(fg):
        return label_components_reference(fg, rounds, init)
    return _launch_label(fg, rounds, init, body(*fg.shape[1:]))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _plan_cluster(lib, name: str, h: int, w: int, stride: int | None) -> None:
    """The cluster body's plan, once per device and shape: the kernel's
    shared-memory attribute set, and a raise where the card cannot hold one
    of its clusters at once."""
    key = (torch.cuda.current_device(), name, h, w, stride)
    if key in _plans:
        return
    smem, count = ctypes.c_int(), ctypes.c_int()
    err = lib.ccl_cluster_plan(_VARIANTS[name], h, w, stride or 1, ctypes.byref(smem),
                               ctypes.byref(count))
    _raise_on(err, lib, f"{name} cluster plan ({h}x{w})")
    if count.value < 1:
        raise RuntimeError(f"{name}: a cluster of {CLUSTER_CTAS} CTAs with {smem.value} "
                           f"shared bytes each cannot be resident")
    _plans.add(key)


def _barrier(dev: torch.device) -> Tensor:
    """The block body's team barrier words for the device and its current
    stream: cleared once; every launch leaves each team's arrivals at 0."""
    key = (dev.index, _stream(dev))
    bar = _barriers.get(key)
    if bar is None:
        bar = _barriers[key] = torch.zeros(2 * MAX_TEAMS, dtype=torch.int32, device=dev)
    return bar


def _block_args(lib, name: str, img: Tensor, stride: int | None,
                plan: BlockPlan | None = None):
    """The block body's launch arguments for the chunk ``img [N, H, W]``
    (tile geometry, team scratch, spilled workspaces, barrier words), from
    ``plan`` or else its plan on this card: the SMs found once per device
    and entry point (which also sets the kernel's shared-memory attribute).
    Also returns the buffers the arguments point into, to be held until the
    launch is queued."""
    N, h, w = img.shape
    key = (torch.cuda.current_device(), name)
    sms = _block_sms.get(key)
    if sms is None:
        count = ctypes.c_int()
        _raise_on(lib.ccl_block_plan(_VARIANTS[name], ctypes.byref(count)), lib,
                  f"{name} block plan")
        if not 1 <= count.value <= MAX_TEAMS:
            raise RuntimeError(f"{name}: the block body's CTA cannot be resident "
                               f"({count.value} SMs hold one)")
        sms = _block_sms[key] = count.value
    if plan is None:
        plan = block_plan(h, w, N, sms)
    words = block_scratch_words(h, w, plan, stride)
    scratch = torch.empty(plan.teams * words, dtype=torch.int32, device=img.device)
    work = (torch.empty(plan.work_words, dtype=torch.int32, device=img.device)
            if plan.spilled else None)
    return (plan.tile_rows, plan.tile_width, plan.teams, plan.ctas, scratch.data_ptr(), words,
            _ptr(work), plan.work_words, _barrier(img.device).data_ptr()), (scratch, work)


_NO_BLOCK_ARGS = (0, 0, 0, 0, None, 0, None, 0, None)


def _launch_label(fg, rounds, init, kind):
    N, h, w = fg.shape
    name = "label_components" if init is None else "label_components_seeded"
    lab = torch.empty(N, h * w, dtype=torch.int32, device=fg.device)
    lib = _lib()
    with torch.cuda.device(fg.device):
        if kind == "cluster":
            _plan_cluster(lib, name, h, w, None)
            block = _NO_BLOCK_ARGS
        else:
            block, _buffers = _block_args(lib, name, fg, None)
        fn = lib.ccl_label_launch if init is None else lib.ccl_label_seeded_launch
        err = fn(fg.data_ptr(), _ptr(init), lab.data_ptr(), N, h, w, rounds, *block,
                 int(kind == "cluster"), _stream(fg.device))
    _raise_on(err, lib, f"{name} ({kind} body)")
    LAUNCHES[f"{name}.{kind}"] += 1
    return lab


def _launch_threshold(img, radius, C, stride, rounds, closed_rounds, union, kind, plan=None):
    N, h, w = img.shape
    dev = img.device
    name = "threshold_label_union" if union else "threshold_label"
    r_ds = _window_radius(radius, stride) if stride > 1 else radius
    fg = torch.empty(N, h, w, dtype=torch.bool, device=dev)
    lab = torch.empty(N, h * w, dtype=torch.int32, device=dev)
    fg_c = torch.empty_like(fg) if union else None
    lab_c = torch.empty_like(lab) if union else None
    lib = _lib()
    with torch.cuda.device(dev):
        if kind == "cluster":
            _plan_cluster(lib, name, h, w, stride)
            block = _NO_BLOCK_ARGS
        else:
            block, _buffers = _block_args(lib, name, img, stride, plan)
        fn = lib.ccl_threshold_union_launch if union else lib.ccl_threshold_launch
        err = fn(
            img.data_ptr(), int(img.dtype == torch.uint8), fg.data_ptr(), lab.data_ptr(),
            _ptr(fg_c), _ptr(lab_c), N, h, w, stride, r_ds, float(C), rounds, closed_rounds,
            *block, int(kind == "cluster"), _stream(dev),
        )
    _raise_on(err, lib, f"{name} ({kind} body)")
    LAUNCHES[f"{name}.{kind}"] += 1
    return (fg, lab, fg_c, lab_c) if union else (fg, lab)
