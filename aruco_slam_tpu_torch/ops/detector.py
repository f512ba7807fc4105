"""ArUco marker detection (L2), frame-batched — counterpart of
``aruco_slam_tpu.ops.detector``, the replacement for OpenCV's
``cv::aruco::detectMarkers`` (reference src/aruco_slam.cpp:313).

A static-shape reformulation of OpenCV's contour pipeline, with a leading
frame axis on every stage (``[N, H, W]`` in, ``[N, K, ...]`` out):

1. **Adaptive threshold** — block-mean field, windowed, nearest-upsampled;
   ``img < mean - C``.
2. **Connected components** — min-label propagation: per round one
   8-neighbour min step and segmented min scans along rows and columns in
   both directions. The fused threshold/close/CCL stage is the CUDA kernel
   family in ``ops.kernels.ccl`` (K3-K5s).
3. **Candidates** — component sizes by one sort of subsampled root keys;
   the K largest per source, exact top-k with ties in ascending index
   order (``jax.lax.top_k``'s order).
4. **Quad corners** — a masked-argmax chain over each candidate's
   row-extreme points in a gathered label window.
5. **Subpixel refinement** and **decode** — saddle-point refine; a
   homography samples the 7x7 cell grid, the bits are matched against all
   rotations of DICT_ARUCO_ORIGINAL in one product (``ops.dictionary``).

No stage reads a tensor back to the host or makes a data-dependent shape.
Ties everywhere resolve to the first index, as in the JAX package:
``torch.sort(..., stable=True)`` replaces ``top_k``/``argsort``, and
``argmax`` takes int32, never bool.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.ops import dictionary, geometry, linalg

Tensor = torch.Tensor

# Stage boundaries of detect_markers_batch, for timing one call on the card:
# a caller sets STAGE_MARKS to a list, and each boundary then appends
# (the stage that just ended, a recorded CUDA event). None costs nothing.
STAGE_MARKS = None


def _mark(stage: str) -> None:
    if STAGE_MARKS is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        STAGE_MARKS.append((stage, event))


@dataclass(frozen=True)
class DetectorConfig:
    """The JAX package's ``DetectorConfig``, field for field (the JAX
    source documents each measurement behind a default). Two fields are
    kept only so that both configs convert into each other:
    ``use_pallas_ccl`` has no effect here (the CCL kernel is chosen by the
    tensor's device), and ``approx_topk`` neither (top-k is always exact;
    on the CPU the JAX package's approximate top-k is exact too)."""

    max_candidates: int = 16
    adaptive_radius: int = 7
    mean_stride: int = 4
    adaptive_radii: tuple = ()  # empty = single adaptive_radius
    adaptive_C: float = 7.0
    shape_buckets: tuple = ((480, 640), (720, 1280), (1080, 1920))
    ccl_rounds: int = 3
    use_pallas_ccl: bool | None = None
    min_component_pixels: int = 80
    max_component_fraction: float = 0.2
    stats_stride: int = 4
    approx_topk: bool = True
    corner_window: int = 96
    cell_samples: int = 2
    cell_margin: float = 0.0
    cell_vote: bool = False
    max_border_errors: int = 8
    max_correction: int = 1
    min_corner_separation: float = 4.0
    min_contrast: float = 25.0
    subpix_refine: bool = True
    subpix_window: int = 4
    subpix_iters: int = 3
    subpix_window_small: int = 2
    subpix_small_extent: float = 40.0
    closing_union: bool = True
    closing_dedup_px: float = 2.0
    second_chance: bool = True
    retry_cell_samples: int = 4
    retry_cell_vote: bool = True
    retry_budget: int = 4
    closed_budget: int = 8
    closed_ccl_rounds: int = 2


class Detections(NamedTuple):
    ids: Tensor  # [N, K] int32 (-1 invalid)
    corners: Tensor  # [N, K, 4, 2] pixel coords, corner 0 = pattern top-left
    valid: Tensor  # [N, K] bool


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[n, idx[n, k], ...]`` along dim 1 (per-frame gather)."""
    shaped = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, shaped.expand(*idx.shape, *x.shape[2:]))


def _shift2d(x: Tensor, dy: int, dx: int, fill) -> Tensor:
    """``out[..., y, x] = x[..., y - dy, x - dx]``, ``fill`` where that
    falls outside (``jnp.roll`` with the wrapped edge overwritten)."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)] = (
        x[..., max(-dy, 0): h - max(dy, 0), max(-dx, 0): w - max(dx, 0)]
    )
    return out


# ---------------------------------------------------------------------------
# Stage 1: adaptive threshold
# ---------------------------------------------------------------------------


def _window_mean(grid: Tensor, r: int) -> Tensor:
    """Mean over a (2r+1)^2 window clamped to the edge, summed column
    direction first, then rows, each in index order. For an integer-valued
    image every partial sum is exact in float32, so any order gives these
    bits; the one division is IEEE."""
    _, a, b = grid.shape
    win = 2 * r + 1
    dev = grid.device
    iy = torch.clamp(torch.arange(-r, a + r, device=dev), 0, a - 1)
    ix = torch.clamp(torch.arange(-r, b + r, device=dev), 0, b - 1)
    g = grid[:, iy]
    acc = g[:, 0:a]
    for k in range(1, win):
        acc = acc + g[:, k: k + a]
    g = acc[:, :, ix]
    acc = g[:, :, 0:b]
    for k in range(1, win):
        acc = acc + g[:, :, k: k + b]
    return acc / float(win * win)


def adaptive_threshold(img: Tensor, radius: int, C: float, mean_stride: int = 1) -> Tensor:
    """Foreground (dark) mask ``[N, H, W]``: img < window_mean - C, OpenCV's
    ADAPTIVE_THRESH_MEAN_C + THRESH_BINARY_INV with edge-replicated borders.

    With ``mean_stride`` s > 1 dividing H and W, the mean is taken over an
    s x s block-mean grid with window radius ``max(1, round(radius / s))``
    and nearest-upsampled; otherwise at full resolution with ``radius``.
    Block sums run over rows within each column of the block, then across
    columns; the block mean is sum / s^2 (the JAX package's ``mean``, equal
    to the kernel's sum * (1 / s^2) for a power-of-two s)."""
    x = img.to(torch.float32)
    N, h, w = x.shape
    s = mean_stride
    if s > 1 and h % s == 0 and w % s == 0:
        blk = x.reshape(N, h // s, s, w // s, s)
        t = blk[:, :, 0]
        for k in range(1, s):
            t = t + blk[:, :, k]
        b = t[..., 0]
        for k in range(1, s):
            b = b + t[..., k]
        mean = _window_mean(b / float(s * s), max(1, round(radius / s)))
        mean = mean.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
    else:
        mean = _window_mean(x, radius)
    return x < (mean - C)


# ---------------------------------------------------------------------------
# Stage 2: connected-component labelling
# ---------------------------------------------------------------------------


def _shift1(x: Tensor, d: int, dim: int, fill) -> Tensor:
    return _shift2d(x, d, 0, fill) if dim == 1 else _shift2d(x, 0, d, fill)


def _seg_min_scan(lab: Tensor, fg: Tensor, big: int, dim: int, reverse: bool) -> Tensor:
    """Segmented inclusive min-scan along ``dim`` (1 = down the rows, 2 =
    along a row); background pixels are segment boundaries. Hillis-Steele
    doubling over shifted tensors, as the Pallas kernel does: integer min,
    so bit-identical to any other scan order."""
    v = torch.where(fg, lab, big)
    f = ~fg
    extent = lab.shape[dim]
    s = 1
    while s < extent:
        d = -s if reverse else s
        vs = _shift1(v, d, dim, big)
        fs = _shift1(f, d, dim, True)
        v = torch.where(f, v, torch.minimum(v, vs))
        f = f | fs
        s *= 2
    return torch.where(fg, torch.minimum(lab, v), lab)


def _neighbor_min(lab: Tensor, fg: Tensor, big: int) -> Tensor:
    """One Jacobi 8-neighbour min step over foreground pixels."""
    lab_m = torch.where(fg, lab, big)
    best = lab_m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(best, _shift2d(lab_m, dy, dx, big))
    return torch.where(fg, torch.minimum(lab, best), lab)


def label_components(fg: Tensor, rounds: int, init: Tensor | None = None) -> Tensor:
    """8-connected CCL of ``fg [N, H, W]`` by min-label propagation with
    run-scan acceleration; ``rounds`` of (neighbour min, row scans both
    ways, column scans both ways). ``init [N, H, W]`` int32 seeds the
    foreground (the closing-union's closed pass starts from the raw
    labels). Returns flat labels ``[N, H*W]`` int32; a foreground pixel's
    label converges to the least flat index of its component, and
    background keeps its own index."""
    N, h, w = fg.shape
    n = h * w
    idx = torch.arange(n, dtype=torch.int32, device=fg.device).reshape(1, h, w).expand(N, h, w)
    lab = idx
    if init is not None:
        lab = torch.where(fg, torch.minimum(init.reshape(N, h, w), idx), idx)
    for _ in range(rounds):
        lab = _neighbor_min(lab, fg, n)
        lab = _seg_min_scan(lab, fg, n, dim=2, reverse=False)
        lab = _seg_min_scan(lab, fg, n, dim=2, reverse=True)
        lab = _seg_min_scan(lab, fg, n, dim=1, reverse=False)
        lab = _seg_min_scan(lab, fg, n, dim=1, reverse=True)
    return lab.reshape(N, n)


def binary_close3(fg: Tensor) -> Tensor:
    """3x3 binary closing of ``fg [N, H, W]``: out-of-image reads as
    background for the dilation and as foreground for the erosion."""
    dil = fg
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                dil = dil | _shift2d(fg, dy, dx, False)
    ero = dil
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                ero = ero & _shift2d(dil, dy, dx, True)
    return ero


# ---------------------------------------------------------------------------
# Stage 3 + 4: candidates and quad corners
# ---------------------------------------------------------------------------


def _masked_argmax(score: Tensor, mask: Tensor) -> Tensor:
    """First index of the max over the last dim; an all-masked row gives 0."""
    return torch.argmax(torch.where(mask, score, -torch.inf), dim=-1)


def _component_stats_multi(labels_list, fg_list, cfg: DetectorConfig):
    """Component stats over one or more label images of one shape (the
    closing-union's raw and closed pair share one sort): the
    ``stats_stride``-subsampled root keys of source s are offset by
    ``s * H*W``, sorted once, and segment counts come from a cummax of the
    segment starts. Selection then runs per source, so each keeps its own
    budget. Returns a list of (roots [N, K], bbox [N, K, 4] (x0, x1, y0,
    y1), cand_valid [N, K], count_ds [N, K] float32) per source."""
    N, h, w = fg_list[0].shape
    n = h * w
    st = cfg.stats_stride
    S = len(labels_list)
    dev = fg_list[0].device
    cells = [l.reshape(N, h, w)[:, ::st, ::st].reshape(N, -1) for l in labels_list]
    fgs = [f[:, ::st, ::st].reshape(N, -1) for f in fg_list]
    hs, ws = fg_list[0][0, ::st, ::st].shape
    m = hs * ws
    big = S * n
    key = torch.cat([torch.where(fgs[s], cells[s] + s * n, big) for s in range(S)], dim=1)
    sk = torch.sort(key, dim=1).values
    pos = torch.arange(S * m, dtype=torch.int32, device=dev)
    neq = sk[:, 1:] != sk[:, :-1]
    edge = torch.ones(N, 1, dtype=torch.bool, device=dev)
    is_start = torch.cat([edge, neq], dim=1)
    is_end = torch.cat([neq, edge], dim=1)
    start_pos = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    counts_end = pos - start_pos + 1

    # the subsampled count is ~count / st^2: gate at half of that here and
    # apply the exact size filter per candidate in quads_from_candidates
    min_ds = max(1, cfg.min_component_pixels // (st * st) // 2)
    max_ds = int(cfg.max_component_fraction * (n // (st * st)))
    ok = is_end & (sk < big) & (counts_end >= min_ds) & (counts_end <= max_ds)

    px_y = (torch.arange(hs, dtype=torch.int32, device=dev) * st)[:, None].expand(hs, ws).reshape(-1)
    px_x = (torch.arange(ws, dtype=torch.int32, device=dev) * st)[None, :].expand(hs, ws).reshape(-1)
    K = cfg.max_candidates
    out = []
    for s in range(S):
        ok_s = ok & (sk >= s * n) & (sk < (s + 1) * n) if S > 1 else ok
        score = torch.where(ok_s, counts_end, 0)
        # exact top-k, equal scores in ascending index order (lax.top_k's)
        svals, idx_k = torch.sort(score, dim=1, descending=True, stable=True)
        svals, idx_k = svals[:, :K], idx_k[:, :K]
        cand_valid = svals > 0
        roots = (torch.gather(sk, 1, idx_k) - s * n).to(torch.int32)  # segment key is the root
        roots = torch.where(cand_valid, roots, n)  # an empty slot must not alias a root

        # per-candidate bbox over the source's subsampled grid: [N, K, m]
        sel = (cells[s][:, None, :] == roots[:, :, None]) & fgs[s][:, None, :]
        bb_minx = torch.where(sel, px_x, n).amin(dim=-1)
        bb_maxx = torch.where(sel, px_x, -1).amax(dim=-1)
        bb_miny = torch.where(sel, px_y, n).amin(dim=-1)
        bb_maxy = torch.where(sel, px_y, -1).amax(dim=-1)
        # subsampling can miss an extreme by up to st - 1 px
        bbox = torch.stack([
            torch.clamp(bb_minx - (st - 1), min=0),
            torch.clamp(bb_maxx + (st - 1), max=w - 1),
            torch.clamp(bb_miny - (st - 1), min=0),
            torch.clamp(bb_maxy + (st - 1), max=h - 1),
        ], dim=-1).to(torch.int32)
        out.append((roots, bbox, cand_valid, svals.to(torch.float32)))
    return out


def component_candidates(labels: Tensor, fg: Tensor, cfg: DetectorConfig):
    """Top-K components by subsampled size: (roots [N, K] int32 flat root
    index, bbox [N, K, 4] int32, cand_valid [N, K], count_ds [N, K])."""
    return _component_stats_multi([labels], [fg], cfg)[0]


def quads_from_candidates(labels2d: Tensor, roots: Tensor, bbox: Tensor, cand_valid: Tensor,
                          cfg: DetectorConfig, src: Tensor | None = None):
    """Corner chain over prepared candidates. ``labels2d`` is
    ``[N, H, W]``, or ``[N, S, H, W]`` with ``src [N, K]`` naming each
    candidate's source image. Each candidate reads a ``corner_window``^2
    label window (strided when the component is larger) by one gather;
    the chain then runs on the 2W row-extreme points, where every
    maximiser of the chain's objectives lies. Returns (corners
    [N, K, 4, 2] float32, cand_valid [N, K] after the exact size filter)."""
    if src is None:
        N, h, w = labels2d.shape
        row_base = torch.zeros_like(roots, dtype=torch.int64)
    else:
        N, _, h, w = labels2d.shape
        row_base = src.to(torch.int64) * h
    flat = labels2d.reshape(N, -1)
    n = h * w
    W = cfg.corner_window
    dev = roots.device
    span = torch.arange(W, dtype=torch.int32, device=dev)
    x0, x1, y0, y1 = bbox.unbind(-1)
    extent = torch.maximum(x1 - x0, y1 - y0) + 1
    stride = torch.clamp(torch.div(extent + W - 1, W, rounding_mode="floor"), min=1)
    wy = torch.clamp(y0[..., None] + stride[..., None] * span, 0, h - 1)  # [N, K, W]
    wx = torch.clamp(x0[..., None] + stride[..., None] * span, 0, w - 1)
    # the [W, W] window gathered directly: the same elements the JAX
    # package's row-then-lane take reads, without its [W, w] row slab
    gidx = ((row_base[..., None] + wy)[..., :, None] * w + wx[..., None, :]).reshape(N, -1)
    lab_w = torch.gather(flat, 1, gidx).reshape(*roots.shape, W, W)
    # background keeps its own flat index and a root is a foreground pixel,
    # so equality alone identifies the component
    mask2d = lab_w == roots[..., None, None]
    npix = torch.clamp(mask2d.sum(dim=(-1, -2)).to(torch.float32), min=1.0)
    mi = mask2d.to(torch.int32)
    first = torch.argmax(mi, dim=-1)  # first foreground lane per row
    last = W - 1 - torch.argmax(mi.flip(-1), dim=-1)
    row_any = mask2d.any(dim=-1)
    wxf, wyf = wx.to(torch.float32), wy.to(torch.float32)
    xl = torch.gather(wxf, -1, first)
    xr = torch.gather(wxf, -1, last)
    px = torch.cat([xl, xr], dim=-1)  # [N, K, 2W]
    py = torch.cat([wyf, wyf], dim=-1)
    mask = torch.cat([row_any, row_any], dim=-1)
    cnt = torch.where(row_any, (last - first + 1).to(torch.float32), 0.0)
    tot = torch.clamp(cnt.sum(-1), min=1.0)
    cx = (0.5 * (xl + xr) * cnt).sum(-1) / tot
    cy = (wyf * cnt).sum(-1) / tot

    def point(i):
        return torch.stack([torch.gather(px, -1, i[..., None])[..., 0],
                            torch.gather(py, -1, i[..., None])[..., 0]], dim=-1)

    def sq(v):
        return v * v

    # 1. three hull corners: farthest from the centroid (p0), farthest from
    #    p0 (p2), largest |cross| off the p0-p2 chord (p1)
    i0 = _masked_argmax(sq(px - cx[..., None]) + sq(py - cy[..., None]), mask)
    p0 = point(i0)
    i2 = _masked_argmax(sq(px - p0[..., 0:1]) + sq(py - p0[..., 1:2]), mask)
    p2 = point(i2)
    ex, ey = p2[..., 0:1] - p0[..., 0:1], p2[..., 1:2] - p0[..., 1:2]
    cross02 = ex * (py - p0[..., 1:2]) - ey * (px - p0[..., 0:1])
    p1 = point(_masked_argmax(torch.abs(cross02), mask))

    # 2. the diagonal is the chord with extent on both sides; the 4th
    #    corner is the extreme point opposite the remaining known corner
    def chord_stats(a, b, other):
        d = b - a
        norm = torch.sqrt(sq(d[..., 0]) + sq(d[..., 1])) + 1e-9
        cr = (d[..., 0:1] * (py - a[..., 1:2]) - d[..., 1:2] * (px - a[..., 0:1])) / norm[..., None]
        mpos = torch.where(mask, cr, -torch.inf).amax(dim=-1)
        mneg = torch.where(mask, -cr, -torch.inf).amax(dim=-1)
        score = torch.minimum(mpos, mneg)
        side_other = d[..., 0] * (other[..., 1] - a[..., 1]) - d[..., 1] * (other[..., 0] - a[..., 0])
        p4 = point(_masked_argmax(-torch.sign(side_other)[..., None] * cr, mask))
        return score, torch.stack([a, other, b, p4], dim=-2)

    s_a, quad_a = chord_stats(p0, p2, p1)
    s_b, quad_b = chord_stats(p0, p1, p2)
    s_c, quad_c = chord_stats(p1, p2, p0)
    quads3 = torch.stack([quad_a, quad_b, quad_c], dim=-3)  # [N, K, 3, 4, 2]
    best = torch.argmax(torch.stack([s_a, s_b, s_c], dim=-1), dim=-1)
    quad = torch.gather(
        quads3, -3, best[..., None, None, None].expand(*best.shape, 1, 4, 2)
    )[..., 0, :, :]  # [A, Y, B, W]: diagonal ends at 0 and 2
    # winding: positive shoelace area in image coordinates, or the mirrored
    # order decodes to a wrong-but-valid id (the dictionary is closed under
    # vertical flips); for [A, Y, B, W] the sign is cross(B - A, W - Y)
    dd = quad[..., 2, :] - quad[..., 0, :]
    ww = quad[..., 3, :] - quad[..., 1, :]
    flip = ((dd[..., 0] * ww[..., 1] - dd[..., 1] * ww[..., 0]) < 0)[..., None]
    corners = torch.stack([
        quad[..., 0, :], torch.where(flip, quad[..., 3, :], quad[..., 1, :]),
        quad[..., 2, :], torch.where(flip, quad[..., 1, :], quad[..., 3, :]),
    ], dim=-2)
    # exact size filter: the window covers the whole component
    size_est = npix * (stride * stride).to(torch.float32)
    cand_valid = (
        cand_valid
        & (size_est >= cfg.min_component_pixels)
        & (size_est <= cfg.max_component_fraction * n)
    )
    return corners, cand_valid


def extract_quads(labels: Tensor, fg: Tensor, cfg: DetectorConfig):
    """Top-K components by size -> 4 corner points each: (corners
    [N, K, 4, 2] float32, cand_valid [N, K])."""
    roots, bbox, cand_valid, _ = component_candidates(labels, fg, cfg)
    return quads_from_candidates(labels.reshape(fg.shape), roots, bbox, cand_valid, cfg)


# ---------------------------------------------------------------------------
# Stage 5: decode
# ---------------------------------------------------------------------------


def _bilinear(img: Tensor, pts: Tensor) -> Tensor:
    """Bilinear samples of ``img [N, H, W]`` at ``pts [N, ..., 2]`` (x, y),
    coordinates clamped to [0, size - 1.001] as in the JAX package. The
    integer indices are clamped once more so that a NaN point reads pixel
    (0, 0) on any device instead of faulting; its sample stays NaN."""
    N, h, w = img.shape
    x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
    xf, yf = torch.floor(x), torch.floor(y)
    fx, fy = x - xf, y - yf
    x0 = torch.clamp(xf.to(torch.int64), 0, w - 2)
    y0 = torch.clamp(yf.to(torch.int64), 0, h - 2)
    flat = img.reshape(N, -1).to(torch.float32)
    base = (y0 * w + x0).reshape(N, -1)

    def at(off):
        return torch.gather(flat, 1, base + off).reshape(x.shape)

    return (
        at(0) * (1 - fx) * (1 - fy)
        + at(1) * fx * (1 - fy)
        + at(w) * (1 - fx) * fy
        + at(w + 1) * fx * fy
    )


_BORDER_MASK_NP = np.ones((7, 7), bool)
_BORDER_MASK_NP[1:6, 1:6] = False


def decode_candidates(img: Tensor, corners: Tensor, cfg: DetectorConfig):
    """Sample and binarise the 7x7 cell grid of each quad ``[N, K, 4, 2]``
    and match it against the dictionary. Returns (ids, corners rolled so
    corner 0 is the pattern's top-left, contrast, border_err, dict_valid)."""
    dev = corners.device
    s = cfg.cell_samples
    m = cfg.cell_margin
    offs = m + (1.0 - 2.0 * m) * (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    cell = torch.arange(7, dtype=torch.float32, device=dev)
    gx = (cell[None, :, None, None] + offs[None, None, None, :]).expand(7, 7, s, s).reshape(-1)
    gy = (cell[:, None, None, None] + offs[None, None, :, None]).expand(7, 7, s, s).reshape(-1)
    grid = torch.stack([gx, gy], dim=-1)  # [49 s^2, 2] canonical (col, row)
    # closed-form unit-square homography composed with the 1/7 scale
    Hu = linalg.homography_unit_square(corners)
    scale = torch.tensor([[1.0 / 7.0, 0.0, 0.0], [0.0, 1.0 / 7.0, 0.0], [0.0, 0.0, 1.0]],
                         dtype=corners.dtype, device=dev)
    px = geometry.apply_homography(Hu @ scale, grid)  # [N, K, G, 2]
    vals = _bilinear(img, px).reshape(*corners.shape[:2], 7, 7, s * s)
    cells = vals.mean(dim=-1)
    lo = cells.amin(dim=(-1, -2))
    hi = cells.amax(dim=(-1, -2))
    thresh = (0.5 * (lo + hi))[..., None, None]
    if cfg.cell_vote:
        votes = (vals > thresh[..., None]).to(torch.float32).mean(dim=-1)
        bits = (votes > 0.5).to(torch.float32)
    else:
        bits = (cells > thresh).to(torch.float32)
    border = torch.as_tensor(_BORDER_MASK_NP, device=dev)
    border_err = torch.where(border, bits, 0.0).sum(dim=(-1, -2))
    mid, rot, _, ok = dictionary.match_bits(bits[..., 1:6, 1:6], cfg.max_correction)
    # extracted = rot90(pattern, rot), so the canonical order is roll(corners, rot)
    ridx = (torch.arange(4, device=dev) - rot[..., None].to(torch.int64)) % 4
    rolled = torch.gather(corners, -2, ridx[..., None].expand(*ridx.shape, 2))
    return mid, rolled, hi - lo, border_err, ok


def refine_corners_subpix(img: Tensor, corners: Tensor, window: int = 4, iters: int = 3,
                          window_small: int | None = None, small: Tensor | None = None) -> Tensor:
    """Gradient saddle-point refinement (cv::cornerSubPix's solve) of
    ``corners [N, K, 4, 2]`` on ``img [N, H, W]``: q = (sum g g^T)^-1
    sum (g g^T p) over a Gaussian-weighted window, ``iters`` times, each
    move clamped to the window. Every sample shares the corner's
    fractional offset, so one edge-padded (2w+4)^2 patch per corner gives
    every bilinear field as four shifted slices. ``window_small`` with
    ``small [N, K]``: those candidates' corners use the small window's
    weights (zero outside it) and move clamp, in the same pass."""
    N, h, w = img.shape
    dev = img.device
    pad = window + 2
    x = torch.nn.functional.pad(img.to(torch.float32)[:, None], (pad,) * 4, mode="replicate")[:, 0]
    Hp, Wp = x.shape[-2:]
    offs = torch.arange(-window, window + 1, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")  # [S, S]
    wgt = torch.exp(-(gx * gx + gy * gy) / (window ** 2))
    S = 2 * window + 1
    P = 2 * window + 4  # patch covers offsets [-window-1, window+2]
    flat = corners.reshape(N, -1, 2)
    Cn = flat.shape[1]
    if window_small is not None and small is not None:
        inside = (gx.abs() <= window_small) & (gy.abs() <= window_small)
        wgt_small = torch.where(inside, torch.exp(-(gx * gx + gy * gy) / (window_small ** 2)), 0.0)
        small_c = small.repeat_interleave(4, dim=1)  # per corner
        wgts = torch.where(small_c[..., None, None], wgt_small, wgt)  # [N, C, S, S]
        clamp_w = torch.where(small_c, float(window_small), float(window))
    else:
        wgts = wgt.expand(N, Cn, S, S)
        clamp_w = torch.full((N, Cn), float(window), device=dev)
    span = torch.arange(P, device=dev)
    xflat = x.reshape(N, -1)
    q = flat
    for _ in range(iters):
        qc = torch.stack([torch.clamp(q[..., 0], 0.0, w - 1.001),
                          torch.clamp(q[..., 1], 0.0, h - 1.001)], dim=-1)
        base = torch.floor(qc)
        fx = (qc[..., 0] - base[..., 0])[..., None, None]
        fy = (qc[..., 1] - base[..., 1])[..., None, None]
        # the patch starts at base + pad - window - 1, clamped into the padded
        # image as lax.dynamic_slice clamps it (a NaN corner reads row/col 0)
        ys = torch.clamp(base[..., 1].to(torch.int64) + pad - window - 1, 0, Hp - P)
        xs = torch.clamp(base[..., 0].to(torch.int64) + pad - window - 1, 0, Wp - P)
        pidx = ((ys[..., None] + span)[..., :, None] * Wp + (xs[..., None] + span)[..., None, :])
        patch = torch.gather(xflat, 1, pidx.reshape(N, -1)).reshape(N, Cn, P, P)

        def field(ey, ex):
            a0y, a0x = ey + 1, ex + 1  # grid offset -window maps to +1

            def sl(ay, ax):
                return patch[..., ay: ay + S, ax: ax + S]

            return (
                (1 - fy) * (1 - fx) * sl(a0y, a0x)
                + (1 - fy) * fx * sl(a0y, a0x + 1)
                + fy * (1 - fx) * sl(a0y + 1, a0x)
                + fy * fx * sl(a0y + 1, a0x + 1)
            )

        dx = 0.5 * (field(0, 1) - field(0, -1))
        dy = 0.5 * (field(1, 0) - field(-1, 0))
        px = qc[..., 0, None, None] + gx
        py = qc[..., 1, None, None] + gy
        gxx = (wgts * dx * dx).sum(dim=(-1, -2))
        gxy = (wgts * dx * dy).sum(dim=(-1, -2))
        gyy = (wgts * dy * dy).sum(dim=(-1, -2))
        bx = (wgts * (dx * dx * px + dx * dy * py)).sum(dim=(-1, -2))
        by = (wgts * (dx * dy * px + dy * dy * py)).sum(dim=(-1, -2))
        det = gxx * gyy - gxy * gxy
        ok = det.abs() > 1e-9
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        q_new = torch.stack([(gyy * bx - gxy * by) * inv_det,
                             (gxx * by - gxy * bx) * inv_det], dim=-1)
        delta = torch.clamp(q_new - qc, -clamp_w[..., None], clamp_w[..., None])
        q = torch.where(ok[..., None], qc + delta, q)
    return q.reshape(corners.shape)


# ---------------------------------------------------------------------------
# Thresholding + labelling: the kernel family or its plain versions
# ---------------------------------------------------------------------------


def _threshold_and_label(img: Tensor, radius: int, cfg: DetectorConfig, reference: bool = False):
    """(fg [N, H, W], labels [N, H*W]): K4 where the fused threshold
    applies (power-of-two stride dividing H and W), else the plain
    threshold and K5. ``reference`` takes the plain versions throughout."""
    from aruco_slam_tpu_torch.ops.kernels import ccl

    _, h, w = img.shape
    stride = max(cfg.mean_stride, 1)
    if ccl.fused_threshold_ok(h, w, stride):
        fn = ccl.threshold_label_reference if reference else ccl.threshold_label
        return fn(img, radius, cfg.adaptive_C, stride, cfg.ccl_rounds)
    fg = adaptive_threshold(img, radius, cfg.adaptive_C, cfg.mean_stride)
    lab_fn = ccl.label_components_reference if reference else ccl.label_components
    return fg, lab_fn(fg, cfg.ccl_rounds)


def _union_masks_and_labels(img: Tensor, radius: int, cfg: DetectorConfig,
                            reference: bool = False):
    """(fg, labels, fg_closed, labels_closed) for the closing-union source:
    K3 in one launch where the fused threshold applies, else the plain
    threshold, K5, the plain close and K5s (seeded with the raw labels).
    Bit-identical either way."""
    from aruco_slam_tpu_torch.ops.kernels import ccl

    _, h, w = img.shape
    stride = max(cfg.mean_stride, 1)
    if ccl.fused_threshold_ok(h, w, stride):
        fn = ccl.threshold_label_union_reference if reference else ccl.threshold_label_union
        return fn(img, radius, cfg.adaptive_C, stride, cfg.ccl_rounds, cfg.closed_ccl_rounds)
    lab_fn = ccl.label_components_reference if reference else ccl.label_components
    fg = adaptive_threshold(img, radius, cfg.adaptive_C, cfg.mean_stride)
    labels = lab_fn(fg, cfg.ccl_rounds)
    fg_c = binary_close3(fg)
    labels_c = lab_fn(fg_c, cfg.closed_ccl_rounds, init=labels.reshape(fg.shape))
    return fg, labels, fg_c, labels_c


def _candidates_at_radius(img: Tensor, radius: int, cfg: DetectorConfig, reference: bool = False):
    """Candidate quads at one threshold radius: the raw-foreground CCL and,
    with ``closing_union``, the closed-foreground one. Returns (raw_quads,
    raw_valid, closed_quads, closed_valid); the closed pair is None without
    ``closing_union``."""
    if not cfg.closing_union:
        fg, labels = _threshold_and_label(img, radius, cfg, reference)
        _mark("ccl")
        roots, bbox, cand_valid, _ = component_candidates(labels, fg, cfg)
        _mark("stats")
        q, v = quads_from_candidates(labels.reshape(fg.shape), roots, bbox, cand_valid, cfg)
        _mark("chain")
        return q, v, None, None
    fg, labels, fg_c, labels_c = _union_masks_and_labels(img, radius, cfg, reference)
    _mark("ccl")
    (r_roots, r_bbox, r_valid, r_sv), (c_roots, c_bbox, c_valid, c_sv) = (
        _component_stats_multi([labels, labels_c], [fg, fg_c], cfg)
    )
    if cfg.closed_budget and cfg.closed_budget < c_roots.shape[1]:
        # stats-level pre-dedup: a closed candidate whose bbox matches a
        # valid raw one within the subsample quantisation and whose count is
        # within 15% is the same component; survivors keep their size order
        st = cfg.stats_stride
        bb_near = (c_bbox[:, :, None, :] - r_bbox[:, None, :, :]).abs().amax(dim=-1) <= 2 * st
        cnt_near = (c_sv[:, :, None] <= r_sv[:, None, :] * 1.15 + 2.0) & (
            c_sv[:, :, None] >= r_sv[:, None, :] * 0.85 - 2.0
        )
        dup = (bb_near & cnt_near & r_valid[:, None, :]).any(dim=-1)
        c_keep = c_valid & ~dup
        order = torch.sort(torch.where(c_keep, -c_sv, torch.inf), dim=1, stable=True).indices
        order = order[:, : cfg.closed_budget]
        c_roots, c_bbox, c_valid = _take(c_roots, order), _take(c_bbox, order), _take(c_keep, order)
    _mark("stats")
    k = r_roots.shape[1]
    q, v = quads_from_candidates(
        torch.stack([labels.reshape(fg.shape), labels_c.reshape(fg.shape)], dim=1),
        torch.cat([r_roots, c_roots], dim=1),
        torch.cat([r_bbox, c_bbox], dim=1),
        torch.cat([r_valid, c_valid], dim=1),
        cfg,
        src=torch.cat([torch.zeros_like(r_roots), torch.ones_like(c_roots)], dim=1),
    )
    _mark("chain")
    return q[:, :k], v[:, :k], q[:, k:], v[:, k:]


def to_grayscale(img: Tensor, channel_order: str = "bgr") -> Tensor:
    """Colour ``[..., H, W, 3]`` -> luma ``[..., H, W]`` with OpenCV's
    BGR2GRAY weights (Y = 0.299 R + 0.587 G + 0.114 B); integer input is
    rounded half-to-even and keeps its dtype."""
    if channel_order not in ("bgr", "rgb"):
        raise ValueError(f"channel_order must be 'bgr' or 'rgb', got {channel_order!r}")
    wts = (0.114, 0.587, 0.299) if channel_order == "bgr" else (0.299, 0.587, 0.114)
    w = torch.tensor(wts, dtype=torch.float32, device=img.device)
    y = torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))
    if not img.dtype.is_floating_point:
        return torch.round(y).to(img.dtype)
    return y.to(img.dtype)


def detect_markers_batch(images: Tensor, cfg: DetectorConfig = DetectorConfig(),
                         reference: bool = False) -> Detections:
    """Detection for a batch of frames: grayscale ``[N, H, W]`` (uint8 or
    float) or colour ``[N, H, W, 3]`` (BGR). The CCL stage runs the kernel
    family for CUDA tensors, its plain versions for CPU tensors, or its
    plain versions anywhere with ``reference``."""
    img = images
    if img.dim() == 4 and img.shape[-1] == 3:
        img = to_grayscale(img)
    radii = cfg.adaptive_radii or (cfg.adaptive_radius,)
    _mark("start")
    raw_q, raw_v, clo_q, clo_v = [], [], [], []
    for r in radii:
        q, v, q2, v2 = _candidates_at_radius(img, r, cfg, reference)
        raw_q.append(q)
        raw_v.append(v)
        if q2 is not None:
            clo_q.append(q2)
            clo_v.append(v2)
    quads = torch.cat(raw_q, dim=1)
    cand_valid = torch.cat(raw_v, dim=1)
    if clo_q:
        # closed-source candidates within closing_dedup_px (max corner
        # distance, corner for corner) of an exact-valid raw candidate are
        # the same component; the union keeps the raw slot budget
        cq = torch.cat(clo_q, dim=1)
        cv = torch.cat(clo_v, dim=1)
        diff = cq[:, :, None] - quads[:, None]  # [N, Kc, Kr, 4, 2]
        d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]).amax(dim=-1)
        near_raw = ((d < cfg.closing_dedup_px) & cand_valid[:, None, :]).any(dim=-1)
        cv = cv & ~near_raw
        k_out = quads.shape[1]
        all_q = torch.cat([quads, cq], dim=1)
        all_v = torch.cat([cand_valid, cv], dim=1)
        # valid first, stable: raw candidates keep priority
        order = torch.sort((~all_v).to(torch.uint8), dim=1, stable=True).indices[:, :k_out]
        quads = _take(all_q, order)
        cand_valid = _take(all_v, order)
        _mark("union")
    if cfg.subpix_refine:
        if cfg.subpix_window_small < cfg.subpix_window:
            extent = (quads.amax(dim=2) - quads.amin(dim=2)).amax(dim=-1)  # [N, K]
            quads = refine_corners_subpix(
                img, quads, window=cfg.subpix_window, iters=cfg.subpix_iters,
                window_small=cfg.subpix_window_small, small=extent < cfg.subpix_small_extent,
            )
        else:
            quads = refine_corners_subpix(img, quads, window=cfg.subpix_window,
                                          iters=cfg.subpix_iters)
    _mark("subpix")
    mids, corners, contrast, border_errs, dict_ok = decode_candidates(img, quads, cfg)
    if cfg.second_chance:
        # denser sampling + per-sample vote for the pass-1 misses among
        # quad-valid candidates, compacted to retry_budget slots; pass-1
        # winners keep their results bit for bit
        retry_cfg = replace(cfg, cell_samples=cfg.retry_cell_samples,
                            cell_vote=cfg.retry_cell_vote)
        miss1 = ~(dict_ok & (border_errs <= cfg.max_border_errors))
        eligible = cand_valid & miss1
        r_budget = min(cfg.retry_budget, quads.shape[1])
        sel = torch.sort((~eligible).to(torch.uint8), dim=1, stable=True).indices[:, :r_budget]
        mids2, corners2, contrast2, border2, ok2 = decode_candidates(img, _take(quads, sel),
                                                                     retry_cfg)
        use2 = _take(eligible, sel)

        def put(x, new):
            upd = torch.where(use2.reshape(*use2.shape, *([1] * (x.dim() - 2))), new, _take(x, sel))
            shaped = sel.reshape(*sel.shape, *([1] * (x.dim() - 2))).expand_as(upd)
            return x.scatter(1, shaped, upd)

        mids = put(mids, mids2)
        corners = put(corners, corners2)
        contrast = put(contrast, contrast2)
        border_errs = put(border_errs, border2)
        dict_ok = put(dict_ok, ok2)
    _mark("decode")

    # corner sanity: every pairwise separation above the threshold
    diffs = corners[..., :, None, :] - corners[..., None, :, :]  # [N, K, 4, 4, 2]
    d2 = diffs[..., 0] * diffs[..., 0] + diffs[..., 1] * diffs[..., 1]
    eye = torch.eye(4, dtype=torch.bool, device=corners.device)
    min_sep = torch.where(eye, torch.inf, d2).amin(dim=(-1, -2))
    sep_ok = min_sep >= cfg.min_corner_separation ** 2

    valid = (
        cand_valid & dict_ok & (border_errs <= cfg.max_border_errors) & sep_ok
        & (contrast >= cfg.min_contrast)
    )
    # dedup by id: keep the earliest valid slot per id
    same_id = (mids[:, :, None] == mids[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    K = mids.shape[1]
    earlier = torch.tril(torch.ones(K, K, dtype=torch.bool, device=mids.device), diagonal=-1)
    valid = valid & ~(same_id & earlier).any(dim=-1)
    ids = torch.where(valid, mids, -1)
    _mark("dedup")
    return Detections(ids=ids, corners=corners, valid=valid)


def detect_markers(img: Tensor, cfg: DetectorConfig = DetectorConfig(),
                   reference: bool = False) -> Detections:
    """Detection for one frame, grayscale ``[H, W]`` or colour ``[H, W, 3]``
    (BGR): :func:`detect_markers_batch` on a batch of one, unbatched."""
    det = detect_markers_batch(img[None], cfg, reference)
    return Detections(det.ids[0], det.corners[0], det.valid[0])
