"""Small fixed-size linear algebra, unrolled (L0) — counterparts of
``aruco_slam_tpu.ops.linalg``. Batched over leading dims. The closed forms
are kept (not ``torch.linalg``) so the plain path computes what the
kernels compute, term for term."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def inv3x3(A: Tensor) -> Tensor:
    """Closed-form 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    row0 = torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1)
    row1 = torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1)
    row2 = torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def cholesky_unrolled(A: Tensor, n: int) -> Tensor:
    """Lower-triangular Cholesky of SPD ``A [..., n, n]``, unrolled; the
    pivot is floored at 1e-30 (NaN propagates, as ``jnp.maximum`` does)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack(
        [
            torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)
        ],
        dim=-2,
    )


def solve_spd(A: Tensor, b: Tensor, n: int) -> Tensor:
    """Solve SPD ``A x = b`` (``b [..., n]``) by unrolled Cholesky."""
    L = cholesky_unrolled(A, n)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def homography_unit_square(quad: Tensor) -> Tensor:
    """Closed-form homography mapping the unit square (0,0),(1,0),(1,1),
    (0,1) to ``quad [..., 4, 2]`` (Heckbert's projective mapping)."""
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dx2 = x1 - x2, x3 - x2
    dy1, dy2 = y1 - y2, y3 - y2
    inv_det = 1.0 / (dx1 * dy2 - dx2 * dy1)
    g = (sx * dy2 - sy * dx2) * inv_det
    h = (sy * dx1 - sx * dy1) * inv_det
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    one = torch.ones_like(a)
    return torch.stack(
        [
            torch.stack([a, b, x0], dim=-1),
            torch.stack([d, e, y0], dim=-1),
            torch.stack([g, h, one], dim=-1),
        ],
        dim=-2,
    )
