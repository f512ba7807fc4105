"""The control of the comparison: the plain reference computed in TF32, the
precision below the deployments' float32 with TF32 off, put in the
program's place. It has to come out not correct (``PERF.md`` gives its
readings).

TF32 is applied by rounding every input of every matrix product
(``@``, ``matmul``, ``bmm``, ``einsum``) to TF32's 10 explicit mantissa
bits, round to nearest, and accumulating in float32, as the tensor cores
do. The rounding is made here rather than left to
``torch.backends.cuda.matmul.allow_tf32``: the library need not pick a
TF32 kernel for the reference's small batched products, and the CPU has
none, so only an explicit rounding computes in TF32 everywhere.

The detector's corners come from its subpixel solve, whose gradient sums
are elementwise products, not matrix products; there the control rounds
the inputs of every product (``*``) to TF32 too, as those sums would be
taken as a TF32 matrix product of the gradient fields on the tensor cores.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.overrides import TorchFunctionMode

from portbench.reference import detector

_PRODUCTS = {torch.matmul, torch.bmm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__}
_ELEMENTWISE = {torch.mul, torch.Tensor.mul, torch.Tensor.__mul__, torch.Tensor.__rmul__}


def to_tf32(x):
    """A float32 tensor rounded to TF32 (10 mantissa bits, to nearest);
    anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).reshape(x.shape)


class TF32Products(TorchFunctionMode):
    """Within this mode every matrix product takes its inputs in TF32; with
    ``elementwise``, every elementwise product too."""

    def __init__(self, elementwise: bool = False):
        super().__init__()
        self.funcs = _PRODUCTS | _ELEMENTWISE if elementwise else _PRODUCTS

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.funcs:
            args = tuple(to_tf32(a) for a in args)
        return func(*args, **kwargs)


@contextmanager
def subpix_in_tf32():
    """Within this context the reference detector's subpixel solve takes
    every product's inputs in TF32; the plain solve is given back after."""
    plain = detector.refine_corners_subpix

    def tf32(*args, **kwargs):
        with TF32Products(elementwise=True):
            return plain(*args, **kwargs)

    detector.refine_corners_subpix = tf32
    try:
        yield
    finally:
        detector.refine_corners_subpix = plain


def control_result(cell, lanes) -> tuple:
    """The reference in float32 with TF32 products (the detector's subpixel
    solve with TF32 products throughout), as the program's result and (at
    image level) its detections per lane."""
    from portbench import check

    with TF32Products(), subpix_in_tf32():
        ref = check.reference(cell, lanes, torch.float32)
    dets = None
    if "detections" in ref:
        dets = tuple(x.index_select(0, cell.lane_base) for x in ref.pop("detections"))
    return ref, dets
