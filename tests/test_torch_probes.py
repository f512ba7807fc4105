"""The probes P1-P3 of the JAX package's ``benchmarks/`` on the port's side:
the plain versions of the copy kernels (``ops/kernels/probes.py``) and of
the threshold stage alone (``ccl.threshold_only``) held bit for bit against
the probes' own Pallas bodies in interpret mode, K4's plain version on P3's
frame of random bytes against the JAX package's K4 in interpret mode, and
the block body's spilled plan that P3 sets beside the resident one.

The probe files time their kernels when they are imported, so their bodies
are copied here verbatim, each with its file and lines, and a test holds
each copy to those lines; only ``interpret=True`` is added to their
``pallas_call``. On CPU tensors every
new wrapper takes its plain version and launches nothing."""

import functools
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aruco_slam_tpu.ops.kernels import ccl as K
from aruco_slam_tpu_torch.ops.kernels import ccl, probes

torch.set_num_threads(1)

FRAMES = (3, 48, 64)
THRESHOLD_SHAPES = ((96, 128), (64, 128))
RADIUS, C, STRIDE = 7, 7.0, 4  # the probes' threshold


# benchmarks/_ccl_fixed_probe.py:49-54
def thr_only_kernel(img_ref, fg_out, *, radius, C, stride, h, w):
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    x = img_ref[:].astype(jnp.float32)
    fgm = K._fg_from_image(x, radius, C, stride, row_ids, col_ids, h, w)
    fg_out[:] = fgm.astype(jnp.int32)


# benchmarks/_ccl_fixed_probe.py:68-69
def copy_kernel(img_ref, out_ref):
    out_ref[:] = img_ref[:].astype(jnp.int32)


# benchmarks/_det_chain_probe.py:222-223
def kern(i_ref, o_ref):
    o_ref[:] = i_ref[:] * 1.0000001


PROBE_BODIES = {  # each copy above: the file and lines it was copied from
    "thr_only_kernel": (thr_only_kernel, "benchmarks/_ccl_fixed_probe.py", 49, 54),
    "copy_kernel": (copy_kernel, "benchmarks/_ccl_fixed_probe.py", 68, 69),
    "kern": (kern, "benchmarks/_det_chain_probe.py", 222, 223),
}


@pytest.mark.parametrize("name", PROBE_BODIES)
def test_copied_probe_bodies_match_their_files(name):
    """Each Pallas body copied above is, line for line, the one in its
    probe file (read as text: importing the file runs its timing)."""
    fn, path, first, last = PROBE_BODIES[name]
    lines = (Path(__file__).resolve().parents[1] / path).read_text().splitlines()
    assert textwrap.dedent("\n".join(lines[first - 1:last]) + "\n") == inspect.getsource(fn)


def _vmapped(kernel, dtype, shape):
    """The probes' ``pallas_call`` of one frame (``_ccl_fixed_probe.py:56-
    63``, ``_det_chain_probe.py:225-231``) in interpret mode, vmapped over
    the frames as the probes run it."""

    def one(im):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(shape, dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(im)

    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def copy_probe():
    return _vmapped(copy_kernel, jnp.int32, FRAMES[1:])


@pytest.fixture(scope="module")
def scale_probe():
    return _vmapped(kern, jnp.float32, FRAMES[1:])


@pytest.fixture(scope="module")
def threshold_probes():
    """P1a's kernel at each shape, compiled once for both input types."""
    return {(h, w): _vmapped(functools.partial(thr_only_kernel, radius=RADIUS, C=C,
                                               stride=STRIDE, h=h, w=w), jnp.int32, (h, w))
            for h, w in THRESHOLD_SHAPES}


def _fractional(shape, seed):
    """The copy's contract: values in [-0.99, 256), most of them fractional."""
    return np.random.default_rng(seed).uniform(-0.99, 256.0, shape).astype(np.float32)


def test_copy_matches_the_probes_pallas_kernel(copy_probe):
    x = _fractional(FRAMES, 0)
    x[0, 0, :4] = (-0.99, -0.5, 0.0, 255.99)  # truncation toward zero at the ends
    ours = probes.copy_to_int32_reference(torch.as_tensor(x))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(copy_probe(jnp.asarray(x))))
    assert ours[0, 0, :4].tolist() == [0, 0, 0, 255]


def test_scale_matches_the_probes_pallas_kernel(scale_probe):
    """Bit for bit, and torch's multiply by a Python float rounds the
    constant to float32 as JAX's weak-typed scalar does: the plain version
    equals a multiply by the float32 constant."""
    x = _fractional(FRAMES, 1)
    ours = probes.scale_copy_reference(torch.as_tensor(x))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(scale_probe(jnp.asarray(x))))
    np.testing.assert_array_equal(ours.numpy(), x * np.float32(probes.SCALE))
    scale = torch.tensor(probes.SCALE, dtype=torch.float32)
    assert torch.equal(ours, torch.as_tensor(x) * scale)
    assert bool((ours != torch.as_tensor(x)).any())  # the multiply is not a no-op


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", THRESHOLD_SHAPES)
def test_threshold_only_matches_the_probes_pallas_kernel(threshold_probes, shape, dtype):
    """P1a's plain version against ``thr_only_kernel``, bit for bit, on
    bytes and on the same bytes as float32 (the probe casts its rendered
    uint8 frames to float32)."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, (2, *shape)).astype(dtype)
    ours = ccl.threshold_only_reference(torch.as_tensor(img), RADIUS, C, STRIDE)
    assert ours.dtype == torch.int32 and ours.shape == (2, *shape)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(threshold_probes[shape](
        jnp.asarray(img))))
    assert 0 < int(ours.sum()) < ours.numel()


def test_k4_plain_on_random_bytes_matches_pallas():
    """P3's input, a frame of random bytes (``default_rng(0)``), at 64x128:
    K4's plain version at 3 rounds against the JAX package's K4 in
    interpret mode; labels compared, the components left unconverged."""
    img = np.random.default_rng(0).integers(0, 256, (64, 128)).astype(np.uint8)
    fg, lab = ccl.threshold_label_reference(torch.as_tensor(img)[None].float(), RADIUS, C,
                                            STRIDE, 3)
    fg_k, lab_k = K.threshold_label_tpu(jnp.asarray(img), RADIUS, C, STRIDE, 3, interpret=True)
    np.testing.assert_array_equal(fg[0].numpy(), np.asarray(fg_k).astype(bool))
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(lab_k))
    assert 0.2 < float(fg.float().mean()) < 0.8


def test_spilled_plan_at_1080p():
    """P3's second plan on an H100: 17 tiles of 64 rows, their workspaces in
    device memory, one team on all 132 SMs (115 of them with no tile)."""
    assert ccl.spilled_plan(1080, 1920, 132) == ccl.BlockPlan(
        64, 1920, 1, 17, 1, 132, True, 0, 17 * ccl.block_tile_words(64, 1920, shared=False))
    # the plan block_plan falls back to is the same function's
    assert ccl.block_plan(2160, 3840, 1) == ccl.spilled_plan(2160, 3840)


def test_block_plan_at_1080p_stays_resident():
    plan = ccl.block_plan(1080, 1920, 1)
    assert not plan.spilled and plan.work_words == 0
    assert plan.tile_rows <= 24 and plan.ctas == plan.tiles_y <= ccl.H100_SMS
    assert plan.smem_bytes == 4 * ccl.block_tile_words(plan.tile_rows, 1920)


def _cpu_calls():
    img = torch.as_tensor(_fractional((2, 64, 128), 3))
    # a frame wider than the cluster body takes, in the spilled plan
    wide = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (1, 64, 1280),
                                                             dtype=np.uint8))
    return {
        "copy_to_int32": (lambda: probes.copy_to_int32(img),
                          lambda: probes.copy_to_int32_reference(img)),
        "scale_copy": (lambda: probes.scale_copy(img), lambda: probes.scale_copy_reference(img)),
        "threshold_only": (lambda: ccl.threshold_only(img.floor(), RADIUS, C, STRIDE),
                           lambda: ccl.threshold_only_reference(img.floor(), RADIUS, C, STRIDE)),
        "threshold_label(plan=spilled)": (
            lambda: ccl.threshold_label(wide, RADIUS, C, STRIDE, 3,
                                        plan=ccl.spilled_plan(64, 1280)),
            lambda: ccl.threshold_label_reference(wide, RADIUS, C, STRIDE, 3)),
    }


@pytest.mark.parametrize("name", list(_cpu_calls()))
def test_new_wrappers_on_cpu_take_the_plain_versions(name):
    call, plain = _cpu_calls()[name]
    before = (dict(probes.LAUNCHES), dict(ccl.LAUNCHES))
    got, want = call(), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (probes.LAUNCHES, ccl.LAUNCHES) == before
