"""The CCL kernel family's plain versions (K3-K5s) held against the JAX
package: its XLA stage functions and its Pallas kernels in interpret mode,
on the shapes, strides and radii of ``tests/test_pallas_kernels.py`` and on
one rendered 480x640 frame under ``DetectorConfig()``. Every comparison is
exact: the threshold is integer arithmetic in float32 until its divisions
and the labelling is integer min-propagation. On CPU tensors the kernel
wrappers take these plain versions and launch nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.ops import detector as jdet
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.ops.kernels import ccl as jccl
from aruco_slam_tpu.sim import renderer as jrenderer
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import ccl

torch.set_num_threads(1)

THRESHOLD_CASES = (((64, 256), 4, 7), ((64, 128), 1, 5), ((128, 128), 2, 7))
CCL_CASES = (((64, 256), 0.4, 4), ((64, 128), 0.7, 6), ((128, 128), 0.05, 2))


def _eq(ours: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def rendered():
    """The scene of tests/test_detector.py, one uint8 480x640 frame."""
    cam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    stack = jrenderer.build_marker_stack(jsyn.make_arena(n_markers=20))
    cam_pos, R_wc = jrenderer.camera_pose_from_robot(jnp.asarray((2.55, -2.0, 1.2), jnp.float32))
    return np.array(jrenderer.render_frame(cam_pos, R_wc, stack, cam))


@pytest.mark.parametrize("shape,dens,rounds", CCL_CASES)
def test_label_components_matches_xla_and_pallas(shape, dens, rounds):
    fg = np.random.default_rng(2).random(shape) < dens
    ours = ccl.label_components(torch.as_tensor(fg)[None], rounds)[0]
    _eq(ours, jax.jit(lambda m: jdet.label_components(m, rounds))(jnp.asarray(fg)))
    _eq(ours, jccl.label_components_tpu(jnp.asarray(fg), rounds, interpret=True))


def test_seeded_label_components_matches_xla_and_pallas():
    fg = np.random.default_rng(11).random((64, 256)) < 0.4
    lab = detector.label_components(torch.as_tensor(fg)[None], 4)
    fg_c = detector.binary_close3(torch.as_tensor(fg)[None])
    ours = ccl.label_components(fg_c, 2, init=lab.reshape(fg_c.shape))[0]
    seed = jnp.asarray(lab[0].numpy().reshape(fg.shape))
    fgc_j = jnp.asarray(fg_c[0].numpy())
    _eq(ours, jax.jit(lambda m, s: jdet.label_components(m, 2, init=s))(fgc_j, seed))
    _eq(ours, jccl.label_components_tpu(fgc_j, 2, interpret=True, init=seed))


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_and_close_match_xla(shape, stride, radius):
    img = np.random.default_rng(5).integers(0, 256, (3, *shape)).astype(np.uint8)
    fg = detector.adaptive_threshold(torch.as_tensor(img), radius, 7.0, stride)
    thr = jax.jit(jax.vmap(lambda im: jdet.adaptive_threshold(im, radius, 7.0, stride)))
    fg_j = thr(jnp.asarray(img))
    _eq(fg, fg_j)
    _eq(detector.binary_close3(fg), jax.jit(jax.vmap(jdet.binary_close3))(fg_j))


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_label_matches_pallas(shape, stride, radius):
    img = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    fg, lab = ccl.threshold_label(torch.as_tensor(img)[None], radius, 7.0, stride, 4)
    fg_k, lab_k = jccl.threshold_label_tpu(jnp.asarray(img), radius, 7.0, stride, 4,
                                           interpret=True)
    _eq(fg[0], fg_k)
    _eq(lab[0], lab_k)


@pytest.mark.parametrize("shape,stride,radius", THRESHOLD_CASES)
def test_threshold_label_union_matches_pallas(shape, stride, radius):
    img = np.random.default_rng(9).integers(0, 256, shape).astype(np.uint8)
    ours = ccl.threshold_label_union(torch.as_tensor(img)[None], radius, 7.0, stride, 4, 2)
    ref = jccl.threshold_label_union_tpu(jnp.asarray(img), radius, 7.0, stride, 4,
                                         closed_rounds=2, interpret=True)
    for a, b in zip(ours, ref):
        _eq(a[0], b)


def test_union_on_a_rendered_frame_matches_xla_and_pallas(rendered):
    """The detector default on a marker scene: all four outputs of K3's
    plain version against the Pallas kernel and the unfused XLA stages."""
    cfg = detector.DetectorConfig()
    args = (cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds,
            cfg.closed_ccl_rounds)
    ours = ccl.threshold_label_union(torch.as_tensor(rendered)[None], *args)
    ref = jccl.threshold_label_union_tpu(jnp.asarray(rendered), *args[:4],
                                         closed_rounds=args[4], interpret=True)
    for a, b in zip(ours, ref):
        _eq(a[0], b)
    xla = jax.jit(lambda im: jdet._union_masks_and_labels(im, args[0], jdet.DetectorConfig()))(
        jnp.asarray(rendered)
    )
    for a, b in zip(ours, xla):
        _eq(a[0], b)
    assert 0 < int(ours[0].sum()) < rendered.size // 4


def test_wrappers_on_cpu_take_the_plain_versions(rendered):
    img = torch.as_tensor(np.stack([rendered, rendered[::-1].copy()]))
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    fg4, lab4 = ccl.threshold_label(img, 7, 7.0, 4, 3)
    assert torch.equal(fg4, out[0]) and torch.equal(lab4, out[1])
    assert torch.equal(ccl.label_components(out[0], 3), out[1])
    assert ccl.LAUNCHES == before
    # frames are independent: the second frame alone gives its own rows
    single = ccl.threshold_label_union(img[1:].contiguous(), 7, 7.0, 4, 3, 2)
    for a, b in zip(single, out):
        assert torch.equal(a[0], b[1])


def test_float_images_take_the_same_path():
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 256)).astype(np.uint8)
    a = ccl.threshold_label_union(torch.as_tensor(img), 7, 7.0, 4, 3, 2)
    b = ccl.threshold_label_union(torch.as_tensor(img.astype(np.float32)), 7, 7.0, 4, 3, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fused_threshold_gate():
    assert ccl.fused_threshold_ok(480, 640, 4)
    assert ccl.fused_threshold_ok(1080, 1920, 4)
    assert ccl.fused_threshold_ok(64, 128, 1)
    assert not ccl.fused_threshold_ok(480, 640, 3)  # not a power of two
    assert not ccl.fused_threshold_ok(482, 640, 4)  # the block grid does not tile
    with pytest.raises(ValueError, match="power-of-two"):
        ccl.threshold_label(torch.zeros(1, 480, 640, dtype=torch.uint8), 7, 7.0, 3, 3)
