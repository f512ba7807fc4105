"""The hand-written CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU (sm_90a) and nvcc, so they carry the ``cuda``
marker and skip where there is no card. Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``: the suite's
conftest imports JAX, which a machine that runs only the port lacks.
"""

import dataclasses

import pytest
import torch

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import ccl
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
from aruco_slam_tpu_torch.sim import renderer, synthetic
from aruco_slam_tpu_torch.utils.config import CompatConfig, EkfConfig, SlamConfig

pytestmark = pytest.mark.cuda

DIST = (-0.28, 0.07, 1.2e-3, -8e-4, 0.018)
CFG = SlamConfig(ekf=EkfConfig(max_landmarks=8, max_observations_per_frame=6))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _data(dev, dist=None, n=3, batch=4, duration=3.0):
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=dist)
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=s, max_obs=6),
            level="corners", camera=cam,
        )
        for s in range(n)
    ]
    return cam, runner.build_batch_data(seqs, batch, "corners", dev)


@pytest.mark.parametrize("dist", [None, DIST])
def test_pnp_kernel_matches_plain(dev, dist):
    cam, data = _data(dev, dist)
    corners = data.corners_px.flatten(0, 1).contiguous()  # every frame as a lane batch
    valid = data.obs_valid.flatten(0, 1).contiguous()
    corners[::7, -1] = float("nan")  # garbage slots, marked valid
    valid[::7, -1] = True
    before = pk.LAUNCHES
    z, R, keep = pk.pnp_frontend_batch(corners, valid, cam, CFG)
    zr, Rr, keepr = pk.pnp_frontend_reference(corners, valid, cam, CFG)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    assert torch.equal(keep, keepr)
    assert not keep[::7, -1].any()
    torch.testing.assert_close(z[keep], zr[keep], atol=2e-5, rtol=0)
    torch.testing.assert_close(R[keep], Rr[keep], atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("compat", [CompatConfig(), CompatConfig(reject_divergent=True,
                                                                 stationary_gate=False)])
def test_frame_kernel_replay_matches_plain(dev, compat):
    """The whole corner-level replay through both kernels against the plain
    path on the card, with capacity drops (3 slots)."""
    cfg = dataclasses.replace(
        CFG, ekf=EkfConfig(max_landmarks=3, max_observations_per_frame=6), compat=compat
    )
    cam, data = _data(dev)
    before = (pk.LAUNCHES, kb.LAUNCHES)
    out = runner.replay_batch(data, cfg, cam, "corners")
    frames = data.obs_ids.shape[1]
    assert (pk.LAUNCHES, kb.LAUNCHES) == (before[0] + frames, before[1] + frames)
    ref = runner.replay_batch_reference(data, cfg, cam, "corners")
    torch.cuda.synchronize()
    assert torch.equal(out.n_landmarks, ref.n_landmarks)
    assert torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids)
    assert torch.equal(out.final_state.dropped, ref.final_state.dropped)
    assert int(out.final_state.dropped.sum()) > 0
    torch.testing.assert_close(out.trajectory, ref.trajectory, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.final_state.sigma, ref.final_state.sigma,
                               atol=5e-5, rtol=5e-3)


def test_frame_kernel_refuses_oversized_state(dev):
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=78, max_observations_per_frame=2))
    B, M = 1, 2
    state = ekf.init_state(cfg, B, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="227 KB"):
        kb.frame_step_batched(
            state, torch.zeros(B, 3, **f32), torch.zeros(B, 9, **f32),
            torch.zeros(B, 9, **f32), torch.zeros(B, M, **i32),
            torch.zeros(B, M, 3, **f32), torch.zeros(B, M, 9, **f32),
            torch.zeros(B, M, dtype=torch.bool, device=dev),
            torch.full((B, M), -1, **i32), cfg,
        )


def _frames(dev, shape):
    """Rendered marker frames (at 480x640) or uniform noise, uint8 [4, H, W]."""
    g = torch.Generator().manual_seed(shape[0] * 7 + shape[1])
    if shape == (480, 640):
        poses = [(2.55, -2.0, 1.2), (2.0, -2.5, 2.5), (1.0, -1.0, 0.3)]
        cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
        imgs = renderer.render_poses(poses, synthetic.make_arena(n_markers=20), cam, device=dev)
        noise = torch.randint(0, 256, (1, *shape), generator=g, dtype=torch.uint8)
        return torch.cat([imgs, noise.to(dev)])
    return torch.randint(0, 256, (4, *shape), generator=g, dtype=torch.uint8).to(dev)


@pytest.mark.parametrize("shape,stride,radius", [
    ((64, 256), 4, 7), ((64, 128), 1, 5), ((128, 128), 2, 7), ((480, 640), 4, 7),
])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_ccl_family_matches_plain(dev, shape, stride, radius, dtype):
    """K3, K4, K5 and K5s against their plain versions, bit for bit."""
    img = _frames(dev, shape).to(dtype).contiguous()
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, radius, 7.0, stride, 3, 2)
    ref = ccl.threshold_label_union_reference(img, radius, 7.0, stride, 3, 2)
    fg4, lab4 = ccl.threshold_label(img, radius, 7.0, stride, 4)
    fg4r, lab4r = ccl.threshold_label_reference(img, radius, 7.0, stride, 4)
    fg, lab, fg_c = ref[0], ref[1], ref[2]
    k5 = ccl.label_components(fg, 4)
    k5s = ccl.label_components(fg_c, 2, init=lab.reshape(fg.shape))
    torch.cuda.synchronize()
    for a, b in zip(out + (fg4, lab4), ref + (fg4r, lab4r)):
        assert torch.equal(a, b)
    assert torch.equal(k5, detector.label_components(fg, 4))
    assert torch.equal(k5s, detector.label_components(fg_c, 2, init=lab.reshape(fg.shape)))
    assert bool(fg.any()) and not bool(fg.all())
    assert {k: ccl.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)


def test_ccl_kernel_at_1080p(dev):
    img = torch.randint(0, 256, (2, 1080, 1920), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_image_replay_kernels_match_plain(dev):
    """The image-level replay through K3, K1 and K2 against the plain path."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=2.0, seed=s, frames_per_sec=5.0), level="images",
            camera=cam, device=dev,
        )
        for s in range(2)
    ]
    data = runner.build_batch_data(seqs, 3, "images", dev)
    before = ccl.LAUNCHES["threshold_label_union"]
    out = runner.replay_batch(data, CFG, cam, "images", det_chunk=8)
    assert ccl.LAUNCHES["threshold_label_union"] == before + 4  # ceil(3 * 10 / 8)
    ref = runner.replay_batch_reference(data, CFG, cam, "images", det_chunk=8)
    torch.cuda.synchronize()
    assert torch.equal(out.n_landmarks, ref.n_landmarks)
    assert torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids)
    assert int(out.n_landmarks[:, -1].min()) > 0
    torch.testing.assert_close(out.trajectory, ref.trajectory, atol=1e-4, rtol=0)
