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
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
from aruco_slam_tpu_torch.sim import synthetic
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
