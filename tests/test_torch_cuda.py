"""The hand-written CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU (sm_90a) and nvcc, so they carry the ``cuda``
marker and skip where there is no card. Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``: the suite's
conftest imports JAX, which a machine that runs only the port lacks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.kernels import ccl
from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
from aruco_slam_tpu_torch.sim import renderer, synthetic
from aruco_slam_tpu_torch.system import SlamSystem
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


def _k6_case(dev, max_lm, n_lm, seed, M=16):
    """A state with ``n_lm`` landmarks (SPD covariance) and a frame that
    mixes known, new and invalid observations, one known one at its
    slot's last record (a stationary-gate hit)."""
    rng = np.random.default_rng(seed)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=M))
    N, na = 3 + 3 * max_lm, 3 + 3 * n_lm
    A = rng.normal(size=(na, na)) * 0.1
    sigma = np.zeros((N, N), np.float32)
    sigma[:na, :na] = A @ A.T + 0.05 * np.eye(na)
    mu = np.zeros(N, np.float32)
    mu[:na] = rng.normal(size=na)
    slot_ids = np.full(max_lm, -1, np.int32)
    slot_ids[:n_lm] = rng.choice(10_000, n_lm, replace=False)
    last = rng.normal(size=(max_lm, 3)).astype(np.float32)
    state = ekf.init_state(cfg, 1, dev)._replace(
        mu=torch.as_tensor(mu, device=dev)[None],
        sigma=torch.as_tensor(sigma, device=dev)[None],
        slot_ids=torch.as_tensor(slot_ids, device=dev)[None],
        n_landmarks=torch.tensor([n_lm], dtype=torch.int32, device=dev),
        last_obs=torch.as_tensor(last, device=dev)[None],
        seen_prev=torch.ones(1, max_lm, dtype=torch.bool, device=dev),
        initialized=torch.ones(1, dtype=torch.bool, device=dev),
    )
    ids = np.full(M, -1, np.int32)
    ids[:12] = np.concatenate([slot_ids[:8], 20_000 + np.arange(4)])
    z = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    z[0] = last[0]
    Bn = (rng.normal(size=(M, 3, 3)) * 0.05).astype(np.float32)
    R = Bn @ np.transpose(Bn, (0, 2, 1)) + 0.01 * np.eye(3, dtype=np.float32)
    perm = rng.permutation(M)
    frame = ekf.FrameObservations(*(torch.as_tensor(x[perm], device=dev)[None]
                                    for x in (ids, z, R, ids >= 0)))
    return cfg, state, frame


@pytest.mark.parametrize("max_lm", [64, 128])
@pytest.mark.parametrize("reject", [False, True])
def test_frame_update_kernel_matches_plain(dev, max_lm, reject):
    """K6 against ``ekf.update`` on the card, past K2's 77-landmark limit."""
    cfg, state, frame = _k6_case(dev, max_lm, max_lm - 2, max_lm)
    cfg = dataclasses.replace(cfg, compat=CompatConfig(reject_divergent=reject,
                                                       divergence_ze_norm=0.6))
    before = k6.LAUNCHES
    out = k6.frame_update(state, frame, cfg)
    ref = k6.frame_update_reference(state, frame, cfg)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == before + 1
    for name in ("slot_ids", "n_landmarks", "seen_prev", "diverged", "dropped"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert int(out.dropped[0]) == 2 and int(out.n_landmarks[0]) == max_lm
    for name in ("mu", "sigma", "last_obs"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=5e-5, rtol=5e-3)
    # the uninitialized lane keeps everything
    still = k6.frame_update(state._replace(initialized=~state.initialized), frame, cfg)
    torch.cuda.synchronize()
    for name in ekf.EkfState._fields[:6]:
        assert torch.equal(getattr(still, name), getattr(state, name)), name


def test_slam_system_on_the_card_matches_the_cpu(dev):
    """The same calls on a card system (K6, K3) and a CPU one (plain)."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=2.0, seed=4, max_obs=8))
    img = renderer.render_poses([(2.55, -2.0, 1.2)], synthetic.make_arena(n_markers=20), cam,
                                device="cpu")[0].numpy()
    systems = [SlamSystem(CFG, camera=cam, device=d) for d in (dev, "cpu")]
    epf = seq.enc_per_frame
    before = k6.LAUNCHES
    for f in range(seq.num_frames):
        for e in range(epf):
            for s in systems:
                s.add_encoder(*seq.enc_w[f * epf + e], seq.enc_dt[f * epf + e])
        for s in systems:
            s.add_observations(seq.obs_ids[f], seq.obs_z[f], seq.obs_R[f], seq.obs_valid[f])
    for s in systems:
        s.add_image(img)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == before + seq.num_frames + 1
    gpu, cpu = systems
    np.testing.assert_allclose(gpu.pose(), cpu.pose(), atol=1e-4)
    np.testing.assert_array_equal(gpu.landmark_map()[1], cpu.landmark_map()[1])
    np.testing.assert_allclose(gpu.landmark_map()[0], cpu.landmark_map()[0], atol=1e-4)
    assert [d["id"] for d in gpu.detected_markers()] == [d["id"] for d in cpu.detected_markers()]
    assert len(gpu.detected_markers()) >= 1
