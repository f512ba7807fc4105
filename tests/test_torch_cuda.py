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
from aruco_slam_tpu_torch.ops.kernels import probes
from aruco_slam_tpu_torch.sim import renderer, synthetic
from aruco_slam_tpu_torch.system import SlamSystem
from aruco_slam_tpu_torch.utils.config import CompatConfig, EkfConfig, SlamConfig
from torch_ccl_masks import tile_crossing_mask

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
    corners[::5, 0] = float("inf")  # padded slots: garbage, not valid
    valid[::5, 0] = False
    before = pk.LAUNCHES
    z, R, keep = pk.pnp_frontend_batch(corners, valid, cam, CFG)
    zr, Rr, keepr = pk.pnp_frontend_reference(corners, valid, cam, CFG)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == before + 1
    assert torch.equal(keep, keepr)
    assert not keep[::7, -1].any() and not keep[::5, 0].any()
    # a padded slot exits at once with z = 0 and R = I
    assert torch.equal(z[::5, 0], torch.zeros_like(z[::5, 0]))
    assert torch.equal(R[::5, 0], torch.eye(3, device=dev).expand_as(R[::5, 0]))
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
    before = (pk.LAUNCHES, kb.LAUNCHES["smem"])
    out = runner.replay_batch(data, cfg, cam, "corners")
    frames = data.obs_ids.shape[1]
    assert (pk.LAUNCHES, kb.LAUNCHES["smem"]) == (before[0] + frames, before[1] + frames)
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
    """The state K2 once refused (78 landmarks, past one CTA's shared
    memory) is refused no more: it takes the cluster variant and matches
    the plain version."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=78, max_observations_per_frame=2))
    B, M = 1, 2
    state = ekf.init_state(cfg, B, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    frame = ekf.FrameObservations(
        torch.tensor([[7, -1]], dtype=torch.int32, device=dev),
        torch.tensor([[[1.0, 0.5, 0.1], [0.0, 0.0, 0.0]]], **f32),
        (0.01 * torch.eye(3, **f32)).expand(B, M, 3, 3).contiguous(),
        torch.tensor([[True, False]], device=dev),
    )
    ticks = torch.zeros(B, 0, **f32)
    controls = ekf.Control(ticks, ticks, ticks)
    assert kb.variant(3 + 3 * 78)[0] == "cluster"
    before = kb.LAUNCHES["cluster"]
    out = kb.frame_step_batched(state, frame, controls, cfg)
    ref = kb.frame_step_reference(state, frame, controls, cfg)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["cluster"] == before + 1
    assert out.n_landmarks.tolist() == ref.n_landmarks.tolist() == [1]
    for name in ("mu", "sigma"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=5e-5, rtol=5e-3)


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
    """K3, K4, K5, K5s and the threshold alone against their plain
    versions, bit for bit (every shape here takes the cluster body)."""
    img = _frames(dev, shape).to(dtype).contiguous()
    kind = ccl.body(*shape, stride)
    assert kind == "cluster"
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, radius, 7.0, stride, 3, 2)
    ref = ccl.threshold_label_union_reference(img, radius, 7.0, stride, 3, 2)
    fg4, lab4 = ccl.threshold_label(img, radius, 7.0, stride, 4)
    fg4r, lab4r = ccl.threshold_label_reference(img, radius, 7.0, stride, 4)
    fg, lab, fg_c = ref[0], ref[1], ref[2]
    k5 = ccl.label_components(fg, 4)
    k5s = ccl.label_components(fg_c, 2, init=lab.reshape(fg.shape))
    thr = ccl.threshold_only(img, radius, 7.0, stride)
    torch.cuda.synchronize()
    for a, b in zip(out + (fg4, lab4), ref + (fg4r, lab4r)):
        assert torch.equal(a, b)
    assert torch.equal(thr, ccl.threshold_only_reference(img, radius, 7.0, stride))
    assert torch.equal(k5, detector.label_components(fg, 4))
    assert torch.equal(k5s, detector.label_components(fg_c, 2, init=lab.reshape(fg.shape)))
    assert bool(fg.any()) and not bool(fg.all())
    assert {k: ccl.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k.endswith(kind)) for k in before}


@pytest.mark.parametrize("frames", [1, 128])
def test_ccl_cluster_body_on_many_frames(dev, frames):
    """The cluster body at 480x640 on one frame and on a 128-frame chunk
    (more frames than clusters the card holds at once), K3 and K4."""
    base = _frames(dev, (480, 640))
    img = base.repeat((frames + 3) // 4, 1, 1)[:frames].contiguous()
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    fg4, lab4 = ccl.threshold_label(img, 7, 7.0, 4, 3)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(fg4, ref[0])
    assert torch.equal(lab4, ccl.label_components_reference(ref[0], 3))
    used = {k: v - before[k] for k, v in ccl.LAUNCHES.items() if v != before[k]}
    assert used == {"threshold_label_union.cluster": 1, "threshold_label.cluster": 1}


def test_ccl_kernel_at_1080p(dev):
    """1920x1080 takes the block body."""
    img = torch.randint(0, 256, (2, 1080, 1920), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    before = ccl.LAUNCHES["threshold_label_union.block"]
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    fg = ref[0]
    k5 = ccl.label_components(fg, 3)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(k5, ccl.label_components_reference(fg, 3))
    assert ccl.LAUNCHES["threshold_label_union.block"] == before + 1


def _hd_frames(dev, h, w, n):
    """n frames of the 20-marker arena at h x w (an HD camera of the
    detector's buckets), at varied poses."""
    rng = np.random.default_rng(h + n)
    poses = np.stack([rng.uniform(0.8, 4.3, n), rng.uniform(-3.9, -0.8, n),
                      rng.uniform(-np.pi, np.pi, n)], axis=1)
    poses[0] = (2.55, -2.0, 1.2)
    f = 1800.0 * w / 1920
    cam = CameraIntrinsics.create(f, f, w / 2, h / 2)
    return renderer.render_poses(poses, synthetic.make_arena(n_markers=20), cam, height=h,
                                 width=w, device=dev)


@pytest.mark.parametrize("h,w", [(720, 1280), (1080, 1920)])
@pytest.mark.parametrize("frames", [1, 16])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_ccl_block_body_at_hd(dev, h, w, frames, dtype):
    """K3, K4, K5, K5s and the threshold alone in the block body on
    rendered HD frames, one frame (spread over the card) and a 16-frame
    chunk (several frames in flight), against their plain versions, bit for
    bit."""
    img = _hd_frames(dev, h, w, frames).to(dtype).contiguous()
    assert ccl.body(h, w, 4) == ccl.body(h, w) == "block"
    before = dict(ccl.LAUNCHES)
    out = ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    ref = ccl.threshold_label_union_reference(img, 7, 7.0, 4, 3, 2)
    fg4, lab4 = ccl.threshold_label(img, 7, 7.0, 4, 3)
    fg, lab, fg_c = ref[0], ref[1], ref[2]
    k5 = ccl.label_components(fg_c, 3)
    k5s = ccl.label_components(fg_c, 2, init=lab.reshape(fg.shape))
    thr = ccl.threshold_only(img, 7, 7.0, 4)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(thr, fg.to(torch.int32))
    assert torch.equal(fg4, fg) and torch.equal(lab4, ccl.label_components_reference(fg, 3))
    assert torch.equal(k5, ccl.label_components_reference(fg_c, 3))
    assert torch.equal(k5s, ccl.label_components_reference(fg_c, 2, init=lab.reshape(fg.shape)))
    assert bool(fg.any()) and not bool(fg.all())
    assert {k: ccl.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k.endswith("block")) for k in before}


@pytest.mark.parametrize("frames", [1, 16])
def test_ccl_block_body_on_tile_crossing_mask(dev, frames):
    """K5 and K5s at 1920x1080 on a serpentine through every tile of the
    block body's plan for the chunk, components on its tile edges and runs
    across its row splits; unconverged after the bounded rounds."""
    plan = ccl.block_plan(1080, 1920, frames)
    mask = tile_crossing_mask(1080, 1920, plan.tile_rows, plan.tile_width // 32)
    fg = torch.as_tensor(mask, device=dev)[None].repeat(frames, 1, 1).contiguous()
    lab = ccl.label_components(fg, 3)
    ref = ccl.label_components_reference(fg, 3)
    seed = ref.reshape(fg.shape)
    seeded = ccl.label_components(fg, 2, init=seed)
    torch.cuda.synchronize()
    assert torch.equal(lab, ref)
    assert torch.equal(seeded, ccl.label_components_reference(fg, 2, init=seed))
    assert int(torch.unique(ref[0][fg[0].reshape(-1)]).numel()) > 16  # unconverged


def test_ccl_block_body_spills_frames_larger_than_the_card(dev):
    """A 2160x3840 mask: more tiles than SMs, their workspaces in device
    memory, one team on every SM."""
    fg = torch.as_tensor(np.random.default_rng(5).random((1, 2160, 3840)) < 0.6, device=dev)
    assert ccl.block_plan(2160, 3840, 1).spilled
    lab = ccl.label_components(fg, 3)
    torch.cuda.synchronize()
    assert torch.equal(lab, ccl.label_components_reference(fg, 3))


def _probe_frames(dev, n):
    """n rendered 480x640 frames as float32 (the probes' input) and a frame
    of fractional values in [-0.99, 256)."""
    poses = [(2.55, -2.0, 1.2), (2.0, -2.5, 2.5), (1.0, -1.0, 0.3)] * (-(-n // 3))
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    img = renderer.render_poses(poses[:n], synthetic.make_arena(n_markers=20), cam, device=dev)
    frac = np.random.default_rng(6).uniform(-0.99, 256.0, (1, 480, 640)).astype(np.float32)
    return torch.cat([img.float(), torch.as_tensor(frac, device=dev)]).contiguous()


@pytest.mark.parametrize("name", ["copy_to_int32", "scale_copy"])
def test_probe_kernels_match_plain(dev, name):
    """P1b and P2 bit for bit: the 16-byte path on a chunk, and the
    element path on a chunk that starts 4 bytes past an aligned address
    and whose length is no multiple of 4."""
    kern, plain = getattr(probes, name), getattr(probes, f"{name}_reference")
    img = _probe_frames(dev, 20)
    key = {"copy_to_int32": "probe_copy", "scale_copy": "probe_scale"}[name]
    before = probes.LAUNCHES[key]
    odd = img.reshape(-1)[1: 1 + 3 * 7 * 33].view(3, 7, 33)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    got = (kern(img), kern(odd))
    torch.cuda.synchronize()
    assert probes.LAUNCHES[key] == before + 2
    for a, x in zip(got, (img, odd)):
        b = plain(x)
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_threshold_only_in_both_bodies(dev):
    """The threshold alone against its plain version in the cluster body
    (the probe's 20 frames of 480x640) and the block body (16 rendered
    1920x1080 frames), and against K4's own fg."""
    for img in (_probe_frames(dev, 20)[:20].contiguous(), _hd_frames(dev, 1080, 1920, 16)):
        kind = ccl.body(*img.shape[1:], 4)
        before = ccl.LAUNCHES[f"threshold_only.{kind}"]
        thr = ccl.threshold_only(img, 7, 7.0, 4)
        fg4, _ = ccl.threshold_label(img, 7, 7.0, 4, 1)
        torch.cuda.synchronize()
        assert ccl.LAUNCHES[f"threshold_only.{kind}"] == before + 1
        assert torch.equal(thr, ccl.threshold_only_reference(img, 7, 7.0, 4))
        assert torch.equal(thr, fg4.to(torch.int32))


def test_k4_on_random_bytes_in_both_plans(dev):
    """P3: K4 at 3 rounds on a 1920x1080 frame of random bytes in the
    resident plan (the planner's) and the spilled plan: fg and labels equal
    to the plain version's and to each other's."""
    img = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (1, 1080, 1920)),
                          device=dev).to(torch.uint8).float().contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = (None, ccl.spilled_plan(1080, 1920, sms))
    before = ccl.LAUNCHES["threshold_label.block"]
    outs = [ccl.threshold_label(img, 7, 7.0, 4, 3, plan=plan) for plan in plans]
    ref = ccl.threshold_label_reference(img, 7, 7.0, 4, 3)
    torch.cuda.synchronize()
    assert ccl.LAUNCHES["threshold_label.block"] == before + 2
    for fg, lab in outs:
        assert torch.equal(fg, ref[0]) and torch.equal(lab, ref[1])
    assert 0.3 < float(ref[0].float().mean()) < 0.7


def test_k4_refuses_a_plan_the_chunk_cannot_take(dev):
    """csrc ``block_launch`` refuses a plan that does not fit the chunk
    (another frame's tiles, two spilled teams, a short workspace, a CTA
    short of the tiles, a tile past shared memory) and launches nothing."""
    img = torch.zeros(2, 1080, 1920, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spilled, resident = ccl.spilled_plan(1080, 1920, sms), ccl.block_plan(1080, 1920, 2, sms)
    bad = (ccl.spilled_plan(720, 1280, sms), spilled._replace(teams=2),
           spilled._replace(work_words=spilled.work_words - 1),
           resident._replace(ctas=resident.ctas - 1),
           resident._replace(tile_rows=64, tiles_y=17, ctas=17))
    before = dict(ccl.LAUNCHES)
    for plan in bad:
        with pytest.raises(RuntimeError, match="block body"):
            ccl.threshold_label(img, 7, 7.0, 4, 3, plan=plan)
    torch.cuda.synchronize()
    assert ccl.LAUNCHES == before


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
    before = ccl.LAUNCHES["threshold_label_union.cluster"]
    out = runner.replay_batch(data, CFG, cam, "images", det_chunk=8)
    assert ccl.LAUNCHES["threshold_label_union.cluster"] == before + 4  # ceil(3 * 10 / 8)
    ref = runner.replay_batch_reference(data, CFG, cam, "images", det_chunk=8)
    torch.cuda.synchronize()
    assert torch.equal(out.n_landmarks, ref.n_landmarks)
    assert torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids)
    assert int(out.n_landmarks[:, -1].min()) > 0
    torch.testing.assert_close(out.trajectory, ref.trajectory, atol=1e-4, rtol=0)


def _k6_case(dev, max_lm, n_lm, seed, M=16):
    """A state with ``n_lm`` landmarks (SPD covariance) and a frame that
    mixes known, new and invalid observations, one known one at its
    slot's last record (a stationary-gate hit). At any M but 16 the frame
    is :func:`_wide_obs`'s."""
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
    if M == 16:
        ids = np.full(M, -1, np.int32)
        ids[:12] = np.concatenate([slot_ids[:8], 20_000 + np.arange(4)])
        z = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
        z[0] = last[0]
        valid = ids >= 0
    else:
        ids, z, valid = _wide_obs(rng, mu, slot_ids, min(8, n_lm), last[0], M)
    Bn = (rng.normal(size=(M, 3, 3)) * 0.05).astype(np.float32)
    # a wide frame's chain (about 200 updates, most of a few landmarks)
    # keeps its float32 digits with a noise floor of 0.1 (M 16's 0.01 would
    # cost it ten times more of the tolerance, in the plain version too)
    floor = 0.01 if M == 16 else 0.1
    R = Bn @ np.transpose(Bn, (0, 2, 1)) + floor * np.eye(3, dtype=np.float32)
    perm = rng.permutation(M)
    frame = ekf.FrameObservations(*(torch.as_tensor(x[perm], device=dev)[None]
                                    for x in (ids, z, R, valid)))
    return cfg, state, frame


def _expected_z(mu, slots):
    """The robot-frame measurement of the landmarks in ``slots`` from the
    pose mu[0:3] (``ekf.update``'s model)."""
    x, y, th = mu[:3]
    lm = mu[3:].reshape(-1, 3)[slots]
    dx, dy = lm[:, 0] - x, lm[:, 1] - y
    c, s = np.cos(th), np.sin(th)
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     (lm[:, 2] - th + np.pi) % (2 * np.pi) - np.pi], -1)


def _wide_obs(rng, mu, slot_ids, n_known, last0, M):
    """(ids, z, valid) of M observations whose ids repeat: the landmarks of
    the first ``n_known`` slots and 4 new markers, each many times (a known
    one near its expected measurement, a new one near one place; each copy
    moved by a few cm, so that their order matters to the result), about a
    fifth invalid (some with a padding id); the first is slot 0's landmark
    at its last record (a stationary-gate hit). M may be 0."""
    pool = np.concatenate([slot_ids[:n_known], 20_000 + np.arange(4)]).astype(np.int32)
    at = np.concatenate([_expected_z(mu, np.arange(n_known)),
                         rng.uniform(0.3, 2.0, (4, 3))])
    pick = rng.integers(0, len(pool), M)
    ids = pool[pick]
    valid = rng.random(M) > 0.2
    ids[~valid & (rng.random(M) > 0.5)] = -1
    z = (at[pick] + rng.normal(size=(M, 3)) * 0.03).astype(np.float32)
    if M:
        ids[0], valid[0], z[0] = pool[0], True, last0
    return ids, z, valid


def _n_new(state, frame):
    """The frame's valid observations of ids that the map does not hold."""
    return (frame.valid & (ekf.lookup_slots(state.slot_ids, frame.ids) < 0)).sum(1)


@pytest.mark.parametrize("max_lm", [64, 128, k6.MAX_CLUSTER_LANDMARKS,
                                    k6.MAX_CLUSTER_LANDMARKS + 1])
@pytest.mark.parametrize("reject", [False, True])
def test_frame_update_kernel_matches_plain(dev, max_lm, reject):
    """K6 against ``ekf.update`` on the card, past K2's 77-landmark limit:
    the cluster variant up to its capacity, the grid variant just above."""
    cfg, state, frame = _k6_case(dev, max_lm, max_lm - 2, max_lm)
    cfg = dataclasses.replace(cfg, compat=CompatConfig(reject_divergent=reject,
                                                       divergence_ze_norm=0.6))
    kind = k6.variant(3 + 3 * max_lm)[0]
    assert kind == ("grid" if max_lm > k6.MAX_CLUSTER_LANDMARKS else "cluster")
    before = dict(k6.LAUNCHES)
    out = k6.frame_update(state, frame, cfg)
    ref = k6.frame_update_reference(state, frame, cfg)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == {**before, kind: before[kind] + 1}
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


# K6's frame step: (max_landmarks, landmarks). With the case's 4 new
# markers the active square is small at 40 of 64 and 100 of 128 or 512
# slots, and full (na = N, 2 inserts dropped at 128) at 126 and 508. At
# 1,000 slots (N = 3,003) a full square's stripes pass the grid's shared
# memory, so that frame runs in device memory.
_K6_SQUARES = [(64, 40), (128, 100), (128, 126), (512, 100), (512, 508), (1000, 996)]
# Frames wider than the kernels keep their prologue in shared memory for
# (past ekf_update.MAX_SHARED_OBS = 256, in device memory), and an empty
# one, in both variants: (max_landmarks, landmarks, M).
_WIDE = [(128, 100, 257), (128, 100, 300), (128, 100, 0), (512, 100, 257), (512, 100, 300),
         (512, 100, 0)]
_K6_FRAMES = ([pytest.param(lm, n, 16, id=f"{lm}-{n}") for lm, n in _K6_SQUARES]
              + [pytest.param(lm, n, m, id=f"{lm}-{n}-M{m}") for lm, n, m in _WIDE])


@pytest.mark.parametrize("max_lm,n_lm,M", _K6_FRAMES)
@pytest.mark.parametrize("ticks", [0, 10])
@pytest.mark.parametrize("initialized", [True, False])
def test_k6_frame_step_matches_plain(dev, max_lm, n_lm, M, ticks, initialized):
    """K6's frame step (the compose, the predict, the update, the rows)
    against its plain version at N = 195 and 387 (cluster variant) and
    1,539 (grid variant), with a small and a full active square, from an
    initialized and an uninitialized state: out of place, in place (``out``
    sharing mu and sigma with the state), reading frame f of time-major
    arrays; exactly one device event per call. Also frames of 257 and 300
    observation slots (ids repeated, new and padding ones among them) and
    of none, in both variants."""
    cfg, state, frame = _k6_case(dev, max_lm, n_lm, max_lm + n_lm, M)
    state = state._replace(initialized=torch.full_like(state.initialized, initialized))
    rng = np.random.default_rng(ticks)
    w = torch.as_tensor(rng.uniform(-1.0, 3.0, (3, ticks, 2)).astype(np.float32), device=dev)
    dt = torch.as_tensor(rng.uniform(0.005, 0.02, (3, ticks)).astype(np.float32), device=dev)
    controls = ekf.Control(w[..., 0], w[..., 1], dt)  # 3 frames, strided views
    frames = ekf.FrameObservations(*(torch.cat([x] * 3) for x in frame))
    kind = k6.variant(3 + 3 * max_lm)[0]
    assert kind == ("grid" if max_lm > k6.MAX_CLUSTER_LANDMARKS else "cluster")

    def rows():
        return k6.Rows(torch.zeros(3, 3, device=dev), torch.zeros(3, 3, 3, device=dev),
                       torch.zeros(3, dtype=torch.int32, device=dev), 1)

    ref_rows = rows()
    ref = k6.frame_step_reference(state, frames, controls, cfg, rows=ref_rows)
    one = (ekf.FrameObservations(*(x[1:2] for x in frames)),
           ekf.Control(*(x[1:2] for x in controls)))
    mine = ekf.EkfState(*(t.clone() for t in state))
    spare = ekf.init_state(cfg, 1, dev)._replace(mu=mine.mu, sigma=mine.sigma)
    got_rows = rows()
    before = dict(k6.LAUNCHES)
    outs = [k6.frame_step(state, *one, cfg),
            k6.frame_step(mine, *one, cfg, out=spare),
            k6.frame_step(state, frames, controls, cfg, rows=got_rows)]
    torch.cuda.synchronize()
    assert k6.LAUNCHES == {**before, kind: before[kind] + 3}
    assert outs[1] is spare and spare.sigma is mine.sigma
    for out in outs:
        for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged",
                     "dropped"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
        for name in ("mu", "sigma", "last_obs"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=5e-5,
                                       rtol=5e-3)
    n_new = int(_n_new(state, frame)[0])
    assert n_new == 4 if M == 16 else (n_new > 0) == (M > 0)
    assert int(ref.n_landmarks[0]) == min(max_lm, n_lm + n_new) and bool(ref.initialized[0])
    assert torch.equal(got_rows.n_landmarks, ref_rows.n_landmarks)
    for a, b in ((got_rows.trajectory, ref_rows.trajectory), (got_rows.pose_cov,
                                                             ref_rows.pose_cov)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-3)
    assert _device_events_per_call(lambda: k6.frame_step(state, *one, cfg)) == 1


@pytest.mark.parametrize("in_place", [False, True])
def test_k6_grid_full_square_repeats(dev, in_place):
    """K6's grid variant on the full square (N = 1,539, na = N: every
    stripe's CTA in the chain and its barriers), 20 times from the same
    inputs and 10 ticks, out of place or in place: each result equals the
    plain version, and the first bit for bit (the kernel has no float
    atomics, so a race between the stripes would show as a difference)."""
    cfg, state, frame = _k6_case(dev, 512, 508, 1020)
    rng = np.random.default_rng(10)
    w = torch.as_tensor(rng.uniform(-1.0, 3.0, (1, 10, 2)).astype(np.float32), device=dev)
    dt = torch.as_tensor(rng.uniform(0.005, 0.02, (1, 10)).astype(np.float32), device=dev)
    controls = ekf.Control(w[..., 0], w[..., 1], dt)
    assert k6.variant(state.mu.shape[1])[0] == "grid"
    ref = k6.frame_step_reference(state, frame, controls, cfg)
    first = None
    for _ in range(20):
        if in_place:
            mine = ekf.EkfState(*(t.clone() for t in state))
            out = k6.frame_step(mine, frame, controls, cfg, out=ekf.init_state(cfg, 1, dev)
                                ._replace(mu=mine.mu, sigma=mine.sigma))
        else:
            out = k6.frame_step(state, frame, controls, cfg)
        torch.cuda.synchronize()
        for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged",
                     "dropped"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), name
        for name in ("mu", "sigma", "last_obs"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=5e-5,
                                       rtol=5e-3)
        first = first or out
        for a, b in zip(out, first):
            assert torch.equal(a, b)


def _device_events_per_call(call, reps=10, pads=(0.2, 1.0, 3.0)):
    """Device events per call over ``reps`` calls under torch.profiler, the
    window opened ``pad`` seconds before the calls and closed ``pad`` after
    their device work. The profiler can drop the events of a short window
    (on an H100 it kept none of a K6 call's in some windows), so a window
    that saw fewer events than calls is tried again wider (chip_smoke.py's
    ``_kernel_ms`` does the same)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for pad in pads:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            time.sleep(pad)
        n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if n >= reps:
            break
    return n / reps


def _widened(data, M, frames, seed):
    """The first ``frames`` frames of a single-stream replay's data, each
    frame's observation slots drawn with repeats to M slots (ids repeated,
    invalid slots among them; each copy's z moved by up to 1 cm, so that
    their order matters)."""
    rng = np.random.default_rng(seed)
    F, m = data.obs_ids.shape
    pick = torch.as_tensor(rng.integers(0, m, (frames, M)), device=data.obs_ids.device)

    def take(x):
        idx = pick.reshape(frames, M, *([1] * (x.dim() - 2))).expand(frames, M, *x.shape[2:])
        return torch.gather(x[:frames], 1, idx)

    jitter = torch.as_tensor(rng.uniform(-0.01, 0.01, (frames, M, 3)).astype(np.float32),
                             device=data.obs_z.device)
    return data._replace(enc_w=data.enc_w[:frames], enc_dt=data.enc_dt[:frames],
                         obs_ids=take(data.obs_ids), obs_z=take(data.obs_z) + jitter,
                         obs_R=take(data.obs_R), obs_valid=take(data.obs_valid))


@pytest.mark.parametrize("max_lm,M", [pytest.param(128, 8, id="128"),
                                      pytest.param(512, 8, id="512"),
                                      pytest.param(128, 300, id="128-M300"),
                                      pytest.param(512, 257, id="512-M257")])
def test_k6_replay_matches_plain(dev, max_lm, M):
    """The single-stream replay through K6's frame step (one launch a frame
    through ``ekf_update.replay_step``, the state updated in place from the
    second frame on) against the plain replay on the card; also 10 frames
    widened to 300 and 257 observation slots (``_widened``)."""
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=6.0, seed=9, max_obs=8))
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=M))
    data = runner.replay_data_from_sequence(seq, "obs", dev)
    if M != 8:
        data = _widened(data, M, 10, M)
    assert data.obs_ids.shape[1] == M
    kind = k6.variant(3 + 3 * max_lm)[0]
    before = dict(k6.LAUNCHES)
    out = runner.replay(data, cfg)
    ref = runner.replay_reference(data, cfg)
    torch.cuda.synchronize()
    assert k6.LAUNCHES == {**before, kind: before[kind] + data.obs_ids.shape[0]}
    assert torch.equal(out.n_landmarks, ref.n_landmarks) and int(out.n_landmarks[-1]) > 0
    assert torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids)
    torch.testing.assert_close(out.trajectory, ref.trajectory, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.final_state.sigma, ref.final_state.sigma, atol=1e-4,
                               rtol=5e-3)


def _k2_case(dev, max_lm, B=3, T=10, seed=0, n_lms=None, M=16):
    """B lanes of ``_k6_case`` (``max_lm - 2`` landmarks, so inserts drop,
    or lane b's ``n_lms[b]``; frames of M observations), lane 1 not yet
    initialized, with T encoder ticks each (as strided views of one [B, T,
    2] tensor, as the replay hands them over)."""
    n_lms = n_lms or (max_lm - 2,) * B
    lanes = [_k6_case(dev, max_lm, n_lms[b], seed + b, M) for b in range(B)]
    cfg = lanes[0][0]
    state = ekf.EkfState(*(torch.cat(x) for x in zip(*(st for _, st, _ in lanes))))
    state = state._replace(initialized=torch.arange(B, device=dev) != 1)
    frame = ekf.FrameObservations(*(torch.cat(x) for x in zip(*(fr for _, _, fr in lanes))))
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.uniform(-1.0, 3.0, (B, T, 2)).astype(np.float32), device=dev)
    dt = torch.as_tensor(rng.uniform(0.005, 0.02, (B, T)).astype(np.float32), device=dev)
    return cfg, state, frame, ekf.Control(w[..., 0], w[..., 1], dt)


# Lanes of different active sizes: each lane's landmarks (mixed cases only).
# At 512 slots the first and last lanes' active blocks (1,215 and 1,539
# rows) pass what a 16-CTA cluster holds on chip (912 rows), so they run in
# device memory (the L2 branch) beside a lane on chip.
_MIXED = {128: (100, 20, 126), 512: (400, 60, 510)}


_K2_SIZES = [(8, "smem"), (kb.MAX_SMEM_LANDMARKS, "smem"), (100, "cluster"),
             (kb.MAX_CLUSTER_LANDMARKS + 1, "device"), (128, "cluster"), (512, "device")]
# Frames of 257, 300 and 0 observation slots in each variant.
_K2_FRAMES = ([pytest.param(lm, kind, 16, id=f"{lm}-{kind}") for lm, kind in _K2_SIZES]
              + [pytest.param(lm, kind, m, id=f"{lm}-{kind}-M{m}")
                 for lm, kind in ((8, "smem"), (128, "cluster"), (512, "device"))
                 for m in (257, 300, 0)])


@pytest.mark.parametrize("max_lm,kind,M", _K2_FRAMES)
@pytest.mark.parametrize("ticks", [10, 0])
def test_frame_step_variants_match_plain(dev, max_lm, kind, M, ticks):
    """K2 in each variant against its plain version on one frame of known,
    new, gated, dropped and invalid observations, with and without encoder
    ticks, one lane uninitialized; the replay rows it writes; exactly one
    device event per call. The cluster and device variants also at the
    fewest CTAs a lane, and with lanes of different active sizes, the
    device variant's largest in device memory. Each variant also on frames
    of 257 and 300 observation slots (ids repeated) and of none."""
    cfg, state, frame, controls = _k2_case(dev, max_lm, T=ticks, n_lms=_MIXED.get(max_lm), M=M)
    n = 3 + 3 * max_lm
    assert kb.variant(n)[0] == kind and frame.ids.shape[1] == M
    B, F = state.mu.shape[0], 4
    if max_lm == 512:
        na = 3 + 3 * torch.clamp(state.n_landmarks + _n_new(state, frame), max=max_lm)
        rows_on_chip = kb.on_chip_rows(kind, n, M, kb.variant(n, B)[1])
        assert (na > rows_on_chip).tolist() == [True, False, True]

    def rows():
        return kb.Rows(torch.zeros(B, F, 3, device=dev), torch.zeros(B, F, 3, 3, device=dev),
                       torch.zeros(B, F, dtype=torch.int32, device=dev), 2)

    ref_rows = rows()
    ref = kb.frame_step_reference(state, frame, controls, cfg, rows=ref_rows)
    choices = [None] if kind == "smem" else [None, (kind, kb.min_ctas(kind, n))]
    for choice in choices:
        got_rows = rows()
        before = dict(kb.LAUNCHES)
        if choice is None:
            out = kb.frame_step_batched(state, frame, controls, cfg, rows=got_rows)
        else:
            out = kb._launch(state, frame, controls, cfg, None, got_rows, choice)
        torch.cuda.synchronize()
        assert kb.LAUNCHES == {**before, kind: before[kind] + 1}
        for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged",
                     "dropped"):
            assert torch.equal(getattr(out, name), getattr(ref, name)), (name, choice)
        assert (int(out.dropped.sum()) > 0) == (M > 0) and bool(out.initialized.all())
        for name in ("mu", "sigma", "last_obs"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=5e-5,
                                       rtol=5e-3)
        assert torch.equal(got_rows.n_landmarks, ref_rows.n_landmarks)
        for a, b in zip(got_rows[:2], ref_rows[:2]):
            torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-3)
    assert _device_events_per_call(lambda: kb.frame_step_batched(state, frame, controls,
                                                                 cfg)) == 1


def test_slam_system_on_the_card_matches_the_cpu(dev):
    """The same calls on a card system (K6, K3) and a CPU one (plain)."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=2.0, seed=4, max_obs=8))
    img = renderer.render_poses([(2.55, -2.0, 1.2)], synthetic.make_arena(n_markers=20), cam,
                                device="cpu")[0].numpy()
    systems = [SlamSystem(CFG, camera=cam, device=d) for d in (dev, "cpu")]
    epf = seq.enc_per_frame
    before = k6.LAUNCHES["cluster"]
    for f in range(seq.num_frames):
        for e in range(epf):
            for s in systems:
                s.add_encoder(*seq.enc_w[f * epf + e], seq.enc_dt[f * epf + e])
        for s in systems:
            s.add_observations(seq.obs_ids[f], seq.obs_z[f], seq.obs_R[f], seq.obs_valid[f])
    for s in systems:
        s.add_image(img)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["cluster"] == before + seq.num_frames + 1
    gpu, cpu = systems
    np.testing.assert_allclose(gpu.pose(), cpu.pose(), atol=1e-4)
    np.testing.assert_array_equal(gpu.landmark_map()[1], cpu.landmark_map()[1])
    np.testing.assert_allclose(gpu.landmark_map()[0], cpu.landmark_map()[0], atol=1e-4)
    assert [d["id"] for d in gpu.detected_markers()] == [d["id"] for d in cpu.detected_markers()]
    assert len(gpu.detected_markers()) >= 1


def test_dryrun_two_ranks_share_the_card(dev):
    """Two ranks on one card take gloo and run every multi-rank leg
    (sharded replay, the distributed solve, sharded detection) there."""
    from aruco_slam_tpu_torch.parallel import dryrun

    runs = dryrun.dryrun_multichip(2)
    assert [r.device.type for r in runs] == ["cuda", "cuda"]
    np.testing.assert_array_equal(runs[0].ba_history, runs[1].ba_history)
    assert runs[0].ba_history[-1] < runs[0].ba_history[0]
    assert all(r.detections > 0 and r.image_replay_shape[0] == 2 for r in runs)


def test_detect_frames_asq_on_the_card(dev, tmp_path):
    """Frames streamed from an .asq onto the card detect as the same frames
    held in memory, bit for bit (the chunk buffer is refilled only after
    its copy has landed)."""
    from aruco_slam_tpu_torch.io import native_seqio

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=4.0, seed=2), level="images",
                                      camera=cam, device=dev)
    path = str(tmp_path / "frames.asq")
    native_seqio.write_frames(path, seq.images)
    got = runner.detect_frames_asq(path, chunk=8, device=dev)
    want = runner.detect_frames(torch.as_tensor(seq.images, device=dev), chunk=8)
    assert got[0].device.type == "cuda"
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].any())
