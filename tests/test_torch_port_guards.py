"""Guards of the PyTorch port: it never imports JAX, sets true-float32
matmuls, refuses to build without nvcc, validates kernel inputs before any
launch, sends a non-CPU tensor only to a kernel (no plain fallback), raises
on a refused launch without trying another kernel variant, gives a frame
wider than the EKF kernels' shared slots its workspace in device memory,
and puts what its entry points make on the card unless told otherwise."""

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import numpy as np

import aruco_slam_tpu_torch
import torch_dist_ranks
from aruco_slam_tpu_torch import bench, convert, pipeline, runner
from aruco_slam_tpu_torch.io import native_seqio
from aruco_slam_tpu_torch.models import ekf, graph_builder, pose_graph
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.kernels import (
    _build, ccl, ekf_update, ekf_update_batched, pnp_frontend, probes,
)
from aruco_slam_tpu_torch.parallel import dryrun, launch, mesh
from aruco_slam_tpu_torch.sim import renderer, synthetic
from aruco_slam_tpu_torch.system import SlamSystem
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = SlamConfig(ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=3))
CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)


def test_port_imports_no_jax_and_no_yaml():
    code = (
        "import sys\n"
        "import aruco_slam_tpu_torch, aruco_slam_tpu_torch.runner, "
        "aruco_slam_tpu_torch.sim.synthetic, aruco_slam_tpu_torch.convert, "
        "aruco_slam_tpu_torch.ops.detector, aruco_slam_tpu_torch.ops.dictionary, "
        "aruco_slam_tpu_torch.ops.kernels.ccl, aruco_slam_tpu_torch.ops.kernels.probes, "
        "aruco_slam_tpu_torch.sim.renderer, "
        "aruco_slam_tpu_torch.system, aruco_slam_tpu_torch.viz, "
        "aruco_slam_tpu_torch.ops.kernels.ekf_update, aruco_slam_tpu_torch.utils.device, "
        "aruco_slam_tpu_torch.models.ba, aruco_slam_tpu_torch.models.graph_builder, "
        "aruco_slam_tpu_torch.models.pose_graph, aruco_slam_tpu_torch.pipeline, "
        "aruco_slam_tpu_torch.io.checkpoint, aruco_slam_tpu_torch.utils.logging, "
        "aruco_slam_tpu_torch.cli, aruco_slam_tpu_torch.parallel.mesh, "
        "aruco_slam_tpu_torch.parallel.launch, aruco_slam_tpu_torch.parallel.dist_ba, "
        "aruco_slam_tpu_torch.parallel.dryrun, aruco_slam_tpu_torch.io.native_seqio, "
        "aruco_slam_tpu_torch.demo, aruco_slam_tpu_torch.bench, "
        "aruco_slam_tpu_torch.utils.reference_ekf\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'yaml', 'aruco_slam_tpu')"
        " or m.startswith(('jax.', 'jaxlib.', 'aruco_slam_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_precision_flags_set_on_import():
    assert aruco_slam_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_build_without_nvcc_names_the_compiler(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    for name in ("pnp_frontend", "ccl", "ekf_frame_update", "probes"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load(name)
    assert not (tmp_path / "build").exists()


def _k2_args(B=2, M=3, T=2, device="cpu"):
    state = ekf.init_state(CFG, B, device)
    f32 = dict(dtype=torch.float32, device=device)
    frame = ekf.FrameObservations(
        torch.full((B, M), -1, dtype=torch.int32, device=device), torch.zeros(B, M, 3, **f32),
        torch.eye(3, **f32).repeat(B, M, 1, 1), torch.zeros(B, M, dtype=torch.bool, device=device),
    )
    ticks = torch.ones(B, T, 3, **f32)  # wl, wr, dt as strided views of one tensor
    controls = ekf.Control(ticks[..., 0], ticks[..., 1], 0.01 * ticks[..., 2])
    return dict(state=state, frame=frame, controls=controls, config=CFG)


def test_frame_step_rejects_bad_inputs():
    ok = _k2_args()
    out = ekf_update_batched.frame_step_batched(**ok)
    assert out.n_landmarks.tolist() == [0, 0] and out.initialized.tolist() == [True, True]
    frame, state = ok["frame"], ok["state"]
    with pytest.raises(TypeError, match="ids"):
        ekf_update_batched.frame_step_batched(**{**ok, "frame": frame._replace(ids=frame.ids.long())})
    sig = state.sigma
    strided = sig.transpose(1, 2)  # same shape (square), not contiguous
    assert strided.shape == sig.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="sigma"):
        ekf_update_batched.frame_step_batched(**{**ok, "state": state._replace(sigma=strided)})
    with pytest.raises(ValueError, match="z must be"):
        ekf_update_batched.frame_step_batched(**{**ok, "frame": frame._replace(z=frame.z[:, :2])})
    with pytest.raises(ValueError, match="wl must be"):
        ekf_update_batched.frame_step_batched(
            **{**ok, "controls": ok["controls"]._replace(wl=ok["controls"].wl[:, :1])})
    with pytest.raises(ValueError, match="max_landmarks"):
        ekf_update_batched.frame_step_batched(
            **{**ok, "config": SlamConfig(ekf=EkfConfig(max_landmarks=5))})
    rows = ekf_update_batched.Rows(torch.zeros(2, 4, 3), torch.zeros(2, 4, 3, 3),
                                   torch.zeros(2, 4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="outside"):
        ekf_update_batched.frame_step_batched(**ok, rows=rows)
    with pytest.raises(TypeError, match="rows.n_landmarks"):
        ekf_update_batched.frame_step_batched(
            **ok, rows=rows._replace(n_landmarks=rows.n_landmarks.long(), f=0))
    with pytest.raises(ValueError, match="out.sigma"):
        ekf_update_batched.frame_step_batched(
            **ok, out=state._replace(sigma=torch.zeros(2, 15, 14)))
    spare = ekf.init_state(CFG, 2, "cpu")
    with pytest.raises(ValueError, match="share memory"):
        ekf_update_batched.frame_step_batched(**ok, out=spare._replace(slot_ids=state.slot_ids))
    with pytest.raises(ValueError, match="share memory"):
        ekf_update_batched.frame_step_batched(**ok, out=state)
    assert ekf_update_batched.frame_step_batched(**ok, out=spare) is spare


def _k6_args(B=1, M=3, device="cpu"):
    state = ekf.init_state(CFG, B, device)
    frame = ekf.FrameObservations(
        torch.full((B, M), -1, dtype=torch.int32, device=device),
        torch.zeros(B, M, 3, device=device), torch.zeros(B, M, 3, 3, device=device),
        torch.zeros(B, M, dtype=torch.bool, device=device),
    )
    return state, frame


def test_frame_update_rejects_bad_inputs():
    state, frame = _k6_args()
    out = ekf_update.frame_update(state, frame, CFG)
    assert out.n_landmarks.tolist() == [0]
    with pytest.raises(ValueError, match="single-stream"):
        ekf_update.frame_update(*_k6_args(B=2), CFG)
    with pytest.raises(TypeError, match="ids"):
        ekf_update.frame_update(state, frame._replace(ids=frame.ids.long()), CFG)
    with pytest.raises(ValueError, match="max_landmarks"):
        ekf_update.frame_update(state, frame, SlamConfig(ekf=EkfConfig(max_landmarks=5)))
    with pytest.raises(ValueError, match="sigma"):
        ekf_update.frame_update(state._replace(sigma=state.sigma.transpose(1, 2)), frame, CFG)


def test_frame_step_rejects_bad_inputs():
    """K6's frame step checks the ticks, the rows, the observations' frame
    axis (one frame, or every frame of the replay with rows) and what
    ``out`` shares with the state."""
    state, frame = _k6_args()
    ticks = ekf.Control(torch.ones(1, 2), torch.ones(1, 2), torch.full((1, 2), 0.1))
    rows = ekf_update.Rows(torch.zeros(4, 3), torch.zeros(4, 3, 3),
                           torch.zeros(4, dtype=torch.int32), 3)
    out = ekf_update.frame_step(state, frame, ticks, CFG, rows=rows)
    assert bool(out.initialized[0]) and int(rows.n_landmarks[3]) == 0
    with pytest.raises(TypeError, match="dt"):
        ekf_update.frame_step(state, frame, ticks._replace(dt=ticks.dt.double()), CFG)
    with pytest.raises(ValueError, match="wl"):
        ekf_update.frame_step(state, frame, ticks._replace(wl=torch.ones(2, 2)), CFG)
    with pytest.raises(ValueError, match="outside"):
        rows.f = 4
        ekf_update.frame_step(state, frame, ticks, CFG, rows=rows)
    rows.f = 0
    with pytest.raises(TypeError, match="rows.n_landmarks"):
        ekf_update.frame_step(state, frame, ticks, CFG, rows=ekf_update.Rows(
            rows.trajectory, rows.pose_cov, rows.n_landmarks.long()))
    two = ekf.FrameObservations(*(torch.cat([x, x]) for x in frame))
    with pytest.raises(ValueError, match="one, or with rows"):
        ekf_update.frame_step(state, two, ticks, CFG)
    with pytest.raises(ValueError, match="one, or with rows"):
        ekf_update.frame_step(state, two, ticks, CFG, rows=rows)
    spare = ekf.init_state(CFG, 1, "cpu")
    with pytest.raises(ValueError, match="share only mu and sigma"):
        ekf_update.frame_step(state, frame, ticks, CFG, out=spare._replace(
            slot_ids=state.slot_ids))
    with pytest.raises(ValueError, match="share only mu and sigma"):
        ekf_update.frame_step(state, frame, ticks, CFG, out=spare._replace(
            sigma=state.sigma.view(state.sigma.shape)))
    in_place = spare._replace(mu=state.mu, sigma=state.sigma)
    assert ekf_update.frame_step(state, frame, ticks, CFG, out=in_place) is not in_place
    with pytest.raises(ValueError, match="no kernel"):
        ekf_update.frame_step(*_k6_args(device="meta"), ekf.Control(
            *(torch.ones(1, 2, device="meta") for _ in range(3))), CFG)


def test_pnp_frontend_rejects_bad_inputs():
    corners = torch.zeros(2, 3, 4, 2)
    valid = torch.zeros(2, 3, dtype=torch.bool)
    with pytest.raises(TypeError, match="float32"):
        pnp_frontend.pnp_frontend_batch(corners.double(), valid, CAM, CFG)
    with pytest.raises(TypeError, match="bool"):
        pnp_frontend.pnp_frontend_batch(corners, valid.int(), CAM, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        pnp_frontend.pnp_frontend_batch(corners.transpose(0, 1).contiguous().transpose(0, 1),
                                        valid, CAM, CFG)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to a kernel or raises: 'meta' has none."""
    before = (pnp_frontend.LAUNCHES, ekf_update_batched.LAUNCHES, dict(ekf_update.LAUNCHES))
    with pytest.raises(ValueError, match="no kernel"):
        pnp_frontend.pnp_frontend_batch(
            torch.zeros(2, 3, 4, 2, device="meta"),
            torch.zeros(2, 3, dtype=torch.bool, device="meta"), CAM, CFG,
        )
    with pytest.raises(ValueError, match="no kernel"):
        ekf_update_batched.frame_step_batched(**_k2_args(device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ekf_update.frame_update(*_k6_args(device="meta"), CFG)
    assert (pnp_frontend.LAUNCHES, ekf_update_batched.LAUNCHES,
            dict(ekf_update.LAUNCHES)) == before


def test_ccl_wrappers_reject_bad_inputs():
    img = torch.zeros(2, 64, 128, dtype=torch.uint8)
    fg = torch.zeros(2, 64, 128, dtype=torch.bool)
    with pytest.raises(TypeError, match="uint8 or float32"):
        ccl.threshold_label_union(img.int(), 7, 7.0, 4, 3, 2)
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        ccl.threshold_label(img[0], 7, 7.0, 4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ccl.threshold_label(img.transpose(1, 2), 7, 7.0, 4, 3)
    with pytest.raises(ValueError, match="power-of-two"):
        ccl.threshold_label_union(img, 7, 7.0, 3, 3, 2)
    with pytest.raises(TypeError, match="bool"):
        ccl.label_components(fg.to(torch.uint8), 3)
    with pytest.raises(TypeError, match="int32"):
        ccl.label_components(fg, 2, init=torch.zeros(2, 64, 128, dtype=torch.int64))
    with pytest.raises(ValueError, match="init must be"):
        ccl.label_components(fg, 2, init=torch.zeros(2, 64 * 128, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    probes.copy_to_int32, probes.scale_copy, lambda img: ccl.threshold_only(img, 7, 7.0, 4),
], ids=["copy_to_int32", "scale_copy", "threshold_only"])
def test_probe_wrappers_reject_bad_inputs(call):
    """The probes' wrappers raise on a wrong type, a wrong rank, a
    non-contiguous chunk and a tensor that is neither on the CPU nor on a
    card, before any launch."""
    img = torch.zeros(2, 64, 128)
    before = (dict(probes.LAUNCHES), dict(ccl.LAUNCHES))
    with pytest.raises(TypeError, match="float32"):
        call(img.to(torch.float64))
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        call(img[0])
    with pytest.raises(ValueError, match="contiguous"):
        call(img.transpose(1, 2))
    with pytest.raises(ValueError, match="no kernel"):
        call(torch.zeros(2, 64, 128, device="meta"))
    assert (probes.LAUNCHES, ccl.LAUNCHES) == before


def test_threshold_label_refuses_a_plan_the_frame_cannot_take(monkeypatch):
    """K4's plan argument. On the CPU the plain version runs and reads no
    plan. On the card the plan's geometry reaches csrc ``block_launch`` as
    it is, and its refusal of a plan the chunk cannot take raises with no
    launch counted (the card's own refusals: ``test_torch_cuda.py``). A
    frame the cluster body takes refuses a plan before any launch."""
    img = torch.zeros(2, 48, 40, dtype=torch.uint8)  # the block body's
    assert ccl.body(48, 40, 4) == "block"
    bad = ccl.spilled_plan(48, 40)._replace(teams=2)
    want = ccl.threshold_label_reference(img, 7, 7.0, 4, 3)
    got = ccl.threshold_label(img, 7, 7.0, 4, 3, plan=bad)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    lib = _RefusingCcl()
    _as_if_on_the_card(monkeypatch, ccl, lib)
    monkeypatch.setattr(ccl, "_route", lambda t: True)
    monkeypatch.setattr(ccl, "_block_sms", {})
    monkeypatch.setattr(ccl, "_barriers", {})
    before = dict(ccl.LAUNCHES)
    with pytest.raises(RuntimeError, match="block body.*out of memory"):
        ccl.threshold_label(img, 7, 7.0, 4, 3, plan=bad)
    rows, width, teams, ctas, _, _, _, work_words, _ = lib.block_args[-1]
    assert (rows, width, teams, ctas, work_words) == (
        bad.tile_rows, bad.tile_width, bad.teams, bad.ctas, bad.work_words)
    with pytest.raises(ValueError, match="cluster body"):
        ccl.threshold_label(torch.zeros(2, 64, 256, dtype=torch.uint8), 7, 7.0, 4, 3,
                            plan=ccl.spilled_plan(64, 256))
    assert lib.bodies == [0]
    assert ccl.LAUNCHES == before


def test_ccl_wrappers_never_fall_back():
    """Off the CPU the CCL family launches its kernel or raises."""
    before = dict(ccl.LAUNCHES)
    img = torch.zeros(2, 64, 128, dtype=torch.uint8, device="meta")
    fg = torch.zeros(2, 64, 128, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2)
    with pytest.raises(ValueError, match="no kernel"):
        ccl.threshold_label(img, 7, 7.0, 4, 3)
    with pytest.raises(ValueError, match="no kernel"):
        ccl.threshold_only(img, 7, 7.0, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ccl.label_components(fg, 3)
    with pytest.raises(ValueError, match="init on"):
        ccl.label_components(fg, 2, init=torch.zeros(2, 64, 128, dtype=torch.int32))
    assert ccl.LAUNCHES == before


class _RefusingK6:
    """K6's library with plans that succeed and launches that are refused."""

    def __init__(self):
        self.calls = []

    def ekf_frame_update_cluster_plan(self, N, M, G, W, smem, count):
        W._obj.value, smem._obj.value, count._obj.value = -(-N // G), 1024, 4
        return 0

    def ekf_frame_update_grid_plan(self, N, M, G, W, cap, smem):
        G._obj.value, W._obj.value, smem._obj.value = 8, -(-N // 8), 1024
        cap._obj.value = N * W._obj.value
        return 0

    def ekf_frame_update_launch(self, args):
        self.calls.append(("cluster", "grid")[args._obj.variant])
        return 2  # cudaErrorMemoryAllocation

    def ekf_frame_update_error_string(self, err):
        return b"out of memory"


class _RefusingCcl:
    """The CCL family's library: plans succeed, launches are refused."""

    def __init__(self):
        self.bodies, self.block_args = [], []

    def ccl_cluster_plan(self, variant, h, w, stride, smem, count):
        smem._obj.value, count._obj.value = 1024, 4
        return 0

    def ccl_block_plan(self, variant, sms):
        sms._obj.value = ccl.H100_SMS
        return 0

    def _launch(self, *args):
        self.bodies.append(args[-2])  # ..., the block body's 9 arguments, body, stream
        self.block_args.append(args[-11:-2])
        return 2

    ccl_threshold_union_launch = ccl_threshold_launch = ccl_threshold_only_launch = _launch
    ccl_label_launch = ccl_label_seeded_launch = _launch

    def ccl_error_string(self, err):
        return b"out of memory"


def _as_if_on_the_card(monkeypatch, module, lib):
    """Drive a wrapper's launch path with CPU tensors and a stand-in library."""
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "_plans", type(module._plans)())
    monkeypatch.setattr(module, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("max_lm,kind", [(64, "cluster"), (400, "grid")])
def test_refused_k6_launch_raises_and_tries_no_other_variant(monkeypatch, max_lm, kind):
    lib = _RefusingK6()
    _as_if_on_the_card(monkeypatch, ekf_update, lib)
    monkeypatch.setattr(ekf_update, "_workspaces", {})
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    state = ekf.init_state(cfg, 1, "cpu")
    _, frame = _k6_args()
    assert ekf_update.variant(3 + 3 * max_lm)[0] == kind
    before = dict(ekf_update.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{kind} launch.*out of memory"):
        ekf_update._launch(state, frame, cfg, ekf_update.variant(3 + 3 * max_lm))
    assert lib.calls == [kind]
    assert ekf_update.LAUNCHES == before


@pytest.mark.parametrize("max_lm,kind", [(64, "cluster"), (400, "grid")])
def test_refused_k6_frame_step_raises_and_keeps_no_replay(monkeypatch, max_lm, kind):
    """A refused frame step raises, tries no other variant and counts no
    launch, through ``frame_step``'s launch and through a replay's first
    frame; the refused replay keeps the caller's state, and its next call
    launches the first frame again."""
    lib = _RefusingK6()
    _as_if_on_the_card(monkeypatch, ekf_update, lib)
    monkeypatch.setattr(ekf_update, "_workspaces", {})
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    state = ekf.init_state(cfg, 1, "cpu")
    frame = ekf.FrameObservations(*(torch.cat([x, x]) for x in _k6_args()[1]))
    ticks = ekf.Control(*(torch.ones(2, 4) for _ in range(3)))
    rows = ekf_update.Rows(torch.zeros(2, 3), torch.zeros(2, 3, 3),
                           torch.zeros(2, dtype=torch.int32))
    before = dict(ekf_update.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{kind} launch.*out of memory"):
        ekf_update._launch(state, frame, cfg, ekf_update.variant(3 + 3 * max_lm), ticks,
                           None, rows)
    rep = ekf_update.replay_step(state, frame, ticks, cfg, rows)
    rep._on_card()
    for _ in range(2):
        with pytest.raises(RuntimeError, match=f"{kind} launch.*out of memory"):
            rep(0)
        assert rep.state is state
    assert lib.calls == [kind] * 3
    assert ekf_update.LAUNCHES == before


class _RecordingK6(_RefusingK6):
    """K6's library with launches that succeed and record their arguments."""

    def ekf_frame_update_launch(self, args):
        a = args._obj
        self.calls.append((a.f, a.state[1], a.out[1], a.state[2], a.out[2], a.obs_frames, a.T))
        return 0


@pytest.mark.parametrize("max_lm", [64, 400])
def test_replay_checks_once_and_steps_in_place(monkeypatch, max_lm):
    """A replay's frames through ``ekf_update.replay_step``, as if on the
    card: the inputs are checked once, when it is made; every frame then
    launches with the arguments made there, only the frame index changed
    (the time-major observations read at it); the first frame reads the
    caller's state, and from the second on sigma (and mu) are updated in
    place while the bookkeeping alternates between two sets. A frame
    outside the replay raises and launches nothing, and a replay is made
    only from every frame of its observations."""
    lib = _RecordingK6()
    _as_if_on_the_card(monkeypatch, ekf_update, lib)
    monkeypatch.setattr(ekf_update, "_workspaces", {})
    checks = []
    real_check = ekf_update._check_step
    monkeypatch.setattr(ekf_update, "_check_step", lambda *a: checks.append(1) or real_check(*a))
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    F = 5
    frames = ekf.FrameObservations(*(torch.cat([x] * F) for x in _k6_args()[1]))
    ticks = ekf.Control(*(torch.ones(F, 4) for _ in range(3)))
    rows = ekf_update.Rows(torch.zeros(F, 3), torch.zeros(F, 3, 3),
                           torch.zeros(F, dtype=torch.int32))
    state0 = ekf.init_state(cfg, 1, "cpu")
    kind = ekf_update.variant(3 + 3 * max_lm)[0]
    before = ekf_update.LAUNCHES[kind]
    rep = ekf_update.replay_step(state0, frames, ticks, cfg, rows)
    rep._on_card()
    states = [rep(f) for f in range(F)]
    assert ekf_update.LAUNCHES[kind] == before + F and len(checks) == 1
    assert [c[0] for c in lib.calls] == list(range(F)) and rows.f == F - 1
    assert all(c[5] == 1 and c[6] == 4 for c in lib.calls)  # frame f of the arrays, 4 ticks
    sig0 = state0.sigma.data_ptr()
    first = lib.calls[0]
    assert first[1] == sig0 and first[2] != sig0  # the caller's state is only read
    for c in lib.calls[1:]:
        assert c[1] == c[2] == first[2]  # sigma in place in the replay's own buffer
        assert c[3] != c[4]  # the bookkeeping never in place
    assert states[0] is states[2] is states[4] and states[1] is states[3]
    assert states[0] is not states[1] and states[0].sigma is states[1].sigma
    assert rep.state is states[-1]
    for f in (F, -1):
        with pytest.raises(ValueError, match="outside the replay"):
            rep(f)
    assert len(lib.calls) == F and ekf_update.LAUNCHES[kind] == before + F
    with pytest.raises(ValueError, match="every frame"):
        ekf_update.replay_step(state0, ekf.FrameObservations(*(x[:1] for x in frames)),
                               ekf.Control(*(x[:1] for x in ticks)), cfg, rows)


class _RefusingK2:
    """K2's library with plans that succeed and launches that are refused."""

    def __init__(self):
        self.calls = []

    def ekf_frame_batched_plan(self, variant, N, L, M, G, smem, resident):
        kind = ekf_update_batched.VARIANTS[variant]
        smem._obj.value = ekf_update_batched.shared_bytes(kind, N, L, M, G)
        resident._obj.value = 1
        return 0

    def ekf_frame_batched_launch(self, variant, *args):
        self.calls.append(ekf_update_batched.VARIANTS[variant])
        return 2  # cudaErrorMemoryAllocation

    def ekf_frame_batched_error_string(self, err):
        return b"out of memory"


class _WidthRecordingK6(_RefusingK6):
    """K6's library whose plans record the observations they are planned
    for and whose launches succeed and record (variant, M, scratch, slots)."""

    def __init__(self):
        super().__init__()
        self.planned_for = []

    def ekf_frame_update_cluster_plan(self, N, M, G, W, smem, count):
        self.planned_for.append(M)
        return super().ekf_frame_update_cluster_plan(N, M, G, W, smem, count)

    def ekf_frame_update_grid_plan(self, N, M, G, W, cap, smem):
        self.planned_for.append(M)
        return super().ekf_frame_update_grid_plan(N, M, G, W, cap, smem)

    def ekf_frame_update_launch(self, args):
        a = args._obj
        self.calls.append((("cluster", "grid")[a.variant], a.M, a.scratch, a.slots))
        return 0


@pytest.mark.parametrize("max_lm", [64, 400])
def test_k6_wide_frames_take_a_slot_workspace(monkeypatch, max_lm):
    """As if on the card: a frame of 256 observation slots or fewer
    launches as before (no slots in device memory; the grid's scratch
    alone); a wider one gets the prologue's slots and order, [CTAs, 2, M]
    int32 after the grid's scratch, made once per width and reused, with
    no check refusing it; every plan is made for MAX_SHARED_OBS slots."""
    lib = _WidthRecordingK6()
    _as_if_on_the_card(monkeypatch, ekf_update, lib)
    monkeypatch.setattr(ekf_update, "_workspaces", {})
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    state = ekf.init_state(cfg, 1, "cpu")
    choice = ekf_update.variant(3 + 3 * max_lm)
    ctas = 8 if choice[0] == "grid" else choice[1]  # the stand-in grid plan's CTAs
    head = ekf_update._grid_words(3 + 3 * max_lm) if choice[0] == "grid" else 0
    for M in (16, 256, 257, 300, 300):
        frame = ekf.FrameObservations(*(x.expand(1, M, *x.shape[2:]).contiguous()
                                        for x in _k6_args(M=1)[1]))
        ekf_update._launch(state, frame, cfg, choice)
    assert set(lib.planned_for) == {ekf_update.MAX_SHARED_OBS}
    assert [c[:2] for c in lib.calls] == [(choice[0], m) for m in (16, 256, 257, 300, 300)]
    assert all((c[2] is not None) == (choice[0] == "grid") for c in lib.calls)
    assert lib.calls[0][3] is None and lib.calls[1][3] is None
    assert lib.calls[3][3] == lib.calls[4][3] != lib.calls[2][3]
    for M, call in ((257, lib.calls[2]), (300, lib.calls[3])):
        ws = ekf_update._workspaces[(0, 0, choice[0], 3 + 3 * max_lm, M)]
        assert ws.numel() == head + 2 * ctas * M
        assert call[3] == ws.data_ptr() + 4 * head


class _RecordingK2(_RefusingK2):
    """K2's library with launches that succeed and record (variant, M,
    CTAs a lane, shared bytes, the slots' pointer)."""

    def ekf_frame_batched_launch(self, variant, ptrs, strides, fcfg, icfg, smem, stream):
        self.calls.append((ekf_update_batched.VARIANTS[variant], icfg[3], icfg[4], smem,
                           ptrs[28]))
        return 0


@pytest.mark.parametrize("max_lm", [32, 128, 400])
def test_k2_wide_frames_take_a_slot_workspace(monkeypatch, max_lm):
    """As if on the card: K2 at 256 observation slots or fewer launches with
    the shared bytes its layout always had (2M words of slots and order)
    and no slots in device memory; a wider frame gets [B, G, 2, M] int32 in
    device memory, made once per shape and reused, and its layout drops
    the slots' words; nothing refuses the width."""
    lib = _RecordingK2()
    _as_if_on_the_card(monkeypatch, ekf_update_batched, lib)
    monkeypatch.setattr(ekf_update_batched, "_workspaces", {})
    monkeypatch.setattr(ekf_update_batched, "_choices", {})
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    N, B = 3 + 3 * max_lm, 2
    kind = ekf_update_batched.variant(N)[0]
    for M in (16, 256, 257, 300, 300):
        args = _k2_args(B=B, M=M)
        ekf_update_batched._launch(ekf.init_state(cfg, B, "cpu"), args["frame"],
                                   args["controls"], cfg, None, None)
    assert [c[:2] for c in lib.calls] == [(kind, m) for m in (16, 256, 257, 300, 300)]
    for (_, M, ctas, smem, slots) in lib.calls:
        w = ekf_update_batched.stripe_width(N, ctas)
        fixed = {"smem": N * N + 8 * N + 384 + 21 + 3 * max_lm + (max_lm + 3) // 4,
                 "cluster": N * w + 7 * w + 3 * N + 73 + 21}.get(kind)
        words = 2 * M if M <= 256 else 0
        assert smem == (ekf_update_batched.MAX_SHARED_BYTES if fixed is None
                        else 4 * (fixed + words))
        if M <= 256:
            assert slots is None
        else:
            ws = ekf_update_batched._workspaces[(0, 0, B, ctas, M)]
            assert ws.dtype == torch.int32 and ws.numel() == B * ctas * 2 * M
            assert slots == ws.data_ptr()
    assert lib.calls[3][4] == lib.calls[4][4] != lib.calls[2][4]


@pytest.mark.parametrize("max_lm,kind", [(32, "smem"), (128, "cluster"), (400, "device")])
def test_refused_k2_launch_raises_and_tries_no_other_variant(monkeypatch, max_lm, kind):
    """A refused K2 launch raises in every variant: no other variant and no
    plain version runs, and nothing is counted as launched."""
    lib = _RefusingK2()
    _as_if_on_the_card(monkeypatch, ekf_update_batched, lib)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=3))
    args = _k2_args()
    choice = ekf_update_batched.variant(3 + 3 * max_lm)
    assert choice[0] == kind
    before = dict(ekf_update_batched.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{kind} launch.*out of memory"):
        ekf_update_batched._launch(ekf.init_state(cfg, 2, "cpu"), args["frame"],
                                   args["controls"], cfg, None, None, choice)
    assert lib.calls == [kind]
    assert ekf_update_batched.LAUNCHES == before


@pytest.mark.parametrize("shape,kind", [((64, 256), "cluster"), ((48, 40), "block")])
def test_refused_ccl_launch_raises_and_tries_no_other_body(monkeypatch, shape, kind):
    lib = _RefusingCcl()
    _as_if_on_the_card(monkeypatch, ccl, lib)
    monkeypatch.setattr(ccl, "_route", lambda t: True)
    monkeypatch.setattr(ccl, "_block_sms", {})
    monkeypatch.setattr(ccl, "_barriers", {})
    img = torch.zeros(2, *shape, dtype=torch.uint8)
    fg = torch.zeros(2, *shape, dtype=torch.bool)
    assert ccl.body(*shape, 4) == ccl.body(*shape) == kind
    before = dict(ccl.LAUNCHES)
    calls = (
        lambda: ccl.threshold_label_union(img, 7, 7.0, 4, 3, 2),
        lambda: ccl.threshold_label(img, 7, 7.0, 4, 3),
        lambda: ccl.label_components(fg, 3),
        lambda: ccl.label_components(fg, 2, init=torch.zeros(2, *shape, dtype=torch.int32)),
        lambda: ccl.threshold_only(img, 7, 7.0, 4),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match=f"{kind} body.*out of memory"):
            call()
    assert lib.bodies == [int(kind == "cluster")] * 5
    assert ccl.LAUNCHES == before


def test_shared_memory_budget():
    """K2's smem variant holds the main path's lane (N = 99) in 46,456
    bytes and every map up to 77 landmarks; its cluster variant reaches as
    far as K6's; beyond that the device variant takes every size, on 16
    CTAs for one lane."""
    assert ekf_update_batched.shared_bytes("smem", 99, 32) == 46_456  # main path: N = 99
    assert ekf_update_batched.MAX_SMEM_LANDMARKS == 77
    assert ekf_update_batched.MAX_CLUSTER_LANDMARKS == ekf_update.MAX_CLUSTER_LANDMARKS == 308
    assert ekf_update_batched.variant(3 + 3 * 309) == ("device", 16)


def test_lookup_slots_never_argmaxes_bool(monkeypatch):
    real = torch.argmax

    def strict(x, *a, **k):
        if x.dtype == torch.bool:
            raise RuntimeError("argmax(): does not support bool input")
        return real(x, *a, **k)

    monkeypatch.setattr(torch, "argmax", strict)
    slot_ids = torch.tensor([[4, 9, -1, -1], [7, -1, -1, -1]], dtype=torch.int32)
    ids = torch.tensor([[9, 5, 4], [-1, 7, 3]], dtype=torch.int32)
    out = ekf.lookup_slots(slot_ids, ids)
    assert out.dtype == torch.int32
    assert out.tolist() == [[1, -1, 0], [1, 0, -1]]


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # hide any card: the script must refuse
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env,
    )


def test_chip_smoke_refuses_without_gpu(tmp_path):
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_backend_rule_never_puts_two_ranks_of_one_card_on_nccl(monkeypatch):
    """nccl only where every rank has a card of its own; gloo on the CPU
    and for ranks that share a card; nccl asked for more ranks than cards
    raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.backend_for(1, "cuda") == "nccl"
    assert mesh.backend_for(2, "cuda") == "gloo"
    assert mesh.backend_for(4, "cuda") == "gloo"
    assert mesh.backend_for(4, "cpu") == "gloo"
    assert [mesh.rank_device(r, "cuda").index for r in range(4)] == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="card per rank"):
        mesh.init(1, 2, "nccl", "cuda", "file:///nonexistent/store")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.backend_for(4, "cuda") == "nccl"
    assert mesh.backend_for(8, "cuda") == "gloo"
    assert [mesh.rank_device(r, "cuda").index for r in range(4)] == [0, 1, 2, 3]
    assert not torch.distributed.is_initialized()


def test_failed_group_init_raises(monkeypatch, tmp_path):
    """A group that cannot be made raises, in this process and in spawned
    ranks; nothing runs on the CPU instead."""
    store = f"file://{tmp_path}/store"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init(0, 1, init_method=store)  # device None: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(torch_dist_ranks.hang, 1, args=(0,))
    with pytest.raises(ValueError, match="nccl"):
        mesh.init(0, 1, "nccl", "cpu", store)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match=r"(?s)rank \d exited.*nccl needs every rank on a card"):
        launch.run_ranks(torch_dist_ranks.hang, 2, "nccl", "cpu", args=(0,), timeout=120)


def _seq():
    return synthetic.generate_sequence(synthetic.SimParams(duration=0.5, max_obs=3))


def _detect_asq():
    with tempfile.TemporaryDirectory() as d:
        native_seqio.write_frames(f"{d}/frames.asq", np.zeros((2, 48, 64), np.uint8))
        return runner.detect_frames_asq(f"{d}/frames.asq")


ENTRY_POINTS = {
    "init_state": lambda: ekf.init_state(CFG, 1),
    "replay_sharded": lambda: runner.replay_sharded(
        runner.build_batch_data([_seq()], 2, device="cpu"), CFG),
    "detect_frames_asq": _detect_asq,
    "dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
    "entry": lambda: dryrun.entry()[1][0].mu,
    "bench.build_data": lambda: bench.build_data(2, 0.5, CAM, distinct=1)[0].obs_ids,
    "replay_data_from_sequence": lambda: runner.replay_data_from_sequence(_seq()),
    "build_batch_data": lambda: runner.build_batch_data([_seq()], 2),
    "replay_sequence": lambda: runner.replay_sequence(_seq(), CFG),
    "render_poses": lambda: renderer.render_poses(
        np.zeros((1, 3)), synthetic.make_arena(4), CAM, height=8, width=8),
    "ekf_state_from_numpy": lambda: convert.ekf_state_from_numpy(ekf.init_state(CFG, 1, "cpu")),
    "SlamSystem": lambda: SlamSystem(CFG).state,
    "ekf_then_ba": lambda: pipeline.ekf_then_ba(_seq(), CFG, ba_iters=1, cg_iters=1)["poses"],
    "ekf_then_pose_graph": lambda: pipeline.ekf_then_pose_graph(
        _seq(), CFG, iters=1, cg_iters=1)["poses"],
    "pose_graph.solve": lambda: pose_graph.solve(
        pose_graph.build(np.zeros((3, 3)), np.zeros((2, 3))), iters=1, cg_iters=1),
    "ba_problem_from_numpy": lambda: convert.ba_problem_from_numpy(
        graph_builder.synthetic_ba_problem(4, 2, obs_per_kf=1)[0]).poses,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Called without ``device``, an entry point makes its tensors on the
    card, and where there is none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        out = ENTRY_POINTS[name]()
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ENTRY_POINTS[name]()
