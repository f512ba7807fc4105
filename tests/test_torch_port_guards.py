"""Guards of the PyTorch port: it never imports JAX, sets true-float32
matmuls, refuses to build without nvcc, validates kernel inputs before any
launch, sends a non-CPU tensor only to a kernel (no plain fallback), and
puts what its entry points make on the card unless told otherwise."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

import aruco_slam_tpu_torch
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.kernels import (
    _build, ccl, ekf_update, ekf_update_batched, pnp_frontend,
)
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
        "aruco_slam_tpu_torch.ops.kernels.ccl, aruco_slam_tpu_torch.sim.renderer, "
        "aruco_slam_tpu_torch.system, aruco_slam_tpu_torch.viz, "
        "aruco_slam_tpu_torch.ops.kernels.ekf_update, aruco_slam_tpu_torch.utils.device\n"
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
    for name in ("pnp_frontend", "ccl", "ekf_frame_update"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load(name)
    assert not (tmp_path / "build").exists()


def _k2_args(B=2, M=3, device="cpu"):
    state = ekf.init_state(CFG, B, device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        state=state,
        pose=torch.zeros(B, 3, **f32),
        A=torch.eye(3, **f32).reshape(1, 9).repeat(B, 1),
        Q=torch.zeros(B, 9, **f32),
        ids=torch.full((B, M), -1, **i32),
        z=torch.zeros(B, M, 3, **f32),
        R9=torch.eye(3, **f32).reshape(1, 1, 9).repeat(B, M, 1),
        valid=torch.zeros(B, M, dtype=torch.bool, device=device),
        slots=torch.full((B, M), -1, **i32),
        config=CFG,
    )


def test_frame_step_rejects_bad_inputs():
    ok = _k2_args()
    out = ekf_update_batched.frame_step_batched(**ok)
    assert out.n_landmarks.tolist() == [0, 0]
    with pytest.raises(TypeError, match="slots"):
        ekf_update_batched.frame_step_batched(**{**ok, "slots": ok["slots"].long()})
    sig = ok["state"].sigma
    strided = sig.transpose(1, 2)  # same shape (square), not contiguous
    assert strided.shape == sig.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="sigma"):
        ekf_update_batched.frame_step_batched(
            **{**ok, "state": ok["state"]._replace(sigma=strided)}
        )
    with pytest.raises(ValueError, match="z must be"):
        ekf_update_batched.frame_step_batched(**{**ok, "z": ok["z"][:, :2]})


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
    before = (pnp_frontend.LAUNCHES, ekf_update_batched.LAUNCHES, ekf_update.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel"):
        pnp_frontend.pnp_frontend_batch(
            torch.zeros(2, 3, 4, 2, device="meta"),
            torch.zeros(2, 3, dtype=torch.bool, device="meta"), CAM, CFG,
        )
    with pytest.raises(ValueError, match="no kernel"):
        ekf_update_batched.frame_step_batched(**_k2_args(device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ekf_update.frame_update(*_k6_args(device="meta"), CFG)
    assert (pnp_frontend.LAUNCHES, ekf_update_batched.LAUNCHES, ekf_update.LAUNCHES) == before


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
        ccl.label_components(fg, 3)
    with pytest.raises(ValueError, match="init on"):
        ccl.label_components(fg, 2, init=torch.zeros(2, 64, 128, dtype=torch.int32))
    assert ccl.LAUNCHES == before


def test_shared_memory_budget():
    assert ekf_update_batched.shared_bytes(99, 32) == 43_668  # main path: N = 99
    fits = [
        lm for lm in range(1, 128)
        if ekf_update_batched.shared_bytes(3 + 3 * lm, lm) <= ekf_update_batched.MAX_SHARED_BYTES
    ]
    assert max(fits) == 77 and 64 in fits


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


def _seq():
    return synthetic.generate_sequence(synthetic.SimParams(duration=0.5, max_obs=3))


ENTRY_POINTS = {
    "init_state": lambda: ekf.init_state(CFG, 1),
    "replay_data_from_sequence": lambda: runner.replay_data_from_sequence(_seq()),
    "build_batch_data": lambda: runner.build_batch_data([_seq()], 2),
    "replay_sequence": lambda: runner.replay_sequence(_seq(), CFG),
    "render_poses": lambda: renderer.render_poses(
        np.zeros((1, 3)), synthetic.make_arena(4), CAM, height=8, width=8),
    "ekf_state_from_numpy": lambda: convert.ekf_state_from_numpy(ekf.init_state(CFG, 1, "cpu")),
    "SlamSystem": lambda: SlamSystem(CFG).state,
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
