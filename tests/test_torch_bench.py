"""The port's benchmark harness (``aruco_slam_tpu_torch.bench``), its
``cli bench`` and the entry step ``parallel.dryrun.entry`` on the CPU, at
small sizes: the harness's data and corner-level replay against the JAX
package's generator, ``build_batch_data`` and ``replay_batch`` (trajectory
to atol 1e-4, counts and slots exact); its copy of the float64 reference
EKF against ``tests/reference_ekf.py``; the numpy baseline with and
without cv2; the image leg; ``main``'s last line (``bench.py``'s keys);
and ``entry`` against ``__graft_entry__.entry`` (mu and sigma to 1e-5)."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import reference_ekf
from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import bench, cli, convert
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.parallel import dryrun
from aruco_slam_tpu_torch.utils import reference_ekf as port_reference_ekf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# bench.py's replay configuration; 4 lanes over 3 distinct 2 s sequences
JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=32, max_observations_per_frame=16))
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))
BATCH, DISTINCT, SECONDS = 4, 3, 2.0
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "image_level_frames_per_sec_per_chip"}


@pytest.fixture(scope="module")
def built():
    """The harness's data and the JAX package's, from the same seeds."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    data, seqs = bench.build_data(BATCH, SECONDS, cam, distinct=DISTINCT, device="cpu")
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    jseqs = [jsyn.generate_sequence(jsyn.SimParams(duration=SECONDS, seed=s), level="corners",
                                    camera=jcam)
             for s in range(DISTINCT)]
    return data, seqs, jrunner.build_batch_data(jseqs, BATCH, "corners"), jseqs


def test_build_data_matches_jax(built):
    data, seqs, jdata, jseqs = built
    assert len(seqs) == DISTINCT and data.obs_ids.shape[:2] == (BATCH, seqs[0].num_frames)
    assert data.images is None and jdata.images is None
    for name in data._fields:
        if name == "images":
            continue
        ours, ref = getattr(data, name).numpy(), np.asarray(getattr(jdata, name))
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    assert seqs[0].camera() == convert.camera_from_numpy(*(
        getattr(jseqs[0].camera(), k) for k in ("fx", "fy", "cx", "cy", "dist")))


def test_bench_device_matches_jax_replay(built):
    data, seqs, jdata, jseqs = built
    fps, out, seconds = bench.bench_device(data, CFG, seqs[0].camera(), "corners", reps=1)
    ref = jrunner.replay_batch(jdata, JCFG, jseqs[0].camera(), "corners")
    np.testing.assert_allclose(out.trajectory.numpy(), np.asarray(ref.trajectory), atol=1e-4)
    np.testing.assert_array_equal(out.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    np.testing.assert_array_equal(out.final_state.slot_ids.numpy(),
                                  np.asarray(ref.final_state.slot_ids))
    assert int(out.n_landmarks[:, -1].min()) > 0
    assert len(seconds) == 1 and fps > 0


def test_reference_ekf_copy_equals_the_test_oracle(built):
    """The port's copy is the oracle verbatim and runs the same numbers."""
    assert Path(port_reference_ekf.__file__).read_text() == \
        (ROOT / "tests" / "reference_ekf.py").read_text()
    seq = built[1][0]
    ours, ref = port_reference_ekf.ReferenceEKF(), reference_ekf.ReferenceEKF()
    epf = seq.enc_per_frame
    for f in range(seq.num_frames):
        for e in range(f * epf, (f + 1) * epf):
            for ekf in (ours, ref):
                ekf.add_encoder(seq.enc_w[e, 0], seq.enc_w[e, 1], seq.enc_dt[e])
        obs = [(int(seq.obs_ids[f, j]), seq.obs_z[f, j], seq.obs_R[f, j])
               for j in range(seq.max_obs) if seq.obs_valid[f, j]]
        ours.add_frame(obs)
        ref.add_frame(obs)
    assert len(ref.id_map) > 0 and ours.id_map == ref.id_map
    assert np.array_equal(ours.mu, ref.mu) and np.array_equal(ours.sigma, ref.sigma)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_bench_reference_numpy_with_and_without_cv2(built, with_cv2, monkeypatch, capsys):
    """With cv2, one solvePnP per valid observation; without it (the import
    made to fail), none and the warning on stderr."""
    seq, n_frames = built[1][0], 10
    calls = []
    if with_cv2:
        cv2 = pytest.importorskip("cv2")
        solve = cv2.solvePnP
        monkeypatch.setattr(cv2, "solvePnP", lambda *a, **k: calls.append(1) or solve(*a, **k))
    else:
        monkeypatch.setitem(sys.modules, "cv2", None)
    fps = bench.bench_reference_numpy(seq, n_frames=n_frames)
    assert fps > 0
    assert len(calls) == (int(seq.obs_valid[:n_frames].sum()) if with_cv2 else 0)
    assert ("cv2 missing" in capsys.readouterr().err) is not with_cv2


def test_bench_image_level_on_the_cpu():
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    fps, seconds = bench.bench_image_level(cam, batch=2, duration=0.3, device="cpu")
    assert fps > 0 and len(seconds) == 3 and min(seconds) > 0


def test_main_prints_bench_py_keys(capsys):
    bench.main(device="cpu", batch=2, duration=1.0, reps=1, image_batch=2, image_duration=0.3,
               reference_frames=5)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "bench: device cpu"
    assert any(line.startswith("bench: numpy reference") for line in lines[:-1])
    last = json.loads(lines[-1])
    assert set(last) == BENCH_KEYS
    assert last["metric"] == "ekf_pipeline_frames_per_sec_per_chip"
    assert last["unit"] == "frames/s"
    for key in ("value", "vs_baseline", "image_level_frames_per_sec_per_chip"):
        assert last[key] is not None and last[key] > 0, key


def test_cli_bench_passes_the_device(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda device=None: seen.append(device))
    cli.main(["bench", "--device", "cpu"])
    cli.main(["bench"])
    assert seen == ["cpu", None]


def test_entry_matches_jax_entry():
    fn, args = dryrun.entry("cpu")
    assert args[0].mu.device.type == "cpu"
    out = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    ref = jax.jit(jfn)(*jargs)
    np.testing.assert_allclose(out.mu[0].numpy(), np.asarray(ref.mu), atol=1e-5)
    np.testing.assert_allclose(out.sigma[0].numpy(), np.asarray(ref.sigma), atol=1e-5)
    assert int(out.n_landmarks[0]) == int(ref.n_landmarks) == 4
    np.testing.assert_array_equal(out.slot_ids[0].numpy(), np.asarray(ref.slot_ids))
