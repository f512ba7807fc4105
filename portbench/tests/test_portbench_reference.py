"""The plain reference: independent of the port, equal to the estimator
it states, and able to tell a wrong answer from a right one: its control
(the reference in TF32) and a run with its timed path broken both come out
not correct."""

from __future__ import annotations

import ast
import json
import math

import numpy as np
import pytest
import torch

from portbench import cell as cellmod
from portbench import check
from portbench import run as runmod
from portbench.control import TF32Products, control_result, subpix_in_tf32, to_tf32
from portbench.reference import detector, ekf, pnp, sim
from portbench.spec import HERE


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"aruco_slam_tpu_torch", "aruco_slam_tpu", "jax", "jaxlib", "flax"}
    assert tops <= {"__future__", "copy", "math", "functools", "dataclasses", "typing", "numpy",
                    "torch", "portbench"}, tops


def _one_lane(seconds=20.0, seed=4):
    cfg = json.loads((HERE / "configs" / "arena20.json").read_text())
    cfg["duration_s"] = seconds
    base = sim.base_sequences(cfg, "obs", 1, seed)
    enc_w, enc_dt = sim.lane_encoders(torch.as_tensor(base["wheels"]), 1, 0.4, 10, 0.01,
                                      torch.Generator().manual_seed(seed))
    return cfg, base, enc_w, enc_dt


def test_the_ekf_equals_the_growing_float64_estimator():
    """One lane at measurement level against the reference estimator's
    naive dense form (growing matrices, ``utils/reference_ekf.py``)."""
    from aruco_slam_tpu_torch.utils.reference_ekf import ReferenceEKF

    cfg, base, enc_w, enc_dt = _one_lane()
    est = cfg["estimator"]
    ids, z, R, valid = (torch.as_tensor(base[k]) for k in ("ids", "z", "R", "valid"))
    out = ekf.replay(enc_w, enc_dt, ids, z.double(), R.double(), valid,
                     torch.zeros(1, dtype=torch.long), {**est, "symmetrize_sigma": False}, 32)
    naive, traj = ReferenceEKF(), []
    for f in range(ids.shape[1]):
        for e in range(enc_w.shape[2]):
            naive.add_encoder(*(float(x) for x in (enc_w[0, f, e, 0], enc_w[0, f, e, 1],
                                                    enc_dt[0, f, e])))
        naive.add_frame([(int(ids[0, f, j]), z[0, f, j].double().numpy(),
                          R[0, f, j].double().numpy())
                         for j in range(ids.shape[2]) if valid[0, f, j]])
        traj.append(naive.mu[:3].copy())
    np.testing.assert_allclose(out["trajectory"][0].numpy(), np.stack(traj), atol=1e-9)
    n = len(naive.mu)
    assert int(out["n_landmarks"][0, -1]) == (n - 3) // 3
    np.testing.assert_allclose(out["mu"][0, :n].numpy(), naive.mu, atol=1e-9)
    np.testing.assert_allclose(out["sigma"][0, :n, :n].numpy(), naive.sigma, atol=1e-9)


def test_the_front_end_and_ekf_agree_with_the_port_plain_path():
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cfg = json.loads((HERE / "configs" / "arena20.json").read_text())
    cfg["duration_s"] = 5.0
    base = sim.base_sequences(cfg, "corners", 2, 8)
    lb = torch.tensor([0, 1, 1])
    enc_w, enc_dt = sim.lane_encoders(torch.as_tensor(base["wheels"]), 3, 0.4, 10, 0.01,
                                      torch.Generator().manual_seed(8))
    ids, valid, corners = (torch.as_tensor(base[k])[lb] for k in ("ids", "valid", "corners"))
    c = cfg["camera"]
    out = runner.replay_batch_reference(
        runner.ReplayData(enc_w, enc_dt, ids, None, None, valid, corners),
        SlamConfig(ekf=EkfConfig(32, 16)), CameraIntrinsics.create(c["fx"], c["fy"], c["cx"],
                                                                   c["cy"]), "corners")
    z, R, keep, _ = pnp.frontend(torch.as_tensor(base["corners"]).double(),
                                 torch.as_tensor(base["valid"]), c, cfg["estimator"])
    ref = ekf.replay(enc_w, enc_dt, torch.as_tensor(base["ids"]), z, R, keep, lb,
                     cfg["estimator"], 32)
    assert (out.n_landmarks == ref["n_landmarks"]).all()
    assert (out.final_state.slot_ids == ref["slot_ids"]).all()
    assert (out.trajectory.double() - ref["trajectory"]).abs().max() < 1e-4


def test_the_detector_equals_the_port_plain_detector():
    from aruco_slam_tpu_torch.ops import detector as port_detector
    from portbench.reference import render

    cfg = json.loads((HERE / "configs" / "arena20.json").read_text())
    cfg["duration_s"] = 0.3
    base = sim.base_sequences(cfg, "images", 1, 2)
    frames = render.render(sim.Arena.from_config(cfg), base["poses"][0], cfg["camera"],
                           cfg["sensors"]["camera_height_m"], "cpu")
    got = detector.detect_markers_batch(frames)
    want = port_detector.detect_markers_batch(frames, reference=True)
    assert want.valid.any()
    assert (got.valid == want.valid).all() and (got.ids == want.ids).all()
    assert (got.corners[got.valid] - want.corners[want.valid]).abs().max() == 0


@pytest.mark.parametrize("seed", [3, 5])
def test_the_detector_finds_the_rendered_markers(seed):
    """A witness that owes nothing to the port's detector: the markers that
    the generator projects into a 1 s clip are mostly found, by id, at
    their projected corners to within a pixel (the median)."""
    from portbench.reference import render

    cfg = json.loads((HERE / "configs" / "arena20_clip6.json").read_text())
    cfg["duration_s"] = 1.0
    base = sim.base_sequences(cfg, "images", 1, seed)
    frames = render.render(sim.Arena.from_config(cfg), base["poses"][0], cfg["camera"],
                           cfg["sensors"]["camera_height_m"], "cpu")
    det = detector.detect_markers_batch(frames)
    ids, valid, corners = base["ids"][0], base["valid"][0], base["corners"][0]
    gaps, seen = [], 0
    for f in range(frames.shape[0]):
        found = {int(det.ids[f, k]): det.corners[f, k].numpy()
                 for k in range(det.ids.shape[1]) if det.valid[f, k]}
        for m in np.flatnonzero(valid[f]):
            seen += 1
            if int(ids[f, m]) in found:
                gaps.append(np.abs(found[int(ids[f, m])] - corners[f, m]).max())
    assert len(gaps) >= 2 * seen / 3, (len(gaps), seen)
    assert np.median(gaps) < 1.0


def test_tf32_rounds_products_only():
    a, b = torch.randn(4, 3, 3), torch.randn(4, 3, 5)
    with TF32Products():
        c = a @ b
        d = a + 1.0
    assert (c == to_tf32(a) @ to_tf32(b)).all() and (d == a + 1.0).all()
    assert ((to_tf32(a) - a).abs() <= a.abs() * 2.0**-11).all()


def test_tf32_elementwise_rounds_every_product():
    a, b = torch.randn(4, 3), torch.randn(4, 3)
    with TF32Products(elementwise=True):
        c, d, e = a * b, 2.5 * a, a + b
    assert (c == to_tf32(a) * to_tf32(b)).all() and (d == 2.5 * to_tf32(a)).all()
    assert (e == a + b).all()


def test_the_detector_control_moves_the_corners():
    """The subpixel solve in TF32 moves the detector's corners off the plain
    detector's (which the program matches bit for bit: ``PERF.md``), and
    the plain solve is back afterwards."""
    from portbench.reference import render

    cfg = json.loads((HERE / "configs" / "arena20_clip6.json").read_text())
    cfg["duration_s"] = 0.3
    base = sim.base_sequences(cfg, "images", 1, 3)
    frames = render.render(sim.Arena.from_config(cfg), base["poses"][0], cfg["camera"],
                           cfg["sensors"]["camera_height_m"], "cpu")
    plain = detector.refine_corners_subpix
    want = detector.detect_markers_batch(frames)
    with subpix_in_tf32():
        got = detector.detect_markers_batch(frames)
    assert detector.refine_corners_subpix is plain
    both = got.valid & want.valid
    assert both.any()
    assert (got.corners - want.corners).abs()[both].max() > 1e-3


@pytest.mark.parametrize("cell,seconds", [("arena20_corners_b4096", 2.0), ("tour100_stream", 60.0),
                                          ("arena20_images_b32", 0.5)])
def test_the_control_is_not_correct(cell, seconds, tmp_path):
    """The reference in TF32 in the program's place fails the cell's limits
    (at the cell's own size on the card: ``PERF.md``); a 20-frame stream is
    too short for TF32's error to show, so the stream runs 60 s here."""
    from portbench.tests.conftest import tiny_copy

    tiny = tiny_copy(tmp_path, seconds)
    w = tiny.workload(cell)
    traffic = tiny.traffic(w["traffic"])
    c = cellmod.Cell(tiny.config(w["config"]), traffic, 2**31 + 21, "cpu")
    lanes = cellmod.sample_lanes(c.lanes, traffic["check_lanes"], 1)
    ctl, dets = control_result(c, lanes)
    ref = check.reference(c, lanes)
    ok, table = check.judge(check.numbers(c, ctl, dets, ref),
                            traffic["limits"])
    assert not ok, table


def _broken_state(monkeypatch):
    """Every EKF frame step returns its state unchanged."""
    from aruco_slam_tpu_torch.ops.kernels import ekf_update, ekf_update_batched

    def same(state, frame, controls, config, out=None, rows=None):
        if rows is not None:
            f = rows.f
            rows.trajectory[:, f] = state.mu[:, :3]
            rows.pose_cov[:, f] = state.sigma[:, :3, :3]
            rows.n_landmarks[:, f] = state.n_landmarks
        return state

    def replay_step(state, frames, controls, config, rows):
        def rep(f):
            rows.trajectory[f] = state.mu[0, :3]
            rows.pose_cov[f] = state.sigma[0, :3, :3]
            rows.n_landmarks[f] = state.n_landmarks[0]
            return state

        return rep

    monkeypatch.setattr(ekf_update_batched, "frame_step_batched", same)
    monkeypatch.setattr(ekf_update_batched, "frame_step_prechecked", same)
    monkeypatch.setattr(ekf_update, "replay_step", replay_step)


def _broken_half(monkeypatch):
    """The second half of the lanes is not replayed: it returns copies of
    the first half's answers."""
    from aruco_slam_tpu_torch import runner

    whole = runner.replay_batch

    def half(data, *args, **kwargs):
        B = data.obs_ids.shape[0]
        part = whole(runner.ReplayData(*(None if x is None else x[:B // 2] for x in data)),
                     *args, **kwargs)
        idx = torch.arange(B) % (B // 2)
        return runner.ReplayResult(*(x.index_select(0, idx) for x in part[:3]),
                                   final_state=type(part.final_state)(
                                       *(x.index_select(0, idx) for x in part.final_state)))

    monkeypatch.setattr(runner, "replay_batch", half)


def _broken_answer(monkeypatch):
    """One lane's pose at one frame is off by a centimetre where it is
    written."""
    from aruco_slam_tpu_torch import runner

    for name in ("replay_batch", "replay"):
        whole = getattr(runner, name)

        def altered(*args, _whole=whole, **kwargs):
            out = _whole(*args, **kwargs)
            t = out.trajectory.view(-1, *out.trajectory.shape[-2:])
            t[-1, t.shape[1] // 2, 0] += 1e-2
            return out

        monkeypatch.setattr(runner, name, altered)


FAULTS = {"state_unchanged": _broken_state, "half_the_batch": _broken_half,
          "answer_altered": _broken_answer}


# every fault that a cell can have (a single stream has no second half)
CASES = [(c, f) for c in ("arena20_corners_b4096", "tour100_corners_b256", "tour100_stream")
         for f in sorted(FAULTS) if not (c == "tour100_stream" and f == "half_the_batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = runmod.run(cell, 2**31 + 33, 0.05, False, "cpu", spec=tiny)
    assert not res["correct"] and res["failed"] == 1, res["checks"]
    assert any(not (r["value"] <= r["limit"]) or math.isnan(r["value"])
               for r in res["checks"].values())


@pytest.mark.cuda
def test_the_graphed_reference_equals_the_eager_one(card):
    cfg = json.loads((HERE / "configs" / "tour100.json").read_text())
    cfg["duration_s"] = 20.0
    base = sim.base_sequences(cfg, "obs", 2, 5)
    lb = torch.tensor([0, 1, 1, 0], device=card)
    enc_w, enc_dt = sim.lane_encoders(torch.as_tensor(base["wheels"], device=card), 4, 0.4, 10,
                                      0.01, torch.Generator(device=card).manual_seed(5))
    ids, z, R, valid = (torch.as_tensor(base[k], device=card) for k in ("ids", "z", "R", "valid"))
    inputs, depth = ekf.frames_of(enc_w, enc_dt, ids, z.double(), R.double(), valid, lb)
    est = cfg["estimator"]
    a, b = ekf.State(4, 128, torch.float64, card), ekf.State(4, 128, torch.float64, card)
    eager, graphed = ekf._Eager(a, est), ekf._Graphed(b, [x[:, 0] for x in inputs], est)
    for f in range(enc_w.shape[1]):
        frame = [x[:, f] for x in inputs]
        eager(frame, int(depth[f]))
        graphed(frame, int(depth[f]))
        for k in ekf.FIELDS:
            assert torch.equal(getattr(a, k), getattr(b, k)), (f, k)
