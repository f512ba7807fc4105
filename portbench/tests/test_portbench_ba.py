"""The back-end cell on the CPU: the float64 bundle-adjustment reference
against a dense normal-equations solve and the port's graph builder, the
``ekf_then_ba`` entry found by file and correct on a 20 s, 20-marker
sequence, each fault of its timed path and its control not correct, and
the back end's readers on a made-up trace."""

from __future__ import annotations

import json
import math
import shutil

import numpy as np
import pytest
import torch

from portbench import cell as cellmod
from portbench import check
from portbench import run as runmod
from portbench.reference import ba
from portbench.reference.ekf import wrap
from portbench.spec import Spec
from portbench.tests.conftest import tiny_copy
from portbench.trace import Trace

CELL = "tour100_ba"
SEED = 2**31 + 41


def ba_copy(dest, **traffic) -> Spec:
    """The harness's data cut to a 20 s run of the 20-marker arena, the back
    end's cell on it, its traffic changed by ``traffic``."""
    spec = tiny_copy(dest, 20.0)
    b = json.loads((spec.root / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["config"] = "arena20"
            name = w["traffic"]
    (spec.root / "BENCHMARK.json").write_text(json.dumps(b))
    path = spec.here / "traffic" / f"{name}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **traffic}))
    return Spec(spec.root, spec.here)


def dense_gn_step(g: ba.Graph, damping: float):
    """Oracle: one Gauss-Newton step by the dense (3K + 3L) normal
    equations in float64 (a copy of ``tests/test_torch_ba.py``'s, on the
    reference's graph, at a state where the prior's residual is zero)."""
    poses, lms = g.poses.numpy(), g.landmarks.numpy()
    K, L = len(poses), len(lms)
    n = 3 * K + 3 * L
    H = np.zeros((n, n))
    b = np.zeros(n)

    def h_jac(p, t):
        x, y, th = p
        s, c = np.sin(th), np.cos(th)
        dx, dy = t[0] - x, t[1] - y
        h = np.array([dx * c + dy * s, -dx * s + dy * c,
                      np.arctan2(np.sin(t[2] - th), np.cos(t[2] - th))])
        Jp = np.array([[-c, -s, -dx * s + dy * c], [s, -c, -dx * c - dy * s], [0, 0, -1]])
        Jt = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        return h, Jp, Jt

    def add(Ja, Jb, W, r, sa, sb):
        H[sa:sa + 3, sa:sa + 3] += Ja.T @ W @ Ja
        H[sb:sb + 3, sb:sb + 3] += Jb.T @ W @ Jb
        H[sa:sa + 3, sb:sb + 3] += Ja.T @ W @ Jb
        H[sb:sb + 3, sa:sa + 3] += Jb.T @ W @ Ja
        b[sa:sa + 3] += Ja.T @ W @ r
        b[sb:sb + 3] += Jb.T @ W @ r

    for i in range(len(g.obs_kf)):
        k, l = int(g.obs_kf[i]), int(g.obs_lm[i])
        h, Jp, Jl = h_jac(poses[k], lms[l])
        r = g.obs_z[i].numpy() - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        add(Jp, Jl, g.obs_w[i].numpy(), r, 3 * k, 3 * K + 3 * l)
    for i in range(len(g.odo_i)):
        a, c2 = int(g.odo_i[i]), int(g.odo_j[i])
        h, Ji, Jj = h_jac(poses[a], poses[c2])
        r = g.odo_z[i].numpy() - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        add(Ji, Jj, g.odo_w[i].numpy(), r, 3 * a, 3 * c2)
    H[:3, :3] += g.prior_w.numpy()
    H += damping * np.eye(n)
    d = np.linalg.solve(H, b)
    return d[:3 * K].reshape(K, 3), d[3 * K:].reshape(L, 3)


def _synthetic_graph() -> ba.Graph:
    from aruco_slam_tpu_torch.models import graph_builder

    p, _, _ = graph_builder.synthetic_ba_problem(12, 8, obs_per_kf=4, seed=1, dtype=np.float64)

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    return ba.Graph(poses=t(p.poses), landmarks=t(p.landmarks), ids=np.arange(8),
                    obs_kf=t(p.obs_kf, torch.long), obs_lm=t(p.obs_lm, torch.long),
                    obs_z=t(p.obs_z), obs_w=t(p.obs_w), odo_i=t(p.odo_i, torch.long),
                    odo_j=t(p.odo_j, torch.long), odo_z=t(p.odo_z), odo_w=t(p.odo_w),
                    prior_w=t(p.prior_w))


@pytest.mark.parametrize("deflate", [False, True])
def test_one_reference_step_equals_the_dense_solve(deflate):
    """200 CG iterations solve this 60-unknown system exactly, deflated or
    not, so the step is the normal equations' to 1e-8."""
    g = _synthetic_graph()
    poses, lms = ba.step(g, g.poses, g.landmarks, 1e-6, 200, deflate)
    dp, dl = dense_gn_step(g, 1e-6)
    for new, old, d in ((poses, g.poses, dp), (lms, g.landmarks, dl)):
        gap = (new - old).numpy() - d
        gap[:, 2] = wrap(torch.as_tensor(gap[:, 2])).numpy()
        assert np.abs(gap).max() < 1e-8


def test_the_reference_graph_is_the_port_s(tmp_path):
    """``reference.ba.build`` makes the graph that the port's
    ``graph_builder.build_from_sequence`` documents, from the same
    sequence and filter answer: the same factors in the same order and the
    same start, to the port's float32."""
    from aruco_slam_tpu_torch.io.sequence import Sequence
    from aruco_slam_tpu_torch.models import graph_builder

    spec = ba_copy(tmp_path)
    w = spec.workload(CELL)
    c = cellmod.Cell(spec.config(w["config"]), spec.traffic(w["traffic"]), SEED, "cpu")
    f = check.reference(c, np.arange(1))
    enc_w, enc_dt = c.enc_w[0].numpy(), c.enc_dt[0].numpy()
    ids, z, R, valid = (c.base[k][0] for k in ("ids", "z", "R", "valid"))
    est = c.config["estimator"]
    mu, slots = f["mu"][0].numpy(), f["slot_ids"][0].numpy()
    seq = Sequence(enc_w=enc_w.reshape(-1, 2), enc_dt=enc_dt.reshape(-1), enc_per_frame=c.epf,
                   obs_ids=ids, obs_z=z, obs_R=R, obs_valid=valid)
    init = {int(i): mu[3 + 3 * s:6 + 3 * s] for s, i in enumerate(slots) if i >= 0}
    gone = max(init)
    del init[gone]  # one landmark composed from its first observation
    held = np.asarray([i if int(i) in init else -1 for i in slots])
    slam = Spec().entry("ekf_then_ba").slam_config(c.config, c.level)
    for stride in (1, 3):
        g = ba.build(enc_w, enc_dt, ids, z, R, valid, est, stride, f["trajectory"][0].numpy(),
                     held, mu)
        p, lm_ids = graph_builder.build_from_sequence(
            seq, slam, keyframe_stride=stride, init_poses=f["trajectory"][0].numpy(),
            init_landmarks=init)
        assert (lm_ids == g.ids).all() and len(g.ids) > 2 and gone in g.ids
        for name in ("obs_kf", "obs_lm", "odo_i", "odo_j"):
            assert (np.asarray(getattr(p, name)) == getattr(g, name).numpy()).all(), name
        for name in ("poses", "landmarks", "obs_z", "obs_w", "odo_z", "odo_w", "prior_w"):
            want = getattr(g, name).numpy()
            gap = np.abs(np.asarray(getattr(p, name), np.float64) - want).max()
            assert gap <= 1e-6 * max(1.0, np.abs(want).max()), (name, gap)


def test_the_entry_is_correct_on_a_20_s_sequence(tmp_path):
    spec = ba_copy(tmp_path)
    res = runmod.run(CELL, SEED, 0.05, False, "cpu", spec=spec)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"ba_pipeline_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res["checks"]) == ["traj_gap", "pose_gap", "lm_gap", "cost_gap",
                                   "answer_cost_gap", "lm_id_mismatch", "history_mismatch"]


def test_a_later_entry_is_a_file_and_a_traffic_file(tmp_path):
    """A new entry needs a module under ``entries/``, a traffic file that
    names it and its cell: the harness loads it through ``Spec.entry``."""
    spec = ba_copy(tmp_path)
    shutil.copy(spec.here / "entries" / "ekf_then_ba.py", spec.here / "entries" / "smooth.py")
    t = json.loads((spec.here / "traffic" / "ba.json").read_text())
    (spec.here / "traffic" / "smooth.json").write_text(json.dumps({**t, "entry": "smooth"}))
    b = json.loads((spec.root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "arena20_smooth", "config": "arena20", "traffic": "smooth",
                           "chips": 1, "why": "test"})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]].index("ba_pipeline_s")][
        "workloads"].append("arena20_smooth")
    (spec.root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = Spec(spec.root, spec.here)
    mod = spec.entry("smooth")
    assert callable(mod.Program) and callable(mod.reference)
    res = runmod.run("arena20_smooth", SEED, 0.05, False, "cpu", spec=spec)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"ba_pipeline_s", "setup_s"}


def _gn_step_dropped(monkeypatch):
    from aruco_slam_tpu_torch.models import ba as port_ba

    solve = port_ba.solve
    monkeypatch.setattr(port_ba, "solve", lambda *a, **k: solve(*a, **{**k,
                                                                       "iters": k["iters"] - 1}))


def _gauge_not_deflated(monkeypatch):
    from aruco_slam_tpu_torch.models import ba as port_ba

    solve = port_ba.solve
    monkeypatch.setattr(port_ba, "solve", lambda *a, **k: solve(*a, **{**k,
                                                                       "deflate_gauge": False}))


def _solve_returns_its_start(monkeypatch):
    """Every Gauss-Newton step leaves the state as it was."""
    from aruco_slam_tpu_torch.models import ba as port_ba

    def same(problem, poses, landmarks, *args, **kwargs):
        return poses, landmarks, port_ba.cost(problem, poses, landmarks, problem.poses[0])

    monkeypatch.setattr(port_ba, "_gn_step", same)


def _landmark_moved(monkeypatch):
    """The first landmark comes out 1 cm off where the solve writes it."""
    from aruco_slam_tpu_torch.models import ba as port_ba

    solve = port_ba.solve

    def moved(*args, **kwargs):
        poses, landmarks, stats = solve(*args, **kwargs)
        landmarks[0, 0] += 0.01
        return poses, landmarks, stats

    monkeypatch.setattr(port_ba, "solve", moved)


FAULTS = {"gn_step_dropped": _gn_step_dropped, "gauge_not_deflated": _gauge_not_deflated,
          "solve_returns_its_start": _solve_returns_its_start, "landmark_moved": _landmark_moved}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_back_end_is_not_correct(fault, tmp_path, monkeypatch):
    """Each fault fails the cell's limits. At 200 CG iterations the 20 s
    run's 600-unknown system is solved to rounding with or without the
    gauge deflation, which shows only where CG stops short (as at the
    cell's 6,300 unknowns), so these runs take 20 iterations."""
    spec = ba_copy(tmp_path, cg_iters=20)
    assert runmod.run(CELL, SEED, 0.05, False, "cpu", spec=spec)["correct"]
    FAULTS[fault](monkeypatch)
    res = runmod.run(CELL, SEED, 0.05, False, "cpu", spec=spec)
    assert not res["correct"] and res["failed"] == 1, res["checks"]
    assert any(not (r["value"] <= r["limit"]) or math.isnan(r["value"])
               for r in res["checks"].values())


def test_the_control_is_not_correct(tmp_path):
    """The reference in TF32 in the program's place fails the limits, at the
    cell's own size (``PERF.md`` gives its readings on the card)."""
    spec = tiny_copy(tmp_path, 210.0)
    entry = spec.entry("ekf_then_ba")
    w = spec.workload(CELL)
    traffic = spec.traffic(w["traffic"])
    c = cellmod.Cell(spec.config(w["config"]), traffic, SEED, "cpu")
    assert c.frames == 2100 and c.config["arena"]["markers"] == 100
    ok, table = check.judge(entry.numbers(c, entry.control(c), entry.reference(c)),
                            traffic["limits"])
    assert not ok, table


def test_the_back_end_readers_on_a_made_up_trace():
    """Two K6 frame steps, the map read back, the problem's upload (two
    copies), then four solve kernels: 7 events after the filter over 2 GN
    steps; the solve spans 10 us to 40 us."""
    spec = Spec()
    ev = [("ekf_frame_update_cluster_kernel", 0.0, 1.0), ("ekf_frame_update_cluster_kernel", 2.0, 3.0),
          ("Memcpy DtoH (Device -> Pageable)", 4.0, 5.0), ("Memcpy HtoD (Pageable -> Device)", 6.0, 7.0),
          ("Memcpy HtoD (Pageable -> Device)", 8.0, 9.0), ("elementwise_kernel", 10.0, 11.0),
          ("reduce_kernel", 20.0, 22.0), ("gemm", 30.0, 31.0), ("elementwise_kernel", 35.0, 40.0)]
    t = Trace(ev, 1.0, 1, 2, 1, traffic={"ba_iters": 2})
    t.bounds = {"ba_solve": 3e-6}
    assert spec.reader("layers", "device_events_per_gn")(t) == pytest.approx(3.5)
    assert spec.reader("layers", "ba_solve_roofline")(t) == pytest.approx(10.0)
    assert spec.reader("layers", "ba_solve_roofline")(Trace(ev[:5], 1.0, 1, 2, 1)) is None
    assert spec.reader("layers", "device_events_per_gn")(Trace(ev[2:], 1.0, 1, 2, 1)) is None


def test_ba_pipeline_s_is_the_median_call():
    window = runmod.Window([4.0, 1.0, 3.0, 100.0, 2.0], 110.0, 2100, 5.0)
    assert Spec().reader("end_to_end", "ba_pipeline_s")(window) == 3.0
