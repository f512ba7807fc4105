"""The port's checkpoints, learned-map export, run log, profiler trace and
CLI on the CPU — ``tests/test_io_cli.py`` on the port, and against the JAX
package where both write the same thing.

- Checkpoints: the port's round trip; a JAX-written npz checkpoint loads in
  the port and a port-written one in the JAX package, leaf for leaf.
- ``export_learned_map`` round-trips through ``map_io.load_map``.
- ``write_replay_log`` writes the JAX package's lines for the same result.
- ``simulate`` -> ``replay`` (log, map, plot) -> ``ba`` and ``ba --ekf-init``
  with ``--device cpu``: the JSON lines of the JAX CLI on the same file
  (metrics within 1e-4; keyframe and landmark counts equal, costs within
  rtol 1e-3).
- ``--config`` settings survive unless a flag overrides them; ``trace``
  writes a trace; ``replay --level images`` refuses a sequence whose
  ``.asq`` frames are gone.
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from aruco_slam_tpu import cli as jcli
from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.io import checkpoint as jcheckpoint
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu.utils import logging as jlog
from aruco_slam_tpu_torch import cli, convert, runner
from aruco_slam_tpu_torch.io import checkpoint, map_io
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils import logging as slog

torch.set_num_threads(1)

JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=16, max_observations_per_frame=8))
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def runs():
    """A 6 s sequence replayed by both packages."""
    seq = jsyn.generate_sequence(jsyn.SimParams(duration=6.0, seed=9, max_obs=8))
    jres = jrunner.replay(jrunner.replay_data_from_sequence(seq), JCFG)
    res = runner.replay(runner.replay_data_from_sequence(seq, "obs", "cpu"), CFG)
    return seq, jres, res


def test_checkpoint_roundtrip_ekf_state(tmp_path, runs):
    state = runs[2].final_state
    path = str(tmp_path / "ckpt")
    checkpoint.save_pytree(path, state)
    restored = checkpoint.load_pytree(path, state, device="cpu")
    assert type(restored) is ekf.EkfState
    for a, b in zip(state, restored):
        assert torch.equal(a, b)


def test_checkpoints_cross_packages(tmp_path, runs):
    """The npz layout is the JAX package's: a JAX-written state loads in
    the port, and the port's state loads in the JAX package's reader."""
    jstate = runs[1].final_state
    jcheckpoint._save_npz(str(tmp_path / "j.npz"), jstate)
    like = ekf.EkfState(*[0] * len(ekf.EkfState._fields))
    got = checkpoint.load_pytree(str(tmp_path / "j"), like, device="cpu")
    for name, leaf in zip(ekf.EkfState._fields, jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(leaf), err_msg=name)
    port_state = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for a, b in zip(port_state, convert.ekf_state_from_numpy(got, "cpu")):
        assert torch.equal(a, b)

    state = runs[2].final_state
    checkpoint.save_pytree(str(tmp_path / "p"), state)
    back = jcheckpoint._load_npz(str(tmp_path / "p.npz"), jax.tree.map(np.zeros_like, jstate))
    for name, leaf in zip(ekf.EkfState._fields, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(leaf), getattr(state, name).numpy())


def test_export_learned_map_roundtrip(tmp_path, runs):
    state = runs[2].final_state
    lms, ids, active = (t[0] for t in ekf.get_map(state, CFG))
    path = str(tmp_path / "learned_map.txt")
    checkpoint.export_learned_map(path, lms, ids, active)
    m = map_io.load_map(path)
    assert len(m) == int(state.n_landmarks[0]) > 0
    planar = synthetic.map_to_planar(m)
    est = lms[active].numpy()
    order = {int(i): k for k, i in enumerate(m.ids)}
    for k, aid in enumerate(ids[active].tolist()):
        row = planar[order[aid]]
        np.testing.assert_allclose(row[:2], est[k, :2], atol=1e-5)
        assert abs(np.arctan2(np.sin(row[2] - est[k, 2]), np.cos(row[2] - est[k, 2]))) < 1e-4


def test_write_replay_log_matches_jax(tmp_path, runs):
    """The same result (the JAX replay's arrays carried across) gives the
    same lines; the port's own replay gives a log of the same form."""
    _, jres, res = runs
    carried = runner.ReplayResult(
        trajectory=torch.tensor(np.asarray(jres.trajectory)),
        pose_cov=torch.tensor(np.asarray(jres.pose_cov)),
        n_landmarks=torch.tensor(np.asarray(jres.n_landmarks)),
        final_state=convert.ekf_state_from_numpy(jax.tree.map(np.asarray, jres.final_state),
                                                 "cpu"),
    )
    ours, ref = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    for every in (1, 7):
        n = slog.write_replay_log(ours, carried, every=every)
        assert n == jlog.write_replay_log(ref, jres, every=every)
        assert open(ours).read() == open(ref).read()
    n = slog.write_replay_log(ours, res)
    lines = [json.loads(line) for line in open(ours)]
    assert n == len(lines) - 1 == 60 and lines[-1]["final"] is True
    assert {"frame", "x", "y", "theta", "cov_trace", "n_landmarks"} <= set(lines[0])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_simulate_replay_ba_match_jax(tmp_path, capsys):
    seq_path = str(tmp_path / "seq.npz")
    cli.main(["simulate", "--out", seq_path, "--duration", "6", "--seed", "4"])
    assert _last_json(capsys) == {"frames": 60, "out": seq_path, "level": "obs"}
    log_path, map_path, png = (str(tmp_path / n) for n in ("log.jsonl", "map.txt", "run.png"))
    common = ["--max-landmarks", "16", "--max-obs", "16"]
    cli.main(["replay", "--sequence", seq_path, "--log", log_path, "--export-map", map_path,
              "--plot", png, "--device", "cpu", *common])
    ours = _last_json(capsys)
    jcli.main(["replay", "--sequence", seq_path, *common])
    ref = _last_json(capsys)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4, err_msg=k)
    assert len(open(log_path).readlines()) == 61
    assert len(map_io.load_map(map_path)) == ours["n_landmarks"] > 0
    assert os.path.getsize(png) > 0

    ba_args = ["ba", "--sequence", seq_path, "--stride", "2", "--iters", "3",
               "--cg-iters", "40"]
    for extra in ([], ["--ekf-init"]):
        cli.main([*ba_args, *extra, "--device", "cpu"])
        ours = _last_json(capsys)
        jcli.main([*ba_args, *extra])
        ref = _last_json(capsys)
        assert (ours["keyframes"], ours["landmarks"]) == (ref["keyframes"], ref["landmarks"])
        for k in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
        assert ours["final_cost"] < ours["initial_cost"]
        if extra:
            assert ours["initial_cost"] <= plain_initial * 1.05
        plain_initial = ours["initial_cost"]


def test_cli_refuses_asq(tmp_path):
    """``simulate --image-format asq`` writes the frames to a sibling .asq
    container; ``replay --level images`` refuses the sequence once that
    container is gone."""
    out = tmp_path / "s.npz"
    cli.main(["simulate", "--out", str(out), "--duration", "0.3", "--level", "images",
              "--image-format", "asq", "--device", "cpu"])
    os.remove(tmp_path / "s.asq")
    with pytest.raises(IOError, match="asq"):
        cli.main(["replay", "--sequence", str(out), "--level", "images", "--device", "cpu"])


def test_cli_config_not_clobbered(tmp_path):
    """--config ekf settings survive unless CLI flags override them."""
    yaml_path = tmp_path / "c.yaml"
    yaml_path.write_text("ekf:\n    max_landmarks: 128\n")
    args = argparse.Namespace(config=str(yaml_path), max_landmarks=None, max_obs=None)
    assert cli._load_config(args).ekf.max_landmarks == 128
    args = argparse.Namespace(config=str(yaml_path), max_landmarks=32, max_obs=None)
    cfg = cli._load_config(args)
    assert cfg.ekf.max_landmarks == 32
    assert cfg.ekf.max_observations_per_frame == 16  # untouched default
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcli._load_config(args))


def test_profiler_trace_capture(tmp_path, runs):
    logdir = str(tmp_path / "trace")
    data = runner.replay_data_from_sequence(runs[0], "obs", "cpu")
    with slog.trace(logdir):
        runner.replay(data._replace(**{k: v[:5] for k, v in data._asdict().items()
                                       if v is not None}), CFG)
    found = [f for _, _, files in os.walk(logdir) for f in files]
    assert any(f.endswith(".pt.trace.json") for f in found), found
    # the program's spans on a host track of the same clock: each frame
    # step holds the host's operations that it ran (the CPU's trace here)
    (name,) = [f for f in found if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    frames = [e for e in events if e.get("cat") == "program_span" and e["name"] == "replay.frame"]
    assert len(frames) == 5 and all(e["args"]["frames"] == 1 for e in frames)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    for fr in frames:
        end = fr["ts"] + fr["dur"]
        assert any(fr["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end for e in ops), fr
