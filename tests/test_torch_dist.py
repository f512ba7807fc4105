"""The port's distributed slice on the CPU, ranks over gloo, against the
JAX package on a 4-device mesh (``tests/test_parallel.py``'s problems and
bounds):

- ``partition_problem`` equals JAX's exactly (``lm_perm`` and every data
  field of every shard);
- ``solve_dist`` on 4 ranks equals JAX's ``solve_dist`` and the port's
  single-device ``ba.solve``: poses and landmarks (de-permuted) within
  atol 2e-3 (48/40) / 3e-3 (24/37), the cost history within rtol 2e-2;
  plain, ``adaptive`` and ``deflate_gauge``;
- a solve issues exactly ``iters * (cg_iters + 2) + 1`` all-reduces per
  rank (``iters`` more under ``deflate_gauge``) and one all-gather, and no
  other torch.distributed collective, at two trip counts;
- ``runner.replay_sharded`` equals JAX's ``replay_sharded``
  (``test_parallel.py:184-214``'s inputs): trajectory within 1e-4, slots
  and landmark counts exact;
- sharded ``detect_frames`` is bit-identical to the unsharded call;
- ``dryrun_multichip(2, device="cpu")`` runs; ``run_ranks`` raises a
  rank's failure and stops a hung rank.

The ranks are spawned once for the module (every multi-rank case runs in
one world of 4, ``tests/torch_dist_ranks.py``); each JAX program compiles
once.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.parallel import dist_ba as jdist
from aruco_slam_tpu.parallel import mesh as jmesh
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ba, graph_builder
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.parallel import dist_ba, dryrun, launch, mesh
from aruco_slam_tpu_torch.sim import synthetic

torch.set_num_threads(1)

WORLD = 4
# tests/test_parallel.py's problems, trip counts and pose / landmark bounds
PROBLEMS = {
    "48/40": (dict(n_keyframes=48, n_landmarks=40, obs_per_kf=5, seed=4),
              dict(iters=5, cg_iters=60, damping=1e-4), 2e-3),
    "24/37": (dict(n_keyframes=24, n_landmarks=37, obs_per_kf=4, seed=6),
              dict(iters=3, cg_iters=40, damping=1e-4), 3e-3),
}
HISTORY_RTOL = 2e-2
SOLVES = {
    "48/40": ("48/40", {}),
    "24/37": ("24/37", {}),
    "48/40 adaptive": ("48/40", {"adaptive": True}),
    "24/37 deflate_gauge": ("24/37", {"deflate_gauge": True}),
}
# tests/test_parallel.py's collective-count problem at two trip counts
COUNT_PROBLEM = dict(n_keyframes=24, n_landmarks=16, obs_per_kf=4, seed=7)
COUNTS = {
    "2x8": dict(iters=2, cg_iters=8, damping=1e-4),
    "3x5": dict(iters=3, cg_iters=5, damping=1e-4),
    "2x8 deflate_gauge": dict(iters=2, cg_iters=8, damping=1e-4, deflate_gauge=True),
}
JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=8, max_observations_per_frame=4))


def _cfg():
    return convert.config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def problems():
    return {name: graph_builder.synthetic_ba_problem(**args)[0]
            for name, (args, _, _) in PROBLEMS.items()}


@pytest.fixture(scope="module")
def seqs():
    """test_parallel.py:184-214's eight 3 s sequences."""
    return [synthetic.generate_sequence(synthetic.SimParams(duration=3.0, seed=s, max_obs=4))
            for s in range(8)]


@pytest.fixture(scope="module")
def images():
    """test_parallel.py:150-181's rendered frames (2 sequences, 3 frames of
    640x480, tiled to 8 lanes), and 23 of them flat (not a multiple of the
    world)."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    img_seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=0.6, seed=s, frames_per_sec=5.0, max_obs=8),
            level="images", camera=cam, device="cpu")
        for s in range(2)
    ]
    stack = runner.build_batch_data(img_seqs, 8, "images", "cpu").images
    return [stack, stack.reshape(-1, *stack.shape[-2:])[:23]]


@pytest.fixture(scope="module")
def world(problems, seqs, images):
    """Every rank's results of every multi-rank case (one spawn)."""
    solves = {
        name: (dist_ba.partition_problem(problems[p], WORLD)[0], {**PROBLEMS[p][1], **extra})
        for name, (p, extra) in SOLVES.items()
    }
    sharded = dist_ba.partition_problem(
        graph_builder.synthetic_ba_problem(**COUNT_PROBLEM)[0], WORLD)[0]
    counts = {name: (sharded, kw) for name, kw in COUNTS.items()}
    data = runner.build_batch_data(seqs, device="cpu")
    return launch.run_ranks(ranks.all_cases, WORLD, device="cpu",
                            args=(solves, counts, (data, _cfg()), images), timeout=600)


@pytest.mark.parametrize("n_shards", [3, 4, 8])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_partition_problem_matches_jax(problems, name, n_shards):
    ours, perm = dist_ba.partition_problem(problems[name], n_shards)
    ref, jperm = jdist.partition_problem(problems[name], n_shards)
    np.testing.assert_array_equal(perm, jperm)
    for field in dist_ba.ShardedBAProblem._fields:
        want = np.asarray(getattr(ref, field))
        got = getattr(ours, field)
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def _jax_solve(sharded, kw):
    return jdist.solve_dist(sharded, jmesh.make_mesh(WORLD), **kw)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_dist_matches_jax_and_single_device(world, problems, name):
    p, extra = SOLVES[name]
    kw = {**PROBLEMS[p][1], **extra}
    atol = PROBLEMS[p][2]
    poses, lms, hist = world[0]["solve"][name]
    for r in world[1:]:  # every rank returns the same replicated result
        for a, b in zip(r["solve"][name], world[0]["solve"][name]):
            assert torch.equal(a, b)
    _, perm = dist_ba.partition_problem(problems[p], WORLD)
    lms = lms.numpy()[perm]
    jsharded, jperm = jdist.partition_problem(problems[p], WORLD)
    jposes, jlms, jhist = _jax_solve(jsharded, kw)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=atol)
    np.testing.assert_allclose(lms, np.asarray(jlms)[jperm], atol=atol)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=HISTORY_RTOL)
    sposes, slms, stats = ba.solve(convert.ba_problem_from_numpy(problems[p], "cpu"), **kw)
    np.testing.assert_allclose(poses.numpy(), sposes.numpy(), atol=atol)
    np.testing.assert_allclose(lms, slms.numpy(), atol=atol)
    np.testing.assert_allclose(hist.numpy(), stats.cost_history.numpy(), rtol=HISTORY_RTOL)
    assert hist[-1] < hist[0]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_collectives_per_solve(world, name):
    kw = COUNTS[name]
    expect = kw["iters"] * (kw["cg_iters"] + 2) + 1 + (kw["iters"] if "deflate_gauge" in kw else 0)
    for r in world:
        assert r["count"][name] == {"all_reduce": expect, "all_gather": 1}
        assert r["count"][name + " torch"] == {"all_reduce": expect, "all_gather": 1}


def test_replay_sharded_matches_jax(world, seqs):
    f, epf = seqs[0].num_frames, seqs[0].enc_per_frame
    stack = lambda n: np.stack([getattr(s, n) for s in seqs])  # noqa: E731
    data = jrunner.ReplayData(
        enc_w=jnp.asarray(stack("enc_w").reshape(8, f, epf, 2)),
        enc_dt=jnp.asarray(stack("enc_dt").reshape(8, f, epf)),
        obs_ids=jnp.asarray(stack("obs_ids")),
        obs_z=jnp.asarray(stack("obs_z")),
        obs_R=jnp.asarray(stack("obs_R")),
        obs_valid=jnp.asarray(stack("obs_valid")),
    )
    mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    ref = jrunner.replay_sharded(data, JCFG, mesh4)
    ours = world[0]["replay"]
    np.testing.assert_allclose(ours.trajectory.numpy(), np.asarray(ref.trajectory), atol=1e-4)
    np.testing.assert_array_equal(ours.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    np.testing.assert_array_equal(ours.final_state.slot_ids.numpy(),
                                  np.asarray(ref.final_state.slot_ids))
    for r in world[1:]:
        assert torch.equal(r["replay"].trajectory, ours.trajectory)
    plain = runner.replay_batch(runner.build_batch_data(seqs, device="cpu"), _cfg())
    assert torch.equal(plain.trajectory, ours.trajectory)


def test_replay_sharded_refuses_a_batch_the_world_does_not_split(seqs, monkeypatch):
    monkeypatch.setattr(mesh, "rank_world", lambda group=None: (0, 3))
    with pytest.raises(ValueError, match="8 lanes"):
        runner.replay_sharded(runner.build_batch_data(seqs, device="cpu"), _cfg(), device="cpu")


@pytest.mark.parametrize("which", [0, 1], ids=["8x3 lanes", "23 frames"])
def test_sharded_detection_is_bit_identical(world, images, which):
    want = runner.detect_frames(images[which], chunk=4)
    assert bool(want[2].any())  # the scene has detections
    for r in world:
        for got, ref in zip(r["detect"][which], want):
            assert got.shape == ref.shape and torch.equal(got, ref)


def test_dryrun_multichip_runs():
    runs = dryrun.dryrun_multichip(2, device="cpu")
    assert len(runs) == 2
    for r in runs:
        assert r.device.type == "cpu"
        assert r.replay_shape[0] == 2 and r.image_replay_shape[0] == 2
        assert r.ba_poses_shape == (8, 3)
        assert np.isfinite(r.ba_history).all() and r.ba_history[-1] < r.ba_history[0]
        assert r.detections > 0
    np.testing.assert_array_equal(runs[0].ba_history, runs[1].ba_history)


def test_run_ranks_raises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        launch.run_ranks(ranks.fail_at, 2, device="cpu", args=(1,), timeout=120)


class _LateExit:
    """A stand-in rank process that writes its result at start and reads as
    running for the first ``running_reads`` readings of its exit code, then
    as exited with 0."""

    def __init__(self, target, daemon, args, running_reads):
        self.args, self.reads, self.running_reads = args, 0, running_reads

    def start(self):
        _, rank, _, _, _, store, _, _ = self.args
        with open(f"{store}/result-{rank}.pkl", "wb") as f:
            pickle.dump(rank, f)

    @property
    def exitcode(self):
        self.reads += 1
        return None if self.reads <= self.running_reads else 0

    def join(self, timeout=None):
        pass

    def is_alive(self):
        return False


@pytest.mark.parametrize("running_reads", [1, 2, 3])
def test_run_ranks_returns_when_the_last_rank_exits_between_readings(monkeypatch,
                                                                    running_reads):
    # the launcher once read the exit codes three times an iteration and
    # failed when the last rank exited between the second and third reading
    class Ctx:
        def Process(self, target, daemon, args):
            return _LateExit(target, daemon, args, running_reads)

    monkeypatch.setattr(launch.torch.multiprocessing, "get_context", lambda method: Ctx())
    assert launch.run_ranks(ranks.hang, 2, device="cpu", args=(0,), timeout=60) == [0, 1]


def test_run_ranks_stops_a_hung_rank():
    with pytest.raises(TimeoutError):
        launch.run_ranks(ranks.hang, 1, device="cpu", args=(600,), timeout=5)
