"""K6's plain versions (``ops.kernels.ekf_update.frame_update`` and
``frame_step`` on CPU tensors) against the JAX single-stream frame kernel
``aruco_slam_tpu.ops.kernels.ekf_update.frame_update`` in interpret mode,
on the cases of the JAX package's own kernel tests: a mixed chain of known
and new markers, a capacity overflow, the gate off with reject-divergent
on, and the uninitialized no-op; the frame step against JAX's
``ekf.predict_block`` followed by that kernel, at 0, 1 and 10 encoder
ticks from initialized and uninitialized states; and at 300 observation
slots against ``predict_block`` then JAX's ``ekf.update``. Integer fields
exact; mu, sigma, last_obs to atol 5e-5 / rtol 5e-3 (float32 sums in
another order, carried over a few frames)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.ops.kernels import ekf_update as jkern
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import ekf_update

torch.set_num_threads(1)

JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=12, max_observations_per_frame=6))
INTS = ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged", "dropped")


def _frame(rng, ids, m=6):
    a = np.full(m, -1, np.int32)
    a[: len(ids)] = ids
    z = np.zeros((m, 3), np.float32)
    z[: len(ids)] = rng.uniform(0.3, 2, (len(ids), 3))
    R = np.tile(np.eye(3, dtype=np.float32) * 0.05, (m, 1, 1))
    v = np.zeros(m, bool)
    v[: len(ids)] = True
    return a, z, R, v


def _jstate(jcfg, initialized=True):
    state = jekf.init_state(jcfg)._replace(initialized=jnp.asarray(initialized))
    if initialized:
        for _ in range(3):
            state = jekf.predict(
                state, jekf.Control(jnp.float32(1.2), jnp.float32(1.0), jnp.float32(0.05)), jcfg
            )
    return state


def _assert_same(ours, ref):
    for name in INTS:
        np.testing.assert_array_equal(getattr(ours, name)[0].numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("mu", "sigma", "last_obs"):
        np.testing.assert_allclose(getattr(ours, name)[0].numpy(), np.asarray(getattr(ref, name)),
                                   atol=5e-5, rtol=5e-3, err_msg=name)


def _run(jcfg, frames, seed):
    """Both kernels over the frames from one predicted state, each chain
    feeding itself; compared after every frame. A frame is a list of ids
    (valid, first) or a ready (ids, z, R, valid) tuple."""
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)
    ref = _jstate(jcfg)
    ours = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for ids in frames:
        a, z, R, v = ids if isinstance(ids, tuple) else _frame(rng, ids)
        ref = jkern.frame_update(ref, jekf.FrameObservations(*map(jnp.asarray, (a, z, R, v))),
                                 jcfg, interpret=True)
        frame = ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in (a, z, R, v)))
        ours = ekf_update.frame_update(ours, frame, cfg)
        _assert_same(ours, ref)
    return ours


@pytest.mark.parametrize("case", ["mixed", "capacity_overflow", "gate_off_reject"])
def test_frame_update_plain_matches_jax_kernel(case):
    launches = dict(ekf_update.LAUNCHES)
    if case == "mixed":
        out = _run(JCFG, ([3, 5], [5, 9, 3], [9, 1], [1, 3, 5, 9]), 0)
        assert int(out.n_landmarks[0]) == 4
    elif case == "capacity_overflow":
        jcfg = dataclasses.replace(JCFG, ekf=jconfig.EkfConfig(max_landmarks=2,
                                                               max_observations_per_frame=6))
        out = _run(jcfg, ([1, 2, 3],), 1)
        assert int(out.dropped[0]) == 1
    else:
        jcfg = dataclasses.replace(
            JCFG, compat=jconfig.CompatConfig(stationary_gate=False, reject_divergent=True)
        )
        _run(jcfg, ([2, 4], [4, 2], [2, 4, 6]), 2)
    assert ekf_update.LAUNCHES == launches  # CPU tensors never launch


def test_frame_update_plain_uninitialized_noop():
    cfg = convert.config_from_dict(dataclasses.asdict(JCFG))
    rng = np.random.default_rng(3)
    a, z, R, v = _frame(rng, [3])
    ref_state = _jstate(JCFG, initialized=False)
    ref = jkern.frame_update(ref_state, jekf.FrameObservations(*map(jnp.asarray, (a, z, R, v))),
                             JCFG, interpret=True)
    state = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, ref_state), "cpu")
    out = ekf_update.frame_update(
        state, ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in (a, z, R, v))), cfg
    )
    _assert_same(out, ref)
    for name in ekf.EkfState._fields:
        assert torch.equal(getattr(out, name), getattr(state, name)), name


def test_frame_update_plain_matches_jax_kernel_in_arrival_order():
    """Observations as they arrive, not sorted: known and new markers
    interleaved, a marker seen twice in the frame, and invalid entries (one
    with a known id) between valid ones."""
    rng = np.random.default_rng(4)
    first = _frame(rng, [3, 5, 9])
    ids = np.array([9, 5, 7, 3, -1, 9], np.int32)
    valid = np.array([True, False, True, True, False, True])
    z = rng.uniform(0.3, 2, (6, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32) * 0.05, (6, 1, 1))
    out = _run(JCFG, (first, (ids, z, R, valid)), 4)
    assert int(out.n_landmarks[0]) == 4
    assert out.slot_ids[0, :4].tolist() == [3, 5, 9, 7]


def test_variant_is_chosen_by_size_alone():
    """The cluster variant, 16 CTAs, wherever sigma fits their shared memory
    (227 KB each), the grid variant above; never fewer than 3 columns (the
    pose block) per CTA."""
    n = lambda lm: 3 + 3 * lm  # noqa: E731
    assert ekf_update.variant(n(64)) == ("cluster", 16)  # SlamSystem's default
    assert ekf_update.variant(n(128)) == ("cluster", 16)  # config 2
    assert ekf_update.cluster_shared_bytes(n(128), 16) == 46_468  # 25 columns a CTA, the compose
    assert ekf_update.MAX_CLUSTER_LANDMARKS == 308
    assert ekf_update.cluster_shared_bytes(n(308), 16) <= ekf_update.MAX_SHARED_BYTES
    assert ekf_update.cluster_shared_bytes(n(309), 16) > ekf_update.MAX_SHARED_BYTES
    assert ekf_update.variant(n(308)) == ("cluster", 16)
    assert ekf_update.variant(n(309)) == ("grid", 0)
    assert ekf_update.variant(n(512)) == ("grid", 0)
    assert ekf_update.variant(n(5)) == ("cluster", 6)
    assert ekf_update.variant(n(1)) == ("cluster", 2)
    for lm in range(1, 309):
        kind, ctas = ekf_update.variant(n(lm))
        assert kind == "cluster" and -(-n(lm) // ctas) >= 3


def _ticks(rng, n):
    """n encoder ticks (wl, wr, dt), float32."""
    w = rng.uniform(0.5, 2.0, (2, n)).astype(np.float32)
    return w[0], w[1], rng.uniform(0.02, 0.08, n).astype(np.float32)


def _gate_frames(rng):
    """Three frames: two new markers; both known and a third new one; then
    marker 5 again at the record the second frame left (a stationary-gate
    hit), marker 3 moved and a fourth new one."""
    second = _frame(rng, [5, 9, 3])
    a, z, R, v = _frame(rng, [5, 3, 11])
    z[0] = second[1][0]  # marker 5 where it was seen last frame
    return _frame(rng, [3, 5]), second, (a, z, R, v)


@pytest.mark.parametrize("ticks", [0, 1, 10])
@pytest.mark.parametrize("initialized", [True, False])
@pytest.mark.parametrize("case", ["gate", "capacity_drop"])
def test_frame_step_plain_matches_jax_predict_then_kernel(case, initialized, ticks):
    """``frame_step``'s plain version (the predict over the frame's ticks,
    then the update) against JAX's ``predict_block`` followed by the Pallas
    ``frame_update``, frame after frame from an initialized or an
    uninitialized state: the latch spends an uninitialized state's first
    tick, and the frame runs even with no tick (``predict_block`` sets the
    latch)."""
    rng = np.random.default_rng(10 * ticks + initialized)
    jcfg = JCFG if case == "gate" else dataclasses.replace(
        JCFG, ekf=jconfig.EkfConfig(max_landmarks=2, max_observations_per_frame=6))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    frames = _gate_frames(rng) if case == "gate" else ([1, 2, 3], [2, 4, 1])
    ref = _jstate(jcfg, initialized)
    ours = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    launches = dict(ekf_update.LAUNCHES)
    for ids in frames:
        a, z, R, v = ids if isinstance(ids, tuple) else _frame(rng, ids)
        wl, wr, dt = _ticks(rng, ticks)
        ref = jekf.predict_block(ref, jekf.Control(*map(jnp.asarray, (wl, wr, dt))), jcfg)
        ref = jkern.frame_update(ref, jekf.FrameObservations(*map(jnp.asarray, (a, z, R, v))),
                                 jcfg, interpret=True)
        ours = ekf_update.frame_step(
            ours, ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in (a, z, R, v))),
            ekf.Control(*(torch.as_tensor(x)[None] for x in (wl, wr, dt))), cfg)
        _assert_same(ours, ref)
    assert bool(ours.initialized[0])
    if case == "gate":
        assert int(ours.n_landmarks[0]) == 4
    else:
        assert int(ours.dropped[0]) == 2 and int(ours.n_landmarks[0]) == 2
    assert ekf_update.LAUNCHES == launches  # CPU tensors never launch


def _wide_frames(rng, m=300, n_first=10):
    """Two frames of ``m`` observation slots: ``n_first`` new markers, then
    a frame whose ids repeat (each of those markers many times, near where
    it was first seen) with 8 new ids among them, 6 past a 16-slot map's
    capacity, and about a fifth of the slots invalid (padding ids among
    them), in arrival order."""
    first = _frame(rng, list(range(n_first)), m)
    ids = rng.choice(np.r_[np.arange(n_first), 100 + np.arange(8)], m).astype(np.int32)
    valid = rng.random(m) > 0.2
    ids[~valid & (rng.random(m) > 0.5)] = -1
    z = np.where((ids < n_first)[:, None], first[1][np.minimum(ids, n_first - 1)],
                 rng.uniform(0.3, 2, (m, 3))).astype(np.float32)
    z += rng.normal(0, 0.03, z.shape).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32) * 0.05, (m, 1, 1))
    return first, (ids, z, R, valid)


def test_frame_step_plain_matches_jax_at_300_observations():
    """A frame 300 slots wide (wider than the kernels keep their prologue
    in shared memory for): ``frame_step``'s plain version against JAX's
    ``predict_block`` then its sequential ``ekf.update`` (the Pallas
    kernel's semantics; in interpret mode a frame this wide takes many
    minutes) on a 16-slot map, ids repeated across the frame with new,
    dropped and invalid entries among them. This is the reference the
    card's cases at M 300 are held to."""
    rng = np.random.default_rng(300)
    jcfg = dataclasses.replace(JCFG, ekf=jconfig.EkfConfig(max_landmarks=16,
                                                           max_observations_per_frame=300))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    ref = _jstate(jcfg)
    ours = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    assert ekf_update.MAX_SHARED_OBS < 300
    for a, z, R, v in _wide_frames(rng):
        wl, wr, dt = _ticks(rng, 10)
        ref = jax.jit(jekf.update, static_argnums=2)(
            jekf.predict_block(ref, jekf.Control(*map(jnp.asarray, (wl, wr, dt))), jcfg),
            jekf.FrameObservations(*map(jnp.asarray, (a, z, R, v))), jcfg)
        ours = ekf_update.frame_step(
            ours, ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in (a, z, R, v))),
            ekf.Control(*(torch.as_tensor(x)[None] for x in (wl, wr, dt))), cfg)
        _assert_same(ours, ref)
    assert int(ours.n_landmarks[0]) == 16 and int(ours.dropped[0]) > 0


def test_frame_step_gate_hit_zeroes_the_record():
    """The last of ``_gate_frames`` hits the stationary gate: JAX's
    predict + kernel and the port's frame step both leave marker 5's
    last_obs at zero (quirk (c)) and count it seen."""
    rng = np.random.default_rng(7)
    cfg = convert.config_from_dict(dataclasses.asdict(JCFG))
    ref = _jstate(JCFG)
    ours = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for a, z, R, v in _gate_frames(rng):
        wl, wr, dt = _ticks(rng, 10)
        ref = jkern.frame_update(
            jekf.predict_block(ref, jekf.Control(*map(jnp.asarray, (wl, wr, dt))), JCFG),
            jekf.FrameObservations(*map(jnp.asarray, (a, z, R, v))), JCFG, interpret=True)
        ours = ekf_update.frame_step(
            ours, ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in (a, z, R, v))),
            ekf.Control(*(torch.as_tensor(x)[None] for x in (wl, wr, dt))), cfg)
        _assert_same(ours, ref)
    slot = int(np.flatnonzero(np.asarray(ref.slot_ids) == 5)[0])
    assert np.asarray(ref.last_obs)[slot].tolist() == [0.0, 0.0, 0.0]
    assert ours.last_obs[0, slot].tolist() == [0.0, 0.0, 0.0] and bool(ours.seen_prev[0, slot])


def test_frame_step_reads_frame_f_of_time_major_frames():
    """With rows, the step takes frame ``rows.f`` of the replay's time-major
    observations and ticks, equal to the same frame handed over alone, and
    writes that frame's rows; ``replay_step``'s ``rep(f)`` gives the same
    states and rows."""
    rng = np.random.default_rng(8)
    cfg = convert.config_from_dict(dataclasses.asdict(JCFG))
    frames = [_frame(rng, ids) for ids in ([3, 5], [5, 9, 3], [9, 1])]
    ticks = [_ticks(rng, 10) for _ in frames]
    every = ekf.FrameObservations(*(torch.as_tensor(np.stack(x)) for x in zip(*frames)))
    every_ticks = ekf.Control(*(torch.as_tensor(np.stack(x)) for x in zip(*ticks)))
    rows = ekf_update.Rows(torch.zeros(3, 3), torch.zeros(3, 3, 3),
                           torch.zeros(3, dtype=torch.int32))
    state = alone = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, _jstate(JCFG)), "cpu")
    rep_rows = ekf_update.Rows(torch.zeros(3, 3), torch.zeros(3, 3, 3),
                               torch.zeros(3, dtype=torch.int32))
    rep = ekf_update.replay_step(state, every, every_ticks, cfg, rep_rows)
    for f in range(3):
        rows.f = f
        state = ekf_update.frame_step(state, every, every_ticks, cfg, None, rows)
        for a, b in zip(rep(f), state):
            assert torch.equal(a, b)
        alone = ekf_update.frame_step(
            alone, ekf.FrameObservations(*(torch.as_tensor(x)[None] for x in frames[f])),
            ekf.Control(*(torch.as_tensor(x)[None] for x in ticks[f])), cfg)
        for a, b in zip(state, alone):
            assert torch.equal(a, b)
        assert torch.equal(rows.trajectory[f], state.mu[0, :3])
        assert torch.equal(rows.pose_cov[f], state.sigma[0, :3, :3])
        assert int(rows.n_landmarks[f]) == int(state.n_landmarks[0])
    for name in ("trajectory", "pose_cov", "n_landmarks"):
        assert torch.equal(getattr(rep_rows, name), getattr(rows, name))


def test_replay_calls_the_frame_step_once_a_frame(monkeypatch):
    """``runner.replay`` with the default backend makes K6's replay step
    once (``ekf_update.replay_step``, which checks the inputs) and runs it
    once per frame, and ``predict_block`` only inside it (the predict is
    the step's, not the loop's)."""
    from aruco_slam_tpu.sim import synthetic as jsyn

    seq = jsyn.generate_sequence(jsyn.SimParams(duration=2.0, seed=5, max_obs=6))
    data = runner.replay_data_from_sequence(seq, "obs", "cpu")
    cfg = convert.config_from_dict(dataclasses.asdict(JCFG))
    made, calls, inside, predicts = [], [], [False], []
    real_make, real_step = ekf_update.replay_step, ekf_update.Replay.__call__
    real_predict = ekf.predict_block

    def spy_make(*a, **k):
        made.append(1)
        return real_make(*a, **k)

    def spy_step(self, f):
        calls.append(f)
        inside[0] = True
        try:
            return real_step(self, f)
        finally:
            inside[0] = False

    def spy_predict(*a, **k):
        predicts.append(inside[0])
        return real_predict(*a, **k)

    monkeypatch.setattr(ekf_update, "replay_step", spy_make)
    monkeypatch.setattr(ekf_update.Replay, "__call__", spy_step)
    monkeypatch.setattr(ekf, "predict_block", spy_predict)
    res = runner.replay(data, cfg)
    F = data.obs_ids.shape[0]
    assert made == [1] and calls == list(range(F))
    assert predicts == [True] * F
    assert res.trajectory.shape == (F, 3)


def test_frame_step_for_policy():
    """The replay's step by configuration: K6's frame step for "auto" and
    "pallas"; the plain predict and update for "xla"; the predict and
    ``update_fused`` under ``fused_update``."""
    def cfg(**kw):
        return convert.config_from_dict(dataclasses.asdict(dataclasses.replace(
            JCFG, ekf=dataclasses.replace(JCFG.ekf, **kw))))

    for backend in ("auto", "pallas"):
        assert runner.frame_step_for(cfg(update_backend=backend)) is ekf_update.frame_step
    assert runner.frame_step_for(cfg(update_backend="xla")) is ekf_update.frame_step_reference
    fused = runner.frame_step_for(cfg(fused_update=True))
    assert fused.func is ekf_update.frame_step_reference
    assert fused.keywords == {"update": ekf.update_fused}
    with pytest.raises(ValueError, match="update_backend"):
        runner.frame_step_for(cfg(update_backend="mosaic"))
