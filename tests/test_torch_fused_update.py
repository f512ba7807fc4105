"""The port's ``ekf.update_fused`` (single stream, batch of one) against
the JAX ``ekf.update_fused`` and against the port's sequential
``ekf.update``, on the cases of the JAX package's own fused-update tests;
and ``runner.frame_update_for``'s policy. Integer fields exact, float
fields to atol 5e-5 (the fused form is exact in real arithmetic; float32
rounds it in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_update import random_frame, random_state

from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.utils.config import CompatConfig, EkfConfig, SlamConfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import ekf_update
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)

ATOL = 5e-5
# One shape for every JAX call, so its eagerly compiled ops are shared.
CFG = SlamConfig(ekf=EkfConfig(max_landmarks=12, max_observations_per_frame=8))
INTS = ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged", "dropped")


def _port(jstate, jframe):
    state = convert.ekf_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    frame = ekf.FrameObservations(*(torch.as_tensor(np.array(x))[None] for x in jframe))
    return state, frame


def _assert_close(ours, ref):
    """``ours`` a port state (batch of one), ``ref`` a port or JAX state."""
    for name in ekf.EkfState._fields:
        a = getattr(ours, name)[0].numpy()
        b = getattr(ref, name)
        b = b[0].numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if name in INTS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def _check(cfg, jstate, jframe):
    """Port fused against JAX fused and against the port's sequential
    update; returns the port's fused state."""
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    state, frame = _port(jstate, jframe)
    ours = ekf.update_fused(state, frame, pcfg)
    _assert_close(ours, jekf.update_fused(jstate, jframe, cfg))
    _assert_close(ours, ekf.update(state, frame, pcfg))
    return ours


@pytest.mark.parametrize("seed", range(6))
def test_fused_matches_jax_and_sequential_mixed(seed):
    cfg = CFG
    rng = np.random.default_rng(seed)
    state = random_state(rng, cfg, n_lm=5)
    _check(cfg, state, random_frame(rng, cfg, state, n_known=3, n_new=2, n_invalid=3))


def test_fused_capacity_overflow():
    cfg = CFG
    rng = np.random.default_rng(7)
    state = random_state(rng, cfg, n_lm=10)
    out = _check(cfg, state, random_frame(rng, cfg, state, n_known=2, n_new=5, n_invalid=1))
    assert int(out.dropped[0]) > 0


def test_fused_stationary_gate():
    """One observation repeats its slot's last record, seen last frame."""
    cfg = CFG
    rng = np.random.default_rng(3)
    state = random_state(rng, cfg, n_lm=3)
    sid = int(np.asarray(state.slot_ids)[1])
    state = state._replace(seen_prev=jnp.asarray(np.arange(12) == 1))
    ids = np.full(8, -1, np.int32)
    ids[:2] = [sid, int(np.asarray(state.slot_ids)[0])]
    z = np.zeros((8, 3), np.float32)
    z[0] = np.asarray(state.last_obs)[1]
    z[1] = rng.normal(size=3).astype(np.float32) * 0.3
    R = np.broadcast_to(0.01 * np.eye(3, dtype=np.float32), (8, 3, 3)).copy()
    frame = jekf.FrameObservations(ids=jnp.asarray(ids), z=jnp.asarray(z), R=jnp.asarray(R),
                                   valid=jnp.asarray(np.arange(8) < 2))
    out = _check(cfg, state, frame)
    assert np.allclose(out.last_obs[0, 1].numpy(), 0.0)  # the gated slot's record


@pytest.mark.parametrize("reject", [False, True])
def test_fused_divergence_modes(reject):
    cfg = dataclasses.replace(
        CFG, compat=CompatConfig(reject_divergent=reject, divergence_ze_norm=0.4)
    )
    rng = np.random.default_rng(11)
    state = random_state(rng, cfg, n_lm=6)
    out = _check(cfg, state, random_frame(rng, cfg, state, n_known=5, n_new=1, n_invalid=2))
    assert int(out.diverged[0]) > 0


def test_fused_uninitialized_noop():
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=4))
    rng = np.random.default_rng(1)
    jstate = random_state(rng, cfg, n_lm=2)._replace(initialized=jnp.zeros((), bool))
    state, frame = _port(jstate, random_frame(rng, cfg, jstate, n_known=1, n_new=1, n_invalid=2))
    out = ekf.update_fused(state, frame, convert.config_from_dict(dataclasses.asdict(cfg)))
    for name in ekf.EkfState._fields:
        assert torch.equal(getattr(out, name), getattr(state, name)), name


def test_fused_refuses_a_batch():
    cfg = pconfig.SlamConfig(ekf=pconfig.EkfConfig(max_landmarks=4, max_observations_per_frame=2))
    state = ekf.init_state(cfg, 2, "cpu")
    frame = ekf.FrameObservations(torch.full((2, 2), -1, dtype=torch.int32),
                                  torch.zeros(2, 2, 3), torch.zeros(2, 2, 3, 3),
                                  torch.zeros(2, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="batch must be 1"):
        ekf.update_fused(state, frame, cfg)


def test_fused_multi_frame_replay_close():
    """Chained over 100 frames the fused and the sequential single-stream
    replays stay within 1e-3 of each other."""
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=10.0, seed=5))
    data = runner.replay_data_from_sequence(seq, "obs", "cpu")
    ekf_cfg = pconfig.EkfConfig(max_landmarks=24, max_observations_per_frame=8)
    r_seq = runner.replay(data, pconfig.SlamConfig(ekf=ekf_cfg), None, "obs")
    r_fus = runner.replay(
        data, pconfig.SlamConfig(ekf=dataclasses.replace(ekf_cfg, fused_update=True)), None, "obs"
    )
    assert float((r_seq.trajectory - r_fus.trajectory).abs().max()) < 1e-3
    assert torch.equal(r_seq.n_landmarks, r_fus.n_landmarks)


def test_frame_update_for_policy():
    """fused_update first, then an explicit "xla"; otherwise the kernels:
    K2 batched, K6 single-stream at every max_landmarks (the JAX
    package's Mosaic ceiling is not carried over)."""
    def cfg(max_landmarks=8, **kw):
        return pconfig.SlamConfig(ekf=pconfig.EkfConfig(max_landmarks=max_landmarks, **kw))

    for batched in (False, True):
        assert runner.frame_update_for(cfg(fused_update=True), batched) is ekf.update_fused
        assert runner.frame_update_for(cfg(update_backend="xla"), batched) is ekf.update
    for backend in ("auto", "pallas"):
        assert runner.frame_update_for(cfg(update_backend=backend), True) is runner.update_batched
        for lm in (8, 256, 512):
            assert runner.frame_update_for(cfg(lm, update_backend=backend), False) \
                is ekf_update.frame_update
    with pytest.raises(ValueError, match="update_backend"):
        runner.frame_update_for(cfg(update_backend="mosaic"), False)


def test_update_batched_matches_sequential():
    """The batched policy's K2 update (plain on the CPU) equals
    ``ekf.update`` lane by lane, an uninitialized lane included."""
    cfg = CFG
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(4)
    lanes = []
    for b in range(3):
        st = random_state(rng, cfg, n_lm=4)
        fr = random_frame(rng, cfg, st, n_known=2, n_new=2, n_invalid=2)
        lanes.append(_port(st._replace(initialized=jnp.asarray(b != 1)), fr))
    state = ekf.EkfState(*(torch.cat(x) for x in zip(*(s for s, _ in lanes))))
    frame = ekf.FrameObservations(*(torch.cat(x) for x in zip(*(f for _, f in lanes))))
    ours = runner.update_batched(state, frame, pcfg)
    ref = ekf.update(state, frame, pcfg)
    for name in ekf.EkfState._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if name in INTS:
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert torch.equal(ours.mu[1], state.mu[1])
