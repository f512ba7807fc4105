"""The port's EKF core: in float64 against the dense float64 oracle
(tests/reference_ekf.py) to 1e-8, and in float32 against the JAX package —
the encoder-tick compose against ``ekf.predict_compose``, and the plain
version of the K2 frame step against the JAX K2 kernel in interpret mode
with the state carried across by ``convert`` (ints exact, mu/sigma to
atol 5e-5 / rtol 5e-3, tests/test_pallas_kernels.py:262-272)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.ops.kernels import ekf_update_batched as jkb
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched
from aruco_slam_tpu_torch.utils.config import CompatConfig, EkfConfig, SlamConfig
from reference_ekf import ReferenceEKF

torch.set_num_threads(1)

CFG = SlamConfig(ekf=EkfConfig(max_landmarks=12, max_observations_per_frame=6))
F64 = torch.float64


def random_sequence(rng, n_steps=40, n_markers=8, gate_hits=False):
    """Mixed encoder ticks and frames of 1-3 random observations (the
    style of tests/test_ekf.py), with repeated measurements when
    ``gate_hits`` so the stationary gate fires."""
    seq = [("enc", (0.0, 0.0, 0.1))]  # first tick: the latch
    prev_z = {}
    for t in range(n_steps):
        seq.append(("enc", (float(rng.uniform(0.5, 3.0)), float(rng.uniform(0.5, 3.0)), 0.05)))
        if t % 2 == 0:
            ids = list(rng.choice(n_markers, size=int(rng.integers(1, 4)), replace=False))
            zs, Rs = [], []
            for aid in ids:
                if gate_hits and aid in prev_z and rng.uniform() < 0.5:
                    z = prev_z[aid] + rng.normal(scale=0.001, size=3)
                else:
                    z = np.array([rng.uniform(0.3, 2.0), rng.uniform(-1, 1), rng.uniform(-0.5, 0.5)])
                prev_z[aid] = z
                zs.append(z)
                Rs.append(np.diag(rng.uniform(0.01, 0.3, size=3)))
            seq.append(("img", (ids, zs, Rs)))
    return seq


def frame_of(ids, zs, Rs, m, dtype):
    k = len(ids)
    ids_a = np.full((1, m), -1, np.int32)
    z_a = np.zeros((1, m, 3))
    R_a = np.tile(np.eye(3), (1, m, 1, 1))
    valid = np.zeros((1, m), bool)
    ids_a[0, :k] = ids
    if k:
        z_a[0, :k] = zs
        R_a[0, :k] = Rs
    valid[0, :k] = True
    return ekf.FrameObservations(
        torch.as_tensor(ids_a), torch.as_tensor(z_a, dtype=dtype),
        torch.as_tensor(R_a, dtype=dtype), torch.as_tensor(valid),
    )


@pytest.mark.parametrize(
    "seed,gate_hits,stationary_gate",
    [(0, False, True), (1, False, True), (2, False, True), (3, True, True), (4, True, False)],
)
def test_float64_matches_oracle(seed, gate_hits, stationary_gate):
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(CFG, compat=CompatConfig(stationary_gate=stationary_gate))
    state = ekf.init_state(cfg, 1, "cpu", dtype=F64)
    oracle = ReferenceEKF(stationary_gate=stationary_gate)
    for kind, payload in random_sequence(rng, gate_hits=gate_hits):
        if kind == "enc":
            wl, wr, dt = (torch.tensor([v], dtype=F64) for v in payload)
            state = ekf.predict(state, ekf.Control(wl, wr, dt), cfg)
            oracle.add_encoder(*payload)
        else:
            state = ekf.update(state, frame_of(*payload, m=6, dtype=F64), cfg)
            oracle.add_frame(list(zip(*payload)))
    n = 3 + 3 * len(oracle.id_map)
    mu, sig = state.mu[0].numpy(), state.sigma[0].numpy()
    assert int(state.n_landmarks[0]) == len(oracle.id_map)
    np.testing.assert_allclose(mu[:n], oracle.mu, atol=1e-8, rtol=0)
    np.testing.assert_allclose(sig[:n, :n], oracle.sigma, atol=1e-8, rtol=0)
    assert np.all(mu[n:] == 0) and np.all(sig[n:, :] == 0) and np.all(sig[:, n:] == 0)


def test_new_markers_before_known_and_capacity_drop():
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=2, max_observations_per_frame=4))
    state = ekf.init_state(cfg, 1, "cpu", dtype=F64)
    one = torch.ones(1, dtype=F64)
    state = ekf.predict(state, ekf.Control(0 * one, 0 * one, 0.1 * one), cfg)
    state = ekf.predict(state, ekf.Control(one, 1.2 * one, 0.05 * one), cfg)
    R = np.eye(3) * 0.05
    state = ekf.update(state, frame_of([5], [np.array([1.0, 0, 0])], [R], 4, F64), cfg)
    # arrival: known 5 first, then new 7 and 9; 7 is inserted first, 9 drops
    state = ekf.update(
        state,
        frame_of([5, 7, 9], [np.array([1.0, 0.1, 0]), np.array([0.5, -0.4, 0.2]),
                             np.array([0.7, 0.4, 0.1])], [R, R, R], 4, F64),
        cfg,
    )
    assert state.slot_ids[0].tolist() == [5, 7]
    assert int(state.dropped[0]) == 1 and int(state.n_landmarks[0]) == 2


def test_predict_compose_matches_jax():
    rng = np.random.default_rng(7)
    B, T = 3, 10
    pose0 = rng.normal(size=(B, 3)).astype(np.float32)
    w = rng.uniform(-1.0, 3.0, (B, T, 2)).astype(np.float32)
    dt = rng.uniform(0.005, 0.02, (B, T)).astype(np.float32)
    init = np.array([False, True, True])
    jcfg = jconfig.SlamConfig()
    for kl_both in (True, False):
        cfg = dataclasses.replace(
            CFG, compat=CompatConfig(process_noise_uses_kl_for_both_wheels=kl_both)
        )
        jc = dataclasses.replace(
            jcfg, compat=jconfig.CompatConfig(process_noise_uses_kl_for_both_wheels=kl_both)
        )
        out = ekf.predict_compose(
            torch.as_tensor(pose0), torch.as_tensor(init),
            ekf.Control(torch.as_tensor(w[..., 0]), torch.as_tensor(w[..., 1]),
                        torch.as_tensor(dt)), cfg,
        )
        ref = jax.vmap(
            lambda p, i, a, b, d: jekf.predict_compose(p, i, jekf.Control(a, b, d), jc)
        )(pose0, init, w[..., 0], w[..., 1], dt)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def _frame(f, data):
    """Frame f's observations and encoder ticks, as runner.replay_batch
    hands them to K2."""
    ew = data.enc_w[:, f]
    frame = ekf.FrameObservations(*(x[:, f].contiguous() for x in (
        data.obs_ids, data.obs_z, data.obs_R, data.obs_valid)))
    return frame, ekf.Control(ew[..., 0], ew[..., 1], data.enc_dt[:, f])


@pytest.mark.parametrize("reject_divergent", [False, True])
def test_frame_step_plain_matches_jax_kernel(reject_divergent):
    """The plain K2 against the JAX K2 (interpret mode) on consecutive
    frames of real inputs, including capacity drops (3 slots, 20 markers)."""
    compat = dict(reject_divergent=reject_divergent, divergence_ze_norm=0.03)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=3, max_observations_per_frame=6),
                     compat=CompatConfig(**compat))
    jcfg = jconfig.SlamConfig(
        ekf=jconfig.EkfConfig(max_landmarks=3, max_observations_per_frame=6),
        compat=jconfig.CompatConfig(**compat),
    )
    seqs = [
        jsyn.generate_sequence(jsyn.SimParams(duration=2.0, seed=s, max_obs=6))
        for s in range(3)
    ]
    data = runner.build_batch_data(seqs, 3, "obs", "cpu")
    warm = runner.replay_batch(data._replace(**{
        k: v[:, :6] for k, v in data._asdict().items() if v is not None
    }), cfg)
    state = warm.final_state
    for f in range(6, 10):
        frame, controls = _frame(f, data)
        ours = ekf_update_batched.frame_step_batched(state, frame, controls, cfg)
        args = ekf_update_batched.frame_step_inputs(state, frame, controls, cfg)
        pose, A, Q, ids, z, R9, valid, slots = (a.numpy() for a in args)
        out = jkb.frame_step_batched(
            convert.batched_state_to_trailing(state), pose.T, A.T, Q.T, ids.T,
            np.transpose(z, (1, 2, 0)), np.transpose(R9, (1, 2, 0)),
            valid.T.astype(np.int32), slots.T, jcfg, interpret=True,
        )
        ref = convert.batched_state_from_trailing(jax.tree.map(np.asarray, out), device="cpu")
        for name in ("slot_ids", "n_landmarks", "seen_prev", "diverged", "dropped"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), name)
        for name in ("mu", "sigma", "last_obs"):
            np.testing.assert_allclose(
                getattr(ours, name), getattr(ref, name), atol=5e-5, rtol=5e-3, err_msg=name
            )
        assert bool(ours.initialized.all())  # the step sets the latch
        state = ours
    assert int(state.dropped.sum()) > 0  # capacity drops exercised
    if not reject_divergent:
        assert int(state.diverged.sum()) > 0  # the divergence counter fired


def test_state_conversion_round_trip():
    rng = np.random.default_rng(8)
    B, L = 2, 4
    N = 3 + 3 * L
    st = jekf.EkfState(
        mu=rng.normal(size=(B, N)).astype(np.float32),
        sigma=rng.normal(size=(B, N, N)).astype(np.float32),
        slot_ids=rng.integers(-1, 9, (B, L)).astype(np.int32),
        n_landmarks=np.array([1, 3], np.int32),
        last_obs=rng.normal(size=(B, L, 3)).astype(np.float32),
        seen_prev=rng.uniform(size=(B, L)) < 0.5,
        initialized=np.array([True, False]),
        diverged=np.array([0, 2], np.int32),
        dropped=np.array([1, 0], np.int32),
    )
    ours = convert.ekf_state_from_numpy(st, "cpu")
    back = convert.ekf_state_to_numpy(ours)
    for name in jekf.EkfState._fields:
        np.testing.assert_array_equal(back[name], getattr(st, name), name)
    single = convert.ekf_state_from_numpy(jax.tree.map(lambda x: x[1], st), "cpu")
    np.testing.assert_array_equal(single.sigma[0].numpy(), st.sigma[1])
    trail = convert.batched_state_to_trailing(ours)
    again = convert.batched_state_from_trailing(trail, initialized=st.initialized,
                                             device="cpu")
    for name in ekf.EkfState._fields:
        np.testing.assert_array_equal(getattr(again, name), getattr(ours, name), name)
    assert trail["sigma"].shape == (N, N, B) and trail["n_lm"].shape == (1, B)
