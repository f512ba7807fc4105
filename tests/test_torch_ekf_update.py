"""K6's plain version (``ops.kernels.ekf_update.frame_update`` on CPU
tensors) against the JAX single-stream frame kernel
``aruco_slam_tpu.ops.kernels.ekf_update.frame_update`` in interpret mode,
on the cases of the JAX package's own kernel tests: a mixed chain of known
and new markers, a capacity overflow, the gate off with reject-divergent
on, and the uninitialized no-op. Integer fields exact; mu, sigma, last_obs
to atol 5e-5 / rtol 5e-3 (float32 sums in another order, carried over a
few frames)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.ops.kernels import ekf_update as jkern
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert
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
    assert ekf_update.cluster_shared_bytes(n(128), 16) == 46_384  # 25 columns a CTA
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
