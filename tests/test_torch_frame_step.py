"""K2's whole frame step and the batched replay around it, on the CPU.

- The plain version of ``ekf_update_batched.frame_step_batched`` (compose,
  lookup, sort, sanitise, predict, the sequential update, symmetrize, the
  replay's rows) against the composition that the JAX package's
  ``_replay_batch_kernel`` runs per frame (``aruco_slam_tpu/runner.py``,
  ``frame_step``: vmapped ``predict_compose``, ``lookup_slots``, the
  argsort, the sanitise and the JAX K2 in interpret mode): ints exact,
  floats to atol 5e-5 / rtol 5e-3 (tests/test_pallas_kernels.py:262-272).
- ``runner.replay_batch`` at max_landmarks 96 and 128, past the old
  77-landmark ceiling of K2, against JAX's ``replay_batch``.
- The variant choice for every map size, and that a replay keeps no view
  of any per-frame state.
- ``runner.replay_batch`` under ``fused_update=True`` (each lane through
  ``update_fused``) and ``update_backend="xla"`` against JAX's.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.ops.kernels import ekf_update_batched as jkb
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import ekf_update, ekf_update_batched as kb

torch.set_num_threads(1)

INTS = ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged", "dropped")
FLOATS = ("mu", "sigma", "last_obs")


def _configs(max_lm, m=6, **compat):
    jcfg = jconfig.SlamConfig(
        ekf=jconfig.EkfConfig(max_landmarks=max_lm, max_observations_per_frame=m),
        compat=jconfig.CompatConfig(**compat),
    )
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def _jax_frame_step(state, init, ew, edt, ids, z, R, valid, jcfg):
    """One frame of ``_replay_batch_kernel``'s scan body at obs level, on a
    trailing-batch state; returns the new state and the frame's rows."""
    batch, m_obs = ids.shape
    compose = jax.vmap(lambda p, i, wl, wr, dt: jekf.predict_compose(
        p, i, jekf.Control(wl, wr, dt), jcfg))
    pose, A, Q = compose(state["mu"][:3].T, init, ew[..., 0], ew[..., 1], edt)
    slots = jax.vmap(jekf.lookup_slots)(state["slot_ids"].T, ids)
    arrival = jnp.arange(m_obs, dtype=jnp.int32)
    key = jnp.where(valid, slots * m_obs + arrival[None, :], 2_000_000_000)
    perm = jnp.argsort(key, axis=1)
    ids_s = jnp.take_along_axis(ids, perm, axis=1)
    valid_s = jnp.take_along_axis(valid, perm, axis=1)
    slots_s = jnp.take_along_axis(slots, perm, axis=1)
    z_s = jnp.take_along_axis(z, perm[..., None], axis=1)
    R_s = jnp.take_along_axis(R.reshape(batch, m_obs, 9), perm[..., None], axis=1)
    ok = valid_s[..., None]
    z_s = jnp.where(ok, z_s, 0.0)
    R_s = jnp.where(ok, R_s, jnp.eye(3, dtype=z_s.dtype).reshape(9))
    st = jkb.frame_step_batched(
        state, pose.T, A.reshape(batch, 9).T, Q.reshape(batch, 9).T, ids_s.T,
        jnp.transpose(z_s, (1, 2, 0)), jnp.transpose(R_s, (1, 2, 0)),
        valid_s.T.astype(jnp.int32), slots_s.T, jcfg, interpret=True,
    )
    rows = (st["mu"][:3].T, jnp.transpose(st["sigma"][:3, :3, :], (2, 0, 1)), st["n_lm"][0])
    return st, rows


@pytest.mark.parametrize("ticks", [10, 0])
@pytest.mark.parametrize("kl_both", [True, False])
def test_frame_step_plain_matches_jax_composition(ticks, kl_both):
    """Three frames through both sides from a warmed state: 3 slots over 20
    markers (capacity drops), lane 1 not yet initialized, NaN measurements
    in invalid slots (the sanitise)."""
    jcfg, cfg = _configs(3, process_noise_uses_kl_for_both_wheels=kl_both)
    seqs = [jsyn.generate_sequence(jsyn.SimParams(duration=2.0, seed=s, max_obs=6))
            for s in range(3)]
    data = runner.build_batch_data(seqs, 3, "obs", "cpu")
    warm = runner.replay_batch(data._replace(**{
        k: v[:, :6] for k, v in data._asdict().items() if v is not None}), cfg)
    state = warm.final_state._replace(initialized=torch.tensor([True, False, True]))
    B, F = 3, 3
    got = kb.Rows(torch.zeros(B, F, 3), torch.zeros(B, F, 3, 3),
                  torch.zeros(B, F, dtype=torch.int32), 0)
    rng = np.random.default_rng(ticks + kl_both)
    for f in range(F):
        g = 6 + f
        ew = rng.uniform(-1.0, 3.0, (B, ticks, 2)).astype(np.float32)
        edt = rng.uniform(0.005, 0.02, (B, ticks)).astype(np.float32)
        ids, valid = data.obs_ids[:, g].contiguous(), data.obs_valid[:, g].contiguous()
        z = torch.where(valid[..., None], data.obs_z[:, g], float("nan"))
        R = data.obs_R[:, g].contiguous()
        ew_t = torch.as_tensor(ew)
        controls = ekf.Control(ew_t[..., 0], ew_t[..., 1], torch.as_tensor(edt))
        frame = ekf.FrameObservations(ids, z, R, valid)
        ours = kb.frame_step_batched(state, frame, controls, cfg, rows=got._replace(f=f))
        jst, jrows = _jax_frame_step(
            convert.batched_state_to_trailing(state), state.initialized.numpy(), ew, edt,
            ids.numpy(), z.numpy(), R.numpy(), valid.numpy(), jcfg)
        ref = convert.batched_state_from_trailing(
            jax.tree.map(np.asarray, jst), initialized=np.ones(B, bool), device="cpu")
        for name in INTS:
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), name)
        for name in FLOATS:
            np.testing.assert_allclose(getattr(ours, name), getattr(ref, name),
                                       atol=5e-5, rtol=5e-3, err_msg=name)
        for a, b in zip(got[:2], jrows[:2]):
            np.testing.assert_allclose(a[:, f].numpy(), np.asarray(b), atol=5e-5, rtol=5e-3)
        np.testing.assert_array_equal(got.n_landmarks[:, f].numpy(), np.asarray(jrows[2]))
        state = ours
    assert int(state.dropped.sum()) > 0  # capacity drops exercised


def _large_map_data(level):
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    seqs = [jsyn.generate_sequence(jsyn.SimParams(duration=3.0, seed=s, max_obs=6),
                                   level="corners", camera=jcam) for s in range(2)]
    return seqs, seqs[0].camera()


@pytest.mark.parametrize("max_lm", [96, 128])
@pytest.mark.parametrize("level", ["obs", "corners"])
def test_replay_batch_large_maps_match_jax(max_lm, level):
    """Maps past the old 77-landmark ceiling of K2 replay in the port as in
    JAX (whose replay_batch takes every max_landmarks): 2 lanes, 30 frames."""
    jcfg, cfg = _configs(max_lm)
    seqs, cam = _large_map_data(level)
    assert kb.variant(3 + 3 * max_lm)[0] == "cluster"
    ours = runner.replay_batch(
        runner.build_batch_data(seqs, 2, level, "cpu"), cfg,
        convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.dist), level)
    ref = jrunner.replay_batch(jrunner.build_batch_data(seqs, 2, level), jcfg,
                               cam if level == "corners" else None, level)
    _assert_replays_match(ours, ref)


def _assert_replays_match(ours, ref):
    """A port replay against JAX's: the trajectory within 1e-4, pose_cov
    within 1e-5, landmark counts and slots exact."""
    np.testing.assert_allclose(ours.trajectory.numpy(), np.asarray(ref.trajectory), atol=1e-4)
    np.testing.assert_allclose(ours.pose_cov.numpy(), np.asarray(ref.pose_cov), atol=1e-5)
    np.testing.assert_array_equal(ours.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    np.testing.assert_array_equal(ours.final_state.slot_ids.numpy(),
                                  np.asarray(ref.final_state.slot_ids))
    assert ours.trajectory.shape == (2, 30, 3) and int(ours.n_landmarks[:, -1].min()) > 0


def test_variant_covers_every_map_size():
    """Every max_landmarks from 1 to 1,024 has a variant whose kind is
    chosen by size alone and whose shared-memory plan fits a CTA at every
    batch: smem up to 77, the cluster layout (an N x W stripe, then pose, A,
    Q) up to 308, the device variant beyond."""
    seen = []
    for lm in range(1, 1025):
        n = 3 + 3 * lm
        kinds = set()
        for lanes in (1, 4, 32, 256):
            kind, ctas = kb.variant(n, lanes)
            kinds.add(kind)
            assert 1 <= ctas <= ekf_update.MAX_CLUSTER
            assert kb.shared_bytes(kind, n, lm, ctas=ctas) <= kb.MAX_SHARED_BYTES
            if kind == "smem":
                assert ctas == 1 and lm <= 77
            elif kind == "cluster":
                assert 77 < lm <= 308 and ctas >= kb.min_ctas("cluster", n) >= 2
                assert kb.stripe_width(n, ctas) == -(-n // ctas) >= 3
                assert kb.on_chip_rows("cluster", n, kb.MAX_SHARED_OBS, ctas) == n
                assert kb.shared_bytes("smem", n, lm) > kb.MAX_SHARED_BYTES
            else:
                assert lm > 308 and kb.on_chip_rows("device", n, kb.MAX_SHARED_OBS, ctas) < n
                assert kb.shared_bytes("cluster", n, lm, ctas=16) > kb.MAX_SHARED_BYTES
        assert len(kinds) == 1  # the kind does not depend on the batch
        if not seen or seen[-1] != kind:
            seen.append(kind)
    assert seen == ["smem", "cluster", "device"]
    assert (kb.MAX_SMEM_LANDMARKS, kb.MAX_CLUSTER_LANDMARKS) == (77, 308)
    # the smem plan of the main path's lane, and its smallest parts
    assert kb.shared_bytes("smem", 99, 32, 16) == 4 * (99 * 99 + 8 * 99 + 384 + 21 + 96 + 32 + 8)


@pytest.mark.parametrize("lanes", [1, 4, 32, 256])
@pytest.mark.parametrize("max_lm", [32, 128, 308, 512])
def test_variant_ctas_follow_size_and_batch(max_lm, lanes):
    """G, the CTAs a lane, at N = 99, 387, 927 and 1,539: the most CTAs
    (up to 16) with which the B lanes' clusters still fit the card at once
    (the H100's occupancy table), never fewer than the fewest whose stripe
    fits a CTA; one lane keeps K6's 16. The shared bytes of each G are the
    kernel's layout: sigma N x W (W = max(3, ceil(N / G))), mu W, B 6 W,
    K^T 3 N, the pose block 9, the reduction 64, slots and order 2 M, then
    pose, A, Q 21; the device variant takes all 227 KB, and the frame's
    active block runs on chip while its stripes fit what is left."""
    n = 3 + 3 * max_lm
    kind, ctas = kb.variant(n, lanes)
    assert kind == {32: "smem", 128: "cluster", 308: "cluster", 512: "device"}[max_lm]
    if kind == "smem":
        assert ctas == 1
        return
    lo = kb.min_ctas(kind, n)
    assert lo == {128: 3, 308: 16, 512: 1}[max_lm]
    resident = kb.H100_CLUSTERS
    if lanes == 1:
        assert ctas == 16
    if resident[lo - 1] < lanes:
        assert ctas == lo  # more than one wave whatever G: the fewest CTAs
    else:
        assert resident[ctas - 1] >= lanes
        assert ctas == 16 or resident[ctas] < lanes  # one more CTA a lane: two waves
    # a hypothetical card with room for every cluster gives 16
    assert kb.variant(n, lanes, lambda k, g: 10**6) == (kind, 16)
    for g in range(lo, 17):
        w = max(3, -(-n // g))
        want = 4 * (n * w + 7 * w + 3 * n + 9 + 64 + 2 * 16 + 21)
        if kind == "cluster":
            assert kb.shared_bytes(kind, n, max_lm, 16, ctas=g) == want <= kb.MAX_SHARED_BYTES
            assert kb.on_chip_rows(kind, n, 16, g) == n
        else:
            assert kb.shared_bytes(kind, n, max_lm, 16, ctas=g) == kb.MAX_SHARED_BYTES < want
            area = kb.MAX_SHARED_BYTES // 4 - (want // 4 - n * w)
            rows = kb.on_chip_rows(kind, n, 16, g)
            assert rows * max(3, -(-rows // g)) <= area < (rows + 3) * max(3, -(-(rows + 3) // g))
    if kind == "device":
        assert kb.on_chip_rows(kind, n, 16, 16) == 912  # about 300 landmarks on chip


def test_replay_holds_no_per_frame_state(monkeypatch):
    """The outputs are written in place and the state alternates between
    two buffers: after a 20-frame replay no frame's sigma is alive, the
    steps saw two state buffers only, and no output shares storage with
    the final state."""
    _, cfg = _configs(8)
    seqs = [jsyn.generate_sequence(jsyn.SimParams(duration=2.0, seed=s, max_obs=6))
            for s in range(2)]
    data = runner.build_batch_data(seqs, 2, "obs", "cpu")
    born, inputs = [], set()
    real_sorted, real_step = ekf.apply_sorted, kb.frame_step_reference

    def spy_sorted(*a, **k):
        out = real_sorted(*a, **k)
        born.append(weakref.ref(out.sigma))
        return out

    def spy_step(state, *a, **k):
        inputs.add(state.sigma.data_ptr())
        return real_step(state, *a, **k)

    monkeypatch.setattr(ekf, "apply_sorted", spy_sorted)
    monkeypatch.setattr(kb, "frame_step_reference", spy_step)
    res = runner.replay_batch_reference(data, cfg)
    assert len(born) == 20 and not any(r() is not None for r in born)
    assert len(inputs) == 2
    final = res.final_state
    finals = {t.untyped_storage().data_ptr() for t in final}
    for out in (res.trajectory, res.pose_cov, res.n_landmarks):
        assert out.untyped_storage().data_ptr() not in finals
        assert out.untyped_storage().nbytes() == out.numel() * out.element_size()
    np.testing.assert_array_equal(res.pose_cov[:, -1].numpy(), final.sigma[:, :3, :3].numpy())


def test_replay_checks_its_first_frame_only(monkeypatch):
    """The replay's frames are slices of the same arrays and its states
    alternate between the same two buffers, so K2's wrapper checks the
    first frame's call (the spare state, the rows and their aliasing
    included) and the later frames step without the checks."""
    _, cfg = _configs(8)
    seqs = [jsyn.generate_sequence(jsyn.SimParams(duration=2.0, seed=s, max_obs=6))
            for s in range(2)]
    data = runner.build_batch_data(seqs, 2, "obs", "cpu")
    checked, real_check = [], kb._check_inputs

    def spy_check(*a):
        checked.append(a[-2] is not None and a[-1] is not None)  # out and rows
        return real_check(*a)

    monkeypatch.setattr(kb, "_check_inputs", spy_check)
    res = runner.replay_batch(data, cfg)
    assert checked == [True] and res.trajectory.shape == (2, 20, 3)
    ref = runner.replay_batch_reference(data, cfg)
    for got, want in zip(res, ref):
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want)
    with pytest.raises(TypeError, match="z must be"):
        runner.replay_batch(data._replace(obs_z=data.obs_z.double()), cfg)


def _with_ekf(configs, **ekf):
    return tuple(dataclasses.replace(c, ekf=dataclasses.replace(c.ekf, **ekf)) for c in configs)


@pytest.mark.parametrize("level", ["obs", "corners"])
@pytest.mark.parametrize("ekf_options", [{"fused_update": True}, {"update_backend": "xla"}],
                         ids=["fused_update", "xla"])
def test_replay_batch_fused_update_matches_jax(level, ekf_options):
    """Under fused_update=True JAX's replay_batch vmaps its single-stream
    scan with update_fused, and the port replays each lane with
    update_fused; under update_backend="xla" JAX vmaps ekf.update, the
    sequential algebra of the port's K2. Both as the large-map parity test
    holds them: 2 lanes, 30 frames, 8 slots."""
    jcfg, cfg = _with_ekf(_configs(8), **ekf_options)
    seqs, cam = _large_map_data(level)
    ours = runner.replay_batch(
        runner.build_batch_data(seqs, 2, level, "cpu"), cfg,
        convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.dist), level)
    ref = jrunner.replay_batch(jrunner.build_batch_data(seqs, 2, level), jcfg,
                               cam if level == "corners" else None, level)
    _assert_replays_match(ours, ref)
