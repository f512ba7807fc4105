"""The port's bundle adjustment (``aruco_slam_tpu_torch.models.ba``) against
the JAX package's on the CPU. One numpy problem made from a seed is fed to
both solvers, each through its own ``prepare`` where packed.

- ``_residuals``, ``cost`` and ``_linearize``'s blocks, one ``_schur_matvec``
  and one ``_pcg``: within 1e-5 of the largest reference entry (float32).
- ``solve`` in each mode (fixed damping, adaptive LM, gauge deflation,
  packed with chain odometry, unpacked with general odometry factors):
  poses and landmarks within 1e-4 m / rad, cost history within rtol 1e-4,
  at 4 GN x 25 CG.
- A float64 port solve against the dense float64 normal-equations oracle
  (a copy of ``tests/test_ba.py``'s) within 1e-8.
- The port's counterparts of ``tests/test_ba.py``'s convergence tests with
  their own limits, the packed-against-unpacked check on uneven keyframes,
  the deterministic segment sum, and a solve that reads nothing back to
  the host.

``test_unrolled_gn_loop_matches_scan`` and
``test_seg_sum_lm_scan_matches_segment_sum`` have no counterpart: the port
has no unrolled GN loop and no gather tables (``models/ba.py``'s docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.models import ba as jba
from aruco_slam_tpu.models import graph_builder as jgb
from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.models import ba, graph_builder

torch.set_num_threads(1)

REL = 1e-5
SOLVE_ATOL = 1e-4
SOLVE_RTOL = 1e-4


def _near(got, want, rel=REL, what=""):
    """max |got - want| within ``rel`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} against scale {scale:.3e}"


def _t(p):
    return convert.ba_problem_from_numpy(p, "cpu")


def _j(p):
    return jax.tree.map(jnp.asarray, p)


def _with_closures(problem, n=6, seed=0):
    """``problem`` with ``n`` extra relative-pose factors between random
    keyframe pairs: the general (non-chain) odometry form."""
    rng = np.random.default_rng(seed)
    K = problem.poses.shape[0]
    i = rng.integers(0, K, n).astype(np.int32)
    j = ((i + rng.integers(2, K - 1, n)) % K).astype(np.int32)
    p = problem.poses.astype(np.float64)
    c, s = np.cos(p[i, 2]), np.sin(p[i, 2])
    dx, dy = p[j, 0] - p[i, 0], p[j, 1] - p[i, 1]
    z = np.stack([dx * c + dy * s, -dx * s + dy * c,
                  np.arctan2(np.sin(p[j, 2] - p[i, 2]), np.cos(p[j, 2] - p[i, 2]))], 1)
    w = np.tile(np.eye(3) / 0.05**2, (n, 1, 1))
    return problem._replace(
        odo_i=np.concatenate([problem.odo_i, i]),
        odo_j=np.concatenate([problem.odo_j, j]),
        odo_z=np.concatenate([problem.odo_z, z.astype(np.float32)]),
        odo_w=np.concatenate([problem.odo_w, w.astype(np.float32)]),
        odo_valid=np.ones(len(problem.odo_i) + n, bool),
    )


@pytest.fixture(scope="module")
def problem():
    p, _, _ = jgb.synthetic_ba_problem(60, 25, obs_per_kf=4, init_noise=0.2, seed=5)
    return _with_closures(p)


@pytest.fixture(scope="module")
def blocks(problem):
    """Both packages' linearizations of ``problem`` at a perturbed state."""
    rng = np.random.default_rng(1)
    poses = (problem.poses + rng.normal(scale=0.05, size=problem.poses.shape)).astype(np.float32)
    lms = (problem.landmarks + rng.normal(scale=0.05, size=problem.landmarks.shape)).astype(
        np.float32)
    jp = _j(problem)
    tp = _t(problem)
    prior = problem.poses[0]
    jlin = jba._linearize(jp, jnp.asarray(poses), jnp.asarray(lms), 1e-4,
                          prior_pose=jnp.asarray(prior))
    plan = ba.sum_plan(tp)
    tlin = ba._linearize(tp, torch.tensor(poses), torch.tensor(lms), 1e-4, plan,
                         prior_pose=torch.tensor(prior))
    return dict(poses=poses, lms=lms, jp=jp, tp=tp, plan=plan, jlin=jlin, tlin=tlin)


def test_residuals_and_cost_match_jax(blocks):
    b = blocks
    jparts = jba._residuals(b["jp"], jnp.asarray(b["poses"]), jnp.asarray(b["lms"]))
    tparts = ba._residuals(b["tp"], torch.tensor(b["poses"]), torch.tensor(b["lms"]))
    for jgroup, tgroup in zip(jparts, tparts):
        for name, jv, tv in zip(("r", "J_a", "J_b", "w"), jgroup, tgroup):
            _near(tv.numpy(), np.asarray(jv), what=name)
    prior = b["jp"].poses[0]
    want = float(jba.cost(b["jp"], jnp.asarray(b["poses"]), jnp.asarray(b["lms"]), prior))
    got = float(ba.cost(b["tp"], torch.tensor(b["poses"]), torch.tensor(b["lms"]),
                        b["tp"].poses[0]))
    _near(got, want, what="cost")


def test_linearize_matches_jax(blocks):
    b = blocks
    jlin, tlin = b["jlin"], b["tlin"]
    assert jlin.keys() == tlin.keys()
    for k in jlin:
        _near(tlin[k].numpy(), np.asarray(jlin[k]), what=k)
    # the public per-factor-kind blocks (what a sharded solve sums)
    K, L = b["poses"].shape[0], b["lms"].shape[0]
    jargs = (b["jp"], jnp.asarray(b["poses"]), jnp.asarray(b["lms"]))
    targs = (b["tp"], torch.tensor(b["poses"]), torch.tensor(b["lms"]))
    for name, got, want in (
        ("obs", ba.obs_linear_blocks(*targs), jba.obs_linear_blocks(*jargs, K, L)),
        ("odo", ba.odo_linear_blocks(*targs), jba.odo_linear_blocks(*jargs, K)),
    ):
        for i, (g, w) in enumerate(zip(got, want)):
            _near(g.numpy(), np.asarray(w), what=f"{name} block {i}")


def test_schur_matvec_and_pcg_match_jax(blocks):
    b = blocks
    v = np.random.default_rng(2).normal(size=b["poses"].shape).astype(np.float32)
    want = jba._schur_matvec(b["jlin"], b["jp"], jnp.asarray(v))
    got = ba._schur_matvec(b["tlin"], b["tp"], torch.tensor(v), b["plan"])
    _near(got.numpy(), np.asarray(want), what="S @ v")
    deflate = ba.gauge_rotation_mode(torch.tensor(b["poses"]))
    _near(deflate.numpy(), np.asarray(jba.gauge_rotation_mode(jnp.asarray(b["poses"]))),
          what="gauge mode")
    for d in (None, deflate):
        jx, jres = jba._pcg(b["jlin"], b["jp"], jnp.asarray(v), 8,
                            deflate=None if d is None else jnp.asarray(d.numpy()))
        tx, tres = ba._pcg(b["tlin"], b["tp"], torch.tensor(v), 8, b["plan"], deflate=d)
        _near(tx.numpy(), np.asarray(jx), what=f"pcg x (deflate={d is not None})")
        _near(tres.numpy(), np.asarray(jres), what="pcg residual history")


SOLVE_MODES = {
    "fixed": dict(adaptive=False, deflate_gauge=False, packed=False),
    "adaptive": dict(adaptive=True, deflate_gauge=False, packed=False),
    "deflate": dict(adaptive=False, deflate_gauge=True, packed=False),
    "packed": dict(adaptive=True, deflate_gauge=True, packed=True),
    "unpacked": dict(adaptive=True, deflate_gauge=True, packed=False),
}


@pytest.mark.parametrize("mode", sorted(SOLVE_MODES))
def test_solve_matches_jax(problem, mode):
    """Each mode at 4 GN x 25 CG. "packed" runs the chain problem through
    both packages' ``prepare``; the others run the problem with extra
    relative-pose factors unpacked."""
    opts = dict(SOLVE_MODES[mode])
    packed = opts.pop("packed")
    kw = dict(iters=4, cg_iters=25, damping=1e-4, **opts)
    if packed:
        chain = problem._replace(**{f: getattr(problem, f)[:59] for f in
                                    ("odo_i", "odo_j", "odo_z", "odo_w", "odo_valid")})
        jpacked, tables, static = jba.prepare(chain)
        tpacked, tstatic = ba.prepare(chain)
        assert tstatic == static and static["odo_chain"]
        for f in ba.BAProblem._fields:
            np.testing.assert_array_equal(getattr(tpacked, f), np.asarray(getattr(jpacked, f)))
        jout = jax.jit(lambda p, t: jba.solve(p, tables=t, **static, **kw))(jpacked, tables)
        tout = ba.solve(_t(tpacked), **tstatic, **kw)
    else:
        jout = jax.jit(lambda p: jba.solve(p, **kw))(_j(problem))
        tout = ba.solve(_t(problem), **kw)
    for name, got, want in zip(("poses", "landmarks"), tout[:2], jout[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SOLVE_ATOL, err_msg=name)
    hist = tout[2].cost_history.numpy()
    np.testing.assert_allclose(hist, np.asarray(jout[2].cost_history), rtol=SOLVE_RTOL)
    assert hist.shape == (5,) and hist[-1] < hist[0]


def dense_gn_step(problem, damping=1e-6):
    """Oracle: one Gauss-Newton step via the full dense (3K+3L) normal
    equations in float64 (a copy of tests/test_ba.py's)."""
    poses = np.asarray(problem.poses, np.float64)
    lms = np.asarray(problem.landmarks, np.float64)
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

    def add(a, bb, Ja, Jb, W, r, sa, sb):
        H[sa:sa + 3, sa:sa + 3] += Ja.T @ W @ Ja
        H[sb:sb + 3, sb:sb + 3] += Jb.T @ W @ Jb
        H[sa:sa + 3, sb:sb + 3] += Ja.T @ W @ Jb
        H[sb:sb + 3, sa:sa + 3] += Jb.T @ W @ Ja
        b[sa:sa + 3] += Ja.T @ W @ r
        b[sb:sb + 3] += Jb.T @ W @ r

    for i in range(len(problem.obs_kf)):
        if not problem.obs_valid[i]:
            continue
        k, l = int(problem.obs_kf[i]), int(problem.obs_lm[i])
        h, Jp, Jl = h_jac(poses[k], lms[l])
        r = np.asarray(problem.obs_z[i], np.float64) - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        add(k, l, Jp, Jl, np.asarray(problem.obs_w[i], np.float64), r, 3 * k, 3 * K + 3 * l)
    for i in range(len(problem.odo_i)):
        if not problem.odo_valid[i]:
            continue
        a, c2 = int(problem.odo_i[i]), int(problem.odo_j[i])
        h, Ji, Jj = h_jac(poses[a], poses[c2])
        r = np.asarray(problem.odo_z[i], np.float64) - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        add(a, c2, Ji, Jj, np.asarray(problem.odo_w[i], np.float64), r, 3 * a, 3 * c2)

    H[:3, :3] += np.asarray(problem.prior_w, np.float64)
    H += damping * np.eye(n)
    d = np.linalg.solve(H, b)
    return d[: 3 * K].reshape(K, 3), d[3 * K:].reshape(L, 3)


def test_float64_schur_cg_step_matches_dense_oracle():
    """In float64 one GN step of the port (200 CG iterations, an exact
    solve at this size) is the dense oracle's to 1e-8; the JAX test of the
    same step can hold its float32 solve to 5e-3 only."""
    problem, _, _ = graph_builder.synthetic_ba_problem(12, 8, obs_per_kf=4, seed=1,
                                                       dtype=np.float64)
    tp = _t(problem)
    assert tp.poses.dtype == torch.float64
    poses, lms, _ = ba.solve(tp, iters=1, cg_iters=200, damping=1e-6)
    dp_ref, dl_ref = dense_gn_step(problem)
    np.testing.assert_allclose(poses.numpy() - problem.poses, dp_ref, atol=1e-8)
    np.testing.assert_allclose(lms.numpy() - problem.landmarks, dl_ref, atol=1e-8)


def test_ba_converges_to_ground_truth():
    problem, true_poses, true_lms = graph_builder.synthetic_ba_problem(
        n_keyframes=60, n_landmarks=30, obs_per_kf=6, init_noise=0.15, seed=2)
    poses, lms, stats = ba.solve(_t(problem), iters=8, cg_iters=60, damping=1e-4)
    assert float(stats.final_cost) < float(stats.initial_cost) * 0.05
    err = np.linalg.norm(poses.numpy()[:, :2] - true_poses[:, :2], axis=1)
    assert err.mean() < 0.03, err.mean()
    lerr = np.linalg.norm(lms.numpy()[:, :2] - true_lms[:, :2], axis=1)
    assert lerr.mean() < 0.03, lerr.mean()


def _rotate_about_anchor(poses, lms, phi):
    """Rotate every pose k >= 1 and every landmark about pose 0's position
    by phi (tests/test_ba.py's displacement along the flat gauge mode)."""
    c, s = np.cos(phi), np.sin(phi)
    R = np.array([[c, -s], [s, c]])
    anchor = poses[0, :2]
    p = poses.copy()
    p[1:, :2] = (poses[1:, :2] - anchor) @ R.T + anchor
    p[1:, 2] = poses[1:, 2] + phi
    l = lms.copy()
    l[:, :2] = (lms[:, :2] - anchor) @ R.T + anchor
    l[:, 2] = lms[:, 2] + phi
    return p, l


def test_gauge_deflation_recovers_flat_mode():
    problem, _, true_lms = graph_builder.synthetic_ba_problem(
        n_keyframes=200, n_landmarks=60, obs_per_kf=4, obs_sigma=0.02,
        odo_sigma=0.1, init_noise=0.0, seed=9)
    p0, l0 = _rotate_about_anchor(problem.poses, problem.landmarks, 0.1)
    tp = _t(problem._replace(poses=p0.astype(np.float32), landmarks=l0.astype(np.float32)))
    kw = dict(iters=3, cg_iters=30, damping=1e-6)
    _, lms_plain, _ = ba.solve(tp, **kw)
    _, lms_defl, _ = ba.solve(tp, deflate_gauge=True, **kw)
    err_plain = np.linalg.norm(lms_plain.numpy()[:, :2] - true_lms[:, :2], axis=1).mean()
    err_defl = np.linalg.norm(lms_defl.numpy()[:, :2] - true_lms[:, :2], axis=1).mean()
    assert err_defl < 0.12, err_defl
    assert err_defl < 0.5 * err_plain, (err_plain, err_defl)


def test_adaptive_lm_rejects_bad_steps():
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=40, n_landmarks=20, obs_per_kf=5, init_noise=0.6, seed=11)
    _, _, stats = ba.solve(_t(problem), iters=10, cg_iters=40, damping=1e-6, adaptive=True)
    hist = stats.cost_history.numpy()
    assert np.all(np.diff(hist) <= 1e-4 * hist[0]), hist
    assert hist[-1] < hist[0]


def test_cost_monotone_under_lm_damping():
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=40, n_landmarks=20, obs_per_kf=5, init_noise=0.3, seed=3)
    _, _, stats = ba.solve(_t(problem), iters=6, cg_iters=50, damping=1e-3)
    hist = stats.cost_history.numpy()
    assert hist[-1] < hist[0]
    assert hist[-1] < 0.05 * hist[0]


def test_packed_matches_unpacked_on_uneven_keyframes():
    """``prepare``'s packing with pads (a scattered subset of observations
    invalid) solves as the unpacked problem does, to float32 summation
    order (tests/test_ba.py's packed check, on the port alone)."""
    problem, _, _ = graph_builder.synthetic_ba_problem(40, 25, obs_per_kf=5, seed=3)
    valid = problem.obs_valid.copy()
    valid[np.random.default_rng(0).choice(len(valid), size=30, replace=False)] = False
    problem = problem._replace(obs_valid=valid)
    kw = dict(iters=4, cg_iters=60, damping=1e-4)
    p0, l0, s0 = ba.solve(_t(problem), **kw)
    packed, static = ba.prepare(problem)
    assert static["odo_chain"] is True and static["kf_width"] == 5
    p1, l1, s1 = ba.solve(_t(packed), **kw, **static)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), atol=2e-4)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=2e-4)
    np.testing.assert_allclose(float(s1.final_cost), float(s0.final_cost), rtol=1e-4)


def test_seg_sum_equals_index_add_on_skewed_keys():
    """The keyed sum on a skewed key distribution (key 3 owns half the rows,
    key 7 none) equals ``index_add_``, for [N, 3] and [N, 3, 3] operands."""
    rng = np.random.default_rng(1)
    N, L = 500, 17
    ids = np.where(rng.random(N) < 0.5, 3, rng.integers(0, L, N))
    ids[ids == 7] = 2
    ids = torch.tensor(ids)
    seg = ba.segments(ids, L)
    assert seg.lengths[7] == 0 and int(seg.lengths.sum()) == N
    for shape in [(N, 3), (N, 3, 3)]:
        vals = torch.tensor(rng.normal(size=shape))
        want = torch.zeros(L, *shape[1:], dtype=vals.dtype).index_add_(0, ids, vals)
        torch.testing.assert_close(ba.seg_sum(vals, seg), want, rtol=1e-12, atol=1e-12)


def test_solve_reads_nothing_back_to_the_host(problem, monkeypatch):
    """No tensor is turned into a Python value or branched on inside the
    solve (each would be one host sync per GN or CG step on the card)."""
    tp = _t(problem)

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor inside ba.solve")

    for name in ("item", "tolist", "numpy", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = ba.solve(tp, iters=2, cg_iters=5, adaptive=True, deflate_gauge=True)
    monkeypatch.undo()
    assert torch.isfinite(out[2].cost_history).all()
