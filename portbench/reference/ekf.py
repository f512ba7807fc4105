"""The EKF-SLAM plain reference: the estimator of ``gitAugust/Aruco_Slam``
(``src/aruco_slam.cpp``) as the port states it, written anew for B lanes
at once in the dtype of its inputs, with no kernel, fused step or cache.

Per frame: the predict over the frame's encoder ticks (the midpoint arc,
the process noise with the left wheel's radius for both wheels, the first
tick of a run spent on the latch), then the frame's observations in the
reference's queue order (new markers first, then ascending slot, ties by
arrival), each linearized at the frame-start mean: a known landmark's
rank-3 correction unless its measurement repeats the last one within the
stationary gate, a new landmark's augmentation (with the reference's
float cast of the heading's sine and cosine), or a drop once every slot is
taken; then sigma made symmetric. Fixed capacity: ``max_landmarks``
slots, inactive rows and columns of sigma exactly zero.

The ticks of a frame are composed in closed form rather than one by one:
the pose Jacobians of a frame's ticks commute (each shifts only the
heading column), so their product and the folded process noise are sums.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

Tensor = torch.Tensor


def wrap(a: Tensor) -> Tensor:
    a = torch.where(a >= math.pi, a - 2.0 * math.pi, a)
    return torch.where(a < -math.pi, a + 2.0 * math.pi, a)


def _mat3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _inv3(S):
    """3x3 inverses by the adjugate: elementwise, with no host synchronisation."""
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    A, B_, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B_ + c * C
    adj = _mat3([[A, -(b * i - c * h), b * f - c * e],
                 [B_, a * i - c * g, -(a * f - c * d)],
                 [C, -(a * h - b * g), a * e - b * d]])
    return adj / det[..., None, None]


def _rot_t(c, s):
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, s, o], [-s, c, o], [o, o, i]])


def _pose_jac(c, s, dx, dy):
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[-c, -s, -dx * s + dy * c], [s, -c, -dx * c - dy * s], [o, o, -i]])


class State:
    """mu [B, N], sigma [B, N, N], slot_ids [B, L], n_lm [B], last_obs
    [B, L, 3], seen_prev [B, L], initialized [B]."""

    def __init__(self, B: int, L: int, dtype, device):
        N = 3 + 3 * L
        self.L = L
        self.mu = torch.zeros(B, N, dtype=dtype, device=device)
        self.sigma = torch.zeros(B, N, N, dtype=dtype, device=device)
        self.slot_ids = torch.full((B, L), -1, dtype=torch.int32, device=device)
        self.n_lm = torch.zeros(B, dtype=torch.int32, device=device)
        self.last_obs = torch.zeros(B, L, 3, dtype=dtype, device=device)
        self.seen_prev = torch.zeros(B, L, dtype=torch.bool, device=device)
        self.initialized = torch.zeros(B, dtype=torch.bool, device=device)


def predict(st: State, wl: Tensor, wr: Tensor, dt: Tensor, est: dict) -> None:
    """The frame's ticks ``[B, T]``, in place."""
    kl, kr, b, qk = est["wheel_radius_m"], est["wheel_radius_m"], est["half_wheelbase_m"], \
        est["Q_k"]
    use = torch.ones_like(wl)
    use[:, 0] = st.initialized.to(wl.dtype)  # an uninitialized lane's first tick: the latch
    dsl, dsr = kl * dt * wl, kr * dt * wr
    dth = (dsr - dsl) / (2.0 * b) * use
    ds = 0.5 * (dsr + dsl) * use
    th0 = st.mu[:, 2:3]
    th_before = th0 + torch.cumsum(dth, 1) - dth
    tmp = th_before + 0.5 * dth
    c, s = torch.cos(tmp), torch.sin(tmp)
    p, q = -ds * s, ds * c  # each tick's Jacobian: I plus (p, q) in the heading column
    # what the later ticks of the frame shift each tick's noise by
    P = torch.sum(p, 1, keepdim=True) - torch.cumsum(p, 1)
    Qs = torch.sum(q, 1, keepdim=True) - torch.cumsum(q, 1)
    o, i = torch.zeros_like(P), torch.ones_like(P)
    G = _mat3([[i, o, P], [o, i, Qs], [o, o, i]])  # [B, T, 3, 3]
    a = torch.stack([c, s, torch.full_like(c, 1.0 / b)], -1)
    a2 = torch.stack([c, s, torch.full_like(c, -1.0 / b)], -1)
    scale = ((0.5 * kl * dt) ** 2 * use)[..., None, None]
    Qk = scale * (qk * wl.abs()[..., None, None] * (a[..., :, None] * a[..., None, :])
                  + qk * wr.abs()[..., None, None] * (a2[..., :, None] * a2[..., None, :]))
    Q = torch.sum(G @ Qk @ G.transpose(-1, -2), 1)
    o1, i1 = torch.zeros_like(P[:, 0]), torch.ones_like(P[:, 0])
    A = _mat3([[i1, o1, p.sum(1)], [o1, i1, q.sum(1)], [o1, o1, i1]])
    mu = st.mu.clone()
    mu[:, 0] = st.mu[:, 0] + torch.sum(ds * c, 1)
    mu[:, 1] = st.mu[:, 1] + torch.sum(ds * s, 1)
    mu[:, 2] = wrap(st.mu[:, 2] + dth.sum(1))
    sigma = st.sigma.clone()
    sigma[:, :3, :] = A @ st.sigma[:, :3, :]
    sigma[:, :, :3] = sigma[:, :, :3] @ A.transpose(-1, -2)
    sigma[:, :3, :3] += Q
    st.mu, st.sigma = mu, sigma
    st.initialized = torch.ones_like(st.initialized)


def update(st: State, ids: Tensor, z: Tensor, R: Tensor, valid: Tensor, est: dict,
           depth: int) -> None:
    """One frame's observations ``[B, M]``, in place; ``depth`` bounds the
    valid observations of any lane (the queue's later slots are empty)."""
    B, M = ids.shape
    L, N = st.L, st.mu.shape[1]
    dtype, dev = st.mu.dtype, st.mu.device
    lm_iota = torch.arange(L, device=dev)
    hit = st.slot_ids[:, None, :] == ids[:, :, None]
    slot = torch.where(hit.any(-1), torch.argmax(hit.to(torch.int32), -1),
                       torch.full_like(ids, -1, dtype=torch.int64))
    arrival = torch.arange(M, device=dev)
    key = torch.where(valid, slot * M + arrival, 2_000_000_000)
    perm = torch.argsort(key, dim=1, stable=True)

    def take(x):
        idx = perm.reshape(*perm.shape, *([1] * (x.dim() - 2)))
        return torch.gather(x, 1, idx.expand(*perm.shape, *x.shape[2:]))

    ids_s, z_s, R_s, v_s, slot_s = take(ids), take(z), take(R), take(valid), take(slot)
    x0, y0, th0 = st.mu[:, 0], st.mu[:, 1], st.mu[:, 2]
    mu0 = st.mu.clone()  # the stale linearization point
    c0, s0 = torch.cos(th0), torch.sin(th0)
    ci, si = c0.to(torch.float32).to(dtype), s0.to(torch.float32).to(dtype)
    Rt, Gmi = _rot_t(c0, s0), _rot_t(ci, si)
    eye = torch.eye(3, dtype=dtype, device=dev)
    new_last, new_seen = st.last_obs.clone(), torch.zeros_like(st.seen_prev)
    mu, sigma = st.mu, st.sigma
    for k in range(depth):
        v = v_s[:, k]
        zk = torch.where(v[:, None], z_s[:, k], torch.zeros_like(z_s[:, k]))
        Rk = torch.where(v[:, None, None], R_s[:, k], eye)
        known = slot_s[:, k] >= 0
        eff = torch.where(known, slot_s[:, k], st.n_lm.to(torch.int64))
        effc = torch.clamp(eff, max=L - 1)
        rows = 3 + 3 * effc[:, None] + torch.arange(3, device=dev)  # [B, 3]
        # a known landmark, linearized at the frame-start mean
        m = torch.gather(mu0, 1, rows)
        gdx, gdy, gdth = m[:, 0] - x0, m[:, 1] - y0, wrap(m[:, 2] - th0)
        ze = torch.stack([zk[:, 0] - (gdx * c0 + gdy * s0), zk[:, 1] - (-gdx * s0 + gdy * c0),
                          wrap(zk[:, 2] - gdth)], -1)
        Gp = _pose_jac(c0, s0, gdx, gdy)
        sig_rows = torch.gather(sigma, 1, rows[:, :, None].expand(B, 3, N))
        Bm = Gp @ sigma[:, :3, :] + Rt @ sig_rows
        BE = torch.gather(Bm, 2, rows[:, None, :].expand(B, 3, 3))
        S = Bm[:, :, :3] @ Gp.transpose(-1, -2) + BE @ Rt.transpose(-1, -2) + Rk
        KT = _inv3(S) @ Bm
        seen = torch.gather(st.seen_prev, 1, effc[:, None])[:, 0]
        last = torch.gather(st.last_obs, 1, effc[:, None, None].expand(B, 1, 3))[:, 0]
        gate = seen & (torch.sum((last - zk) ** 2, -1) < est["stationary_gate_m"] ** 2)
        apply = (v & known & ~gate).to(dtype)[:, None, None]
        KT = KT * apply
        mu = mu + (ze[:, None, :] @ KT)[:, 0]
        sigma = sigma - KT.transpose(-1, -2) @ Bm
        # a new landmark: its rows and columns written, for the lanes that add one
        do_new = v & ~known & (st.n_lm < L)
        mx = x0 + ci * zk[:, 0] - si * zk[:, 1]
        my = y0 + si * zk[:, 0] + ci * zk[:, 1]
        mth = wrap(th0 + zk[:, 2])
        Gsk = _pose_jac(ci, si, mx - x0, my - y0)
        inner = Gsk @ sigma[:, :3, :3] @ Gsk.transpose(-1, -2) + Rk
        smm = Gmi @ inner.transpose(-1, -2) @ Gmi.transpose(-1, -2)
        smx = -(Gmi @ Gsk) @ sigma[:, :3, :]
        smx = smx.scatter(2, rows[:, None, :].expand(B, 3, 3), smm)
        nd = do_new[:, None, None]
        cols_i = rows[:, None, :].expand(B, N, 3)
        sigma = sigma.scatter(2, cols_i, torch.where(nd, smx.transpose(-1, -2),
                                                     torch.gather(sigma, 2, cols_i)))
        rows_i = rows[:, :, None].expand(B, 3, N)
        sigma = sigma.scatter(1, rows_i, torch.where(nd, smx, torch.gather(sigma, 1, rows_i)))
        mu = mu.scatter(1, rows, torch.where(do_new[:, None], torch.stack([mx, my, mth], -1),
                                             torch.gather(mu, 1, rows)))
        # bookkeeping
        sel = lm_iota[None, :] == eff[:, None]
        st.slot_ids = torch.where(do_new[:, None] & sel, ids_s[:, k:k + 1], st.slot_ids)
        st.n_lm = st.n_lm + do_new.to(torch.int32)
        do_known = v & known
        write = (do_known | do_new)[:, None] & sel
        nlo = torch.where((do_known & ~gate)[:, None], zk, torch.zeros_like(zk))
        new_last = torch.where(write[:, :, None], nlo[:, None, :], new_last)
        new_seen = new_seen | write
    if est["symmetrize_sigma"]:
        sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
    st.mu, st.sigma, st.last_obs, st.seen_prev = mu, sigma, new_last, new_seen


FIELDS = ("mu", "sigma", "slot_ids", "n_lm", "last_obs", "seen_prev", "initialized")


class _Eager:
    """A frame's predict and update, operation by operation."""

    def __init__(self, st: State, est: dict):
        self.st, self.est = st, est

    def __call__(self, frame_inputs, depth: int) -> None:
        predict(self.st, *frame_inputs[:3], self.est)
        update(self.st, *frame_inputs[3:], self.est, depth)


class _Graphed:
    """A frame's predict and update as CUDA graphs, one per queue depth,
    over static input buffers and the state's own tensors: the same
    operations as :class:`_Eager`, replayed without a launch from the host
    per operation."""

    def __init__(self, st: State, frame_inputs, est: dict):
        self.st, self.est = st, est
        self.inputs = [x.clone() for x in frame_inputs]
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()

    def _body(self, depth: int) -> None:
        tmp = copy.copy(self.st)
        _Eager(tmp, self.est)(self.inputs, depth)
        for k in FIELDS:
            getattr(self.st, k).copy_(getattr(tmp, k))

    def __call__(self, frame_inputs, depth: int) -> None:
        for buf, x in zip(self.inputs, frame_inputs):
            buf.copy_(x)
        if depth not in self.graphs:
            saved = [getattr(self.st, k).clone() for k in FIELDS]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body(depth)  # warm-up, outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                self._body(depth)
            for k, v in zip(FIELDS, saved):
                getattr(self.st, k).copy_(v)
            self.graphs[depth] = graph
        self.graphs[depth].replay()


def frames_of(enc_w: Tensor, enc_dt: Tensor, ids: Tensor, z: Tensor, R: Tensor, valid: Tensor,
              lane_base: Tensor):
    """Each lane's per-frame inputs ``[wl, wr, dt, ids, z, R, valid]`` (frame
    axis 1, in the dtype of ``z``) and each frame's queue depth."""
    dtype = z.dtype
    depth = np.asarray(valid.index_select(0, lane_base).sum(-1).amax(0).cpu())
    obs = [x.index_select(0, lane_base) for x in (ids, z, R, valid)]
    return [enc_w[..., 0].to(dtype), enc_w[..., 1].to(dtype), enc_dt.to(dtype), *obs], depth


def replay(enc_w: Tensor, enc_dt: Tensor, ids: Tensor, z: Tensor, R: Tensor, valid: Tensor,
           lane_base: Tensor, est: dict, L: int) -> dict:
    """B lanes of F frames from a fresh state, in the dtype of ``z``: the
    encoder ticks ``enc_w [B, F, T, 2]``, ``enc_dt [B, F, T]`` are the
    lanes' own, the observations ``[D, F, M, ...]`` those of the distinct
    sequence ``lane_base[b]`` that lane b replays. Returns the trajectory
    [B, F, 3] and landmark counts [B, F] after each frame's update, and the
    final mu, sigma and slot ids. On a GPU each frame's step is replayed
    as a CUDA graph."""
    B, F = enc_w.shape[:2]
    dtype, dev = z.dtype, z.device
    st = State(B, L, dtype, dev)
    inputs, depth = frames_of(enc_w, enc_dt, ids, z, R, valid, lane_base)
    traj = torch.empty(B, F, 3, dtype=dtype, device=dev)
    n_lm = torch.empty(B, F, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        step = _Graphed(st, [x[:, 0] for x in inputs], est)
    else:
        step = _Eager(st, est)
    for f in range(F):
        step([x[:, f] for x in inputs], int(depth[f]))
        traj[:, f] = st.mu[:, :3]
        n_lm[:, f] = st.n_lm
    return {"trajectory": traj, "n_landmarks": n_lm, "mu": st.mu, "sigma": st.sigma,
            "slot_ids": st.slot_ids}
