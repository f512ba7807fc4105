// K6: the single-stream EKF frame step, one launch per frame, in two
// variants chosen by the state's size N alone (ops/kernels/ekf_update.py).
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/ekf_update.py
// (_frame_update_kernel, launched by frame_update) together with the XLA
// work that the JAX single-stream replay runs around it every frame
// (aruco_slam_tpu/runner.py, _replay_jit: ekf.predict_block over the
// frame's encoder ticks, the slot lookup and the (slot, arrival) sort). For
// one lane, from the raw frame:
//   - the frame step's prologue (frame_step; T >= 0): the compose of the
//     frame's T encoder ticks into (pose, A, Q) (ekf.predict_compose: the
//     midpoint arcs, the latch's first tick; by warp 0 of every CTA), then
//     the covariance predict sigma <- blockdiag(A, I) sigma blockdiag(A,
//     I)^T + blockdiag(Q, 0) and mu[0:3] <- pose on the frame's active
//     square; the latch set. The update alone (frame_update; T < 0) has no
//     prologue and keeps a state that has had no encoder tick as it was
//     (the addImage early-out);
//   - the slot lookup and the stable (slot * M + arrival) sort, computed by
//     every CTA into its own shared memory (for a frame wider than
//     kMaxSharedObs, into its own region of the workspace in device memory:
//     any M takes one launch, as the chain runs over the whole frame);
//   - the frame's M observations through the sequential update in the
//     reference's queue order (new markers first, then ascending slot, ties
//     by arrival), every one linearized at the frame-start mean: a known
//     landmark's rank-3 correction (closed-form 3x3 innovation inverse,
//     stationary gate against the frozen last_obs / seen_prev, divergence
//     count or, under reject_divergent, the reject), a new landmark's
//     augmentation into the next slot, or a capacity drop; the slot /
//     last_obs / seen bookkeeping; sigma symmetrized at the end;
//   - in a replay, the frame's rows of the pose, pose covariance and
//     landmark count.
//
// What bounds it on Hopper: the chain. Each observation reads pose and
// landmark rows that the previous one wrote, so the observations run one
// after the other, and every CTA that holds a part of sigma has to agree on
// each step. The bytes bound (the frame's active square read and written
// once) is microseconds; the barriers between the steps and where sigma
// lives set the pace. Both variants work on the frame's active square
// alone, na = 3 + 3 min(L, landmarks + the frame's new observations),
// computed in the kernel: past it sigma is zero and the frame cannot touch
// it. Where the output's mu and sigma are the input's (the replay's state,
// which it owns) the frame is updated in place and nothing outside the
// square is read or written; otherwise the rest is copied in 16-byte
// vectors. The bookkeeping arrays are never updated in place: the chain
// reads the frame-start records while it writes the new ones.
//
// Variant 1, a thread-block cluster (every N whose sigma fits the shared
// memory of 16 CTAs, the non-portable size): ekf::cluster_frame in
// ekf_frame_common.cuh, which describes it, shared with K2's cluster and
// device variants (ekf_frame_batched.cu), as are the compose, the lookup
// and sort and the 3x3 algebra. One hardware cluster barrier per processed
// observation; the square's stripes in shared memory.
//
// Variant 2, a cooperative grid (any larger N): the same steps on a
// persistent grid of resident CTAs. The frame's square is cut into stripes
// of Wa = max(kGridMinCols, ceil(na / G)) columns, one a CTA, and only the CTAs
// that own a stripe take part in the chain and its barriers; CTAs past the
// square only copy (or, in place, leave at once). A stripe lives in the CTA's
// shared memory for the whole frame where na x Wa fits its stripe area,
// else in the output sigma in device memory (in L2), in place. Per
// processed observation the CTAs exchange B (3 na floats, and an insert's
// pose block) through a double-buffered scratch in device memory, read at
// L2 (__ldcg), and meet at one hand-written grid barrier
// (grid_barrier.cuh: an arrival counter and a generation word, left at
// zero arrivals, so the words are cleared once); no -rdc build is needed.
// The symmetrize pairs (r, c), r < c, by the owner of column c after every
// stripe is written out.

#include <algorithm>

#include "ekf_frame_common.cuh"
#include "grid_barrier.cuh"

namespace {

using namespace ekf;

// The grid variant's narrowest stripe (>= 3, the pose block): a frame's
// square of na columns runs on ceil(na / max(4, ceil(na / G))) CTAs. On an
// H100 the kernel alone took about the same time at 3 to 8 columns and
// more at 16: the work of a CTA per observation, not the barrier, set the
// pace (tools/k6_large_map_ab.py, PERF.md).
constexpr int kGridMinCols = 4;

// The frame step's per-launch inputs beside the state: the frame's encoder
// ticks (wl, wr, dt at element strides; T < 0: the update alone) and the
// replay's rows (null outside a replay).
struct Step {
  const float* wl;
  const float* wr;
  const float* dt;
  long long s_wl, s_wr, s_dt;
  int T;
  float* traj;                // [3] the frame's trajectory row
  float* cov;                 // [9] its pose-covariance row
  int* nlm;                   // [1] its landmark count
  unsigned char* init_out;    // [1] the latch, set (the frame step)
};

// Both variants' shared memory in 4-byte words: the cluster body's layout
// (cluster_words: stripe area, own mu, B double buffer, K^T, pose block,
// reduction, slots, order), then the compose's pose, A, Q.
__host__ __device__ inline long long k6_words(long long cap, int N, int W, int M) {
  return cluster_words(cap, N, W, M) + 21;
}

// The compose into pq (warp 0; read after the CTA's next barrier), or null
// for the update alone.
__device__ __forceinline__ const float* prologue(const Io& io, const Cfg& cfg, const Odom& od,
                                                 const Step& st) {
  if (st.T < 0) return nullptr;
  extern __shared__ float smem[];
  float* pq = smem + cluster_words(cfg.cap, cfg.N, cfg.W, cfg.M);
  if (threadIdx.x < 32)
    compose_lane(od, io.mu_in, io.init_in[0] != 0, st.wl, st.s_wl, st.wr, st.s_wr, st.dt,
                 st.s_dt, st.T, pq);
  return pq;
}

// ===========================================================================
// Variant 1: a thread-block cluster (the body is ekf::cluster_frame)
// ===========================================================================

__global__ void __launch_bounds__(kCThreads, 1)
ekf_frame_update_cluster_kernel(Io io, Cfg cfg, Odom od, Step st) {
  const float* pq = prologue(io, cfg, od, st);
  cluster_frame(io, cfg, Lane{pq, st.traj, st.cov, st.nlm, st.init_out});
}

// ===========================================================================
// Variant 2: a cooperative grid on the frame's active square
// ===========================================================================

__global__ void __launch_bounds__(kCThreads, 1)
ekf_frame_update_grid_kernel(Io io, Cfg cfg, Odom od, Step st,
                             float* scratch,     // [2, 3N + 9] B (or sigma_mx), pose block
                             unsigned int* bar)  // [2] grid barrier
{
  const float* pq = prologue(io, cfg, od, st);
  extern __shared__ float smem[];
  const int N = cfg.N, L = cfg.L, M = cfg.M, W = cfg.W;
  float* stripe = smem;                       // [cap] own columns, when they fit
  float* muo = stripe + cfg.cap;              // [W] own mu
  float* Bbuf = muo + W;                      // [2, 3, W] own B / sigma_mx
  float* KT = Bbuf + 6 * W;                   // [3, N]
  float* Bsc = KT + 3 * N;                    // [9] the pose block (inserts)
  float* red = Bsc + 9;                       // [2, 32] warp partials
  const int rank = blockIdx.x, G = gridDim.x;
  int* s_slot = prologue_slots(reinterpret_cast<int*>(red + 64), io.slot_ws, rank, M);  // [M]
  int* s_order = s_slot + M;                  // [M]

  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = rank == 0;  // CTA 0 keeps the bookkeeping and owns the pose columns
  const bool init = pq != nullptr || io.init_in[0] != 0;

  if (lead) copy_bookkeeping(io, L, init);
  lookup_and_sort(io.slot_ids_in, io.ids, io.valid, L, M, s_slot, s_order);  // ends in a barrier
  int n_lm = io.n_lm_in[0];
  int diverged = io.div_in[0];
  int dropped = io.drop_in[0];

  // ---- the frame's active square and this CTA's stripe of it
  int n_new = 0;
  for (int i = 0; i < M; ++i) n_new += (io.valid[i] && s_slot[i] < 0) ? 1 : 0;
  const int na = 3 + 3 * min(L, n_lm + n_new);
  const int Wa = max(kGridMinCols, (na + G - 1) / G);  // <= W
  const int Ga = (na + Wa - 1) / Wa;                   // the CTAs that own a stripe
  const int c0 = rank * Wa;
  const int Wb = max(0, min(Wa, na - c0));
  const bool on_chip = (long long)na * Wa <= cfg.cap;
  const int ld = on_chip ? Wa : N;
  float* sig = on_chip ? stripe : io.sigma + c0;
  const bool in_place = io.sigma == io.sigma_in;

  // ---- the rest of sigma and mu, copied by every CTA; the own stripe
  if (!in_place) copy_outside(io.sigma_in, io.sigma, N, na, rank, G);
  if (io.mu != io.mu_in)
    for (int j = na + rank * nt + tid; j < N; j += G * nt) io.mu[j] = io.mu_in[j];
  if (rank >= Ga) return;  // uniform in the CTA; no barrier below counts it
  for (int e0 = tid; e0 < (on_chip || !in_place ? na * Wb : 0); e0 += nt * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nt;
      if (e < na * Wb) {
        const int r = e / Wb, t = e - r * Wb;
        v[u] = io.sigma_in[(long long)r * N + c0 + t];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nt;
      if (e < na * Wb) {
        const int r = e / Wb, t = e - r * Wb;
        sig[(long long)r * ld + t] = v[u];
      }
    }
  }
  for (int t = tid; t < Wb; t += nt) muo[t] = io.mu_in[c0 + t];
  __syncthreads();

  float x0 = io.mu_in[0], y0 = io.mu_in[1], th0 = io.mu_in[2];
  if (pq) {
    // ---- the covariance predict with the frame's (A, Q); mu[0:3] <- pose
    const float* A = pq + 3;
    const float* Q = pq + 12;
    x0 = pq[0];
    y0 = pq[1];
    th0 = pq[2];
    for (int t = tid; t < Wb; t += nt) {  // rows 0..2 of the own columns
      const float s0 = sig[t], s1 = sig[ld + t], s2 = sig[2 * ld + t];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        sig[i * ld + t] = A[3 * i] * s0 + A[3 * i + 1] * s1 + A[3 * i + 2] * s2;
    }
    __syncthreads();
    if (lead) {  // columns 0..2 (+ Q), all in CTA 0
      for (int j = tid; j < na; j += nt) {
        float* row = sig + (long long)j * ld;
        const float t0 = row[0], t1 = row[1], t2 = row[2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          row[c] = t0 * A[3 * c] + t1 * A[3 * c + 1] + t2 * A[3 * c + 2] +
                   (j < 3 ? Q[3 * j + c] : 0.0f);
      }
      if (tid < 3) muo[tid] = pq[tid];
    }
    __syncthreads();
  }

  if (init) {  // else the addImage early-out (src/aruco_slam.cpp:84)
    const float sth = sinf(th0), cth = cosf(th0);
    const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
    int parity = 0, red_set = 0;

    for (int p = 0; p < M; ++p) {
      const int i = s_order[p];
      if (!io.valid[i]) continue;  // uniform across the grid
      const Obs o = load_obs(io.z, io.R9, i, s_slot);
      if (o.slot < 0 && n_lm >= L) {
        dropped += 1;  // capacity drop
        continue;
      }
      float* Bown = Bbuf + parity * 3 * W;
      float* Bm = scratch + (long long)parity * (3 * N + 9);
      parity ^= 1;

      if (o.slot >= 0) {
        // ---- known landmark (src/aruco_slam.cpp:108-207) ----
        const int idx = 3 + 3 * o.slot;
        float ze[3], Gp[9];
        known_terms(io.mu_in, o, x0, y0, th0, cth, sth, ze, Gp);
        // phase A: B at the own columns, into shared memory and the scratch
        for (int t = tid; t < Wb; t += nt) {
          const float sp0 = sig[t], sp1 = sig[ld + t], sp2 = sig[2 * ld + t];
          const float sl0 = sig[(long long)idx * ld + t];
          const float sl1 = sig[(long long)(idx + 1) * ld + t];
          const float sl2 = sig[(long long)(idx + 2) * ld + t];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float b = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                            Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
            Bown[a * W + t] = b;
            Bm[a * N + c0 + t] = b;
          }
        }
        grid_barrier(bar, Ga);

        // the whole B at L2, into KT's place
        for (int r = tid; r < na; r += nt) {
#pragma unroll
          for (int a = 0; a < 3; ++a) KT[a * N + r] = __ldcg(Bm + a * N + r);
        }
        __syncthreads();
        // S = B[:, 0:3] Gp^T + B[:, block] Gl^T + R (every thread)
        float S[9], invS[9];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              acc += KT[a * N + k] * Gp[3 * c + k] + KT[a * N + idx + k] * Gl[3 * c + k];
            S[3 * a + c] = acc + o.Rk[3 * a + c];
          }
        inv3(S, invS);
        __syncthreads();  // every thread has read S's columns of B
        // K^T = S^-1 B over the square's rows, in place; ||K||^2 in one fixed order
        float part = 0.0f;
        for (int r = tid; r < na; r += nt) {
          const float b0 = KT[r], b1 = KT[N + r], b2 = KT[2 * N + r];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float kt = invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2;
            KT[a * N + r] = kt;
            part += kt * kt;
          }
        }
        const float k_norm2 = block_sum(part, red, red_set);  // also orders the KT writes
        bool gate, div_hit;
        decide(cfg, io.seen_in, io.last_obs_in, o, ze, k_norm2, &gate, &div_hit);
        const bool reject = cfg.reject_divergent && div_hit;
        if (!gate && !reject) {
          for (int t = tid; t < Wb; t += nt) {
            const float b0 = Bown[t], b1 = Bown[W + t], b2 = Bown[2 * W + t];
            float dm = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
              dm += ze[a] * (invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2);
            muo[t] = muo[t] + dm;
          }
          // sigma <- sigma - K B on the own columns, kUpd entries a thread in flight
          if (Wb > 0) {
            const int dr = nt / Wb, dt = nt - dr * Wb;
            int r = tid / Wb, t = tid - r * Wb;
            while (r < na) {
              int rs[kUpd], ts[kUpd];
              float v[kUpd];
#pragma unroll
              for (int u = 0; u < kUpd; ++u) {
                rs[u] = r;
                ts[u] = t;
                if (r < na) v[u] = sig[(long long)r * ld + t];
                t += dt;
                r += dr;
                if (t >= Wb) {
                  t -= Wb;
                  r += 1;
                }
              }
#pragma unroll
              for (int u = 0; u < kUpd; ++u) {
                if (rs[u] < na) {
                  const int rr = rs[u], tt = ts[u];
                  float x = v[u];
                  x = x - KT[rr] * Bown[tt];
                  x = x - KT[N + rr] * Bown[W + tt];
                  x = x - KT[2 * N + rr] * Bown[2 * W + tt];
                  sig[(long long)rr * ld + tt] = x;
                }
              }
            }
          }
        }
        if (lead && tid == 0) {
          // last_obs entry: z, or zeros on a stationary-gate hit (quirk (c))
#pragma unroll
          for (int a = 0; a < 3; ++a) io.last_obs_out[3 * o.slot + a] = gate ? 0.0f : o.zz[a];
          io.seen_out[o.slot] = 1;
        }
        diverged += div_hit ? 1 : 0;
      } else {
        // ---- new landmark (src/aruco_slam.cpp:208-260) ----
        const int idx = 3 + 3 * n_lm;
        float map_r[3], Gsk[9], GG[9];
        insert_terms(o, x0, y0, th0, cth, sth, Gl, map_r, Gsk, GG);
        // phase A: sigma_mx = -(Gmi Gsk) sigma[0:3, :] at the own columns;
        // CTA 0 also hands out the pose block (this insert does not write it)
        for (int t = tid; t < Wb; t += nt) {
          const float sp0 = sig[t], sp1 = sig[ld + t], sp2 = sig[2 * ld + t];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float u = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
            Bown[r * W + t] = u;
            Bm[r * N + c0 + t] = u;
          }
        }
        if (lead && tid < 9) Bm[3 * N + tid] = sig[(tid / 3) * ld + tid % 3];
        grid_barrier(bar, Ga);

        if (tid < 9) Bsc[tid] = __ldcg(Bm + 3 * N + tid);
        __syncthreads();
        float smm[9];
        insert_smm(Bsc, Gsk, Gl, o.Rk, smm);
        // rows idx..idx+2 of the own columns += sigma_mx
        for (int e = tid; e < 3 * Wb; e += nt) {
          const int r = e / Wb, t = e - r * Wb;
          sig[(long long)(idx + r) * ld + t] += Bown[r * W + t];
        }
        __syncthreads();
        // the owner of columns idx..idx+2: += sigma_mx^T down them (at L2),
        // and sigma_mm on the new 3x3 block
        for (int c = 0; c < 3; ++c) {
          const int col = idx + c;
          if (col < c0 || col >= c0 + Wb) continue;  // uniform in the CTA
          for (int j = tid; j < na; j += nt) {
            float* q = sig + (long long)j * ld + (col - c0);
            float v = *q + __ldcg(Bm + c * N + j);
            const int rb = j - idx;
            if (rb >= 0 && rb < 3) v += smm[3 * rb + c];
            *q = v;
          }
          if (tid == 0) muo[col - c0] = muo[col - c0] + map_r[c];
        }
        if (lead && tid == 0) {
          io.slot_ids_out[n_lm] = io.ids[o.i];
#pragma unroll
          for (int a = 0; a < 3; ++a) io.last_obs_out[3 * n_lm + a] = 0.0f;
          io.seen_out[n_lm] = 1;
        }
        n_lm += 1;
      }
      __syncthreads();
    }
  }

  // ---- the square's result: the stripes written out (on chip), one grid
  // barrier (every stripe is out, and no CTA reads the frame-start mean
  // any more), then the symmetrize of each pair (r, c), r < c, by the
  // owner of column c, the (c, r) entry read at L2; and mu.
  if (on_chip) {
    for (int e = tid; e < na * Wb; e += nt) {
      const int r = e / Wb, t = e - r * Wb;
      io.sigma[(long long)r * N + c0 + t] = stripe[r * Wa + t];
    }
  }
  grid_barrier(bar, Ga);
  if (init && cfg.symmetrize) {
    for (int e0 = tid; e0 < Wb * na; e0 += nt * kUpd) {
      float v[kUpd];
#pragma unroll
      for (int u = 0; u < kUpd; ++u) {
        const int e = e0 + u * nt;
        const int t = e / na, r = e - t * na, c = c0 + t;
        if (e < Wb * na && r < c)
          v[u] = 0.5f * (sig[(long long)r * ld + t] + __ldcg(io.sigma + (long long)c * N + r));
      }
#pragma unroll
      for (int u = 0; u < kUpd; ++u) {
        const int e = e0 + u * nt;
        const int t = e / na, r = e - t * na, c = c0 + t;
        if (e < Wb * na && r < c) {
          io.sigma[(long long)r * N + c] = v[u];
          io.sigma[(long long)c * N + r] = v[u];
        }
      }
    }
  }
  for (int t = tid; t < Wb; t += nt) io.mu[c0 + t] = muo[t];
  if (lead && tid == 0) {
    io.n_lm_out[0] = n_lm;
    io.div_out[0] = diverged;
    io.drop_out[0] = dropped;
    if (st.init_out) st.init_out[0] = 1;
  }
  if (lead && st.traj) {
    __syncthreads();  // CTA 0 wrote sigma[0:3, 0:3] in every branch
    if (tid < 9) st.cov[tid] = io.sigma[(tid / 3) * N + tid % 3];
    if (tid < 3) st.traj[tid] = muo[tid];
    if (tid == 0) st.nlm[0] = n_lm;
  }
}

// ===========================================================================
// The host side
// ===========================================================================

template <typename T>
const T* in_at(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out_at(void* p) {
  return static_cast<T*>(p);
}

cudaError_t set_cluster_attributes(int G) {
  // the most any N needs, so that plans cached for other sizes stay valid
  cudaError_t err = cudaFuncSetAttribute(ekf_frame_update_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSharedBytes);
  if (err == cudaSuccess && G > 8)
    err = cudaFuncSetAttribute(ekf_frame_update_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void cluster_launch_config(cudaLaunchConfig_t* lc, cudaLaunchAttribute* attr, int G, int smem,
                           cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *lc = {};
  lc->gridDim = dim3(G);
  lc->blockDim = dim3(kCThreads);
  lc->dynamicSmemBytes = static_cast<size_t>(smem);
  lc->stream = stream;
  lc->attrs = attr;
  lc->numAttrs = 1;
}

}  // namespace

// One call's arguments, filled by the wrapper (ekf_update.py: _Args, the
// same layout) and kept for a replay's frames, which change only f. At
// global scope: the extern "C" functions that take it keep external linkage.
struct Args {
  const void* state[9];  // mu, sigma, slot_ids, n_landmarks, last_obs, seen_prev,
                         // initialized, diverged, dropped
  void* out[9];          // the new state's (mu and sigma may be the state's: in
                         // place; initialized null for the update alone)
  const void* obs[4];    // ids [F', M], z [F', M, 3], R [F', M, 3, 3], valid [F', M]
  const void* ticks[3];  // wl, wr, dt [F', T]
  void* rows[3];         // trajectory [F, 3], pose_cov [F, 3, 3], n_landmarks [F], or null
  void* scratch;         // the grid variant's [2, 3N + 9]
  void* bar;             // the grid variant's barrier words
  void* slots;           // [G, 2, M] int32, the prologue's slots and order a CTA
                         // where M > kMaxSharedObs (else null)
  void* stream;
  long long obs_frames;  // 1: the observations and ticks hold every frame (F' = F,
                         // time-major) and frame f is read; 0: they hold frame f alone
  long long s_tick[6];   // (frame, tick) element strides of wl, wr, dt
  int variant;           // 0 cluster, 1 grid
  int N, L, M, T;        // T < 0: the update alone (no ticks, no latch, no rows)
  int f;                 // the frame
  int G, W, cap, smem, device;
  int stationary_gate, reject_divergent, symmetrize, kl_both;
  float gate_eps2, div_ze2, div_k2;
  float kl, kr, two_b, inv_b, kl_over_b, kr_over_b, half_kl, q_k;
};

// The cluster variant's plan for an N-dim state on G CTAs: columns per CTA,
// shared bytes, and how many such clusters the current card can hold at
// once (0: none, the launch would be refused). Sets the kernel's attributes.
// M: the observations a frame whose slots and order the shared memory is
// planned for (the wrapper passes kMaxSharedObs, so that one plan serves
// every frame width: a wider frame keeps them in device memory).
extern "C" int ekf_frame_update_cluster_plan(int N, int M, int G, int* W, int* smem_bytes,
                                             int* max_clusters) {
  if (G < 1 || G > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const int w = (N + G - 1) / G;
  const long long bytes = k6_words((long long)N * w, N, w, M) * 4;
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_cluster_attributes(G);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t lc;
  cudaLaunchAttribute attr[1];
  cluster_launch_config(&lc, attr, G, static_cast<int>(bytes), nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ekf_frame_update_cluster_kernel, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *W = w;
  *smem_bytes = static_cast<int>(bytes);
  *max_clusters = n;
  return 0;
}

// The grid variant's plan for an N-dim state: as many CTAs as can be
// resident at once (G), the widest stripe a CTA can own (W =
// max(kGridMinCols, ceil(N / G))), its stripe area in words (cap: N x W where that fits, else what the shared memory leaves;
// a frame whose stripes do not fit runs in device memory) and the shared
// bytes, M as for the cluster plan. Sets the kernel's attributes.
extern "C" int ekf_frame_update_grid_plan(int N, int M, int* G, int* W, int* cap,
                                          int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ekf_frame_update_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The stripes are sized for one CTA an SM; more resident CTAs only make
  // the stripes narrower, which the kernel computes per frame.
  const int w = std::max(kGridMinCols, (N + sms - 1) / sms);
  const long long fixed = k6_words(0, N, w, M);
  if (fixed * 4 > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const long long area = std::min((long long)N * w, kMaxSharedBytes / 4 - fixed);
  const long long bytes = (fixed + area) * 4;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ekf_frame_update_grid_kernel, kCThreads, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *G = per_sm * sms;
  *W = w;
  *cap = static_cast<int>(area);
  *smem_bytes = static_cast<int>(bytes);
  return 0;
}

// One launch: the frame step of frame a->f (T >= 0) or the update alone.
extern "C" int ekf_frame_update_launch(const Args* a) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = a->M;
  if (M > kMaxSharedObs && a->slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (cur != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess)
    return static_cast<int>(err);
  const long long fo = a->obs_frames * a->f;  // the frame's row of time-major inputs
  const Io io{in_at<float>(a->state[0]), in_at<float>(a->state[1]), in_at<int>(a->state[2]),
              in_at<int>(a->state[3]), in_at<float>(a->state[4]),
              in_at<unsigned char>(a->state[5]), in_at<unsigned char>(a->state[6]),
              in_at<int>(a->state[7]), in_at<int>(a->state[8]),
              in_at<int>(a->obs[0]) + fo * M, in_at<float>(a->obs[1]) + fo * 3 * M,
              in_at<float>(a->obs[2]) + fo * 9 * M, in_at<unsigned char>(a->obs[3]) + fo * M,
              out_at<float>(a->out[0]), out_at<float>(a->out[1]), out_at<int>(a->out[2]),
              out_at<int>(a->out[3]), out_at<float>(a->out[4]), out_at<unsigned char>(a->out[5]),
              out_at<int>(a->out[7]), out_at<int>(a->out[8]), out_at<int>(a->slots)};
  const Cfg cfg{a->N, a->L, M, a->G, a->W, a->cap, a->stationary_gate, a->gate_eps2,
                a->reject_divergent, a->div_ze2, a->div_k2, a->symmetrize};
  const Odom od{a->kl, a->kr, a->two_b, a->inv_b, a->kl_over_b, a->kr_over_b, a->half_kl,
                a->q_k, a->kl_both};
  const bool rows = a->rows[0] != nullptr;
  const Step st{in_at<float>(a->ticks[0]) + a->obs_frames * a->f * a->s_tick[0],
                in_at<float>(a->ticks[1]) + a->obs_frames * a->f * a->s_tick[2],
                in_at<float>(a->ticks[2]) + a->obs_frames * a->f * a->s_tick[4],
                a->s_tick[1], a->s_tick[3], a->s_tick[5], a->T,
                rows ? out_at<float>(a->rows[0]) + 3LL * a->f : nullptr,
                rows ? out_at<float>(a->rows[1]) + 9LL * a->f : nullptr,
                rows ? out_at<int>(a->rows[2]) + a->f : nullptr,
                out_at<unsigned char>(a->out[6])};
  const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  if (a->variant == 0) {
    cudaLaunchConfig_t lc;
    cudaLaunchAttribute attr[1];
    cluster_launch_config(&lc, attr, a->G, a->smem, stream);
    err = cudaLaunchKernelEx(&lc, ekf_frame_update_cluster_kernel, io, cfg, od, st);
  } else if (a->variant == 1) {
    float* scratch = out_at<float>(a->scratch);
    unsigned int* bar = out_at<unsigned int>(a->bar);
    void* args[] = {const_cast<Io*>(&io), const_cast<Cfg*>(&cfg), const_cast<Odom*>(&od),
                    const_cast<Step*>(&st), &scratch, &bar};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ekf_frame_update_grid_kernel),
                                      dim3(a->G), dim3(kCThreads), args,
                                      static_cast<size_t>(a->smem), stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (cur != a->device) cudaSetDevice(cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ekf_frame_update_args_bytes() { return static_cast<int>(sizeof(Args)); }

extern "C" const char* ekf_frame_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
