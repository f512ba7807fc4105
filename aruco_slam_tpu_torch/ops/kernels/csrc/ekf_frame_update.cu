// K6: the single-stream EKF frame update, one launch per frame, in two
// variants chosen by the state's size N alone (ops/kernels/ekf_update.py).
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/ekf_update.py
// (_frame_update_kernel, launched by frame_update) together with the XLA
// glue around it (the slot lookup and the (slot, arrival) sort). For one
// lane: the frame's M observations, in arrival order, through the
// sequential update in the reference's queue order (new markers first,
// then ascending slot, ties by arrival), every one linearized at the
// frame-start mean mu0: a known landmark's rank-3 correction (closed-form
// 3x3 innovation inverse, stationary gate against the frozen last_obs /
// seen_prev, divergence count or, under reject_divergent, the reject), a
// new landmark's augmentation into the next slot, or a capacity drop; the
// slot / last_obs / seen bookkeeping; sigma symmetrized at the end. A lane
// that has had no encoder tick keeps its whole state.
//
// The prologue: every CTA computes each observation's slot (the first slot
// whose id matches, else -1) and the stable order by key slot * M +
// arrival, invalid last, into its own shared memory; all CTAs get the same
// order, so no CTA waits on another for it.
//
// What bounds it on Hopper: the chain. Each observation reads pose and
// landmark rows that the previous one wrote, so the observations run one
// after the other, and every CTA that holds a part of sigma has to agree on
// each step. The bytes bound (sigma read and written once) is microseconds;
// the barriers between the steps and where sigma lives set the pace.
//
// Variant 1, a thread-block cluster (every N whose sigma fits the shared
// memory of 8, or 16 with the non-portable size, CTAs): CTA r owns a
// stripe of W columns of sigma and the same entries of mu, in its own
// shared memory for the whole frame. Sigma is read from device memory once
// at the start and written once at the end. Per processed observation:
//   - phase A: B = Gp sigma[0:3, :] + Gl sigma[idx:idx+3, :] (or the
//     insert's sigma_mx) for the own columns, into the CTA's shared memory,
//     double-buffered;
//   - one hardware cluster barrier;
//   - every CTA reads the whole B (3N floats) from its peers through
//     distributed shared memory, forms S, K^T = S^-1 B and ||K||^2 in one
//     fixed order, so every CTA takes the same gate / reject branch;
//   - it applies the rank-3 update to its own columns in shared memory (the
//     insert: rows idx..idx+2 of the own columns, and the owner of the new
//     columns down them).
// Phase A of the next observation reads only the CTA's own columns, so one
// barrier per processed observation is enough; the double buffer keeps a
// CTA already in the next phase A from overwriting B while a slower one
// still reads it. The symmetrize reads the transposed entries from the
// peers and writes the result straight to device memory.
//
// Variant 2, a cooperative grid (N above the cluster's capacity): sigma
// stays in device memory (in the 50 MB L2), in the output buffer; a
// persistent grid of resident blocks, each owning a stripe of columns,
// runs the same steps with a hand-written grid barrier (an arrival counter
// and a generation word in device memory, left at zero arrivals by the
// last block, so the buffer is cleared once and never again). Data written
// by another block is read with __ldcg (at L2). No -rdc build is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;       // the grid variant
constexpr int kCThreads = 512;      // the cluster variant: more warps hide shared-memory latency
constexpr int kMinCols = 16;        // the grid variant's narrowest stripe
constexpr int kChunk = 1024;        // the grid variant: rows of K^T staged at once
constexpr int kBigKey = 2000000000;  // sort key of an invalid observation
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a CTA may use
constexpr int kMaxCluster = 16;
// Elements each thread has in flight in the copies from and to device or
// distributed shared memory: the loads of one batch are issued before any
// of its stores, so the copies are not bound by one load's latency.
constexpr int kBatch = 8;

struct Cfg {
  int N, L, M;              // state dim, landmark slots, observations/frame
  int G, W;                 // CTAs, columns per CTA
  int stationary_gate;      // CompatConfig.stationary_gate
  float gate_eps2;          // stationary_gate_eps^2
  int reject_divergent;     // CompatConfig.reject_divergent
  float div_ze2, div_k2;    // divergence_ze_norm^2, divergence_k_norm^2
  int symmetrize;           // EkfConfig.symmetrize_sigma
};

struct Io {
  const float* mu_in;              // [N] (mu0)
  const float* sigma_in;           // [N, N]
  const int* slot_ids_in;          // [L]
  const int* n_lm_in;              // [1]
  const float* last_obs_in;        // [L, 3]
  const unsigned char* seen_in;    // [L]
  const unsigned char* init_in;    // [1]
  const int* div_in;               // [1]
  const int* drop_in;              // [1]
  const int* ids;                  // [M] arrival order
  const float* z;                  // [M, 3]
  const float* R9;                 // [M, 9]
  const unsigned char* valid;      // [M]
  float* mu;                       // outputs
  float* sigma;
  int* slot_ids_out;
  int* n_lm_out;
  float* last_obs_out;
  unsigned char* seen_out;
  int* div_out;
  int* drop_out;
};

// Shared memory in 4-byte words.
// Cluster: own sigma columns N x W | own mu W | B double buffer 2 x 3W |
// K^T (first B) 3N | the pose block 9 | reduction 2 x 32 | slots M | order M.
__host__ __device__ inline long long cluster_words(int N, int W, int M) {
  return (long long)N * W + 7LL * W + 3LL * N + 9 + 64 + 2LL * M;
}
// Grid: K^T rows kChunk x 3 | own B columns 3W | reduction 2 x 32 | slots M |
// order M.
__host__ __device__ inline long long grid_words(int W, int M) {
  return 3LL * kChunk + 3LL * W + 64 + 2LL * M;
}

__device__ __forceinline__ float wrap_angle(float a) {
  a = (a >= kPi) ? a - kTwoPi : a;
  return (a < -kPi) ? a + kTwoPi : a;
}

// C = X @ Y, row-major 3x3
__device__ __forceinline__ void matmul3(const float* X, const float* Y, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = X[3 * i] * Y[j] + X[3 * i + 1] * Y[3 + j] + X[3 * i + 2] * Y[6 + j];
}

__device__ __forceinline__ void transpose3(const float* X, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[3 * i + j] = X[3 * j + i];
}

// Closed-form 3x3 inverse via the adjugate (linalg.inv3x3).
__device__ __forceinline__ void inv3(const float* S, float* I) {
  const float a = S[0], b = S[1], c = S[2];
  const float d = S[3], e = S[4], f = S[5];
  const float g = S[6], h = S[7], i = S[8];
  const float co_a = e * i - f * h;
  const float co_b = -(d * i - f * g);
  const float co_c = d * h - e * g;
  const float inv_det = 1.0f / (a * co_a + b * co_b + c * co_c);
  I[0] = co_a * inv_det;
  I[1] = -(b * i - c * h) * inv_det;
  I[2] = (b * f - c * e) * inv_det;
  I[3] = co_b * inv_det;
  I[4] = (a * i - c * g) * inv_det;
  I[5] = -(a * f - c * d) * inv_det;
  I[6] = co_c * inv_det;
  I[7] = -(a * h - b * g) * inv_det;
  I[8] = (a * e - b * d) * inv_det;
}

// Sum of v over the CTA in one fixed order; every thread gets the total.
// red[0..31] holds the warp partials (two sets, alternating between calls,
// so that one barrier a call is enough), and every thread adds them up in
// warp order.
__device__ float block_sum(float v, float* red, int& set) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  float* part = red + 32 * set;
  set ^= 1;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += part[w];
  return total;
}

// The prologue (ekf.lookup_slots, ekf.sort_observations): s_slot[i] is
// observation i's slot (the first slot whose id equals ids[i], else -1),
// s_order[p] the observation processed p-th: stable by key slot * M +
// arrival, an invalid observation's key after every valid one.
__device__ void lookup_and_sort(const Io& io, int L, int M, int* s_slot, int* s_order) {
  const int tid = threadIdx.x;
  for (int i = tid; i < M; i += blockDim.x) s_slot[i] = INT_MAX;
  __syncthreads();
  for (int e = tid; e < M * L; e += blockDim.x) {
    const int i = e / L, l = e - i * L;
    if (io.slot_ids_in[l] == io.ids[i]) atomicMin(s_slot + i, l);
  }
  __syncthreads();
  for (int i = tid; i < M; i += blockDim.x)
    if (s_slot[i] == INT_MAX) s_slot[i] = -1;
  __syncthreads();
  for (int i = tid; i < M; i += blockDim.x) {
    const int ki = io.valid[i] ? s_slot[i] * M + i : kBigKey;
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const int kj = io.valid[j] ? s_slot[j] * M + j : kBigKey;
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    s_order[rank] = i;
  }
  __syncthreads();
}

// The bookkeeping arrays' copy into the outputs (by one CTA).
__device__ void copy_bookkeeping(const Io& io, int L, bool init) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    io.slot_ids_out[l] = io.slot_ids_in[l];
    io.seen_out[l] = init ? 0 : io.seen_in[l];
  }
  for (int e = threadIdx.x; e < 3 * L; e += blockDim.x) io.last_obs_out[e] = io.last_obs_in[e];
}

// One observation's frame-start quantities, the same in every CTA.
struct Obs {
  int i, slot;
  float zz[3], Rk[9];
};

__device__ __forceinline__ Obs load_obs(const Io& io, int i, const int* s_slot) {
  Obs o;
  o.i = i;
  o.slot = s_slot[i];
#pragma unroll
  for (int a = 0; a < 3; ++a) o.zz[a] = io.z[i * 3 + a];
#pragma unroll
  for (int e = 0; e < 9; ++e) o.Rk[e] = io.R9[i * 9 + e];
  return o;
}

// A known landmark's innovation ze and pose Jacobian Gp at mu0.
__device__ __forceinline__ void known_terms(const Io& io, const Obs& o, float x0, float y0,
                                            float th0, float cth, float sth, float* ze,
                                            float* Gp) {
  const int idx = 3 + 3 * o.slot;
  const float gdx = io.mu_in[idx] - x0;
  const float gdy = io.mu_in[idx + 1] - y0;
  const float gdth = wrap_angle(io.mu_in[idx + 2] - th0);
  ze[0] = o.zz[0] - (gdx * cth + gdy * sth);
  ze[1] = o.zz[1] - (-gdx * sth + gdy * cth);
  ze[2] = wrap_angle(o.zz[2] - gdth);
  const float g[9] = {-cth, -sth, -gdx * sth + gdy * cth,
                      sth, -cth, -gdx * cth - gdy * sth,
                      0.0f, 0.0f, -1.0f};
#pragma unroll
  for (int e = 0; e < 9; ++e) Gp[e] = g[e];
}

// The stationary gate and the divergence decision of a known landmark.
__device__ __forceinline__ void decide(const Io& io, const Cfg& cfg, const Obs& o,
                                       const float* ze, float k_norm2, bool* gate,
                                       bool* div_hit) {
  const float ze_norm2 = ze[0] * ze[0] + ze[1] * ze[1] + ze[2] * ze[2];
  // comparisons that are false for NaN, as the JAX gates
  *div_hit = (ze_norm2 >= cfg.div_ze2) || (k_norm2 >= cfg.div_k2);
  *gate = false;
  if (cfg.stationary_gate && io.seen_in[o.slot]) {
    float d2 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dd = io.last_obs_in[3 * o.slot + a] - o.zz[a];
      d2 += dd * dd;
    }
    *gate = d2 < cfg.gate_eps2;
  }
}

// The new landmark's frame-start pieces: map pose, Gsk and GG = Gl Gsk.
__device__ __forceinline__ void insert_terms(const Obs& o, float x0, float y0, float th0,
                                             float cth, float sth, const float* Gl,
                                             float* map_r, float* Gsk, float* GG) {
  map_r[0] = x0 + cth * o.zz[0] - sth * o.zz[1];
  map_r[1] = y0 + sth * o.zz[0] + cth * o.zz[1];
  map_r[2] = wrap_angle(th0 + o.zz[2]);
  const float dxn = map_r[0] - x0, dyn = map_r[1] - y0;
  const float g[9] = {-cth, -sth, -sth * dxn + cth * dyn,
                      sth, -cth, -dxn * cth - dyn * sth,
                      0.0f, 0.0f, -1.0f};
#pragma unroll
  for (int e = 0; e < 9; ++e) Gsk[e] = g[e];
  matmul3(Gl, Gsk, GG);  // Gmi == Gl = R(theta)^T
}

// sigma_mm = Gl (Gsk sig3 Gsk^T + R)^T Gl^T from the pose block sig3.
__device__ __forceinline__ void insert_smm(const float* sig3, const float* Gsk, const float* Gl,
                                           const float* Rk, float* smm) {
  float T0[9], T1[9], inner[9], innerT[9], GskT[9], GlT[9];
  matmul3(Gsk, sig3, T0);
  transpose3(Gsk, GskT);
  matmul3(T0, GskT, inner);
#pragma unroll
  for (int e = 0; e < 9; ++e) inner[e] += Rk[e];
  transpose3(inner, innerT);
  matmul3(Gl, innerT, T1);
  transpose3(Gl, GlT);
  matmul3(T1, GlT, smm);
}

// ===========================================================================
// Variant 1: a thread-block cluster, sigma in distributed shared memory
// ===========================================================================

__global__ void __launch_bounds__(kCThreads, 1)
ekf_frame_update_cluster_kernel(Io io, Cfg cfg) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = cfg.N, L = cfg.L, M = cfg.M, W = cfg.W;
  extern __shared__ float smem[];
  float* sig = smem;                          // [N, W] own columns
  float* muo = sig + (long long)N * W;        // [W]
  float* Bbuf = muo + W;                      // [2, 3, W] B / sigma_mx, own columns
  float* KT = Bbuf + 6 * W;                   // [3, N]
  float* Bsc = KT + 3 * N;                    // [9] the pose block (inserts)
  float* red = Bsc + 9;                       // [2, 32] warp partials
  int* s_slot = reinterpret_cast<int*>(red + 64);  // [M]
  int* s_order = s_slot + M;                  // [M]

  const int tid = threadIdx.x;
  const int c0 = rank * W;
  const int Wb = max(0, min(W, N - c0));
  const bool lead = rank == 0;  // rank 0 keeps the bookkeeping
  const bool init = io.init_in[0] != 0;

  // ---- the working state: own columns of sigma and mu ----
  for (int e0 = tid; e0 < N * Wb; e0 += kCThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kCThreads;
      if (e < N * Wb) {
        const int r = e / Wb, t = e - r * Wb;
        v[u] = io.sigma_in[(long long)r * N + c0 + t];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kCThreads;
      if (e < N * Wb) {
        const int r = e / Wb, t = e - r * Wb;
        sig[r * W + t] = v[u];
      }
    }
  }
  for (int t = tid; t < Wb; t += kCThreads) muo[t] = io.mu_in[c0 + t];
  if (lead) copy_bookkeeping(io, L, init);
  lookup_and_sort(io, L, M, s_slot, s_order);  // ends in __syncthreads
  int n_lm = io.n_lm_in[0];
  int diverged = io.div_in[0];
  int dropped = io.drop_in[0];

  if (init) {  // else the addImage early-out (src/aruco_slam.cpp:84)
    const float x0 = io.mu_in[0], y0 = io.mu_in[1], th0 = io.mu_in[2];
    const float sth = sinf(th0), cth = cosf(th0);
    const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
    int parity = 0, red_set = 0;

    for (int p = 0; p < M; ++p) {
      const int i = s_order[p];
      if (!io.valid[i]) continue;  // uniform across the cluster
      const Obs o = load_obs(io, i, s_slot);
      float* Bown = Bbuf + parity * 3 * W;
      const int par = parity;
      if (o.slot < 0 && n_lm >= L) {
        dropped += 1;  // capacity drop
        continue;
      }
      parity ^= 1;

      if (o.slot >= 0) {
        // ---- known landmark (src/aruco_slam.cpp:108-207) ----
        const int idx = 3 + 3 * o.slot;
        float ze[3], Gp[9];
        known_terms(io, o, x0, y0, th0, cth, sth, ze, Gp);
        // phase A: B at the own columns
        for (int t = tid; t < Wb; t += kCThreads) {
          const float sp0 = sig[t], sp1 = sig[W + t], sp2 = sig[2 * W + t];
          const float sl0 = sig[idx * W + t], sl1 = sig[(idx + 1) * W + t];
          const float sl2 = sig[(idx + 2) * W + t];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            Bown[a * W + t] = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                              Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
        }
        cluster.sync();

        // the whole B from its owners, into KT's place
        for (int r = tid; r < N; r += kCThreads) {
          const int owner = r / W;
          const float* pb = cluster.map_shared_rank(Bbuf + par * 3 * W, owner);
          const int lt = r - owner * W;
          const float b0 = pb[lt], b1 = pb[W + lt], b2 = pb[2 * W + lt];
          KT[r] = b0;
          KT[N + r] = b1;
          KT[2 * N + r] = b2;
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
        // K^T = S^-1 B over all N rows, in place; ||K||^2 in one fixed order
        float part = 0.0f;
        for (int r = tid; r < N; r += kCThreads) {
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
        decide(io, cfg, o, ze, k_norm2, &gate, &div_hit);
        const bool reject = cfg.reject_divergent && div_hit;
        if (!gate && !reject) {
          for (int t = tid; t < Wb; t += kCThreads) {
            const float b0 = Bown[t], b1 = Bown[W + t], b2 = Bown[2 * W + t];
            float dm = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
              dm += ze[a] * (invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2);
            muo[t] = muo[t] + dm;
          }
          // sigma <- sigma - K B on the own columns
          if (Wb > 0) {
            const int dr = kCThreads / Wb, dt = kCThreads - dr * Wb;
            int r = tid / Wb, t = tid - r * Wb;
            while (r < N) {
              float* q = sig + r * W + t;
              float v = *q;
              v = v - KT[r] * Bown[t];
              v = v - KT[N + r] * Bown[W + t];
              v = v - KT[2 * N + r] * Bown[2 * W + t];
              *q = v;
              t += dt;
              r += dr;
              if (t >= Wb) {
                t -= Wb;
                r += 1;
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
        // phase A: sigma_mx = -(Gmi Gsk) sigma[0:3, :] at the own columns
        for (int t = tid; t < Wb; t += kCThreads) {
          const float sp0 = sig[t], sp1 = sig[W + t], sp2 = sig[2 * W + t];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            Bown[r * W + t] = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
        }
        cluster.sync();

        // the pose block, rank 0's (this insert does not write it)
        if (tid < 9) {
          const float* s0 = cluster.map_shared_rank(sig, 0);
          Bsc[tid] = s0[(tid / 3) * W + tid % 3];
        }
        __syncthreads();
        float smm[9];
        insert_smm(Bsc, Gsk, Gl, o.Rk, smm);
        // rows idx..idx+2 of the own columns += sigma_mx
        for (int e = tid; e < 3 * Wb; e += kCThreads) {
          const int r = e / Wb, t = e - r * Wb;
          sig[(idx + r) * W + t] += Bown[r * W + t];
        }
        __syncthreads();
        // the owner of columns idx..idx+2: += sigma_mx^T down them (from
        // the peers), and sigma_mm on the new 3x3 block
        for (int c = 0; c < 3; ++c) {
          const int col = idx + c;
          if (col < c0 || col >= c0 + Wb) continue;  // uniform in the CTA
          for (int j = tid; j < N; j += kCThreads) {
            const int owner = j / W;
            const float* pb = cluster.map_shared_rank(Bbuf + par * 3 * W, owner);
            float* q = sig + j * W + (col - c0);
            float v = *q + pb[c * W + (j - owner * W)];
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

  // ---- the result. Symmetrized, each CTA writes whole rows: row j of its
  // own columns' indices, 0.5 (sigma[j, r] + sigma[r, j]), the first term
  // from the owner of column r (contiguous in its shared memory), the
  // second from its own column j. Otherwise its own columns as they are.
  cluster.sync();  // every CTA's last update is done
  if (init && cfg.symmetrize) {
    for (int e0 = tid; e0 < Wb * N; e0 += kCThreads * kBatch) {
      float tr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kCThreads;
        if (e < Wb * N) {
          const int t = e / N, r = e - t * N, owner = r / W;
          tr[u] = cluster.map_shared_rank(sig, owner)[(c0 + t) * W + (r - owner * W)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kCThreads;
        if (e < Wb * N) {
          const int t = e / N, r = e - t * N;
          io.sigma[(long long)(c0 + t) * N + r] = 0.5f * (tr[u] + sig[r * W + t]);
        }
      }
    }
  } else {
    for (int e = tid; e < N * Wb; e += kCThreads) {
      const int r = e / Wb, t = e - r * Wb;
      io.sigma[(long long)r * N + c0 + t] = sig[r * W + t];
    }
  }
  for (int t = tid; t < Wb; t += kCThreads) io.mu[c0 + t] = muo[t];
  if (lead && tid == 0) {
    io.n_lm_out[0] = n_lm;
    io.div_out[0] = diverged;
    io.drop_out[0] = dropped;
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// ===========================================================================
// Variant 2: a cooperative grid, sigma in device memory
// ===========================================================================

// Barrier across the whole grid. bar[0] counts arrivals and is left at 0 by
// the last arrival; bar[1] is a generation that only grows. Cleared once
// when the buffer is made; valid only under a cooperative launch.
__device__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;  // cannot move before this block arrives
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ekf_frame_update_grid_kernel(Io io, float* scratch,  // [2, 3, N] B / sigma_mx
                             unsigned int* bar,      // [2] grid barrier
                             Cfg cfg) {
  extern __shared__ float smem[];
  float* KTs = smem;                   // [3, kChunk]
  float* Bown = KTs + 3 * kChunk;      // [3, W] this block's columns of B
  float* red = Bown + 3 * cfg.W;       // [2, 32] warp partials
  int* s_slot = reinterpret_cast<int*>(red + 64);  // [M]
  int* s_order = s_slot + cfg.M;       // [M]

  const int N = cfg.N, L = cfg.L, M = cfg.M;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * cfg.W;
  const int Wb = min(cfg.W, N - c0);  // >= 1: the plan sizes the grid so
  const long long NWb = (long long)N * Wb;
  const bool lead = blockIdx.x == 0;  // block 0 keeps the bookkeeping
  const bool init = io.init_in[0] != 0;
  float* sigma = io.sigma;
  float* mu = io.mu;

  // ---- the working state: own columns of sigma and mu ----
  for (long long e0 = tid; e0 < NWb; e0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e = e0 + u * kThreads;
      if (e < NWb) {
        const long long r = e / Wb;
        v[u] = io.sigma_in[r * N + c0 + (e - r * Wb)];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long e = e0 + u * kThreads;
      if (e < NWb) {
        const long long r = e / Wb;
        sigma[r * N + c0 + (e - r * Wb)] = v[u];
      }
    }
  }
  for (int j = tid; j < Wb; j += kThreads) mu[c0 + j] = io.mu_in[c0 + j];
  if (lead) copy_bookkeeping(io, L, init);
  lookup_and_sort(io, L, M, s_slot, s_order);
  int n_lm = io.n_lm_in[0];
  int diverged = io.div_in[0];
  int dropped = io.drop_in[0];
  // addImage early-out before the first encoder tick (src/aruco_slam.cpp:84)
  if (!init) {
    if (lead && tid == 0) {
      io.n_lm_out[0] = n_lm;
      io.div_out[0] = diverged;
      io.drop_out[0] = dropped;
    }
    return;  // uniform across the grid
  }

  const float x0 = io.mu_in[0], y0 = io.mu_in[1], th0 = io.mu_in[2];
  const float sth = sinf(th0), cth = cosf(th0);
  const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
  int parity = 0, red_set = 0;

  for (int p = 0; p < M; ++p) {
    const int i = s_order[p];
    if (!io.valid[i]) continue;  // uniform across the grid
    const Obs o = load_obs(io, i, s_slot);

    if (o.slot >= 0) {
      // ---- known landmark (src/aruco_slam.cpp:108-207) ----
      float* Bm = scratch + (long long)parity * 3 * N;
      parity ^= 1;
      const int idx = 3 + 3 * o.slot;
      float ze[3], Gp[9];
      known_terms(io, o, x0, y0, th0, cth, sth, ze, Gp);
      // phase A: B at the own columns
      for (int t = tid; t < Wb; t += kThreads) {
        const int j = c0 + t;
        const float sp0 = sigma[j], sp1 = sigma[N + j], sp2 = sigma[2 * N + j];
        const float sl0 = sigma[(long long)idx * N + j];
        const float sl1 = sigma[(long long)(idx + 1) * N + j];
        const float sl2 = sigma[(long long)(idx + 2) * N + j];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float b = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                          Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
          Bm[a * N + j] = b;
          Bown[a * cfg.W + t] = b;
        }
      }
      grid_barrier(bar, cfg.G);

      // phase B: S = B[:, 0:3] Gp^T + B[:, block] Gl^T + R (every thread)
      float S[9], invS[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc += __ldcg(Bm + a * N + k) * Gp[3 * c + k] +
                   __ldcg(Bm + a * N + idx + k) * Gl[3 * c + k];
          S[3 * a + c] = acc + o.Rk[3 * a + c];
        }
      inv3(S, invS);
      // ||K||^2 over all N rows of K^T = S^-1 B, in one fixed order
      float part = 0.0f;
      for (int j = tid; j < N; j += kThreads) {
        const float b0 = __ldcg(Bm + j), b1 = __ldcg(Bm + N + j), b2 = __ldcg(Bm + 2 * N + j);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float kt = invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2;
          part += kt * kt;
        }
      }
      const float k_norm2 = block_sum(part, red, red_set);
      bool gate, div_hit;
      decide(io, cfg, o, ze, k_norm2, &gate, &div_hit);
      const bool reject = cfg.reject_divergent && div_hit;
      if (!gate && !reject) {
        for (int t = tid; t < Wb; t += kThreads) {
          const float b0 = Bown[t], b1 = Bown[cfg.W + t], b2 = Bown[2 * cfg.W + t];
          float dm = 0.0f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            dm += ze[a] * (invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2);
          mu[c0 + t] = mu[c0 + t] + dm;
        }
        // sigma <- sigma - K B on the own columns, K^T kChunk rows at a time
        for (int r0 = 0; r0 < N; r0 += kChunk) {
          const int rn = min(kChunk, N - r0);
          for (int t = tid; t < rn; t += kThreads) {
            const int r = r0 + t;
            const float b0 = __ldcg(Bm + r), b1 = __ldcg(Bm + N + r), b2 = __ldcg(Bm + 2 * N + r);
#pragma unroll
            for (int a = 0; a < 3; ++a)
              KTs[a * kChunk + t] = invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2;
          }
          __syncthreads();
          const long long en = (long long)rn * Wb;
          for (long long e = tid; e < en; e += kThreads) {
            const int t = static_cast<int>(e / Wb);
            const int cc = static_cast<int>(e - (long long)t * Wb);
            float* q = sigma + (long long)(r0 + t) * N + c0 + cc;
            float v = *q;
            v = v - KTs[t] * Bown[cc];
            v = v - KTs[kChunk + t] * Bown[cfg.W + cc];
            v = v - KTs[2 * kChunk + t] * Bown[2 * cfg.W + cc];
            *q = v;
          }
          __syncthreads();
        }
      }
      if (lead && tid == 0) {
        // last_obs entry: z, or zeros on a stationary-gate hit (quirk (c))
#pragma unroll
        for (int a = 0; a < 3; ++a) io.last_obs_out[3 * o.slot + a] = gate ? 0.0f : o.zz[a];
        io.seen_out[o.slot] = 1;
      }
      diverged += div_hit ? 1 : 0;
    } else if (n_lm < L) {
      // ---- new landmark (src/aruco_slam.cpp:208-260) ----
      float* smx = scratch + (long long)parity * 3 * N;
      parity ^= 1;
      const int idx = 3 + 3 * n_lm;
      float map_r[3], Gsk[9], GG[9];
      insert_terms(o, x0, y0, th0, cth, sth, Gl, map_r, Gsk, GG);
      // phase A: sigma_mx = -(Gmi Gsk) sigma[0:3, :] at the own columns
      for (int t = tid; t < Wb; t += kThreads) {
        const int j = c0 + t;
        const float sp0 = sigma[j], sp1 = sigma[N + j], sp2 = sigma[2 * N + j];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float u = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
          smx[r * N + j] = u;
          Bown[r * cfg.W + t] = u;
        }
      }
      grid_barrier(bar, cfg.G);

      // phase B: sigma_mm from the pose block (block 0's columns; this
      // insert does not write it)
      float sig3[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) sig3[3 * r + c] = __ldcg(sigma + r * N + c);
      float smm[9];
      insert_smm(sig3, Gsk, Gl, o.Rk, smm);
      // rows idx..idx+2 of the own columns += sigma_mx
      for (int t = tid; t < 3 * Wb; t += kThreads) {
        const int r = t / Wb, cc = t - r * Wb;
        sigma[(long long)(idx + r) * N + c0 + cc] += Bown[r * cfg.W + cc];
      }
      __syncthreads();
      // the owner of columns idx..idx+2: += sigma_mx^T down them, and
      // sigma_mm on the new 3x3 block
      for (int c = 0; c < 3; ++c) {
        const int col = idx + c;
        if (col < c0 || col >= c0 + Wb) continue;  // uniform in the block
        for (int j = tid; j < N; j += kThreads) {
          float* q = sigma + (long long)j * N + col;
          float v = *q + __ldcg(smx + c * N + j);
          const int rb = j - idx;
          if (rb >= 0 && rb < 3) v += smm[3 * rb + c];
          *q = v;
        }
        if (tid == 0) mu[col] = mu[col] + map_r[c];
      }
      if (lead && tid == 0) {
        io.slot_ids_out[n_lm] = io.ids[o.i];
#pragma unroll
        for (int a = 0; a < 3; ++a) io.last_obs_out[3 * n_lm + a] = 0.0f;
        io.seen_out[n_lm] = 1;
      }
      n_lm += 1;
    } else {
      dropped += 1;  // capacity drop
    }
    __syncthreads();
  }

  // ---- symmetrize: each off-diagonal pair by one thread of the grid ----
  if (cfg.symmetrize) {
    grid_barrier(bar, cfg.G);
    const long long NN = (long long)N * N;
    const long long stride = (long long)cfg.G * kThreads;
    for (long long e = (long long)blockIdx.x * kThreads + tid; e < NN; e += stride) {
      const long long r = e / N, c = e - r * N;
      if (r >= c) continue;
      const float v = 0.5f * (__ldcg(sigma + e) + __ldcg(sigma + c * N + r));
      sigma[e] = v;
      sigma[c * N + r] = v;
    }
  }
  if (lead && tid == 0) {
    io.n_lm_out[0] = n_lm;
    io.div_out[0] = diverged;
    io.drop_out[0] = dropped;
  }
}

Io make_io(void* const* p) {
  return Io{static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
            static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
            static_cast<const float*>(p[4]), static_cast<const unsigned char*>(p[5]),
            static_cast<const unsigned char*>(p[6]), static_cast<const int*>(p[7]),
            static_cast<const int*>(p[8]), static_cast<const int*>(p[9]),
            static_cast<const float*>(p[10]), static_cast<const float*>(p[11]),
            static_cast<const unsigned char*>(p[12]), static_cast<float*>(p[13]),
            static_cast<float*>(p[14]), static_cast<int*>(p[15]), static_cast<int*>(p[16]),
            static_cast<float*>(p[17]), static_cast<unsigned char*>(p[18]),
            static_cast<int*>(p[19]), static_cast<int*>(p[20])};
}

Cfg make_cfg(int N, int L, int M, int G, int W, int stationary_gate, float gate_eps2,
             int reject_divergent, float div_ze2, float div_k2, int symmetrize) {
  return Cfg{N, L, M, G, W, stationary_gate, gate_eps2, reject_divergent,
             div_ze2, div_k2, symmetrize};
}

}  // namespace

// The cluster variant's plan for an N-dim state on G CTAs: columns per CTA,
// shared bytes, and how many such clusters the current card can hold at
// once (0: none, the launch would be refused). Sets the kernel's attributes.
extern "C" int ekf_frame_update_cluster_plan(int N, int M, int G, int* W, int* smem_bytes,
                                             int* max_clusters) {
  if (G < 1 || G > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const int w = (N + G - 1) / G;
  const long long bytes = cluster_words(N, w, M) * 4;
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  // the most any N needs, so that plans cached for other sizes stay valid
  cudaError_t err = cudaFuncSetAttribute(ekf_frame_update_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 8) {
    err = cudaFuncSetAttribute(ekf_frame_update_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(G);
  lc.blockDim = dim3(kCThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(bytes);
  lc.attrs = attr;
  lc.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ekf_frame_update_cluster_kernel, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *W = w;
  *smem_bytes = static_cast<int>(bytes);
  *max_clusters = n;
  return 0;
}

// The grid variant's plan: as many blocks as can be resident at once, none
// narrower than kMinCols columns. Sets the kernel's attributes.
extern "C" int ekf_frame_update_grid_plan(int N, int M, int* G, int* W, int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The occupancy is queried at the shared memory of the widest stripe the
  // grid can get (one block per SM); a narrower stripe needs less, so the
  // count of resident blocks found is a lower bound.
  long long w_max = (N + sms - 1) / sms;
  if (w_max < kMinCols) w_max = kMinCols;
  const long long smem_max = grid_words(static_cast<int>(w_max), M) * 4;
  if (smem_max > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ekf_frame_update_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ekf_frame_update_grid_kernel, kThreads, static_cast<size_t>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  long long w = (N + resident - 1) / resident;
  if (w < kMinCols) w = kMinCols;  // <= w_max: resident >= sms
  *W = static_cast<int>(w);
  *G = static_cast<int>((N + w - 1) / w);
  *smem_bytes = static_cast<int>(grid_words(*W, M) * 4);
  return 0;
}

// ptrs: mu_in, sigma_in, slot_ids_in, n_lm_in, last_obs_in, seen_in,
// init_in, div_in, drop_in, ids, z, R9, valid (inputs, observations in
// arrival order), mu, sigma, slot_ids, n_lm, last_obs, seen, div, drop
// (outputs).
extern "C" int ekf_frame_update_cluster_launch(
    void* const* ptrs, int N, int L, int M, int G, int W, int smem_bytes,
    int stationary_gate, float gate_eps2, int reject_divergent, float div_ze2,
    float div_k2, int symmetrize, void* stream) {
  Io io = make_io(ptrs);
  Cfg cfg = make_cfg(N, L, M, G, W, stationary_gate, gate_eps2, reject_divergent, div_ze2,
                     div_k2, symmetrize);
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(G);
  lc.blockDim = dim3(kCThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  lc.stream = static_cast<cudaStream_t>(stream);
  lc.attrs = attr;
  lc.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&lc, ekf_frame_update_cluster_kernel, io, cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ekf_frame_update_grid_launch(
    void* const* ptrs, float* scratch, unsigned int* bar, int N, int L, int M, int G, int W,
    int smem_bytes, int stationary_gate, float gate_eps2, int reject_divergent,
    float div_ze2, float div_k2, int symmetrize, void* stream) {
  Io io = make_io(ptrs);
  Cfg cfg = make_cfg(N, L, M, G, W, stationary_gate, gate_eps2, reject_divergent, div_ze2,
                     div_k2, symmetrize);
  void* args[] = {&io, &scratch, &bar, &cfg};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ekf_frame_update_grid_kernel), dim3(G), dim3(kThreads),
      args, static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekf_frame_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
