// The EKF frame update's device code shared by K6 (ekf_frame_update.cu, one
// stream) and K2 (ekf_frame_batched.cu, B replay lanes): the 3x3 algebra,
// the prologue's slot lookup and (slot, arrival) sort, the per-observation
// terms, the encoder-tick compose, and the thread-block-cluster frame body
// that both kernels run (K6 on one lane, K2 on a grid of B clusters).
//
// The cluster body works on the frame's active square: the leading na x na
// block of sigma, na = 3 + 3 min(L, landmarks + the frame's new
// observations), which holds every entry the frame can change (past the
// active landmarks sigma is zero, and the frame's inserts stay inside). CTA
// r of a cluster owns a stripe of Wa = ceil(na / G) columns of the square
// (at least 3, so that rank 0 holds the pose block) and the same entries of
// mu. Where the square's stripes fit the plan's stripe area they live in
// shared memory for the whole frame, read from device memory once at the
// start and written once at the end; otherwise they stay in the output
// sigma in device memory (mostly in the 50 MB L2), on the row stride N, and
// the frame runs there in place. The choice is per lane and per frame, the
// same in every CTA of the lane, and both homes run the same arithmetic.
// The rest of sigma (and of mu) is a copy, spread over the cluster's CTAs
// in 16-byte vectors, with no barrier against the chain; where the output's
// mu and sigma are the input's (an update in place) nothing is copied.
// Per processed observation:
//   - phase A: B = Gp sigma[0:3, :] + Gl sigma[idx:idx+3, :] (or the
//     insert's sigma_mx) for the own columns, into the CTA's shared memory,
//     double-buffered;
//   - one hardware cluster barrier;
//   - every CTA reads the whole B (3 na floats) from its peers through
//     distributed shared memory, forms S, K^T = S^-1 B and ||K||^2 in one
//     fixed order, so every CTA takes the same gate / reject branch;
//   - it applies the rank-3 update to its own columns (the insert: rows
//     idx..idx+2 of the own columns, and the owner of the new columns down
//     them).
// Phase A of the next observation reads only the CTA's own columns, so one
// barrier per processed observation is enough; the double buffer keeps a
// CTA already in the next phase A from overwriting B while a slower one
// still reads it. On chip, the symmetrize reads the transposed entries from
// the peers and writes the result straight to device memory; in device
// memory each pair of entries is symmetrized in place by one CTA. Every
// write of the result comes after the body's last cluster barrier, after
// every CTA has read its stripe and the frame-start mean, which is what
// makes the update in place safe.
//
// With a frame prologue (K2, and K6's frame step) the body also runs the
// compose of the frame's encoder ticks (pose, A, Q, by warp 0 of every CTA
// into its shared memory: compose_lane) and the covariance predict on the
// own columns (rows 0..2 in every CTA, then columns 0..2 in CTA 0, which
// owns them), and it writes the replay's rows of the lane's pose, pose
// covariance and landmark count.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace ekf {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kCThreads = 512;       // the cluster body: more warps hide shared-memory latency
constexpr int kBigKey = 2000000000;  // sort key of an invalid observation
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a CTA may use
constexpr int kMaxCluster = 16;
// Elements each thread has in flight in the copies from and to device or
// distributed shared memory: the loads of one batch are issued before any
// of its stores, so the copies are not bound by one load's latency.
constexpr int kBatch = 8;
// The same for the cluster body's rank-3 update and in-place symmetrize.
constexpr int kUpd = 4;
// The widest frame whose prologue slots and order (2M int32) live in shared
// memory, where the plans reserve room for them; a wider frame keeps them in
// device memory, a region a CTA of the launch's workspace, so that the
// prologue stays redundant per CTA with no barrier of its own
// (ekf_update.MAX_SHARED_OBS, ekf_update_batched.MAX_SHARED_OBS).
constexpr int kMaxSharedObs = 256;

struct Cfg {
  int N, L, M;              // state dim, landmark slots, observations/frame
  int G, W;                 // CTAs, the widest stripe a CTA may own (the cluster body)
  int cap;                  // the cluster body's stripe area, in 4-byte words of shared memory
  int stationary_gate;      // CompatConfig.stationary_gate
  float gate_eps2;          // stationary_gate_eps^2
  int reject_divergent;     // CompatConfig.reject_divergent
  float div_ze2, div_k2;    // divergence_ze_norm^2, divergence_k_norm^2
  int symmetrize;           // EkfConfig.symmetrize_sigma
};

// The odometry constants of the encoder-tick compose (OdomConfig,
// CovarianceConfig.Q_k, CompatConfig.process_noise_uses_kl_for_both_wheels),
// each rounded to float32 where the plain version rounds it.
struct Odom {
  float kl, kr;             // wheel radii
  float two_b;              // 2 b
  float inv_b;              // 1 / b
  float kl_over_b, kr_over_b;
  float half_kl;            // 0.5 kl
  float q_k;
  int kl_both;
};

// One lane's arrays (K6: the stream; K2: lane b of the batch).
struct Io {
  const float* mu_in;              // [N] (mu0; K2: the pose entries before the compose)
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
  int* slot_ws;                    // [G, 2, M] the prologue's slots and order of the lane's
                                   // CTAs where M > kMaxSharedObs, else unused
};

// The frame prologue around the cluster body (K2, and K6's frame step); all
// null for K6's update alone.
struct Lane {
  const float* pq;           // shared memory: pose[3], A[9], Q[9] of the compose
  float* traj;               // [3] the replay's trajectory row, or null
  float* cov;                // [9] its pose-covariance row
  int* nlm;                  // [1] its landmark count
  unsigned char* init_out;   // [1] the latch, set
};

// Shared words of the prologue's slots and order: 2M up to kMaxSharedObs
// observations, none for a wider frame (they are in device memory).
__host__ __device__ inline long long shared_slot_words(int M) {
  return M <= kMaxSharedObs ? 2LL * M : 0;
}

// The prologue's slots and order [2, M] of CTA `cta` of the launch: at
// `shared` (the layout's place) where the frame is narrow enough, else in
// the CTA's own region of the workspace `ws` in device memory.
__device__ __forceinline__ int* prologue_slots(int* shared, int* ws, long long cta, int M) {
  return M <= kMaxSharedObs ? shared : ws + 2 * cta * M;
}

// The cluster body's shared memory in 4-byte words: the stripe area cap (own
// sigma columns; N x W holds any frame's) | own mu W | B double buffer 2 x 3W |
// K^T (first B) 3N | the pose block 9 | reduction 2 x 32 | slots M | order M
// (shared_slot_words).
__host__ __device__ inline long long cluster_words(long long cap, int N, int W, int M) {
  return cap + 7LL * W + 3LL * N + 9 + 64 + shared_slot_words(M);
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
__device__ __forceinline__ float block_sum(float v, float* red, int& set) {
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
// arrival, an invalid observation's key after every valid one. Every
// thread of the CTA takes part, or with nt > 0 its threads t0 .. t0 + nt - 1
// (whole warps, nt < blockDim.x), which meet at named barrier 1; it ends in
// a barrier of those threads. The two arrays are the CTA's own, in shared
// or in device memory (prologue_slots): the barriers order their reads and
// writes in either.
__device__ void lookup_and_sort(const int* slot_ids, const int* ids, const unsigned char* valid,
                                int L, int M, int* s_slot, int* s_order, int t0 = 0, int nt = 0) {
  const int tid = threadIdx.x - t0;
  const int parts = nt > 0 ? nt : static_cast<int>(blockDim.x);
  const auto sync = [nt] {
    if (nt > 0) {
      asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
    } else {
      __syncthreads();
    }
  };
  for (int i = tid; i < M; i += parts) s_slot[i] = INT_MAX;
  sync();
  for (int e = tid; e < M * L; e += parts) {
    const int i = e / L, l = e - i * L;
    if (slot_ids[l] == ids[i]) atomicMin(s_slot + i, l);
  }
  sync();
  for (int i = tid; i < M; i += parts)
    if (s_slot[i] == INT_MAX) s_slot[i] = -1;
  sync();
  for (int i = tid; i < M; i += parts) {
    const int ki = valid[i] ? s_slot[i] * M + i : kBigKey;
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const int kj = valid[j] ? s_slot[j] * M + j : kBigKey;
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    s_order[rank] = i;
  }
  sync();
}

// The bookkeeping arrays' copy into the outputs (by one CTA).
__device__ void copy_bookkeeping(const Io& io, int L, bool init) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    io.slot_ids_out[l] = io.slot_ids_in[l];
    io.seen_out[l] = init ? 0 : io.seen_in[l];
  }
  for (int e = threadIdx.x; e < 3 * L; e += blockDim.x) io.last_obs_out[e] = io.last_obs_in[e];
}

// One observation's frame-start quantities, the same in every thread.
struct Obs {
  int i, slot;
  float zz[3], Rk[9];
};

__device__ __forceinline__ Obs load_obs(const float* z, const float* R9, int i, const int* s_slot) {
  Obs o;
  o.i = i;
  o.slot = s_slot[i];
#pragma unroll
  for (int a = 0; a < 3; ++a) o.zz[a] = z[i * 3 + a];
#pragma unroll
  for (int e = 0; e < 9; ++e) o.Rk[e] = R9[i * 9 + e];
  return o;
}

// A known landmark's innovation ze and pose Jacobian Gp at the frame-start
// mean: pose (x0, y0, th0), the landmark at mu0[idx..idx+2].
__device__ __forceinline__ void known_terms(const float* mu0, const Obs& o, float x0, float y0,
                                            float th0, float cth, float sth, float* ze,
                                            float* Gp) {
  const int idx = 3 + 3 * o.slot;
  const float gdx = mu0[idx] - x0;
  const float gdy = mu0[idx + 1] - y0;
  const float gdth = wrap_angle(mu0[idx + 2] - th0);
  ze[0] = o.zz[0] - (gdx * cth + gdy * sth);
  ze[1] = o.zz[1] - (-gdx * sth + gdy * cth);
  ze[2] = wrap_angle(o.zz[2] - gdth);
  const float g[9] = {-cth, -sth, -gdx * sth + gdy * cth,
                      sth, -cth, -gdx * cth - gdy * sth,
                      0.0f, 0.0f, -1.0f};
#pragma unroll
  for (int e = 0; e < 9; ++e) Gp[e] = g[e];
}

// The stationary gate (against the frozen previous-frame records) and the
// divergence decision of a known landmark.
__device__ __forceinline__ void decide(const Cfg& cfg, const unsigned char* seen_prev,
                                       const float* last_prev, const Obs& o, const float* ze,
                                       float k_norm2, bool* gate, bool* div_hit) {
  const float ze_norm2 = ze[0] * ze[0] + ze[1] * ze[1] + ze[2] * ze[2];
  // comparisons that are false for NaN, as the JAX gates
  *div_hit = (ze_norm2 >= cfg.div_ze2) || (k_norm2 >= cfg.div_k2);
  *gate = false;
  if (cfg.stationary_gate && seen_prev[o.slot]) {
    float d2 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dd = last_prev[3 * o.slot + a] - o.zz[a];
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

// ekf.predict_compose for one lane: T encoder ticks (wl, wr, dt at element
// strides s_wl, s_wr, s_dt) folded into the pose and the covariance
// transform sigma' = blockdiag(A, I) sigma blockdiag(A, I)^T +
// blockdiag(Q, 0). A lane that is not yet initialized spends its first tick
// on the latch. pose holds the start pose on entry.
__device__ void compose_ticks(const Odom& od, bool init, const float* wl, long long s_wl,
                              const float* wr, long long s_wr, const float* dt, long long s_dt,
                              int T, float* pose, float* A, float* Q) {
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    A[e] = (e % 4 == 0) ? 1.0f : 0.0f;
    Q[e] = 0.0f;
  }
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    if (!init) {  // the latch: the first tick moves nothing
      init = true;
      continue;
    }
    const float w_l = wl[k * s_wl], w_r = wr[k * s_wr], d = dt[k * s_dt];
    const float dsl = od.kl * d * w_l;
    const float dsr = od.kr * d * w_r;
    const float dth = (dsr - dsl) / od.two_b;
    const float ds = 0.5f * (dsr + dsl);
    const float tmp = pose[2] + 0.5f * dth;
    const float c = cosf(tmp), s = sinf(tmp);
    const float H[9] = {1.0f, 0.0f, -ds * s, 0.0f, 1.0f, ds * c, 0.0f, 0.0f, 1.0f};
    float wkh[6];  // 3 x 2
    if (od.kl_both) {  // quirk (b): kl scales both wheel columns
      const float f = od.half_kl * d;
      wkh[0] = f * c;
      wkh[1] = f * c;
      wkh[2] = f * s;
      wkh[3] = f * s;
      wkh[4] = f * od.inv_b;
      wkh[5] = f * -od.inv_b;
    } else {
      const float f = 0.5f * d;
      wkh[0] = f * (od.kl * c);
      wkh[1] = f * (od.kr * c);
      wkh[2] = f * (od.kl * s);
      wkh[3] = f * (od.kr * s);
      wkh[4] = f * od.kl_over_b;
      wkh[5] = f * -od.kr_over_b;
    }
    const float su0 = od.q_k * fabsf(w_l), su1 = od.q_k * fabsf(w_r);
    float HA[9], HQ[9], Qn[9], Ht[9];
    matmul3(H, A, HA);
    matmul3(H, Q, HQ);
    transpose3(H, Ht);
    matmul3(HQ, Ht, Qn);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float qk = (wkh[2 * i] * su0) * wkh[2 * j] + (wkh[2 * i + 1] * su1) * wkh[2 * j + 1];
        Qn[3 * i + j] = Qn[3 * i + j] + qk;
      }
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      A[e] = HA[e];
      Q[e] = Qn[e];
    }
    const float x = pose[0] + ds * c, y = pose[1] + ds * s;
    pose[2] = wrap_angle(pose[2] + dth);
    pose[0] = x;
    pose[1] = y;
  }
}

// ekf.predict_compose of one lane, from its pose mu[0:3] (every lane of the
// calling warp, redundantly); lane 0 writes pose, A and Q to pq[21].
__device__ void compose_lane(const Odom& od, const float* mu, bool init, const float* wl,
                             long long s_wl, const float* wr, long long s_wr, const float* dt,
                             long long s_dt, int T, float* pq) {
  float pose[3] = {mu[0], mu[1], mu[2]};
  float A[9], Q[9];
  compose_ticks(od, init, wl, s_wl, wr, s_wr, dt, s_dt, T, pose, A, Q);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int e = 0; e < 3; ++e) pq[e] = pose[e];
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      pq[3 + e] = A[e];
      pq[12 + e] = Q[e];
    }
  }
}

// dst[e] = src[e] for e in [lo, hi), by participants part, part + parts, ...:
// 16-byte vectors (streaming: the copy is not read again in the launch) where
// src and dst share their alignment, else single floats.
__device__ __forceinline__ void copy_span(const float* __restrict__ src, float* __restrict__ dst,
                                          long long lo, long long hi, long long part,
                                          long long parts) {
  if (lo >= hi) return;
  const unsigned long long s = reinterpret_cast<unsigned long long>(src + lo);
  const unsigned long long d = reinterpret_cast<unsigned long long>(dst + lo);
  if (((s ^ d) & 15ULL) != 0) {
    for (long long e = lo + part; e < hi; e += parts) dst[e] = src[e];
    return;
  }
  const long long head = min(hi - lo, static_cast<long long>(((16 - (s & 15ULL)) & 15ULL) >> 2));
  const long long a = lo + head;  // 16-byte aligned in both
  const long long nv = (hi - a) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + a);
  float4* d4 = reinterpret_cast<float4*>(dst + a);
  for (long long v0 = part; v0 < nv; v0 += parts * 4) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (v0 + u * parts < nv) x[u] = __ldcs(s4 + v0 + u * parts);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (v0 + u * parts < nv) __stcs(d4 + v0 + u * parts, x[u]);
  }
  const long long tail = a + 4 * nv;  // at most 3 elements at each end
  if (part < head) dst[lo + part] = src[lo + part];
  if (part < hi - tail) dst[tail + part] = src[tail + part];
}

// The part of an N x N sigma outside its leading na x na square, copied by
// the cluster's G CTAs: rows 0..na-2 past column na (a warp a row), then
// one span from row na-1's column na to the end (every thread).
__device__ void copy_outside(const float* src, float* dst, int N, int na, int rank, int G) {
  if (na >= N) return;
  const int nt = blockDim.x, tid = threadIdx.x, warps = nt >> 5;
  for (int r = rank * warps + (tid >> 5); r < na - 1; r += G * warps)
    copy_span(src, dst, (long long)r * N + na, (long long)(r + 1) * N, tid & 31, 32);
  copy_span(src, dst, (long long)(na - 1) * N + na, (long long)N * N,
            (long long)rank * nt + tid, (long long)G * nt);
}

// The frame body on a thread-block cluster (see the head of this file). K6
// passes an empty Lane; K2 passes its compose (in shared memory, written
// before the body's first barrier) and its replay rows.
__device__ void cluster_frame(const Io& io, const Cfg& cfg, const Lane& ln) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = cfg.N, L = cfg.L, M = cfg.M, G = cfg.G, W = cfg.W;
  extern __shared__ float smem[];
  float* stripe = smem;                       // [cap] own columns, when they fit
  float* muo = stripe + cfg.cap;              // [W] own mu
  float* Bbuf = muo + W;                      // [2, 3, W] B / sigma_mx, own columns
  float* KT = Bbuf + 6 * W;                   // [3, N]
  float* Bsc = KT + 3 * N;                    // [9] the pose block (inserts)
  float* red = Bsc + 9;                       // [2, 32] warp partials
  int* s_slot = prologue_slots(reinterpret_cast<int*>(red + 64), io.slot_ws, rank, M);  // [M]
  int* s_order = s_slot + M;                  // [M]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool lead = rank == 0;  // rank 0 keeps the bookkeeping
  // K2 always runs the frame (its compose spent the latch); K6 skips it
  // before the first encoder tick
  const bool init = ln.pq != nullptr || io.init_in[0] != 0;

  if (lead) copy_bookkeeping(io, L, init);
  lookup_and_sort(io.slot_ids_in, io.ids, io.valid, L, M, s_slot, s_order);  // ends in a barrier
  int n_lm = io.n_lm_in[0];
  int diverged = io.div_in[0];
  int dropped = io.drop_in[0];
  float x0 = io.mu_in[0], y0 = io.mu_in[1], th0 = io.mu_in[2];

  // ---- the frame's active square: the landmarks at its start and every
  // insert it may make. The chain reads and writes nothing outside it.
  int n_new = 0;
  for (int i = 0; i < M; ++i) n_new += (io.valid[i] && s_slot[i] < 0) ? 1 : 0;
  const int na = 3 + 3 * min(L, n_lm + n_new);
  const int Wa = max(3, (na + G - 1) / G);  // this frame's stripe width (the pose block in rank 0)
  const int c0 = rank * Wa;
  const int Wb = max(0, min(Wa, na - c0));
  // The stripes' home, the same in every CTA of the lane: shared memory where
  // the square's stripes fit the plan's stripe area, else the output sigma in
  // device memory (in place, mostly in L2), on another stride.
  const bool on_chip = (long long)na * Wa <= cfg.cap;
  const int ld = on_chip ? Wa : N;
  float* sig = on_chip ? stripe : io.sigma + c0;

  // ---- the rest of sigma and mu, copied; the own stripe of the square
  // (nothing to copy where the update is in place)
  const bool in_place = io.sigma == io.sigma_in;
  if (!in_place) copy_outside(io.sigma_in, io.sigma, N, na, rank, G);
  if (io.mu != io.mu_in)
    for (int j = na + rank * nt + tid; j < N; j += G * nt) io.mu[j] = io.mu_in[j];
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
        sig[r * ld + t] = v[u];
      }
    }
  }
  for (int t = tid; t < Wb; t += nt) muo[t] = io.mu_in[c0 + t];
  __syncthreads();

  if (ln.pq) {
    // ---- the covariance predict with the frame's (A, Q); mu[0:3] <- pose
    const float* A = ln.pq + 3;
    const float* Q = ln.pq + 12;
    x0 = ln.pq[0];
    y0 = ln.pq[1];
    th0 = ln.pq[2];
    for (int t = tid; t < Wb; t += nt) {  // rows 0..2 of the own columns
      const float s0 = sig[t], s1 = sig[ld + t], s2 = sig[2 * ld + t];
#pragma unroll
      for (int i = 0; i < 3; ++i) sig[i * ld + t] = A[3 * i] * s0 + A[3 * i + 1] * s1 + A[3 * i + 2] * s2;
    }
    __syncthreads();
    if (lead) {  // columns 0..2 (+ Q), all in rank 0
      for (int j = tid; j < na; j += nt) {
        float* row = sig + j * ld;
        const float t0 = row[0], t1 = row[1], t2 = row[2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          row[c] = t0 * A[3 * c] + t1 * A[3 * c + 1] + t2 * A[3 * c + 2] + (j < 3 ? Q[3 * j + c] : 0.0f);
      }
      if (tid < 3) muo[tid] = ln.pq[tid];
    }
    __syncthreads();
  }

  if (init) {  // else the addImage early-out (src/aruco_slam.cpp:84)
    const float sth = sinf(th0), cth = cosf(th0);
    const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
    int parity = 0, red_set = 0;

    for (int p = 0; p < M; ++p) {
      const int i = s_order[p];
      if (!io.valid[i]) continue;  // uniform across the cluster
      const Obs o = load_obs(io.z, io.R9, i, s_slot);
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
        known_terms(io.mu_in, o, x0, y0, th0, cth, sth, ze, Gp);
        // phase A: B at the own columns
        for (int t = tid; t < Wb; t += nt) {
          const float sp0 = sig[t], sp1 = sig[ld + t], sp2 = sig[2 * ld + t];
          const float sl0 = sig[idx * ld + t], sl1 = sig[(idx + 1) * ld + t];
          const float sl2 = sig[(idx + 2) * ld + t];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            Bown[a * W + t] = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                              Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
        }
        cluster.sync();

        // the whole B from its owners, into KT's place
        for (int r = tid; r < na; r += nt) {
          const int owner = r / Wa;
          const float* pb = cluster.map_shared_rank(Bbuf + par * 3 * W, owner);
          const int lt = r - owner * Wa;
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
          // sigma <- sigma - K B on the own columns, kUpd entries a thread
          // in flight (device memory's latency in the other home)
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
                if (r < na) v[u] = sig[r * ld + t];
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
                  sig[rr * ld + tt] = x;
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
        // phase A: sigma_mx = -(Gmi Gsk) sigma[0:3, :] at the own columns
        for (int t = tid; t < Wb; t += nt) {
          const float sp0 = sig[t], sp1 = sig[ld + t], sp2 = sig[2 * ld + t];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            Bown[r * W + t] = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
        }
        cluster.sync();

        // the pose block, rank 0's (this insert does not write it): from its
        // shared memory, or at L2 from the output in device memory
        if (tid < 9) {
          Bsc[tid] = on_chip ? cluster.map_shared_rank(stripe, 0)[(tid / 3) * ld + tid % 3]
                             : __ldcg(io.sigma + (tid / 3) * N + tid % 3);
        }
        __syncthreads();
        float smm[9];
        insert_smm(Bsc, Gsk, Gl, o.Rk, smm);
        // rows idx..idx+2 of the own columns += sigma_mx
        for (int e = tid; e < 3 * Wb; e += nt) {
          const int r = e / Wb, t = e - r * Wb;
          sig[(idx + r) * ld + t] += Bown[r * W + t];
        }
        __syncthreads();
        // the owner of columns idx..idx+2: += sigma_mx^T down them (from
        // the peers), and sigma_mm on the new 3x3 block
        for (int c = 0; c < 3; ++c) {
          const int col = idx + c;
          if (col < c0 || col >= c0 + Wb) continue;  // uniform in the CTA
          for (int j = tid; j < na; j += nt) {
            const int owner = j / Wa;
            const float* pb = cluster.map_shared_rank(Bbuf + par * 3 * W, owner);
            float* q = sig + j * ld + (col - c0);
            float v = *q + pb[c * W + (j - owner * Wa)];
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

  // ---- the square's result. On chip, symmetrized, each CTA writes whole
  // rows: row j of its own columns' indices, 0.5 (sigma[j, r] + sigma[r, j]),
  // the first term from the owner of column r (contiguous in its shared
  // memory), the second from its own column j; otherwise its own columns as
  // they are. In device memory the square is already in the output, and the
  // symmetrize pairs (r, c), r < c, by the owner of column c, the (c, r)
  // entry read at L2.
  cluster.sync();  // every CTA's last update is done
  if (on_chip && init && cfg.symmetrize) {
    for (int e0 = tid; e0 < Wb * na; e0 += nt * kBatch) {
      float tr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        if (e < Wb * na) {
          const int t = e / na, r = e - t * na, owner = r / Wa;
          tr[u] = cluster.map_shared_rank(stripe, owner)[(c0 + t) * Wa + (r - owner * Wa)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        if (e < Wb * na) {
          const int t = e / na, r = e - t * na;
          io.sigma[(long long)(c0 + t) * N + r] = 0.5f * (tr[u] + sig[r * ld + t]);
        }
      }
    }
  } else if (on_chip) {
    for (int e = tid; e < na * Wb; e += nt) {
      const int r = e / Wb, t = e - r * Wb;
      io.sigma[(long long)r * N + c0 + t] = sig[r * ld + t];
    }
  } else if (init && cfg.symmetrize) {
    for (int e0 = tid; e0 < Wb * na; e0 += nt * kUpd) {
      float v[kUpd];
#pragma unroll
      for (int u = 0; u < kUpd; ++u) {
        const int e = e0 + u * nt;
        const int t = e / na, r = e - t * na, c = c0 + t;
        if (e < Wb * na && r < c)
          v[u] = 0.5f * (io.sigma[(long long)r * N + c] + __ldcg(io.sigma + (long long)c * N + r));
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
    if (ln.init_out) ln.init_out[0] = 1;
  }
  if (lead && ln.traj) {
    __syncthreads();  // rank 0 wrote sigma[0:3, 0:3] in every branch
    if (tid < 9) ln.cov[tid] = io.sigma[(tid / 3) * N + tid % 3];
    if (tid < 3) ln.traj[tid] = muo[tid];
    if (tid == 0) ln.nlm[0] = n_lm;
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

}  // namespace ekf
