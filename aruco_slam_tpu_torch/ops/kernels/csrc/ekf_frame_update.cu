// K6: the single-stream EKF frame update, one cooperative launch per frame.
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/ekf_update.py
// (_frame_update_kernel, launched by frame_update). For one lane: the
// frame's M observations, already sorted (new markers first, then
// ascending slot), through the sequential update, every one linearized at
// the frame-start mean mu0: a known landmark's rank-3 correction (closed-
// form 3x3 innovation inverse, stationary gate against the frozen
// last_obs / seen_prev, divergence count or, under reject_divergent, the
// reject), a new landmark's augmentation into the next slot, or a
// capacity drop; the slot / last_obs / seen bookkeeping; sigma symmetrized
// at the end. A lane that has had no encoder tick keeps its whole state.
//
// What bounds it on Hopper: the chain. Each observation reads pose and
// landmark rows that the previous one wrote, so the observations run one
// after the other; sigma (N^2 floats, N = 3 + 3 * max_landmarks: 149 KB at
// 64 landmarks, 9.0 MiB at 512) outgrows one block's 227 KB of shared
// memory past 77 landmarks, which is K2's ceiling. The bytes bound (sigma
// read and written once) is microseconds; the grid barriers that the chain
// needs set the pace.
//
// The design: sigma stays in device memory (in the 50 MB L2 at every size
// above), in the output buffer, and one persistent cooperative grid works
// on it. Block b owns a stripe of W columns of sigma and the same entries
// of mu. Every write of the chain lands in the writer's own columns:
//   - a known landmark's B = Gp sigma[0:3, :] + Gl sigma[idx:idx+3, :] is
//     computed per owned column (phase A) into a scratch [3, N]; after one
//     grid barrier every block forms S from B's pose and landmark columns,
//     the whole K^T = S^-1 B (staged in shared memory kChunk rows at a
//     time) and ||K||^2 as a block sum in one fixed order, so every block
//     takes the same gate / reject decision; then it applies
//     sigma -= K B to its own columns, all rows (phase B);
//   - a new landmark's sigma_mx = -(Gl Gsk) sigma[0:3, :] is computed per
//     owned column into the scratch; after one grid barrier each block
//     adds it to rows idx..idx+2 of its own columns, and the owner of the
//     new columns idx..idx+2 adds it (and the 3x3 sigma_mm) down them.
// Phase A of the next observation reads only the block's own columns, so
// one grid barrier per processed observation is enough; the scratch is
// double-buffered so that a block already in the next phase A does not
// overwrite B while a slower block still reads it. The symmetrize reads
// entries of other blocks and takes one more barrier. Data written by
// another block is read with __ldcg (at L2, past the SM's L1).
//
// The grid is sized from the occupancy query so every block is resident,
// and launched with cudaLaunchCooperativeKernel, which refuses a grid that
// is not. The barrier is a hand-written counter + generation pair in
// device memory (no -rdc build needed). There is no landmark ceiling:
// shared memory holds kChunk rows of K^T and the block's own B columns,
// whatever N is.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCols = 16;  // the narrowest column stripe a block owns
constexpr int kChunk = 1024;  // rows of K^T staged in shared memory at once

struct Cfg {
  int N, L, M;              // state dim, landmark slots, observations/frame
  int G, W;                 // blocks, columns per block
  int stationary_gate;      // CompatConfig.stationary_gate
  float gate_eps2;          // stationary_gate_eps^2
  int reject_divergent;     // CompatConfig.reject_divergent
  float div_ze2, div_k2;    // divergence_ze_norm^2, divergence_k_norm^2
  int symmetrize;           // EkfConfig.symmetrize_sigma
};

// Shared memory, in 4-byte words: KT rows kChunk x 3 | own B columns 3W |
// reduction scratch 33.
__host__ __device__ inline long long smem_words(int W) {
  return 3LL * kChunk + 3LL * W + 33;
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

// Sum of v over the block in one fixed order; every thread gets the total.
// red[0..31] holds the warp partials, red[32] the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    red[32] = total;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next call
  return total;
}

// Barrier across the whole grid. bar[0] counts arrivals, bar[1] is the
// generation; both start at 0 (the launcher clears them). Only valid under
// a cooperative launch, where every block is resident.
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
ekf_frame_update_kernel(const float* __restrict__ mu_in,       // [N] (mu0)
                        const float* __restrict__ sigma_in,    // [N, N]
                        const int* __restrict__ slot_ids_in,   // [L]
                        const int* __restrict__ n_lm_in,       // [1]
                        const float* __restrict__ last_obs_in,  // [L, 3]
                        const unsigned char* __restrict__ seen_in,  // [L]
                        const unsigned char* __restrict__ init_in,  // [1]
                        const int* __restrict__ div_in,        // [1]
                        const int* __restrict__ drop_in,       // [1]
                        const int* __restrict__ ids,           // [M] sorted
                        const float* __restrict__ z,           // [M, 3]
                        const float* __restrict__ R9,          // [M, 9]
                        const unsigned char* __restrict__ valid,  // [M]
                        const int* __restrict__ slots,         // [M] frame-start
                        float* mu, float* sigma,  // the working state (outputs)
                        int* slot_ids_out, int* n_lm_out, float* last_obs_out,
                        unsigned char* seen_out, int* div_out, int* drop_out,
                        float* scratch,       // [2, 3, N] B / sigma_mx, double-buffered
                        unsigned int* bar,    // [2] grid barrier
                        Cfg cfg) {
  extern __shared__ float smem[];
  float* KTs = smem;                   // [3, kChunk]
  float* Bown = KTs + 3 * kChunk;      // [3, W] this block's columns of B
  float* red = Bown + 3 * cfg.W;       // [33]

  const int N = cfg.N, L = cfg.L, M = cfg.M;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * cfg.W;
  const int Wb = min(cfg.W, N - c0);  // >= 1: the launcher sizes the grid so
  const long long NWb = (long long)N * Wb;
  const bool lead = blockIdx.x == 0;  // block 0 keeps the bookkeeping
  const bool init = init_in[0] != 0;

  // ---- the working state: own columns of sigma and mu ----
  for (long long e = tid; e < NWb; e += kThreads) {
    const long long r = e / Wb;
    const long long off = r * N + c0 + (e - r * Wb);
    sigma[off] = sigma_in[off];
  }
  for (int j = tid; j < Wb; j += kThreads) mu[c0 + j] = mu_in[c0 + j];
  if (lead) {
    for (int l = tid; l < L; l += kThreads) {
      slot_ids_out[l] = slot_ids_in[l];
      seen_out[l] = init ? 0 : seen_in[l];
    }
    for (int e = tid; e < 3 * L; e += kThreads) last_obs_out[e] = last_obs_in[e];
  }
  int n_lm = n_lm_in[0];
  int diverged = div_in[0];
  int dropped = drop_in[0];
  __syncthreads();
  // addImage early-out before the first encoder tick (src/aruco_slam.cpp:84)
  if (!init) {
    if (lead && tid == 0) {
      n_lm_out[0] = n_lm;
      div_out[0] = diverged;
      drop_out[0] = dropped;
    }
    return;  // uniform across the grid
  }

  const float x0 = mu_in[0], y0 = mu_in[1], th0 = mu_in[2];
  const float sth = sinf(th0), cth = cosf(th0);
  const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
  int parity = 0;

  for (int i = 0; i < M; ++i) {
    if (!valid[i]) continue;  // uniform across the grid
    const int slot = slots[i];
    const float zz[3] = {z[i * 3], z[i * 3 + 1], z[i * 3 + 2]};
    float Rk[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) Rk[e] = R9[i * 9 + e];

    if (slot >= 0) {
      // ---- known landmark (src/aruco_slam.cpp:108-207) ----
      float* Bm = scratch + (long long)parity * 3 * N;
      parity ^= 1;
      const int idx = 3 + 3 * slot;
      const float gdx = mu_in[idx] - x0;
      const float gdy = mu_in[idx + 1] - y0;
      const float gdth = wrap_angle(mu_in[idx + 2] - th0);
      const float ze[3] = {zz[0] - (gdx * cth + gdy * sth),
                           zz[1] - (-gdx * sth + gdy * cth),
                           wrap_angle(zz[2] - gdth)};
      const float Gp[9] = {-cth, -sth, -gdx * sth + gdy * cth,
                           sth, -cth, -gdx * cth - gdy * sth,
                           0.0f, 0.0f, -1.0f};
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
          S[3 * a + c] = acc + Rk[3 * a + c];
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
      const float k_norm2 = block_sum(part, red);
      const float ze_norm2 = ze[0] * ze[0] + ze[1] * ze[1] + ze[2] * ze[2];
      // comparisons that are false for NaN, as the JAX gates
      const bool div_hit = (ze_norm2 >= cfg.div_ze2) || (k_norm2 >= cfg.div_k2);
      bool gate = false;
      if (cfg.stationary_gate && seen_in[slot]) {
        float d2 = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float dd = last_obs_in[3 * slot + a] - zz[a];
          d2 += dd * dd;
        }
        gate = d2 < cfg.gate_eps2;
      }
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
            float* p = sigma + (long long)(r0 + t) * N + c0 + cc;
            float v = *p;
            v = v - KTs[t] * Bown[cc];
            v = v - KTs[kChunk + t] * Bown[cfg.W + cc];
            v = v - KTs[2 * kChunk + t] * Bown[2 * cfg.W + cc];
            *p = v;
          }
          __syncthreads();
        }
      }
      if (lead && tid == 0) {
        // last_obs entry: z, or zeros on a stationary-gate hit (quirk (c))
#pragma unroll
        for (int a = 0; a < 3; ++a) last_obs_out[3 * slot + a] = gate ? 0.0f : zz[a];
        seen_out[slot] = 1;
      }
      diverged += div_hit ? 1 : 0;
    } else if (n_lm < L) {
      // ---- new landmark (src/aruco_slam.cpp:208-260) ----
      float* smx = scratch + (long long)parity * 3 * N;
      parity ^= 1;
      const int idx = 3 + 3 * n_lm;
      const float map_r[3] = {x0 + cth * zz[0] - sth * zz[1],
                              y0 + sth * zz[0] + cth * zz[1],
                              wrap_angle(th0 + zz[2])};
      const float dxn = map_r[0] - x0, dyn = map_r[1] - y0;
      const float Gsk[9] = {-cth, -sth, -sth * dxn + cth * dyn,
                            sth, -cth, -dxn * cth - dyn * sth,
                            0.0f, 0.0f, -1.0f};
      float GG[9];
      matmul3(Gl, Gsk, GG);  // Gmi == Gl = R(theta)^T
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
      float T0[9], T1[9], inner[9], innerT[9], GskT[9], GlT[9], smm[9];
      matmul3(Gsk, sig3, T0);
      transpose3(Gsk, GskT);
      matmul3(T0, GskT, inner);
#pragma unroll
      for (int e = 0; e < 9; ++e) inner[e] += Rk[e];
      transpose3(inner, innerT);
      matmul3(Gl, innerT, T1);
      transpose3(Gl, GlT);
      matmul3(T1, GlT, smm);
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
          float* p = sigma + (long long)j * N + col;
          float v = *p + __ldcg(smx + c * N + j);
          const int rb = j - idx;
          if (rb >= 0 && rb < 3) v += smm[3 * rb + c];
          *p = v;
        }
        if (tid == 0) mu[col] = mu[col] + map_r[c];
      }
      if (lead && tid == 0) {
        slot_ids_out[n_lm] = ids[i];
#pragma unroll
        for (int a = 0; a < 3; ++a) last_obs_out[3 * n_lm + a] = 0.0f;
        seen_out[n_lm] = 1;
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
    n_lm_out[0] = n_lm;
    div_out[0] = diverged;
    drop_out[0] = dropped;
  }
}

// Columns per block and blocks for an N-dim state on the current device:
// as many blocks as can be resident at once, none narrower than kMinCols.
int plan(int N, int* G, int* W, long long* smem_bytes) {
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
  const long long smem_max = smem_words(static_cast<int>(w_max)) * 4;
  if (smem_max > 48 * 1024) {
    err = cudaFuncSetAttribute(ekf_frame_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_max));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ekf_frame_update_kernel, kThreads, static_cast<size_t>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  long long w = (N + resident - 1) / resident;
  if (w < kMinCols) w = kMinCols;  // <= w_max: resident >= sms
  *W = static_cast<int>(w);
  *G = static_cast<int>((N + w - 1) / w);
  *smem_bytes = smem_words(*W) * 4;
  return 0;
}

}  // namespace

// Blocks the kernel launches for an N-dim state (for reports), or -1.
extern "C" int ekf_frame_update_grid(int N) {
  int G = 0, W = 0;
  long long smem = 0;
  return plan(N, &G, &W, &smem) == 0 ? G : -1;
}

extern "C" int ekf_frame_update_launch(
    const float* mu_in, const float* sigma_in, const int* slot_ids_in,
    const int* n_lm_in, const float* last_obs_in, const unsigned char* seen_in,
    const unsigned char* init_in, const int* div_in, const int* drop_in,
    const int* ids, const float* z, const float* R9, const unsigned char* valid,
    const int* slots,
    float* mu_out, float* sigma_out, int* slot_ids_out, int* n_lm_out,
    float* last_obs_out, unsigned char* seen_out, int* div_out, int* drop_out,
    float* scratch, unsigned int* bar,
    int N, int L, int M,
    int stationary_gate, float gate_eps2, int reject_divergent,
    float div_ze2, float div_k2, int symmetrize, void* stream) {
  int G = 0, W = 0;
  long long smem = 0;
  int perr = plan(N, &G, &W, &smem);
  if (perr != 0) return perr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Cfg cfg{N, L, M, G, W, stationary_gate, gate_eps2, reject_divergent,
          div_ze2, div_k2, symmetrize};
  void* args[] = {
      &mu_in, &sigma_in, &slot_ids_in, &n_lm_in, &last_obs_in, &seen_in, &init_in,
      &div_in, &drop_in, &ids, &z, &R9, &valid, &slots,
      &mu_out, &sigma_out, &slot_ids_out, &n_lm_out, &last_obs_out, &seen_out,
      &div_out, &drop_out, &scratch, &bar, &cfg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ekf_frame_update_kernel),
                                    dim3(G), dim3(kThreads), args,
                                    static_cast<size_t>(smem), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekf_frame_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
