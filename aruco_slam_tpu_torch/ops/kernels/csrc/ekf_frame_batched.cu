// K2: one EKF frame step for a batch of replay lanes, one CTA per lane.
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/ekf_update_batched.py
// (_frame_kernel, launched by frame_step_batched). Per lane: the covariance
// predict with the frame's composed pose Jacobian A and process noise Q
// (sigma <- blockdiag(A, I) sigma blockdiag(A, I)^T + blockdiag(Q, 0)),
// mu[0:3] <- pose, then the frame's M observations in their sorted order:
// a known landmark's rank-3 correction linearized at the frame-start mean
// (stale mu0, closed-form 3x3 inverse, stationary gate, divergence count or
// reject), a new landmark's augmentation, or a capacity drop, with the
// slot / last_obs / seen bookkeeping; then sigma is symmetrized on the way
// out.
//
// What bounds it on Hopper: shared-memory traffic. The lane's covariance
// (N^2 floats: 39,204 bytes at N = 99) is read from device memory once,
// lives in shared memory for the predict and the whole sequential chain,
// and is written back once — each observation's rank-3 update touches all
// N^2 entries, so keeping sigma out of device memory is the design's point.
// The TPU kernel put the batch on the vector lanes ([N, N, B]); here the
// batch is the grid (sigma is batch-major [B, N, N]) and the 256 threads of
// a CTA split the N-long rows and the N^2 update. Reductions over N (the
// gain norm) use warp shuffles plus a shared scratch. Branches depend only
// on the lane's own observation, so they are uniform across the CTA.
// Shared memory above 48 KB is dynamic (cudaFuncSetAttribute); the wrapper
// refuses sizes above the 227 KB a block can hold.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Cfg {
  int N, L, M;              // state dim, landmark slots, observations/frame
  int stationary_gate;      // CompatConfig.stationary_gate
  float gate_eps2;          // stationary_gate_eps^2
  int reject_divergent;     // CompatConfig.reject_divergent
  float div_ze2, div_k2;    // divergence_ze_norm^2, divergence_k_norm^2
  int symmetrize;           // EkfConfig.symmetrize_sigma
};

// Shared-memory layout, in 4-byte words (the wrapper's shared_bytes()
// mirrors this): sigma N*N | mu N | mu0 N | Bm 3N | KT 3N | red 33 |
// frozen_last 3L | new_last 3L | slot_ids L | frozen_seen L | new_seen L |
// scal 3 (n_lm, diverged, dropped).
__host__ __device__ inline long long smem_words(int N, int L) {
  return (long long)N * N + 8LL * N + 33 + 9LL * L + 3;
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

// Sum of v over the block; every thread gets the total. red[0..31] holds
// the warp partials, red[32] the total.
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
  return red[32];
}

__global__ void __launch_bounds__(kThreads)
ekf_frame_kernel(const float* __restrict__ mu_in,        // [B, N]
                 const float* __restrict__ sigma_in,     // [B, N, N]
                 const int* __restrict__ slot_ids_in,    // [B, L]
                 const int* __restrict__ n_lm_in,        // [B]
                 const float* __restrict__ last_obs_in,  // [B, L, 3]
                 const unsigned char* __restrict__ seen_in,  // [B, L]
                 const int* __restrict__ div_in,         // [B]
                 const int* __restrict__ drop_in,        // [B]
                 const float* __restrict__ pose,         // [B, 3]
                 const float* __restrict__ A9,           // [B, 9]
                 const float* __restrict__ Q9,           // [B, 9]
                 const int* __restrict__ ids,            // [B, M] sorted
                 const float* __restrict__ z,            // [B, M, 3]
                 const float* __restrict__ R9,           // [B, M, 9]
                 const unsigned char* __restrict__ valid,  // [B, M]
                 const int* __restrict__ slots,          // [B, M] frame-start
                 float* __restrict__ mu_out, float* __restrict__ sigma_out,
                 int* __restrict__ slot_ids_out, int* __restrict__ n_lm_out,
                 float* __restrict__ last_obs_out,
                 unsigned char* __restrict__ seen_out,
                 int* __restrict__ div_out, int* __restrict__ drop_out,
                 Cfg cfg) {
  extern __shared__ float smem[];
  const int N = cfg.N, L = cfg.L, M = cfg.M;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int NN = N * N;  // <= 227 KB / 4: fits an int

  float* s = smem;
  float* mu = s + NN;
  float* mu0 = mu + N;
  float* Bm = mu0 + N;   // rows of B = Gx sigma; scratch for the predict
  float* KT = Bm + 3 * N;  // rows of K^T; the insert's u rows
  float* red = KT + 3 * N;
  float* frozen_last = red + 33;
  float* new_last = frozen_last + 3 * L;
  int* slot_ids = reinterpret_cast<int*>(new_last + 3 * L);
  int* frozen_seen = slot_ids + L;
  int* new_seen = frozen_seen + L;
  int* scal = new_seen + L;

  // ---- load the lane's state ----
  const float* sig_g = sigma_in + (long long)b * NN;
  for (int e = tid; e < NN; e += kThreads) s[e] = sig_g[e];
  for (int j = tid; j < N; j += kThreads) mu[j] = mu_in[(long long)b * N + j];
  for (int l = tid; l < L; l += kThreads) {
    slot_ids[l] = slot_ids_in[b * L + l];
    frozen_seen[l] = seen_in[b * L + l] != 0;
    new_seen[l] = 0;
  }
  for (int e = tid; e < 3 * L; e += kThreads) {
    frozen_last[e] = new_last[e] = last_obs_in[(long long)b * 3 * L + e];
  }
  if (tid == 0) {
    scal[0] = n_lm_in[b];
    scal[1] = div_in[b];
    scal[2] = drop_in[b];
  }
  float A[9], Q[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    A[e] = A9[b * 9 + e];
    Q[e] = Q9[b * 9 + e];
  }
  __syncthreads();

  // ---- predict: pose rows, then pose columns (+ Q) ----
  for (int j = tid; j < N; j += kThreads) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      Bm[i * N + j] = A[3 * i] * s[j] + A[3 * i + 1] * s[N + j] + A[3 * i + 2] * s[2 * N + j];
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i * N + j] = Bm[i * N + j];
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    const float* row = s + j * N;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Bm[c * N + j] = row[0] * A[3 * c] + row[1] * A[3 * c + 1] + row[2] * A[3 * c + 2] +
                      (j < 3 ? Q[3 * j + c] : 0.0f);
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s[j * N + c] = Bm[c * N + j];
  }
  if (tid < 3) mu[tid] = pose[b * 3 + tid];
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) mu0[j] = mu[j];
  __syncthreads();

  // ---- the sorted observations, in order ----
  const float x0 = mu0[0], y0 = mu0[1], th0 = mu0[2];
  const float sth = sinf(th0), cth = cosf(th0);
  const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};

  for (int i = 0; i < M; ++i) {
    const int o = b * M + i;
    if (!valid[o]) continue;  // uniform across the CTA
    const int slot = slots[o];
    const float zz[3] = {z[o * 3], z[o * 3 + 1], z[o * 3 + 2]};
    float Rk[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) Rk[e] = R9[o * 9 + e];
    const int n_lm = scal[0];
    __syncthreads();  // every thread has read scal before thread 0 writes it

    if (slot >= 0) {
      // ---- known landmark (src/aruco_slam.cpp:108-207) ----
      const int idx = 3 + 3 * slot;
      const float gdx = mu0[idx] - x0;
      const float gdy = mu0[idx + 1] - y0;
      const float gdth = wrap_angle(mu0[idx + 2] - th0);
      const float ze[3] = {zz[0] - (gdx * cth + gdy * sth),
                           zz[1] - (-gdx * sth + gdy * cth),
                           wrap_angle(zz[2] - gdth)};
      const float Gp[9] = {-cth, -sth, -gdx * sth + gdy * cth,
                           sth, -cth, -gdx * cth - gdy * sth,
                           0.0f, 0.0f, -1.0f};
      for (int j = tid; j < N; j += kThreads) {
        const float sp0 = s[j], sp1 = s[N + j], sp2 = s[2 * N + j];
        const float sl0 = s[idx * N + j];
        const float sl1 = s[(idx + 1) * N + j];
        const float sl2 = s[(idx + 2) * N + j];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          Bm[a * N + j] = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                          Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
      }
      __syncthreads();
      // S = B[:, 0:3] Gp^T + B[:, block] Gl^T + R (every thread, redundantly)
      float S[9], invS[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc += Bm[a * N + k] * Gp[3 * c + k] + Bm[a * N + idx + k] * Gl[3 * c + k];
          S[3 * a + c] = acc + Rk[3 * a + c];
        }
      inv3(S, invS);
      float part = 0.0f;
      for (int j = tid; j < N; j += kThreads) {
        const float b0 = Bm[j], b1 = Bm[N + j], b2 = Bm[2 * N + j];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float kt = invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2;
          KT[a * N + j] = kt;
          part += kt * kt;
        }
      }
      const float k_norm2 = block_sum(part, red);  // also publishes KT
      const float ze_norm2 = ze[0] * ze[0] + ze[1] * ze[1] + ze[2] * ze[2];
      const bool div_hit = (ze_norm2 >= cfg.div_ze2) || (k_norm2 >= cfg.div_k2);
      bool gate = false;
      if (cfg.stationary_gate && frozen_seen[slot]) {
        float d2 = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float dd = frozen_last[3 * slot + a] - zz[a];
          d2 += dd * dd;
        }
        gate = d2 < cfg.gate_eps2;
      }
      const bool reject = cfg.reject_divergent && div_hit;
      if (!gate && !reject) {
        for (int j = tid; j < N; j += kThreads)
          mu[j] = mu[j] + (ze[0] * KT[j] + ze[1] * KT[N + j] + ze[2] * KT[2 * N + j]);
        // sigma <- sigma - K B, one rank-1 term at a time
        for (int e = tid; e < NN; e += kThreads) {
          const int r = e / N;
          const int c = e - r * N;
          float v = s[e];
          v = v - KT[r] * Bm[c];
          v = v - KT[N + r] * Bm[N + c];
          v = v - KT[2 * N + r] * Bm[2 * N + c];
          s[e] = v;
        }
      }
      if (tid == 0) {
        // last_obs entry: z, or zeros on a stationary-gate hit (quirk (c))
#pragma unroll
        for (int a = 0; a < 3; ++a) new_last[3 * slot + a] = gate ? 0.0f : zz[a];
        new_seen[slot] = 1;
        scal[1] += div_hit ? 1 : 0;
      }
    } else if (n_lm < L) {
      // ---- new landmark (src/aruco_slam.cpp:208-260) ----
      const int idx = 3 + 3 * n_lm;
      const float map_r[3] = {x0 + cth * zz[0] - sth * zz[1],
                              y0 + sth * zz[0] + cth * zz[1],
                              wrap_angle(th0 + zz[2])};
      const float dxn = map_r[0] - x0, dyn = map_r[1] - y0;
      const float Gsk[9] = {-cth, -sth, -sth * dxn + cth * dyn,
                            sth, -cth, -dxn * cth - dyn * sth,
                            0.0f, 0.0f, -1.0f};
      const float sig3[9] = {s[0], s[1], s[2], s[N], s[N + 1], s[N + 2],
                             s[2 * N], s[2 * N + 1], s[2 * N + 2]};
      float T0[9], T1[9], inner[9], innerT[9], GskT[9], GlT[9], smm[9], GG[9];
      matmul3(Gsk, sig3, T0);
      transpose3(Gsk, GskT);
      matmul3(T0, GskT, inner);
#pragma unroll
      for (int e = 0; e < 9; ++e) inner[e] += Rk[e];
      transpose3(inner, innerT);
      matmul3(Gl, innerT, T1);  // Gmi == Gl = R(theta)^T
      transpose3(Gl, GlT);
      matmul3(T1, GlT, smm);
      matmul3(Gl, Gsk, GG);
      // u_r = sigma_mx row r + 0.5 * smm[r, :] on the new block: the row
      // pass and the column pass below each add it once
      for (int j = tid; j < N; j += kThreads) {
        const float sp0 = s[j], sp1 = s[N + j], sp2 = s[2 * N + j];
        const int in_blk = j - idx;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float u = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
          if (in_blk >= 0 && in_blk < 3) u += 0.5f * smm[3 * r + in_blk];
          KT[r * N + j] = u;
        }
      }
      __syncthreads();
      for (int t = tid; t < 3 * N; t += kThreads) {
        const int r = t / N, j = t - r * N;
        s[(idx + r) * N + j] += KT[r * N + j];
      }
      __syncthreads();
      for (int t = tid; t < 3 * N; t += kThreads) {
        const int r = t / N, j = t - r * N;
        s[j * N + idx + r] += KT[r * N + j];
      }
      if (tid < 3) mu[idx + tid] += map_r[tid];
      if (tid == 0) {
        slot_ids[n_lm] = ids[o];
        scal[0] = n_lm + 1;
#pragma unroll
        for (int a = 0; a < 3; ++a) new_last[3 * n_lm + a] = 0.0f;
        new_seen[n_lm] = 1;
      }
    } else {
      if (tid == 0) scal[2] += 1;  // capacity drop
    }
    __syncthreads();
  }

  // ---- write back; symmetrize on the way out ----
  float* sig_o = sigma_out + (long long)b * NN;
  for (int e = tid; e < NN; e += kThreads) {
    if (cfg.symmetrize) {
      const int r = e / N;
      const int c = e - r * N;
      sig_o[e] = 0.5f * (s[e] + s[c * N + r]);
    } else {
      sig_o[e] = s[e];
    }
  }
  for (int j = tid; j < N; j += kThreads) mu_out[(long long)b * N + j] = mu[j];
  for (int l = tid; l < L; l += kThreads) {
    slot_ids_out[b * L + l] = slot_ids[l];
    seen_out[b * L + l] = static_cast<unsigned char>(new_seen[l]);
  }
  for (int e = tid; e < 3 * L; e += kThreads)
    last_obs_out[(long long)b * 3 * L + e] = new_last[e];
  if (tid == 0) {
    n_lm_out[b] = scal[0];
    div_out[b] = scal[1];
    drop_out[b] = scal[2];
  }
}

}  // namespace

extern "C" long long ekf_frame_smem_bytes(int N, int L) {
  return smem_words(N, L) * 4;
}

extern "C" int ekf_frame_launch(
    const float* mu_in, const float* sigma_in, const int* slot_ids_in,
    const int* n_lm_in, const float* last_obs_in, const unsigned char* seen_in,
    const int* div_in, const int* drop_in,
    const float* pose, const float* A9, const float* Q9,
    const int* ids, const float* z, const float* R9,
    const unsigned char* valid, const int* slots,
    float* mu_out, float* sigma_out, int* slot_ids_out, int* n_lm_out,
    float* last_obs_out, unsigned char* seen_out, int* div_out, int* drop_out,
    int B, int N, int L, int M,
    int stationary_gate, float gate_eps2, int reject_divergent,
    float div_ze2, float div_k2, int symmetrize, void* stream) {
  if (B <= 0) return 0;
  const long long smem = smem_words(N, L) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ekf_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cfg cfg{N, L, M, stationary_gate, gate_eps2, reject_divergent,
                div_ze2, div_k2, symmetrize};
  ekf_frame_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mu_in, sigma_in, slot_ids_in, n_lm_in, last_obs_in, seen_in, div_in,
      drop_in, pose, A9, Q9, ids, z, R9, valid, slots, mu_out, sigma_out,
      slot_ids_out, n_lm_out, last_obs_out, seen_out, div_out, drop_out, cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekf_frame_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
