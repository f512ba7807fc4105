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
// stripe of the columns of the frame's active square in its own shared
// memory for the whole frame, with one hardware cluster barrier per
// processed observation; the rest of sigma is copied. Its
// body, ekf::cluster_frame in ekf_frame_common.cuh (which describes it), is
// shared with K2's cluster variant (ekf_frame_batched.cu), as are the
// prologue's lookup and sort and the 3x3 algebra.
//
// Variant 2, a cooperative grid (N above the cluster's capacity): sigma
// stays in device memory (in the 50 MB L2), in the output buffer; a
// persistent grid of resident blocks, each owning a stripe of columns,
// runs the same steps with a hand-written grid barrier (an arrival counter
// and a generation word in device memory, left at zero arrivals by the
// last block, so the buffer is cleared once and never again). Data written
// by another block is read with __ldcg (at L2). No -rdc build is needed.

#include "ekf_frame_common.cuh"
#include "grid_barrier.cuh"

namespace {

using namespace ekf;

constexpr int kThreads = 256;       // the grid variant
constexpr int kMinCols = 16;        // the grid variant's narrowest stripe
constexpr int kChunk = 1024;        // the grid variant: rows of K^T staged at once

// Grid: K^T rows kChunk x 3 | own B columns 3W | reduction 2 x 32 | slots M |
// order M. (The cluster variant's layout: cluster_words, ekf_frame_common.cuh.)
__host__ __device__ inline long long grid_words(int W, int M) {
  return 3LL * kChunk + 3LL * W + 64 + 2LL * M;
}

// ===========================================================================
// Variant 1: a thread-block cluster, sigma in distributed shared memory
// (the body is ekf::cluster_frame, shared with K2's cluster variant)
// ===========================================================================

__global__ void __launch_bounds__(kCThreads, 1)
ekf_frame_update_cluster_kernel(Io io, Cfg cfg) {
  cluster_frame(io, cfg, Lane{nullptr, nullptr, nullptr, nullptr, nullptr});
}

// ===========================================================================
// Variant 2: a cooperative grid, sigma in device memory
// ===========================================================================

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
  lookup_and_sort(io.slot_ids_in, io.ids, io.valid, L, M, s_slot, s_order);
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
    const Obs o = load_obs(io.z, io.R9, i, s_slot);

    if (o.slot >= 0) {
      // ---- known landmark (src/aruco_slam.cpp:108-207) ----
      float* Bm = scratch + (long long)parity * 3 * N;
      parity ^= 1;
      const int idx = 3 + 3 * o.slot;
      float ze[3], Gp[9];
      known_terms(io.mu_in, o, x0, y0, th0, cth, sth, ze, Gp);
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
      decide(cfg, io.seen_in, io.last_obs_in, o, ze, k_norm2, &gate, &div_hit);
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

// The cluster variant's stripe area holds N x W, any frame's square.
Cfg make_cfg(int N, int L, int M, int G, int W, int stationary_gate, float gate_eps2,
             int reject_divergent, float div_ze2, float div_k2, int symmetrize) {
  return Cfg{N, L, M, G, W, N * W, stationary_gate, gate_eps2, reject_divergent,
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
  const long long bytes = cluster_words((long long)N * w, N, w, M) * 4;
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
