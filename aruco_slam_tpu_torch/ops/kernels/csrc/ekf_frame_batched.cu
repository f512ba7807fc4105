// K2: the whole EKF frame step of B replay lanes, one launch per frame, in
// three variants whose kind is chosen by the state's size N and whose CTAs a
// lane by N and the batch B (ops/kernels/ekf_update_batched.py: variant).
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/ekf_update_batched.py
// (_frame_kernel, launched by frame_step_batched) together with the XLA
// glue that aruco_slam_tpu/runner.py (_replay_batch_kernel) runs around it
// every frame. Per lane, from the raw frame:
//   - the prologue: the compose of the frame's encoder ticks into (pose, A,
//     Q) (ekf.predict_compose: midpoint arcs, the latch's first tick), the
//     slot lookup and the stable (slot * M + arrival) sort with invalid
//     observations last (ekf_frame_common.cuh, shared with K6), in shared
//     memory, or past kMaxSharedObs observations in a region a CTA of the
//     workspace in device memory (any M takes one launch). Invalid
//     observations are never read, which is what the glue's sanitise (z ->
//     0, R -> I) made safe for the masked TPU kernel;
//   - the covariance predict sigma <- blockdiag(A, I) sigma blockdiag(A, I)^T
//     + blockdiag(Q, 0), mu[0:3] <- pose;
//   - the observations in their sorted order, each linearized at the
//     frame-start mean: a known landmark's rank-3 correction (stationary
//     gate, divergence count or reject), a new landmark's augmentation, or
//     a capacity drop, with the slot / last_obs / seen bookkeeping;
//   - sigma symmetrized on the way out, the latch set, and the replay's row
//     f of the lane's pose, pose covariance and landmark count written.
//
// What bounds it on Hopper: the chain, as in K6. Each observation reads
// rows of sigma that the previous one wrote, so a lane's observations run
// one after the other; the bytes bound (sigma read and written once) is a
// few microseconds at the main path's shape. The design keeps each lane's
// active block next to the SMs that work on it, spends as few barriers per
// observation as the data needs, and spreads the B lanes over the card:
//
// "smem" (one CTA per lane, N <= 234): the lane's sigma lives in the CTA's
//   shared memory for the frame; warp 0 composes the ticks while the other
//   warps load the state. A known observation costs two barriers: phase A
//   writes B = Gx sigma and each warp's part of the Gram matrix B B^T into
//   a double buffer; after the barrier every thread forms S, S^-1 and
//   ||K||^2 = tr(S^-1 B B^T S^-T) from the buffer in one fixed order (so
//   every thread takes the same gate / reject branch), and the rank-3
//   update runs with rows by warp and columns by lane, each lane's columns
//   of B held in registers (no integer division); the second barrier only
//   follows an observation that changed sigma. A new landmark is one pass
//   and one barrier. Rows and columns past the active landmarks are exactly
//   zero and stay so, so every pass stops at 3 + 3 n_landmarks. Two or more
//   lanes share an SM where shared memory allows.
// "cluster" (234 < N <= 927) and "device" (any larger N): one program, the
//   cluster body of ekf_frame_common.cuh (cluster_frame, shared with K6) on
//   a grid of B clusters of G CTAs, with K2's compose and predict around
//   it. The body works on the frame's active square only and copies the
//   rest of sigma in 16-byte vectors. The two kinds differ in the plan: the
//   cluster kind's stripe area holds N x ceil(N / G) (every frame runs on
//   chip), the device kind's is all the shared memory a CTA has, and a
//   lane whose square's stripes do not fit runs in place in the output
//   sigma in device memory (in L2), decided per lane inside the kernel. G
//   is the most CTAs a lane can have while the B clusters still fit the
//   card at once (the wrapper's rule, from cudaOccupancyMaxActiveClusters).

#include <algorithm>

#include "ekf_frame_common.cuh"

namespace {

using namespace ekf;

constexpr int kSThreads = 256;  // the smem variant
constexpr int kMaxWarps = 32;
constexpr int kColChunks = 8;   // columns of B a lane holds in registers: 8 x 32 per pass

// The batch's arrays; every [B, ...] array is batch-major and contiguous,
// the encoder ticks [B, T] at the given element strides.
struct BatchIo {
  const float* mu;
  const float* sigma;
  const int* slot_ids;
  const int* n_lm;
  const float* last_obs;
  const unsigned char* seen;
  const unsigned char* init;
  const int* div;
  const int* drop;
  const int* ids;
  const float* z;
  const float* R9;
  const unsigned char* valid;
  const float* wl;
  const float* wr;
  const float* dt;
  float* mu_out;
  float* sigma_out;
  int* slot_ids_out;
  int* n_lm_out;
  float* last_obs_out;
  unsigned char* seen_out;
  unsigned char* init_out;
  int* div_out;
  int* drop_out;
  float* traj;       // [B, F, 3] or null
  float* pose_cov;   // [B, F, 9]
  int* nlm_rows;     // [B, F]
  int* slots;        // [B, G, 2, M] the prologue's slots and order a CTA where M >
                     // kMaxSharedObs, else null
  long long s_wl[2], s_wr[2], s_dt[2];  // (batch, tick) strides
  int T, F, f;
};

// The smem variant's shared memory in 4-byte words: sigma N*N | mu N | mu0 N |
// B double buffer 2 x 3N | Gram partials 2 x 6 x kMaxWarps | pose, A, Q 21 |
// frozen last_obs 3L | slots M | order M (shared_slot_words) | frozen seen L
// bytes.
__host__ __device__ inline long long lane_words(int N, int L, int M) {
  return (long long)N * N + 8LL * N + 12LL * kMaxWarps + 21 + 3LL * L + shared_slot_words(M) +
         (L + 3) / 4;
}

// The cluster and device variants' stripe width on G CTAs: ceil(N / G), at
// least the pose block's 3 columns.
inline int stripe_width(int N, int G) { return std::max(3, (N + G - 1) / G); }

// Their shared memory in 4-byte words (the body's layout, then pose, A, Q):
// the cluster kind's stripe area holds N x W; the device kind takes a
// CTA's whole shared memory and gives the body what is left as its area.
long long batched_cluster_words(bool device, int N, int M, int G) {
  const int W = stripe_width(N, G);
  return device ? kMaxSharedBytes / 4 : cluster_words((long long)N * W, N, W, M) + 21;
}

// Lane b's compose (ekf_frame_common.cuh: compose_lane) into pq[21].
__device__ __forceinline__ void compose_batch_lane(const BatchIo& io, const Odom& od, int b, int N,
                                                   float* pq) {
  compose_lane(od, io.mu + (long long)b * N, io.init[b] != 0, io.wl + b * io.s_wl[0], io.s_wl[1],
               io.wr + b * io.s_wr[0], io.s_wr[1], io.dt + b * io.s_dt[0], io.s_dt[1], io.T, pq);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// ===========================================================================
// The smem variant: one CTA per lane, its sigma in shared memory
// ===========================================================================

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2)
ekf_frame_batched_lane_kernel(BatchIo io, Cfg cfg, Odom od) {
  extern __shared__ float smem[];
  const int N = cfg.N, L = cfg.L, M = cfg.M;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const long long NN = (long long)N * N;

  float* s = smem;
  float* mu = smem + NN;
  float* mu0 = mu + N;
  float* Bb = mu0 + N;                 // [2][3N]
  float* Gw = Bb + 6 * N;              // [2][kMaxWarps][6]
  float* pq = Gw + 12 * kMaxWarps;     // [21]
  float* f_last = pq + 21;             // [3L]
  int* s_sh = reinterpret_cast<int*>(f_last + 3 * L);  // [2M] where the frame is narrow enough
  unsigned char* f_seen = reinterpret_cast<unsigned char*>(s_sh + shared_slot_words(M));  // [L]

  int* s_slot = prologue_slots(s_sh, io.slots, b, M);  // [M]
  int* s_order = s_slot + M;                             // [M]
  const float* sig_in = io.sigma + b * NN;
  const int* ids = io.ids + (long long)b * M;
  const float* z = io.z + (long long)b * 3 * M;
  const float* R9 = io.R9 + (long long)b * 9 * M;
  const unsigned char* valid = io.valid + (long long)b * M;
  float* last_out = io.last_obs_out + (long long)b * 3 * L;
  unsigned char* seen_out = io.seen_out + (long long)b * L;
  int* slot_out = io.slot_ids_out + (long long)b * L;
  int n_lm = io.n_lm[b];

  // ---- prologue: warp 0 composes, the others load; then lookup and sort
  if (warp == 0) {
    compose_batch_lane(io, od, b, N, pq);
  } else {
    const int t0 = tid - 32, nt = kThreads - 32;
    // the observations into L1 for the chain (lines of 128 bytes)
    for (int e = t0; 128 * e < 36 * M; e += nt) prefetch_l1(reinterpret_cast<const char*>(R9) + 128 * e);
    for (int e = t0; 128 * e < 12 * M; e += nt) prefetch_l1(reinterpret_cast<const char*>(z) + 128 * e);
    // sigma into shared memory
    for (long long e0 = t0; e0 < NN; e0 += (long long)nt * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long e = e0 + (long long)u * nt;
        if (e < NN) v[u] = sig_in[e];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long e = e0 + (long long)u * nt;
        if (e < NN) s[e] = v[u];
      }
    }
    for (int j = t0; j < N; j += nt) mu[j] = mu0[j] = io.mu[(long long)b * N + j];
    for (int e = t0; e < 3 * L; e += nt) f_last[e] = last_out[e] = io.last_obs[(long long)b * 3 * L + e];
    for (int l = t0; l < L; l += nt) {
      f_seen[l] = io.seen[(long long)b * L + l];
      seen_out[l] = 0;
      slot_out[l] = io.slot_ids[(long long)b * L + l];
    }
  }
  lookup_and_sort(io.slot_ids + (long long)b * L, ids, valid, L, M, s_slot, s_order);

  // ---- the covariance predict with the frame's (A, Q); mu[0:3] <- pose
  {
    const float* A = pq + 3;
    const float* Q = pq + 12;
    const int na = 3 + 3 * n_lm;
    float* T0 = Bb;  // rows 0..2 of A sigma
    for (int j = tid; j < na; j += kThreads) {
      const float s0 = s[j], s1 = s[N + j], s2 = s[2 * N + j];
#pragma unroll
      for (int i = 0; i < 3; ++i) T0[i * N + j] = A[3 * i] * s0 + A[3 * i + 1] * s1 + A[3 * i + 2] * s2;
    }
    __syncthreads();
    for (int j = tid; j < na; j += kThreads) {
      float t[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = j < 3 ? T0[j * N + k] : s[(long long)j * N + k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s[(long long)j * N + c] = t[0] * A[3 * c] + t[1] * A[3 * c + 1] + t[2] * A[3 * c + 2] +
                                  (j < 3 ? Q[3 * j + c] : 0.0f);
      if (j >= 3) {
#pragma unroll
        for (int i = 0; i < 3; ++i) s[i * N + j] = T0[i * N + j];
      }
    }
    if (tid < 3) mu[tid] = mu0[tid] = pq[tid];
    __syncthreads();
  }

  // ---- the sorted observations, in order ----
  const float x0 = pq[0], y0 = pq[1], th0 = pq[2];
  const float sth = sinf(th0), cth = cosf(th0);
  const float Gl[9] = {cth, sth, 0.0f, -sth, cth, 0.0f, 0.0f, 0.0f, 1.0f};
  int diverged = io.div[b], dropped = io.drop[b];
  int par = 0;

  for (int p = 0; p < M; ++p) {
    const int i = s_order[p];
    if (!valid[i]) break;  // the invalid ones are sorted last
    const Obs o = load_obs(z, R9, i, s_slot);

    if (o.slot >= 0) {
      // ---- known landmark (src/aruco_slam.cpp:108-207) ----
      const int idx = 3 + 3 * o.slot;
      const int na = 3 + 3 * n_lm;
      float ze[3], Gp[9];
      known_terms(mu0, o, x0, y0, th0, cth, sth, ze, Gp);
      float* Bm = Bb + par * 3 * N;
      float* G = Gw + par * 6 * kMaxWarps;
      par ^= 1;
      // phase A: B = Gx sigma over the active columns, and B B^T
      float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = tid; j < na; j += kThreads) {
        const float sp0 = s[j], sp1 = s[N + j], sp2 = s[2 * N + j];
        const float sl0 = s[(long long)idx * N + j], sl1 = s[(long long)(idx + 1) * N + j];
        const float sl2 = s[(long long)(idx + 2) * N + j];
        float bv[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          bv[a] = Gp[3 * a] * sp0 + Gp[3 * a + 1] * sp1 + Gp[3 * a + 2] * sp2 +
                  Gl[3 * a] * sl0 + Gl[3 * a + 1] * sl1 + Gl[3 * a + 2] * sl2;
          Bm[a * N + j] = bv[a];
        }
        g[0] += bv[0] * bv[0];
        g[1] += bv[0] * bv[1];
        g[2] += bv[0] * bv[2];
        g[3] += bv[1] * bv[1];
        g[4] += bv[1] * bv[2];
        g[5] += bv[2] * bv[2];
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) g[q] += __shfl_down_sync(0xffffffffu, g[q], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 6; ++q) G[warp * 6 + q] = g[q];
      }
      __syncthreads();

      // S = B[:, 0:3] Gp^T + B[:, block] Gl^T + R, S^-1 and ||K||^2, the
      // same in every thread
      float S[9], invS[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc += Bm[a * N + k] * Gp[3 * c + k] + Bm[a * N + idx + k] * Gl[3 * c + k];
          S[3 * a + c] = acc + o.Rk[3 * a + c];
        }
      inv3(S, invS);
      float gs[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int q = 0; q < 6; ++q) gs[q] += G[w * 6 + q];
      }
      const float Gm[9] = {gs[0], gs[1], gs[2], gs[1], gs[3], gs[4], gs[2], gs[4], gs[5]};
      float k_norm2 = 0.0f;  // sum over a of invS[a, :] G invS[a, :]^T
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float gc = Gm[3 * c] * invS[3 * a] + Gm[3 * c + 1] * invS[3 * a + 1] +
                           Gm[3 * c + 2] * invS[3 * a + 2];
          k_norm2 += invS[3 * a + c] * gc;
        }
      }
      bool gate, div_hit;
      decide(cfg, f_seen, f_last, o, ze, k_norm2, &gate, &div_hit);
      const bool reject = cfg.reject_divergent && div_hit;
      if (!gate && !reject) {
        // mu += K ze; sigma -= K B, K^T = S^-1 B: rows by warp, columns by
        // lane, the lane's columns of B in registers
        for (int j = tid; j < na; j += kThreads) {
          const float b0 = Bm[j], b1 = Bm[N + j], b2 = Bm[2 * N + j];
          float dm = 0.0f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            dm += ze[a] * (invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2);
          mu[j] = mu[j] + dm;
        }
        for (int cb = 0; cb < na; cb += 32 * kColChunks) {
          float bc[kColChunks][3];
#pragma unroll
          for (int q = 0; q < kColChunks; ++q) {
            const int c = cb + lane + 32 * q;
#pragma unroll
            for (int a = 0; a < 3; ++a) bc[q][a] = c < na ? Bm[a * N + c] : 0.0f;
          }
          for (int r = warp; r < na; r += kWarps) {
            const float b0 = Bm[r], b1 = Bm[N + r], b2 = Bm[2 * N + r];
            float kt[3];
#pragma unroll
            for (int a = 0; a < 3; ++a)
              kt[a] = invS[3 * a] * b0 + invS[3 * a + 1] * b1 + invS[3 * a + 2] * b2;
            float* row = s + (long long)r * N;
#pragma unroll
            for (int q = 0; q < kColChunks; ++q) {
              const int c = cb + lane + 32 * q;
              if (c < na) row[c] = row[c] - (kt[0] * bc[q][0] + kt[1] * bc[q][1] + kt[2] * bc[q][2]);
            }
          }
        }
        __syncthreads();  // the next phase A reads the updated rows
      }
      if (tid == 0) {
        // last_obs entry: z, or zeros on a stationary-gate hit (quirk (c))
#pragma unroll
        for (int a = 0; a < 3; ++a) last_out[3 * o.slot + a] = gate ? 0.0f : o.zz[a];
        seen_out[o.slot] = 1;
      }
      diverged += div_hit ? 1 : 0;
    } else if (n_lm < L) {
      // ---- new landmark (src/aruco_slam.cpp:208-260) ----
      // Rows and columns idx..idx+2 are zero and nothing below reads them,
      // so one pass writes them: sigma_mx across, its transpose down, and
      // sigma_mm on the new block.
      const int idx = 3 + 3 * n_lm;
      float map_r[3], Gsk[9], GG[9], smm[9];
      insert_terms(o, x0, y0, th0, cth, sth, Gl, map_r, Gsk, GG);
      const float sig3[9] = {s[0], s[1], s[2], s[N], s[N + 1], s[N + 2],
                             s[2 * N], s[2 * N + 1], s[2 * N + 2]};
      insert_smm(sig3, Gsk, Gl, o.Rk, smm);
      for (int j = tid; j < idx; j += kThreads) {
        const float sp0 = s[j], sp1 = s[N + j], sp2 = s[2 * N + j];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float u = -(GG[3 * r] * sp0 + GG[3 * r + 1] * sp1 + GG[3 * r + 2] * sp2);
          s[(long long)(idx + r) * N + j] = u;
          s[(long long)j * N + idx + r] = u;
        }
      }
      if (tid < 9) s[(long long)(idx + tid / 3) * N + idx + tid % 3] = smm[tid];
      if (tid < 3) mu[idx + tid] = mu[idx + tid] + map_r[tid];
      if (tid == 0) {
        slot_out[n_lm] = ids[o.i];
#pragma unroll
        for (int a = 0; a < 3; ++a) last_out[3 * n_lm + a] = 0.0f;
        seen_out[n_lm] = 1;
      }
      n_lm += 1;
      __syncthreads();
    } else {
      dropped += 1;  // capacity drop
    }
  }
  __syncthreads();

  // ---- write back; symmetrize on the way out ----
  const int na = 3 + 3 * n_lm;
  {
    float* sig_o = io.sigma_out + b * NN;
    for (int r = warp; r < N; r += kWarps) {
      for (int c = lane; c < N; c += 32) {
        float v = 0.0f;  // past the active block sigma is zero
        if (r < na && c < na) v = cfg.symmetrize ? 0.5f * (s[r * N + c] + s[c * N + r]) : s[r * N + c];
        sig_o[(long long)r * N + c] = v;
      }
    }
  }
  for (int j = tid; j < N; j += kThreads) io.mu_out[(long long)b * N + j] = mu[j];
  if (tid == 0) {
    io.n_lm_out[b] = n_lm;
    io.div_out[b] = diverged;
    io.drop_out[b] = dropped;
    io.init_out[b] = 1;
  }
  if (io.traj) {
    const long long row = (long long)b * io.F + io.f;
    if (tid < 9) {
      const int r = tid / 3, c = tid % 3;
      io.pose_cov[row * 9 + tid] = cfg.symmetrize ? 0.5f * (s[r * N + c] + s[c * N + r])
                                                  : s[r * N + c];
    }
    if (tid < 3) io.traj[row * 3 + tid] = mu[tid];
    if (tid == 0) io.nlm_rows[row] = n_lm;
  }
}

// ===========================================================================
// The cluster and device variants: K6's cluster body, one cluster per lane
// ===========================================================================

__global__ void __launch_bounds__(kCThreads, 1)
ekf_frame_batched_cluster_kernel(BatchIo bio, Cfg cfg, Odom od) {
  extern __shared__ float smem[];
  const int N = cfg.N, L = cfg.L, M = cfg.M;
  const int b = blockIdx.x / cfg.G;
  float* pq = smem + cluster_words(cfg.cap, N, cfg.W, M);
  if (threadIdx.x < 32) compose_batch_lane(bio, od, b, N, pq);  // read after the body's first barrier
  const long long NN = (long long)N * N;
  const Io io{bio.mu + (long long)b * N, bio.sigma + b * NN, bio.slot_ids + (long long)b * L,
              bio.n_lm + b, bio.last_obs + (long long)b * 3 * L, bio.seen + (long long)b * L,
              bio.init + b, bio.div + b, bio.drop + b, bio.ids + (long long)b * M,
              bio.z + (long long)b * 3 * M, bio.R9 + (long long)b * 9 * M,
              bio.valid + (long long)b * M, bio.mu_out + (long long)b * N, bio.sigma_out + b * NN,
              bio.slot_ids_out + (long long)b * L, bio.n_lm_out + b,
              bio.last_obs_out + (long long)b * 3 * L, bio.seen_out + (long long)b * L,
              bio.div_out + b, bio.drop_out + b,
              bio.slots ? bio.slots + (long long)b * cfg.G * 2 * M : nullptr};
  const long long row = (long long)b * bio.F + bio.f;
  const bool rows = bio.traj != nullptr;
  const Lane ln{pq, rows ? bio.traj + row * 3 : nullptr, rows ? bio.pose_cov + row * 9 : nullptr,
                rows ? bio.nlm_rows + row : nullptr, bio.init_out + b};
  cluster_frame(io, cfg, ln);
}

// The kernel of a variant (0 smem, 1 cluster, 2 device) and its threads.
const void* kernel_of(int variant, int* threads) {
  switch (variant) {
    case 0:
      *threads = kSThreads;
      return reinterpret_cast<const void*>(ekf_frame_batched_lane_kernel<kSThreads>);
    case 1:
    case 2:
      *threads = kCThreads;
      return reinterpret_cast<const void*>(ekf_frame_batched_cluster_kernel);
    default:
      return nullptr;
  }
}

}  // namespace

// Shared bytes per CTA of a variant (0 smem; 1 cluster and 2 device, each
// with G CTAs a lane) for an N-dim state, L slots and M observations; the
// wrapper's plan mirrors it
// (ekf_update_batched.shared_bytes).
extern "C" long long ekf_frame_batched_smem_bytes(int variant, int N, int L, int M, int G) {
  if (variant == 0) return lane_words(N, L, M) * 4;
  return batched_cluster_words(variant == 2, N, M, G) * 4;
}

// A variant's plan: shared bytes per CTA and how many CTAs (clusters of G
// for the cluster and device variants) the current card holds at once, 0
// if none; sets the kernel's attributes, so that a launch needs no other
// call.
extern "C" int ekf_frame_batched_plan(int variant, int N, int L, int M, int G, int* smem_bytes,
                                      int* resident) {
  int threads = 0;
  const void* fn = kernel_of(variant, &threads);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = ekf_frame_batched_smem_bytes(variant, N, L, M, G);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2 && bytes / 4 < cluster_words(0, N, stripe_width(N, G), M) + 21)
    return static_cast<int>(cudaErrorInvalidValue);  // no room for the body's buffers
  // the most any size needs, so that plans cached for other sizes stay valid
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = 0;
  if (variant != 0) {
    if (G < 1 || G > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    if (G > 8) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchConfig_t lc = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.gridDim = dim3(G);
    lc.blockDim = dim3(threads);
    lc.dynamicSmemBytes = static_cast<size_t>(bytes);
    lc.attrs = attr;
    lc.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, fn, &lc);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, static_cast<size_t>(bytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(bytes);
  *resident = n;
  return 0;
}

// ptrs: mu, sigma, slot_ids, n_lm, last_obs, seen, init, div, drop, ids, z,
// R9, valid, wl, wr, dt (inputs; observations in arrival order), mu, sigma,
// slot_ids, n_lm, last_obs, seen, init, div, drop (outputs), traj, pose_cov,
// nlm_rows (the replay's rows, or null), slots ([B, G, 2, M] int32 where M >
// kMaxSharedObs, else null). strides: wl, wr, dt (batch, tick).
// fcfg: gate_eps2, div_ze2, div_k2, kl, kr, two_b, inv_b, kl_over_b,
// kr_over_b, half_kl, q_k. icfg: B, N, L, M, G, T, F, f, stationary_gate,
// reject_divergent, symmetrize, kl_both.
extern "C" int ekf_frame_batched_launch(int variant, void* const* ptrs, const long long* strides,
                                        const float* fcfg, const int* icfg, int smem_bytes,
                                        void* stream) {
  const int B = icfg[0], N = icfg[1], L = icfg[2], M = icfg[3], G = icfg[4];
  if (B <= 0) return 0;
  BatchIo io;
  io.mu = static_cast<const float*>(ptrs[0]);
  io.sigma = static_cast<const float*>(ptrs[1]);
  io.slot_ids = static_cast<const int*>(ptrs[2]);
  io.n_lm = static_cast<const int*>(ptrs[3]);
  io.last_obs = static_cast<const float*>(ptrs[4]);
  io.seen = static_cast<const unsigned char*>(ptrs[5]);
  io.init = static_cast<const unsigned char*>(ptrs[6]);
  io.div = static_cast<const int*>(ptrs[7]);
  io.drop = static_cast<const int*>(ptrs[8]);
  io.ids = static_cast<const int*>(ptrs[9]);
  io.z = static_cast<const float*>(ptrs[10]);
  io.R9 = static_cast<const float*>(ptrs[11]);
  io.valid = static_cast<const unsigned char*>(ptrs[12]);
  io.wl = static_cast<const float*>(ptrs[13]);
  io.wr = static_cast<const float*>(ptrs[14]);
  io.dt = static_cast<const float*>(ptrs[15]);
  io.mu_out = static_cast<float*>(ptrs[16]);
  io.sigma_out = static_cast<float*>(ptrs[17]);
  io.slot_ids_out = static_cast<int*>(ptrs[18]);
  io.n_lm_out = static_cast<int*>(ptrs[19]);
  io.last_obs_out = static_cast<float*>(ptrs[20]);
  io.seen_out = static_cast<unsigned char*>(ptrs[21]);
  io.init_out = static_cast<unsigned char*>(ptrs[22]);
  io.div_out = static_cast<int*>(ptrs[23]);
  io.drop_out = static_cast<int*>(ptrs[24]);
  io.traj = static_cast<float*>(ptrs[25]);
  io.pose_cov = static_cast<float*>(ptrs[26]);
  io.nlm_rows = static_cast<int*>(ptrs[27]);
  io.slots = static_cast<int*>(ptrs[28]);
  if (M > kMaxSharedObs && io.slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 2; ++k) {
    io.s_wl[k] = strides[k];
    io.s_wr[k] = strides[2 + k];
    io.s_dt[k] = strides[4 + k];
  }
  io.T = icfg[5];
  io.F = icfg[6];
  io.f = icfg[7];
  const int W = variant == 0 ? 0 : stripe_width(N, G);
  // the cluster body's stripe area: what the plan's shared memory leaves it
  const int cap = variant == 0 ? 0 : smem_bytes / 4 - static_cast<int>(cluster_words(0, N, W, M) + 21);
  const Cfg cfg{N, L, M, G, W, cap, icfg[8], fcfg[0], icfg[9], fcfg[1], fcfg[2], icfg[10]};
  const Odom od{fcfg[3], fcfg[4], fcfg[5], fcfg[6], fcfg[7], fcfg[8], fcfg[9], fcfg[10], icfg[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (variant == 0) {
    ekf_frame_batched_lane_kernel<kSThreads><<<B, kSThreads, smem_bytes, st>>>(io, cfg, od);
  } else if (variant == 1 || variant == 2) {
    cudaLaunchConfig_t lc = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.gridDim = dim3(B * G);
    lc.blockDim = dim3(kCThreads);
    lc.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    lc.stream = st;
    lc.attrs = attr;
    lc.numAttrs = 1;
    err = cudaLaunchKernelEx(&lc, ekf_frame_batched_cluster_kernel, io, cfg, od);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ekf_frame_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
