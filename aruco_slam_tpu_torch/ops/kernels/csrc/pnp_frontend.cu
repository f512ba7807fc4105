// K1: the PnP front-end, a group of 8 threads per (sequence, marker-slot)
// lane: one thread per (start, corner) pair.
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/pnp_frontend.py
// (_pnp_kernel, launched by pnp_frontend_batch). Per lane: pixel corners ->
// 8-step Brown-Conrady undistortion -> Heckbert unit-square homography ->
// Zhang init and the planar-flip second start -> Gauss-Newton (settle on
// both starts, the lower residual finishes; unrolled 6x6 Cholesky) ->
// robot-frame observation (x, y, heading) -> diagonal covariance from the
// mean-squared reprojection error -> range and covariance-norm gates. A
// padded slot (valid = 0) exits at once with keep = 0, z = 0 and R = I.
//
// What bounds it on Hopper: the latency of a dependent chain of about 10k
// float operations per lane, not bytes (a lane reads 33 bytes and writes
// 49). One thread per lane gave the main path's 4,096 lanes 32 blocks of
// 128 threads: about 100 of the 132 SMs idle and one warp per scheduler,
// with nothing to hide the chain's latency. Here the 8 threads of a lane
// (four lanes a warp, 32,768 threads in all) split the work: thread (s, k)
// undistorts corner k, forms corner k's residual, Jacobian rows and share
// of J^T J and J^T r in Gauss-Newton start s; the four corners' shares meet
// by warp shuffles (a fixed tree, so the four threads hold the same bits),
// and each thread then solves the 6x6 system itself. The two starts settle
// side by side and pick the winner with one shuffle; both halves then run
// the finish on it. The homography and Zhang init, a few hundred
// operations, are computed by all 8 threads alike.
//
// Unlike Mosaic, CUDA has atan2f, so the heading is finished here and the
// full 3x3 covariance is written; nothing is completed outside.
//
// Garbage corners (padding slots marked valid) flow through as inf/NaN and
// must end as keep = 0: every gate is a <= comparison, false for NaN, and
// the Cholesky floor uses nan_max (fmaxf would drop a NaN and could let a
// garbage lane through); a NaN in one corner reaches the whole lane through
// the shuffled sums. Built without fast-math for the same reason.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kUndistortIters = 8;

struct Params {
  float fx, fy, cx, cy;       // intrinsics
  float half;                 // marker_length / 2
  float thresh;               // useful_distance_threshold
  float rx, ry, rth;          // covariance coefficients R_x, R_y, R_theta
  float t2cx, t2cy;           // robot->camera translation
  float k1, k2, p1, p2, k3;   // Brown-Conrady distortion
};

// jnp.maximum / torch.clamp(min=): a NaN operand stays NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float wrap_angle(float a) {
  a = (a >= kPi) ? a - kTwoPi : a;
  return (a < -kPi) ? a + kTwoPi : a;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float norm3(const float* a) { return sqrtf(dot3(a, a)); }

// C = X @ Y, row-major 3x3
__device__ __forceinline__ void matmul3(const float* X, const float* Y, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = X[3 * i] * Y[j] + X[3 * i + 1] * Y[3 + j] + X[3 * i + 2] * Y[6 + j];
}

// R = I + sin(th) K + (1 - cos(th)) K^2 for the axis-angle vector w;
// I + skew(w) below theta 1e-8 (geometry.rodrigues).
__device__ void rodrigues(float w0, float w1, float w2, float* R) {
  const float theta = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
  const bool small = theta < 1e-8f;
  const float safe = small ? 1.0f : theta;
  const float kx = w0 / safe, ky = w1 / safe, kz = w2 / safe;
  const float st = sinf(theta);
  const float ct1 = 1.0f - cosf(theta);
  const float K[9] = {0.0f, -kz, ky, kz, 0.0f, -kx, -ky, kx, 0.0f};
  float KK[9];
  matmul3(K, K, KK);
  const float Rs[9] = {1.0f, -w2, w1, w2, 1.0f, -w0, -w1, w0, 1.0f};
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    R[e] = small ? Rs[e] : eye + st * K[e] + ct1 * KK[e];
  }
}

// Solve the 6x6 SPD system A x = b by unrolled Cholesky (linalg.solve_spd).
// A holds the lower triangle row-major: A[i][j] at A[i * 6 + j], j <= i.
__device__ __forceinline__ void solve_spd6(const float* A, const float* b, float* x) {
  float L[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = (i == j) ? sqrtf(nan_max(s, 1e-30f)) : s / L[j * 6 + j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * y[k];
    y[i] = s / L[i * 6 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * x[k];
    x[i] = s / L[i * 6 + i];
  }
}


// The sum over the 4 corner threads of one start (lanes xor 1, 2), the
// same bits in all four.
__device__ __forceinline__ float corner_sum(float v, unsigned mask) {
  v += __shfl_xor_sync(mask, v, 1);
  v += __shfl_xor_sync(mask, v, 2);
  return v;
}

// Corner (X, Y, 0) under pose (R, t): its camera point pc[3] and its
// normalized reprojection residual (r0, r1) against (xk, yk).
__device__ __forceinline__ void corner_residual(const float* R, const float* t, float X, float Y,
                                                float xk, float yk, float* pc, float& r0,
                                                float& r1) {
  pc[0] = R[0] * X + R[1] * Y + t[0];
  pc[1] = R[3] * X + R[4] * Y + t[1];
  pc[2] = R[6] * X + R[7] * Y + t[2];
  const float inv_z = 1.0f / pc[2];
  r0 = pc[0] * inv_z - xk;
  r1 = pc[1] * inv_z - yk;
}

// Gauss-Newton on one start, the calling thread holding corner (X, Y) and
// its residual (pnp._gauss_newton_refine): the rotation steps as
// R <- R exp(skew(-d[0:3])), a step is kept only if it lowers sum r^2 (ss,
// the corners' sum). Returns the final sum r^2.
__device__ float gn_refine(float* R, float* t, float& r0, float& r1, float* pc, float ss,
                           float X, float Y, float xk, float yk, int iters, unsigned mask) {
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float JtJ[36];
    float Jtr[6];
#pragma unroll
    for (int a = 0; a < 36; ++a) JtJ[a] = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) Jtr[a] = 0.0f;
    {
      const float px = pc[0], py = pc[1], pz = pc[2];
      const float inv_z = 1.0f / pz;
      const float iz2 = inv_z * inv_z;
      // M = R @ skew(X_k), X_k = (X, Y, 0)
      float Mm[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Mm[3 * i] = -Y * R[3 * i + 2];
        Mm[3 * i + 1] = X * R[3 * i + 2];
        Mm[3 * i + 2] = Y * R[3 * i] - X * R[3 * i + 1];
      }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        // d(proj)/d(pc) row: [inv_z, 0, -px iz2] or [0, inv_z, -py iz2]
        const float dw = -(row == 0 ? px : py) * iz2;
        float J[6];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          J[c] = inv_z * (-Mm[3 * row + c]) + dw * (-Mm[6 + c]);
        J[3] = row == 0 ? inv_z : 0.0f;
        J[4] = row == 0 ? 0.0f : inv_z;
        J[5] = dw;
        const float rm = row == 0 ? r0 : r1;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          Jtr[a] += J[a] * rm;
#pragma unroll
          for (int c = 0; c <= a; ++c) JtJ[a * 6 + c] += J[a] * J[c];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      Jtr[a] = corner_sum(Jtr[a], mask);
#pragma unroll
      for (int c = 0; c <= a; ++c) JtJ[a * 6 + c] = corner_sum(JtJ[a * 6 + c], mask);
      JtJ[a * 6 + a] += 1e-9f;
    }
    float d[6];
    solve_spd6(JtJ, Jtr, d);
    float dR[9], R_new[9];
    rodrigues(-d[0], -d[1], -d[2], dR);
    matmul3(R, dR, R_new);
    const float t_new[3] = {t[0] - d[3], t[1] - d[4], t[2] - d[5]};
    float pc_new[3], q0, q1;
    corner_residual(R_new, t_new, X, Y, xk, yk, pc_new, q0, q1);
    const float ss_new = corner_sum(q0 * q0 + q1 * q1, mask);
    if (ss_new < ss) {  // NaN: keep the current iterate; the same in the 4 threads
#pragma unroll
      for (int e = 0; e < 9; ++e) R[e] = R_new[e];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        t[e] = t_new[e];
        pc[e] = pc_new[e];
      }
      r0 = q0;
      r1 = q1;
      ss = ss_new;
    }
  }
  return ss;
}

constexpr int kGroup = 8;     // threads a lane: (start, corner)
constexpr int kThreads = 128;  // 16 lanes a block

__global__ void __launch_bounds__(kThreads)
pnp_frontend_kernel(const float* __restrict__ corners,  // [L, 4, 2]
                    const unsigned char* __restrict__ valid,  // [L]
                    float* __restrict__ z_out,          // [L, 3]
                    float* __restrict__ R_out,          // [L, 9]
                    unsigned char* __restrict__ keep_out,  // [L]
                    int lanes, Params p, int settle, int finish) {
  const int lane = (blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (lane >= lanes) return;  // whole groups
  const int gi = threadIdx.x % kGroup;
  const int k = gi & 3;        // the corner
  const int start = gi >> 2;   // 0: Zhang's start, 1: its planar flip
  const int wl = threadIdx.x & 31;
  const unsigned mask = 0xFFu << (wl & ~7);  // the lane's 8 threads of the warp
  const int base = wl & ~3;   // this start's corner 0
  if (!valid[lane]) {  // a padded slot, uniform in the group
    if (gi == 0) {
      z_out[lane * 3] = z_out[lane * 3 + 1] = z_out[lane * 3 + 2] = 0.0f;
#pragma unroll
      for (int e = 0; e < 9; ++e) R_out[lane * 9 + e] = (e % 4 == 0) ? 1.0f : 0.0f;
      keep_out[lane] = 0;
    }
    return;
  }

  // undistort corner k (camera.undistort_normalized): with zero
  // coefficients every step is the exact identity
  const float uk = corners[lane * 8 + 2 * k];
  const float vk = corners[lane * 8 + 2 * k + 1];
  const float xd = (uk - p.cx) / p.fx;
  const float yd = (vk - p.cy) / p.fy;
  float x = xd, y = yd;
#pragma unroll
  for (int it = 0; it < kUndistortIters; ++it) {
    const float r2 = x * x + y * y;
    const float radial = 1.0f + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3));
    const float dx = p.p1 * 2.0f * x * y + p.p2 * (r2 + 2.0f * x * x);
    const float dy = p.p2 * 2.0f * x * y + p.p1 * (r2 + 2.0f * y * y);
    x = (xd - dx) / radial;
    y = (yd - dy) / radial;
  }
  float u[4], v[4], xn[4], yn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    u[c] = __shfl_sync(mask, uk, base + c);
    v[c] = __shfl_sync(mask, vk, base + c);
    xn[c] = __shfl_sync(mask, x, base + c);
    yn[c] = __shfl_sync(mask, y, base + c);
  }
  const float h = p.half;
  const float ox[4] = {-h, h, h, -h};  // TL, TR, BR, BL (aruco_slam.h:189)
  const float oy[4] = {h, h, -h, -h};
  const float X = ox[k], Y = oy[k];
  // --- Heckbert unit-square homography, then H = Hu @ A_inv -------------
  const float sx = xn[0] - xn[1] + xn[2] - xn[3];
  const float sy = yn[0] - yn[1] + yn[2] - yn[3];
  const float dx1 = xn[1] - xn[2], dx2 = xn[3] - xn[2];
  const float dy1 = yn[1] - yn[2], dy2 = yn[3] - yn[2];
  const float inv_det = 1.0f / (dx1 * dy2 - dx2 * dy1);
  const float g = (sx * dy2 - sy * dx2) * inv_det;
  const float hh = (sy * dx1 - sx * dy1) * inv_det;
  const float Hu[9] = {xn[1] - xn[0] + g * xn[1], xn[3] - xn[0] + hh * xn[3], xn[0],
                       yn[1] - yn[0] + g * yn[1], yn[3] - yn[0] + hh * yn[3], yn[0],
                       g, hh, 1.0f};
  const float Lm = 2.0f * h;
  const float inv_L = 1.0f / Lm, h_L = h / Lm;
  float h1[3], h2[3], h3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h1[i] = Hu[3 * i] * inv_L;
    h2[i] = Hu[3 * i + 1] * (-inv_L);
    h3[i] = Hu[3 * i] * h_L + Hu[3 * i + 1] * h_L + Hu[3 * i + 2];
  }
  // --- Zhang init: scale, in front of the camera, onto SO(3) -------------
  const float lam = 2.0f / (norm3(h1) + norm3(h2));
  const float flip = (h3[2] * lam < 0.0f) ? -1.0f : 1.0f;
  float r1[3], r2[3], t0[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r1[i] = h1[i] * lam * flip;
    r2[i] = h2[i] * lam * flip;
    t0[i] = h3[i] * lam * flip;
  }
  float r1n[3], r2o[3], r1o[3], r3[3];
  const float n_r1 = norm3(r1);
#pragma unroll
  for (int i = 0; i < 3; ++i) r1n[i] = r1[i] / n_r1;
  const float d21 = dot3(r2, r1n);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2o[i] = r2[i] - d21 * 0.5f * r1n[i];
  const float d12 = dot3(r1n, r2o);
  const float n22 = dot3(r2o, r2o);
#pragma unroll
  for (int i = 0; i < 3; ++i) r1o[i] = r1n[i] - d12 * 0.5f * r2o[i] / n22;
  const float n_r1o = norm3(r1o);
#pragma unroll
  for (int i = 0; i < 3; ++i) r1o[i] = r1o[i] / n_r1o;
  const float d2o = dot3(r2o, r1o);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2o[i] = r2o[i] - d2o * r1o[i];
  const float n_r2o = norm3(r2o);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2o[i] = r2o[i] / n_r2o;
  cross3(r1o, r2o, r3);
  const float R0[9] = {r1o[0], r2o[0], r3[0], r1o[1], r2o[1], r3[1],
                       r1o[2], r2o[2], r3[2]};

  // --- planar flip: rotate by -2 theta about v x n, sin(theta) = |v x n|,
  // cos(theta) = v.n; sin(-2t) = -2 s c, 1 - cos(-2t) = 2 s^2 ----------
  const float tn = norm3(t0);
  const float vv[3] = {t0[0] / tn, t0[1] / tn, t0[2] / tn};
  const float nrm[3] = {R0[2], R0[5], R0[8]};
  float axr[3];
  cross3(vv, nrm, axr);
  const float s_ = norm3(axr);
  const float s_safe = nan_max(s_, 1e-9f);
  const float ax[3] = {axr[0] / s_safe, axr[1] / s_safe, axr[2] / s_safe};
  const float cs = dot3(vv, nrm);
  const float st = -2.0f * s_ * cs;
  const float omc = 2.0f * s_ * s_;
  const float K[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
  float KK[9], Rf[9], Rb[9];
  matmul3(K, K, KK);
#pragma unroll
  for (int e = 0; e < 9; ++e) Rf[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + st * K[e] + omc * KK[e];
  matmul3(Rf, R0, Rb);

  // --- the two starts settle side by side; the lower residual finishes --
  float R[9], t[3] = {t0[0], t0[1], t0[2]};
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = start ? Rb[e] : R0[e];
  float pc[3], q0, q1;
  corner_residual(R, t, X, Y, xn[k], yn[k], pc, q0, q1);
  float ss = corner_sum(q0 * q0 + q1 * q1, mask);
  const float res = gn_refine(R, t, q0, q1, pc, ss, X, Y, xn[k], yn[k], settle, mask);
  const float res_other = __shfl_xor_sync(mask, res, 4);
  const bool pick_b = (start ? res : res_other) < (start ? res_other : res);
  const bool mine = pick_b == (start == 1);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float o = __shfl_xor_sync(mask, R[e], 4);
    R[e] = mine ? R[e] : o;
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float o = __shfl_xor_sync(mask, t[e], 4);
    t[e] = mine ? t[e] : o;
  }
  corner_residual(R, t, X, Y, xn[k], yn[k], pc, q0, q1);
  ss = corner_sum(q0 * q0 + q1 * q1, mask);
  gn_refine(R, t, q0, q1, pc, ss, X, Y, xn[k], yn[k], finish, mask);

  // --- observation, covariance, gates (ops.frontend) --------------------
  // mean-squared pixel error through the full distorted pinhole
  // (src/aruco_slam.cpp:460-465)
  float e2;
  {
    const float inv_z = 1.0f / pc[2];
    const float x_p = pc[0] * inv_z;
    const float y_p = pc[1] * inv_z;
    const float r2 = x_p * x_p + y_p * y_p;
    const float radial = 1.0f + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3));
    const float xy2 = 2.0f * x_p * y_p;
    const float x_dst = x_p * radial + p.p1 * xy2 + p.p2 * (r2 + 2.0f * x_p * x_p);
    const float y_dst = y_p * radial + p.p2 * xy2 + p.p1 * (r2 + 2.0f * y_p * y_p);
    const float du = p.fx * x_dst + p.cx - uk;
    const float dv = p.fy * y_dst + p.cy - vk;
    e2 = du * du + dv * dv;
  }
  const float rms = corner_sum(e2, mask) * 0.25f;
  if (gi != 0) return;
  const float ddu = u[0] - u[2], ddv = v[0] - v[2];
  const float diag_px = sqrtf(ddu * ddu + ddv * ddv);
  const float tnorm = norm3(t);
  const float obj_err = (rms / diag_px) * (tnorm / Lm);
  const float d0 = obj_err * p.rx + 1e-2f;
  const float d1 = obj_err * p.ry + 1e-2f;
  const float d2 = obj_err * p.rth + 1e-3f;
  const float cov_norm = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);

  z_out[lane * 3] = t[2] + p.t2cx;
  z_out[lane * 3 + 1] = -t[0] + p.t2cy;
  z_out[lane * 3 + 2] = wrap_angle(atan2f(-R[2], R[8]));
  float* Ro = R_out + lane * 9;
  Ro[0] = d0; Ro[1] = 0.0f; Ro[2] = 0.0f;
  Ro[3] = 0.0f; Ro[4] = d1; Ro[5] = 0.0f;
  Ro[6] = 0.0f; Ro[7] = 0.0f; Ro[8] = d2;
  keep_out[lane] = (tnorm <= p.thresh) && (cov_norm <= 1.0f);  // NaN -> 0
}

}  // namespace

extern "C" int pnp_frontend_launch(const float* corners, const unsigned char* valid, float* z,
                                   float* R9, unsigned char* keep, int lanes,
                                   float fx, float fy, float cx, float cy,
                                   float half, float thresh,
                                   float rx, float ry, float rth,
                                   float t2cx, float t2cy,
                                   float k1, float k2, float p1, float p2, float k3,
                                   int settle, int finish, void* stream) {
  if (lanes <= 0) return 0;
  const Params p{fx, fy, cx, cy, half, thresh, rx, ry, rth, t2cx, t2cy,
                 k1, k2, p1, p2, k3};
  const long long threads = (long long)lanes * kGroup;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  pnp_frontend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, valid, z, R9, keep, lanes, p, settle, finish);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pnp_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
