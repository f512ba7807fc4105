// K1: the PnP front-end, one thread per (sequence, marker-slot) lane.
//
// Replaces the Pallas kernel aruco_slam_tpu/ops/kernels/pnp_frontend.py
// (_pnp_kernel, launched by pnp_frontend_batch). Per lane: pixel corners ->
// 8-step Brown-Conrady undistortion -> Heckbert unit-square homography ->
// Zhang init and the planar-flip second start -> Gauss-Newton (settle on
// both starts, the lower residual finishes; unrolled 6x6 Cholesky) ->
// robot-frame observation (x, y, heading) -> diagonal covariance from the
// mean-squared reprojection error -> range and covariance-norm gates.
//
// What bounds it on Hopper: registers and the FP32 pipe. A lane reads 32
// bytes and writes 52; everything else is straight-line float math held in
// registers (the 8x6 Jacobian is never stored: J^T J and J^T r accumulate
// row by row). One thread per lane keeps it register-resident; the design
// spends nothing on shared memory or synchronisation. __launch_bounds__(128)
// caps the block so the compiler may use up to 255 registers per thread
// without a launch failure. ptxas's register and spill count is printed by
// the build (ops/kernels/_build.py passes -Xptxas -v).
//
// Unlike Mosaic, CUDA has atan2f, so the heading is finished here and the
// full 3x3 covariance is written; nothing is completed outside.
//
// Garbage corners (padding slots) flow through as inf/NaN and must end as
// keep = 0: every gate is a <= comparison, false for NaN, and the
// Cholesky floor uses nan_max (fmaxf would drop a NaN and could let a
// garbage lane through). Built without fast-math for the same reason.

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

// Normalized reprojection residuals r[8] and camera points pc[12] of the
// four object corners (ox, oy, 0) under pose (R, t).
__device__ __forceinline__ void residual(const float* R, const float* t,
                                         const float* ox, const float* oy,
                                         const float* xn, const float* yn,
                                         float* r, float* pc) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float px = R[0] * ox[k] + R[1] * oy[k] + t[0];
    const float py = R[3] * ox[k] + R[4] * oy[k] + t[1];
    const float pz = R[6] * ox[k] + R[7] * oy[k] + t[2];
    const float inv_z = 1.0f / pz;
    r[2 * k] = px * inv_z - xn[k];
    r[2 * k + 1] = py * inv_z - yn[k];
    pc[3 * k] = px;
    pc[3 * k + 1] = py;
    pc[3 * k + 2] = pz;
  }
}

__device__ __forceinline__ float sumsq8(const float* r) {
  float s = 0.0f;
#pragma unroll
  for (int m = 0; m < 8; ++m) s += r[m] * r[m];
  return s;
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

// Gauss-Newton with the residual and camera points of the current iterate
// carried (pnp._gauss_newton_refine): the rotation steps as
// R <- R exp(skew(-d[0:3])), a step is kept only if it lowers sum r^2.
// Returns the final sum r^2.
__device__ float gn_refine(float* R, float* t, float* r, float* pc,
                           const float* ox, const float* oy,
                           const float* xn, const float* yn, int iters) {
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float JtJ[36];
    float Jtr[6];
#pragma unroll
    for (int a = 0; a < 36; ++a) JtJ[a] = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) Jtr[a] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float X = ox[k], Y = oy[k];
      const float px = pc[3 * k], py = pc[3 * k + 1], pz = pc[3 * k + 2];
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
        const float rm = r[2 * k + row];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          Jtr[a] += J[a] * rm;
#pragma unroll
          for (int c = 0; c <= a; ++c) JtJ[a * 6 + c] += J[a] * J[c];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) JtJ[a * 6 + a] += 1e-9f;
    float d[6];
    solve_spd6(JtJ, Jtr, d);
    float dR[9], R_new[9];
    rodrigues(-d[0], -d[1], -d[2], dR);
    matmul3(R, dR, R_new);
    const float t_new[3] = {t[0] - d[3], t[1] - d[4], t[2] - d[5]};
    float r_new[8], pc_new[12];
    residual(R_new, t_new, ox, oy, xn, yn, r_new, pc_new);
    if (sumsq8(r_new) < sumsq8(r)) {  // NaN: keep the current iterate
#pragma unroll
      for (int e = 0; e < 9; ++e) R[e] = R_new[e];
#pragma unroll
      for (int e = 0; e < 3; ++e) t[e] = t_new[e];
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = r_new[e];
#pragma unroll
      for (int e = 0; e < 12; ++e) pc[e] = pc_new[e];
    }
  }
  return sumsq8(r);
}

__global__ void __launch_bounds__(128)
pnp_frontend_kernel(const float* __restrict__ corners,  // [L, 4, 2]
                    float* __restrict__ z_out,          // [L, 3]
                    float* __restrict__ R_out,          // [L, 9]
                    unsigned char* __restrict__ keep_out,  // [L]
                    int lanes, Params p, int settle, int finish) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  float u[4], v[4], xn[4], yn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    u[k] = corners[lane * 8 + 2 * k];
    v[k] = corners[lane * 8 + 2 * k + 1];
    // undistort (camera.undistort_normalized): with zero coefficients
    // every step is the exact identity
    const float xd = (u[k] - p.cx) / p.fx;
    const float yd = (v[k] - p.cy) / p.fy;
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
    xn[k] = x;
    yn[k] = y;
  }
  const float h = p.half;
  const float ox[4] = {-h, h, h, -h};  // TL, TR, BR, BL (aruco_slam.h:189)
  const float oy[4] = {h, h, -h, -h};

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

  // --- dual-start settle, winner finish ---------------------------------
  float Ra[9], ta[3], r[8], pc[12];
#pragma unroll
  for (int e = 0; e < 9; ++e) Ra[e] = R0[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) ta[e] = t0[e];
  residual(Ra, ta, ox, oy, xn, yn, r, pc);
  const float res_a = gn_refine(Ra, ta, r, pc, ox, oy, xn, yn, settle);
  float tb[3] = {t0[0], t0[1], t0[2]};
  residual(Rb, tb, ox, oy, xn, yn, r, pc);
  const float res_b = gn_refine(Rb, tb, r, pc, ox, oy, xn, yn, settle);
  float R[9], t[3];
  const bool pick_b = res_b < res_a;
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = pick_b ? Rb[e] : Ra[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = pick_b ? tb[e] : ta[e];
  residual(R, t, ox, oy, xn, yn, r, pc);
  gn_refine(R, t, r, pc, ox, oy, xn, yn, finish);

  // --- observation, covariance, gates (ops.frontend) --------------------
  // mean-squared pixel error through the full distorted pinhole
  // (src/aruco_slam.cpp:460-465)
  float rms = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float inv_z = 1.0f / pc[3 * k + 2];
    const float x_p = pc[3 * k] * inv_z;
    const float y_p = pc[3 * k + 1] * inv_z;
    const float r2 = x_p * x_p + y_p * y_p;
    const float radial = 1.0f + r2 * (p.k1 + r2 * (p.k2 + r2 * p.k3));
    const float xy2 = 2.0f * x_p * y_p;
    const float x_dst = x_p * radial + p.p1 * xy2 + p.p2 * (r2 + 2.0f * x_p * x_p);
    const float y_dst = y_p * radial + p.p2 * xy2 + p.p1 * (r2 + 2.0f * y_p * y_p);
    const float du = p.fx * x_dst + p.cx - u[k];
    const float dv = p.fy * y_dst + p.cy - v[k];
    rms += du * du + dv * dv;
  }
  rms *= 0.25f;
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

extern "C" int pnp_frontend_launch(const float* corners, float* z, float* R9,
                                   unsigned char* keep, int lanes,
                                   float fx, float fy, float cx, float cy,
                                   float half, float thresh,
                                   float rx, float ry, float rth,
                                   float t2cx, float t2cy,
                                   float k1, float k2, float p1, float p2, float k3,
                                   int settle, int finish, void* stream) {
  if (lanes <= 0) return 0;
  const Params p{fx, fy, cx, cy, half, thresh, rx, ry, rth, t2cx, t2cy,
                 k1, k2, p1, p2, k3};
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  pnp_frontend_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, z, R9, keep, lanes, p, settle, finish);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pnp_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
