// K3-K5s: adaptive threshold, 3x3 closing and connected-component
// labelling of a chunk of frames, one thread block of 1024 threads per frame.
//
// Replaces the Pallas kernels of aruco_slam_tpu/ops/kernels/ccl.py:
//   K3  _threshold_ccl_union_kernel  threshold -> close -> CCL(raw) ->
//                                    CCL(closed, seeded with the raw labels)
//   K4  _threshold_ccl_kernel        threshold -> CCL
//   K5  _ccl_kernel                  CCL of a given mask
//   K5s _ccl_seeded_kernel           CCL of a given mask, seeded with init
// as compile-time variants of one body, ccl_kernel<kThreshold, kUnion,
// kSeeded>, each with a C entry point below. Each computes what the Pallas
// body computes, bit for bit:
//   - threshold: s x s block sums (rows of each block column, then across
//     the columns), block mean = sum * (1 / s^2) for a power-of-two s, a
//     (2r+1)^2 window over the block grid clamped to its edge (columns, then
//     rows, each in index order), one IEEE division by (2r+1)^2,
//     nearest-upsample, fg = x < mean - C. For an integer-valued image every
//     sum is exact in float32; no fast-math (ops/kernels/_build.py), so the
//     division is IEEE.
//   - close: dilation reads out-of-image pixels as background, erosion as
//     foreground.
//   - CCL: per round a Jacobi 8-neighbour min (reads the pre-step labels,
//     writes the other buffer, as jnp.roll does), then segmented min run
//     scans along rows forward and backward (one warp per row, a shuffle
//     scan carried across 32-wide chunks), then along columns forward and
//     backward (one thread per column walking down, coalesced across the
//     warp). Background pixels are segment boundaries and keep their own
//     flat index. Integer min is exact, so any scan order gives these bits.
//
// What bounds it on Hopper: a frame's working images do not fit in shared
// memory (a 640x480 int32 label image is 1.2 MB, a block gets 227 KB), so
// they live in global scratch that the wrapper allocates: a label ping
// buffer, the dilation mask and the two block-mean grids. Each CCL round
// makes about 5 passes over the label image, so a 3+2-round union frame
// moves roughly 25 passes x 1.2 MB through L2 (a 16-frame chunk's working
// set stays inside the 50 MB L2), plus the latency of one __syncthreads
// between passes with one block per frame. The design spends nothing on
// making that fast: a frame's labels in the distributed shared memory of a
// cluster, tiling, or a union-find that converges fully are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* img;      // [N, H, W] uint8 or float32 (threshold variants)
  int img_u8;
  uint8_t* fg;          // [N, H, W] mask: written by the threshold, else read
  int* lab;             // [N, H*W] labels of fg
  uint8_t* fg_c;        // [N, H, W] closed mask (union)
  int* lab_c;           // [N, H*W] labels of fg_c (union)
  uint8_t* dil;         // [N, H, W] dilation scratch (union)
  int* tmp;             // [N, H*W] label scratch
  float* grid;          // [N, 2, (H/s)*(W/s)] block-mean scratch (threshold)
  const int* init;      // [N, H, W] seed labels (seeded)
  int h, w, stride, r;  // frame, block stride, window radius in blocks
  float C;
  int rounds, closed_rounds;
};

__device__ __forceinline__ float pixel(const Args& a, size_t i) {
  return a.img_u8 ? static_cast<float>(static_cast<const uint8_t*>(a.img)[i])
                  : static_cast<const float*>(a.img)[i];
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// fg = img < windowed block mean - C, for one frame.
__device__ void threshold(const Args& a, size_t frame, uint8_t* fg) {
  const int h = a.h, w = a.w, s = a.stride;
  const int hs = h / s, ws = w / s, cells = hs * ws;
  const size_t px0 = frame * static_cast<size_t>(h) * w;
  float* g0 = a.grid + frame * 2 * static_cast<size_t>(cells);
  float* g1 = g0 + cells;
  const float inv_ss = 1.0f / static_cast<float>(s * s);  // exact: s is a power of two
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int by = c / ws, bx = c - by * ws;
    const size_t row0 = px0 + static_cast<size_t>(by * s) * w + bx * s;
    float b = 0.0f;
    for (int dx = 0; dx < s; ++dx) {
      float t = pixel(a, row0 + dx);
      for (int dy = 1; dy < s; ++dy) t += pixel(a, row0 + static_cast<size_t>(dy) * w + dx);
      b = dx == 0 ? t : b + t;
    }
    g0[c] = b * inv_ss;
  }
  __syncthreads();
  const int r = a.r, win = 2 * r + 1;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int by = c / ws, bx = c - by * ws;
    float acc = g0[clampi(by - r, 0, hs - 1) * ws + bx];
    for (int k = 1; k < win; ++k) acc += g0[clampi(by - r + k, 0, hs - 1) * ws + bx];
    g1[c] = acc;
  }
  __syncthreads();
  const float area = static_cast<float>(win * win);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int by = c / ws, bx = c - by * ws;
    float acc = g1[by * ws + clampi(bx - r, 0, ws - 1)];
    for (int k = 1; k < win; ++k) acc += g1[by * ws + clampi(bx - r + k, 0, ws - 1)];
    g0[c] = acc / area;
  }
  __syncthreads();
  const int n = h * w;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / w, x = p - y * w;
    const float mean = g0[(y / s) * ws + x / s];
    fg[p] = pixel(a, px0 + p) < mean - a.C;
  }
  __syncthreads();
}

// fg_c = erode(dilate(fg)), 3x3.
__device__ void close3(const uint8_t* fg, uint8_t* dil, uint8_t* fg_c, int h, int w) {
  const int n = h * w;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / w, x = p - y * w;
    uint8_t v = 0;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;  // background outside
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx >= 0 && xx < w) v |= fg[yy * w + xx];
      }
    }
    dil[p] = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / w, x = p - y * w;
    uint8_t v = 1;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;  // foreground outside
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx >= 0 && xx < w) v &= dil[yy * w + xx];
      }
    }
    fg_c[p] = v;
  }
  __syncthreads();
}

// dst = Jacobi 8-neighbour min of src over foreground.
__device__ void neighbor_min(const uint8_t* fg, const int* src, int* dst, int h, int w) {
  const int n = h * w;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int v = src[p];
    if (fg[p]) {
      const int y = p / w, x = p - y * w;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = x + dx;
          const int q = yy * w + xx;
          if (xx >= 0 && xx < w && fg[q]) v = min(v, src[q]);
        }
      }
    }
    dst[p] = v;
  }
}

// One chunk of a segmented inclusive min-scan over a warp: lane order is
// scan order; f marks a boundary (background or past the row's end).
__device__ __forceinline__ int warp_seg_min(int v, int f, int lane, int carry) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vs = __shfl_up_sync(kFull, v, d);
    const int fs = __shfl_up_sync(kFull, f, d);
    if (lane >= d) {
      if (!f) v = min(v, vs);
      f |= fs;
    }
  }
  return f ? v : min(v, carry);
}

// Row scans, forward then backward: src -> dst, one warp per row.
__device__ void row_scans(const uint8_t* fg, const int* src, int* dst, int h, int w, int big) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int y = threadIdx.x >> 5; y < h; y += nwarps) {
    const uint8_t* frow = fg + static_cast<size_t>(y) * w;
    const int* srow = src + static_cast<size_t>(y) * w;
    int* drow = dst + static_cast<size_t>(y) * w;
    int carry = big;
    for (int c0 = 0; c0 < w; c0 += 32) {
      const int x = c0 + lane;
      const bool on = x < w && frow[x];
      const int lab = x < w ? srow[x] : big;
      const int v = warp_seg_min(on ? lab : big, on ? 0 : 1, lane, carry);
      if (x < w) drow[x] = on ? v : lab;
      carry = __shfl_sync(kFull, v, 31);
    }
    __syncwarp();
    carry = big;
    for (int c0 = w - 1; c0 >= 0; c0 -= 32) {
      const int x = c0 - lane;
      const bool on = x >= 0 && frow[x];
      const int v = warp_seg_min(on ? drow[x] : big, on ? 0 : 1, lane, carry);
      if (on) drow[x] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  }
}

// Column scans, forward then backward, in place: one thread per column.
__device__ void col_scans(const uint8_t* fg, int* lab, int h, int w, int big) {
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    int carry = big;
    for (int y = 0; y < h; ++y) {
      const int p = y * w + x;
      if (fg[p]) {
        carry = min(carry, lab[p]);
        lab[p] = carry;
      } else {
        carry = big;
      }
    }
    carry = big;
    for (int y = h - 1; y >= 0; --y) {
      const int p = y * w + x;
      if (fg[p]) {
        carry = min(carry, lab[p]);
        lab[p] = carry;
      } else {
        carry = big;
      }
    }
  }
}

// Labels of fg into lab: own flat index (seeded: min(init, index) on the
// foreground), then `rounds` rounds; tmp is the Jacobi step's buffer.
__device__ void label(const uint8_t* fg, const int* init, int* lab, int* tmp,
                      int h, int w, int rounds) {
  const int n = h * w;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    lab[p] = (init != nullptr && fg[p]) ? min(init[p], p) : p;
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {
    neighbor_min(fg, lab, tmp, h, w);
    __syncthreads();
    row_scans(fg, tmp, lab, h, w, n);
    __syncthreads();
    col_scans(fg, lab, h, w, n);
    __syncthreads();
  }
}

template <bool kThreshold, bool kUnion, bool kSeeded>
__global__ void __launch_bounds__(kThreads) ccl_kernel(Args a) {
  const size_t frame = blockIdx.x;
  const size_t n = static_cast<size_t>(a.h) * a.w;
  uint8_t* fg = a.fg + frame * n;
  int* lab = a.lab + frame * n;
  int* tmp = a.tmp + frame * n;
  if (kThreshold) threshold(a, frame, fg);
  if (kUnion) {
    uint8_t* fg_c = a.fg_c + frame * n;
    close3(fg, a.dil + frame * n, fg_c, a.h, a.w);
    label(fg, nullptr, lab, tmp, a.h, a.w, a.rounds);
    label(fg_c, lab, a.lab_c + frame * n, tmp, a.h, a.w, a.closed_rounds);
  } else {
    label(fg, kSeeded ? a.init + frame * n : nullptr, lab, tmp, a.h, a.w, a.rounds);
  }
}

template <bool kThreshold, bool kUnion, bool kSeeded>
int launch(const Args& a, int n_frames, void* stream) {
  if (n_frames <= 0) return 0;
  ccl_kernel<kThreshold, kUnion, kSeeded>
      <<<n_frames, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args threshold_args(const void* img, int img_u8, uint8_t* fg, int* lab, uint8_t* fg_c,
                    int* lab_c, uint8_t* dil, int* tmp, float* grid, int h, int w,
                    int stride, int r, float C, int rounds, int closed_rounds) {
  return Args{img, img_u8, fg, lab, fg_c, lab_c, dil, tmp, grid, nullptr,
              h, w, stride, r, C, rounds, closed_rounds};
}

Args label_args(const uint8_t* fg, const int* init, int* lab, int* tmp, int h, int w,
                int rounds) {
  return Args{nullptr, 0, const_cast<uint8_t*>(fg), lab, nullptr, nullptr, nullptr, tmp,
              nullptr, init, h, w, 1, 0, 0.0f, rounds, 0};
}

}  // namespace

// K3
extern "C" int ccl_threshold_union_launch(const void* img, int img_u8, uint8_t* fg, int* lab,
                                          uint8_t* fg_c, int* lab_c, uint8_t* dil, int* tmp,
                                          float* grid, int n, int h, int w, int stride, int r,
                                          float C, int rounds, int closed_rounds,
                                          void* stream) {
  return launch<true, true, false>(
      threshold_args(img, img_u8, fg, lab, fg_c, lab_c, dil, tmp, grid, h, w, stride, r, C,
                     rounds, closed_rounds),
      n, stream);
}

// K4 (fg_c, lab_c and dil are unused)
extern "C" int ccl_threshold_launch(const void* img, int img_u8, uint8_t* fg, int* lab,
                                    uint8_t* fg_c, int* lab_c, uint8_t* dil, int* tmp,
                                    float* grid, int n, int h, int w, int stride, int r,
                                    float C, int rounds, int closed_rounds, void* stream) {
  return launch<true, false, false>(
      threshold_args(img, img_u8, fg, lab, fg_c, lab_c, dil, tmp, grid, h, w, stride, r, C,
                     rounds, closed_rounds),
      n, stream);
}

// K5 (init is unused)
extern "C" int ccl_label_launch(const uint8_t* fg, const int* init, int* lab, int* tmp, int n,
                                int h, int w, int rounds, void* stream) {
  return launch<false, false, false>(label_args(fg, init, lab, tmp, h, w, rounds), n, stream);
}

// K5s
extern "C" int ccl_label_seeded_launch(const uint8_t* fg, const int* init, int* lab, int* tmp,
                                       int n, int h, int w, int rounds, void* stream) {
  return launch<false, false, true>(label_args(fg, init, lab, tmp, h, w, rounds), n, stream);
}

extern "C" const char* ccl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
