// K3-K5s: adaptive threshold, 3x3 closing and connected-component
// labelling of a chunk of frames, in two bodies chosen by the frame's shape
// alone (ops/kernels/ccl.py): a thread-block cluster per frame where the
// frame's labels fit the cluster's shared memory (every frame of the
// detector's 480x640 bucket), else one thread block per frame with the
// working images in device memory.
//
// Replaces the Pallas kernels of aruco_slam_tpu/ops/kernels/ccl.py:
//   K3  _threshold_ccl_union_kernel  threshold -> close -> CCL(raw) ->
//                                    CCL(closed, seeded with the raw labels)
//   K4  _threshold_ccl_kernel        threshold -> CCL
//   K5  _ccl_kernel                  CCL of a given mask
//   K5s _ccl_seeded_kernel           CCL of a given mask, seeded with init
// as compile-time variants of each body, <kThreshold, kUnion, kSeeded>,
// each with a C entry point below. Each computes what the Pallas body
// computes, bit for bit:
//   - threshold: s x s block sums (rows of each block column, then across
//     the columns), block mean = sum * (1 / s^2) for a power-of-two s, a
//     (2r+1)^2 window over the block grid clamped to its edge (columns, then
//     rows, each in index order), one IEEE division by (2r+1)^2,
//     nearest-upsample, fg = x < mean - C. For an integer-valued image every
//     sum is exact in float32; no fast-math (ops/kernels/_build.py), so the
//     division is IEEE.
//   - close: dilation reads out-of-image pixels as background, erosion as
//     foreground.
//   - CCL: per round a Jacobi 8-neighbour min (every pixel reads the
//     pre-step labels, as jnp.roll does), then segmented min run scans
//     along rows forward and backward, then along columns forward and
//     backward. Background pixels are segment boundaries and keep their own
//     flat index. Integer min is exact and associative, so any scan order
//     and any split of a scan gives these bits.
//
// What bounds it on Hopper: not bytes (an image in, masks and labels out,
// about 11 bytes a pixel: 0.1 ms for 128 frames at 480x640) but the ~25
// dependent passes over a frame's 1.2 MB label image, each ended by a
// barrier.
//
// The cluster body: one frame per cluster of 8 CTAs (1024 threads each);
// CTA r owns a band of h / 8 whole rows, and the band's labels (int32), its
// raw, dilated and closed masks (one bit a pixel) and, while the threshold
// runs, its block-mean cells stay in the CTA's shared memory for the whole
// frame. Only the image is read from device memory, and only the outputs
// are written to it. Across bands:
//   - the threshold's vertical window and the 3x3 closing read the peers'
//     cells and mask rows through distributed shared memory after a
//     hardware cluster barrier;
//   - the Jacobi step reads the neighbouring bands' edge rows, which each
//     CTA exports before the barrier that ends a round; inside a band it
//     runs in place, chunk by chunk, through a chunk buffer and a saved copy
//     of the last pre-step row of the chunk above;
//   - the row scans (forward then backward: each horizontal run's minimum)
//     stay inside a CTA: a warp per row, a contiguous segment per lane,
//     joined across lanes by segmented scans over the lanes;
//   - the column scans (each vertical run's minimum) run within the band;
//     a run that crosses band edges is then joined from the peers' top-
//     and bottom-run minima (and whether a band's column is all
//     foreground), read after one cluster barrier.
// Two cluster barriers per CCL round. The launch runs one cluster per
// frame (persistent clusters looping over frames timed no faster).
//
// The block body: one 1024-thread block per frame, the working images in
// global scratch that the wrapper allocates (a label ping buffer, the
// dilation mask and the two block-mean grids). Each CCL round makes about
// 5 passes over the label image through L2, with a __syncthreads between
// passes. It takes every frame, 1920x1080 included.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterCtas = 8;          // CTAs per frame in the cluster body
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a CTA may use
constexpr int kAllFg = 1 << 30;          // column summary flag; labels < 2^30
// The cluster body keeps a band column's mask bits in one 64-bit register
// and a lane's part of a row (w / 32 pixels) in one 32-bit register.
constexpr int kMaxBandRows = 64;
constexpr int kMaxRowPixels = 1024;
constexpr int kLoads = 4;  // label loads a thread issues before it uses them

struct Args {
  const void* img;      // [N, H, W] uint8 or float32 (threshold variants)
  int img_u8;
  uint8_t* fg;          // [N, H, W] mask: written by the threshold, else read
  int* lab;             // [N, H*W] labels of fg
  uint8_t* fg_c;        // [N, H, W] closed mask (union)
  int* lab_c;           // [N, H*W] labels of fg_c (union)
  uint8_t* dil;         // [N, H, W] dilation scratch (union, block body)
  int* tmp;             // [N, H*W] label scratch (block body)
  float* grid;          // [N, 2, (H/s)*(W/s)] block-mean scratch (threshold, block body)
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

// ===========================================================================
// The block body: one block per frame, working images in global scratch
// ===========================================================================

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

// ===========================================================================
// The cluster body: one frame per cluster, a band of rows per CTA, the
// band's working state in shared memory
// ===========================================================================

// Shared memory of a CTA, in 4-byte words from the start.
struct Layout {
  int K;  // rows per in-place Jacobi chunk
  int words;
  int lab;              // [R, w] the band's labels
  int prev;             // [w] the last pre-step row of the chunk above
  int halo_t, halo_b;   // [w] pre-step labels of the rows just outside the band
  int edge_t, edge_b;   // [w] the band's first and last label rows, for the peers
  int sum_t, sum_b;     // [w] the band's top- and bottom-run minima, for the peers
  int fgb, fgcb, dilb;  // [R, w/32] raw, closed and dilated masks, a bit a pixel
  int hm_t, hm_b;       // [w/32] mask bits of the rows just outside the band
  int tmp;              // [K, w] Jacobi chunk; the threshold's 3 cell grids first
};

// The cluster body's layout for an h x w frame (block stride `stride` if
// the variant thresholds), or false where the frame does not take it: h a
// multiple of 8 with bands of at most 64 rows, w a multiple of 32 and at
// most 1024, the band a whole number of cell rows, and the whole within
// 227 KB. ops/kernels/ccl.py mirrors this arithmetic.
__host__ __device__ inline bool cluster_layout(int h, int w, int stride, int thresholds,
                                               Layout* L) {
  if (h <= 0 || w <= 0 || h % kClusterCtas != 0 || w % 32 != 0) return false;
  const int R = h / kClusterCtas, wq = w / 32;
  if (R > kMaxBandRows || w > kMaxRowPixels) return false;
  if (thresholds && (stride < 1 || R % stride != 0 || w % stride != 0)) return false;
  const long long cells = thresholds ? (long long)(R / stride) * (w / stride) : 0;
  const long long cap = kMaxSharedBytes / 4;
  long long at = 0;
  L->lab = 0;
  at += (long long)R * w;
  L->prev = static_cast<int>(at);
  at += w;
  L->halo_t = static_cast<int>(at);
  at += w;
  L->halo_b = static_cast<int>(at);
  at += w;
  L->edge_t = static_cast<int>(at);
  at += w;
  L->edge_b = static_cast<int>(at);
  at += w;
  L->sum_t = static_cast<int>(at);
  at += w;
  L->sum_b = static_cast<int>(at);
  at += w;
  L->fgb = static_cast<int>(at);
  at += (long long)R * wq;
  L->fgcb = static_cast<int>(at);
  at += (long long)R * wq;
  L->dilb = static_cast<int>(at);
  at += (long long)R * wq;
  L->hm_t = static_cast<int>(at);
  at += wq;
  L->hm_b = static_cast<int>(at);
  at += wq;
  if (at >= cap) return false;
  long long K = (cap - at) / w;
  if (K > R) K = R;
  if (K < 1) return false;
  L->tmp = static_cast<int>(at);
  at += (K * w > 3 * cells) ? K * w : 3 * cells;
  if (at > cap) return false;
  L->K = static_cast<int>(K);
  L->words = static_cast<int>(at);
  return true;
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// The same shared-memory object in the CTA of the given cluster rank.
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ int mbit(const uint32_t* row, int x) {
  return (row[x >> 5] >> (x & 31)) & 1;
}

// The n <= 32 mask bits of a row from pixel x0 on, bit j for pixel x0 + j.
__device__ __forceinline__ uint32_t lane_bits(const uint32_t* row, int x0, int n, int wq) {
  const int k = x0 >> 5;
  const uint64_t two = static_cast<uint64_t>(row[k]) |
                       (k + 1 < wq ? static_cast<uint64_t>(row[k + 1]) << 32 : 0ull);
  const uint32_t v = static_cast<uint32_t>(two >> (x0 & 31));
  return n == 32 ? v : v & ((1u << n) - 1u);
}

// A band column's mask bits, bit y for row y (rows <= 64): `word` points at
// the column's word in row 0, rows wq words apart.
__device__ __forceinline__ uint64_t column_bits(const uint32_t* word, int bit, int rows, int wq) {
  uint64_t m = 0;
  for (int y0 = 0; y0 < rows; y0 += kLoads) {
    uint32_t v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = y0 + u < rows ? word[(y0 + u) * wq] : 0u;
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      m |= static_cast<uint64_t>((v[u] >> bit) & 1u) << (y0 + u);
  }
  return m;
}

// The first `rows` bits of m in reverse order.
__device__ __forceinline__ uint64_t reverse_rows(uint64_t m, int rows) {
  return __brevll(m) >> (64 - rows);
}

// One direction of a segmented min scan over n labels, p[0], p[stride],
// ..., in place: foreground (bit j of m) takes the minimum of its run so
// far, starting from `carry`; background ends a run. Returns the carry at
// the end (big where the last label is background).
__device__ __forceinline__ int run_min_pass(int* p, int stride, uint64_t m, int n, int carry,
                                            int big) {
  int c = carry;
  for (int j0 = 0; j0 < n; j0 += kLoads) {
    int v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = j0 + u < n ? p[(j0 + u) * stride] : 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u;
      if (j >= n) break;
      if ((m >> j) & 1ull) {
        c = min(c, v[u]);
        p[j * stride] = c;
      } else {
        c = big;
      }
    }
  }
  return c;
}

// A row's mask word k dilated along the row (out of the row: background).
__device__ __forceinline__ uint32_t hdilate(const uint32_t* row, int k, int wq) {
  const uint32_t v = row[k];
  const uint32_t l = k > 0 ? row[k - 1] : 0u;
  const uint32_t r = k < wq - 1 ? row[k + 1] : 0u;
  return v | (v << 1) | (l >> 31) | (v >> 1) | (r << 31);
}

// A row's mask word k eroded along the row (out of the row: foreground).
__device__ __forceinline__ uint32_t herode(const uint32_t* row, int k, int wq) {
  const uint32_t v = row[k];
  const uint32_t l = k > 0 ? row[k - 1] : kFull;
  const uint32_t r = k < wq - 1 ? row[k + 1] : kFull;
  return v & ((v << 1) | (l >> 31)) & ((v >> 1) | (r << 31));
}

// One CTA's view of its frame and band.
struct Band {
  int* sm;
  Layout lay;
  int rank, h, w, wq, R, y0;
  size_t band_px;  // the band's first pixel in the chunk

  __device__ int* lab() const { return sm + lay.lab; }
  __device__ uint32_t* bits(int off) const { return reinterpret_cast<uint32_t*>(sm + off); }
  // Row yy (-1 or R: the peers' rows just outside the band) of the mask at
  // offset off, or nullptr outside the image.
  __device__ const uint32_t* mask_row(int off, int yy) const {
    const int gy = y0 + yy;
    if (gy < 0 || gy >= h) return nullptr;
    if (yy < 0) return peer(bits(off), rank - 1) + (R - 1) * wq;
    if (yy >= R) return peer(bits(off), rank + 1);
    return bits(off) + yy * wq;
  }
};

// The band's threshold into the raw mask bits and the fg output.
__device__ void cl_threshold(const Args& a, const Band& b) {
  const int s = a.stride, ws = b.w / s, Rc = b.R / s, hs = b.h / s, cy0 = b.y0 / s;
  const int cells = Rc * ws, tid = threadIdx.x;
  float* g0 = reinterpret_cast<float*>(b.sm + b.lay.tmp);  // [Rc, ws] block means
  float* g1 = g0 + cells;                                   // [Rc, ws] vertical sums
  float* gm = g1 + cells;                                   // [Rc, ws] window means
  const float inv_ss = 1.0f / static_cast<float>(s * s);    // exact: s is a power of two
  for (int c = tid; c < cells; c += kThreads) {
    const int cy = c / ws, bx = c - cy * ws;
    const size_t row0 = b.band_px + static_cast<size_t>(cy * s) * b.w + bx * s;
    float acc = 0.0f;
    for (int dx = 0; dx < s; ++dx) {
      float t = pixel(a, row0 + dx);
      for (int dy = 1; dy < s; ++dy) t += pixel(a, row0 + static_cast<size_t>(dy) * b.w + dx);
      acc = dx == 0 ? t : acc + t;
    }
    g0[c] = acc * inv_ss;
  }
  cluster_sync();  // every band's block means are in
  const int r = a.r, win = 2 * r + 1;
  for (int c = tid; c < cells; c += kThreads) {
    const int cy = c / ws, bx = c - cy * ws;
    float acc = 0.0f;
    for (int k = 0; k < win; ++k) {
      const int gy = clampi(cy0 + cy - r + k, 0, hs - 1);
      const int owner = gy / Rc;
      const float* src = peer(g0, owner);
      const float v = src[(gy - owner * Rc) * ws + bx];
      acc = k == 0 ? v : acc + v;
    }
    g1[c] = acc;
  }
  __syncthreads();
  const float area = static_cast<float>(win * win);
  for (int c = tid; c < cells; c += kThreads) {
    const int cy = c / ws, bx = c - cy * ws;
    float acc = g1[cy * ws + clampi(bx - r, 0, ws - 1)];
    for (int k = 1; k < win; ++k) acc += g1[cy * ws + clampi(bx - r + k, 0, ws - 1)];
    gm[c] = acc / area;
  }
  __syncthreads();
  uint32_t* fgb = b.bits(b.lay.fgb);
  for (int e = tid; e < b.R * b.w; e += kThreads) {  // whole warps: R * w % 32 == 0
    const int y = e / b.w, x = e - y * b.w;
    const bool on = pixel(a, b.band_px + e) < gm[(y / s) * ws + x / s] - a.C;
    a.fg[b.band_px + e] = on;
    const uint32_t word = __ballot_sync(kFull, on);
    if ((threadIdx.x & 31) == 0) fgb[y * b.wq + (x >> 5)] = word;
  }
}

// The band's mask bits from a given mask in device memory.
__device__ void cl_load_mask(const uint8_t* fg, const Band& b) {
  uint32_t* fgb = b.bits(b.lay.fgb);
  for (int e = threadIdx.x; e < b.R * b.w; e += kThreads) {
    const uint32_t word = __ballot_sync(kFull, fg[b.band_px + e] != 0);
    if ((threadIdx.x & 31) == 0) fgb[e >> 5] = word;
  }
}

// The 3x3 closing of the raw mask into the closed mask bits and output.
// Starts after a cluster barrier that follows every band's raw mask.
__device__ void cl_close(const Args& a, const Band& b) {
  uint32_t* dil = b.bits(b.lay.dilb);
  uint32_t* fgc = b.bits(b.lay.fgcb);
  for (int e = threadIdx.x; e < b.R * b.wq; e += kThreads) {
    const int y = e / b.wq, k = e - y * b.wq;
    uint32_t acc = 0u;
    for (int dy = -1; dy <= 1; ++dy) {
      const uint32_t* row = b.mask_row(b.lay.fgb, y + dy);
      if (row != nullptr) acc |= hdilate(row, k, b.wq);  // background outside
    }
    dil[e] = acc;
  }
  cluster_sync();  // every band's dilation is in
  for (int e = threadIdx.x; e < b.R * b.wq; e += kThreads) {
    const int y = e / b.wq, k = e - y * b.wq;
    uint32_t acc = kFull;
    for (int dy = -1; dy <= 1; ++dy) {
      const uint32_t* row = b.mask_row(b.lay.dilb, y + dy);
      if (row != nullptr) acc &= herode(row, k, b.wq);  // foreground outside
    }
    fgc[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < b.R * b.w; e += kThreads)
    a.fg_c[b.band_px + e] = (fgc[e >> 5] >> (e & 31)) & 1;
}

// The band's labels of the mask at offset `moff` after `rounds` rounds,
// written to out (the band's rows of an [N, H*W] label output). The
// initial labels: the flat index; seeded from device memory (`init`), min
// of it and the index on the foreground; with `from_lab`, min of the
// labels already in shared memory and the index on the foreground.
__device__ void cl_label(const Band& b, int moff, const int* init, bool from_lab, int rounds,
                         int* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = b.w, wq = b.wq, R = b.R;
  const int big = b.h * w;
  const int base = b.y0 * w;  // the band's first flat index
  int* lab = b.lab();
  int* prev = b.sm + b.lay.prev;
  int* halo_t = b.sm + b.lay.halo_t;
  int* halo_b = b.sm + b.lay.halo_b;
  int* edge_t = b.sm + b.lay.edge_t;
  int* edge_b = b.sm + b.lay.edge_b;
  int* sum_t = b.sm + b.lay.sum_t;
  int* sum_b = b.sm + b.lay.sum_b;
  int* tmp = b.sm + b.lay.tmp;
  const uint32_t* bits = b.bits(moff);
  uint32_t* hm_t = b.bits(b.lay.hm_t);
  uint32_t* hm_b = b.bits(b.lay.hm_b);

  for (int e = tid; e < R * w; e += kThreads) {
    const int p = base + e;
    const bool on = (bits[e >> 5] >> (e & 31)) & 1;
    int v = p;
    if (init != nullptr && on) v = min(init[b.band_px + e], p);
    if (from_lab && on) v = min(lab[e], p);
    lab[e] = v;
  }
  for (int k = tid; k < wq; k += kThreads) {  // the peers' mask rows beside the band
    const uint32_t* t = b.mask_row(moff, -1);
    const uint32_t* d = b.mask_row(moff, R);
    hm_t[k] = t != nullptr ? t[k] : 0u;
    hm_b[k] = d != nullptr ? d[k] : 0u;
  }
  __syncthreads();
  for (int x = tid; x < w; x += kThreads) {
    edge_t[x] = lab[x];
    edge_b[x] = lab[(R - 1) * w + x];
  }
  cluster_sync();  // initial labels, edges and masks are in everywhere

  const int S = w >> 5;  // a lane's pixels of a row in the row scans
  const int t0 = warp / wq, k0 = warp - t0 * wq;  // item `warp`'s (row, word)
  const int step_t = kWarps / wq, step_k = kWarps - step_t * wq;
  const uint32_t seg_full = S == 32 ? kFull : (1u << S) - 1u;
  const uint64_t col_full = R == 64 ? ~0ull : (1ull << R) - 1ull;
  for (int it = 0; it < rounds; ++it) {
    // ---- Jacobi 8-neighbour min, in place chunk by chunk ----
    const bool has_t = b.y0 > 0, has_b = b.y0 + R < b.h;
    if (has_t) {
      const int* src = peer(edge_b, b.rank - 1);
      for (int x = tid; x < w; x += kThreads) halo_t[x] = src[x];
    }
    if (has_b) {
      const int* src = peer(edge_t, b.rank + 1);
      for (int x = tid; x < w; x += kThreads) halo_b[x] = src[x];
    }
    __syncthreads();
    // a warp per 32-pixel word of a chunk row; a word with no foreground
    // keeps its labels and is skipped. A warp walks the items warp, warp +
    // 32, ... of a chunk, (row t, word k) stepped without a division.
    for (int c0 = 0; c0 < R; c0 += b.lay.K) {
      const int kn = min(b.lay.K, R - c0);
      int t = t0, k = k0;
      for (int item = warp; item < kn * wq; item += kWarps) {
        const int y = c0 + t, kk = k;
        k += step_k;
        t += step_t;
        if (k >= wq) {
          k -= wq;
          ++t;
        }
        const uint32_t mw = bits[y * wq + kk];
        if (mw == 0u) continue;  // uniform in the warp
        const int x = (kk << 5) + lane;
        int best = big;
        // the three rows' masked labels at x - 1, x, x + 1, every load of
        // the three issued without a branch (a row outside the image has an
        // empty mask); lane 0 and lane 31 also read one pixel past the word
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = y + dy;
          const int* lrow;
          const uint32_t* mrow;
          bool avail = true;
          if (yy < 0) {
            avail = has_t;
            lrow = halo_t;
            mrow = hm_t;
          } else if (yy >= R) {
            avail = has_b;
            lrow = halo_b;
            mrow = hm_b;
          } else {
            lrow = (yy == c0 - 1) ? prev : lab + yy * w;  // pre-step values
            mrow = bits + yy * wq;
          }
          const uint32_t mc = avail ? mrow[kk] : 0u;
          const uint32_t ml = (avail && kk > 0) ? mrow[kk - 1] : 0u;
          const uint32_t mr = (avail && kk + 1 < wq) ? mrow[kk + 1] : 0u;
          const int mid = ((mc >> lane) & 1u) ? lrow[x] : big;
          const bool edge_on = lane == 0 ? (ml >> 31) != 0u : (lane == 31 && (mr & 1u) != 0u);
          const int edge = edge_on ? lrow[lane == 0 ? x - 1 : x + 1] : big;
          const int up = __shfl_up_sync(kFull, mid, 1);
          const int down = __shfl_down_sync(kFull, mid, 1);
          best = min(best, min(mid, min(lane == 0 ? edge : up, lane == 31 ? edge : down)));
        }
        if ((mw >> lane) & 1u) tmp[(y - c0) * w + x] = best;  // with its own label
      }
      __syncthreads();
      t = t0;
      k = k0;
      for (int item = warp; item < kn * wq; item += kWarps) {
        const int y = c0 + t, kk = k;
        const bool last = t == kn - 1;
        k += step_k;
        t += step_t;
        if (k >= wq) {
          k -= wq;
          ++t;
        }
        const uint32_t mw = bits[y * wq + kk];
        if (mw == 0u) continue;  // no foreground: nothing changed, nothing is read
        const int x = (kk << 5) + lane;
        int* q = lab + y * w + x;
        if (last) prev[x] = *q;  // pre-step row for the next chunk
        if ((mw >> lane) & 1u) *q = tmp[(y - c0) * w + x];
      }
      __syncthreads();
    }
    // ---- row scans forward then backward, that is each horizontal run's
    // minimum: one warp per row, S contiguous pixels per lane, the runs
    // that cross lanes joined by segmented scans over the lanes ----
    for (int y = warp; y < R; y += kWarps) {
      int* seg = lab + y * w + lane * S;
      const uint32_t m = lane_bits(bits + y * wq, lane * S, S, wq);
      if (!__any_sync(kFull, m != 0u)) continue;  // no foreground in the row
      const bool all = m == seg_full;
      // the minima of the runs at the segment's two ends
      int c = big, first = big;
      bool open = m != 0u;
      for (int j0 = 0; j0 < S; j0 += kLoads) {
        int v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) v[u] = j0 + u < S ? seg[j0 + u] : 0;
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int j = j0 + u;
          if (j >= S) break;
          if ((m >> j) & 1u) {
            c = min(c, v[u]);
          } else {
            if (open) first = c;
            open = false;
            c = big;
          }
        }
      }
      if (open) first = c;
      // the carry into the segment from the left, and from the right (the
      // same scan over the lanes in reverse order)
      const int incl = warp_seg_min(c, all ? 0 : 1, lane, big);
      int from_l = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) from_l = big;
      const int first_rev = __shfl_sync(kFull, first, 31 - lane);
      const int all_rev = __shfl_sync(kFull, all ? 1 : 0, 31 - lane);
      const int incl_rev = warp_seg_min(first_rev, all_rev ? 0 : 1, lane, big);
      int from_r = __shfl_sync(kFull, incl_rev, (30 - lane) & 31);
      if (lane == 31) from_r = big;
      if (m != 0u) {
        run_min_pass(seg, 1, m, S, from_l, big);
        run_min_pass(seg + S - 1, -1, __brev(m) >> (32 - S), S, from_r, big);
      }
    }
    __syncthreads();
    // ---- column scans forward then backward, that is each vertical run's
    // minimum: within the band, then the runs that cross band edges joined
    // from the peers' top- and bottom-run minima ----
    for (int x = tid; x < w; x += kThreads) {
      const uint64_t m = column_bits(bits + (x >> 5), x & 31, R, wq);
      if (m == 0ull) {  // no foreground in the band's column
        sum_b[x] = big;
        sum_t[x] = big;
        continue;
      }
      const bool all = m == col_full;
      // prefix minima down the runs, then the runs' minima up them
      const int bot = run_min_pass(lab + x, w, m, R, big, big);
      const int top = run_min_pass(lab + (R - 1) * w + x, -w, reverse_rows(m, R), R, big, big);
      sum_b[x] = bot | (all ? kAllFg : 0);  // the bottom run's minimum (big: background)
      sum_t[x] = top | (all ? kAllFg : 0);  // the top run's minimum
    }
    cluster_sync();  // every band's run summaries are in
    for (int x = tid; x < w; x += kThreads) {
      int above[kClusterCtas], below[kClusterCtas];
#pragma unroll
      for (int k = 0; k < kClusterCtas; ++k) {
        above[k] = k < b.rank ? peer(sum_b, k)[x] : 0;
        below[k] = k > b.rank ? peer(sum_t, k)[x] : 0;
      }
      // the run entering from above: the next band up's bottom run, and on
      // through every band whose column is all foreground; likewise below
      int up = big, dn = big;
      bool go = true;
#pragma unroll
      for (int k = kClusterCtas - 1; k >= 0; --k) {
        if (k < b.rank && go) {
          up = min(up, above[k] & ~kAllFg);
          go = (above[k] & kAllFg) != 0;
        }
      }
      go = true;
#pragma unroll
      for (int k = 0; k < kClusterCtas; ++k) {
        if (k > b.rank && go) {
          dn = min(dn, below[k] & ~kAllFg);
          go = (below[k] & kAllFg) != 0;
        }
      }
      if (up < big || dn < big) {  // a run crosses the band's edge
        const uint64_t m = column_bits(bits + (x >> 5), x & 31, R, wq);
        const int n_top = m == col_full ? R : __ffsll(static_cast<long long>(~m)) - 1;
        const int n_bot = m == col_full ? R : __clzll(static_cast<long long>(~(m << (64 - R))));
        for (int y = 0; y < n_top; ++y) lab[y * w + x] = min(lab[y * w + x], up);
        for (int y = R - n_bot; y < R; ++y) lab[y * w + x] = min(lab[y * w + x], dn);
      }
      edge_t[x] = lab[x];
      edge_b[x] = lab[(R - 1) * w + x];
    }
    if (it + 1 < rounds) cluster_sync();  // every band's edges are in
  }
  __syncthreads();
  for (int e = tid; e < R * w; e += kThreads) out[b.band_px + e] = lab[e];
}

template <bool kThreshold, bool kUnion, bool kSeeded>
__global__ void __launch_bounds__(kThreads, 1) ccl_cluster_kernel(Args a, Layout lay) {
  extern __shared__ int sm[];
  Band b{sm, lay, 0, a.h, a.w, a.w / 32, a.h / kClusterCtas, 0, 0};
  b.rank = static_cast<int>(cg::this_cluster().block_rank());
  b.y0 = b.rank * b.R;
  // a cluster per frame: frame blockIdx.y
  b.band_px = (static_cast<size_t>(blockIdx.y) * a.h + b.y0) * a.w;
  if (kThreshold)
    cl_threshold(a, b);
  else
    cl_load_mask(a.fg, b);
  cluster_sync();  // every band's raw mask is in
  if (kUnion) {
    cl_close(a, b);
    cl_label(b, lay.fgb, nullptr, false, a.rounds, a.lab);
    cl_label(b, lay.fgcb, nullptr, true, a.closed_rounds, a.lab_c);
  } else {
    cl_label(b, lay.fgb, kSeeded ? a.init : nullptr, false, a.rounds, a.lab);
  }
  cluster_sync();  // no CTA leaves while a peer still reads its shared memory
}

// ===========================================================================
// Launches
// ===========================================================================

template <bool kThreshold, bool kUnion, bool kSeeded>
int cluster_plan(int h, int w, int stride, int* smem_bytes, int* max_clusters) {
  Layout lay;
  if (!cluster_layout(h, w, stride, kThreshold ? 1 : 0, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = ccl_cluster_kernel<kThreshold, kUnion, kSeeded>;
  const int bytes = lay.words * 4;
  // the most any shape needs, so that plans cached for other shapes stay valid
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(kClusterCtas);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(bytes);
  lc.attrs = attr;
  lc.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(max_clusters, kern, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = bytes;
  return 0;
}

// body 0: a block per frame; body 1: the cluster body, a cluster per frame.
template <bool kThreshold, bool kUnion, bool kSeeded>
int launch(const Args& a, int n_frames, int body, void* stream) {
  if (n_frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    ccl_kernel<kThreshold, kUnion, kSeeded><<<n_frames, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  Layout lay;
  if (!cluster_layout(a.h, a.w, a.stride, kThreshold ? 1 : 0, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(kClusterCtas, n_frames);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(lay.words) * 4;
  lc.stream = s;
  lc.attrs = attr;
  lc.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&lc, ccl_cluster_kernel<kThreshold, kUnion, kSeeded>, a, lay);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// The cluster body's shared bytes for a variant (0 K3, 1 K4, 2 K5, 3 K5s)
// at h x w, and how many of its clusters the card holds at once. Sets the
// kernel's shared-memory attribute.
extern "C" int ccl_cluster_plan(int variant, int h, int w, int stride, int* smem_bytes,
                                int* max_clusters) {
  switch (variant) {
    case 0: return cluster_plan<true, true, false>(h, w, stride, smem_bytes, max_clusters);
    case 1: return cluster_plan<true, false, false>(h, w, stride, smem_bytes, max_clusters);
    case 2: return cluster_plan<false, false, false>(h, w, stride, smem_bytes, max_clusters);
    case 3: return cluster_plan<false, false, true>(h, w, stride, smem_bytes, max_clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 (the block body alone reads dil, tmp and grid)
extern "C" int ccl_threshold_union_launch(const void* img, int img_u8, uint8_t* fg, int* lab,
                                          uint8_t* fg_c, int* lab_c, uint8_t* dil, int* tmp,
                                          float* grid, int n, int h, int w, int stride, int r,
                                          float C, int rounds, int closed_rounds, int body,
                                          void* stream) {
  return launch<true, true, false>(
      threshold_args(img, img_u8, fg, lab, fg_c, lab_c, dil, tmp, grid, h, w, stride, r, C,
                     rounds, closed_rounds),
      n, body, stream);
}

// K4 (fg_c, lab_c and dil are unused)
extern "C" int ccl_threshold_launch(const void* img, int img_u8, uint8_t* fg, int* lab,
                                    uint8_t* fg_c, int* lab_c, uint8_t* dil, int* tmp,
                                    float* grid, int n, int h, int w, int stride, int r,
                                    float C, int rounds, int closed_rounds, int body,
                                    void* stream) {
  return launch<true, false, false>(
      threshold_args(img, img_u8, fg, lab, fg_c, lab_c, dil, tmp, grid, h, w, stride, r, C,
                     rounds, closed_rounds),
      n, body, stream);
}

// K5 (init is unused)
extern "C" int ccl_label_launch(const uint8_t* fg, const int* init, int* lab, int* tmp, int n,
                                int h, int w, int rounds, int body, void* stream) {
  return launch<false, false, false>(label_args(fg, init, lab, tmp, h, w, rounds), n, body,
                                     stream);
}

// K5s
extern "C" int ccl_label_seeded_launch(const uint8_t* fg, const int* init, int* lab, int* tmp,
                                       int n, int h, int w, int rounds, int body,
                                       void* stream) {
  return launch<false, false, true>(label_args(fg, init, lab, tmp, h, w, rounds), n, body,
                                    stream);
}

extern "C" const char* ccl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
