// K3-K5s: adaptive threshold, 3x3 closing and connected-component
// labelling of a chunk of frames, in two bodies chosen by the frame's shape
// alone (ops/kernels/ccl.py): a thread-block cluster per frame where the
// frame's labels fit the cluster's shared memory (every frame of the
// detector's 480x640 bucket), else the block body, which cuts each frame
// into tiles and spreads them over the card's SMs.
//
// Replaces the Pallas kernels of aruco_slam_tpu/ops/kernels/ccl.py:
//   K3  _threshold_ccl_union_kernel  threshold -> close -> CCL(raw) ->
//                                    CCL(closed, seeded with the raw labels)
//   K4  _threshold_ccl_kernel        threshold -> CCL
//   K5  _ccl_kernel                  CCL of a given mask
//   K5s _ccl_seeded_kernel           CCL of a given mask, seeded with init
// and the probe benchmarks/_ccl_fixed_probe.py:49 thr_only_kernel (P1a):
// the threshold stage alone, fg written as int32 (K4 with its labelling
// compiled out, so that its time is the stage's share of K4's), as
// compile-time variants of each body, <kThreshold, kUnion, kSeeded,
// kLabels>, each with a C entry point below. Each computes what the Pallas
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
//   - CCL: per round a Jacobi 8-neighbour min (every pixel reads the
//     pre-step labels, as jnp.roll does), then segmented min run scans
//     along rows forward and backward, then along columns forward and
//     backward. Background pixels are segment boundaries and keep their own
//     flat index. Integer min is exact and associative, so any scan order
//     and any split of a scan gives these bits.
//
// What bounds it on Hopper: not bytes (an image in, masks and labels out,
// about 11 bytes a pixel: 0.1 ms for 128 frames at 480x640) but the ~25
// dependent passes over a frame's label image, each ended by a barrier.
// Both bodies keep a frame's labels and masks on chip between the passes.
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
// The block body (every other frame: 1280x720, 1920x1080, any h and w): a
// frame is cut into tiles of at most 64 rows by at most 2048 pixels, one
// CTA a tile, and the tiles of a frame form a team of CTAs that meets at a
// hand-written barrier in device memory. A cooperative launch holds every
// CTA on the card at once: as many teams as fit on its SMs, each looping
// over the chunk's frames (the plan, ops/kernels/ccl.py block_plan, picks
// the tile height that fills the card). A 1080p frame alone runs on 120
// SMs; sixteen run two at a time on 128. Where the frame's team fits the
// card, each tile's labels and its raw, dilated and closed masks (a bit a
// pixel, with a ring of the neighbours' bits) stay in its CTA's shared
// memory for the whole frame, as in the cluster body; the tiles of a
// larger frame keep the same workspace in device memory and each CTA works
// through several of them in turn. Inside a tile the Jacobi step runs in
// place, a warp sweeping each column of 32-pixel words down the tile (each
// row's horizontal 3-min formed once). Across tiles, through the team's
// exchange scratch in device memory (read through L2 with __ldcg, after a
// team barrier):
//   - the threshold's block means and vertical window sums, one grid per
//     frame computed by the whole team;
//   - the masks' rings, read from the mask bytes the neighbours wrote;
//   - the Jacobi step's halo: each tile's edge rows and columns;
//   - the row and column scans run within the tile; a run that crosses a
//     tile edge is joined from the neighbours' edge-run minima, walking on
//     through tiles whose row or column is all foreground.
// Team barriers per CCL round: two, three where a row spans several tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"

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
  int* lab;             // [N, H*W] labels of fg; the threshold alone: fg as int32
  uint8_t* fg_c;        // [N, H, W] closed mask (union)
  int* lab_c;           // [N, H*W] labels of fg_c (union)
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

// The threshold's fg output at pixel i: a byte, or, where the threshold
// runs alone (kFg32), an int32 in lab.
template <bool kFg32>
__device__ __forceinline__ void store_fg(const Args& a, size_t i, bool on) {
  if (kFg32)
    a.lab[i] = on;
  else
    a.fg[i] = on;
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
template <bool kFg32>
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
    store_fg<kFg32>(a, b.band_px + e, on);
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

template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
__global__ void __launch_bounds__(kThreads, 1) ccl_cluster_kernel(Args a, Layout lay) {
  extern __shared__ int sm[];
  Band b{sm, lay, 0, a.h, a.w, a.w / 32, a.h / kClusterCtas, 0, 0};
  b.rank = static_cast<int>(cg::this_cluster().block_rank());
  b.y0 = b.rank * b.R;
  // a cluster per frame: frame blockIdx.y
  b.band_px = (static_cast<size_t>(blockIdx.y) * a.h + b.y0) * a.w;
  if (kThreshold)
    cl_threshold<!kLabels>(a, b);
  else
    cl_load_mask(a.fg, b);
  cluster_sync();  // every band's raw mask is in
  if (!kLabels) return;  // the threshold alone: every peer read is behind the barrier
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
// The block body: a frame in tiles, a CTA a tile, a team of CTAs a frame
// ===========================================================================

// A tile's row (w / 32 pixels a lane) and column masks fit 64-bit registers.
constexpr int kMaxTileRows = 64;
constexpr int kMaxTileWidth = 2048;
// Run summaries in the exchange scratch: the run's minimum label (h * w
// where the tile's edge pixel is background), kFlag where the tile's whole
// row or column is foreground, so that the run goes on through it.
constexpr unsigned kFlag = 0x80000000u;
constexpr unsigned kVal = 0x7fffffffu;

// A tile's workspace, in 4-byte words from its start.
struct TileLayout {
  int lab;              // [TR, TW] the tile's labels
  int halo_t, halo_b;   // [TW + 2] pre-step labels of the rows just outside, x = -1 .. TW
  int halo_l, halo_r;   // [TR] pre-step labels of the columns just outside
  int fgb;              // [TR + 4, TW/32 + 2] raw mask bits, a ring of 2 rows and a word
  int fgcb, dilb;       // [TR + 2, TW/32 + 2] closed and dilated mask bits, a ring of 1
  int ends;             // [TR, TW/32, 2] pre-step labels of each word's first and last pixel
  int words;
};

// The workspace of a TR x TW tile, or false where the tile does not take
// the block body: TR <= 64, TW a multiple of 32 and at most 2048 and, in
// shared memory, within 227 KB. ops/kernels/ccl.py (block_tile_words)
// mirrors this arithmetic.
__host__ __device__ inline bool tile_layout(int TR, int TW, bool shared, TileLayout* L) {
  if (TR < 1 || TR > kMaxTileRows || TW < 32 || TW > kMaxTileWidth || TW % 32 != 0) return false;
  const long long MW = TW / 32 + 2;
  long long at = 0;
  L->lab = 0;
  at += static_cast<long long>(TR) * TW;
  L->halo_t = static_cast<int>(at);
  at += TW + 2;
  L->halo_b = static_cast<int>(at);
  at += TW + 2;
  L->halo_l = static_cast<int>(at);
  at += TR;
  L->halo_r = static_cast<int>(at);
  at += TR;
  L->fgb = static_cast<int>(at);
  at += (TR + 4) * MW;
  L->fgcb = static_cast<int>(at);
  at += (TR + 2) * MW;
  L->dilb = static_cast<int>(at);
  at += (TR + 2) * MW;
  L->ends = static_cast<int>(at);
  at += 2LL * TR * (TW / 32);
  if (shared && at > kMaxSharedBytes / 4) return false;
  L->words = static_cast<int>(at);
  return true;
}

// The launch's plan (chosen by ops/kernels/ccl.py block_plan) and buffers.
struct Grid {
  int n;                  // frames in the chunk
  int TR, TW, TX, TY;     // tile rows and width; tiles across and down a frame
  int teams, ctas;        // teams in flight; CTAs a team (its tiles, or every SM)
  int spilled;            // workspaces in device memory (work), not shared memory
  int cells;              // the threshold's block cells a frame (0: no threshold)
  long long team_words;   // a team's exchange scratch
  int* scratch;           // [teams, team_words]
  int* work;              // [TX * TY, words] (spilled)
  unsigned* bar;          // [teams, 2] barrier words, zero when the buffer is made
};

// A team's exchange scratch in device memory.
struct Xchg {
  float* g0;          // [cells] block means
  float* g1;          // [cells] vertical window sums
  int* row_edge;      // [TY, 2, w] each tile row's first (0) and last (1) label row
  int* col_edge;      // [TX, 2, h] each tile column's first (0) and last (1) label column
  unsigned* row_sum;  // [TX, 2, h] each tile row's left (0) and right (1) run summary
  unsigned* col_sum;  // [TY, 2, w] each tile column's top (0) and bottom (1) run summary
};

// The words of a team's exchange scratch; ops/kernels/ccl.py mirrors it.
__host__ __device__ inline long long team_words(int h, int w, int TX, int TY, int cells) {
  return 2LL * cells + 4LL * TY * w + 4LL * TX * h;
}

__device__ Xchg exchange(const Grid& g, int h, int w, int team) {
  int* base = g.scratch + static_cast<size_t>(team) * g.team_words;
  Xchg X;
  X.g0 = reinterpret_cast<float*>(base);
  X.g1 = X.g0 + g.cells;
  X.row_edge = base + 2 * static_cast<size_t>(g.cells);
  X.col_edge = X.row_edge + 2 * static_cast<size_t>(g.TY) * w;
  X.row_sum = reinterpret_cast<unsigned*>(X.col_edge + 2 * static_cast<size_t>(g.TX) * h);
  X.col_sum = X.row_sum + 2 * static_cast<size_t>(g.TX) * h;
  return X;
}

// One CTA's view of one tile of one frame.
struct Tile {
  int* ws;  // the workspace: shared memory, or the tile's slice of work
  TileLayout L;
  int h, w, TW, TWq, MW, TX, TY;
  int ty, tx, y0, x0;
  int rows, cols;  // the tile's rows and pixels across inside the frame
  size_t px;       // the frame's first pixel in the chunk

  __device__ int* lab() const { return ws + L.lab; }
  // the mask at offset off (hr ring rows) at row 0, word 0: rows -hr ..
  // rows + hr - 1 and words -1 .. TWq are valid, MW words a row
  __device__ uint32_t* mask(int off, int hr) const {
    return reinterpret_cast<uint32_t*>(ws + off) + hr * MW + 1;
  }
};

__device__ Tile make_tile(const Args& a, const Grid& g, int t, size_t frame, int* smem) {
  Tile T;
  tile_layout(g.TR, g.TW, !g.spilled, &T.L);
  T.h = a.h;
  T.w = a.w;
  T.TW = g.TW;
  T.TWq = g.TW >> 5;
  T.MW = T.TWq + 2;
  T.TX = g.TX;
  T.TY = g.TY;
  T.ty = t / g.TX;
  T.tx = t - T.ty * g.TX;
  T.y0 = T.ty * g.TR;
  T.x0 = T.tx * g.TW;
  T.rows = min(g.TR, a.h - T.y0);
  T.cols = min(g.TW, a.w - T.x0);
  T.px = frame * static_cast<size_t>(a.h) * a.w;
  T.ws = g.spilled ? g.work + static_cast<size_t>(t) * T.L.words : smem;
  return T;
}

// The (row, column) of a thread's elements e = threadIdx.x, + kThreads, ...
// of a row-major array `width` wide, stepped without a division.
struct Walk {
  int y, x, dy, dx, width;
  __device__ explicit Walk(int w) : width(w) {
    y = threadIdx.x / w;
    x = threadIdx.x - y * w;
    dy = kThreads / w;
    dx = kThreads - dy * w;
  }
  __device__ void next() {
    x += dx;
    y += dy;
    if (x >= width) {
      x -= width;
      ++y;
    }
  }
};

// The bits of word kk (pixels x0 + 32 kk ..) that lie inside the frame.
__device__ __forceinline__ uint32_t in_frame_bits(const Tile& T, int kk) {
  const int lo = T.x0 + kk * 32;
  const int first = max(0, -lo), end = min(32, T.w - lo);
  if (end <= first) return 0u;
  const uint32_t below_end = end == 32 ? kFull : (1u << end) - 1u;
  return below_end & ~((1u << first) - 1u);
}

// The n <= 64 mask bits of a tile row from pixel x on (bit j: pixel x + j).
__device__ __forceinline__ uint64_t row_bits64(const uint32_t* row, int x, int n, int wq) {
  const int k = x >> 5, off = x & 31;
  const uint64_t w0 = row[k];
  const uint64_t w1 = k + 1 < wq ? row[k + 1] : 0u;
  const uint64_t w2 = k + 2 < wq ? row[k + 2] : 0u;
  uint64_t v = (w0 | (w1 << 32)) >> off;
  if (off != 0) v |= w2 << (64 - off);
  return n == 64 ? v : v & ((1ull << n) - 1ull);
}

// The minimum of a run that enters the tile from its neighbours: their run
// summaries at p[0], p[step], ... (n of them, nearest first; v0 = p[0],
// loaded by the caller beside its other walks' first loads), each taken
// while the tiles before it had the whole line in foreground. After the
// first (most runs end in the next tile), kChain loads at a time: a dark
// region tens of rows tall spans several short tiles.
constexpr int kChain = 8;
__device__ __forceinline__ int chain_min(const unsigned* p, long long step, int n, unsigned v0,
                                         int big) {
  if (n <= 0) return big;
  int best = static_cast<int>(v0 & kVal);
  if (!(v0 & kFlag)) return best;
  for (int k0 = 1; k0 < n; k0 += kChain) {
    unsigned v[kChain];
#pragma unroll
    for (int u = 0; u < kChain; ++u) v[u] = k0 + u < n ? __ldcg(p + (k0 + u) * step) : 0u;
#pragma unroll
    for (int u = 0; u < kChain; ++u) {
      if (k0 + u >= n) return best;
      best = min(best, static_cast<int>(v[u] & kVal));
      if (!(v[u] & kFlag)) return best;
    }
  }
  return best;
}

// ---- the threshold, over the team ----

// Block means of every cell of the frame at px, the team's threads in turn.
__device__ void thr_block_means(const Args& a, size_t px, float* g0, int rank, int ctas) {
  const int s = a.stride, ws = a.w / s, cells = (a.h / s) * ws;
  const float inv_ss = 1.0f / static_cast<float>(s * s);  // exact: s is a power of two
  for (int c = rank * kThreads + threadIdx.x; c < cells; c += ctas * kThreads) {
    const int by = c / ws, bx = c - by * ws;
    const size_t row0 = px + static_cast<size_t>(by * s) * a.w + bx * s;
    float b = 0.0f;
    for (int dx = 0; dx < s; ++dx) {
      float t = pixel(a, row0 + dx);
      for (int dy = 1; dy < s; ++dy) t += pixel(a, row0 + static_cast<size_t>(dy) * a.w + dx);
      b = dx == 0 ? t : b + t;
    }
    g0[c] = b * inv_ss;
  }
}

// The window's vertical sums of every cell (after a team barrier).
__device__ void thr_vertical(const Args& a, const float* g0, float* g1, int rank, int ctas) {
  const int s = a.stride, ws = a.w / s, hs = a.h / s, cells = hs * ws;
  const int r = a.r, win = 2 * r + 1;
  for (int c = rank * kThreads + threadIdx.x; c < cells; c += ctas * kThreads) {
    const int by = c / ws, bx = c - by * ws;
    float acc = __ldcg(g0 + clampi(by - r, 0, hs - 1) * ws + bx);
    for (int k = 1; k < win; ++k) acc += __ldcg(g0 + clampi(by - r + k, 0, hs - 1) * ws + bx);
    g1[c] = acc;
  }
}

// The tile's threshold into its raw mask bits and the fg output (after a
// team barrier): the window means of the tile's cells from the vertical
// sums, in the workspace ahead of the masks (free until the labels start:
// (TR / s + 2) x (TW / s + 2) cells fit its (TR + 2) x TW words), then the
// pixels, kLoads a thread in flight.
template <bool kFg32>
__device__ void thr_tile(const Args& a, const Tile& T, const float* g1) {
  const int s = a.stride, ls = __ffs(s) - 1, ws = a.w / s, r = a.r, win = 2 * r + 1;
  const float area = static_cast<float>(win * win);
  const int cy0 = T.y0 >> ls, cx0 = T.x0 >> ls;
  const int nr = ((T.y0 + T.rows - 1) >> ls) - cy0 + 1;
  const int nc = ((T.x0 + T.cols - 1) >> ls) - cx0 + 1;
  float* mean = reinterpret_cast<float*>(T.ws);
  Walk q(nc);
  for (int c = threadIdx.x; c < nr * nc; c += kThreads, q.next()) {
    const float* row = g1 + (cy0 + q.y) * ws;
    const int cx = cx0 + q.x;
    float acc = 0.0f;
    for (int k0 = 0; k0 < win; k0 += kLoads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        v[u] = k0 + u < win ? __ldcg(row + clampi(cx - r + k0 + u, 0, ws - 1)) : 0.0f;
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (k0 + u < win) acc = k0 + u == 0 ? v[u] : acc + v[u];
    }
    mean[c] = acc / area;
  }
  __syncthreads();
  uint32_t* m = T.mask(T.L.fgb, 2);
  const int n = T.rows * T.TW;
  Walk p(T.TW);
  for (int e0 = 0; e0 < n; e0 += kLoads * kThreads) {
    float v[kLoads];
    Walk pu = p;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x, gx = T.x0 + pu.x;
      v[u] = e < n && gx < a.w ? pixel(a, T.px + static_cast<size_t>(T.y0 + pu.y) * a.w + gx)
                               : 0.0f;
      pu.next();
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e - (threadIdx.x & 31) >= n) break;  // whole warps: n is a multiple of 32
      const int y = p.y, x = p.x, gy = T.y0 + y, gx = T.x0 + x;
      p.next();
      bool on = false;
      if (gx < a.w) {
        on = v[u] < mean[((gy >> ls) - cy0) * nc + (gx >> ls) - cx0] - a.C;
        store_fg<kFg32>(a, T.px + static_cast<size_t>(gy) * a.w + gx, on);
      }
      const uint32_t word = __ballot_sync(kFull, on);
      if ((threadIdx.x & 31) == 0) m[y * T.MW + (x >> 5)] = word;
    }
  }
}

// The tile's raw mask bits from a given mask in device memory.
__device__ void load_mask(const uint8_t* fg, const Tile& T) {
  uint32_t* m = T.mask(T.L.fgb, 2);
  Walk p(T.TW);
  for (int e = threadIdx.x; e < T.rows * T.TW; e += kThreads, p.next()) {
    const int gx = T.x0 + p.x;
    const bool on = gx < T.w && fg[T.px + static_cast<size_t>(T.y0 + p.y) * T.w + gx] != 0;
    const uint32_t word = __ballot_sync(kFull, on);
    if ((threadIdx.x & 31) == 0) m[p.y * T.MW + (p.x >> 5)] = word;
  }
}

// The mask's ring around the tile (hr rows above and below, a word left
// and right) from the frame's mask bytes src, which other CTAs may have
// written before a team barrier: read through L2. Outside the frame: 0.
__device__ void fill_ring(const uint8_t* src, const Tile& T, uint32_t* m, int hr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ring_rows = 2 * hr * T.MW;  // items: whole ring rows, then 2 words a row
  const int items = ring_rows + 2 * T.rows;
  for (int it0 = warp * kLoads; it0 < items; it0 += kWarps * kLoads) {  // kLoads items a warp
    int yy[kLoads], kk[kLoads];
    bool on[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = it0 + u;
      if (it < ring_rows) {
        const int rr = it / T.MW;
        kk[u] = it - rr * T.MW - 1;
        yy[u] = rr < hr ? rr - hr : T.rows + rr - hr;
      } else {
        const int j = it - ring_rows;
        yy[u] = j >> 1;
        kk[u] = (j & 1) ? T.TWq : -1;
      }
      const int gy = T.y0 + yy[u], gx = T.x0 + kk[u] * 32 + lane;
      on[u] = it < items && gy >= 0 && gy < T.h && gx >= 0 && gx < T.w &&
              __ldcg(src + T.px + static_cast<size_t>(gy) * T.w + gx) != 0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (it0 + u >= items) break;  // uniform in the warp
      const uint32_t word = __ballot_sync(kFull, on[u]);
      if (lane == 0) m[yy[u] * T.MW + kk[u]] = word;
    }
  }
}

// The tile's 3x3 closing into its closed mask bits and the fg_c output,
// from the raw mask and its 2-row ring.
__device__ void close_tile(const Args& a, const Tile& T) {
  const uint32_t* f = T.mask(T.L.fgb, 2);
  uint32_t* d = T.mask(T.L.dilb, 1);
  uint32_t* c = T.mask(T.L.fgcb, 1);
  const int MW = T.MW, TWq = T.TWq;
  // the dilation over the tile and a ring of one (its bits past the ring
  // are not used); outside the frame it reads as foreground for the erosion
  for (int e = threadIdx.x; e < (T.rows + 2) * MW; e += kThreads) {
    const int yy = e / MW - 1, kk = e - (yy + 1) * MW - 1;
    const int gy = T.y0 + yy;
    uint32_t acc = kFull;
    if (gy >= 0 && gy < T.h) {
      acc = 0u;
      for (int dy = -1; dy <= 1; ++dy) {
        const uint32_t* row = f + (yy + dy) * MW;
        const uint32_t v = row[kk];
        const uint32_t l = kk > -1 ? row[kk - 1] : 0u;
        const uint32_t r = kk < TWq ? row[kk + 1] : 0u;
        acc |= v | (v << 1) | (l >> 31) | (v >> 1) | (r << 31);
      }
      acc |= ~in_frame_bits(T, kk);
    }
    d[yy * MW + kk] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T.rows * TWq; e += kThreads) {
    const int yy = e / TWq, kk = e - yy * TWq;
    uint32_t acc = kFull;
    for (int dy = -1; dy <= 1; ++dy) {
      const uint32_t* row = d + (yy + dy) * MW;
      const uint32_t v = row[kk], l = row[kk - 1], r = row[kk + 1];
      acc &= v & ((v << 1) | (l >> 31)) & ((v >> 1) | (r << 31));
    }
    c[yy * MW + kk] = acc & in_frame_bits(T, kk);
  }
  __syncthreads();
  Walk p(T.TW);
  for (int e = threadIdx.x; e < T.rows * T.TW; e += kThreads, p.next())
    if (p.x < T.cols)
      a.fg_c[T.px + static_cast<size_t>(T.y0 + p.y) * T.w + T.x0 + p.x] =
          (c[p.y * MW + (p.x >> 5)] >> (p.x & 31)) & 1u;
}

// ---- the labelling: phases of a tile, team barriers between them ----

// The tile's first and last label rows and columns, for its neighbours'
// halos (after a __syncthreads that follows the labels).
__device__ void export_edges(const Tile& T, const Xchg& X, bool rows, bool cols) {
  const int* lab = T.lab();
  if (rows) {
    int* top = X.row_edge + static_cast<size_t>(T.ty) * 2 * T.w + T.x0;
    int* bot = top + T.w;
    for (int x = threadIdx.x; x < T.cols; x += kThreads) {
      top[x] = lab[x];
      bot[x] = lab[(T.rows - 1) * T.TW + x];
    }
  }
  if (cols) {
    int* left = X.col_edge + static_cast<size_t>(T.tx) * 2 * T.h + T.y0;
    int* right = left + T.h;
    for (int y = threadIdx.x; y < T.rows; y += kThreads) {
      left[y] = lab[y * T.TW];
      right[y] = lab[y * T.TW + T.cols - 1];
    }
  }
}

// Initial labels of the mask m: the flat index; with init (seeded), min of
// it and the index on the foreground; with from_lab, min of the labels
// already in the workspace and the index on the foreground. Then the edges.
__device__ void label_init(const Tile& T, const uint32_t* m, const int* init, bool from_lab,
                           const Xchg& X) {
  int* lab = T.lab();
  Walk q(T.TW);
  for (int e = threadIdx.x; e < T.rows * T.TW; e += kThreads, q.next()) {
    const int y = q.y, x = q.x;
    const int p = (T.y0 + y) * T.w + T.x0 + x;  // past the frame's edge: background
    const bool on = (m[y * T.MW + (x >> 5)] >> (x & 31)) & 1u;
    int v = p;
    if (init != nullptr && on) v = min(init[T.px + p], p);
    if (from_lab && on) v = min(lab[e], p);
    lab[e] = v;
  }
  __syncthreads();
  export_edges(T, X, true, true);
  __syncthreads();
}

// Round phase 1: the halo from the neighbours' edges, the Jacobi step in
// place, the row scans within the tile and, where a row spans several
// tiles, the rows' edge-run summaries.
__device__ void round_rows(const Tile& T, const uint32_t* m, const Xchg& X, int big) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TW = T.TW, TWq = T.TWq, MW = T.MW, R = T.rows;
  int* lab = T.lab();
  int* halo_t = T.ws + T.L.halo_t;
  int* halo_b = T.ws + T.L.halo_b;
  int* halo_l = T.ws + T.L.halo_l;
  int* halo_r = T.ws + T.L.halo_r;
  {
    const int* up = T.ty > 0 ? X.row_edge + (static_cast<size_t>(T.ty - 1) * 2 + 1) * T.w
                              : nullptr;
    const int* dn = T.ty + 1 < T.TY ? X.row_edge + static_cast<size_t>(T.ty + 1) * 2 * T.w
                                    : nullptr;
    for (int i = tid; i < TW + 2; i += kThreads) {
      const int gx = T.x0 - 1 + i;
      const bool in = gx >= 0 && gx < T.w;
      halo_t[i] = (up != nullptr && in) ? __ldcg(up + gx) : big;
      halo_b[i] = (dn != nullptr && in) ? __ldcg(dn + gx) : big;
    }
    const int* lf = T.tx > 0 ? X.col_edge + (static_cast<size_t>(T.tx - 1) * 2 + 1) * T.h
                             : nullptr;
    const int* rt = T.tx + 1 < T.TX ? X.col_edge + static_cast<size_t>(T.tx + 1) * 2 * T.h
                                    : nullptr;
    for (int y = tid; y < R; y += kThreads) {
      halo_l[y] = lf != nullptr ? __ldcg(lf + T.y0 + y) : big;
      halo_r[y] = rt != nullptr ? __ldcg(rt + T.y0 + y) : big;
    }
  }
  __syncthreads();
  // ---- the Jacobi 8-neighbour min, in place: a warp sweeps a column of
  // 32-pixel words down the tile (columns without foreground skipped),
  // each row's horizontal 3-min of masked pre-step labels formed once and
  // kept for the two rows below. The words' first and last pixels are
  // saved first, so that a sweep reads its neighbours' pre-step labels
  // whatever they have written. ----
  int* ends = T.ws + T.L.ends;
  for (int i = tid; i < R * TWq; i += kThreads) {  // i = row * TWq + word
    ends[2 * i] = lab[32 * i];
    ends[2 * i + 1] = lab[32 * i + 31];
  }
  __syncthreads();
  for (int kk = warp; kk < TWq; kk += kWarps) {
    uint32_t any = 0u;
    for (int y = lane; y < R; y += 32) any |= m[y * MW + kk];
    if (!__any_sync(kFull, any != 0u)) continue;  // nothing in the column changes
    const int x = (kk << 5) + lane;
    int h2 = big, h1 = big;  // the 3-mins of the rows two and one above
    for (int yy = -1; yy <= R; ++yy) {
      const uint32_t* mrow = m + yy * MW;  // the ring's rows and words included
      const uint32_t mc = mrow[kk], ml = mrow[kk - 1], mr = mrow[kk + 1];
      const bool ring_row = yy < 0 || yy >= R;
      const int* lrow = yy < 0 ? halo_t + 1 : (yy >= R ? halo_b + 1 : lab + yy * TW);
      const int mid = ((mc >> lane) & 1u) ? lrow[x] : big;
      // lane 0 and lane 31 also read one pixel past the word
      int edge = big;
      if (lane == 0 && (ml >> 31) != 0u)
        edge = ring_row ? lrow[x - 1] : (kk > 0 ? ends[2 * (yy * TWq + kk) - 1] : halo_l[yy]);
      else if (lane == 31 && (mr & 1u) != 0u)
        edge = ring_row ? lrow[x + 1] : (kk + 1 < TWq ? ends[2 * (yy * TWq + kk + 1)] : halo_r[yy]);
      const int from_l = __shfl_up_sync(kFull, mid, 1);
      const int from_r = __shfl_down_sync(kFull, mid, 1);
      const int h0 = min(mid, min(lane == 0 ? edge : from_l, lane == 31 ? edge : from_r));
      const int y = yy - 1;  // its three rows are in: the new label, with its own
      if (y >= 0 && ((m[y * MW + kk] >> lane) & 1u)) lab[y * TW + x] = min(h2, min(h1, h0));
      h2 = h1;
      h1 = h0;
    }
  }
  __syncthreads();
  // ---- row scans, forward then backward (each horizontal run's minimum
  // within the tile): a warp per row, S contiguous pixels a lane, the runs
  // that cross lanes joined by segmented scans over the lanes ----
  const int S = TW >> 5;
  const uint64_t seg_full = S == 64 ? ~0ull : (1ull << S) - 1ull;
  for (int y = warp; y < R; y += kWarps) {
    int* seg = lab + y * TW + lane * S;
    const uint64_t mb = row_bits64(m + y * MW, lane * S, S, TWq);
    if (!__any_sync(kFull, mb != 0ull)) continue;  // no foreground in the row
    const bool all = mb == seg_full;
    int c = big, first = big;
    bool open = mb != 0ull;
    for (int j0 = 0; j0 < S; j0 += kLoads) {
      int v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) v[u] = j0 + u < S ? seg[j0 + u] : 0;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = j0 + u;
        if (j >= S) break;
        if ((mb >> j) & 1ull) {
          c = min(c, v[u]);
        } else {
          if (open) first = c;
          open = false;
          c = big;
        }
      }
    }
    if (open) first = c;
    const int incl = warp_seg_min(c, all ? 0 : 1, lane, big);
    int into_l = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) into_l = big;
    const int first_rev = __shfl_sync(kFull, first, 31 - lane);
    const int all_rev = __shfl_sync(kFull, all ? 1 : 0, 31 - lane);
    const int incl_rev = warp_seg_min(first_rev, all_rev ? 0 : 1, lane, big);
    int into_r = __shfl_sync(kFull, incl_rev, (30 - lane) & 31);
    if (lane == 31) into_r = big;
    if (mb != 0ull) {
      run_min_pass(seg, 1, mb, S, into_l, big);
      run_min_pass(seg + S - 1, -1, __brevll(mb) >> (64 - S), S, into_r, big);
    }
  }
  __syncthreads();
  if (T.TX > 1) {  // each row's left- and right-run minimum, for the neighbours
    unsigned* left = X.row_sum + static_cast<size_t>(T.tx) * 2 * T.h + T.y0;
    unsigned* right = left + T.h;
    for (int y = tid; y < R; y += kThreads) {
      const uint32_t* mr = m + y * MW;
      bool all = true;
      for (int k = 0; k < TWq; ++k) all = all && mr[k] == kFull;
      const unsigned f = all ? kFlag : 0u;
      left[y] = ((mr[0] & 1u) ? static_cast<unsigned>(lab[y * TW]) : static_cast<unsigned>(big)) | f;
      right[y] = ((mr[TWq - 1] >> 31) ? static_cast<unsigned>(lab[y * TW + TW - 1])
                                       : static_cast<unsigned>(big)) | f;
    }
    __syncthreads();
  }
}

// Round phase 2: where a row spans several tiles, the row runs that cross
// the tile's left or right edge joined; then the column scans within the
// tile and the columns' edge-run summaries.
__device__ void round_cols(const Tile& T, const uint32_t* m, const Xchg& X, int big) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TW = T.TW, TWq = T.TWq, MW = T.MW, R = T.rows;
  int* lab = T.lab();
  if (T.TX > 1) {
    for (int y = warp; y < R; y += kWarps) {
      const int gy = T.y0 + y;
      // the run entering from the left: the next tile's right run, and on
      // through every tile whose row is all foreground; likewise right
      const long long step = 2LL * T.h;
      const unsigned* lp = X.row_sum + (T.tx - 1) * step + T.h + gy;
      const unsigned* rp = X.row_sum + (T.tx + 1) * step + gy;
      const int n_l = T.tx, n_r = T.TX - 1 - T.tx;
      const unsigned l0 = n_l > 0 ? __ldcg(lp) : 0u, r0 = n_r > 0 ? __ldcg(rp) : 0u;
      const int left = chain_min(lp, -step, n_l, l0, big);
      const int right = chain_min(rp, step, n_r, r0, big);
      if (left == big && right == big) continue;  // uniform in the warp
      // the row's leading and trailing foreground pixels
      const uint32_t* mr = m + y * MW;
      const uint32_t w0 = lane < TWq ? mr[lane] : kFull;
      const uint32_t w1 = lane + 32 < TWq ? mr[lane + 32] : kFull;
      const unsigned gap0 = __ballot_sync(kFull, w0 != kFull);
      const unsigned gap1 = __ballot_sync(kFull, w1 != kFull);
      int n_left = TW, n_right = TW;
      if (gap0 | gap1) {
        const int jl = gap0 ? __ffs(gap0) - 1 : 32 + __ffs(gap1) - 1;
        const int jr = gap1 ? 63 - __clz(gap1) : 31 - __clz(gap0);
        n_left = jl * 32 + __ffs(~mr[jl]) - 1;
        n_right = (TWq - 1 - jr) * 32 + __clz(~mr[jr]);
      }
      int* row = lab + y * TW;
      if (left < big)
        for (int x = lane; x < n_left; x += 32) row[x] = min(row[x], left);
      __syncwarp();
      if (right < big)
        for (int x = TW - 1 - lane; x >= TW - n_right; x -= 32) row[x] = min(row[x], right);
    }
    __syncthreads();
  }
  // ---- column scans, forward then backward, within the tile: a thread a
  // column, then the columns' top- and bottom-run minima ----
  unsigned* top = X.col_sum + static_cast<size_t>(T.ty) * 2 * T.w + T.x0;
  unsigned* bot = top + T.w;
  const uint64_t col_full = R == 64 ? ~0ull : (1ull << R) - 1ull;
  for (int x = tid; x < T.cols; x += kThreads) {
    const uint64_t cm = column_bits(m + (x >> 5), x & 31, R, MW);
    unsigned t_run = big, b_run = big, f = 0u;
    if (cm != 0ull) {
      b_run = run_min_pass(lab + x, TW, cm, R, big, big);
      t_run = run_min_pass(lab + (R - 1) * TW + x, -TW, reverse_rows(cm, R), R, big, big);
      f = cm == col_full ? kFlag : 0u;
    }
    top[x] = t_run | f;
    bot[x] = b_run | f;
  }
  __syncthreads();
}

// Round phase 3: the column runs that cross the tile's top or bottom edge
// joined; then, unless it is the pass's last round, the edges exported.
__device__ void round_join(const Tile& T, const uint32_t* m, const Xchg& X, int big,
                           bool exports) {
  const int TW = T.TW, MW = T.MW, R = T.rows;
  int* lab = T.lab();
  const long long step = 2LL * T.w;
  const uint64_t col_full = R == 64 ? ~0ull : (1ull << R) - 1ull;
  int* top_e = X.row_edge + static_cast<size_t>(T.ty) * 2 * T.w + T.x0;
  int* bot_e = top_e + T.w;
  const int n_up = T.ty, n_dn = T.TY - 1 - T.ty;
  for (int x0 = threadIdx.x; x0 < T.cols; x0 += 2 * kThreads) {
    // the run entering from above: the next tile's bottom run, and on
    // through every tile whose column is all foreground; likewise below.
    // Two columns a thread, the four walks' first loads together.
    const int xs[2] = {x0, x0 + kThreads};
    const bool two = xs[1] < T.cols;
    const unsigned* up_p[2];
    const unsigned* dn_p[2];
    unsigned up0[2], dn0[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gx = T.x0 + (c == 0 || two ? xs[c] : x0);
      up_p[c] = X.col_sum + (T.ty - 1) * step + T.w + gx;
      dn_p[c] = X.col_sum + (T.ty + 1) * step + gx;
      up0[c] = n_up > 0 && (c == 0 || two) ? __ldcg(up_p[c]) : 0u;
      dn0[c] = n_dn > 0 && (c == 0 || two) ? __ldcg(dn_p[c]) : 0u;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 1 && !two) break;
      const int x = xs[c];
      const int up = chain_min(up_p[c], -step, n_up, up0[c], big);
      const int dn = chain_min(dn_p[c], step, n_dn, dn0[c], big);
      if (up < big || dn < big) {
        const uint64_t cm = column_bits(m + (x >> 5), x & 31, R, MW);
        const int n_top = cm == col_full ? R : __ffsll(static_cast<long long>(~cm)) - 1;
        const int n_bot =
            cm == col_full ? R : __clzll(static_cast<long long>(~(cm << (64 - R))));
        for (int y = 0; y < n_top; ++y) lab[y * TW + x] = min(lab[y * TW + x], up);
        for (int y = R - n_bot; y < R; ++y) lab[y * TW + x] = min(lab[y * TW + x], dn);
      }
      if (exports) {
        top_e[x] = lab[x];
        bot_e[x] = lab[(R - 1) * TW + x];
      }
    }
  }
  __syncthreads();
  if (exports) {
    export_edges(T, X, false, true);
    __syncthreads();
  }
}

// One label pass over the team's frame: the mask at workspace offset moff
// (hr ring rows; with ring_src, its ring is read from those mask bytes
// first), `rounds` rounds, the labels written to out.
__device__ void label_pass(const Args& a, const Grid& g, const Xchg& X, int* smem, size_t frame,
                           int rank, unsigned* bar, int moff, int hr, const uint8_t* ring_src,
                           const int* init, bool from_lab, int rounds, int* out) {
  const int tiles = g.TX * g.TY, big = a.h * a.w;
  for (int t = rank; t < tiles; t += g.ctas) {
    const Tile T = make_tile(a, g, t, frame, smem);
    const uint32_t* m = T.mask(moff, hr);
    if (ring_src != nullptr) {
      fill_ring(ring_src, T, T.mask(moff, hr), hr);
      __syncthreads();
    }
    label_init(T, m, init, from_lab, X);
  }
  grid_barrier(bar, g.ctas);  // initial labels and edges are in everywhere
  for (int it = 0; it < rounds; ++it) {
    for (int t = rank; t < tiles; t += g.ctas) {
      const Tile T = make_tile(a, g, t, frame, smem);
      round_rows(T, T.mask(moff, hr), X, big);
    }
    if (g.TX > 1) grid_barrier(bar, g.ctas);  // every tile's row summaries are in
    for (int t = rank; t < tiles; t += g.ctas) {
      const Tile T = make_tile(a, g, t, frame, smem);
      round_cols(T, T.mask(moff, hr), X, big);
    }
    grid_barrier(bar, g.ctas);  // every tile's column summaries are in
    for (int t = rank; t < tiles; t += g.ctas) {
      const Tile T = make_tile(a, g, t, frame, smem);
      round_join(T, T.mask(moff, hr), X, big, it + 1 < rounds);
    }
    if (it + 1 < rounds) grid_barrier(bar, g.ctas);  // every tile's edges are in
  }
  for (int t = rank; t < tiles; t += g.ctas) {
    const Tile T = make_tile(a, g, t, frame, smem);
    const int* lab = T.lab();
    Walk p(T.TW);
    for (int e = threadIdx.x; e < T.rows * T.TW; e += kThreads, p.next())
      if (p.x < T.cols) out[T.px + static_cast<size_t>(T.y0 + p.y) * T.w + T.x0 + p.x] = lab[e];
    __syncthreads();
  }
}

template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
__global__ void __launch_bounds__(kThreads, 1) ccl_block_kernel(Args a, Grid g) {
  extern __shared__ int smem[];
  const int team = blockIdx.x / g.ctas, rank = blockIdx.x - team * g.ctas;
  const int tiles = g.TX * g.TY;
  unsigned* bar = g.bar + 2 * team;
  const Xchg X = exchange(g, a.h, a.w, team);
  TileLayout L;
  tile_layout(g.TR, g.TW, !g.spilled, &L);
  for (int f = team; f < g.n; f += g.teams) {
    const size_t frame = static_cast<size_t>(f);
    const size_t px = frame * a.h * a.w;
    if (kThreshold) {
      thr_block_means(a, px, X.g0, rank, g.ctas);
      grid_barrier(bar, g.ctas);  // every cell's block mean is in
      thr_vertical(a, X.g0, X.g1, rank, g.ctas);
      grid_barrier(bar, g.ctas);  // every cell's vertical sum is in
      for (int t = rank; t < tiles; t += g.ctas) {
        thr_tile<!kLabels>(a, make_tile(a, g, t, frame, smem), X.g1);
        __syncthreads();
      }
      grid_barrier(bar, g.ctas);  // every tile's fg bytes are in
    } else {
      for (int t = rank; t < tiles; t += g.ctas) {
        load_mask(a.fg, make_tile(a, g, t, frame, smem));
        __syncthreads();
      }
    }
    if (!kLabels) continue;  // the threshold alone
    for (int t = rank; t < tiles; t += g.ctas) {
      const Tile T = make_tile(a, g, t, frame, smem);
      fill_ring(a.fg, T, T.mask(L.fgb, 2), 2);
      __syncthreads();
      if (kUnion) {
        close_tile(a, T);
        __syncthreads();
      }
    }
    if (kUnion) {
      label_pass(a, g, X, smem, frame, rank, bar, L.fgb, 2, nullptr, nullptr, false, a.rounds,
                 a.lab);
      label_pass(a, g, X, smem, frame, rank, bar, L.fgcb, 1, a.fg_c, nullptr, true,
                 a.closed_rounds, a.lab_c);
    } else {
      label_pass(a, g, X, smem, frame, rank, bar, L.fgb, 2, nullptr, kSeeded ? a.init : nullptr,
                 false, a.rounds, a.lab);
    }
  }
}

// ===========================================================================
// Launches
// ===========================================================================

template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
int cluster_plan(int h, int w, int stride, int* smem_bytes, int* max_clusters) {
  Layout lay;
  if (!cluster_layout(h, w, stride, kThreshold ? 1 : 0, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = ccl_cluster_kernel<kThreshold, kUnion, kSeeded, kLabels>;
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

// The block body's plan for the card: the kernel's shared-memory attribute
// set (the most any tile needs), and the SMs that hold one of its CTAs at
// the most shared memory: the plan puts at most one CTA on each.
template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
int block_plan(int* sms) {
  auto* kern = ccl_block_kernel<kThreshold, kUnion, kSeeded, kLabels>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) *sms = 0;
  return 0;
}

// The block body's launch: the plan's geometry checked against the frame
// and the buffers the wrapper sized (scratch_words a team, work_words in
// all), then one cooperative launch of teams x ctas CTAs.
template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
int block_launch(const Args& a, int n, int tile_rows, int tile_width, int teams, int ctas,
                 int* scratch, long long scratch_words, int* work, long long work_words,
                 unsigned* bar, cudaStream_t s) {
  Grid g;
  g.n = n;
  g.TR = tile_rows;
  g.TW = tile_width;
  g.teams = teams;
  g.ctas = ctas;
  g.spilled = work != nullptr ? 1 : 0;
  TileLayout L;
  if (a.h <= 0 || a.w <= 0 || teams < 1 || ctas < 1 || bar == nullptr || scratch == nullptr ||
      !tile_layout(tile_rows, tile_width, !g.spilled, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  g.TX = (a.w + tile_width - 1) / tile_width;
  g.TY = (a.h + tile_rows - 1) / tile_rows;
  const int tiles = g.TX * g.TY;
  // resident: a CTA a tile; spilled: one team of CTAs working through the tiles
  if (g.spilled ? (teams != 1 || work_words != static_cast<long long>(tiles) * L.words)
                : ctas != tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  g.cells = kThreshold ? (a.h / a.stride) * (a.w / a.stride) : 0;
  g.team_words = team_words(a.h, a.w, g.TX, g.TY, g.cells);
  if (scratch_words != g.team_words) return static_cast<int>(cudaErrorInvalidValue);
  g.scratch = scratch;
  g.work = work;
  g.bar = bar;
  Args args_copy = a;
  void* params[] = {&args_copy, &g};
  const size_t smem = g.spilled ? 0 : static_cast<size_t>(L.words) * 4;
  cudaError_t err =
      cudaLaunchCooperativeKernel(ccl_block_kernel<kThreshold, kUnion, kSeeded, kLabels>,
                                  dim3(teams * ctas), dim3(kThreads), params, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// body 0: the block body (geometry from the plan); body 1: the cluster
// body, a cluster per frame.
template <bool kThreshold, bool kUnion, bool kSeeded, bool kLabels>
int launch(const Args& a, int n_frames, int tile_rows, int tile_width, int teams, int ctas,
           int* scratch, long long scratch_words, int* work, long long work_words,
           unsigned* bar, int body, void* stream) {
  if (n_frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return block_launch<kThreshold, kUnion, kSeeded, kLabels>(
        a, n_frames, tile_rows, tile_width, teams, ctas, scratch, scratch_words, work, work_words,
        bar, s);
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
      cudaLaunchKernelEx(&lc, ccl_cluster_kernel<kThreshold, kUnion, kSeeded, kLabels>, a, lay);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cluster body's shared bytes for a variant (0 K3, 1 K4, 2 K5, 3 K5s, 4
// the threshold alone) at h x w, and how many of its clusters the card
// holds at once. Sets the kernel's shared-memory attribute.
extern "C" int ccl_cluster_plan(int variant, int h, int w, int stride, int* smem_bytes,
                                int* max_clusters) {
  switch (variant) {
    case 0: return cluster_plan<true, true, false, true>(h, w, stride, smem_bytes, max_clusters);
    case 1: return cluster_plan<true, false, false, true>(h, w, stride, smem_bytes, max_clusters);
    case 2: return cluster_plan<false, false, false, true>(h, w, stride, smem_bytes, max_clusters);
    case 3: return cluster_plan<false, false, true, true>(h, w, stride, smem_bytes, max_clusters);
    case 4: return cluster_plan<true, false, false, false>(h, w, stride, smem_bytes, max_clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The block body's SMs for a variant (0 when the card cannot hold one of
// its CTAs at the most shared memory). Sets the kernel's attribute.
extern "C" int ccl_block_plan(int variant, int* sms) {
  switch (variant) {
    case 0: return block_plan<true, true, false, true>(sms);
    case 1: return block_plan<true, false, false, true>(sms);
    case 2: return block_plan<false, false, false, true>(sms);
    case 3: return block_plan<false, false, true, true>(sms);
    case 4: return block_plan<true, false, false, false>(sms);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch entry points take both bodies' arguments; the cluster body
// ignores the block body's geometry and buffers (tile_rows .. bar). work
// is null where the tiles' workspaces fit shared memory.

// K3
extern "C" int ccl_threshold_union_launch(
    const void* img, int img_u8, uint8_t* fg, int* lab, uint8_t* fg_c, int* lab_c, int n, int h,
    int w, int stride, int r, float C, int rounds, int closed_rounds, int tile_rows,
    int tile_width, int teams, int ctas, int* scratch, long long scratch_words, int* work,
    long long work_words, unsigned* bar, int body, void* stream) {
  const Args a{img, img_u8, fg, lab, fg_c, lab_c, nullptr, h, w, stride, r, C, rounds,
               closed_rounds};
  return launch<true, true, false, true>(a, n, tile_rows, tile_width, teams, ctas, scratch,
                                         scratch_words, work, work_words, bar, body, stream);
}

// K4 (fg_c and lab_c are unused)
extern "C" int ccl_threshold_launch(
    const void* img, int img_u8, uint8_t* fg, int* lab, uint8_t* fg_c, int* lab_c, int n, int h,
    int w, int stride, int r, float C, int rounds, int closed_rounds, int tile_rows,
    int tile_width, int teams, int ctas, int* scratch, long long scratch_words, int* work,
    long long work_words, unsigned* bar, int body, void* stream) {
  const Args a{img, img_u8, fg, lab, fg_c, lab_c, nullptr, h, w, stride, r, C, rounds,
               closed_rounds};
  return launch<true, false, false, true>(a, n, tile_rows, tile_width, teams, ctas, scratch,
                                          scratch_words, work, work_words, bar, body, stream);
}

// K5 (init is unused)
extern "C" int ccl_label_launch(const uint8_t* fg, const int* init, int* lab, int n, int h, int w,
                                int rounds, int tile_rows, int tile_width, int teams, int ctas,
                                int* scratch, long long scratch_words, int* work,
                                long long work_words, unsigned* bar, int body, void* stream) {
  const Args a{nullptr, 0, const_cast<uint8_t*>(fg), lab, nullptr, nullptr, init, h, w, 1, 0,
               0.0f, rounds, 0};
  return launch<false, false, false, true>(a, n, tile_rows, tile_width, teams, ctas, scratch,
                                           scratch_words, work, work_words, bar, body, stream);
}

// K5s
extern "C" int ccl_label_seeded_launch(const uint8_t* fg, const int* init, int* lab, int n,
                                       int h, int w, int rounds, int tile_rows, int tile_width,
                                       int teams, int ctas, int* scratch,
                                       long long scratch_words, int* work, long long work_words,
                                       unsigned* bar, int body, void* stream) {
  const Args a{nullptr, 0, const_cast<uint8_t*>(fg), lab, nullptr, nullptr, init, h, w, 1, 0,
               0.0f, rounds, 0};
  return launch<false, false, true, true>(a, n, tile_rows, tile_width, teams, ctas, scratch,
                                          scratch_words, work, work_words, bar, body, stream);
}

// The threshold alone (P1a): fg as int32 [N, H, W]
extern "C" int ccl_threshold_only_launch(const void* img, int img_u8, int* fg, int n, int h,
                                         int w, int stride, int r, float C, int tile_rows,
                                         int tile_width, int teams, int ctas, int* scratch,
                                         long long scratch_words, int* work,
                                         long long work_words, unsigned* bar, int body,
                                         void* stream) {
  const Args a{img, img_u8, nullptr, fg, nullptr, nullptr, nullptr, h, w, stride, r, C, 0, 0};
  return launch<true, false, false, false>(a, n, tile_rows, tile_width, teams, ctas, scratch,
                                           scratch_words, work, work_words, bar, body, stream);
}

extern "C" const char* ccl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
