// P1b and P2: the copy probes of the JAX package's CCL and detector studies,
// the floor under every kernel of the image path: how fast the card moves a
// chunk of frames from device memory through the SMs and back.
//
// Replaces the Pallas kernels of
//   probe_copy   benchmarks/_ccl_fixed_probe.py:68  copy_kernel  float32 -> int32
//                (astype: C truncation toward zero)
//   probe_scale  benchmarks/_det_chain_probe.py:222 kern         float32 -> float32,
//                x * 1.0000001f (the constant rounded to float32, as JAX's
//                weak-typed scalar and torch's are)
// Each function reads every input byte once and writes every output byte
// once, and does one operation an element: what bounds it on Hopper is the
// card's memory rate alone, and its time over its bytes is the card's
// achieved copy rate at the image path's shapes. So each kernel is as plain
// as a copy can be: a grid-stride loop over all N*H*W elements of the
// chunk, 16-byte loads and stores (float4 / int4), kUnroll of them in flight
// a thread before the first store, then the tail (and a buffer not aligned
// to 16 bytes) an element at a time. kBlocksPerSm blocks of kThreads on
// each SM fill its 2,048 threads. One launch a chunk.
//
// The int32 of a value outside int32's range, or of NaN, differs between
// XLA, cvt.rzi and torch's CPU cast; the probes never feed one, and the
// wrapper (ops/kernels/probes.py) leaves such values outside its contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 4;

struct ToInt32 {
  using Out = int;
  using Out4 = int4;
  __device__ static int one(float x) { return static_cast<int>(x); }  // cvt.rzi.s32.f32
  __device__ static int4 four(float4 v) {
    return make_int4(one(v.x), one(v.y), one(v.z), one(v.w));
  }
};

struct Scale {
  using Out = float;
  using Out4 = float4;
  __device__ static float one(float x) { return x * 1.0000001f; }
  __device__ static float4 four(float4 v) {
    return make_float4(one(v.x), one(v.y), one(v.z), one(v.w));
  }
};

// n elements; the first 4 * n4 as n4 16-byte vectors (n4 = 0 where a buffer
// is not aligned to 16 bytes), the rest one by one.
template <class Op>
__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ in,
                                                         typename Op::Out* __restrict__ out,
                                                         long long n, long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  auto* out4 = reinterpret_cast<typename Op::Out4*>(out);
  long long i = t0;
  for (; i + (kUnroll - 1) * step < n4; i += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = in4[i + u * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out4[i + u * step] = Op::four(v[u]);
  }
  for (; i < n4; i += step) out4[i] = Op::four(in4[i]);
  for (long long j = 4 * n4 + t0; j < n; j += step) out[j] = Op::one(in[j]);
}

template <class Op>
int launch(const float* in, typename Op::Out* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (in == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long items = n4 > 0 ? n4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  probe_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(in, out, n, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P1b: out[i] = (int) in[i] over n elements.
extern "C" int probe_copy_launch(const float* in, int* out, long long n, void* stream) {
  return launch<ToInt32>(in, out, n, stream);
}

// P2: out[i] = in[i] * 1.0000001f over n elements.
extern "C" int probe_scale_launch(const float* in, float* out, long long n, void* stream) {
  return launch<Scale>(in, out, n, stream);
}

extern "C" const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
