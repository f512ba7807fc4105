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
// as a copy can be: a thread a 16-byte vector (float4 in, float4 / int4
// out), a block of kThreads a contiguous span of the chunk, as many blocks
// as the chunk needs, as PyTorch's elementwise launch lays out its work;
// the elements past the last vector (all of them where a buffer is not
// aligned to 16 bytes) a thread each after the vectors. One launch a chunk.
// Of the loops tools/probe_copy_variants.py times on an H100 (a grid-stride
// loop of 8 blocks an SM, streaming cache hints, a TMA ring through shared
// memory), this one alone ran the scaled copy level with PyTorch's
// img * 1.0000001 (0.0276 ms on P2's 78.6 MB).
//
// The int32 of a value outside int32's range, or of NaN, differs between
// XLA, cvt.rzi and torch's CPU cast; the probes never feed one, and the
// wrapper (ops/kernels/probes.py) leaves such values outside its contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// n elements: thread t < n4 converts the 16-byte vector t (n4 = 0 where a
// buffer is not aligned to 16 bytes), thread n4 + e the element 4 n4 + e.
template <class Op>
__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ in,
                                                         typename Op::Out* __restrict__ out,
                                                         long long n, long long n4) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n4) {
    reinterpret_cast<typename Op::Out4*>(out)[t] =
        Op::four(reinterpret_cast<const float4*>(in)[t]);
  } else {
    const long long j = 3 * n4 + t;
    if (j < n) out[j] = Op::one(in[j]);
  }
}

template <class Op>
int launch(const float* in, typename Op::Out* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (in == nullptr || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long blocks = (n - 3 * n4 + kThreads - 1) / kThreads;  // n4 vectors, then elements
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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
