#!/usr/bin/env python3
"""Candidate loops for the copy probes P1b and P2 (``csrc/probes.cu``),
timed beside the one PyTorch call that computes each, on one card.

P2 (the scaled copy, x 1.0000001, on P2's 32 rendered 640x480 float32
frames: 78.6 MB read and written) and P1b (the float32 -> int32 copy on
P1's 20 frames: 49.2 MB) in each of these loops, built from this file's
own CUDA source (nvcc, sm_90a):

- ``grid``: the loop of ``probes.cu`` up to PR 13: a grid-stride loop, 8
  blocks of 256 threads an SM, 4 16-byte loads a thread in flight;
- ``grid_cs``: the same with streaming cache hints (``__ldcs`` /
  ``__stcs``: the data is touched once);
- ``span4`` / ``span1``: a block per contiguous span, as PyTorch's
  elementwise launch does, 256 threads of 4 (or 1) 16-byte loads each, as
  many blocks as the chunk needs; ``span4_cs`` with the cache hints,
  ``span1_ldcs`` / ``span1_stcs`` with the load's or the store's alone;
  ``span1_128`` / ``span2_128`` / ``span1_512``: blocks of 128 threads of
  1 or 2 loads, and of 512 threads;
- ``tma``: a persistent ring through shared memory: two CTAs an SM, each
  with 4 stages of 16 KB, one thread issuing the bulk copies in
  (``cp.async.bulk`` into shared memory, completing on an mbarrier) and
  out (``cp.async.bulk`` back to device memory), every thread converting
  the stage in place between them;
- ``library``: ``img * 1.0000001`` and ``img.to(torch.int32)``.

Every result is checked against the plain version bit for bit first. Then
WINDOWS rounds, each timing every candidate in turn (torch.profiler over
20 launches, the kernel alone: chip_smoke.py's ``_kernel_ms``). Prints
the card's name and power limit first, the median device ms of each
candidate with its GB/s and share of 3.35 TB/s, and a JSON object of every
window's times last. Needs one CUDA card and nvcc.

    python3 tools/probe_copy_variants.py [WINDOWS]   (default 5)
"""

import ctypes
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOOPS = ("grid", "grid_cs", "span4", "span4_cs", "span1", "tma", "span1_ldcs", "span1_stcs",
         "span1_128", "span2_128", "span1_512")
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct ToInt32 {
  using Out = int;
  using Out4 = int4;
  __device__ static int one(float x) { return static_cast<int>(x); }
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

// cache hints: bit 0 the load's (__ldcs), bit 1 the store's (__stcs)
template <int kHint>
__device__ __forceinline__ float4 ld(const float4* p) { return (kHint & 1) ? __ldcs(p) : *p; }
template <int kHint, class T>
__device__ __forceinline__ void st(T* p, T v) {
  if (kHint & 2) __stcs(p, v); else *p = v;
}

// grid-stride, kUnroll 16-byte loads a thread in flight
template <class Op, int kCs>
__global__ void __launch_bounds__(kThreads) p2v_grid(const float* __restrict__ in,
                                                     typename Op::Out* __restrict__ out,
                                                     long long n, long long n4) {
  constexpr int kUnroll = 4;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  auto* out4 = reinterpret_cast<typename Op::Out4*>(out);
  long long i = t0;
  for (; i + (kUnroll - 1) * step < n4; i += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld<kCs>(in4 + i + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) st<kCs>(out4 + i + u * step, Op::four(v[u]));
  }
  for (; i < n4; i += step) st<kCs>(out4 + i, Op::four(ld<kCs>(in4 + i)));
  for (long long j = 4 * n4 + t0; j < n; j += step) out[j] = Op::one(in[j]);
}

// a block of kTh threads per span of kPer * kTh 16-byte vectors
template <class Op, int kPer, int kTh, int kCs>
__global__ void __launch_bounds__(kTh) p2v_span(const float* __restrict__ in,
                                                typename Op::Out* __restrict__ out,
                                                long long n, long long n4) {
  const long long base = static_cast<long long>(blockIdx.x) * kPer * kTh + threadIdx.x;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  auto* out4 = reinterpret_cast<typename Op::Out4*>(out);
  float4 v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long i = base + u * kTh;
    if (i < n4) v[u] = ld<kCs>(in4 + i);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long i = base + u * kTh;
    if (i < n4) st<kCs>(out4 + i, Op::four(v[u]));
  }
  if (blockIdx.x == 0)
    for (long long j = 4 * n4 + threadIdx.x; j < n; j += kTh) out[j] = Op::one(in[j]);
}

// the TMA ring
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kStage4 = kStageBytes / 16;
constexpr int kTmaCtasPerSm = 2;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void load_stage(float4* dst, const float4* src, uint32_t bytes,
                                           uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n .reg .pred p;\n WAIT_%=:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               " @!p bra WAIT_%=;\n}" :: "r"(saddr(bar)), "r"(parity) : "memory");
}

template <class Op>
__global__ void __launch_bounds__(kThreads) p2v_tma(const float* __restrict__ in,
                                                    typename Op::Out* __restrict__ out,
                                                    long long n, long long n4) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const float4* in4 = reinterpret_cast<const float4*>(in);
  auto* out4 = reinterpret_cast<typename Op::Out4*>(out);
  const long long chunks = (n4 + kStage4 - 1) / kStage4;
  // this CTA's chunks: blockIdx.x + j * gridDim.x, j < mine
  const long long mine =
      blockIdx.x < chunks ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto bytes_of = [&](long long j) {
    const long long c = blockIdx.x + j * gridDim.x;
    return static_cast<uint32_t>(min(static_cast<long long>(kStage4), n4 - c * kStage4) * 16);
  };
  auto src_of = [&](long long j) { return in4 + (blockIdx.x + j * gridDim.x) * kStage4; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(saddr(full + s)), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (long long j = 0; j < kStages && j < mine; ++j)
      load_stage(ring + j * kStage4, src_of(j), bytes_of(j), full + j);
  }
  __syncthreads();
  for (long long j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % kStages);
    wait_stage(full + s, static_cast<uint32_t>((j / kStages) & 1));
    float4* st4 = ring + s * kStage4;
    auto* so4 = reinterpret_cast<typename Op::Out4*>(st4);
    const int k4 = static_cast<int>(bytes_of(j) / 16);
    for (int e = threadIdx.x; e < k4; e += kThreads) so4[e] = Op::four(st4[e]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long c = blockIdx.x + j * gridDim.x;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(out4 + c * kStage4), "r"(saddr(st4)), "r"(bytes_of(j)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the stage of chunk j - 1 is free once its store has read it: refill it
      if (j >= 1 && j - 1 + kStages < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        const int r = static_cast<int>((j - 1) % kStages);
        load_stage(ring + r * kStage4, src_of(j - 1 + kStages), bytes_of(j - 1 + kStages),
                   full + r);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long j = 4 * n4 + t0; j < n; j += static_cast<long long>(gridDim.x) * kThreads)
    out[j] = Op::one(in[j]);
}

int sms_of() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <class Op>
int launch(int loop, const float* in, typename Op::Out* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = sms_of();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  auto cap = [](long long b, long long most) {
    return static_cast<unsigned>(b < 1 ? 1 : b < most ? b : most);
  };
  auto span = [&](auto kern, long long per_block, int threads) {
    kern<<<cap((n4 + per_block - 1) / per_block, n4 + 1), threads, 0, s>>>(in, out, n, n4);
  };
  switch (loop) {
    case 0:
      p2v_grid<Op, 0><<<cap((n4 + kThreads - 1) / kThreads, 8LL * sms), kThreads, 0, s>>>(
          in, out, n, n4);
      break;
    case 1:
      p2v_grid<Op, 3><<<cap((n4 + kThreads - 1) / kThreads, 8LL * sms), kThreads, 0, s>>>(
          in, out, n, n4);
      break;
    case 2: span(p2v_span<Op, 4, 256, 0>, 1024, 256); break;
    case 3: span(p2v_span<Op, 4, 256, 3>, 1024, 256); break;
    case 4: span(p2v_span<Op, 1, 256, 0>, 256, 256); break;
    case 6: span(p2v_span<Op, 1, 256, 1>, 256, 256); break;
    case 7: span(p2v_span<Op, 1, 256, 2>, 256, 256); break;
    case 8: span(p2v_span<Op, 1, 128, 0>, 128, 128); break;
    case 9: span(p2v_span<Op, 2, 128, 0>, 256, 128); break;
    case 10: span(p2v_span<Op, 1, 512, 0>, 512, 512); break;
    case 5: {
      const int bytes = kStages * kStageBytes + kStages * 8;
      cudaError_t err =
          cudaFuncSetAttribute(p2v_tma<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long chunks = (n4 + kStage4 - 1) / kStage4;
      p2v_tma<Op><<<cap(chunks, static_cast<long long>(kTmaCtasPerSm) * sms),
                    kThreads, bytes, s>>>(in, out, n, n4);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p2v_scale(int loop, const float* in, float* out, long long n, void* stream) {
  return launch<Scale>(loop, in, out, n, stream);
}
extern "C" int p2v_copy(int loop, const float* in, int* out, long long n, void* stream) {
  return launch<ToInt32>(loop, in, out, n, stream);
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_copy_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from aruco_slam_tpu_torch.ops.kernels import _build, probes

    windows = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    card = cs._card()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "p2v.cu"
        src.write_text(SOURCE)
        report = _build._compile(src, Path(tmp) / "p2v.so")
        lib = ctypes.CDLL(str(Path(tmp) / "p2v.so"))
    print("\n".join(line for line in report.splitlines() if "registers" in line))
    P, L = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.p2v_scale, lib.p2v_copy):
        fn.argtypes = [ctypes.c_int, P, P, L, P]
        fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    frames = cs._probe_frames(dev)
    chunks = {"scale": frames["p2"], "copy": frames["p1"]}
    plain = {"scale": probes.scale_copy_reference, "copy": probes.copy_to_int32_reference}
    dtype = {"scale": torch.float32, "copy": torch.int32}
    library = {"scale": lambda img: img * 1.0000001, "copy": lambda img: img.to(torch.int32)}

    def candidate(op, loop):
        img, fn = chunks[op], getattr(lib, f"p2v_{op}")
        out = torch.empty(img.shape, dtype=dtype[op], device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            err = fn(LOOPS.index(loop), img.data_ptr(), out.data_ptr(), img.numel(), stream)
            if err:
                raise RuntimeError(f"{op} {loop}: launch failed ({err})")
            return out
        return call

    calls = {}
    for op in chunks:
        for loop in LOOPS:
            calls[f"{op}.{loop}"] = (candidate(op, loop), "p2v_")
        calls[f"{op}.library"] = (lambda op=op: library[op](chunks[op]), "")
    for name, (call, _) in calls.items():
        op = name.split(".")[0]
        got = call().clone()
        torch.cuda.synchronize()
        want = plain[op](chunks[op])
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise SystemExit(f"{name} differs from its plain version")
    print(f"every candidate bit-identical to its plain version ({len(calls)} calls)")
    times = {name: [] for name in calls}
    for _ in range(windows):
        for name, (call, part) in calls.items():
            times[name].append(cs._kernel_ms(call, part, pads=cs.PROFILE_PADS_S[:1])[0])
    out = {"card": card, "windows": windows, "ms": times, "median_ms": {}}
    for name, ts in times.items():
        op = name.split(".")[0]
        n_bytes = 8 * chunks[op].numel()
        med = statistics.median(ts)
        out["median_ms"][name] = med
        print(f"{name:16s} {med:.5f} ms (median of {windows}; {min(ts):.5f}-{max(ts):.5f}), "
              f"{cs._probe_rate(n_bytes, med)}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
