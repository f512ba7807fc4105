// A barrier over a group of CTAs in device memory, for kernels whose CTAs
// are all resident at once (a cooperative launch): K6's grid variant
// (ekf_frame_update.cu) over its whole grid, and the CCL block body
// (ccl.cu) over the CTAs of each frame's team.
#pragma once

// bar[0] counts arrivals and is left at 0 by the last arrival; bar[1] is a
// generation that only grows. Cleared once when the buffer is made.
__device__ inline void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;  // cannot move before this block arrives
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}
