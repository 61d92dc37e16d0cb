// Section timers shared by the kernel families: thread 0 of a block charges
// the cycles since its last mark to a class of barrier phase. A timed launch
// writes, per block, kClasses cycle sums and then the whole kernel's cycles
// (clock64 of thread 0).
#pragma once

#include <cuda_runtime.h>

namespace cheeta {

#ifdef __CUDACC__

// Marks sit right after the barrier that ends a phase, so a mark's interval
// is the phase's length as the block sees it. The untimed clock is empty,
// so an untimed kernel carries no timing code.
template <bool kOn, int kClasses>
struct PhaseClock {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long*) {}
};

// The sums, the start and the last mark live in static shared memory, not
// in registers: the timed kernel then gets the registers, and spills, of
// the untimed one.
template <int kClasses>
struct PhaseClock<true, kClasses> {
  long long* acc;  // kClasses sums, then the start, then the last mark
  __device__ __forceinline__ PhaseClock() {
    __shared__ long long slots[kClasses + 2];
    acc = slots;
    if (threadIdx.x == 0) {
      const long long t = clock64();
      for (int c = 0; c < kClasses; ++c) acc[c] = 0;
      acc[kClasses] = acc[kClasses + 1] = t;
    }
  }
  __device__ __forceinline__ void mark(int cls) {
    if (threadIdx.x == 0) {
      const long long t = clock64();
      acc[cls] += t - acc[kClasses + 1];
      acc[kClasses + 1] = t;
    }
  }
  __device__ __forceinline__ void write(long long* out) {
    if (threadIdx.x == 0 && out) {
      for (int c = 0; c < kClasses; ++c) out[c] = acc[c];
      out[kClasses] = clock64() - acc[kClasses];
    }
  }
};

#endif  // __CUDACC__

}  // namespace cheeta
