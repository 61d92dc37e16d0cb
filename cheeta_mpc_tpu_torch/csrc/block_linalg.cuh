// Small dense linear algebra for one thread block: reductions, mat-vecs
// split over a few lanes per row, register-tiled products and the split of
// a block over the independent products of one phase. Shared by the
// interior-point kernels (ipm_riccati.cuh) and the equality-Riccati kernels
// (eq_riccati.cuh). Plain f32 FMA; no tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cheeta {

constexpr int kTpo = 8;  // threads that share one output row in mat-vecs

#ifdef __CUDACC__

// NaN-propagating min/max (fminf/fmaxf drop a NaN operand; the step guard
// must see it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

enum { kSum, kMin, kMax };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == kSum ? a + b : (OP == kMin ? nan_min(a, b) : nan_max(a, b));
}

// Block-wide reduction; every thread gets the same result. Starts with a
// barrier, so writes of the phase before it are visible afterwards.
template <int OP>
__device__ float block_reduce(float v, float* red) {
  const float ident = OP == kSum ? 0.f : (OP == kMin ? INFINITY : -INFINITY);
  for (int s = 16; s; s >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, s));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : ident;
  for (int s = 16; s; s >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// One thread's share of sum_l M[l * stride] * v[l].
__device__ __forceinline__ float pdot(const float* M, int stride,
                                      const float* v, int n, int sub) {
  float a = 0.f;
  for (int l = sub; l < n; l += kTpo) a = fmaf(M[(size_t)l * stride], v[l], a);
  return a;
}

// The same against the vector v + w, summed element by element first.
__device__ __forceinline__ float pdot2(const float* M, int stride,
                                       const float* v, const float* w, int n,
                                       int sub) {
  float a = 0.f;
  for (int l = sub; l < n; l += kTpo)
    a = fmaf(M[(size_t)l * stride], v[l] + w[l], a);
  return a;
}

struct NoOp {
  __device__ __forceinline__ void operator()() const {}
};

// Asynchronous copies global -> shared (cp.async, 4 bytes each, through
// L1): a thread issues its share and goes on; cp_async_wait_all() before a
// barrier makes every copy that the block issued visible after it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Copy groups: a pass that streams its stages commits one group per stage
// and waits until at most `pending` (0 or 1) of its newest groups are still
// in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
struct WaitCopies {
  int pending;
  __device__ __forceinline__ void operator()() const { cp_async_wait(pending); }
};
// The block copies n floats from src (global) to dst (shared).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// n_out outputs, each the sum over kTpo threads of part(o, sub); epi(o, sum)
// runs in one thread per output. Ends with a barrier; pre() runs in every
// thread just before it.
template <class Part, class Epi, class Pre = NoOp>
__device__ __forceinline__ void rows(int n_out, Part part, Epi epi,
                                     Pre pre = Pre()) {
  const int sub = threadIdx.x & (kTpo - 1);
  const int grp = threadIdx.x / kTpo, ngrp = blockDim.x / kTpo;
  for (int o0 = 0; o0 < n_out; o0 += ngrp) {
    const int o = o0 + grp;
    const bool valid = o < n_out;
    float acc = valid ? part(o, sub) : 0.f;
    for (int s = kTpo / 2; s; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (valid && sub == 0) epi(o, acc);
  }
  pre();
  __syncthreads();
}

// The sums of one TM x TN register tile of c(i, j) = init(i, j) +
// sum_{l < Kd} a(i, l) * b(l, j) + sum_{l < Kd2} a2(i, l) * b2(l, j), the
// tile's rows ti + r * TI and columns tj + c * TJ (clamped to the last row
// and column), so that an inner step costs TM + TN loads for TM * TN
// multiply-adds and neighbouring threads read neighbouring words.
template <int TM, int TN, class FI, class FA, class FB, class FA2, class FB2>
__device__ __forceinline__ void tile_sums(float (&acc)[TM][TN], int ti, int TI,
                                          int M, int tj, int TJ, int Nn,
                                          FI init, int Kd, FA a, FB b, int Kd2,
                                          FA2 a2, FB2 b2) {
  int ri[TM], cj[TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) ri[r] = min(ti + r * TI, M - 1);
#pragma unroll
  for (int c = 0; c < TN; ++c) cj[c] = min(tj + c * TJ, Nn - 1);
  // The sums start from init(i, j): its loads (often from global memory)
  // are all in flight before the first of them is needed.
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = init(ri[r], cj[c]);
  for (int l = 0; l < Kd; ++l) {
    float av[TM], bv[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = a(ri[r], l);
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = b(l, cj[c]);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
  for (int l = 0; l < Kd2; ++l) {
    float av[TM], bv[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = a2(ri[r], l);
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = b2(l, cj[c]);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// M x Nn outputs c(i, j) = init(i, j) + sum_{l < Kd} a(i, l) * b(l, j),
// each thread a TM x TN register tile (tile_sums). Thread ``t`` of ``nth``
// takes tiles t, t + nth, ...; store(i, j, sum) runs once per output. The
// sum may come in two segments with operands of their own (a2, b2 over
// Kd2 terms after a, b over Kd), accumulated into the same registers.
template <int TM, int TN, class FI, class FA, class FB, class FA2, class FB2,
          class FS>
__device__ __forceinline__ void tile_product2(int t, int nth, int M, int Nn,
                                              FI init, int Kd, FA a, FB b,
                                              int Kd2, FA2 a2, FB2 b2,
                                              FS store) {
  const int TI = (M + TM - 1) / TM, TJ = (Nn + TN - 1) / TN;
  for (int tile = t; tile < TI * TJ; tile += nth) {
    const int ti = tile / TJ, tj = tile % TJ;
    float acc[TM][TN];
    tile_sums<TM, TN>(acc, ti, TI, M, tj, TJ, Nn, init, Kd, a, b, Kd2, a2,
                      b2);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (ti + r * TI < M && tj + c * TJ < Nn)
          store(ti + r * TI, tj + c * TJ, acc[r][c]);
  }
}

// The same for an M x M result that is symmetric in exact arithmetic
// (A' P A, C' W C, H' G^-1 H): T x T tiles, and only those on and above the
// diagonal of the tile grid, since tile (tj, ti) holds the mirror image of
// tile (ti, tj). Each output above the diagonal is computed once and stored
// at (i, j) and (j, i), so the result is exactly symmetric and needs no
// symmetrization, and the block does little more than half the work.
template <int T, class FI, class FA, class FB, class FA2, class FB2, class FS>
__device__ __forceinline__ void sym_tile_product2(int t, int nth, int M,
                                                  FI init, int Kd, FA a, FB b,
                                                  int Kd2, FA2 a2, FB2 b2,
                                                  FS store) {
  const int TI = (M + T - 1) / T;
  for (int tile = t; tile < TI * (TI + 1) / 2; tile += nth) {
    int ti = 0, rem = tile;  // row ti of the tile grid holds TI - ti tiles
    while (rem >= TI - ti) {
      rem -= TI - ti;
      ++ti;
    }
    const int tj = ti + rem;
    float acc[T][T];
    tile_sums<T, T>(acc, ti, TI, M, tj, TI, M, init, Kd, a, b, Kd2, a2, b2);
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const int i = ti + r * TI, j = tj + c * TI;
        // A diagonal tile holds both (i, j) and (j, i): its upper half is
        // stored, mirrored.
        if (i < M && j < M && (ti < tj || r <= c)) {
          store(i, j, acc[r][c]);
          if (i != j) store(j, i, acc[r][c]);
        }
      }
  }
}

template <int T, class FI, class FA, class FB, class FS>
__device__ __forceinline__ void sym_tile_product(int t, int nth, int M,
                                                 int Kd, FI init, FA a, FB b,
                                                 FS store) {
  sym_tile_product2<T>(t, nth, M, init, Kd, a, b, 0, a, b, store);
}

template <int TM, int TN, class FI, class FA, class FB, class FS>
__device__ __forceinline__ void tile_product(int t, int nth, int M, int Nn,
                                             int Kd, FI init, FA a, FB b,
                                             FS store) {
  tile_product2<TM, TN>(t, nth, M, Nn, init, Kd, a, b, 0, a, b, store);
}

__device__ __forceinline__ int tiles_of(int M, int Nn, int TM, int TN) {
  return ((M + TM - 1) / TM) * ((Nn + TN - 1) / TN);
}
// Tiles of sym_tile_product2 for an M x M result.
__device__ __forceinline__ int sym_tiles_of(int M, int T) {
  const int TI = (M + T - 1) / T;
  return TI * (TI + 1) / 2;
}

// Splits the block over the independent products of one phase: when all
// their tiles fit the block at once, each product gets its own threads
// (off .. off + need) and they run side by side; otherwise every product
// is looped over by the whole block, one after the other.
struct PhaseSplit {
  int tid, nt, off;
  bool side_by_side;
  __device__ PhaseSplit(int total_need)
      : tid(threadIdx.x), nt(blockDim.x), off(0),
        side_by_side(total_need <= (int)blockDim.x) {}
  // First tile of this thread for a product needing ``need`` threads
  // (a value past the last tile if the thread has no part in it).
  __device__ int first(int need) {
    if (!side_by_side) return tid;
    const int t = tid - off;
    off += need;
    return (t >= 0 && t < need) ? t : need;
  }
  __device__ int step(int need) const { return side_by_side ? need : nt; }
};

#endif  // __CUDACC__

}  // namespace cheeta
