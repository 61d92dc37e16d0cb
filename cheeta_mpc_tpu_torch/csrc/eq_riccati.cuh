// Equality-constrained Riccati (LQR) solve: device code shared by the
// batch-1 kernel (eq_riccati_single.cu) and the fleet kernel
// (eq_riccati_fleet.cu). Replaces the Pallas kernels
// ops/pallas_riccati.py::_eq_lqr_kernel and
// ops/pallas_eq_batch.py::_eq_fleet_kernel of the JAX package.
//
// One team of kEqTeamWarps warps (its whole thread block) solves one problem,
// exactly (no iterations): the backward factorization with the masked
// stage-equality elimination, the vector pass fused into the same stage
// loop, then the forward rollout — the algebra of
// ops/riccati.py::solve_eq_lqr:
//   P_N = sym(Q_N), p_N = q_N; for k = N-1 .. 0:
//     PA = P A, PB = P B, G = R + B'PB + reg I, H = S + B'PA,
//     Gi = inv(sym(G)), Y = Gi D', Lam = D Y + diag(eps (1 - mask)),
//     Li = inv(sym(Lam)), YLi = Y Li, W = Gi - YLi Y',
//     K = -(W H + YLi C), P = sym(Q + A'PA + H'K + C' Li (C - Y'H));
//     h = -(mask e), m = p + P_next b, g = r + B'm,
//     k = -(W g - YLi h), nu0 = -(Li h + YLi' g),
//     p = q + A'm + H'k + C'nu0;
//   du = K dx + k, dx+ = A dx + B du + b from dx0.
//
// What bounds it: the latency of the stage-serial chain, not bytes or
// operations. What the design does about it:
// - A problem's team of four warps is its thread block, so no barrier
//   wider than the team paces the chain, and several problems share an SM:
//   a fleet of 512 legged problems is resident at once (four teams of four
//   warps per SM).
// - The two inverses run on one warp's registers (warp_gj_inverse) with no
//   barrier per pivot: lane c holds column c of the compact Gauss-Jordan
//   tableau, rotated so that the pivot row is always the first register,
//   and the pivot column comes by shuffles from the pivot's lane.
// - A stage's data (A, B, C, D and the vectors b, q, r, e, mask) arrives by
//   cp.async one stage ahead into one of two slots; R, S and Q of the stage
//   arrive at its start into the arrays their sums accumulate in (G, H and
//   P), and are there when the second phase needs them. The rollout streams
//   K, k, A, B, b one step ahead through the same slots.
// - Products run on 4 x 4 register tiles with 16-byte shared-memory loads
//   (run_tiles). The tiles and vector rows of a phase are dealt round robin
//   over the team (CyclicSplit), and a warp whose lanes hold tiles of two
//   products runs them in one call (run_phase_tiles).
// - The tile products, the inverse and the stage copies are each one
//   function (noinline) that every phase calls, on operands given as
//   offsets into shared memory: the solve is a long sequence of different
//   phases, each run once per stage, and code that every phase inlines
//   for itself is fetched anew every stage.
// - Arrays whose lives do not overlap share memory: Gi is formed in G and
//   W in Gi, Li in Lam, T in PB, T2 in Y. -Y is kept beside Y, so that every
//   product sums plain products of its operands. The layout comes with the
//   launch parameters, so its offsets are constant operands.
//
// Arithmetic. Plain f32 FMA, no tensor cores, no TF32 (never build this
// with --use_fast_math): a lower-precision product compounds over the
// 67-stage recursion to newtons of force error. Every output is summed in
// one fixed order, whatever the team size or tile shape: a product output
// sequentially over its inner index from its initial value (tile_sums), a
// mat-vec row over kTpo lanes then xor shuffles, a vector-pass row by one
// thread. The inverse is the PLAIN Gauss-Jordan elimination with the
// separate add-back of the pivot row and no equilibration (with unscaled
// pivots the one-hot-shifted form loses the 1 once |pivot| >> 1, and the
// equilibrated form turns a tiny negative diagonal of G or Lam into a 1e15
// scale); no pivot search, no refinement. Its compact tableau applies to
// each entry the operations of the augmented form [sym(M) | I], in the
// same order, each update as one fmaf. ops/cuda_eq_riccati.py::
// gj_inverse_compact follows that order in torch but rounds the product
// and the difference separately, so it does not reproduce the fmaf
// rounding: the kernel's own arithmetic is held only against the plain
// version at chip_smoke.py's tolerances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "block_linalg.cuh"
#include "phase_clock.cuh"

namespace cheeta {

constexpr int kEqNumIn = 13;
constexpr int kEqNumOut = 6;

// Section timers (phase_clock.cuh): the classes of phase that a launch's
// cycles are charged to; a timed launch writes kEqNumPhases sums and the
// whole kernel's cycles per problem.
enum EqPhaseClass {
  kEqInvG,      // the inverse of G
  kEqInvLam,    // the inverse of Lam
  kEqProducts,  // the factorization's matrix products, with the vector pass
  kEqStage,     // waiting for a stage's data
  kEqStore,     // symmetrize P, store it
  kEqRollout,   // the forward rollout
  kEqNumPhases
};
constexpr int kEqNumPhaseSlots = kEqNumPhases + 1;

// Widest tableau that a warp keeps in registers (one column per lane).
constexpr int kEqRegTableau = 32;

// A team of kEqTeamWarps warps solves one problem and is one thread block;
// four warps beat one and two for both kernels.
constexpr int kEqTeamWarps = 4;
constexpr int kEqTeamThreads = 32 * kEqTeamWarps;

struct EqDims {
  int N, nx, nu, nc;
};

// Offsets (in floats, each a multiple of four) of every shared-memory
// array; the host sizes the launch with the same function.
struct EqLayout {
  int P0, P1, PA, PBT, GW, H, YT2, nY, Lam, YLi, K;  // work matrices
  int p0, p1, mvec, gvec, kv, nu0, h, dx, du;       // vectors (dx: two)
  int rowj, colj;                                   // wide inverse only
  int slot, slot_size, nslot;                       // stage slots
  // Inside a slot. Backward pass: A B C D b q r e mask; rollout: A B, K at
  // sC, k at sr, b.
  int sA, sB, sC, sD, sb, sq, sr, se, sm;
  int total;
};

inline int eq_round4(int n) { return (n + 3) & ~3; }

// nslot: 2 streams each stage's data one stage ahead; 1 loads it when the
// stage starts (for shapes whose two slots do not fit a block).
inline EqLayout make_eq_layout(const EqDims& d, int nslot) {
  EqLayout L;
  const int nx = d.nx, nu = d.nu, nc = d.nc;
  const int nmax = nu > nc ? nu : nc;
  const int wide = nmax > kEqRegTableau ? nmax : 0;
  auto mx = [](int a, int b) { return a > b ? a : b; };
  int o = 0;
  auto take = [&](int n) {
    const int at = o;
    o += eq_round4(n);
    return at;
  };
  L.P0 = take(nx * nx); L.P1 = take(nx * nx); L.PA = take(nx * nx);
  L.PBT = take(mx(nx * nu, nc * nx)); L.GW = take(nu * nu);
  L.H = take(nu * nx); L.YT2 = take(mx(nu * nc, nc * nx));
  L.nY = take(nu * nc);
  L.Lam = take(nc * nc); L.YLi = take(nu * nc); L.K = take(nu * nx);
  L.p0 = take(nx); L.p1 = take(nx); L.mvec = take(nx); L.gvec = take(nu);
  L.kv = take(nu); L.nu0 = take(nc); L.h = take(nc); L.dx = take(2 * nx);
  L.du = take(nu); L.rowj = take(wide); L.colj = take(wide);
  int so = 0;
  auto stake = [&](int n) {
    const int at = so;
    so += eq_round4(n);
    return at;
  };
  L.sA = stake(nx * nx); L.sB = stake(nx * nu);
  L.sC = stake(mx(nc * nx, nu * nx)); L.sD = stake(nc * nu);
  L.sb = stake(nx); L.sq = stake(nx); L.sr = stake(nu); L.se = stake(nc);
  L.sm = stake(nc);
  L.slot_size = so;
  L.nslot = nslot;
  L.slot = take(nslot * so);
  L.total = o;
  return L;
}

// Inputs:  A B b Q q R r S C D e mask dx0
// Outputs: dx du K k P p   (P and p may be null)
struct EqArgs {
  const float* in[kEqNumIn];
  long long in_stride[kEqNumIn];  // elements between problems (0 = shared)
  float* out[kEqNumOut];
  long long out_stride[kEqNumOut];
  long long* timers;  // kEqNumPhaseSlots per problem, null = untimed
  EqDims d;
  EqLayout L;  // make_eq_layout(d, nslot), filled in by the host
  float reg, eps;
};

#ifdef __CUDACC__

// cp_async4 (block_linalg.cuh) 16 bytes at a time (cp.async.cg: through L2
// only); dst and src must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// The team copies n floats from src (global) to dst (shared), 16 bytes at
// a time where both are aligned and n is a multiple of four, else 4 bytes;
// the caller commits and waits.
__device__ __forceinline__ void team_copy_async(float* dst, const float* src,
                                                int n) {
  const int tid = threadIdx.x;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // Rolled loops: a phase's code is fetched once per stage.
  if (((reinterpret_cast<size_t>(src) | d) & 15) == 0 && (n & 3) == 0) {
#pragma unroll 1
    for (int i = 4 * tid; i < n; i += 4 * kEqTeamThreads)
      cp_async16(dst + i, src + i);
  } else {
#pragma unroll 1
    for (int i = tid; i < n; i += kEqTeamThreads) cp_async4(dst + i, src + i);
  }
}

// n_out mat-vec rows over the team, each summed as rows() (block_linalg.cuh)
// sums it: part(o, sub) on kTpo lanes, then xor shuffles; epi(o, sum) runs
// in one thread per row. The caller ends the phase with the team's barrier.
template <class Part, class Epi>
__device__ __forceinline__ void team_rows(int n_out, Part part, Epi epi) {
  const int sub = threadIdx.x & (kTpo - 1), grp = threadIdx.x / kTpo;
  constexpr int ngrp = kEqTeamThreads / kTpo;
  for (int o0 = 0; o0 < n_out; o0 += ngrp) {
    const int o = o0 + grp;
    const bool valid = o < n_out;
    float acc = valid ? part(o, sub) : 0.f;
    for (int s = kTpo / 2; s; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (valid && sub == 0) epi(o, acc);
  }
}

// Deals the items (register tiles, vector rows) of a phase's independent
// products round robin over the team, in the order the products are
// named: item i of the product that starts at item ``off`` goes to thread
// (off + i) mod nt. When ``warp_aligned`` items (each product's rounded up
// to whole warps) fit the team, each product starts on a warp of its own,
// so that no warp runs two products one after the other; else, when the
// plain items fit, products share warps side by side; when they do not,
// no thread takes a second item before every thread has a first.
struct CyclicSplit {
  int tid, nt, off;
  bool aligned;
  __device__ CyclicSplit(int tid_, int nt_, int warp_aligned = 0)
      : tid(tid_), nt(nt_), off(0),
        aligned(warp_aligned > 0 && warp_aligned <= nt_) {}
  // First item of this thread in a product of ``need`` items; the step
  // between its items is nt.
  __device__ int first(int need) {
    if (aligned) off = (off + 31) & ~31;
    const int t = ((tid - off) % nt + nt) % nt;
    off += need;
    return t;
  }
};
// Items of a product rounded up to whole warps.
__device__ __forceinline__ int warp_items(int n) { return (n + 31) & ~31; }

// M <- inverse of sym(M), n x n (n <= kMax <= 32), by one warp, in
// registers. Lane c holds column c of the compact tableau (slot c: left
// column c until pivot c, right column n + c from then on: the columns a
// pivot changes), rotated so that u[t] is row j + t at pivot j: the pivot
// row is always u[0], and no entry needs a test against j (a dynamic
// register index would put the column in local memory; tests against j
// made a serial chain of selects). Every row's pivot-column entry comes from
// lane j (shuffles, all in flight together). An entry gets
// fma(-T[i][j], rv, T[i][c]), plus rv in row j, with rv = T[j][c] times the
// pivot's reciprocal. Slot j turns into right column n + j, which held
// e_j: its pivot-row entry is 1, and its entries start from e_j. Rows and
// lanes past n hold zeros, stay zero and are not stored, so every n <= kMax
// gives the same bits at any kMax >= n. The pivot loop stays rolled (code
// size); with kExact, n == kMax is known to the compiler, which schedules
// the loop better (the legged widths, 24 and 16, take it). M is at shared
// offset m_off.
template <int kMax, bool kExact>
static __device__ void warp_gj_inverse(int m_off, int n_) {
  const int n = kExact ? kMax : n_;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  float u[kMax];
#pragma unroll
  for (int t = 0; t < kMax; ++t)
    u[t] = (t < n && lane < n) ? 0.5f * (smem[m_off + t * n + lane] +
                                         smem[m_off + lane * n + t])
                               : 0.f;
  for (int j = 0; j < n; ++j) {
    const bool mine = lane == j;
    float ci[kMax];
#pragma unroll
    for (int t = 0; t < kMax; ++t) ci[t] = __shfl_sync(0xffffffffu, u[t], j);
    // Times the reciprocal, not divided: the IEEE division leaves its fast
    // path for a zero numerator (a sparse G has many).
    const float ipiv = 1.0f / ci[0];
    const float rv = (mine ? 1.0f : u[0]) * ipiv;
    // Row j, then rows j + 1 ... moved down by one as they are formed.
    const float row_j = fmaf(-ci[0], rv, mine ? 1.f : u[0]) + rv;
#pragma unroll
    for (int t = 0; t + 1 < kMax; ++t)
      u[t] = fmaf(-ci[t + 1], rv, mine ? 0.f : u[t + 1]);
    u[kMax - 1] = row_j;
  }
  __syncwarp();  // every lane has read M
  if (lane < n) {
#pragma unroll
    for (int t = 0; t < kMax; ++t) {
      int i = t + n;  // u[t] is row (t + n) mod kMax
      if (i >= kMax) i -= kMax;
      if (i < n) smem[m_off + i * n + lane] = u[t];
    }
  }
  __syncwarp();
}

// The same for n > kEqRegTableau, on the tableau in shared memory (in
// place), lane c taking columns c, c + 32, ...; rowj and colj carry the
// scaled pivot row and the old pivot column of each pivot.
static __device__ void warp_gj_inverse_wide(float* M, int n,
                                            float* __restrict__ rowj,
                                            float* __restrict__ colj) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, c = idx % n;
    if (i < c) {
      const float v = 0.5f * (M[i * n + c] + M[c * n + i]);
      M[i * n + c] = v;
      M[c * n + i] = v;
    }
  }
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const float ipiv = 1.0f / M[j * n + j];
    for (int c = lane; c < n; c += 32)
      rowj[c] = (c == j ? 1.0f : M[j * n + c]) * ipiv;
    for (int i = lane; i < n; i += 32) colj[i] = M[i * n + j];
    __syncwarp();
    for (int c = lane; c < n; c += 32)
      for (int i = 0; i < n; ++i) {
        float nv = fmaf(-colj[i], rowj[c],
                        c == j ? (i == j ? 1.f : 0.f) : M[i * n + c]);
        if (i == j) nv += rowj[c];
        M[i * n + c] = nv;
      }
    __syncwarp();
  }
}

// M <- inverse of sym(M), M at shared offset m_off, by warp 0 of the
// block; the caller's barrier follows.
static __device__ __noinline__ void tableau_inverse(int m_off, int n,
                                                    int rowj_off,
                                                    int colj_off) {
  extern __shared__ __align__(16) float smem[];
  if (threadIdx.x >= 32) return;
  if (n == 16) warp_gj_inverse<16, true>(m_off, n);
  else if (n == 24) warp_gj_inverse<24, true>(m_off, n);
  else if (n <= kEqRegTableau) warp_gj_inverse<kEqRegTableau, false>(m_off, n);
  else warp_gj_inverse_wide(smem + m_off, n, smem + rowj_off, smem + colj_off);
}

enum { kCopyStage = 1, kCopyRSQ = 2, kCopyStep = 4 };

// The team's asynchronous copies of one stage (team_copy_async; the caller
// commits and waits): with kCopyStage, stage k's A, B, C, D, b, q, r, e and
// mask into the slot at shared offset sl; with kCopyRSQ, R_k, S_k and Q_k
// into G, H and the P at p_off; with kCopyStep, rollout step k's A, B, K,
// k and b into the slot at sl.
static __device__ __noinline__ void stage_copies(const EqArgs& a, int k,
                                                 int sl, int p_off,
                                                 int what) {
  extern __shared__ __align__(16) float smem[];
  const EqDims d = a.d;
  const EqLayout& L = a.L;
  const int nx = d.nx, nu = d.nu, nc = d.nc;
  const long long prob = blockIdx.x;
  auto in = [&](int i, int per_stage) {
    return a.in[i] + prob * a.in_stride[i] + (size_t)k * per_stage;
  };
  auto copy = [&](int dst_off, const float* src, int n) {
    team_copy_async(smem + dst_off, src, n);
  };
  if (what & (kCopyStage | kCopyStep)) {
    copy(sl + L.sA, in(0, nx * nx), nx * nx);
    copy(sl + L.sB, in(1, nx * nu), nx * nu);
    copy(sl + L.sb, in(2, nx), nx);
  }
  if (what & kCopyStage) {
    copy(sl + L.sC, in(8, nc * nx), nc * nx);
    copy(sl + L.sD, in(9, nc * nu), nc * nu);
    copy(sl + L.sq, in(4, nx), nx);
    copy(sl + L.sr, in(6, nu), nu);
    copy(sl + L.se, in(10, nc), nc);
    copy(sl + L.sm, in(11, nc), nc);
  }
  if (what & kCopyRSQ) {
    copy(L.GW, in(5, nu * nu), nu * nu);
    copy(L.H, in(7, nu * nx), nu * nx);
    copy(p_off, in(3, nx * nx), nx * nx);
  }
  if (what & kCopyStep) {  // K and k: outputs this team wrote
    copy(sl + L.sC, a.out[2] + prob * a.out_stride[2] + (size_t)k * nu * nx,
         nu * nx);
    copy(sl + L.sr, a.out[3] + prob * a.out_stride[3] + (size_t)k * nu, nu);
  }
}

// One operand of a tile product, a matrix in shared memory read as
// x(p, q) = S[off + p * s0 + q * s1].
struct TileOperand {
  int off, s0, s1;
};
__device__ __forceinline__ TileOperand rowmaj(int off, int ld) {
  return TileOperand{off, ld, 1};  // x(p, q) = X[p][q]
}
__device__ __forceinline__ TileOperand colmaj(int off, int ld) {
  return TileOperand{off, 1, ld};  // x(p, q) = X[q][p]
}

// c(i, j) = init(i, j) + sum_{l < K1} a1(i, l) b1(l, j)
//           + sum_{l < K2} a2(i, l) b2(l, j), for i < M, j < Nn.
// init: S[init_off + i * init_ld + j] (zero when init_off < 0); with diag
// 1 plus (i == j ? dconst : 0), with diag 2 it is
// i == j ? dconst * (1 - S[dvec + i]) : 0. c goes to
// S[out_off + i * out_ld + j], negated with out_neg, and also to
// gout[i * gout_ld + j] when gout is set; -c goes to
// S[nout_off + i * out_ld + j] when nout_off >= 0.
struct TileJob {
  int M, Nn;
  int init_off, init_ld, diag, dvec;
  float dconst;
  int K1, K2;
  TileOperand a1, b1, a2, b2;
  int out_off, out_ld, nout_off;
  bool out_neg;
  float* gout;
  int gout_ld;
};
__device__ __forceinline__ TileJob tile_job(int M, int Nn, int out_off,
                                            int out_ld, int K1,
                                            TileOperand a1, TileOperand b1) {
  TileJob J;
  J.M = M; J.Nn = Nn;
  J.init_off = -1; J.init_ld = 0; J.diag = 0; J.dvec = 0; J.dconst = 0.f;
  J.K1 = K1; J.a1 = a1; J.b1 = b1;
  J.K2 = 0; J.a2 = a1; J.b2 = b1;
  J.out_off = out_off; J.out_ld = out_ld; J.nout_off = -1;
  J.out_neg = false;
  J.gout = nullptr; J.gout_ld = 0;
  return J;
}

// Register tiles are 4 x 4, rows i0 .. i0 + 3 and columns j0 .. j0 + 3.
constexpr int kTile = 4;

// One tile's sums over one segment of K terms, four terms at a time with
// 16-byte loads: a operand along l (kAL, a row-major) or along i (a
// column-major), b operand along l (kBL, b column-major) or along j. The
// operands of the next four terms are loaded while these multiply. Each
// output still adds its terms one by one, in the order of l.
template <bool kAL, bool kBL>
__device__ __forceinline__ void tile_terms_vec(float (&acc)[kTile][kTile],
                                               const float* S, int i0,
                                               int j0, int K,
                                               const TileOperand& a,
                                               const TileOperand& b) {
  typedef float Blk[kTile][kTile];
  auto load = [&](int l, Blk& av, Blk& bv) {  // av[r][q], bv[q][c]
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int ia = kAL ? a.off + (i0 + u) * a.s0 + l
                         : a.off + i0 + (l + u) * a.s1;
      const int ib = kBL ? b.off + (j0 + u) * b.s1 + l
                         : b.off + (l + u) * b.s0 + j0;
      const float4 va = *reinterpret_cast<const float4*>(S + ia);
      const float4 vb = *reinterpret_cast<const float4*>(S + ib);
      const float fa[4] = {va.x, va.y, va.z, va.w};
      const float fb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        if (kAL) av[u][v] = fa[v]; else av[v][u] = fa[v];
        if (kBL) bv[v][u] = fb[v]; else bv[u][v] = fb[v];
      }
    }
  };
  Blk av, bv;
  load(0, av, bv);
#pragma unroll 1
  for (int l = 0; l < K; l += kTile) {
    Blk an, bn;
    load(l + kTile < K ? l + kTile : l, an, bn);
#pragma unroll
    for (int q = 0; q < kTile; ++q)
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          acc[r][c] = fmaf(av[r][q], bv[q][c], acc[r][c]);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        av[r][c] = an[r][c];
        bv[r][c] = bn[r][c];
      }
  }
}

// The same one term at a time, on rows and columns clamped to the matrix
// (ri, cj): for shapes or offsets that the 16-byte loads do not fit.
__device__ __forceinline__ void tile_terms(float (&acc)[kTile][kTile],
                                           const float* S,
                                           const int (&ri)[kTile],
                                           const int (&cj)[kTile], int K,
                                           const TileOperand& a,
                                           const TileOperand& b) {
#pragma unroll 1
  for (int l = 0; l < K; ++l) {
    float av[kTile], bv[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) av[r] = S[a.off + ri[r] * a.s0 + l * a.s1];
#pragma unroll
    for (int c = 0; c < kTile; ++c) bv[c] = S[b.off + l * b.s0 + cj[c] * b.s1];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Whether an operand's 16-byte loads are aligned: its offset and its
// leading dimension are multiples of four floats.
__device__ __forceinline__ bool vec_ok(const TileOperand& x) {
  return ((x.off | (x.s0 == 1 ? x.s1 : x.s0)) & 3) == 0;
}

// The items first, first + step, ... of a job: 4 x 4 register tiles, tile
// t covering rows 4 (t / TJ) .. + 3 and columns 4 (t % TJ) .. + 3 (clamped
// to the last row and column, the duplicates not stored). Each output is
// its initial value plus the K1 terms of (a1, b1), then the K2 terms of
// (a2, b2), in the order of l: the order of tile_sums.
static __device__ __noinline__ void run_tiles(const TileJob J, int first,
                                              int step) {
  extern __shared__ __align__(16) float smem[];
  const float* S = smem;
  const int M = J.M, Nn = J.Nn;
  const int TI = (M + kTile - 1) / kTile, TJ = (Nn + kTile - 1) / kTile;
  const bool vec = (M & 3) == 0 && (Nn & 3) == 0 && ((J.K1 | J.K2) & 3) == 0 &&
                   vec_ok(J.a1) && vec_ok(J.b1) &&
                   (J.K2 == 0 || (vec_ok(J.a2) && vec_ok(J.b2)));
  // Whole tiles whose initial values and outputs are rows of four aligned
  // floats move them 16 bytes at a time.
  const bool rows4 =
      vec && J.diag != 2 && ((J.out_off | J.out_ld) & 3) == 0 &&
      (J.init_off < 0 || ((J.init_off | J.init_ld) & 3) == 0) &&
      (J.nout_off < 0 || (J.nout_off & 3) == 0) &&
      (J.gout == nullptr ||
       ((reinterpret_cast<size_t>(J.gout) & 15) == 0 && (J.gout_ld & 3) == 0));
  const float sgn = J.out_neg ? -1.f : 1.f;
  for (int tile = first; tile < TI * TJ; tile += step) {
    const int i0 = kTile * (tile / TJ), j0 = kTile * (tile % TJ);
    int ri[kTile], cj[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) ri[r] = min(i0 + r, M - 1);
#pragma unroll
    for (int c = 0; c < kTile; ++c) cj[c] = min(j0 + c, Nn - 1);
    float acc[kTile][kTile];
    if (J.diag == 2) {
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          acc[r][c] = ri[r] == cj[c]
                          ? J.dconst * (1.f - smem[J.dvec + ri[r]]) : 0.f;
    } else {
      const int ib = J.init_off >= 0 ? J.init_off : 0;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (rows4) {
          const float* src = smem + ib + ri[r] * J.init_ld + j0;
          const float4 v = J.init_off >= 0
                               ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < kTile; ++c)
            acc[r][c] = J.init_off >= 0
                            ? smem[ib + ri[r] * J.init_ld + cj[c]] : 0.f;
        }
      }
      if (J.diag == 1) {
#pragma unroll
        for (int r = 0; r < kTile; ++r)
#pragma unroll
          for (int c = 0; c < kTile; ++c)
            acc[r][c] = acc[r][c] + (ri[r] == cj[c] ? J.dconst : 0.f);
      }
    }
#pragma unroll 1
    for (int seg = 0; seg < 2; ++seg) {
      const TileOperand a = seg ? J.a2 : J.a1, b = seg ? J.b2 : J.b1;
      const int K = seg ? J.K2 : J.K1;
      if (K == 0) continue;
      if (!vec) tile_terms(acc, S, ri, cj, K, a, b);
      else if (a.s1 == 1 && b.s0 == 1)
        tile_terms_vec<true, true>(acc, S, i0, j0, K, a, b);
      else if (a.s1 == 1)
        tile_terms_vec<true, false>(acc, S, i0, j0, K, a, b);
      else if (b.s0 == 1)
        tile_terms_vec<false, true>(acc, S, i0, j0, K, a, b);
      else
        tile_terms_vec<false, false>(acc, S, i0, j0, K, a, b);
    }
    if (rows4) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float4 v = make_float4(sgn * acc[r][0], sgn * acc[r][1],
                                     sgn * acc[r][2], sgn * acc[r][3]);
        *reinterpret_cast<float4*>(smem + J.out_off + (i0 + r) * J.out_ld +
                                   j0) = v;
        if (J.gout)
          *reinterpret_cast<float4*>(J.gout + (i0 + r) * J.gout_ld + j0) = v;
        if (J.nout_off >= 0)
          *reinterpret_cast<float4*>(smem + J.nout_off +
                                     (i0 + r) * J.out_ld + j0) =
              make_float4(-v.x, -v.y, -v.z, -v.w);
      }
      continue;
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (i < M && j < Nn) {
          const float v = sgn * acc[r][c];
          smem[J.out_off + i * J.out_ld + j] = v;
          if (J.gout) J.gout[i * J.gout_ld + j] = v;
          if (J.nout_off >= 0) smem[J.nout_off + i * J.out_ld + j] = -v;
        }
      }
  }
}

// Number of tiles of a job.
__device__ __forceinline__ int tiles_in(const TileJob& J) {
  return tiles_of(J.M, J.Nn, kTile, kTile);
}

// This thread's tiles of the independent products of one phase, dealt by
// ``ph`` in the order given (j1, then j2 when n > 1, then j3 when n > 2).
// A round calls run_tiles once, each lane on the first product it still
// holds tiles of, so that lanes of one warp that hold tiles of different
// products run them together, not one product after the other.
__device__ __forceinline__ void run_phase_tiles(CyclicSplit& ph, int nt,
                                                int n, const TileJob& j1,
                                                const TileJob& j2,
                                                const TileJob& j3) {
  int first[3] = {ph.first(tiles_in(j1)), n > 1 ? ph.first(tiles_in(j2)) : 0,
                  n > 2 ? ph.first(tiles_in(j3)) : 0};
  bool left[3] = {first[0] < tiles_in(j1), n > 1 && first[1] < tiles_in(j2),
                  n > 2 && first[2] < tiles_in(j3)};
  while (__any_sync(0xffffffffu, left[0] || left[1] || left[2])) {
    const int p = left[0] ? 0 : (left[1] ? 1 : (left[2] ? 2 : -1));
    const TileJob J = p == 1 ? j2 : (p == 2 ? j3 : j1);
    run_tiles(J, p >= 0 ? first[p] : tiles_in(J), nt);
    if (p >= 0) left[p] = false;
  }
}

template <bool kTimed>
static __device__ void eq_lqr_solve(const EqArgs& a, float* smem) {
  constexpr int nt = kEqTeamThreads;
  PhaseClock<kTimed, kEqNumPhases> clk;
  const EqDims d = a.d;
  const int N = d.N, nx = d.nx, nu = d.nu, nc = d.nc;
  const int tid = threadIdx.x;
  const long long prob = blockIdx.x;
  const EqLayout& L = a.L;
  const float reg = a.reg, eps = a.eps;
  auto sync = [] { __syncthreads(); };  // the team is the block

  // The inputs are read-only and overlap nothing the kernel writes; the
  // stage data comes through stage_copies.
  typedef const float* __restrict__ In;
  auto in = [&](int i) { return a.in[i] + prob * a.in_stride[i]; };
  In gQ = in(3), gq = in(4), gdx0 = in(12);
  auto outp = [&](int i) {
    return a.out[i] ? a.out[i] + prob * a.out_stride[i] : nullptr;
  };
  float *odx = outp(0), *odu = outp(1), *oK = outp(2), *ok = outp(3),
        *oP = outp(4), *op = outp(5);

  float* s = smem;
  int oPn = L.P0, oPk = L.P1;  // P_{k+1} and P_k, rolled
  float *pn = s + L.p0, *pk = s + L.p1, *mvec = s + L.mvec,
        *gvec = s + L.gvec, *kv = s + L.kv, *nu0 = s + L.nu0, *h = s + L.h,
        *du = s + L.du;
  float *PA = s + L.PA, *G = s + L.GW, *H = s + L.H, *YLi = s + L.YLi,
        *Lam = s + L.Lam;
  auto slot_at = [&](int k) {
    return L.slot + (L.nslot == 2 ? (k & 1) : 0) * L.slot_size;
  };
  auto load_stage = [&](int k) {
    stage_copies(a, k, slot_at(k), 0, kCopyStage);
  };
  auto load_step = [&](int k) {
    stage_copies(a, k, slot_at(k), 0, kCopyStep);
  };
  const bool ahead = L.nslot == 2;

  // ---- terminal boundary --------------------------------------------------
  if (ahead) load_stage(N - 1);
  cp_async_commit();
  {
    const float* QN = gQ + (size_t)N * nx * nx;
    float* Pn = s + oPn;
    for (int idx = tid; idx < nx * nx; idx += nt) {
      const int i = idx / nx, j = idx % nx;
      const float v = 0.5f * (QN[idx] + QN[j * nx + i]);
      Pn[idx] = v;
      if (oP) oP[(size_t)N * nx * nx + idx] = v;
    }
    for (int i = tid; i < nx; i += nt) {
      const float v = gq[N * nx + i];
      pn[i] = v;
      if (op) op[N * nx + i] = v;
    }
  }
  cp_async_wait(0);
  sync();
  clk.mark(kEqStore);

  // ---- backward pass: factorization and vector pass, one loop -------------
  for (int k = N - 1; k >= 0; --k) {
    const int sl = slot_at(k);
    const int oA = sl + L.sA, oB = sl + L.sB, oC = sl + L.sC,
              oD = sl + L.sD;
    const float *sA = s + oA, *sB = s + oB, *sC = s + oC, *sb = s + sl + L.sb,
                *sq = s + sl + L.sq, *sr = s + sl + L.sr,
                *se = s + sl + L.se, *sm = s + sl + L.sm;
    const float* Pn = s + oPn;
    float* Pk = s + oPk;
    // R, S, Q of this stage into the arrays their sums start from (dead
    // since the last stage); the next stage's data into the other slot,
    // whose last reader was the last stage.
    stage_copies(a, k, sl, oPk, kCopyRSQ | (ahead ? 0 : kCopyStage));
    cp_async_commit();
    if (ahead && k > 0) load_stage(k - 1);
    cp_async_commit();
    if (!ahead) {
      cp_async_wait(0);
      sync();
      clk.mark(kEqStage);
    }
    {  // PA = P A, PB = P B, m = p + P b, h = -(mask e)
      const TileJob jpa = tile_job(nx, nx, L.PA, nx, nx, rowmaj(oPn, nx),
                                   rowmaj(oA, nx));
      const TileJob jpb = tile_job(nx, nu, L.PBT, nu, nx, rowmaj(oPn, nx),
                                   rowmaj(oB, nu));
      const int n_pa = tiles_in(jpa), n_pb = tiles_in(jpb);
      CyclicSplit ph(tid, nt, warp_items(n_pa) + warp_items(n_pb) +
                                  warp_items(nx) + warp_items(nc));
      run_phase_tiles(ph, nt, 2, jpa, jpb, jpb);
      for (int i = ph.first(nx); i < nx; i += nt) {
        float acc = pn[i];
#pragma unroll 4
        for (int l = 0; l < nx; ++l) acc = fmaf(Pn[i * nx + l], sb[l], acc);
        mvec[i] = acc;
      }
      for (int i = ph.first(nc); i < nc; i += nt) h[i] = -(sm[i] * se[i]);
    }
    clk.mark(kEqProducts);
    cp_async_wait(1);  // R, S, Q
    clk.mark(kEqStage);
    sync();
    clk.mark(kEqProducts);
    {  // G = R + B'PB + reg I, H = S + B'PA, Pk = Q + A'PA, in place;
       // g = r + B'm
      TileJob jg = tile_job(nu, nu, L.GW, nu, nx, colmaj(oB, nu),
                            rowmaj(L.PBT, nu));
      jg.init_off = L.GW; jg.init_ld = nu; jg.diag = 1; jg.dconst = reg;
      TileJob jh = tile_job(nu, nx, L.H, nx, nx, colmaj(oB, nu),
                            rowmaj(L.PA, nx));
      jh.init_off = L.H; jh.init_ld = nx;
      TileJob jp = tile_job(nx, nx, oPk, nx, nx, colmaj(oA, nx),
                            rowmaj(L.PA, nx));
      jp.init_off = oPk; jp.init_ld = nx;
      const int n_g = tiles_in(jg), n_h = tiles_in(jh),
                n_p = tiles_in(jp);
      CyclicSplit ph(tid, nt, warp_items(n_g) + warp_items(n_h) +
                                  warp_items(n_p) + warp_items(nu));
      run_phase_tiles(ph, nt, 3, jg, jh, jp);
      for (int i = ph.first(nu); i < nu; i += nt) {
        float acc = sr[i];
#pragma unroll 4
        for (int l = 0; l < nx; ++l) acc = fmaf(sB[l * nu + i], mvec[l], acc);
        gvec[i] = acc;
      }
    }
    sync();
    clk.mark(kEqProducts);
    tableau_inverse(L.GW, nu, L.rowj, L.colj);  // Gi, in G
    sync();
    clk.mark(kEqInvG);
    {  // Y = Gi D', and -Y beside it
      TileJob jy = tile_job(nu, nc, L.YT2, nc, nu, rowmaj(L.GW, nu),
                            colmaj(oD, nu));
      jy.nout_off = L.nY;
      run_tiles(jy, tid, nt);
    }
    sync();
    clk.mark(kEqProducts);
    {  // Lam = D Y + diag(eps (1 - mask))
      TileJob jl = tile_job(nc, nc, L.Lam, nc, nu, rowmaj(oD, nu),
                            rowmaj(L.YT2, nc));
      jl.diag = 2; jl.dconst = eps; jl.dvec = sl + L.sm;
      run_tiles(jl, tid, nt);
    }
    sync();
    clk.mark(kEqProducts);
    tableau_inverse(L.Lam, nc, L.rowj, L.colj);  // Li, in Lam
    sync();
    clk.mark(kEqInvLam);
    run_tiles(  // YLi = Y Li
        tile_job(nu, nc, L.YLi, nc, nc, rowmaj(L.YT2, nc),
                 rowmaj(L.Lam, nc)),
        tid, nt);
    sync();
    clk.mark(kEqProducts);
    {  // W = Gi - YLi Y' (in place of Gi), T = C - Y'H (in place of PB);
       // each term as YLi (-Y)' and (-Y)'H, the same product
      TileJob jw = tile_job(nu, nu, L.GW, nu, nc, rowmaj(L.YLi, nc),
                            colmaj(L.nY, nc));
      jw.init_off = L.GW; jw.init_ld = nu;
      TileJob jt = tile_job(nc, nx, L.PBT, nx, nu, colmaj(L.nY, nc),
                            rowmaj(L.H, nx));
      jt.init_off = oC; jt.init_ld = nx;
      const int n_w = tiles_in(jw), n_t = tiles_in(jt);
      CyclicSplit ph(tid, nt, warp_items(n_w) + warp_items(n_t));
      run_phase_tiles(ph, nt, 2, jw, jt, jt);
    }
    sync();
    clk.mark(kEqProducts);
    {  // K = -(W H + YLi C), T2 = Li T (in place of Y), k = -(W g - YLi h),
       // nu0 = -(Li h + YLi' g); K and k go out as they are formed
      TileJob jk = tile_job(nu, nx, L.K, nx, nu, rowmaj(L.GW, nu),
                            rowmaj(L.H, nx));
      jk.K2 = nc; jk.a2 = rowmaj(L.YLi, nc); jk.b2 = rowmaj(oC, nx);
      jk.out_neg = true; jk.gout = oK + (size_t)k * nu * nx; jk.gout_ld = nx;
      const TileJob jt2 = tile_job(nc, nx, L.YT2, nx, nc, rowmaj(L.Lam, nc),
                                   rowmaj(L.PBT, nx));
      const int n_k = tiles_in(jk), n_t2 = tiles_in(jt2);
      CyclicSplit ph(tid, nt, warp_items(n_k) + warp_items(n_t2) +
                                  warp_items(nu) + warp_items(nc));
      run_phase_tiles(ph, nt, 2, jk, jt2, jt2);
      for (int i = ph.first(nu); i < nu; i += nt) {
        float acc = 0.f;
#pragma unroll 4
        for (int l = 0; l < nu; ++l) acc = fmaf(G[i * nu + l], gvec[l], acc);
#pragma unroll 4
        for (int r = 0; r < nc; ++r) acc = fmaf(-YLi[i * nc + r], h[r], acc);
        kv[i] = -acc;
        ok[k * nu + i] = -acc;
      }
      for (int r = ph.first(nc); r < nc; r += nt) {
        float acc = 0.f;
#pragma unroll 4
        for (int c = 0; c < nc; ++c) acc = fmaf(Lam[r * nc + c], h[c], acc);
#pragma unroll 4
        for (int l = 0; l < nu; ++l) acc = fmaf(YLi[l * nc + r], gvec[l], acc);
        nu0[r] = -acc;
      }
    }
    sync();
    clk.mark(kEqProducts);
    {  // PA <- Pk + H'K + C'T2 (P before symmetrization),
       // p = q + A'm + H'k + C'nu0
      TileJob jp = tile_job(nx, nx, L.PA, nx, nu, colmaj(L.H, nx),
                            rowmaj(L.K, nx));
      jp.init_off = oPk; jp.init_ld = nx;
      jp.K2 = nc; jp.a2 = colmaj(oC, nx); jp.b2 = rowmaj(L.YT2, nx);
      const int n_p = tiles_in(jp);
      CyclicSplit ph(tid, nt, warp_items(n_p) + warp_items(nx));
      run_phase_tiles(ph, nt, 1, jp, jp, jp);
      for (int i = ph.first(nx); i < nx; i += nt) {
        float acc = sq[i];
#pragma unroll 4
        for (int l = 0; l < nx; ++l) acc = fmaf(sA[l * nx + i], mvec[l], acc);
#pragma unroll 4
        for (int l = 0; l < nu; ++l) acc = fmaf(H[l * nx + i], kv[l], acc);
#pragma unroll 4
        for (int r = 0; r < nc; ++r) acc = fmaf(sC[r * nx + i], nu0[r], acc);
        pk[i] = acc;
        if (op) op[k * nx + i] = acc;
      }
    }
    sync();
    clk.mark(kEqProducts);
    // Pk <- sym(PA)
    for (int idx = tid; idx < nx * nx; idx += nt) {
      const int i = idx / nx, j = idx % nx;
      const float v = 0.5f * (PA[idx] + PA[j * nx + i]);
      Pk[idx] = v;
      if (oP) oP[(size_t)k * nx * nx + idx] = v;
    }
    clk.mark(kEqStore);
    cp_async_wait(0);  // the next stage's data
    clk.mark(kEqStage);
    sync();
    clk.mark(kEqStore);
    const int so = oPn; oPn = oPk; oPk = so;
    float* sw = pn; pn = pk; pk = sw;
  }

  // ---- forward rollout ----------------------------------------------------
  // K and k come back from global memory: this team wrote them, and
  // barriers lie between. dx_k and dx_{k+1} take turns in two buffers.
  float* dxb = s + L.dx;
  for (int i = tid; i < nx; i += nt) {
    const float v = gdx0[i];
    dxb[i] = v;
    odx[i] = v;
  }
  load_step(0);
  cp_async_commit();
  for (int k = 0; k < N; ++k) {
    cp_async_wait(0);
    sync();  // step k's data and dx_k are in place; slot k - 1 is free
    if (ahead && k + 1 < N) load_step(k + 1);
    cp_async_commit();
    const int sl = slot_at(k);
    const float *sA = s + sl + L.sA, *sB = s + sl + L.sB,
                *sK = s + sl + L.sC, *sk = s + sl + L.sr, *sb = s + sl + L.sb;
    const float* dx = dxb + (k & 1) * nx;
    float* dxn = dxb + ((k + 1) & 1) * nx;
    team_rows(
        nu, [&](int o, int sub) { return pdot(sK + o * nx, 1, dx, nx, sub); },
        [&](int o, float acc) {
          const float v = acc + sk[o];
          du[o] = v;
          odu[k * nu + o] = v;
        });
    sync();
    team_rows(
        nx,
        [&](int o, int sub) {
          return pdot(sA + o * nx, 1, dx, nx, sub) +
                 pdot(sB + o * nu, 1, du, nu, sub);
        },
        [&](int o, float acc) {
          const float v = acc + sb[o];
          dxn[o] = v;
          odx[(k + 1) * nx + o] = v;
        });
    if (!ahead && k + 1 < N) {
      sync();  // the slot is free for step k + 1
      load_step(k + 1);
      cp_async_commit();
    }
  }
  clk.mark(kEqRollout);
  clk.write(a.timers ? a.timers + prob * kEqNumPhaseSlots : nullptr);
}

#endif  // __CUDACC__

}  // namespace cheeta
