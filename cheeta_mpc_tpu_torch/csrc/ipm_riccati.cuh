// Riccati-structured interior-point OCP-QP solver: device code shared by the
// batch-1 kernel (ipm_riccati_single.cu) and the fleet kernel
// (ipm_riccati_fleet.cu).
//
// One thread block solves one problem: the whole fixed-iteration Mehrotra
// predictor-corrector of ops/ocpqp.py::solve_ocp_qp (same init, barrier
// algebra, fraction-to-boundary rule, convergence freeze and stationarity
// step guard), with the barrier-weighted Riccati factorization, the masked
// stage-equality elimination, both vector/forward passes and the SPD
// inverses done in the block. Replaces the Pallas kernels
// ops/pallas_ipm_riccati.py::_ipm_kernel and
// ops/pallas_ipm_batch.py::_fleet_kernel of the JAX package.
//
// What sets the time: the solve is one chain of barrier phases (stage after
// stage, iteration after iteration), so the design shortens the chain and
// keeps loads off it.
// - A stage's data (A, B, C, D, Q, R, S, the equality rows, and the Riccati
//   factors when they live in global memory) is copied into shared memory
//   by cp.async while an earlier stage computes: one stage ahead in the
//   factorization, two in the short stages of the sweeps; the copies are
//   waited for just before the barrier that ends a stage.
// - SPD inverses up to 32 wide run on one warp's registers, one column
//   per lane, with the rows rotated so that the pivot row is always the
//   first register: no barrier per pivot and no test against the pivot
//   index; the block's other warps wait at the one barrier that ends the
//   inverse. Wider ones spread the tableau over the block and take one
//   barrier per pivot. Both get their equilibration scales from the phase
//   that forms the matrix.
// - Passes over all stages split row products over lane groups and give
//   column products one output per thread, so that a warp reads whole
//   lines of global memory.
// - The layout of shared memory comes with the launch parameters: its
//   offsets are constant operands, not registers (the fleet kernel has 128).
// - The Newton backward pass reads p_{k+1} + P_{k+1} rd_k where it is
//   needed instead of forming it in a phase of its own; the corrector's
//   right-hand sides are recomputed where they are read.
// - Products run on register tiles, independent products of a phase side
//   by side on disjoint threads. Without equalities P's products
//   (C' W C + A' P A, then H' K) are computed only on and above the
//   diagonal and stored mirrored, so P needs no symmetrization phase.
// - The equality elimination's small products take one output per thread,
//   reassociated around Z = G^-1 H and T = Ce - Y'H so that G's inverse is
//   followed by four barrier phases: Y and Z; Lam; Y Lam^-1 and Lam^-1 T;
//   then W, K = -(Z + Y Lam^-1 T) and P_k = sym(Qb + A'PA - H'Z
//   + T' Lam^-1 T), each pair (i, j), (j, i) of P summed by one thread and
//   stored as its mean. T and H'Z are formed by the warps that do not
//   share warp 0's scheduler while warp 0 inverts Lam. Z borrows PA's
//   buffer (running on into PB's where nu > nx), and Y is kept transposed
//   so that W reads it along rows; the stored factors are those the sweeps
//   always read. The next stage's copies go out after G's inverse.
// - Code size counts: the kernel is one long sequence of different phases,
//   so code that is fetched once per stage (an unrolled elimination, say)
//   evicts the products' code from the instruction cache.
//
// Memory plan. The iterate, slacks, duals, directions, the rolling P and
// the per-stage work matrices live in dynamic shared memory for all
// iterations, beside the stage slots. The Riccati factors of all stages
// (K, G^-1 or W, and H, Y Lam^-1, Lam^-1, LiD with equalities) live in
// shared memory when they fit the block's share, else in a global scratch
// buffer that the caller provides (kFacShared). Residuals the iteration
// rebuilds (r_l, r_u and the complementarity right-hand sides) are not
// stored: they are recomputed where they are read, with the same
// operations.
//
// Arithmetic. Plain f32 FMA, no tensor cores, IEEE division and square
// root (never build this with --use_fast_math): the barrier Hessian reaches
// condition ~1/mu, and the guard relies on NaN comparing false. The SPD
// inverse is the Jacobi-equilibrated Gauss-Jordan elimination with the
// one-hot-shifted pivot column, the pivot row scaled by the pivot's
// reciprocal, and no Newton refinement.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "block_linalg.cuh"
#include "phase_clock.cuh"

namespace cheeta {

constexpr int kNumIn = 18;
constexpr int kNumOut = 11;

// Section timers: the classes of barrier phase that a launch's cycles are
// charged to, and the slot of the total. A timed launch writes, per block,
// kNumPhaseSlots cycle counts (clock64 of thread 0).
enum PhaseClass {
  kPhInverse,      // SPD inverses
  kPhProducts,     // the factorization's matrix products
  kPhSweeps,       // stage-serial mat-vec passes (Newton, stationarity)
  kPhGradients,    // cost gradients of all stages at once
  kPhBulk,         // other mat-vecs over all stages (residuals, C d)
  kPhStage,        // waiting for a stage's data in shared memory
  kPhElementwise,  // elementwise updates and block reductions
  kNumPhases
};
constexpr int kNumPhaseSlots = kNumPhases + 1;  // + the whole kernel

struct IpmDims {
  int N, nx, nu, ng, nc, iters;
};

struct IpmParams {
  float tau, mu0, s0_min, reg, eps, w_max, mu_tol;
};

// Offsets (in floats) of every shared-memory array; the host uses the same
// function to size the launch.
struct Layout {
  int sl, su, ll, lu, dsl, dsu, dll, dlu, g, ln, w, m, lg, ug;  // (N+1) ng
  int dx, ddx, p, qb, cs, xt, prd, rd;     // (N+1) * nx each
  int du, ddu, kv, rb, ut;                 // N * nu each
  int re;                                  // N * nc
  int rx0, rhs, tu, nuv, nu0;              // nx, nu, nu, nc, nc
  int P0, P1;                              // P_{k+1} and P_k, rolled
  int PA, PB, G, Hk, Gt, Kw, Ww;           // per-stage work
  int sv, rowb, colb;                      // the inverse's pivot buffers
  int Y, T, T2, Lam, Liw, YLiw;            // equality work (nc > 0)
  int red;                                 // 32
  int slot, slot_size;                     // 2 x slot_size for stage data
  int total_vec;
  int fK, fGi, fH, fYLi, fLi, fLiD;        // relative to the factor base
  int total_fac;
};

#define CHEETA_TAKE(field, n) \
  do {                       \
    L.field = o;             \
    o += (n);                \
  } while (0)

// fac_shared: the factors stay in shared memory. Otherwise the stage slots
// also carry the factors that the sweeps read, and the factorization keeps
// work copies of K, W, Y Lam^-1 (its products read those, never the
// global store).
inline Layout make_layout(const IpmDims& d, bool fac_shared) {
  Layout L;
  const int N = d.N, N1 = d.N + 1, nx = d.nx, nu = d.nu, ng = d.ng,
            nc = d.nc;
  const int gl = fac_shared ? 0 : 1;
  int o = 0;
  CHEETA_TAKE(sl, N1 * ng); CHEETA_TAKE(su, N1 * ng); CHEETA_TAKE(ll, N1 * ng);
  CHEETA_TAKE(lu, N1 * ng); CHEETA_TAKE(dsl, N1 * ng); CHEETA_TAKE(dsu, N1 * ng);
  CHEETA_TAKE(dll, N1 * ng); CHEETA_TAKE(dlu, N1 * ng); CHEETA_TAKE(g, N1 * ng);
  CHEETA_TAKE(ln, N1 * ng); CHEETA_TAKE(w, N1 * ng); CHEETA_TAKE(m, N1 * ng);
  CHEETA_TAKE(lg, N1 * ng); CHEETA_TAKE(ug, N1 * ng);
  CHEETA_TAKE(dx, N1 * nx); CHEETA_TAKE(ddx, N1 * nx); CHEETA_TAKE(p, N1 * nx);
  CHEETA_TAKE(qb, N1 * nx); CHEETA_TAKE(cs, N1 * nx); CHEETA_TAKE(xt, N1 * nx);
  CHEETA_TAKE(prd, N1 * nx); CHEETA_TAKE(rd, N1 * nx);
  CHEETA_TAKE(du, N * nu); CHEETA_TAKE(ddu, N * nu); CHEETA_TAKE(kv, N * nu);
  CHEETA_TAKE(rb, N * nu); CHEETA_TAKE(ut, N * nu);
  CHEETA_TAKE(re, N * nc);
  CHEETA_TAKE(rx0, nx); CHEETA_TAKE(rhs, nu); CHEETA_TAKE(tu, nu);
  CHEETA_TAKE(nuv, nc); CHEETA_TAKE(nu0, nc);
  CHEETA_TAKE(P0, nx * nx); CHEETA_TAKE(P1, nx * nx);
  const int nmax = nu > nc ? nu : nc;
  CHEETA_TAKE(PA, nx * nx); CHEETA_TAKE(PB, nx * nu); CHEETA_TAKE(G, nu * nu);
  CHEETA_TAKE(Hk, nu * nx); CHEETA_TAKE(Gt, nu * nu);
  CHEETA_TAKE(Kw, gl * nu * nx); CHEETA_TAKE(Ww, nc ? gl * nu * nu : 0);
  CHEETA_TAKE(Y, nu * nc); CHEETA_TAKE(T, nc * nx); CHEETA_TAKE(T2, nc * nx);
  CHEETA_TAKE(Lam, nc * nc); CHEETA_TAKE(Liw, nc * nc);
  CHEETA_TAKE(YLiw, gl * nu * nc);
  CHEETA_TAKE(sv, nmax); CHEETA_TAKE(rowb, 2 * nmax); CHEETA_TAKE(colb, 2 * nmax);
  CHEETA_TAKE(red, 32);
  // A slot holds what one stage of any stage-serial pass reads.
  const int ab = nx * nx + nx * nu;
  int need = ab + ng * nx + ng * nu + nc * nx + nc * nu +  // factorization
             nx * nx + nu * nu + nu * nx;
  const int bwd = ab + nc * nx +
                  gl * (nc ? nu * nu + nu * nx + nu * nc + nc * nc
                           : nu * nx + nu * nu);          // Newton backward
  const int fwd = ab + gl * nu * nx;                      // Newton forward
  const int stat = ab + nc * nx + nc * nu + gl * nc * nu;  // stationarity
  need = need > bwd ? need : bwd;
  need = need > fwd ? need : fwd;
  need = need > stat ? need : stat;
  L.slot_size = need;
  CHEETA_TAKE(slot, 2 * need);
  L.total_vec = o;
  o = 0;
  CHEETA_TAKE(fK, N * nu * nx); CHEETA_TAKE(fGi, N * nu * nu);
  CHEETA_TAKE(fH, nc ? N * nu * nx : 0); CHEETA_TAKE(fYLi, N * nu * nc);
  CHEETA_TAKE(fLi, N * nc * nc); CHEETA_TAKE(fLiD, N * nc * nu);
  L.total_fac = o;
  return L;
}

#undef CHEETA_TAKE

// Inputs:  A B b Q q R r S C D lg ug mask dx0 Ceq Deq eeq maskeq
// Outputs: dx du s_l s_u lam_l lam_u diag K k P p   (K k P p may be null)
struct IpmArgs {
  const float* in[kNumIn];
  long long in_stride[kNumIn];  // elements between problems (0 = shared)
  float* out[kNumOut];
  long long out_stride[kNumOut];
  float* scratch;  // global factor storage, null = shared memory
  long long scratch_stride;
  long long* timers;  // kNumPhaseSlots per block, null = untimed launch
  IpmDims d;
  IpmParams p;
  Layout L;  // make_layout(d, scratch == null), filled in by the host
};

#ifdef __CUDACC__

// Widest SPD inverse that one warp's registers take (the rotated form);
// wider ones take the block form.
constexpr int kWarpInverseMax = 32;
__host__ __device__ constexpr bool warp_inverse_takes(int n) {
  return n <= kWarpInverseMax;
}

constexpr int kInvMine = 8;  // block form: n * n <= 8 * threads

// The SPD inverses of both forms compute inverse(sym(M)) as
// D (D sym(M) D)^-1 D with the Jacobi scales D = sv = diag(M)^-1/2, which
// the phase that forms M writes (inv_scale) before the barrier that ends
// it: Gauss-Jordan on the compact n x n tableau (slot c of row i: left
// column c until pivot c, right column n + c from then on; these are the
// columns a pivot changes, so the operations are those on [S | I], in the
// same order: ops/cuda_ipm_riccati.py::spd_inverse_gj), with the
// one-hot-shifted pivot column, the pivot row times the pivot's
// reciprocal, and no refinement. Row j times the reciprocal, not divided
// by the pivot: the IEEE division leaves its fast path for a zero or
// subnormal numerator (a sparse G has many), and the whole warp waits for
// the slow one. Both forms apply the same operations to every entry, so
// they give the same bits.

// Block form, for n > kWarpInverseMax: each thread keeps the same few
// entries of the tableau in registers for the whole elimination. One
// barrier per pivot: the owners of row and column j + 1 pass them to the
// next pivot through rowb and colb (two of each, by parity). M and out may
// alias.
static __device__ void block_spd_inverse(const float* M, float* out, int n,
                                         const float* __restrict__ sv,
                                         float* __restrict__ rowb,
                                         float* __restrict__ colb) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float v[kInvMine];
  int ii[kInvMine], cc[kInvMine];
#pragma unroll
  for (int e = 0; e < kInvMine; ++e) {
    const int idx = tid + e * nt;
    ii[e] = idx < n * n ? idx / n : -1;
    cc[e] = idx % n;
    v[e] = 0.f;
    if (ii[e] >= 0) {
      const int i = ii[e], c = cc[e];
      v[e] = sv[i] * (0.5f * (M[i * n + c] + M[c * n + i])) * sv[c];
      if (i == 0) rowb[c] = v[e];
      if (c == 0) colb[i] = v[e] - (i == 0 ? 1.f : 0.f);
    }
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float *rb = rowb + (j & 1) * n, *cb = colb + (j & 1) * n;
    float *rbn = rowb + ((j + 1) & 1) * n, *cbn = colb + ((j + 1) & 1) * n;
    const float ipiv = 1.0f / rb[j];
#pragma unroll
    for (int e = 0; e < kInvMine; ++e) {
      if (ii[e] < 0) continue;
      const int i = ii[e], c = cc[e];
      const float colm = cb[i];
      // Slot j turns into right column n + j, which held e_j: its entry in
      // the pivot row is 1 * ipiv.
      const float nv = c == j ? fmaf(-colm, ipiv, i == j ? 1.f : 0.f)
                              : fmaf(-colm, rb[c] * ipiv, v[e]);
      v[e] = nv;
      if (i == j + 1) rbn[c] = nv;
      if (c == j + 1) cbn[i] = nv - (i == j + 1 ? 1.f : 0.f);
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < kInvMine; ++e)
    if (ii[e] >= 0) out[ii[e] * n + cc[e]] = sv[ii[e]] * v[e] * sv[cc[e]];
  __syncthreads();
}

// Warp form (n <= kMax <= 32), on the lanes of one warp: lane c holds
// column c of the tableau, rotated so that u[t] is row j + t (mod kMax) at
// pivot j. The pivot row is always u[0], so no entry is tested against j
// (a dynamic register index would put the column in local memory). Every
// row's pivot-column entry comes from lane j by shuffles, all in flight
// together; the shifted column subtracts the 1 from the pivot row's entry
// alone. Lane c != j takes rv = T[j][c] * ipiv and each row
// fma(-colm, rv, T[i][c]); lane j (slot j turning into right column
// n + j, which held e_j) takes rv = ipiv and e_j for T. The rows move down
// by one as they are formed. Rows and lanes past n hold zeros, stay zero
// and are not stored, so every n <= kMax gives the same bits at any
// kMax >= n. The pivot loop stays rolled (code size); with kExact,
// n == kMax is known to the compiler, which schedules the loop better.
// M, out and sv are at shared offsets; M and out may alias.
template <int kMax, bool kExact>
static __device__ void warp_spd_inverse(int m_off, int out_off, int sv_off,
                                        int n_) {
  const int n = kExact ? kMax : n_;
  extern __shared__ float smem[];
  const float* M = smem + m_off;
  const float* sv = smem + sv_off;
  const int lane = threadIdx.x & 31;
  const float sc = lane < n ? sv[lane] : 0.f;
  float u[kMax];
#pragma unroll
  for (int t = 0; t < kMax; ++t)
    u[t] = (t < n && lane < n)
               ? sv[t] * (0.5f * (M[t * n + lane] + M[lane * n + t])) * sc
               : 0.f;
  for (int j = 0; j < n; ++j) {
    const bool mine = lane == j;
    float ci[kMax];
#pragma unroll
    for (int t = 0; t < kMax; ++t) ci[t] = __shfl_sync(0xffffffffu, u[t], j);
    const float ipiv = 1.0f / ci[0];
    const float rv = (mine ? 1.0f : u[0]) * ipiv;
    // Row j, then rows j + 1 ... moved down by one as they are formed.
    const float row_j = fmaf(-(ci[0] - 1.f), rv, mine ? 1.f : u[0]);
#pragma unroll
    for (int t = 0; t + 1 < kMax; ++t)
      u[t] = fmaf(-ci[t + 1], rv, mine ? 0.f : u[t + 1]);
    u[kMax - 1] = row_j;
  }
  __syncwarp();  // every lane has read M
  if (lane < n) {
    float* out = smem + out_off;
#pragma unroll
    for (int t = 0; t < kMax; ++t) {
      int i = t + n;  // u[t] is row (t + n) mod kMax
      if (i >= kMax) i -= kMax;
      if (i < n) out[i * n + lane] = sv[i] * u[t] * sc;
    }
  }
}

// The warp form by warp 0 of the block, instantiated exactly at the
// legged and centroidal widths (16 and 24) and once for every other
// n <= kWarpInverseMax; the caller's barrier follows. Not inlined: the
// products' registers and code stay as they are around it.
static __device__ __noinline__ void warp_spd_inverse_n(int m_off,
                                                       int out_off,
                                                       int sv_off, int n) {
  if (threadIdx.x >= 32) return;
  if (n == 16) warp_spd_inverse<16, true>(m_off, out_off, sv_off, n);
  else if (n == 24) warp_spd_inverse<24, true>(m_off, out_off, sv_off, n);
  else warp_spd_inverse<kWarpInverseMax, false>(m_off, out_off, sv_off, n);
}

// out = inverse of sym(M), n x n, in the form that n takes; every array
// lies in the block's shared memory, which starts at s. Ends with the
// block's barrier: the other warps read out.
static __device__ void spd_inverse(const float* s, const float* M,
                                   float* out, int n,
                                   const float* __restrict__ sv,
                                   float* __restrict__ rowb,
                                   float* __restrict__ colb) {
  if (warp_inverse_takes(n)) {
    warp_spd_inverse_n((int)(M - s), (int)(out - s), (int)(sv - s), n);
    __syncthreads();
  } else {
    block_spd_inverse(M, out, n, sv, rowb, colb);
  }
}

// sv entry of the inverse's equilibration, from a diagonal entry of M.
__device__ __forceinline__ float inv_scale(float diag) {
  return 1.0f / sqrtf(fmaxf(diag, 1e-30f));
}

// kFacShared says at compile time whether the Riccati factors live in
// shared memory (else: the global scratch buffer). A pointer that may be
// either is a generic pointer, and every access through it pays 64-bit
// address arithmetic and the generic load path. kEq says whether the
// problem has stage equalities (nc > 0): without them the elimination's
// code is compiled out, since code that a launch never runs still takes
// registers and instruction cache from the phases it does run.
template <bool kFacShared, bool kEq, bool kTimed>
static __device__ void ipm_solve(const IpmArgs& a, float* smem) {
  PhaseClock<kTimed, kNumPhases> clk;
  const IpmDims d = a.d;
  const IpmParams pa = a.p;
  const int N = d.N, N1 = d.N + 1, nx = d.nx, nu = d.nu, ng = d.ng,
            nc = kEq ? d.nc : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long prob = blockIdx.x;
  // The layout lives in the launch parameters, so its offsets are constant
  // operands rather than registers.
  const Layout& L = a.L;

  // An absent array has a null pointer and stride 0, and stays null.
  auto in = [&](int i) { return a.in[i] + prob * a.in_stride[i]; };
  float* out[kNumOut];
  for (int i = 0; i < kNumOut; ++i)
    out[i] = a.out[i] + prob * a.out_stride[i];
  // The inputs are read-only and overlap nothing the kernel writes; saying
  // so lets their loads move ahead of stores to shared memory.
  typedef const float* __restrict__ In;
  In gA = in(0), gB = in(1), gb = in(2), gQ = in(3), gq = in(4), gR = in(5),
     gr = in(6), gS = in(7), gC = in(8), gD = in(9), glg = in(10),
     gug = in(11), gm = in(12), gdx0 = in(13), gCe = in(14), gDe = in(15),
     ge = in(16), gme = in(17);

  float* s = smem;
  float *sl = s + L.sl, *su = s + L.su, *ll = s + L.ll, *lu = s + L.lu,
        *dsl = s + L.dsl, *dsu = s + L.dsu, *dll = s + L.dll,
        *dlu = s + L.dlu, *g = s + L.g, *ln = s + L.ln, *w = s + L.w,
        *m = s + L.m, *lg = s + L.lg, *ug = s + L.ug;
  float *dx = s + L.dx, *ddx = s + L.ddx, *p = s + L.p, *qb = s + L.qb,
        *cs = s + L.cs, *xt = s + L.xt, *prd = s + L.prd, *rd = s + L.rd;
  float *du = s + L.du, *ddu = s + L.ddu, *kv = s + L.kv, *rb = s + L.rb,
        *ut = s + L.ut, *re = s + L.re;
  float *rx0 = s + L.rx0, *rhs = s + L.rhs, *tu = s + L.tu, *nuv = s + L.nuv,
        *nu0 = s + L.nu0;
  float *PA = s + L.PA, *PB = s + L.PB, *G = s + L.G, *Hw = s + L.Hk,
        *Gt = s + L.Gt, *Kw = s + L.Kw, *Ww = s + L.Ww;
  float *Y = s + L.Y, *T = s + L.T, *T2 = s + L.T2, *Lam = s + L.Lam,
        *Liw = s + L.Liw, *YLiw = s + L.YLiw, *red = s + L.red;
  float *sv = s + L.sv, *rowb = s + L.rowb, *colb = s + L.colb;
  auto slot_of = [&](int i) { return s + L.slot + (i & 1) * L.slot_size; };
  float* fac;
  if (kFacShared) fac = s + L.total_vec;
  else fac = a.scratch + prob * a.scratch_stride;
  float *fK = fac + L.fK, *fGi = fac + L.fGi, *fH = fac + L.fH,
        *fYLi = fac + L.fYLi, *fLi = fac + L.fLi, *fLiD = fac + L.fLiD;
  const int ab = nx * nx + nx * nu;  // A, B lead every slot
  // The stage-serial sweeps stream their stages through sub-slots of the
  // slot region: three (the copies run two stages ahead, which the short
  // stages of a sweep need to hide a round trip to L2) where they fit,
  // else two. dep is how many stages ahead.
  const int gl = kFacShared ? 0 : 1;
  const int stat_need = ab + nc * nx + nc * nu + gl * nc * nu;
  const int bwd_need = ab + nc * nx +
                       gl * (nc ? nu * nu + nu * nx + nu * nc + nc * nc
                                : nu * nx + nu * nu);
  const int newton_need =
      bwd_need > ab + gl * nu * nx ? bwd_need : ab + gl * nu * nx;
  auto depth_for = [&](int need) {
    return 3 * need <= 2 * L.slot_size ? 2 : 1;
  };
  auto sub_slot = [&](int i, int need, int dep) {
    return s + L.slot + (i % (dep + 1)) * need;
  };

  // ---- initialization (zero iterate, so g(0, 0) = 0) ----------------------
  float msum = 0.f;
  for (int i = tid; i < N1 * ng; i += nt) {
    const float mk = gm[i], lo = glg[i], hi = gug[i];
    m[i] = mk; lg[i] = lo; ug[i] = hi;
    const float a0 = mk > 0.f ? nan_max(-lo, pa.s0_min) : 1.f;
    const float b0 = mk > 0.f ? nan_max(hi, pa.s0_min) : 1.f;
    sl[i] = a0; su[i] = b0;
    ll[i] = mk > 0.f ? pa.mu0 / a0 : 0.f;
    lu[i] = mk > 0.f ? pa.mu0 / b0 : 0.f;
    dsl[i] = 0.f; dsu[i] = 0.f; dll[i] = 0.f; dlu[i] = 0.f;
    msum += mk;
  }
  for (int i = tid; i < N1 * nx; i += nt) { dx[i] = 0.f; ddx[i] = 0.f; }
  for (int i = tid; i < N * nu; i += nt) { du[i] = 0.f; ddu[i] = 0.f; }
  const float n_active = fmaxf(block_reduce<kSum>(msum, red), 1.f);
  clk.mark(kPhElementwise);

  // Least-squares equality-dual operator of the stationarity metric:
  // LiD_k = (De De' + diag(1 - mask))^-1 De.
  for (int k = 0; k < N && nc; ++k) {
    In De = gDe + (size_t)k * nc * nu;
    for (int idx = tid; idx < nc * nc; idx += nt) {
      const int i = idx / nc, j = idx % nc;
      float acc = i == j ? 1.f - gme[k * nc + i] : 0.f;
      for (int l = 0; l < nu; ++l) acc = fmaf(De[i * nu + l], De[j * nu + l], acc);
      Lam[idx] = acc;
      if (i == j) sv[i] = inv_scale(acc);
    }
    __syncthreads();
    clk.mark(kPhProducts);
    spd_inverse(s, Lam, Liw, nc, sv, rowb, colb);
    clk.mark(kPhInverse);
    float* LiD = fLiD + (size_t)k * nc * nu;
    for (int idx = tid; idx < nc * nu; idx += nt) {
      const int i = idx / nu, j = idx % nu;
      float acc = 0.f;
      for (int l = 0; l < nc; ++l) acc = fmaf(Liw[i * nc + l], De[l * nu + j], acc);
      LiD[idx] = acc;
    }
    __syncthreads();
    clk.mark(kPhProducts);
  }

  // qb <- q + Q x + S' u + C' ln ; rb <- r + R u + S x + D' ln, all stages.
  // The row products (Q x, R u, S x) split each row over a lane group; the
  // column products (C' ln, S' u, D' ln) take one output per thread, so
  // that a warp reads 32 consecutive words of a row of C, S or D.
  auto gradients = [&](const float* x, const float* u) {
    rows(N1 * nx + N * nu,
         [&](int o, int sub) {
           if (o < N1 * nx) {
             const int k = o / nx;
             return pdot(gQ + (size_t)o * nx, 1, x + k * nx, nx, sub);
           }
           const int oo = o - N1 * nx, k = oo / nu;
           return pdot(gR + (size_t)oo * nu, 1, u + k * nu, nu, sub) +
                  pdot(gS + (size_t)oo * nx, 1, x + k * nx, nx, sub);
         },
         [&](int o, float acc) {
           if (o < N1 * nx) qb[o] = gq[o] + acc;
           else rb[o - N1 * nx] = gr[o - N1 * nx] + acc;
         });
    for (int o = tid; o < N1 * nx + N * nu; o += nt) {
      float acc = 0.f;
      if (o < N1 * nx) {
        const int k = o / nx, i = o % nx;
        In Ck = gC + (size_t)k * ng * nx + i;
        const float* lk = ln + k * ng;
#pragma unroll 8
        for (int r = 0; r < ng; ++r) acc = fmaf(Ck[(size_t)r * nx], lk[r], acc);
        if (k < N) {
          In Sk = gS + (size_t)k * nu * nx + i;
          const float* uk = u + k * nu;
#pragma unroll 8
          for (int j = 0; j < nu; ++j) acc = fmaf(Sk[(size_t)j * nx], uk[j], acc);
        }
        qb[o] += acc;
      } else {
        const int oo = o - N1 * nx, k = oo / nu, j = oo % nu;
        In Dk = gD + (size_t)k * ng * nu + j;
        const float* lk = ln + k * ng;
#pragma unroll 8
        for (int r = 0; r < ng; ++r) acc = fmaf(Dk[(size_t)r * nu], lk[r], acc);
        rb[oo] += acc;
      }
    }
    __syncthreads();
    clk.mark(kPhGradients);
  };

  // ---- stationarity ---------------------------------------------------------
  // Slot contents: A, B, then Ce, De and (global factors) LiD.
  auto stat_issue = [&](int k, float* st) {
    copy_async(st, gA + (size_t)k * nx * nx, nx * nx);
    copy_async(st + nx * nx, gB + (size_t)k * nx * nu, nx * nu);
    if (nc) {
      copy_async(st + ab, gCe + (size_t)k * nc * nx, nc * nx);
      copy_async(st + ab + nc * nx, gDe + (size_t)k * nc * nu, nc * nu);
      if (!kFacShared)
        copy_async(st + ab + nc * nx + nc * nu, fLiD + (size_t)k * nc * nu,
                   nc * nu);
    }
  };

  // Input-space KKT stationarity (inf-norm) at state + alpha * direction:
  // adjoint recursion with least-squares equality duals.
  auto stat_at = [&](float alpha) -> float {
    const int dep = depth_for(stat_need);
    for (int q = 0; q < dep; ++q) {
      if (q < N) stat_issue(N - 1 - q, sub_slot(q, stat_need, dep));
      cp_async_commit();
    }
    for (int i = tid; i < N1 * ng; i += nt)
      ln[i] = m[i] * ((lu[i] + alpha * dlu[i]) - (ll[i] + alpha * dll[i]));
    for (int i = tid; i < N1 * nx; i += nt) xt[i] = dx[i] + alpha * ddx[i];
    for (int i = tid; i < N * nu; i += nt) ut[i] = du[i] + alpha * ddu[i];
    __syncthreads();
    clk.mark(kPhElementwise);
    gradients(xt, ut);
    for (int i = tid; i < nx; i += nt) cs[N * nx + i] = qb[N * nx + i];
    cp_async_wait(dep - 1);
    __syncthreads();
    clk.mark(kPhStage);
    float smax = 0.f;
    for (int k = N - 1; k >= 0; --k) {
      const int sidx = N - 1 - k;
      const float* st = sub_slot(sidx, stat_need, dep);
      if (k - dep >= 0)
        stat_issue(k - dep, sub_slot(sidx + dep, stat_need, dep));
      cp_async_commit();
      const float *Ak = st, *Bk = st + nx * nx;
      const float* cn = cs + (k + 1) * nx;
      if (nc == 0) {
        rows(nu + nx,
             [&](int o, int sub) {
               return o < nu ? pdot(Bk + o, nu, cn, nx, sub)
                             : pdot(Ak + (o - nu), nx, cn, nx, sub);
             },
             [&](int o, float acc) {
               if (o < nu) smax = nan_max(smax, fabsf(rb[k * nu + o] + acc));
               else cs[k * nx + o - nu] = qb[k * nx + o - nu] + acc;
             },
             WaitCopies{dep - 1});
        clk.mark(kPhSweeps);
      } else {
        const float *Ce = Bk + nx * nu, *De = Ce + nc * nx;
        const float* LiD =
            kFacShared ? fLiD + (size_t)k * nc * nu : De + nc * nu;
        rows(nu, [&](int o, int sub) { return pdot(Bk + o, nu, cn, nx, sub); },
             [&](int o, float acc) { tu[o] = rb[k * nu + o] + acc; });
        rows(nc,
             [&](int o, int sub) { return pdot(LiD + o * nu, 1, tu, nu, sub); },
             [&](int o, float acc) { nuv[o] = -acc; });
        rows(nu + nx,
             [&](int o, int sub) {
               return o < nu ? pdot(De + o, nu, nuv, nc, sub)
                             : pdot(Ak + (o - nu), nx, cn, nx, sub) +
                                   pdot(Ce + (o - nu), nx, nuv, nc, sub);
             },
             [&](int o, float acc) {
               if (o < nu) smax = nan_max(smax, fabsf(tu[o] + acc));
               else cs[k * nx + o - nu] = qb[k * nx + o - nu] + acc;
             },
             WaitCopies{dep - 1});
        clk.mark(kPhSweeps);
      }
    }
    const float r = block_reduce<kMax>(smax, red);
    clk.mark(kPhElementwise);
    return r;
  };

  // ---- factorization --------------------------------------------------------
  // Slot contents: A, B, C, D, Ce, De, Q, R, S of one stage.
  const int fq = ab + ng * nx + ng * nu + nc * nx + nc * nu;  // Q's offset
  auto fac_issue = [&](int k, float* st) {
    copy_async(st, gA + (size_t)k * nx * nx, nx * nx);
    copy_async(st + nx * nx, gB + (size_t)k * nx * nu, nx * nu);
    copy_async(st + ab, gC + (size_t)k * ng * nx, ng * nx);
    copy_async(st + ab + ng * nx, gD + (size_t)k * ng * nu, ng * nu);
    if (nc) {
      float* se = st + ab + ng * nx + ng * nu;
      copy_async(se, gCe + (size_t)k * nc * nx, nc * nx);
      copy_async(se + nc * nx, gDe + (size_t)k * nc * nu, nc * nu);
    }
    copy_async(st + fq, gQ + (size_t)k * nx * nx, nx * nx);
    copy_async(st + fq + nx * nx, gR + (size_t)k * nu * nu, nu * nu);
    copy_async(st + fq + nx * nx + nu * nu, gS + (size_t)k * nu * nx,
               nu * nx);
  };

  // Backward Riccati with the barrier-augmented Hessian blocks
  // Qb = Q + C' diag(w) C (and Rb, Sb with D) and exact elimination of the
  // masked stage equalities; stores K, G^-1 (W with equalities)
  // (+ H, Y Lam^-1, Lam^-1) and prd_k = P_{k+1} rd_k.
  auto factorize = [&]() {
    fac_issue(N - 1, slot_of(0));
    for (int i = tid; i < N1 * ng; i += nt)
      w[i] = m[i] * nan_min(ll[i] / sl[i] + lu[i] / su[i], pa.w_max);
    __syncthreads();
    clk.mark(kPhElementwise);
    float* Pn = s + L.P0;  // P_{k+1}
    float* Pk = s + L.P1;  // P_k; the two buffers swap after each stage
    float* gP = out[9];    // value-function Hessians, if asked for
    {
      In QN = gQ + (size_t)N * nx * nx;
      In CN = gC + (size_t)N * ng * nx;
      const float* wN = w + N * ng;
      auto init = [&](int i, int j) {
        return 0.5f * (QN[i * nx + j] + QN[j * nx + i]);
      };
      auto a = [&](int i, int l) { return CN[l * nx + i] * wN[l]; };
      auto b = [&](int l, int j) { return CN[l * nx + j]; };
      auto store = [&](int i, int j, float v) {
        Pn[i * nx + j] = v;
        if (gP) gP[(size_t)N * nx * nx + i * nx + j] = v;
      };
      if constexpr (kEq) tile_product<4, 4>(tid, nt, nx, nx, ng, init, a, b, store);
      else sym_tile_product<3>(tid, nt, nx, ng, init, a, b, store);
      cp_async_wait_all();
      __syncthreads();
      clk.mark(kPhProducts);
    }
    for (int k = N - 1; k >= 0; --k) {
      const int sidx = N - 1 - k;
      const float* st = slot_of(sidx);
      // With equalities the next stage's copies go out after G's inverse.
      if (nc == 0 && k > 0) fac_issue(k - 1, slot_of(sidx + 1));
      const float *Ak = st, *Bk = st + nx * nx, *Ck = st + ab,
                  *Dk = Ck + ng * nx, *Cek = Dk + ng * nu,
                  *Dek = Cek + nc * nx;
      const float *Qk = st + fq, *Rk = Qk + nx * nx, *Sk = Rk + nu * nu;
      const float* wk = w + k * ng;
      // Where the products read this stage's factors: the factor store
      // itself in shared memory, else the work copies; a global store is
      // written beside them.
      float* Kk = fK + (size_t)k * nu * nx;
      float* Gik = fGi + (size_t)k * nu * nu;  // G^-1, or W with equalities
      float* Ks = kFacShared ? Kk : Kw;
      float* Hs = (kFacShared && nc) ? fH + (size_t)k * nu * nx : Hw;
      {  // PA = P_{k+1} A, PB = P_{k+1} B, prd_k = P_{k+1} rd_k
        const int n_pa = tiles_of(nx, nx, 4, 4), n_pb = tiles_of(nx, nu, 4, 4);
        PhaseSplit ph(n_pa + n_pb + nx);
        tile_product<4, 4>(
            ph.first(n_pa), ph.step(n_pa), nx, nx, nx,
            [&](int, int) { return 0.f; },
            [&](int i, int l) { return Pn[i * nx + l]; },
            [&](int l, int j) { return Ak[l * nx + j]; },
            [&](int i, int j, float v) { PA[i * nx + j] = v; });
        tile_product<4, 4>(
            ph.first(n_pb), ph.step(n_pb), nx, nu, nx,
            [&](int, int) { return 0.f; },
            [&](int i, int l) { return Pn[i * nx + l]; },
            [&](int l, int j) { return Bk[l * nu + j]; },
            [&](int i, int j, float v) { PB[i * nu + j] = v; });
        for (int i = ph.first(nx); i < nx; i += ph.step(nx)) {
          float acc = 0.f;
          for (int l = 0; l < nx; ++l)
            acc = fmaf(Pn[i * nx + l], rd[k * nx + l], acc);
          prd[k * nx + i] = acc;
        }
      }
      __syncthreads();
      clk.mark(kPhProducts);
      {  // G = Rb + B'PB + reg I ; H = Sb + B'PA ; Pk = Qb + A'PA (+ H'K later)
        const int n_g = tiles_of(nu, nu, 4, 4), n_h = tiles_of(nu, nx, 4, 4),
                  n_p = kEq ? tiles_of(nx, nx, 4, 4) : sym_tiles_of(nx, 3);
        PhaseSplit ph(n_g + n_h + n_p);
        // The sum runs over the ng weighted constraint rows, then over nx.
        tile_product2<4, 4>(
            ph.first(n_g), ph.step(n_g), nu, nu,
            [&](int i, int j) {
              return Rk[i * nu + j] + (i == j ? pa.reg : 0.f);
            },
            ng, [&](int i, int l) { return Dk[l * nu + i] * wk[l]; },
            [&](int l, int j) { return Dk[l * nu + j]; },
            nx, [&](int i, int l) { return Bk[l * nu + i]; },
            [&](int l, int j) { return PB[l * nu + j]; },
            [&](int i, int j, float v) {
              G[i * nu + j] = v;
              if (i == j) sv[i] = inv_scale(v);
            });
        tile_product2<4, 4>(
            ph.first(n_h), ph.step(n_h), nu, nx,
            [&](int i, int j) { return Sk[i * nx + j]; },
            ng, [&](int i, int l) { return Dk[l * nu + i] * wk[l]; },
            [&](int l, int j) { return Ck[l * nx + j]; },
            nx, [&](int i, int l) { return Bk[l * nu + i]; },
            [&](int l, int j) { return PA[l * nx + j]; },
            [&](int i, int j, float v) {
              Hs[i * nx + j] = v;
              if (!kFacShared && nc) fH[(size_t)k * nu * nx + i * nx + j] = v;
            });
        // With equalities P is symmetrized after the elimination, so its
        // products stay whole; without them they are computed on and above
        // the diagonal and stored mirrored (no symmetrization phase).
        auto a = [&](int i, int l) { return Ck[l * nx + i] * wk[l]; };
        auto b = [&](int l, int j) { return Ck[l * nx + j]; };
        auto a2 = [&](int i, int l) { return Ak[l * nx + i]; };
        auto b2 = [&](int l, int j) { return PA[l * nx + j]; };
        auto store = [&](int i, int j, float v) { Pk[i * nx + j] = v; };
        if constexpr (kEq)
          tile_product2<4, 4>(
              ph.first(n_p), ph.step(n_p), nx, nx,
              [&](int i, int j) { return Qk[i * nx + j]; }, ng, a, b, nx, a2,
              b2, store);
        else
          sym_tile_product2<3>(
              ph.first(n_p), ph.step(n_p), nx,
              [&](int i, int j) {
                return 0.5f * (Qk[i * nx + j] + Qk[j * nx + i]);
              },
              ng, a, b, nx, a2, b2, store);
      }
      __syncthreads();
      clk.mark(kPhProducts);
      if (nc == 0) {
        float* Gis = kFacShared ? Gik : Gt;
        spd_inverse(s, G, Gis, nu, sv, rowb, colb);
        clk.mark(kPhInverse);
        // K and H'K have the short sums (nu terms): small tiles, so that
        // more threads share them and each chain is short.
        tile_product<2, 2>(
            tid, nt, nu, nx, nu,
            [&](int, int) { return 0.f; },
            [&](int i, int l) { return Gis[i * nu + l]; },
            [&](int l, int j) { return Hs[l * nx + j]; },
            [&](int i, int j, float v) {
              Ks[i * nx + j] = -v;
              if (!kFacShared) Kk[i * nx + j] = -v;
            });
        if (!kFacShared)
          for (int i = tid; i < nu * nu; i += nt) Gik[i] = Gis[i];
        __syncthreads();
        clk.mark(kPhProducts);
        // Pk += H'K, symmetric as it is stored: no symmetrization phase.
        sym_tile_product<3>(
            tid, nt, nx, nu,
            [&](int i, int j) { return Pk[i * nx + j]; },
            [&](int i, int l) { return Hs[l * nx + i]; },
            [&](int l, int j) { return Ks[l * nx + j]; },
            [&](int i, int j, float v) { Pk[i * nx + j] = v; });
      } else {
        // The equality elimination, reassociated around Z = G^-1 H and
        // T = Ce - Y'H (W = G^-1 - YLi Y', T2 = Li T): K = -(W H + YLi Ce)
        // = -(Z + YLi T) and H'K + Ce'T2 = -H'Z + T'T2. Small products (nc
        // rows), one output per thread, every operand in shared memory;
        // four barrier phases (E1, E2, E4, E5), and T and H'Z beside Lam's
        // inverse (E3). Y is kept transposed (Yt = Y', nc x nu), so that
        // W's sum reads it along rows. Z takes PA's buffer, running on into
        // PB's where nu > nx: both are dead until the next stage's PA.
        float* YLik = fYLi + (size_t)k * nu * nc;
        float* Lik = fLi + (size_t)k * nc * nc;
        float* YLis = kFacShared ? YLik : YLiw;
        float* Lis = kFacShared ? Lik : Liw;
        float* Ws = kFacShared ? Gik : Ww;
        float *Yt = Y, *Z = PA;
        spd_inverse(s, G, Gt, nu, sv, rowb, colb);
        clk.mark(kPhInverse);
        // Issued here, not at the stage's start: with this schedule that
        // measured faster (PERF.md, section 6).
        if (k > 0) fac_issue(k - 1, slot_of(sidx + 1));
        // E1: Y = G^-1 De' ; Z = G^-1 H
        for (int idx = tid; idx < nu * nc + nu * nx; idx += nt) {
          if (idx < nu * nc) {
            const int i = idx / nc, r = idx % nc;
            float acc = 0.f;
            for (int l = 0; l < nu; ++l)
              acc = fmaf(Gt[i * nu + l], Dek[r * nu + l], acc);
            Yt[r * nu + i] = acc;
          } else {
            const int e = idx - nu * nc, i = e / nx, j = e % nx;
            float acc = 0.f;
            for (int l = 0; l < nu; ++l)
              acc = fmaf(Gt[i * nu + l], Hs[l * nx + j], acc);
            Z[e] = acc;
          }
        }
        __syncthreads();
        clk.mark(kPhProducts);
        // E2: Lam = De Y + E
        for (int idx = tid; idx < nc * nc; idx += nt) {
          const int r = idx / nc, c = idx % nc;
          float acc = r == c ? pa.eps * (1.f - gme[k * nc + r]) : 0.f;
          for (int l = 0; l < nu; ++l)
            acc = fmaf(Dek[r * nu + l], Yt[c * nu + l], acc);
          Lam[idx] = acc;
          if (r == c) sv[r] = inv_scale(acc);
        }
        __syncthreads();
        clk.mark(kPhProducts);
        // E3: Lam^-1, by warp 0 where the warp form takes it, and beside
        // it T = Ce - Y'H and Pk <- Pk - H'Z (Qb + A'PA - H'Z) by the warps
        // that do not share warp 0's scheduler (warp w issues on scheduler
        // w % 4); else the block inverts Lam and then takes T and H'Z.
        const bool beside = warp_inverse_takes(nc) && nt > 32;
        if (!beside) spd_inverse(s, Lam, Lis, nc, sv, rowb, colb);
        if (beside && (tid >> 5) % 4 == 0) {
          if (tid < 32)
            warp_spd_inverse_n((int)(Lam - s), (int)(Lis - s), (int)(sv - s),
                               nc);
        } else {
          const int w = tid >> 5, nw = nt >> 5;
          const int t0 = beside ? (w - 1 - w / 4) * 32 + (tid & 31) : tid;
          const int nth = beside ? (nw - (nw + 3) / 4) * 32 : nt;
          for (int idx = t0; idx < nx * nx + nc * nx; idx += nth) {
            if (idx < nx * nx) {
              const int i = idx / nx, j = idx % nx;
              float acc = Pk[idx];
              for (int l = 0; l < nu; ++l)
                acc = fmaf(-Hs[l * nx + i], Z[l * nx + j], acc);
              Pk[idx] = acc;
            } else {
              const int e = idx - nx * nx, r = e / nx, j = e % nx;
              float acc = 0.f;
              for (int l = 0; l < nu; ++l)
                acc = fmaf(Yt[r * nu + l], Hs[l * nx + j], acc);
              T[e] = Cek[e] - acc;
            }
          }
        }
        __syncthreads();  // E4 reads T
        clk.mark(kPhInverse);
        // E4: YLi = Y Li ; T2 = Li T
        for (int idx = tid; idx < nu * nc + nc * nx; idx += nt) {
          if (idx < nu * nc) {
            const int i = idx / nc, r = idx % nc;
            float acc = 0.f;
            for (int l = 0; l < nc; ++l)
              acc = fmaf(Yt[l * nu + i], Lis[l * nc + r], acc);
            YLis[idx] = acc;
            if (!kFacShared) YLik[idx] = acc;
          } else {
            const int e = idx - nu * nc, r = e / nx, j = e % nx;
            float acc = 0.f;
            for (int c = 0; c < nc; ++c)
              acc = fmaf(Lis[r * nc + c], T[c * nx + j], acc);
            T2[e] = acc;
          }
        }
        if (!kFacShared)
          for (int i = tid; i < nc * nc; i += nt) Lik[i] = Lis[i];
        __syncthreads();
        clk.mark(kPhProducts);
        // E5: W = G^-1 - YLi Y' ; K = -(Z + YLi T) ; Pk <- sym(Pk + T'T2),
        // symmetric as stored: the pair (i, j), (j, i) of i <= j in one
        // thread, both sums side by side, their mean stored at both places.
        // Pairs come two rows at a time, rows a and nx - 1 - a (nx + 1
        // pairs), so a warp reads neighbouring columns.
        const int npair = nx * (nx + 1) / 2;
        for (int idx = tid; idx < nu * nu + nu * nx + npair; idx += nt) {
          if (idx < nu * nu) {
            const int i = idx / nu, j = idx % nu;
            float acc = 0.f;
            for (int r = 0; r < nc; ++r)
              acc = fmaf(YLis[i * nc + r], Yt[r * nu + j], acc);
            const float wv = Gt[idx] - acc;
            Ws[idx] = wv;
            if (!kFacShared) Gik[idx] = wv;
          } else if (idx < nu * nu + nu * nx) {
            const int e = idx - nu * nu, i = e / nx, j = e % nx;
            float acc = Z[e];
            for (int r = 0; r < nc; ++r)
              acc = fmaf(YLis[i * nc + r], T[r * nx + j], acc);
            Ks[e] = -acc;
            if (!kFacShared) Kk[e] = -acc;
          } else {
            const int q = idx - nu * nu - nu * nx, a = q / (nx + 1),
                      c = q % (nx + 1);
            const bool lo = c < nx - a;
            const int i = lo ? a : nx - 1 - a, j = lo ? a + c : c - 1;
            float vij = Pk[i * nx + j], vji = Pk[j * nx + i];
            for (int r = 0; r < nc; ++r) {
              vij = fmaf(T[r * nx + i], T2[r * nx + j], vij);
              vji = fmaf(T[r * nx + j], T2[r * nx + i], vji);
            }
            const float v = 0.5f * (vij + vji);
            Pk[i * nx + j] = v;
            Pk[j * nx + i] = v;
          }
        }
      }
      cp_async_wait_all();  // the next stage's slot
      __syncthreads();
      clk.mark(kPhProducts);
      if (gP) {
        for (int idx = tid; idx < nx * nx; idx += nt)
          gP[(size_t)k * nx * nx + idx] = Pk[idx];
      }
      float* swap = Pn;
      Pn = Pk;
      Pk = swap;
    }
  };

  // ---- Newton direction -----------------------------------------------------
  // The backward pass (s = 0 .. N-1, stage N-1-s) and the forward rollout
  // (s = N .. 2N-1, stage s-N) are one stream of 2N stages through the
  // sub-slots. Backward stage: A, B, Ce, then (global factors) K, G^-1 or
  // W, H, Y Lam^-1, Lam^-1; forward stage: A, B, then (global factors) K.
  auto newton_issue = [&](int sidx, float* st) {
    const bool back = sidx < N;
    const int k = back ? N - 1 - sidx : sidx - N;
    copy_async(st, gA + (size_t)k * nx * nx, nx * nx);
    copy_async(st + nx * nx, gB + (size_t)k * nx * nu, nx * nu);
    if (back) {
      float* o = st + ab;
      if (nc) {
        copy_async(o, gCe + (size_t)k * nc * nx, nc * nx);
        o += nc * nx;
      }
      if (!kFacShared) {
        if (nc == 0) {
          copy_async(o, fK + (size_t)k * nu * nx, nu * nx);
          copy_async(o + nu * nx, fGi + (size_t)k * nu * nu, nu * nu);
        } else {
          copy_async(o, fGi + (size_t)k * nu * nu, nu * nu);
          o += nu * nu;
          copy_async(o, fH + (size_t)k * nu * nx, nu * nx);
          o += nu * nx;
          copy_async(o, fYLi + (size_t)k * nu * nc, nu * nc);
          copy_async(o + nu * nc, fLi + (size_t)k * nc * nc, nc * nc);
        }
      }
    } else if (!kFacShared) {
      copy_async(st + ab, fK + (size_t)k * nu * nx, nu * nx);
    }
  };

  // One Newton direction against the stored factors for the complementarity
  // right-hand sides rc_l, rc_u: m (s l) in the predictor, m (s l + ds dl -
  // sigma mu) in the corrector (ds, dl: the predictor's). Backward vector
  // pass, forward rollout, slack and dual directions.
  auto newton = [&](bool corr, float sigma, float mu) {
    auto rcl_at = [&](int i) {
      return corr ? m[i] * (sl[i] * ll[i] + dsl[i] * dll[i] - sigma * mu)
                  : m[i] * (sl[i] * ll[i]);
    };
    auto rcu_at = [&](int i) {
      return corr ? m[i] * (su[i] * lu[i] + dsu[i] * dlu[i] - sigma * mu)
                  : m[i] * (su[i] * lu[i]);
    };
    const int dep = depth_for(newton_need);
    for (int q = 0; q < dep; ++q) {
      if (q < 2 * N) newton_issue(q, sub_slot(q, newton_need, dep));
      cp_async_commit();
    }
    for (int i = tid; i < N1 * ng; i += nt) {
      const float rl = g[i] - sl[i] - lg[i], ru = g[i] + su[i] - ug[i];
      const float beta =
          m[i] * ((ll[i] / sl[i]) * rl + (lu[i] / su[i]) * ru +
                  rcl_at(i) / sl[i] - rcu_at(i) / su[i]);
      ln[i] = m[i] * (lu[i] - ll[i] + beta);
    }
    for (int i = tid; i < nx; i += nt) ddx[i] = rx0[i];
    __syncthreads();
    clk.mark(kPhElementwise);
    gradients(dx, du);
    for (int i = tid; i < nx; i += nt) p[N * nx + i] = qb[N * nx + i];
    cp_async_wait(dep - 1);
    __syncthreads();
    clk.mark(kPhStage);
    for (int sidx = 0; sidx < 2 * N; ++sidx) {
      const float* st = sub_slot(sidx, newton_need, dep);
      if (sidx + dep < 2 * N)
        newton_issue(sidx + dep, sub_slot(sidx + dep, newton_need, dep));
      cp_async_commit();
      const float *Ak = st, *Bk = st + nx * nx;
      if (sidx < N) {
        const int k = N - 1 - sidx;
        const float* pn = p + (k + 1) * nx;  // with prd_k: m = p_{k+1} + prd_k
        const float* pr = prd + k * nx;
        rows(nu,
             [&](int o, int sub) { return pdot2(Bk + o, nu, pn, pr, nx, sub); },
             [&](int o, float acc) { rhs[o] = rb[k * nu + o] + acc; });
        clk.mark(kPhSweeps);
        if (nc == 0) {
          const float* Kk = kFacShared ? fK + (size_t)k * nu * nx : st + ab;
          const float* Gik =
              kFacShared ? fGi + (size_t)k * nu * nu : st + ab + nu * nx;
          rows(nu + nx,
               [&](int o, int sub) {
                 return o < nu ? pdot(Gik + o * nu, 1, rhs, nu, sub)
                               : pdot2(Ak + (o - nu), nx, pn, pr, nx, sub) +
                                     pdot(Kk + (o - nu), nx, rhs, nu, sub);
               },
               [&](int o, float acc) {
                 if (o < nu) kv[k * nu + o] = -acc;
                 else p[k * nx + o - nu] = qb[k * nx + o - nu] + acc;
               },
               WaitCopies{dep - 1});
          clk.mark(kPhSweeps);
        } else {
          const float* Ce = st + ab;
          const float* fs = Ce + nc * nx;  // factors in the slot
          const float* Wk = kFacShared ? fGi + (size_t)k * nu * nu : fs;
          const float* Hk =
              kFacShared ? fH + (size_t)k * nu * nx : fs + nu * nu;
          const float* YLi = kFacShared ? fYLi + (size_t)k * nu * nc
                                        : fs + nu * nu + nu * nx;
          const float* Li = kFacShared ? fLi + (size_t)k * nc * nc
                                       : fs + nu * nu + nu * nx + nu * nc;
          const float* rek = re + k * nc;  // h = -r_eq
          rows(nu + nc,
               [&](int o, int sub) {
                 return o < nu ? pdot(Wk + o * nu, 1, rhs, nu, sub) +
                                     pdot(YLi + o * nc, 1, rek, nc, sub)
                               : pdot(YLi + (o - nu), nc, rhs, nu, sub) -
                                     pdot(Li + (o - nu) * nc, 1, rek, nc, sub);
               },
               [&](int o, float acc) {
                 if (o < nu) kv[k * nu + o] = -acc;
                 else nu0[o - nu] = -acc;
               });
          clk.mark(kPhSweeps);
          rows(nx,
               [&](int o, int sub) {
                 return pdot2(Ak + o, nx, pn, pr, nx, sub) +
                        pdot(Hk + o, nx, kv + k * nu, nu, sub) +
                        pdot(Ce + o, nx, nu0, nc, sub);
               },
               [&](int o, float acc) { p[k * nx + o] = qb[k * nx + o] + acc; },
               WaitCopies{dep - 1});
          clk.mark(kPhSweeps);
        }
      } else {
        const int k = sidx - N;
        const float* Kk = kFacShared ? fK + (size_t)k * nu * nx : st + ab;
        rows(nu,
             [&](int o, int sub) {
               return pdot(Kk + o * nx, 1, ddx + k * nx, nx, sub);
             },
             [&](int o, float acc) { ddu[k * nu + o] = acc + kv[k * nu + o]; });
        clk.mark(kPhSweeps);
        rows(nx,
             [&](int o, int sub) {
               return pdot(Ak + o * nx, 1, ddx + k * nx, nx, sub) +
                      pdot(Bk + o * nu, 1, ddu + k * nu, nu, sub);
             },
             [&](int o, float acc) {
               ddx[(k + 1) * nx + o] = acc + rd[k * nx + o];
             },
             WaitCopies{dep - 1});
        clk.mark(kPhSweeps);
      }
    }
    // Constraint rows of the direction, and from them the slack and dual
    // directions (rc_l, rc_u read before ds, dl are overwritten).
    rows(N1 * ng,
         [&](int o, int sub) {
           const int k = o / ng;
           float acc = pdot(gC + (size_t)o * nx, 1, ddx + k * nx, nx, sub);
           if (k < N)
             acc += pdot(gD + (size_t)o * nu, 1, ddu + k * nu, nu, sub);
           return acc;
         },
        [&](int i, float gi) {
           const float rl = g[i] - sl[i] - lg[i], ru = g[i] + su[i] - ug[i];
           const float rcl = rcl_at(i), rcu = rcu_at(i);
           const float ds_l = m[i] * (gi + rl);
           const float ds_u = m[i] * (-gi - ru);
           dsl[i] = ds_l; dsu[i] = ds_u;
           dll[i] = -m[i] * (rcl + ll[i] * ds_l) / sl[i];
           dlu[i] = -m[i] * (rcu + lu[i] * ds_u) / su[i];
         });
    clk.mark(kPhBulk);
  };

  // Largest alpha <= 1 keeping slacks and duals inside the
  // fraction-to-boundary rule on active rows.
  auto step_length = [&]() -> float {
    float r = INFINITY;
    auto one = [&](float v, float dv, float mk) {
      return (dv < 0.f && mk > 0.f) ? -pa.tau * v / fminf(dv, -1e-30f)
                                    : INFINITY;
    };
    for (int i = tid; i < N1 * ng; i += nt) {
      r = nan_min(r, one(sl[i], dsl[i], m[i]));
      r = nan_min(r, one(su[i], dsu[i], m[i]));
      r = nan_min(r, one(ll[i], dll[i], m[i]));
      r = nan_min(r, one(lu[i], dlu[i], m[i]));
    }
    r = nan_min(1.f, block_reduce<kMin>(r, red));
    clk.mark(kPhElementwise);
    return r;
  };

  // ---- the Mehrotra loop ---------------------------------------------------
  // Written so that every phase appears once in the code: round -1 only
  // evaluates the stationarity of the starting point, and the predictor and
  // the corrector are two passes of one loop.
  float stat_old = 0.f, mu = INFINITY;
  for (int it = -1; it < d.iters; ++it) {
    float alpha = 0.f;
    if (it >= 0) {
      // Residuals: g = C dx + D du, rd = A dx + B du + b - dx+, re (masked).
      rows(N1 * ng + N * nx + N * nc,
           [&](int o, int sub) {
             if (o < N1 * ng) {
               const int k = o / ng;
               float acc = pdot(gC + (size_t)o * nx, 1, dx + k * nx, nx, sub);
               if (k < N)
                 acc += pdot(gD + (size_t)o * nu, 1, du + k * nu, nu, sub);
               return acc;
             }
             if (o < N1 * ng + N * nx) {
               const int oo = o - N1 * ng, k = oo / nx;
               return pdot(gA + (size_t)oo * nx, 1, dx + k * nx, nx, sub) +
                      pdot(gB + (size_t)oo * nu, 1, du + k * nu, nu, sub);
             }
             const int oo = o - N1 * ng - N * nx, k = oo / nc;
             return pdot(gCe + (size_t)oo * nx, 1, dx + k * nx, nx, sub) +
                    pdot(gDe + (size_t)oo * nu, 1, du + k * nu, nu, sub);
           },
           [&](int o, float acc) {
             if (o < N1 * ng) {
               g[o] = acc;
             } else if (o < N1 * ng + N * nx) {
               const int oo = o - N1 * ng;
               rd[oo] = acc + gb[oo] - dx[oo + nx];
             } else {
               const int oo = o - N1 * ng - N * nx;
               re[oo] = gme[oo] * (acc + ge[oo]);
             }
           });
      clk.mark(kPhBulk);
      float csum = 0.f;
      for (int i = tid; i < N1 * ng; i += nt)
        csum += m[i] * (sl[i] * ll[i] + su[i] * lu[i]);
      for (int i = tid; i < nx; i += nt) rx0[i] = gdx0[i] - dx[i];
      mu = block_reduce<kSum>(csum, red) / (2.f * n_active);
      clk.mark(kPhElementwise);

      factorize();
      float sigma = 0.f;
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        newton(pass == 1, sigma, mu);  // predictor, then corrector
        const float a_step = step_length();
        if (pass == 1) {
          alpha = a_step;
          break;
        }
        float asum = 0.f;
        for (int i = tid; i < N1 * ng; i += nt)
          asum += m[i] * ((sl[i] + a_step * dsl[i]) * (ll[i] + a_step * dll[i]) +
                          (su[i] + a_step * dsu[i]) * (lu[i] + a_step * dlu[i]));
        const float mu_aff = block_reduce<kSum>(asum, red) / (2.f * n_active);
        clk.mark(kPhElementwise);
        const float ratio = mu_aff / nan_max(mu, 1e-30f);
        sigma = nan_min(nan_max(ratio * ratio * ratio, 0.f), 1.f);
      }
      // Convergence freeze: zero step once mu < mu_tol unless stationarity
      // is still unresolved.
      if (!(mu > pa.mu_tol || stat_old > 1e3f * pa.mu_tol)) alpha = 0.f;
    }
    // Stationarity step guard: reject a step that grows the KKT
    // stationarity more than tenfold; a NaN compares false and is rejected.
    const float stat_new = stat_at(alpha);
    if (it < 0) {
      stat_old = stat_new;
      continue;
    }
    const bool ok = stat_new <= 10.f * (stat_old + mu);
    if (ok) {
      for (int i = tid; i < N1 * nx; i += nt) dx[i] += alpha * ddx[i];
      for (int i = tid; i < N * nu; i += nt) du[i] += alpha * ddu[i];
      for (int i = tid; i < N1 * ng; i += nt) {
        const bool on = m[i] > 0.f;
        sl[i] = on ? sl[i] + alpha * dsl[i] : 1.f;
        su[i] = on ? su[i] + alpha * dsu[i] : 1.f;
        ll[i] = on ? ll[i] + alpha * dll[i] : 0.f;
        lu[i] = on ? lu[i] + alpha * dlu[i] : 0.f;
      }
      stat_old = stat_new;
    }
    __syncthreads();
    clk.mark(kPhElementwise);
  }

  // ---- results ---------------------------------------------------------------
  for (int i = tid; i < N1 * nx; i += nt) out[0][i] = dx[i];
  for (int i = tid; i < N * nu; i += nt) out[1][i] = du[i];
  for (int i = tid; i < N1 * ng; i += nt) {
    out[2][i] = sl[i]; out[3][i] = su[i];
    out[4][i] = ll[i]; out[5][i] = lu[i];
  }
  if (tid == 0) {
    out[6][0] = mu;
    out[6][1] = stat_old;
  }
  if (out[7]) {  // gains of the last factorization and corrector pass
    for (int i = tid; i < N * nu * nx; i += nt) out[7][i] = fK[i];
    for (int i = tid; i < N * nu; i += nt) out[8][i] = kv[i];
    for (int i = tid; i < N1 * nx; i += nt) out[10][i] = p[i];
  }
  clk.mark(kPhElementwise);
  clk.write(a.timers ? a.timers + prob * kNumPhaseSlots : nullptr);
}

#endif  // __CUDACC__

}  // namespace cheeta
