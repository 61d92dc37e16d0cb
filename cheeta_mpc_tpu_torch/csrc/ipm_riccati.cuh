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
// Memory plan. The iterate, slacks, duals, residuals and directions
// (~18 arrays of (N+1) x ng, ~8 of (N+1) x nx) and the per-stage work
// matrices live in dynamic shared memory for all iterations. The Riccati
// factors (K, G^-1 or W, two rolling buffers of P, and H, Y Lam^-1, Lam^-1,
// LiD with equalities) live in shared memory too when they fit, else in a
// global scratch buffer that the caller provides; so does a copy of A and B
// of all stages, which the stage-serial sweeps read. C and D of the stage
// at hand are staged for the factorization's products; everything else of
// the stage data (more than a block's shared memory at the centroidal
// shape) is read from global memory / L2 where it is needed.
//
// What the time goes into: a thread runs its instructions in order, so a
// loop of load, multiply-add, store pays a full memory latency per element
// unless its loads can start early. Hence:
// read-only inputs are __restrict__, products run on register tiles, sums
// start from their global addends, pointers to shared memory are never
// mixed with pointers to global memory in one variable, and the pivot loop
// does no division.
//
// Arithmetic. Plain f32 FMA, no tensor cores, IEEE division and square
// root (never build this with --use_fast_math): the barrier Hessian reaches
// condition ~1/mu, and the guard relies on NaN comparing false. The SPD
// inverse is the Jacobi-equilibrated Gauss-Jordan elimination with the
// one-hot-shifted pivot column and no Newton refinement.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cheeta {

constexpr int kTpo = 8;  // threads that share one output row in mat-vecs
constexpr int kNumIn = 18;
constexpr int kNumOut = 11;

struct IpmDims {
  int N, nx, nu, ng, nc, iters;
  int ab;  // 1: A and B of all stages are kept in shared memory
};

struct IpmParams {
  float tau, mu0, s0_min, reg, eps, w_max, mu_tol;
};

// Inputs:  A B b Q q R r S C D lg ug mask dx0 Ceq Deq eeq maskeq
// Outputs: dx du s_l s_u lam_l lam_u diag K k P p   (K k P p may be null)
struct IpmArgs {
  const float* in[kNumIn];
  long long in_stride[kNumIn];  // elements between problems (0 = shared)
  float* out[kNumOut];
  long long out_stride[kNumOut];
  float* scratch;  // global factor storage, null = shared memory
  long long scratch_stride;
  IpmDims d;
  IpmParams p;
};

// Offsets (in floats) of every shared-memory array; the host uses the same
// function to size the launch.
struct Layout {
  int sl, su, ll, lu, rl, ru, ln, w, rcl, rcu, dsl, dsu, dll, dlu, g, m, lg,
      ug;                                  // (N+1) * ng each
  int dx, ddx, p, qb, cs, xt, prd, rd;     // (N+1) * nx each
  int du, ddu, kv, rb, ut;                 // N * nu each
  int re;                                  // N * nc
  int mvec, rx0, rhs, tu, nuv, nu0;        // nx, nx, nu, nu, nc, nc
  int PA, PB, G, Hk, aug, sv, rowj, colj;  // per-stage work
  int stg;                                 // C, D (A, B) of one stage
  int Y, T, T2, Lam, Gt;                   // equality work (nc > 0)
  int red;                                 // 32
  int total_vec;
  int fK, fGi, fP, fH, fYLi, fLi, fLiD;    // relative to the factor base
  int total_fac;
  int total_ab;                            // resident A, B (d.ab)
};

#define CHEETA_TAKE(field, n) \
  do {                       \
    L.field = o;             \
    o += (n);                \
  } while (0)

__host__ __device__ inline Layout make_layout(const IpmDims& d) {
  Layout L;
  const int N = d.N, N1 = d.N + 1, nx = d.nx, nu = d.nu, ng = d.ng,
            nc = d.nc;
  const int nmax = nu > nc ? nu : nc;
  int o = 0;
  CHEETA_TAKE(sl, N1 * ng); CHEETA_TAKE(su, N1 * ng); CHEETA_TAKE(ll, N1 * ng);
  CHEETA_TAKE(lu, N1 * ng); CHEETA_TAKE(rl, N1 * ng); CHEETA_TAKE(ru, N1 * ng);
  CHEETA_TAKE(ln, N1 * ng); CHEETA_TAKE(w, N1 * ng); CHEETA_TAKE(rcl, N1 * ng);
  CHEETA_TAKE(rcu, N1 * ng); CHEETA_TAKE(dsl, N1 * ng); CHEETA_TAKE(dsu, N1 * ng);
  CHEETA_TAKE(dll, N1 * ng); CHEETA_TAKE(dlu, N1 * ng); CHEETA_TAKE(g, N1 * ng);
  CHEETA_TAKE(m, N1 * ng); CHEETA_TAKE(lg, N1 * ng); CHEETA_TAKE(ug, N1 * ng);
  CHEETA_TAKE(dx, N1 * nx); CHEETA_TAKE(ddx, N1 * nx); CHEETA_TAKE(p, N1 * nx);
  CHEETA_TAKE(qb, N1 * nx); CHEETA_TAKE(cs, N1 * nx); CHEETA_TAKE(xt, N1 * nx);
  CHEETA_TAKE(prd, N1 * nx); CHEETA_TAKE(rd, N1 * nx);
  CHEETA_TAKE(du, N * nu); CHEETA_TAKE(ddu, N * nu); CHEETA_TAKE(kv, N * nu);
  CHEETA_TAKE(rb, N * nu); CHEETA_TAKE(ut, N * nu);
  CHEETA_TAKE(re, N * nc);
  CHEETA_TAKE(mvec, nx); CHEETA_TAKE(rx0, nx); CHEETA_TAKE(rhs, nu); CHEETA_TAKE(tu, nu);
  CHEETA_TAKE(nuv, nc); CHEETA_TAKE(nu0, nc);
  CHEETA_TAKE(PA, nx * nx); CHEETA_TAKE(PB, nx * nu); CHEETA_TAKE(G, nu * nu);
  CHEETA_TAKE(Hk, nu * nx); CHEETA_TAKE(aug, 2 * nmax * nmax); CHEETA_TAKE(sv, nmax);
  CHEETA_TAKE(rowj, 2 * nmax); CHEETA_TAKE(colj, nmax);
  CHEETA_TAKE(stg, ng * nx + ng * nu + (d.ab ? 0 : nx * nx + nx * nu));
  CHEETA_TAKE(Y, nu * nc); CHEETA_TAKE(T, nc * nx); CHEETA_TAKE(T2, nc * nx);
  CHEETA_TAKE(Lam, nc * nc); CHEETA_TAKE(Gt, nc ? nu * nu : 0);
  CHEETA_TAKE(red, 32);
  L.total_vec = o;
  o = 0;
  CHEETA_TAKE(fK, N * nu * nx); CHEETA_TAKE(fGi, N * nu * nu);
  CHEETA_TAKE(fP, 2 * nx * nx);  // P_{k+1} and P_k, rolled
  CHEETA_TAKE(fH, nc ? N * nu * nx : 0); CHEETA_TAKE(fYLi, N * nu * nc);
  CHEETA_TAKE(fLi, N * nc * nc); CHEETA_TAKE(fLiD, N * nc * nu);
  L.total_fac = o;
  L.total_ab = d.ab ? N * (nx * nx + nx * nu) : 0;
  return L;
}

#undef CHEETA_TAKE

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

// n_out outputs, each the sum over kTpo threads of part(o, sub); epi(o, sum)
// runs in one thread per output. Ends with a barrier.
template <class Part, class Epi>
__device__ __forceinline__ void rows(int n_out, Part part, Epi epi) {
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
  __syncthreads();
}

// M x Nn outputs c(i, j) = sum_{l < Kd} a(i, l) * b(l, j), each thread a
// TM x TN register tile, so that an inner step costs TM + TN loads for
// TM * TN multiply-adds instead of two loads for one; init(i, j) is what
// the sum starts from. A tile's rows and
// columns are strided over the output (ti + r * TI, tj + c * TJ), so that
// neighbouring threads read neighbouring words. Thread ``t`` of ``nth``
// takes tiles t, t + nth, ...; store(i, j, sum) runs once per output.
// The sum may come in two segments with operands of their own (a2, b2 over
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
    int ri[TM], cj[TN];
    float acc[TM][TN];
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
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (ti + r * TI < M && tj + c * TJ < Nn)
          store(ti + r * TI, tj + c * TJ, acc[r][c]);
  }
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

// out = inverse of sym(M), n x n: Jacobi equilibration, Gauss-Jordan with
// the one-hot-shifted pivot column, no refinement. M and out may alias.
static __device__ void spd_inverse(const float* M, float* out, int n,
                                   float* __restrict__ aug,
                                   float* __restrict__ sv,
                                   float* __restrict__ rowj,
                                   float* __restrict__ colj) {
  const int tid = threadIdx.x, nt = blockDim.x, n2 = 2 * n;
  for (int i = tid; i < n; i += nt)
    sv[i] = 1.0f / sqrtf(fmaxf(M[i * n + i], 1e-30f));
  __syncthreads();
  for (int idx = tid; idx < n * n2; idx += nt) {
    const int i = idx / n2, c = idx % n2;
    aug[idx] = c < n ? sv[i] * (0.5f * (M[i * n + c] + M[c * n + i])) * sv[c]
                     : (c - n == i ? 1.f : 0.f);
  }
  __syncthreads();
  // A thread updates the same few entries (row i, window column cc) at
  // every pivot, so their indices are worked out once: an integer division
  // in the pivot loop would cost more than the update itself.
  constexpr int kMine = 4;
  const bool hoisted = n * (n + 1) <= kMine * nt;
  int row_of[kMine], col_of[kMine];
#pragma unroll
  for (int e = 0; e < kMine; ++e) {
    const int idx = tid + e * nt;
    row_of[e] = idx < n * (n + 1) ? idx / (n + 1) : -1;
    col_of[e] = idx % (n + 1);
  }
  for (int j = 0; j < n; ++j) {
    // Row j times the pivot's reciprocal, not divided by the pivot: the
    // IEEE division leaves its fast path for a zero or subnormal numerator
    // (a sparse G has many), and the whole warp waits for the slow one.
    const float ipiv = 1.0f / aug[j * n2 + j];
    for (int c = j + tid; c <= j + n; c += nt) rowj[c] = aug[j * n2 + c] * ipiv;
    for (int i = nt - 1 - tid; i < n; i += nt)
      colj[i] = aug[i * n2 + j] - (i == j ? 1.f : 0.f);
    __syncthreads();
    // Columns left of j are unit vectors already and columns right of
    // n + j are still zero in row j: only [j, n + j] changes.
    if (hoisted) {
#pragma unroll
      for (int e = 0; e < kMine; ++e)
        if (row_of[e] >= 0)
          aug[row_of[e] * n2 + j + col_of[e]] -=
              colj[row_of[e]] * rowj[j + col_of[e]];
    } else {
      for (int idx = tid; idx < n * (n + 1); idx += nt) {
        const int i = idx / (n + 1), c = j + idx % (n + 1);
        aug[i * n2 + c] -= colj[i] * rowj[c];
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, c = idx % n;
    out[idx] = sv[i] * aug[i * n2 + n + c] * sv[c];
  }
  __syncthreads();
}

// kFacShared / kAbShared say at compile time whether the Riccati factors
// and the copy of A, B live in shared memory (else: the global scratch
// buffer, the global inputs). A pointer that may be either is a generic
// pointer, and every access through it pays 64-bit address arithmetic and
// the generic load path instead of a shared-memory load.
template <bool kFacShared, bool kAbShared>
static __device__ void ipm_solve(const IpmArgs& a, float* smem) {
  const IpmDims d = a.d;
  const IpmParams pa = a.p;
  const int N = d.N, N1 = d.N + 1, nx = d.nx, nu = d.nu, ng = d.ng,
            nc = d.nc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long prob = blockIdx.x;
  const Layout L = make_layout(d);

  const float* in[kNumIn];
  for (int i = 0; i < kNumIn; ++i)
    in[i] = a.in[i] ? a.in[i] + prob * a.in_stride[i] : nullptr;
  float* out[kNumOut];
  for (int i = 0; i < kNumOut; ++i)
    out[i] = a.out[i] ? a.out[i] + prob * a.out_stride[i] : nullptr;
  // The inputs are read-only and overlap nothing the kernel writes; saying
  // so lets their loads move ahead of stores to shared memory. Without it
  // every store orders the loads behind it, and a thread runs in order:
  // a loop of load, multiply-add, store pays one L2 latency per element.
  typedef const float* __restrict__ In;
  In gA = in[0], gB = in[1], gb = in[2], gQ = in[3], gq = in[4], gR = in[5],
     gr = in[6], gS = in[7], gC = in[8], gD = in[9], glg = in[10],
     gug = in[11], gm = in[12], gdx0 = in[13], gCe = in[14], gDe = in[15],
     ge = in[16], gme = in[17];

  float* s = smem;
  float *sl = s + L.sl, *su = s + L.su, *ll = s + L.ll, *lu = s + L.lu,
        *rl = s + L.rl, *ru = s + L.ru, *ln = s + L.ln, *w = s + L.w,
        *rcl = s + L.rcl, *rcu = s + L.rcu, *dsl = s + L.dsl,
        *dsu = s + L.dsu, *dll = s + L.dll, *dlu = s + L.dlu, *g = s + L.g,
        *m = s + L.m, *lg = s + L.lg, *ug = s + L.ug;
  float *dx = s + L.dx, *ddx = s + L.ddx, *p = s + L.p, *qb = s + L.qb,
        *cs = s + L.cs, *xt = s + L.xt, *prd = s + L.prd, *rd = s + L.rd;
  float *du = s + L.du, *ddu = s + L.ddu, *kv = s + L.kv, *rb = s + L.rb,
        *ut = s + L.ut, *re = s + L.re;
  float *mvec = s + L.mvec, *rx0 = s + L.rx0, *rhs = s + L.rhs,
        *tu = s + L.tu, *nuv = s + L.nuv, *nu0 = s + L.nu0;
  float *PA = s + L.PA, *PB = s + L.PB, *G = s + L.G, *Hk1 = s + L.Hk,
        *aug = s + L.aug, *sv = s + L.sv, *rowj = s + L.rowj,
        *colj = s + L.colj, *stg = s + L.stg;
  float *Y = s + L.Y, *T = s + L.T, *T2 = s + L.T2, *Lam = s + L.Lam,
        *Gt = s + L.Gt, *red = s + L.red;
  float* fac;
  if (kFacShared) fac = s + L.total_vec;
  else fac = a.scratch + prob * a.scratch_stride;
  // A and B of all stages: a copy in shared memory if it fits (d.ab), the
  // global arrays otherwise. Same indexing either way.
  float* sAB = s + L.total_vec + (kFacShared ? L.total_fac : 0);
  const float *rA, *rB;
  if (kAbShared) {
    rA = sAB;
    rB = sAB + N * nx * nx;
  } else {
    rA = gA;
    rB = gB;
  }
  float *fK = fac + L.fK, *fGi = fac + L.fGi, *fP = fac + L.fP,
        *fH = fac + L.fH, *fYLi = fac + L.fYLi, *fLi = fac + L.fLi,
        *fLiD = fac + L.fLiD;

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
    dll[i] = 0.f; dlu[i] = 0.f;
    msum += mk;
  }
  if (kAbShared) {
    for (int i = tid; i < N * nx * nx; i += nt) sAB[i] = gA[i];
    for (int i = tid; i < N * nx * nu; i += nt) sAB[N * nx * nx + i] = gB[i];
  }
  for (int i = tid; i < N1 * nx; i += nt) { dx[i] = 0.f; ddx[i] = 0.f; }
  for (int i = tid; i < N * nu; i += nt) { du[i] = 0.f; ddu[i] = 0.f; }
  const float n_active = fmaxf(block_reduce<kSum>(msum, red), 1.f);

  // Least-squares equality-dual operator of the stationarity metric:
  // LiD_k = (De De' + diag(1 - mask))^-1 De.
  for (int k = 0; k < N && nc; ++k) {
    const float* De = gDe + (size_t)k * nc * nu;
    for (int idx = tid; idx < nc * nc; idx += nt) {
      const int i = idx / nc, j = idx % nc;
      float acc = i == j ? 1.f - gme[k * nc + i] : 0.f;
      for (int l = 0; l < nu; ++l) acc = fmaf(De[i * nu + l], De[j * nu + l], acc);
      Lam[idx] = acc;
    }
    __syncthreads();
    spd_inverse(Lam, Lam, nc, aug, sv, rowj, colj);
    float* LiD = fLiD + (size_t)k * nc * nu;
    for (int idx = tid; idx < nc * nu; idx += nt) {
      const int i = idx / nu, j = idx % nu;
      float acc = 0.f;
      for (int l = 0; l < nc; ++l) acc = fmaf(Lam[i * nc + l], De[l * nu + j], acc);
      LiD[idx] = acc;
    }
    __syncthreads();
  }

  // qb <- q + Q x + S' u + C' ln ; rb <- r + R u + S x + D' ln, all stages.
  auto gradients = [&](const float* x, const float* u) {
    rows(N1 * nx + N * nu,
         [&](int o, int sub) {
           if (o < N1 * nx) {
             const int k = o / nx, i = o % nx;
             float acc = pdot(gQ + (size_t)o * nx, 1, x + k * nx, nx, sub) +
                         pdot(gC + (size_t)k * ng * nx + i, nx, ln + k * ng,
                              ng, sub);
             if (k < N)
               acc += pdot(gS + (size_t)k * nu * nx + i, nx, u + k * nu, nu,
                           sub);
             return acc;
           }
           const int oo = o - N1 * nx, k = oo / nu, j = oo % nu;
           return pdot(gR + (size_t)oo * nu, 1, u + k * nu, nu, sub) +
                  pdot(gS + (size_t)oo * nx, 1, x + k * nx, nx, sub) +
                  pdot(gD + (size_t)k * ng * nu + j, nu, ln + k * ng, ng, sub);
         },
         [&](int o, float acc) {
           if (o < N1 * nx) qb[o] = gq[o] + acc;
           else rb[o - N1 * nx] = gr[o - N1 * nx] + acc;
         });
  };

  // Input-space KKT stationarity (inf-norm) at state + alpha * direction:
  // adjoint recursion with least-squares equality duals.
  auto stat_at = [&](float alpha) -> float {
    for (int i = tid; i < N1 * ng; i += nt)
      ln[i] = m[i] * ((lu[i] + alpha * dlu[i]) - (ll[i] + alpha * dll[i]));
    for (int i = tid; i < N1 * nx; i += nt) xt[i] = dx[i] + alpha * ddx[i];
    for (int i = tid; i < N * nu; i += nt) ut[i] = du[i] + alpha * ddu[i];
    __syncthreads();
    gradients(xt, ut);
    for (int i = tid; i < nx; i += nt) cs[N * nx + i] = qb[N * nx + i];
    __syncthreads();
    float smax = 0.f;
    for (int k = N - 1; k >= 0; --k) {
      const float* Ak = rA + (size_t)k * nx * nx;
      const float* Bk = rB + (size_t)k * nx * nu;
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
             });
      } else {
        const float* Ce = gCe + (size_t)k * nc * nx;
        const float* De = gDe + (size_t)k * nc * nu;
        const float* LiD = fLiD + (size_t)k * nc * nu;
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
             });
      }
    }
    return block_reduce<kMax>(smax, red);
  };

  // Backward Riccati with the barrier-augmented Hessian blocks
  // Qb = Q + C' diag(w) C (and Rb, Sb with D) and exact elimination of the
  // masked stage equalities; stores K, G^-1 (W with equalities), P
  // (+ H, Y Lam^-1, Lam^-1) and prd_k = P_{k+1} rd_k.
  auto factorize = [&]() {
    for (int i = tid; i < N1 * ng; i += nt)
      w[i] = m[i] * nan_min(ll[i] / sl[i] + lu[i] / su[i], pa.w_max);
    __syncthreads();
    float* Pn = fP;            // P_{k+1}
    float* Pk = fP + nx * nx;  // P_k; the two buffers swap after each stage
    float* gP = out[9];        // value-function Hessians, if asked for
    {
      const float* QN = gQ + (size_t)N * nx * nx;
      const float* CN = gC + (size_t)N * ng * nx;
      for (int idx = tid; idx < nx * nx; idx += nt) {
        const int i = idx / nx, j = idx % nx;
        float acc = 0.5f * (QN[idx] + QN[j * nx + i]);
        for (int r = 0; r < ng; ++r)
          acc = fmaf(CN[r * nx + i] * w[N * ng + r], CN[r * nx + j], acc);
        Pn[idx] = acc;
        if (gP) gP[(size_t)N * nx * nx + idx] = acc;
      }
      __syncthreads();
    }
    for (int k = N - 1; k >= 0; --k) {
      // Stage the matrices that the products below read nx or ng times
      // per output: one coalesced copy with many loads in flight, instead
      // of an L2 round trip inside every inner loop.
      float *Ck = stg, *Dk = Ck + ng * nx;
      const float *Ak = rA + (size_t)k * nx * nx,
                  *Bk = rB + (size_t)k * nx * nu;
      if (!kAbShared) {
        float *sAk = Dk + ng * nu, *sBk = sAk + nx * nx;
        for (int i = tid; i < nx * nx; i += nt) sAk[i] = Ak[i];
        for (int i = tid; i < nx * nu; i += nt) sBk[i] = Bk[i];
        Ak = sAk;
        Bk = sBk;
      }
      for (int i = tid; i < ng * nx; i += nt) Ck[i] = gC[(size_t)k * ng * nx + i];
      for (int i = tid; i < ng * nu; i += nt) Dk[i] = gD[(size_t)k * ng * nu + i];
      __syncthreads();
      In Qk = gQ + (size_t)k * nx * nx;
      In Rk = gR + (size_t)k * nu * nu;
      In Sk = gS + (size_t)k * nu * nx;
      const float* wk = w + k * ng;
      float* Kk = fK + (size_t)k * nu * nx;
      float* Gik = fGi + (size_t)k * nu * nu;
      float* Hk = nc ? fH + (size_t)k * nu * nx : Hk1;
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
      {  // G = Rb + B'PB + reg I ; H = Sb + B'PA ; Pk = Qb + A'PA (+ H'K later)
        const int n_g = tiles_of(nu, nu, 4, 4), n_h = tiles_of(nu, nx, 4, 4),
                  n_p = tiles_of(nx, nx, 4, 4);
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
            [&](int i, int j, float v) { G[i * nu + j] = v; });
        tile_product2<4, 4>(
            ph.first(n_h), ph.step(n_h), nu, nx,
            [&](int i, int j) { return Sk[i * nx + j]; },
            ng, [&](int i, int l) { return Dk[l * nu + i] * wk[l]; },
            [&](int l, int j) { return Ck[l * nx + j]; },
            nx, [&](int i, int l) { return Bk[l * nu + i]; },
            [&](int l, int j) { return PA[l * nx + j]; },
            [&](int i, int j, float v) { Hk[i * nx + j] = v; });
        tile_product2<4, 4>(
            ph.first(n_p), ph.step(n_p), nx, nx,
            [&](int i, int j) { return Qk[i * nx + j]; },
            ng, [&](int i, int l) { return Ck[l * nx + i] * wk[l]; },
            [&](int l, int j) { return Ck[l * nx + j]; },
            nx, [&](int i, int l) { return Ak[l * nx + i]; },
            [&](int l, int j) { return PA[l * nx + j]; },
            [&](int i, int j, float v) { Pk[i * nx + j] = v; });
      }
      __syncthreads();
      if (nc == 0) {
        spd_inverse(G, Gik, nu, aug, sv, rowj, colj);
        tile_product<4, 4>(
            tid, nt, nu, nx, nu,
            [&](int, int) { return 0.f; },
            [&](int i, int l) { return Gik[i * nu + l]; },
            [&](int l, int j) { return Hk[l * nx + j]; },
            [&](int i, int j, float v) { Kk[i * nx + j] = -v; });
        __syncthreads();
        tile_product<4, 4>(
            tid, nt, nx, nx, nu,
            [&](int i, int j) { return Pk[i * nx + j]; },
            [&](int i, int l) { return Hk[l * nx + i]; },
            [&](int l, int j) { return Kk[l * nx + j]; },
            [&](int i, int j, float v) { Pk[i * nx + j] = v; });
        __syncthreads();
      } else {
        const float* Ce = gCe + (size_t)k * nc * nx;
        const float* De = gDe + (size_t)k * nc * nu;
        float* YLi = fYLi + (size_t)k * nu * nc;
        float* Li = fLi + (size_t)k * nc * nc;
        spd_inverse(G, Gt, nu, aug, sv, rowj, colj);
        for (int idx = tid; idx < nu * nc; idx += nt) {  // Y = G^-1 De'
          const int i = idx / nc, r = idx % nc;
          float acc = 0.f;
          for (int l = 0; l < nu; ++l)
            acc = fmaf(Gt[i * nu + l], De[r * nu + l], acc);
          Y[idx] = acc;
        }
        __syncthreads();
        for (int idx = tid; idx < nc * nc; idx += nt) {  // Lam = De Y + E
          const int r = idx / nc, c = idx % nc;
          float acc = r == c ? pa.eps * (1.f - gme[k * nc + r]) : 0.f;
          for (int l = 0; l < nu; ++l)
            acc = fmaf(De[r * nu + l], Y[l * nc + c], acc);
          Lam[idx] = acc;
        }
        __syncthreads();
        spd_inverse(Lam, Li, nc, aug, sv, rowj, colj);
        for (int idx = tid; idx < nu * nc; idx += nt) {  // YLi = Y Li
          const int i = idx / nc, r = idx % nc;
          float acc = 0.f;
          for (int l = 0; l < nc; ++l)
            acc = fmaf(Y[i * nc + l], Li[l * nc + r], acc);
          YLi[idx] = acc;
        }
        __syncthreads();
        // W = G^-1 - YLi Y' ; T = Ce - Y' H
        for (int idx = tid; idx < nu * nu + nc * nx; idx += nt) {
          if (idx < nu * nu) {
            const int i = idx / nu, j = idx % nu;
            float acc = 0.f;
            for (int r = 0; r < nc; ++r)
              acc = fmaf(YLi[i * nc + r], Y[j * nc + r], acc);
            Gik[idx] = Gt[idx] - acc;
          } else {
            const int e = idx - nu * nu, r = e / nx, j = e % nx;
            float acc = 0.f;
            for (int l = 0; l < nu; ++l)
              acc = fmaf(Y[l * nc + r], Hk[l * nx + j], acc);
            T[e] = Ce[e] - acc;
          }
        }
        __syncthreads();
        // K = -(W H + YLi Ce) ; T2 = Li T
        for (int idx = tid; idx < nu * nx + nc * nx; idx += nt) {
          if (idx < nu * nx) {
            const int i = idx / nx, j = idx % nx;
            float acc = 0.f;
            for (int l = 0; l < nu; ++l)
              acc = fmaf(Gik[i * nu + l], Hk[l * nx + j], acc);
            for (int r = 0; r < nc; ++r)
              acc = fmaf(YLi[i * nc + r], Ce[r * nx + j], acc);
            Kk[idx] = -acc;
          } else {
            const int e = idx - nu * nx, r = e / nx, j = e % nx;
            float acc = 0.f;
            for (int c = 0; c < nc; ++c)
              acc = fmaf(Li[r * nc + c], T[c * nx + j], acc);
            T2[e] = acc;
          }
        }
        __syncthreads();
        for (int idx = tid; idx < nx * nx; idx += nt) {  // Pk += H'K + Ce'T2
          const int i = idx / nx, j = idx % nx;
          float acc = Pk[idx];
          for (int l = 0; l < nu; ++l)
            acc = fmaf(Hk[l * nx + i], Kk[l * nx + j], acc);
          for (int r = 0; r < nc; ++r)
            acc = fmaf(Ce[r * nx + i], T2[r * nx + j], acc);
          Pk[idx] = acc;
        }
        __syncthreads();
      }
      for (int idx = tid; idx < nx * nx; idx += nt) {  // Pk <- sym(Pk)
        const int i = idx / nx, j = idx % nx;
        if (i < j) {
          const float v = 0.5f * (Pk[idx] + Pk[j * nx + i]);
          Pk[idx] = v;
          Pk[j * nx + i] = v;
        }
      }
      __syncthreads();
      if (gP) {
        for (int idx = tid; idx < nx * nx; idx += nt)
          gP[(size_t)k * nx * nx + idx] = Pk[idx];
      }
      float* swap = Pn;
      Pn = Pk;
      Pk = swap;
    }
  };

  // One Newton direction against the stored factors for the complementarity
  // right-hand sides in rcl/rcu: backward vector pass, forward rollout,
  // slack and dual directions.
  auto newton = [&]() {
    for (int i = tid; i < N1 * ng; i += nt) {
      const float beta =
          m[i] * ((ll[i] / sl[i]) * rl[i] + (lu[i] / su[i]) * ru[i] +
                  rcl[i] / sl[i] - rcu[i] / su[i]);
      ln[i] = m[i] * (lu[i] - ll[i] + beta);
    }
    __syncthreads();
    gradients(dx, du);
    for (int i = tid; i < nx; i += nt) p[N * nx + i] = qb[N * nx + i];
    __syncthreads();
    for (int k = N - 1; k >= 0; --k) {
      const float* Ak = rA + (size_t)k * nx * nx;
      const float* Bk = rB + (size_t)k * nx * nu;
      const float* Kk = fK + (size_t)k * nu * nx;
      const float* Gik = fGi + (size_t)k * nu * nu;
      for (int i = tid; i < nx; i += nt)
        mvec[i] = p[(k + 1) * nx + i] + prd[k * nx + i];
      __syncthreads();
      rows(nu, [&](int o, int sub) { return pdot(Bk + o, nu, mvec, nx, sub); },
           [&](int o, float acc) { rhs[o] = rb[k * nu + o] + acc; });
      if (nc == 0) {
        rows(nu + nx,
             [&](int o, int sub) {
               return o < nu ? pdot(Gik + o * nu, 1, rhs, nu, sub)
                             : pdot(Ak + (o - nu), nx, mvec, nx, sub) +
                                   pdot(Kk + (o - nu), nx, rhs, nu, sub);
             },
             [&](int o, float acc) {
               if (o < nu) kv[k * nu + o] = -acc;
               else p[k * nx + o - nu] = qb[k * nx + o - nu] + acc;
             });
      } else {
        const float* Ce = gCe + (size_t)k * nc * nx;
        const float* Hk = fH + (size_t)k * nu * nx;
        const float* YLi = fYLi + (size_t)k * nu * nc;
        const float* Li = fLi + (size_t)k * nc * nc;
        const float* rek = re + k * nc;  // h = -r_eq
        rows(nu + nc,
             [&](int o, int sub) {
               return o < nu ? pdot(Gik + o * nu, 1, rhs, nu, sub) +
                                   pdot(YLi + o * nc, 1, rek, nc, sub)
                             : pdot(YLi + (o - nu), nc, rhs, nu, sub) -
                                   pdot(Li + (o - nu) * nc, 1, rek, nc, sub);
             },
             [&](int o, float acc) {
               if (o < nu) kv[k * nu + o] = -acc;
               else nu0[o - nu] = -acc;
             });
        rows(nx,
             [&](int o, int sub) {
               return pdot(Ak + o, nx, mvec, nx, sub) +
                      pdot(Hk + o, nx, kv + k * nu, nu, sub) +
                      pdot(Ce + o, nx, nu0, nc, sub);
             },
             [&](int o, float acc) { p[k * nx + o] = qb[k * nx + o] + acc; });
      }
    }
    for (int i = tid; i < nx; i += nt) ddx[i] = rx0[i];
    __syncthreads();
    for (int k = 0; k < N; ++k) {
      const float* Ak = rA + (size_t)k * nx * nx;
      const float* Bk = rB + (size_t)k * nx * nu;
      const float* Kk = fK + (size_t)k * nu * nx;
      rows(nu,
           [&](int o, int sub) {
             return pdot(Kk + o * nx, 1, ddx + k * nx, nx, sub);
           },
           [&](int o, float acc) { ddu[k * nu + o] = acc + kv[k * nu + o]; });
      rows(nx,
           [&](int o, int sub) {
             return pdot(Ak + o * nx, 1, ddx + k * nx, nx, sub) +
                    pdot(Bk + o * nu, 1, ddu + k * nu, nu, sub);
           },
           [&](int o, float acc) {
             ddx[(k + 1) * nx + o] = acc + rd[k * nx + o];
           });
    }
    rows(N1 * ng,
         [&](int o, int sub) {
           const int k = o / ng;
           float acc = pdot(gC + (size_t)o * nx, 1, ddx + k * nx, nx, sub);
           if (k < N)
             acc += pdot(gD + (size_t)o * nu, 1, ddu + k * nu, nu, sub);
           return acc;
         },
         [&](int o, float acc) { g[o] = acc; });
    for (int i = tid; i < N1 * ng; i += nt) {
      const float ds_l = m[i] * (g[i] + rl[i]);
      const float ds_u = m[i] * (-g[i] - ru[i]);
      dsl[i] = ds_l; dsu[i] = ds_u;
      dll[i] = -m[i] * (rcl[i] + ll[i] * ds_l) / sl[i];
      dlu[i] = -m[i] * (rcu[i] + lu[i] * ds_u) / su[i];
    }
    __syncthreads();
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
    return nan_min(1.f, block_reduce<kMin>(r, red));
  };

  // ---- the Mehrotra loop ---------------------------------------------------
  // Written so that every phase appears once in the code: round -1 only
  // evaluates the stationarity of the starting point, and the predictor and
  // the corrector are two passes of one loop. The kernel is one long
  // sequence of different phases, so every duplicate costs instruction
  // fetches on each iteration.
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
               return pdot(rA + (size_t)oo * nx, 1, dx + k * nx, nx, sub) +
                      pdot(rB + (size_t)oo * nu, 1, du + k * nu, nu, sub);
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
      float csum = 0.f;
      for (int i = tid; i < N1 * ng; i += nt) {
        rl[i] = g[i] - sl[i] - lg[i];
        ru[i] = g[i] + su[i] - ug[i];
        const float cl = m[i] * (sl[i] * ll[i]), cu = m[i] * (su[i] * lu[i]);
        rcl[i] = cl; rcu[i] = cu;  // predictor right-hand sides (sigma = 0)
        csum += m[i] * (sl[i] * ll[i] + su[i] * lu[i]);
      }
      for (int i = tid; i < nx; i += nt) rx0[i] = gdx0[i] - dx[i];
      mu = block_reduce<kSum>(csum, red) / (2.f * n_active);

      factorize();
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        newton();  // predictor, then corrector on the same factorization
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
        const float ratio = mu_aff / nan_max(mu, 1e-30f);
        const float sigma = nan_min(nan_max(ratio * ratio * ratio, 0.f), 1.f);
        // Corrector: new complementarity right-hand sides.
        for (int i = tid; i < N1 * ng; i += nt) {
          rcl[i] = m[i] * (sl[i] * ll[i] + dsl[i] * dll[i] - sigma * mu);
          rcu[i] = m[i] * (su[i] * lu[i] + dsu[i] * dlu[i] - sigma * mu);
        }
        __syncthreads();
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
}

#endif  // __CUDACC__

}  // namespace cheeta
