// L1: the legged SQP linearization of mpc/legged_mpc.py::build_legged_solver
// in one launch per SQP iteration.
//
// Source note.
//   Replaces: no TPU kernel. The JAX package linearizes by jax.jacfwd and
//   leaves the fusion to XLA; the port's plain version (build_legged_solver's
//   linearize_plain, which the solver takes for CPU tensors) does the same
//   with torch.func.jacfwd under vmap, which runs every primitive of the
//   SRBD model and the foot kinematics as its own kernel batched over the
//   48 tangents, and every torch.cat / torch.stack of the model as a
//   batched copy: ~1,700 kernels per linearization, 84 % of the device
//   time of a legged fleet of 512 problems (36 of 43 ms per call on an
//   H100).
//   What bounds it on this card: the bytes written. Per stage it writes A
//   and B (2 x 24 x 24 floats), C and D (2 x 16 x 24), R (24 x 24) and
//   b, e, q, r (~100 floats): ~10.3 KB, ~0.11 ms for 512 x 67 stages at
//   3.35 TB/s. Its arithmetic, ~3,200 f32 operations per stage and tangent
//   (~152,000 per stage), is ~0.08 ms at 67 TFLOP/s.
//   What the design does about it: forward mode by dual numbers in
//   registers. One thread per (problem, stage, tangent j in 0..47)
//   evaluates the RK2 step and the masked foot-velocity equality on
//   (value, tangent) pairs seeded with e_j, so nothing between the inputs
//   and the outputs touches device memory. Thread j writes column j of
//   [A | B] and of [C | D]; the 24 state tangents of a stage are adjacent
//   threads, so each row of A goes out as 24 adjacent floats. The value is
//   computed redundantly by every thread of the stage (it is what a dual
//   number carries), and the stage's threads share out the writes of b,
//   e, q, r and R. One launch per SQP iteration replaces the chain.
//
// Arithmetic. The JVP rule of each primitive, as jacfwd applies it, in f32:
// the derivatives agree with the plain version to rounding (the compiler
// fuses a product and a sum into one fmaf where jacfwd rounds twice, and
// sums of three or four terms run in order). sin and cos come from one
// sincosf per angle, the IEEE-accurate one: never build this with
// --use_fast_math. The mask multiplies each equality row before its
// derivative is taken, so inactive rows of C and D are exact zeros (the
// equality-Riccati kernels rely on it). The soft friction cone's
// relaxed-barrier gradient and Hessian are the closed forms of
// mpc/friction_cone.py::barrier_cost_quadratic.
#include <cuda_runtime.h>

namespace cheeta {
namespace legged {

constexpr int kNx = 24, kNu = 24;
constexpr int kTangents = kNx + kNu;  // threads per stage
constexpr int kNc = 16;               // equality rows per stage
constexpr int kLegs = 4;
constexpr int kStagesPerBlock = 4;
constexpr int kThreads = kStagesPerBlock * kTangents;  // 192

// Inputs, each per problem (stride in in_stride) or shared (stride 0).
enum In {
  kX,       // (N+1, 24) state trajectory
  kU,       // (N, 24) input trajectory
  kEnable,  // (N, 4) contact flags
  kZPos,    // (N, 4) swing height references
  kZVel,    // (N, 4) swing height-rate references
  kEqMask,  // (N, 16) equality-row activity
  kXRef,    // (N+1, 24) state reference
  kURef,    // (N, 24) input reference
  kDts,     // (N) interval durations; null: the model's uniform dt
  kNumIn
};
// Outputs, contiguous per problem.
enum Out {
  kA,     // (N, 24, 24)
  kB,     // (N, 24, 24)
  kBvec,  // (N, 24) f(x_k, u_k) - x_{k+1}
  kC,     // (N, 16, 24)
  kD,     // (N, 16, 24)
  kE,     // (N, 16) masked equality values
  kQvec,  // (N+1, 24) Q (x - x_ref)
  kRvec,  // (N, 24) R (u - u_ref), plus the cone barrier's gradient
  kRmat,  // (N, 24, 24) R plus the barrier's Hessian; null: no soft cone
  kNumOut
};

// The model and the task, in the order mpc/legged_mpc.py::l1_model packs
// them (all f32).
struct Model {
  float dt, gravity, mass;
  float inv_inertia[3], com_offset[3];
  float hip[kLegs][3];
  float hip_length, thigh_length, shank_length;
  float gain;  // position-error gain of the swing-height rows
  float q_diag[kNx], r_diag[kNu];
  float mu, regularization, gripper_force, hessian_shift;  // friction cone
  float barrier_mu, barrier_delta;                          // relaxed barrier
};
constexpr int kNumParams = sizeof(Model) / sizeof(float);

struct Args {
  const float* in[kNumIn];
  long long in_stride[kNumIn];
  float* out[kNumOut];
  int N, batch, rk2;
  Model m;
};

// contact leg [LF, RF, LH, RH] -> block of the joint vector [LF, LH, RF, RH]
template <int kLeg>
__device__ constexpr int joint_slot() {
  return kLeg == 1 ? 2 : kLeg == 2 ? 1 : kLeg;
}
// +1 for the left legs (LF, LH), -1 for the right (RF, RH).
template <int kLeg>
__device__ constexpr float side() {
  return kLeg == 0 || kLeg == 2 ? 1.f : -1.f;
}

struct Dual {
  float v, d;  // value, tangent
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float c, Dual a) {
  return {c * a.v, c * a.d};
}
__device__ __forceinline__ Dual operator+(Dual a, float c) {
  return {a.v + c, a.d};
}
__device__ __forceinline__ Dual operator-(Dual a, float c) {
  return {a.v - c, a.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float v = a.v / b.v;
  return {v, a.d / b.v - b.d * v / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float c) {
  return {a.v / c, a.d / c};
}
__device__ __forceinline__ void sin_cos(Dual a, Dual& s, Dual& c) {
  float sv, cv;
  sincosf(a.v, &sv, &cv);
  s = {sv, a.d * cv};
  c = {cv, a.d * -sv};
}

// R = Rz(yaw) Ry(pitch) Rx(roll) and the trigonometry of eul = (yaw,
// pitch, roll) that the rate maps use.
struct Euler {
  Dual sz, cz, sy, cy, sx, cx;
  Dual R[3][3];
};
__device__ __forceinline__ void euler(const Dual* eul, Euler& e) {
  sin_cos(eul[0], e.sz, e.cz);
  sin_cos(eul[1], e.sy, e.cy);
  sin_cos(eul[2], e.sx, e.cx);
  e.R[0][0] = e.cz * e.cy;
  e.R[0][1] = e.cz * e.sy * e.sx - e.sz * e.cx;
  e.R[0][2] = e.cz * e.sy * e.cx + e.sz * e.sx;
  e.R[1][0] = e.sz * e.cy;
  e.R[1][1] = e.sz * e.sy * e.sx + e.cz * e.cx;
  e.R[1][2] = e.sz * e.sy * e.cx - e.cz * e.sx;
  e.R[2][0] = -e.sy;
  e.R[2][1] = e.cy * e.sx;
  e.R[2][2] = e.cy * e.cx;
}

__device__ __forceinline__ Dual row3(const Dual (&r)[3], Dual a, Dual b,
                                     Dual c) {
  return r[0] * a + r[1] * b + r[2] * c;
}

// One leg's foot in the base frame (hip offset plus the HAA-HFE-KFE chain)
// and, if jac is given, the chain's Jacobian columns d/dhaa, d/dhfe,
// d/dkfe (models/quadruped_kinematics.py::_leg_chain).
template <int kLeg>
__device__ __forceinline__ void leg_chain(const Model& m, const Dual* q,
                                          Dual (&p)[3], Dual (*jac)[3]) {
  const Dual* ql = q + 3 * joint_slot<kLeg>();
  Dual s1, c1, s12, c12, sa, ca;
  sin_cos(ql[1], s1, c1);
  sin_cos(ql[1] + ql[2], s12, c12);
  const Dual px = -(m.thigh_length * s1 + m.shank_length * s12);
  const Dual pz_plane = -(m.thigh_length * c1 + m.shank_length * c12);
  const float py_leg = side<kLeg>() * m.hip_length;
  sin_cos(ql[0], sa, ca);
  const Dual py = py_leg * ca - sa * pz_plane;
  const Dual pz = py_leg * sa + ca * pz_plane;
  p[0] = px + m.hip[kLeg][0];
  p[1] = py + m.hip[kLeg][1];
  p[2] = pz + m.hip[kLeg][2];
  if (jac != nullptr) {
    const Dual dpz_k = m.shank_length * s12;
    jac[0][0] = {0.f, 0.f};
    jac[0][1] = -pz;
    jac[0][2] = py;
    jac[1][0] = pz_plane;
    jac[1][1] = sa * px;
    jac[1][2] = -ca * px;
    jac[2][0] = -m.shank_length * c12;
    jac[2][1] = -sa * dpz_k;
    jac[2][2] = ca * dpz_k;
  }
}

// One leg's effective contact force (enable x u_F) and its moment about the
// CoM, added to the sums.
template <int kLeg>
__device__ __forceinline__ void add_leg_wrench(const Model& m, const Dual* x,
                                               const Dual* u, const float* en,
                                               const Euler& e,
                                               const Dual (&com)[3],
                                               Dual (&fsum)[3],
                                               Dual (&lsum)[3]) {
  Dual pb[3];
  leg_chain<kLeg>(m, x + 12, pb, nullptr);
  Dual arm[3], f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    arm[a] = x[6 + a] + row3(e.R[a], pb[0], pb[1], pb[2]) - com[a];
    f[a] = en[kLeg] * u[3 * kLeg + a];
    fsum[a] = fsum[a] + f[a];
  }
  lsum[0] = lsum[0] + (arm[1] * f[2] - arm[2] * f[1]);
  lsum[1] = lsum[1] + (arm[2] * f[0] - arm[0] * f[2]);
  lsum[2] = lsum[2] + (arm[0] * f[1] - arm[1] * f[0]);
}

// x_dot of the SRBD model (models/srbd_legged.py::srbd_continuous_dynamics).
__device__ __forceinline__ void rates(const Model& m, const Dual* x,
                                      const Dual* u, const float* en,
                                      Dual* xd) {
  Euler e;
  euler(x + 9, e);
  Dual com[3];
  const Dual c0 = {m.com_offset[0], 0.f}, c1 = {m.com_offset[1], 0.f},
             c2 = {m.com_offset[2], 0.f};
#pragma unroll
  for (int a = 0; a < 3; ++a) com[a] = x[6 + a] + row3(e.R[a], c0, c1, c2);
  Dual fsum[3] = {}, lsum[3] = {};
  add_leg_wrench<0>(m, x, u, en, e, com, fsum, lsum);
  add_leg_wrench<1>(m, x, u, en, e, com, fsum, lsum);
  add_leg_wrench<2>(m, x, u, en, e, com, fsum, lsum);
  add_leg_wrench<3>(m, x, u, en, e, com, fsum, lsum);
  xd[0] = fsum[0] / m.mass;
  xd[1] = fsum[1] / m.mass;
  xd[2] = fsum[2] / m.mass - m.gravity;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    xd[3 + a] = lsum[a] / m.mass;
    xd[6 + a] = x[a];
  }
  // eul_dot = E^-1(eul) R I_b^-1 R' (m l_norm)
  Dual t[3], om[3];
  const Dual ml0 = m.mass * x[3], ml1 = m.mass * x[4], ml2 = m.mass * x[5];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    t[b] = m.inv_inertia[b] * (e.R[0][b] * ml0 + e.R[1][b] * ml1 +
                               e.R[2][b] * ml2);
#pragma unroll
  for (int a = 0; a < 3; ++a) om[a] = row3(e.R[a], t[0], t[1], t[2]);
  const Dual ty = e.sy / e.cy;
  xd[9] = e.cz * ty * om[0] + e.sz * ty * om[1] + om[2];
  xd[10] = e.cz * om[1] - e.sz * om[0];
  xd[11] = e.cz / e.cy * om[0] + e.sz / e.cy * om[1];
#pragma unroll
  for (int i = 12; i < kNx; ++i) xd[i] = u[i];
}

// One leg's rows of the masked equality (mpc/legged_mpc.py's stage
// equality): its world foot velocity v = vcom + omega x (R p) + R J qd
// (three zero-velocity rows) and v_z + gain (p_z - z_ref) - zdot_ref (the
// normal-velocity row), each row times its mask before the tangent is
// written: column j of [C | D] and, by the thread whose j is the row, e.
template <int kLeg>
__device__ __forceinline__ void leg_equality(
    const Model& m, const Dual* x, const Dual* u, const Euler& e,
    const Dual (&omega)[3], const float* mask, float zp, float zv, int j,
    float* col, float* e_out) {
  Dual pb[3], jac[3][3];
  leg_chain<kLeg>(m, x + 12, pb, jac);
  const Dual* qd = u + 12 + 3 * joint_slot<kLeg>();
  Dual vb[3], arm[3], rvb[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    vb[a] = jac[0][a] * qd[0] + jac[1][a] * qd[1] + jac[2][a] * qd[2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    arm[a] = row3(e.R[a], pb[0], pb[1], pb[2]);
    rvb[a] = row3(e.R[a], vb[0], vb[1], vb[2]);
  }
  Dual v[4];
  v[0] = x[0] + (omega[1] * arm[2] - omega[2] * arm[1]) + rvb[0];
  v[1] = x[1] + (omega[2] * arm[0] - omega[0] * arm[2]) + rvb[1];
  v[2] = x[2] + (omega[0] * arm[1] - omega[1] * arm[0]) + rvb[2];
  v[3] = v[2] + m.gain * ((x[8] + arm[2]) - zp) - zv;
  const int rows[4] = {3 * kLeg, 3 * kLeg + 1, 3 * kLeg + 2, 12 + kLeg};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rows[i];
    col[r * kNx] = mask[r] * v[i].d;
    if (j == r) *e_out = mask[r] * v[i].v;
  }
}

// The soft cone's relaxed barrier p(h(F)) on one leg's force F
// (mpc/friction_cone.py::barrier_cost_quadratic): its gradient in F_a and
// its Hessian in (F_a, F_c), the latter with the cone's Hessian diagonal
// shift.
__device__ __forceinline__ void barrier(const Model& m, const float* F, int a,
                                        int c, float& grad, float& hess) {
  const float fx = F[0], fy = F[1];
  const float t2 = fx * fx + fy * fy + m.regularization;
  const float tn = sqrtf(t2);
  const float t32 = tn * t2;
  const float h = m.mu * (F[2] + m.gripper_force) - tn;
  const float dh_a = a == 0 ? -fx / tn : a == 1 ? -fy / tn : m.mu;
  const float dh_c = c == 0 ? -fx / tn : c == 1 ? -fy / tn : m.mu;
  float d2h = 0.f;
  if (a != 2 && c != 2)
    d2h = a != c ? fx * fy / t32
                 : -((a == 0 ? fy * fy : fx * fx) + m.regularization) / t32;
  if (a == c) d2h = d2h - m.hessian_shift;
  const float dl = m.barrier_delta;
  float dp, ddp;
  if (h >= dl) {
    dp = -m.barrier_mu / h;
    ddp = m.barrier_mu / (h * h);
  } else {
    dp = m.barrier_mu * (h - 2.f * dl) / (dl * dl);
    ddp = m.barrier_mu / (dl * dl);
  }
  grad = dp * dh_a;
  hess = ddp * dh_a * dh_c + dp * d2h;
}

// Two blocks per SM cap a thread at 168 registers, with ~92 bytes of
// spills: on an H100 that ran a fleet of 512 in 0.75 ms, where one block
// per SM (192 registers, no spill) took 1.27 ms and three (96 registers,
// 604 bytes of spills) 1.25 ms; 2, 4 or 8 stages per block ran alike.
__global__ void __launch_bounds__(kThreads, 2)
    legged_linearize_kernel(const __grid_constant__ Args args) {
  const Model& m = args.m;
  const int N = args.N;
  const long long stage = (long long)blockIdx.x * kStagesPerBlock +
                          threadIdx.x / kTangents;
  if (stage >= (long long)N * args.batch) return;
  const int j = threadIdx.x % kTangents;
  const int prob = (int)(stage / N), k = (int)(stage % N);
  const float* in[kNumIn];
#pragma unroll
  for (int i = 0; i < kNumIn; ++i)
    in[i] = args.in[i] == nullptr ? nullptr
                                  : args.in[i] + prob * args.in_stride[i];
  const float* xk = in[kX] + k * kNx;
  const float* uk = in[kU] + k * kNu;
  float en[kLegs];
#pragma unroll
  for (int l = 0; l < kLegs; ++l) en[l] = in[kEnable][k * kLegs + l];
  const float dt = in[kDts] == nullptr ? m.dt : in[kDts][k];

  Dual x[kNx], u[kNu];
#pragma unroll
  for (int i = 0; i < kNx; ++i) x[i] = {xk[i], i == j ? 1.f : 0.f};
#pragma unroll
  for (int i = 0; i < kNu; ++i) u[i] = {uk[i], kNx + i == j ? 1.f : 0.f};

  const long long sN = (long long)prob * N + k;  // this stage, all problems
  // Column j of [A | B] and of [C | D] (row strides of 24 floats).
  const bool is_x = j < kNx;
  const int jc = is_x ? j : j - kNx;
  float* colAB = args.out[is_x ? kA : kB] + sN * kNx * kNx + jc;
  float* colCD = args.out[is_x ? kC : kD] + sN * kNc * kNx + jc;

  Dual k1[kNx];
  rates(m, x, u, en, k1);
  {
    // The equality at (x_k, u_k); its eul_dot is k1's.
    Euler e;
    euler(x + 9, e);
    Dual omega[3];
    omega[0] = e.cz * e.cy * k1[11] - e.sz * k1[10];
    omega[1] = e.cz * k1[10] + e.sz * e.cy * k1[11];
    omega[2] = k1[9] - e.sy * k1[11];
    float mask[kNc];
#pragma unroll
    for (int r = 0; r < kNc; ++r) mask[r] = in[kEqMask][k * kNc + r];
    const float* zp = in[kZPos] + k * kLegs;
    const float* zv = in[kZVel] + k * kLegs;
    float* e_out = args.out[kE] + sN * kNc + j;
    leg_equality<0>(m, x, u, e, omega, mask, zp[0], zv[0], j, colCD, e_out);
    leg_equality<1>(m, x, u, e, omega, mask, zp[1], zv[1], j, colCD, e_out);
    leg_equality<2>(m, x, u, e, omega, mask, zp[2], zv[2], j, colCD, e_out);
    leg_equality<3>(m, x, u, e, omega, mask, zp[3], zv[3], j, colCD, e_out);
  }

  // The step: x + dt k1 (Euler) or x + dt k2(x + dt/2 k1) (RK2).
  Dual step[kNx];
  if (args.rk2) {
    Dual xm[kNx];
    const float half = 0.5f * dt;
#pragma unroll
    for (int i = 0; i < kNx; ++i) xm[i] = x[i] + half * k1[i];
    rates(m, xm, u, en, step);
  } else {
#pragma unroll
    for (int i = 0; i < kNx; ++i) step[i] = k1[i];
  }
  const float* xk1 = xk + kNx;  // x_{k+1}
  float* b_out = args.out[kBvec] + sN * kNx;
#pragma unroll
  for (int i = 0; i < kNx; ++i) {
    const Dual f = x[i] + dt * step[i];
    colAB[i * kNx] = f.d;
    if (i == j) b_out[i] = f.v - xk1[i];
  }

  // The cost: q (the last stage also writes q_N), r, and R in soft mode.
  const float* enk = in[kEnable] + k * kLegs;
  float* R_out = args.out[kRmat];
  if (is_x) {
    const float* xr = in[kXRef] + k * kNx;
    float* q_out = args.out[kQvec] + ((long long)prob * (N + 1) + k) * kNx;
    q_out[j] = m.q_diag[j] * (xk[j] - xr[j]);
    if (k == N - 1) q_out[kNx + j] = m.q_diag[j] * (xk1[j] - xr[kNx + j]);
  } else {
    const float* ur = in[kURef] + k * kNu;
    float r = m.r_diag[jc] * (uk[jc] - ur[jc]);
    if (R_out != nullptr && jc < 3 * kLegs) {
      const int l = jc / 3;
      float grad, hess;
      barrier(m, uk + 3 * l, jc % 3, jc % 3, grad, hess);
      r = r + grad * enk[l];
    }
    args.out[kRvec][sN * kNu + jc] = r;
  }
  if (R_out != nullptr) {
    // R's diagonal and zeros, then the four legs' 3 x 3 blocks.
    R_out += sN * kNu * kNu;
#pragma unroll 1
    for (int t = j; t < kNu * kNu; t += kTangents) {
      const int row = t / kNu, col = t % kNu;
      if (row < 3 * kLegs && row / 3 == col / 3) continue;
      R_out[t] = row == col ? m.r_diag[row] : 0.f;
    }
    if (j < 9 * kLegs) {
      const int l = j / 9, a = j % 9 / 3, c = j % 3;
      float grad, hess;
      barrier(m, uk + 3 * l, a, c, grad, hess);
      const int row = 3 * l + a;
      R_out[row * kNu + 3 * l + c] =
          (a == c ? m.r_diag[row] : 0.f) + hess * enk[l];
    }
  }
}

}  // namespace legged
}  // namespace cheeta

// in: the kNumIn input pointers (kDts may be null) and their per-problem
// strides in floats (0: shared by the batch); out: the kNumOut output
// pointers (kRmat null without the soft cone); dims: N, batch, rk2 (1) or
// Euler (0); params: the kNumParams floats of Model. Launches on stream;
// returns the CUDA error code of the launch (0 = success); never
// synchronizes.
extern "C" int cheeta_legged_linearize(const void* const* in,
                                       const long long* in_stride,
                                       void* const* out, const int* dims,
                                       const float* params, void* stream) {
  using namespace cheeta::legged;
  Args args;
  args.N = dims[0];
  args.batch = dims[1];
  args.rk2 = dims[2];
  if (args.N < 1 || args.batch < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kNumIn; ++i) {
    if (in[i] == nullptr && i != kDts) return (int)cudaErrorInvalidValue;
    args.in[i] = static_cast<const float*>(in[i]);
    args.in_stride[i] = in_stride[i];
  }
  for (int i = 0; i < kNumOut; ++i) {
    if (out[i] == nullptr && i != kRmat) return (int)cudaErrorInvalidValue;
    args.out[i] = static_cast<float*>(out[i]);
  }
  float* mp = reinterpret_cast<float*>(&args.m);
  for (int i = 0; i < kNumParams; ++i) mp[i] = params[i];
  const long long stages = (long long)args.N * args.batch;
  const unsigned blocks =
      (unsigned)((stages + kStagesPerBlock - 1) / kStagesPerBlock);
  legged_linearize_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

extern "C" int cheeta_legged_linearize_num_params() {
  return cheeta::legged::kNumParams;
}

// Resident blocks per SM, registers and local-memory (spill) bytes per
// thread and threads per block, into out[0..3].
extern "C" int cheeta_legged_linearize_occupancy(int* out) {
  using namespace cheeta::legged;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], legged_linearize_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, legged_linearize_kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = kThreads;
  return 0;
}
