// K1: the Riccati interior-point solve of ONE OCP-QP, one thread block.
// Takes per-problem constraint matrices and optional masked stage
// equalities (nc >= 0) and writes the Riccati gains K, k, P, p of the last
// iteration. Counterpart of ops/pallas_ipm_riccati.py::_ipm_kernel.
#include "ipm_launch.inl"

// timers: null launches the plain kernel, else the one with section timers.
extern "C" int cheeta_ipm_riccati_single(CHEETA_IPM_LAUNCH_PARAMS) {
  if (batch != 1 || threads > cheeta::kSingleThreads)
    return (int)cudaErrorInvalidValue;
  if (timers != nullptr)
    return cheeta::launch_single_timed(CHEETA_IPM_LAUNCH_ARGS);
  return cheeta::launch(
      CHEETA_PICK_SINGLE(scratch == nullptr, dims[4] > 0, false),
      CHEETA_IPM_LAUNCH_ARGS);
}

extern "C" int cheeta_ipm_riccati_single_occupancy(
    int factors_in_smem, int has_eq, int threads, long long smem_bytes,
    int* out) {
  return cheeta::occupancy(
      CHEETA_PICK_SINGLE(factors_in_smem != 0, has_eq != 0, false), threads,
      smem_bytes, out);
}

// What a kernel is built for, into out[0..2]: threads per block, blocks
// per SM, and the SPD inverse's tableau entries per thread (max(nu, nc)^2
// must not exceed them times the threads). kernel: 0 = K1, 1 = K2,
// 2 = K2 with stage equalities.
extern "C" void cheeta_ipm_launch_limits(int kernel, int* out) {
  out[0] = kernel ? cheeta::fleet_threads(kernel == 2)
                  : cheeta::kSingleThreads;
  out[1] = kernel ? cheeta::fleet_blocks_per_sm(kernel == 2) : 1;
  out[2] = cheeta::kInvMine;
}

// The form of the kernels' SPD inverse at width n: 1 = one warp's
// registers (n <= 32), 0 = spread over the block.
extern "C" int cheeta_ipm_inverse_form(int n) {
  return cheeta::warp_inverse_takes(n) ? 1 : 0;
}

// Shared-memory floats of one block: the iterate, work arrays and stage
// slots, plus the Riccati factors when they are kept in shared memory.
// dims is {N, nx, nu, ng, nc, iters} here and in the launchers.
extern "C" long long cheeta_ipm_smem_floats(const int* dims,
                                            int factors_in_smem) {
  const cheeta::Layout L =
      cheeta::make_layout(cheeta::dims_from(dims), factors_in_smem != 0);
  return (long long)L.total_vec + (factors_in_smem ? L.total_fac : 0);
}

// Floats of Riccati-factor storage per problem (the global scratch buffer
// when the factors do not stay in shared memory).
extern "C" long long cheeta_ipm_factor_floats(const int* dims) {
  return cheeta::make_layout(cheeta::dims_from(dims), false).total_fac;
}

extern "C" const char* cheeta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
