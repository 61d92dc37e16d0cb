// K3: the equality-constrained Riccati solve of ONE problem; writes dx, du
// and the gains K, k, P, p. Counterpart of
// ops/pallas_riccati.py::_eq_lqr_kernel.
#include "eq_launch.inl"

// timers: null launches the plain kernel, else the one with section timers.
extern "C" int cheeta_eq_riccati_single(CHEETA_EQ_LAUNCH_PARAMS) {
  if (batch != 1 || out[4] == nullptr || out[5] == nullptr)
    return (int)cudaErrorInvalidValue;
  if (timers != nullptr)
    return cheeta::launch_eq_single_timed(CHEETA_EQ_LAUNCH_ARGS);
  return cheeta::launch_eq(cheeta::eq_riccati_single_kernel<false>,
                           CHEETA_EQ_LAUNCH_ARGS);
}

extern "C" int cheeta_eq_riccati_single_occupancy(long long smem_bytes,
                                                  int* out) {
  return cheeta::occupancy(cheeta::eq_riccati_single_kernel<false>,
                           cheeta::kEqTeamThreads, smem_bytes, out);
}

// Threads per block of both kernels: a block is the team that solves one
// problem.
extern "C" int cheeta_eq_block_threads() { return cheeta::kEqTeamThreads; }

// Shared-memory floats of one block; dims is {N, nx, nu, nc, stage slots}
// here and in the launchers.
extern "C" long long cheeta_eq_smem_floats(const int* dims) {
  return cheeta::make_eq_layout(
             cheeta::EqDims{dims[0], dims[1], dims[2], dims[3]}, dims[4])
      .total;
}
