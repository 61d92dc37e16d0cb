// K4: the same equality-constrained Riccati solve over a batch (any batch
// >= 1); every input is per problem or shared by the batch. Writes dx, du,
// K, k; no P, p. Counterpart of ops/pallas_eq_batch.py::_eq_fleet_kernel.
#include "eq_launch.inl"

// timers: null launches the plain kernel, else the one with section timers.
extern "C" int cheeta_eq_riccati_fleet(CHEETA_EQ_LAUNCH_PARAMS) {
  if (out[4] != nullptr || out[5] != nullptr)  // no P, p from this kernel
    return (int)cudaErrorInvalidValue;
  if (timers != nullptr)
    return cheeta::launch_eq_fleet_timed(CHEETA_EQ_LAUNCH_ARGS);
  return cheeta::launch_eq(cheeta::eq_riccati_fleet_kernel<false>,
                           CHEETA_EQ_LAUNCH_ARGS);
}

extern "C" int cheeta_eq_riccati_fleet_occupancy(long long smem_bytes,
                                                 int* out) {
  return cheeta::occupancy(cheeta::eq_riccati_fleet_kernel<false>,
                           cheeta::kEqTeamThreads, smem_bytes, out);
}
