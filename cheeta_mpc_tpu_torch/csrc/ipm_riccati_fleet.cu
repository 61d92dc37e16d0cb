// K2: the same Riccati interior-point solve over a batch, one thread block
// per problem (grid = batch). The constraint matrices C/D are shared by the
// batch (stride 0); masked stage equalities (nc > 0), per problem, take the
// instantiation with the elimination; no gains are written. Counterpart of
// ops/pallas_ipm_batch.py::_fleet_kernel.
#include "ipm_launch.inl"

// timers: null launches the plain kernel, else the one with section timers.
extern "C" int cheeta_ipm_riccati_fleet(CHEETA_IPM_LAUNCH_PARAMS) {
  if (threads > cheeta::fleet_threads(dims[4] > 0))
    return (int)cudaErrorInvalidValue;
  if (timers != nullptr)
    return cheeta::launch_fleet_timed(CHEETA_IPM_LAUNCH_ARGS);
  return cheeta::launch(
      CHEETA_PICK_FLEET(scratch == nullptr, dims[4] > 0, false),
      CHEETA_IPM_LAUNCH_ARGS);
}

extern "C" int cheeta_ipm_riccati_fleet_occupancy(
    int factors_in_smem, int has_eq, int threads, long long smem_bytes,
    int* out) {
  return cheeta::occupancy(
      CHEETA_PICK_FLEET(factors_in_smem != 0, has_eq != 0, false), threads,
      smem_bytes, out);
}
