// K2: the same Riccati interior-point solve over a batch, one thread block
// per problem (grid = batch). The constraint matrices C/D are shared by the
// batch (stride 0), there are no stage equalities, and no gains are
// written. Counterpart of ops/pallas_ipm_batch.py::_fleet_kernel.
#include "ipm_riccati.cuh"

namespace cheeta {

template <bool kFacShared, bool kAbShared>
__global__ void ipm_riccati_fleet_kernel(const IpmArgs args) {
  extern __shared__ float smem[];
  ipm_solve<kFacShared, kAbShared>(args, smem);
}

}  // namespace cheeta

#include "ipm_launch.inl"

extern "C" int cheeta_ipm_riccati_fleet(
    const void* const* in, const long long* in_stride, void* const* out,
    const long long* out_stride, void* scratch, long long scratch_stride,
    const int* dims, const float* params, int batch, int threads,
    long long smem_bytes, void* stream) {
  if (dims[4] != 0) return (int)cudaErrorInvalidValue;  // nc must be 0
  return cheeta::launch(CHEETA_PICK_KERNEL(cheeta::ipm_riccati_fleet_kernel,
                                          scratch == nullptr, dims[6] != 0),
                        in, in_stride, out,
                        out_stride, scratch, scratch_stride, dims, params,
                        batch, threads, smem_bytes, stream);
}
