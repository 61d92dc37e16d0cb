// K1: the Riccati interior-point solve of ONE OCP-QP, one thread block.
// Takes per-problem constraint matrices and optional masked stage
// equalities (nc >= 0) and writes the Riccati gains K, k, P, p of the last
// iteration. Counterpart of ops/pallas_ipm_riccati.py::_ipm_kernel.
#include "ipm_riccati.cuh"

namespace cheeta {

template <bool kFacShared, bool kAbShared>
__global__ void ipm_riccati_single_kernel(const IpmArgs args) {
  extern __shared__ float smem[];
  ipm_solve<kFacShared, kAbShared>(args, smem);
}

}  // namespace cheeta

#include "ipm_launch.inl"

extern "C" int cheeta_ipm_riccati_single(
    const void* const* in, const long long* in_stride, void* const* out,
    const long long* out_stride, void* scratch, long long scratch_stride,
    const int* dims, const float* params, int batch, int threads,
    long long smem_bytes, void* stream) {
  if (batch != 1) return (int)cudaErrorInvalidValue;
  return cheeta::launch(CHEETA_PICK_KERNEL(cheeta::ipm_riccati_single_kernel,
                                          scratch == nullptr, dims[6] != 0),
                        in, in_stride, out,
                        out_stride, scratch, scratch_stride, dims, params, 1,
                        threads, smem_bytes, stream);
}

// Shared-memory floats of one block: the iterate and work arrays, plus the
// Riccati factors when they are kept in shared memory, plus the resident
// copy of A and B when dims asks for it. dims is {N, nx, nu, ng, nc, iters,
// ab} here and in the launchers.
extern "C" long long cheeta_ipm_smem_floats(const int* dims,
                                            int factors_in_smem) {
  const cheeta::Layout L = cheeta::make_layout(cheeta::dims_from(dims));
  return (long long)L.total_vec + (factors_in_smem ? L.total_fac : 0) +
         L.total_ab;
}

// Floats of Riccati-factor storage per problem (the global scratch buffer
// when the factors do not stay in shared memory).
extern "C" long long cheeta_ipm_factor_floats(const int* dims) {
  return cheeta::make_layout(cheeta::dims_from(dims)).total_fac;
}

extern "C" const char* cheeta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
