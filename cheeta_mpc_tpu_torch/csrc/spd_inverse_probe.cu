// A probe of the interior-point kernels' SPD inverse (ipm_riccati.cuh),
// which no solve launches: it inverts a batch of n x n matrices, one per
// block of K1's kSingleThreads threads, either in the form that the
// kernels take at width n (spd_inverse) or in the block form at any width
// (block_spd_inverse), so that the two can be held against each other bit
// for bit. The block's shared memory holds M, the scales, the block form's
// pivot buffers and the result; thread 0 times the inverse alone.
#include "ipm_launch.inl"

namespace cheeta {

template <bool kBlockForm>
__global__ void __launch_bounds__(kSingleThreads, 1)
    spd_inverse_probe_kernel(const float* __restrict__ M,
                             float* __restrict__ out,
                             long long* __restrict__ cycles, int n) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, nn = n * n;
  float *Ms = smem, *sv = Ms + nn, *rowb = sv + n, *colb = rowb + 2 * n,
        *res = colb + 2 * n;
  const float* Mb = M + (size_t)blockIdx.x * nn;
  for (int i = tid; i < nn; i += nt) Ms[i] = Mb[i];
  __syncthreads();
  for (int i = tid; i < n; i += nt) sv[i] = inv_scale(Ms[i * n + i]);
  __syncthreads();
  const long long t0 = clock64();
  if (kBlockForm) block_spd_inverse(Ms, res, n, sv, rowb, colb);
  else spd_inverse(smem, Ms, res, n, sv, rowb, colb);
  const long long t1 = clock64();
  float* ob = out + (size_t)blockIdx.x * nn;
  for (int i = tid; i < nn; i += nt) ob[i] = res[i];
  if (tid == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace cheeta

// out[b] = inverse of sym(M[b]) for b < batch, M and out (batch, n, n)
// float32 on the card, cycles (batch,) int64: the clock64 cycles of each
// block's inverse. block_form != 0 takes the block form at any n; else the
// form the kernels take at n (cheeta_ipm_inverse_form). n must satisfy
// n * n <= kInvMine * kSingleThreads. Returns the launch's CUDA error code.
extern "C" int cheeta_spd_inverse_probe(const float* M, float* out,
                                        long long* cycles, int batch, int n,
                                        int block_form, void* stream) {
  if (batch < 1 || n < 1 || n * n > cheeta::kInvMine * cheeta::kSingleThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * n * n + 5 * n);
  auto kernel = block_form ? cheeta::spd_inverse_probe_kernel<true>
                           : cheeta::spd_inverse_probe_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, cheeta::kSingleThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(M, out, cycles, n);
  return (int)cudaGetLastError();
}
