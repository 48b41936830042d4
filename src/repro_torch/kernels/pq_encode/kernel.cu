// pq_encode: nearest centroid per PQ subspace.
//
// Replaces: src/repro/kernels/pq_encode/kernel.py, pq_encode_pallas /
// _encode_kernel, and the jnp arithmetic of repro.core.pq.encode (ingest and
// re-quantization) and of the k-means assignment step in train_pq/refine_pq.
//
//   codes[n, m] = argmin_k ( |x_m|^2 - 2 x_m . c_mk + |c_mk|^2 )
//
// The |x_m|^2 term is kept, as repro.core.pq.encode computes it (the Pallas
// kernel drops it): it leaves the argmin unchanged in exact arithmetic but can
// flip near-ties in f32. Ties go to the first index; the output is uint8.
//
// Bound on the H100: at the main path's shapes (N=100 rows per insert
// mini-batch, D=768, M=96, K=256, dsub=8) each row is read once and compared
// with all M*K centroids: 2*K*dsub flops per 4*dsub bytes, ~128 flops per
// byte, so operations bound it (f32 SIMT).
//
// Design: one block per (tile of 128 rows, subspace m). The block stages the
// subspace's K x dsub codebook and its K norms in shared memory once; each
// thread keeps its row's dsub values in registers (dsub <= 32) and scans the
// K centroids, which every thread of the warp reads at the same address (a
// shared-memory broadcast).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDsub = 32;

__global__ void pq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                                 uint8_t* __restrict__ codes, int N, int M, int K, int dsub) {
  extern __shared__ float smem[];
  float* cent = smem;             // K * dsub
  float* cnorm = smem + K * dsub; // K
  const int m = blockIdx.y;
  const float* cbm = cb + (int64_t)m * K * dsub;
  for (int i = threadIdx.x; i < K * dsub; i += blockDim.x) cent[i] = cbm[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < dsub; ++j) s += cent[k * dsub + j] * cent[k * dsub + j];
    cnorm[k] = s;
  }
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int D = M * dsub;
  float xv[kMaxDsub];
  float xx = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxDsub; ++j) {
    xv[j] = j < dsub ? x[n * D + (int64_t)m * dsub + j] : 0.f;
    xx += xv[j] * xv[j];
  }
  float best = 0.f;
  int best_k = -1;
  for (int k = 0; k < K; ++k) {
    const float* c = cent + k * dsub;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDsub; ++j)
      if (j < dsub) dot += xv[j] * c[j];
    const float d = (xx - 2.0f * dot) + cnorm[k];
    if (best_k < 0 || d < best) {  // strict: the first index wins ties
      best = d;
      best_k = k;
    }
  }
  codes[n * M + m] = (uint8_t)(best_k < 0 ? 0 : best_k);
}

}  // namespace

extern "C" int repro_pq_encode(const float* x, const float* codebooks, uint8_t* codes, int N,
                               int M, int K, int dsub, cudaStream_t stream) {
  if (dsub > kMaxDsub) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * (dsub + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pq_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 128;
  dim3 grid((N + threads - 1) / threads, M);
  pq_encode_kernel<<<grid, threads, smem, stream>>>(x, codebooks, codes, N, M, K, dsub);
  return (int)cudaGetLastError();
}
