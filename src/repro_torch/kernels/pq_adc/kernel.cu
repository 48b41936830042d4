// pq_adc: asymmetric (ADC) distances from per-query lookup tables.
//
// Replaces: src/repro/kernels/pq_adc/kernel.py, pq_adc_pallas / _adc_kernel,
// and the jnp gathers of repro.core.pq.adc_distance_versioned that the search
// loop (repro/core/search.py expand_frontier) and Q-Flat (repro/core/flat.py
// qflat_scan) use.
//
//   out[b, c] = sum_m luts[b, v, m, codes[r, m]]   with r = ids[b, c] (gathered)
//                                                  or r = c (dense), v = versions[r]
//
// Bound on the H100: bytes. Each lookup is one byte of code and one 4-byte
// table read for one add, far below the card's operations-per-byte line. The
// TPU kernel turned the lookup into a one-hot x LUT product for the MXU; on
// Hopper it is a plain gather, so no one-hot is ever built.
//
// Design.
//  * Gathered form (one beam round: B=128 queries x C=W*R_slack=164 rows):
//    one warp per (query, candidate). The lanes stride over the M subspaces,
//    so the warp reads the candidate's code row as one coalesced 96-byte run,
//    and the sum ends in a shuffle reduction. The kernel gathers the code row
//    by id itself: no (B, C, M) tensor is ever built. The LUT is read from
//    global memory: a round touches 164 x 96 entries of each query's
//    V*M*K*4 = 196,608-byte table, and the 128 tables (25 MB) stay in L2.
//  * Dense form (Q-Flat over all N rows): every row is looked up in every
//    table, so one query's table is staged once in dynamic shared memory
//    (196,608 B at V=2, M=96, K=256 -- above the 48 KB static limit, so the
//    launcher raises the block's limit with cudaFuncSetAttribute) and a grid
//    of blocks per query sweeps the rows, one thread per row. A table that
//    does not fit the block's shared memory falls back to the gathered kernel
//    with implicit ids.
//  * ids < 0 or >= N write +inf; the caller masks such lanes anyway.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void adc_gathered_kernel(const float* __restrict__ luts,
                                    const uint8_t* __restrict__ codes,
                                    const uint8_t* __restrict__ versions,
                                    const int32_t* __restrict__ ids,
                                    float* __restrict__ out,
                                    int V, int M, int K, int N, int C) {
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * warps + threadIdx.x / 32;
  const int b = blockIdx.y;
  if (c >= C) return;
  const int64_t r = ids ? (int64_t)ids[(int64_t)b * C + c] : (int64_t)c;
  if (r < 0 || r >= N) {
    if (lane == 0) out[(int64_t)b * C + c] = CUDART_INF_F;
    return;
  }
  int v = versions[r];
  v = v < V ? v : V - 1;
  const float* lut = luts + ((int64_t)b * V + v) * M * K;
  const uint8_t* row = codes + r * M;
  float acc = 0.f;
  for (int m = lane; m < M; m += 32) acc += lut[m * K + row[m]];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(int64_t)b * C + c] = acc;
}

__global__ void adc_dense_smem_kernel(const float* __restrict__ luts,
                                      const uint8_t* __restrict__ codes,
                                      const uint8_t* __restrict__ versions,
                                      float* __restrict__ out,
                                      int V, int M, int K, int N) {
  extern __shared__ float table[];  // V * M * K floats of query b
  const int b = blockIdx.y;
  const int entries = V * M * K;
  const float4* src = reinterpret_cast<const float4*>(luts + (int64_t)b * entries);
  float4* dst = reinterpret_cast<float4*>(table);
  for (int i = threadIdx.x; i < entries / 4; i += blockDim.x) dst[i] = src[i];
  for (int i = (entries / 4) * 4 + threadIdx.x; i < entries; i += blockDim.x)
    table[i] = luts[(int64_t)b * entries + i];
  __syncthreads();
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < N;
       r += (int64_t)gridDim.x * blockDim.x) {
    int v = versions[r];
    v = v < V ? v : V - 1;
    const float* t = table + v * M * K;
    const uint8_t* row = codes + r * M;
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc += t[m * K + row[m]];
    out[(int64_t)b * N + r] = acc;
  }
}

}  // namespace

extern "C" int repro_pq_adc(const float* luts, const uint8_t* codes,
                            const uint8_t* versions, const int32_t* ids,
                            float* out, int B, int V, int M, int K, int N, int C,
                            cudaStream_t stream) {
  const size_t smem = (size_t)V * M * K * sizeof(float);
  int device = 0, smem_optin = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool aligned = (reinterpret_cast<uintptr_t>(luts) % 16) == 0 && (V * M * K) % 4 == 0;
  if (ids == nullptr && smem <= (size_t)smem_optin && aligned) {
    cudaError_t e = cudaFuncSetAttribute(adc_dense_smem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = 512;
    // one table residency per block: enough blocks per query to fill the
    // card about twice over, never more than the rows need
    int per_query = (2 * sms + B - 1) / B;
    const int need = (N + threads - 1) / threads;
    per_query = per_query < need ? per_query : need;
    per_query = per_query < 1 ? 1 : per_query;
    dim3 grid(per_query, B);
    adc_dense_smem_kernel<<<grid, threads, smem, stream>>>(luts, codes, versions, out, V, M, K, N);
  } else {
    const int threads = 256, warps = threads / 32;
    dim3 grid((C + warps - 1) / warps, B);
    adc_gathered_kernel<<<grid, threads, 0, stream>>>(luts, codes, versions, ids, out, V, M, K, N, C);
  }
  return (int)cudaGetLastError();
}
