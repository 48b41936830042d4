// flat_l2: full-precision distances between queries and stored vectors.
//
// Replaces: src/repro/kernels/flat_l2/kernel.py, flat_l2_pallas / _flat_kernel,
// and the jnp distance code of repro.core.pq.pairwise_distance (brute force,
// ground truth) and repro.core.pq.exact_distance (rerank, repro/core/flat.py).
//
// Two entries:
//  * dense:    q (B, D) x (N, D) -> (B, N), l2 = |q|^2 + |x|^2 - 2 q.x clamped
//    at >= 0, ip = -q.x; f32 or bf16 inputs, f32 accumulation. Matches
//    flat_l2_ref / pairwise_distance.
//  * gathered: q (B, D), x (N, D), ids (B, C) -> (B, C) in the DIFFERENCE form
//    sum (q - x)^2 (ip: -q.x), the arithmetic of exact_distance, so rerank ids
//    do not drift from the reference on near-ties the way the norm expansion
//    would. ids < 0 or >= N write +inf (the caller masks them).
//
// Bound on the H100. Dense at the main path's shapes (B=128 queries against
// N=1e5 vectors of D=768) does 2*B*N*D flops on N*D*4 bytes: 64 flops per
// byte, above the f32 SIMT line (67 TFLOP/s over 3.35 TB/s = 20), so
// operations bound it. The gathered rerank (C=50 rows per query) reads each
// row once for 3 flops per 4 bytes: bytes bound it.
//
// Design (first, simple version; wgmma/TMA come later):
//  * dense: a 64x64 output tile per block of 256 threads, 4x4 outputs per
//    thread, the D axis walked in steps of 16 through shared memory. Both
//    norms are accumulated from the same shared tiles, so the epilogue
//    (norms, -2 q.x, clamp) needs no second pass and no norm inputs.
//  * gathered: one warp per (query, candidate); lanes stride over D with
//    float4 loads when D % 4 == 0 and the rows are 16-byte aligned, then a
//    shuffle reduction.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void flat_dense_kernel(const T* __restrict__ q, const T* __restrict__ x,
                                  float* __restrict__ out, int B, int N, int D, int ip) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tx = threadIdx.x % (BN / TN);  // 0..15: column group
  const int ty = threadIdx.x / (BN / TN);  // 0..15: row group
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  float qn[TM] = {}, xn[TN] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += blockDim.x) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < B && gk < D) ? to_f32(q[(int64_t)gr * D + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < BN * BK; e += blockDim.x) {
      const int r = e / BK, kk = e % BK;
      const int gr = col0 + r, gk = k0 + kk;
      Bs[kk][r] = (gr < N && gk < D) ? to_f32(x[(int64_t)gr * D + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qn[i] = fmaf(a[i], a[i], qn[i]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) xn[j] = fmaf(bv[j], bv[j], xn[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= N) continue;
      float v;
      if (ip) {
        v = -acc[i][j];
      } else {
        v = qn[i] + xn[j] - 2.0f * acc[i][j];
        v = v > 0.f ? v : 0.f;
      }
      out[(int64_t)gr * N + gc] = v;
    }
  }
}

__global__ void flat_gathered_kernel(const float* __restrict__ q, const float* __restrict__ x,
                                     const int32_t* __restrict__ ids, float* __restrict__ out,
                                     int N, int C, int D, int ip, int vec4) {
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * warps + threadIdx.x / 32;
  const int64_t b = blockIdx.y;
  if (c >= C) return;
  const int64_t r = ids[b * C + c];
  if (r < 0 || r >= N) {
    if (lane == 0) out[b * C + c] = CUDART_INF_F;
    return;
  }
  const float* qq = q + b * D;
  const float* xx = x + r * D;
  float acc = 0.f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(qq);
    const float4* x4 = reinterpret_cast<const float4*>(xx);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 a = q4[i], v = x4[i];
      if (ip) {
        acc += a.x * v.x + a.y * v.y + a.z * v.z + a.w * v.w;
      } else {
        const float d0 = a.x - v.x, d1 = a.y - v.y, d2 = a.z - v.z, d3 = a.w - v.w;
        acc += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float a = qq[i], v = xx[i];
      acc += ip ? a * v : (a - v) * (a - v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b * C + c] = ip ? -acc : acc;
}

}  // namespace

extern "C" int repro_flat_l2_dense(const void* q, const void* x, float* out, int B, int N,
                                   int D, int is_bf16, int metric_ip, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  const int threads = (BM / TM) * (BN / TN);
  if (is_bf16) {
    flat_dense_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), out, B, N, D,
        metric_ip);
  } else {
    flat_dense_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), out, B, N, D, metric_ip);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_flat_l2_gathered(const float* q, const float* x, const int32_t* ids,
                                      float* out, int B, int N, int C, int D, int metric_ip,
                                      cudaStream_t stream) {
  const int threads = 256, warps = threads / 32;
  dim3 grid((C + warps - 1) / warps, B);
  const int vec4 = (D % 4) == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  flat_gathered_kernel<<<grid, threads, 0, stream>>>(q, x, ids, out, N, C, D, metric_ip, vec4);
  return (int)cudaGetLastError();
}
