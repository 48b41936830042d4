// topk_select: the L smallest entries of each row, as values and raw positions.
//
// Replaces: src/repro/kernels/topk_select/kernel.py, topk_select_pallas /
// _topk_block_kernel, and every lax.top_k of the query and build path
// (frontier pick and beam merge in repro/core/search.py, the cuts of
// repro/core/flat.py, the R-cut of repro/core/prune.py, recall.ground_truth).
//
// Order: ascending value, ties to the LOWER position, +inf entries included
// (NaN sorts after +inf, -0.0 equals +0.0) -- exactly a stable ascending sort
// cut to L, and lax.top_k(-x)'s tie rule. Each entry becomes one 64-bit key,
// (order-preserving bits of the value) << 32 | position, so keys are unique
// and "L smallest keys" is the answer with ties already broken. With
// mark_nonfinite the position of a non-finite value is written as -1 (the
// brute-force / Q-Flat / rerank convention); without it raw positions come
// back, which the beam merge and frontier pick need because they gather by
// position.
//
// Bound on the H100: bytes (one read of the row, L values written); the
// work per byte is a handful of compares.
//
// Design: one block per row, two forms picked by the row length.
//  * N <= 1024 (beam merge N=264, frontier N=100, rerank N=50, prune cut
//    N~300): the row's keys sit in shared memory and every entry computes its
//    rank as the number of smaller keys; entries with rank < L write
//    themselves to slot rank. One pass, no sequential dependence on L.
//  * larger N (brute force, ground truth, Q-Flat over the collection): L
//    iterations, each a block-wide min over the keys strictly above the last
//    one selected -- the Pallas body's iterated masked argmin, with the mask
//    replaced by a threshold so the input is never written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRankMaxN = 1024;

__device__ __forceinline__ unsigned long long make_key(float x, int i) {
  uint32_t u;
  if (isnan(x)) {
    u = 0xffffffffu;
  } else {
    if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0
    const uint32_t bits = __float_as_uint(x);
    u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (uint32_t)i;
}

__device__ __forceinline__ void write_out(const float* row, float* vals, int32_t* idx,
                                          int slot, int pos, int mark) {
  const float v = row[pos];
  vals[slot] = v;
  idx[slot] = (mark && !isfinite(v)) ? -1 : pos;
}

__global__ void topk_rank_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                 int32_t* __restrict__ idx, int N, int L, int mark) {
  __shared__ unsigned long long keys[kRankMaxN];
  const int64_t b = blockIdx.x;
  const float* row = d + b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) keys[i] = make_key(row[i], i);
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const unsigned long long k = keys[i];
    int rank = 0;
    for (int j = 0; j < N; ++j) rank += keys[j] < k;
    if (rank < L) write_out(row, vals + b * L, idx + b * L, rank, i, mark);
  }
}

__global__ void topk_iter_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                 int32_t* __restrict__ idx, int N, int L, int mark) {
  __shared__ unsigned long long warp_min[32];
  __shared__ unsigned long long chosen;
  const int64_t b = blockIdx.x;
  const float* row = d + b * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  unsigned long long prev = 0ull;  // every key is > 0: NaN bits are canonical
  for (int s = 0; s < L; ++s) {
    unsigned long long best = ~0ull;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const unsigned long long k = make_key(row[i], i);
      if (k > prev && k < best) best = k;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    if (lane == 0) warp_min[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_min[lane] : ~0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
        best = o < best ? o : best;
      }
      if (lane == 0) {
        chosen = best;
        write_out(row, vals + b * L, idx + b * L, s, (int)(uint32_t)(best & 0xffffffffull), mark);
      }
    }
    __syncthreads();
    prev = chosen;
  }
}

}  // namespace

extern "C" int repro_topk_select(const float* d, float* vals, int32_t* idx, int B, int N,
                                 int L, int mark_nonfinite, cudaStream_t stream) {
  if (N <= kRankMaxN) {
    const int threads = N <= 128 ? 128 : (N <= 256 ? 256 : 512);
    topk_rank_kernel<<<B, threads, 0, stream>>>(d, vals, idx, N, L, mark_nonfinite);
  } else {
    topk_iter_kernel<<<B, 1024, 0, stream>>>(d, vals, idx, N, L, mark_nonfinite);
  }
  return (int)cudaGetLastError();
}
