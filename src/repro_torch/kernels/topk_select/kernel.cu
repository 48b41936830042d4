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
// Bound on the H100: bytes -- one read of the row and L values written; the
// work per byte is a handful of compares. At the long rows of the brute and
// Q-Flat plans (B=128, N=1e5) that is 51.2 MB, 0.0153 ms at 3.35 TB/s.
//
// Design, three forms picked by the launcher from N and L:
//  * rank, N <= 1024 (beam merge N=264, frontier N=100, rerank N=50, prune
//    cut N~300): one block per row; the row's keys sit in shared memory and
//    every entry computes its rank as the number of smaller keys; entries
//    with rank < L write themselves to slot rank. One pass.
//  * long, N > 1024 and L <= kLongMaxL (brute force, ground truth, Q-Flat
//    over the collection): two stages, as the Pallas kernel's blockwise
//    top-L plus merge, but each reads its input once. Stage 1 cuts each row
//    into S chunks (the wrapper picks S, two at B=128) and gives each (row,
//    chunk) a block of 256 threads. The block reads its chunk once in
//    16-byte loads, the next round's in flight while one is filtered, and
//    keeps a running top-L in a shared buffer. A thread makes its 8 keys of
//    a round and tests them against the threshold together; only keys below
//    it are appended (slots from a warp-aggregated atomic), one per thread
//    per step with one __syncthreads_count, and when max(2L, 256) keys are
//    held the buffer is bitonic-sorted, cut to L, and the threshold drops to
//    the L-th key. The first cut comes after 256 keys, so the threshold
//    drops at once and sorts stay short; after that few keys pass, and a
//    round that appends nothing costs one barrier. Each block writes its L
//    smallest keys to a (B, S, L) int64 workspace (a short chunk pads with
//    ~0, which sorts after every real key). Stage 2 gives each row a block
//    that runs the same selection over the row's S*L keys and writes values
//    and positions. One C launcher launches both kernels.
//  * iter, N > 1024 and L > kLongMaxL (off the search and build path): one
//    block per row, L iterations of a block-wide min over the keys strictly
//    above the last one selected.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kRankMaxN = 1024;
constexpr int kThreads = 256;    // long form: threads per block
constexpr int kCap = 2048;       // long form: candidate buffer (16 KB of keys)
constexpr int kLongMaxL = 1024;  // below a cut's limit, kCap - kThreads
constexpr u64 kNone = ~0ull;     // above every real key

__device__ __forceinline__ u64 make_key(float x, int i) {
  uint32_t u;
  if (isnan(x)) {
    u = 0xffffffffu;
  } else {
    if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0
    const uint32_t bits = __float_as_uint(x);
    u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  }
  return ((u64)u << 32) | (uint32_t)i;
}

__device__ __forceinline__ void write_out(const float* row, float* vals, int32_t* idx,
                                          int slot, int pos, int mark) {
  const float v = row[pos];
  vals[slot] = v;
  idx[slot] = (mark && !isfinite(v)) ? -1 : pos;
}

__global__ void topk_rank_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                 int32_t* __restrict__ idx, int N, int L, int mark) {
  __shared__ u64 keys[kRankMaxN];
  const int64_t b = blockIdx.x;
  const float* row = d + b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) keys[i] = make_key(row[i], i);
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const u64 k = keys[i];
    int rank = 0;
    for (int j = 0; j < N; ++j) rank += keys[j] < k;
    if (rank < L) write_out(row, vals + b * L, idx + b * L, rank, i, mark);
  }
}

// ---- long form: a running top-L per block ---------------------------------

struct TopL {
  u64 buf[kCap];  // the current top-L (sorted after a cut) and new candidates
  u64 thr;        // only keys below it can enter: the L-th key once L are kept
  int cnt;
};

// Ascending bitonic sort of a[0, n), n a power of two <= kCap; all threads.
__device__ void bitonic_sort(u64* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const u64 x = a[i], y = a[i + j];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Sort the cnt buffered keys, keep the L smallest, lower the threshold.
// All threads, with the same cnt (s.cnt, which no thread changes meanwhile).
__device__ void cut_to_L(TopL& s, int cnt, int L) {
  int n = 32;
  while (n < cnt) n <<= 1;
  for (int i = cnt + threadIdx.x; i < n; i += kThreads) s.buf[i] = kNone;
  __syncthreads();
  bitonic_sort(s.buf, n);
  if (threadIdx.x == 0) {
    s.cnt = min(cnt, L);
    if (cnt >= L) s.thr = s.buf[L - 1];
  }
  __syncthreads();
}

// Where a selection reads from. Each round a thread loads kPer entries at
// once (Raw, issued a round ahead); key(raw, r, e) is the e-th as a key,
// kNone past the end.

// A chunk [lo, hi) of a row of floats: kPer / 4 float4 per thread (kVec: lo
// and hi are multiples of 4 and the row is 16-byte aligned), else kPer
// scalars; neighbouring threads read neighbouring entries either way.
template <bool kVec>
struct FloatChunk {
  static constexpr int kPer = 8;
  const float* row;
  int lo, hi;
  struct Raw {
    float4 v[kPer / 4];
  };
  __device__ int index(int r, int e) const {
    return kVec ? lo + r + ((e / 4) * kThreads + threadIdx.x) * 4 + e % 4
                : lo + r + e * kThreads + threadIdx.x;
  }
  __device__ Raw load(int r) const {
    Raw raw;
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      if (kVec) {
        const int i = index(r, 4 * j);
        raw.v[j] = i < hi ? __ldcs(reinterpret_cast<const float4*>(row + i))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = index(r, 4 * j + e);
          v[e] = i < hi ? __ldcs(row + i) : 0.f;
        }
        raw.v[j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    return raw;
  }
  __device__ u64 key(const Raw& raw, int r, int e) const {
    const int i = index(r, e);
    const float4& v = raw.v[e / 4];
    const float x = e % 4 == 0 ? v.x : (e % 4 == 1 ? v.y : (e % 4 == 2 ? v.z : v.w));
    return i < hi ? make_key(x, i) : kNone;
  }
};

// n keys already made (a row of the merge's workspace).
struct KeyRow {
  static constexpr int kPer = 4;
  const u64* keys;
  int n;
  struct Raw {
    u64 v[kPer];
  };
  __device__ Raw load(int r) const {
    Raw raw;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = r + e * kThreads + threadIdx.x;
      raw.v[e] = i < n ? keys[i] : kNone;
    }
    return raw;
  }
  __device__ u64 key(const Raw& raw, int, int e) const { return raw.v[e]; }
};

// The L smallest of the n entries of src, sorted into s.buf[0, s.cnt) with
// s.cnt = min(n, L); all threads. Each round a thread makes its kPer keys and
// tests them against the threshold together (no dependence between them).
// Only the keys that pass are appended, one per thread per step at slots from
// one warp-aggregated atomic; one __syncthreads_count per step publishes them
// and gives every thread the buffer's count, and the buffer is cut to L as
// soon as it holds `limit` keys. Once the threshold has dropped, most rounds
// append nothing and cost one barrier. A key tested against an older, higher
// threshold is tested again before it is appended.
template <class Src>
__device__ void block_select(TopL& s, const Src& src, int n, int L) {
  constexpr int kRound = kThreads * Src::kPer;
  const int lane = threadIdx.x % 32;
  const int limit = min(max(2 * L, kThreads), kCap - kThreads);  // > L: a cut frees room
  if (threadIdx.x == 0) {
    s.cnt = 0;
    s.thr = kNone;
  }
  __syncthreads();
  int cnt = 0;  // s.cnt, the same in every thread
  typename Src::Raw cur = src.load(0), nxt = cur;
  for (int r = 0; r < n; r += kRound) {
    if (r + kRound < n) nxt = src.load(r + kRound);
    u64 k[Src::kPer];
    unsigned pass = 0;  // bit e: key e of this round was below the threshold
    const u64 thr = s.thr;
#pragma unroll
    for (int e = 0; e < Src::kPer; ++e) {
      k[e] = src.key(cur, r, e);
      pass |= (unsigned)(k[e] < thr) << e;
    }
    while (__syncthreads_or(pass != 0)) {
      const int e = __ffs(pass) - 1;  // -1: none left in this thread
      u64 key = kNone;
#pragma unroll
      for (int j = 0; j < Src::kPer; ++j) key = j == e ? k[j] : key;
      pass &= pass - 1;
      const bool take = e >= 0 && key < s.thr;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (m) {
        const int leader = __ffs(m) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&s.cnt, __popc(m));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (take) s.buf[base + __popc(m & ((1u << lane) - 1))] = key;
      }
      cnt += __syncthreads_count(take);
      if (cnt >= limit) {
        cut_to_L(s, cnt, L);
        cnt = min(cnt, L);
      }
    }
    cur = nxt;
  }
  cut_to_L(s, cnt, L);
}

// Stage 1: block (b, c) selects the L smallest keys of chunk c of row b.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) topk_chunk_kernel(
    const float* __restrict__ d, u64* __restrict__ ws, int N, int L, int S, int chunk) {
  __shared__ TopL s;
  const int64_t b = blockIdx.x;
  const int c = blockIdx.y;
  const int lo = c * chunk, hi = min(N, lo + chunk);
  block_select(s, FloatChunk<kVec>{d + b * N, lo, hi}, hi - lo, L);
  u64* out = ws + (b * S + c) * L;
  for (int i = threadIdx.x; i < L; i += kThreads) out[i] = i < s.cnt ? s.buf[i] : kNone;
}

// Stage 2: block b merges the S*L keys of row b to its L smallest.
__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
    const u64* __restrict__ ws, const float* __restrict__ d, float* __restrict__ vals,
    int32_t* __restrict__ idx, int N, int L, int S, int mark) {
  __shared__ TopL s;
  const int64_t b = blockIdx.x;
  block_select(s, KeyRow{ws + b * S * L, S * L}, S * L, L);
  // N >= L real keys, each below kNone: the first L are real
  const float* row = d + b * N;
  for (int i = threadIdx.x; i < L; i += kThreads)
    write_out(row, vals + b * L, idx + b * L, i, (int)(uint32_t)(s.buf[i] & 0xffffffffull),
              mark);
}

// ---- iter form: L > kLongMaxL ---------------------------------------------

__global__ void topk_iter_kernel(const float* __restrict__ d, float* __restrict__ vals,
                                 int32_t* __restrict__ idx, int N, int L, int mark) {
  __shared__ u64 warp_min[32];
  __shared__ u64 chosen;
  const int64_t b = blockIdx.x;
  const float* row = d + b * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  u64 prev = 0ull;  // every key is > 0: NaN bits are canonical
  for (int s = 0; s < L; ++s) {
    u64 best = kNone;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const u64 k = make_key(row[i], i);
      if (k > prev && k < best) best = k;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const u64 o = __shfl_down_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    if (lane == 0) warp_min[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? warp_min[lane] : kNone;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const u64 o = __shfl_down_sync(0xffffffffu, best, off);
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

// ws: (B, S, L) int64 workspace of the long form (NULL for the others);
// chunk: entries per chunk, a multiple of 4, with S = ceil(N / chunk).
extern "C" int repro_topk_select(const float* d, float* vals, int32_t* idx, void* ws, int B,
                                 int N, int L, int S, int chunk, int mark_nonfinite,
                                 cudaStream_t stream) {
  if (N <= kRankMaxN) {
    const int threads = N <= 128 ? 128 : (N <= 256 ? 256 : 512);
    topk_rank_kernel<<<B, threads, 0, stream>>>(d, vals, idx, N, L, mark_nonfinite);
  } else if (L <= kLongMaxL) {
    u64* keys = static_cast<u64*>(ws);
    const dim3 grid(B, S);
    if (N % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0) {
      topk_chunk_kernel<true><<<grid, kThreads, 0, stream>>>(d, keys, N, L, S, chunk);
    } else {
      topk_chunk_kernel<false><<<grid, kThreads, 0, stream>>>(d, keys, N, L, S, chunk);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    topk_merge_kernel<<<B, kThreads, 0, stream>>>(keys, d, vals, idx, N, L, S, mark_nonfinite);
  } else {
    topk_iter_kernel<<<B, 1024, 0, stream>>>(d, vals, idx, N, L, mark_nonfinite);
  }
  return (int)cudaGetLastError();
}
