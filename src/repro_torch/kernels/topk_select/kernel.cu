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
// Design, three forms; ops.py picks one by N and L (topk_form) and passes
// its code:
//  * rank, N <= 1024 (beam merge N=264, frontier N=100, rerank N=50, prune
//    cut N~316): a bitonic sort of the row's keys padded with kNone to P, a
//    power of two >= max(N, 32), cut to L. A thread holds E = 2 consecutive
//    keys (one for P = 32) in registers: the stride-1 stages are exchanged in
//    registers, strides below 32E with __shfl_xor_sync, and only larger ones
//    (P >= 128, two or more warps to a row) through shared memory, two
//    buffers in turn so that an exchange takes one barrier. Rows of
//    P <= 64 take one warp each, four rows to a block, and need no block
//    barrier. The previous form counted each key's rank against all N keys,
//    one after another (a chain of N compares per thread); this one is
//    log2(P) (log2(P) + 1) / 2 stages of a compare and a select each, and
//    the per-stage tests depend on the thread, not the key.
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

// ---- rank form: a bitonic sort of each short row ---------------------------

constexpr unsigned kFull = 0xffffffffu;

// P keys per row (a power of two >= 32), E per thread: P / E threads to a
// row, kRows rows to a block.
template <int P, int E, int kRows>
__global__ void __launch_bounds__(P / E * kRows)
    topk_bitonic_kernel(const float* __restrict__ d, float* __restrict__ vals,
                        int32_t* __restrict__ idx, int B, int N, int L, int mark) {
  constexpr int kTpr = P / E;  // threads per row
  static_assert(kTpr % 32 == 0 && (kTpr == 32 || kRows == 1), "a row is one warp or a block");
  constexpr int kLogP = P == 32 ? 5 : P == 64 ? 6 : P == 128 ? 7 : P == 256 ? 8 : P == 512 ? 9 : 10;
  static_assert(1 << kLogP == P, "P is a power of two from 32 to 1024");
  __shared__ u64 xch[2][kTpr > 32 ? P : 1];  // strides past a warp, two buffers in turn
  __shared__ float xs[kRows][P];           // the row's values, read back for the output
  const int sub = threadIdx.x / kTpr, t = threadIdx.x % kTpr;
  const int64_t b = (int64_t)blockIdx.x * kRows + sub;
  const bool live = b < B;  // a block's last rows may not exist; they sort kNone
  const float* row = d + (live ? b : 0) * N;
  const int base = t * E;  // this thread's keys are [base, base + E)
  u64 v[E];
  int buf = 0;  // the exchange buffer: alternating, one barrier per exchange suffices
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool ok = live && base + e < N;
    const float x = ok ? row[base + e] : 0.f;
    v[e] = ok ? make_key(x, base + e) : kNone;
    xs[sub][base + e] = x;
  }
  // Stage (k, j) pairs key i with key i ^ j; the lower of a pair keeps the
  // smaller key when (i & k) == 0. For j, k >= E both tests depend on the
  // thread alone, not on e.
#pragma unroll
  for (int lk = 1; lk <= kLogP; ++lk) {  // linear counters, so both loops unroll fully
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {  // both keys in this thread
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool up = k < E ? (e & k) == 0 : (base & k) == 0;
            const u64 a = v[e], c = v[e | j];
            const bool swap = (c < a) == up;
            v[e] = swap ? c : a;
            v[e | j] = swap ? a : c;
          }
        }
      } else {
        const bool keep_min = ((base & j) == 0) == ((base & k) == 0);
        u64 o[E];
        if (j < 32 * E) {  // the partner is lane ^ (j / E) of this warp
#pragma unroll
          for (int e = 0; e < E; ++e) o[e] = __shfl_xor_sync(kFull, v[e], j / E);
        } else {  // another warp of the row
          u64* x = xch[buf];
          buf ^= 1;
#pragma unroll
          for (int e = 0; e < E; ++e) x[base + e] = v[e];
          __syncthreads();
#pragma unroll
          for (int e = 0; e < E; ++e) o[e] = x[(base + e) ^ j];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = (o[e] < v[e]) == keep_min ? o[e] : v[e];
      }
    }
  }
  __syncthreads();  // xs is read at other threads' positions
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int s = base + e;
    if (live && s < L) {
      const int pos = (int)(uint32_t)(v[e] & 0xffffffffull);
      const float x = xs[sub][pos];
      vals[b * L + s] = x;
      idx[b * L + s] = (mark && !isfinite(x)) ? -1 : pos;
    }
  }
}

template <int P, int E, int kRows>
void launch_bitonic(const float* d, float* vals, int32_t* idx, int B, int N, int L, int mark,
                    cudaStream_t stream) {
  topk_bitonic_kernel<P, E, kRows><<<(B + kRows - 1) / kRows, kRows * (P / E), 0, stream>>>(
      d, vals, idx, B, N, L, mark);
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

// form: 0 rank (N <= kRankMaxN), 1 long (L <= kLongMaxL), 2 iter;
// ws: (B, S, L) int64 workspace of the long form (NULL for the others);
// chunk: entries per chunk, a multiple of 4, with S = ceil(N / chunk).
extern "C" int repro_topk_select(const float* d, float* vals, int32_t* idx, void* ws, int B,
                                 int N, int L, int S, int chunk, int mark_nonfinite, int form,
                                 cudaStream_t stream) {
  if (form == 0) {
    if (N <= 32) {
      launch_bitonic<32, 1, 4>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else if (N <= 64) {
      launch_bitonic<64, 2, 4>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else if (N <= 128) {
      launch_bitonic<128, 2, 1>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else if (N <= 256) {
      launch_bitonic<256, 2, 1>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else if (N <= 512) {
      launch_bitonic<512, 2, 1>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else if (N <= kRankMaxN) {
      launch_bitonic<1024, 2, 1>(d, vals, idx, B, N, L, mark_nonfinite, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (form == 1) {
    if (L > kLongMaxL || ws == nullptr) return (int)cudaErrorInvalidValue;
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
  } else if (form == 2) {
    topk_iter_kernel<<<B, 1024, 0, stream>>>(d, vals, idx, N, L, mark_nonfinite);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
