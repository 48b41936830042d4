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
// Design, four forms; ops.py picks one by N and L (topk_form) and passes
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
//  * sort, N in (1024, kSortMaxP] and L > kLongMaxL (the beam merge once
//    the beam is wider than 1024, e.g. L = k' = 1250 for k = 250: N = L +
//    W * R_slack = 1414): one block of 1024 threads per row sorts its keys,
//    padded with kNone to P = a power of two >= max(N, 2048), with the rank
//    form's network at E = P / 1024 keys a thread, and writes the first L.
//    The exchange buffers are dynamic shared memory (two of P keys up to P =
//    8192, one above).
//  * radix, N > kSortMaxP and L > kLongMaxL (Q-Flat and brute force at k' >
//    1024, ground truth at k > 1024): a radix select on the key made of the
//    value's 32 order bits and the position's pos_bits = bits(N - 1), so
//    keys are unique and the L-th smallest key is exact. Passes, each
//    splitting every row over S chunks, one block per (row, chunk):
//     1. clear: zero the histograms and the per-row candidate counts.
//     2. up to ceil((32 + pos_bits) / 11) histogram passes of 11-bit digits,
//        from the top. A block first takes the row's state from the last
//        pass's histogram (a block-wide scan of 2048 bins: the digit at
//        which the count reaches L), then counts the digits of the keys
//        that still share the prefix (shared-memory atomics, flushed by
//        global atomics).
//        A row is done as soon as the keys at or below its prefix number at
//        most cap = max(P, L): a pass then returns at once.
//     3. compact: the keys at or below the final prefix, at most cap of
//        them, go to a (B, cap) workspace; each warp gathers its keys in
//        shared memory and takes their slots with one atomic on the row's
//        count (their order is restored by the sort).
//     4. sort: the candidates in one block's shared memory (as the sort
//        form, P = a power of two >= max(L, RADIX_MIN_P), at most
//        kSortMaxP), the first L written. An L above kSortMaxP has exactly
//        L candidates: blocks sort runs of kSortMaxP and merge passes join
//        pairs of runs (each key's place is its own index plus its rank in
//        the other run, found by binary search; keys are unique), the last
//        writing values and positions.
//    Each pass reads the row once: 2-3 reads of the batch for typical rows,
//    up to 2 + ceil((32 + pos_bits) / 11) when ties exceed cap.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kRankMaxN = 1024;
constexpr int kThreads = 256;    // long form: threads per block
constexpr int kCap = 2048;       // long form: candidate buffer (16 KB of keys)
constexpr int kLongMaxL = 1024;  // below a cut's limit, kCap - kThreads
constexpr int kSortThreads = 1024;  // sort form and the radix form's sort: threads per block
constexpr int kSortMinP = 2048;     // keys a sort block holds at least (2 a thread)
constexpr int kSortMaxP = 16384;    // and at most: 128 KB of shared memory
constexpr int kDigitBits = 11;      // radix form: bits per histogram pass
constexpr int kBins = 1 << kDigitBits;
constexpr u64 kNone = ~0ull;        // above every real key

// The value's order-preserving bits: NaN above +inf, -0.0 equal to +0.0.
__device__ __forceinline__ uint32_t order_bits(float x) {
  if (isnan(x)) return 0xffffffffu;
  if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0
  const uint32_t bits = __float_as_uint(x);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float x, int i) {
  return ((u64)order_bits(x) << 32) | (uint32_t)i;
}

__device__ __forceinline__ u64 pos_mask(int pos_bits) {
  return pos_bits >= 32 ? 0xffffffffull : (1ull << pos_bits) - 1;
}

__device__ __forceinline__ void write_out(const float* row, float* vals, int32_t* idx,
                                          int slot, int pos, int mark) {
  const float v = row[pos];
  vals[slot] = v;
  idx[slot] = (mark && !isfinite(v)) ? -1 : pos;
}

// ---- the bitonic network of the rank, sort and radix forms -----------------

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// Sort P keys ascending, E consecutive ones a thread: thread t of the row's
// P / E threads holds keys [t*E, t*E + E) in v. Stage (k, j) pairs key i
// with key i ^ j; the lower of a pair keeps the smaller key when (i & k) ==
// 0. Strides below E are exchanged in registers, below 32E with
// __shfl_xor_sync, larger ones (the row is then the whole block) through
// shared memory: with kTwo, x0 and x1 in turn, so an exchange takes one
// barrier; else x0 alone and two barriers. For j, k >= E both tests depend
// on the thread alone, not on e. Up to E = 4 a thread takes all E partners
// before it keeps any (the rank form's code); above, one at a time, which
// spares E registers.
template <int P, int E, bool kTwo>
__device__ __forceinline__ void bitonic_network(u64 (&v)[E], int t, u64* x0, u64* x1) {
  constexpr int kLogP = ilog2(P);
  static_assert(1 << kLogP == P && P >= 32 && P % E == 0, "P is a power of two >= 32");
  constexpr int kO = E <= 4 ? E : 1;  // partners held at once
  const int base = t * E;
  int buf = 0;  // the exchange buffer: alternating, one barrier per exchange suffices
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
        u64* x = x0;
        if (j >= 32 * E) {  // another warp of the row
          if (kTwo) {
            x = buf ? x1 : x0;
            buf ^= 1;
          } else {
            __syncthreads();  // the last exchange's reads are done
          }
#pragma unroll
          for (int e = 0; e < E; ++e) x[base + e] = v[e];
          __syncthreads();
        }
#pragma unroll
        for (int e0 = 0; e0 < E; e0 += kO) {
          u64 o[kO];
#pragma unroll
          for (int e = 0; e < kO; ++e)  // the partner is lane ^ (j / E), or in x
            o[e] = j < 32 * E ? __shfl_xor_sync(kFull, v[e0 + e], j / E) : x[(base + e0 + e) ^ j];
#pragma unroll
          for (int e = 0; e < kO; ++e)
            v[e0 + e] = (o[e] < v[e0 + e]) == keep_min ? o[e] : v[e0 + e];
        }
      }
    }
  }
}

// ---- rank form: a bitonic sort of each short row ---------------------------

// P keys per row (a power of two >= 32), E per thread: P / E threads to a
// row, kRows rows to a block.
template <int P, int E, int kRows>
__global__ void __launch_bounds__(P / E * kRows)
    topk_bitonic_kernel(const float* __restrict__ d, float* __restrict__ vals,
                        int32_t* __restrict__ idx, int B, int N, int L, int mark) {
  constexpr int kTpr = P / E;  // threads per row
  static_assert(kTpr % 32 == 0 && (kTpr == 32 || kRows == 1), "a row is one warp or a block");
  __shared__ u64 xch[2][kTpr > 32 ? P : 1];  // strides past a warp, two buffers in turn
  __shared__ float xs[kRows][P];           // the row's values, read back for the output
  const int sub = threadIdx.x / kTpr, t = threadIdx.x % kTpr;
  const int64_t b = (int64_t)blockIdx.x * kRows + sub;
  const bool live = b < B;  // a block's last rows may not exist; they sort kNone
  const float* row = d + (live ? b : 0) * N;
  const int base = t * E;  // this thread's keys are [base, base + E)
  u64 v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool ok = live && base + e < N;
    const float x = ok ? row[base + e] : 0.f;
    v[e] = ok ? make_key(x, base + e) : kNone;
    xs[sub][base + e] = x;
  }
  bitonic_network<P, E, true>(v, t, xch[0], xch[1]);
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
  __device__ float value(const Raw& raw, int e) const {
    const float4& v = raw.v[e / 4];
    return e % 4 == 0 ? v.x : (e % 4 == 1 ? v.y : (e % 4 == 2 ? v.z : v.w));
  }
  __device__ u64 key(const Raw& raw, int r, int e) const {
    const int i = index(r, e);
    return i < hi ? make_key(value(raw, e), i) : kNone;
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

// ---- sort form, and the radix form's last step: one block sorts a row -------

// Dynamic shared memory of a sort block: two exchange buffers of P keys, or
// one (two barriers an exchange) where two do not fit.
__host__ __device__ constexpr size_t sort_smem(int P) {
  return (P <= 8192 ? 2 : 1) * (size_t)P * sizeof(u64);
}

// Block (b, r) sorts P keys and either writes the first L as values and
// positions (runs == NULL) or writes its run back for the merge passes. The
// keys are row b of d itself (cand == NULL: the sort form, N <= P, keys with
// 32 position bits) or candidates [r*P, (r+1)*P) of the radix form's row b,
// counts[b] of them (cand and runs may be the same buffer: a block reads and
// writes only its own run).
template <int P, int E>
__global__ void __launch_bounds__(kSortThreads) topk_sort_kernel(
    const float* __restrict__ d, const u64* cand, const int* __restrict__ counts, u64* runs,
    float* __restrict__ vals, int32_t* __restrict__ idx, int N, int L, int cap, int pos_bits,
    int mark) {
  static_assert(P == E * kSortThreads, "E keys a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  u64* x0 = reinterpret_cast<u64*>(smem);
  constexpr bool kTwo = sort_smem(P) == 2 * (size_t)P * sizeof(u64);
  u64* x1 = x0 + (kTwo ? P : 0);
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x, base = t * E;
  const int lo = blockIdx.y * P;  // this block's run of the row's candidates
  int n;
  u64 v[E];
  if (cand == nullptr) {
    n = N;
    const float* row = d + b * N;
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = base + e < N ? make_key(row[base + e], base + e) : kNone;
  } else {
    n = min(P, counts[b] - lo);
    const u64* src = cand + b * cap + lo;
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = base + e < n ? src[base + e] : kNone;
  }
  bitonic_network<P, E, kTwo>(v, t, x0, x1);
  if (runs != nullptr) {
    u64* dst = runs + b * cap + lo;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (base + e < n) dst[base + e] = v[e];
    return;
  }
  // at least L real keys, each below kNone: the first L are real
  const u64 mask = pos_mask(pos_bits);
  const float* row = d + b * N;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (base + e < L) write_out(row, vals + b * L, idx + b * L, base + e, (int)(v[e] & mask), mark);
}

constexpr int kMaxDevices = 64;

// Launch topk_sort_kernel<P> on a (B, R) grid, its shared-memory limit
// raised once per device.
template <int P>
cudaError_t launch_sort(const float* d, const u64* cand, const int* counts, u64* runs,
                        float* vals, int32_t* idx, int B, int R, int N, int L, int cap,
                        int pos_bits, int mark, cudaStream_t stream) {
  constexpr int E = P / kSortThreads;
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    e = cudaFuncSetAttribute(topk_sort_kernel<P, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sort_smem(P));
    if (e != cudaSuccess) return e;
    raised[device] = true;
  }
  topk_sort_kernel<P, E><<<dim3(B, R), kSortThreads, sort_smem(P), stream>>>(
      d, cand, counts, runs, vals, idx, N, L, cap, pos_bits, mark);
  return cudaGetLastError();
}

cudaError_t launch_sort_p(int P, const float* d, const u64* cand, const int* counts, u64* runs,
                          float* vals, int32_t* idx, int B, int R, int N, int L, int cap,
                          int pos_bits, int mark, cudaStream_t stream) {
  switch (P) {
    case 2048:
      return launch_sort<2048>(d, cand, counts, runs, vals, idx, B, R, N, L, cap, pos_bits, mark,
                               stream);
    case 4096:
      return launch_sort<4096>(d, cand, counts, runs, vals, idx, B, R, N, L, cap, pos_bits, mark,
                               stream);
    case 8192:
      return launch_sort<8192>(d, cand, counts, runs, vals, idx, B, R, N, L, cap, pos_bits, mark,
                               stream);
    case kSortMaxP:
      return launch_sort<kSortMaxP>(d, cand, counts, runs, vals, idx, B, R, N, L, cap, pos_bits,
                                    mark, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- radix form ------------------------------------------------------------

// A row's progress through the histogram passes: its keys whose bits above
// `shift` are below `prefix` number `below` (< L), those equal to it
// `bucket`, so the L-th smallest key is one of the latter. done: below +
// bucket <= cap (the candidates fit the sort) or shift == 0 (the L-th key
// itself is known, and below + bucket == L).
struct RowState {
  u64 prefix;
  int shift, below, bucket, done;
};

// The radix form's key: unique, and in the order of make_key.
__device__ __forceinline__ u64 radix_key(float x, int i, int pos_bits) {
  return ((u64)order_bits(x) << pos_bits) | (uint32_t)i;
}

// The state after h, the histogram of the digit below s.shift of the keys
// in s's bucket: the digit at which the count of keys reaches L. All kT
// threads of the block.
template <int kT>
__device__ RowState advance(RowState s, const int* __restrict__ h, int L, int cap) {
  constexpr int kPer = kBins / kT;
  static_assert(kPer * kT == kBins && kT % 32 == 0 && kT <= 1024, "bins a thread");
  __shared__ int warp_total[kT / 32];
  __shared__ RowState next;
  if (s.done) return s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int width = min(kDigitBits, s.shift);
  int c[kPer], sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    c[e] = h[tid * kPer + e];
    sum += c[e];
  }
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int cum = incl - sum;  // keys in the bins before this thread's
  for (int w = 0; w < warp; ++w) cum += warp_total[w];
  const int rem = L - s.below;  // 1 <= rem <= s.bucket, the histogram's total
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (cum < rem && rem <= cum + c[e]) {  // one bin of one thread
      RowState n;
      n.prefix = (s.prefix << width) | (u64)(tid * kPer + e);
      n.shift = s.shift - width;
      n.below = s.below + cum;
      n.bucket = c[e];
      n.done = n.below + n.bucket <= cap || n.shift == 0;
      next = n;
    }
    cum += c[e];
  }
  __syncthreads();
  const RowState out = next;
  __syncthreads();  // next is written again by a later call
  return out;
}

// Row b's state entering histogram pass `pass` (pass == passes: the final
// one, for the compaction). Pass p's block (b, 0) stores the state it
// entered with in state[p % 2][b]; the blocks of pass p + 1 read it there
// and advance it by pass p's histogram.
template <int kT>
__device__ RowState state_at(const int* hist, const RowState* state, int B, int64_t b, int pass,
                             int N, int L, int cap, int pos_bits) {
  if (pass == 0) {
    RowState s;
    s.prefix = 0;
    s.shift = 32 + pos_bits;
    s.below = 0;
    s.bucket = N;
    s.done = N <= cap;
    return s;
  }
  return advance<kT>(state[(int64_t)((pass - 1) & 1) * B + b],
                     hist + ((int64_t)(pass - 1) * B + b) * kBins, L, cap);
}

__global__ void __launch_bounds__(kThreads) topk_radix_clear_kernel(int* __restrict__ p,
                                                                   int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int4* p4 = reinterpret_cast<int4*>(p);  // p is 16-byte aligned
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n / 4; i += stride)
    p4[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = (n / 4) * 4 + (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    p[i] = 0;
}

// Pass `pass`: block (b, c) counts the digits of chunk c's keys in row b's
// bucket into hist[pass][b].
template <bool kVec>
__global__ void __launch_bounds__(kThreads) topk_radix_hist_kernel(
    const float* __restrict__ d, int* __restrict__ hist, RowState* __restrict__ state, int B,
    int N, int L, int cap, int pos_bits, int pass, int chunk) {
  __shared__ int h[kBins];
  const int64_t b = blockIdx.x;
  const int c = blockIdx.y;
  const RowState s = state_at<kThreads>(hist, state, B, b, pass, N, L, cap, pos_bits);
  if (c == 0 && threadIdx.x == 0) state[(int64_t)(pass & 1) * B + b] = s;
  if (s.done) return;
  const int width = min(kDigitBits, s.shift);
  const int shift = s.shift - width;
  const u64 digit = (1ull << width) - 1;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int lo = c * chunk, hi = min(N, lo + chunk);
  const FloatChunk<kVec> src{d + b * N, lo, hi};
  constexpr int kPer = FloatChunk<kVec>::kPer;
  constexpr int kRound = kThreads * kPer;
  typename FloatChunk<kVec>::Raw cur = src.load(0), nxt = cur;
  for (int r = 0; r < hi - lo; r += kRound) {
    if (r + kRound < hi - lo) nxt = src.load(r + kRound);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = src.index(r, e);
      const u64 key = radix_key(src.value(cur, e), i, pos_bits);
      const bool take = i < hi && (key >> s.shift) == s.prefix;
      if (take) atomicAdd(&h[(int)((key >> shift) & digit)], 1);
    }
    cur = nxt;
  }
  __syncthreads();
  int* out = hist + ((int64_t)pass * B + b) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (h[i] != 0) atomicAdd(out + i, h[i]);
}

constexpr int kWarpStage = 256;  // compaction: keys a warp gathers before one global atomic

// Block (b, c) appends chunk c's keys at or below row b's final prefix to
// cand[b] (at most cap of them in all). Each warp gathers its keys in
// shared memory and moves them out, at slots from one atomicAdd on
// counts[b], when the stage is nearly full and at the end.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) topk_radix_compact_kernel(
    const float* __restrict__ d, const int* __restrict__ hist, const RowState* __restrict__ state,
    u64* __restrict__ cand, int* __restrict__ counts, int B, int N, int L, int cap, int pos_bits,
    int passes, int chunk) {
  __shared__ u64 stage[kThreads / 32][kWarpStage];
  const int64_t b = blockIdx.x;
  const int c = blockIdx.y;
  const RowState s = state_at<kThreads>(hist, state, B, b, passes, N, L, cap, pos_bits);
  const int lo = c * chunk, hi = min(N, lo + chunk);
  const FloatChunk<kVec> src{d + b * N, lo, hi};
  constexpr int kPer = FloatChunk<kVec>::kPer;
  constexpr int kRound = kThreads * kPer;
  const int lane = threadIdx.x % 32;
  u64* buf = stage[threadIdx.x / 32];
  u64* out = cand + b * cap;
  int held = 0;  // keys in buf: the same in every lane
  auto flush = [&]() {
    __syncwarp();
    int at = 0;
    if (lane == 0) at = atomicAdd(counts + b, held);
    at = __shfl_sync(kFull, at, 0);
    for (int i = lane; i < held; i += 32) out[at + i] = buf[i];
    __syncwarp();
    held = 0;
  };
  typename FloatChunk<kVec>::Raw cur = src.load(0), nxt = cur;
  for (int r = 0; r < hi - lo; r += kRound) {
    if (r + kRound < hi - lo) nxt = src.load(r + kRound);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = src.index(r, e);
      const u64 key = radix_key(src.value(cur, e), i, pos_bits);
      const bool take = i < hi && (key >> s.shift) <= s.prefix;
      const unsigned m = __ballot_sync(kFull, take);
      if (take) buf[held + __popc(m & ((1u << lane) - 1))] = key;
      held += __popc(m);
      if (held > kWarpStage - 32) flush();
    }
    cur = nxt;
  }
  if (held > 0) flush();
}

// One merge pass over sorted runs of `run` keys (rows of `stride` in src):
// runs 2q and 2q + 1 become one. A key's place is its index in its run
// plus the number of keys below it in the other run. dst == NULL: the last
// pass, which writes values and positions.
__global__ void __launch_bounds__(kThreads) topk_runs_merge_kernel(
    const u64* __restrict__ src, u64* __restrict__ dst, const float* __restrict__ d,
    float* __restrict__ vals, int32_t* __restrict__ idx, int N, int L, int stride, int run,
    int pos_bits, int mark) {
  const int64_t b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const u64* s = src + b * stride;
  const u64 key = s[i];
  const int r = i / run, o = r ^ 1;
  const int lo = min(L, o * run), hi = min(L, lo + run);
  int a = lo, z = hi;  // the first key of the other run not below key
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (s[mid] < key) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  const int at = (i - r * run) + (a - lo) + min(r, o) * run;
  if (dst != nullptr) {
    dst[b * stride + at] = key;
  } else {
    write_out(d + b * N, vals + b * L, idx + b * L, at, (int)(key & pos_mask(pos_bits)), mark);
  }
}

// The radix form's workspace, in bytes from its start (ops.radix_plan
// computes the same): the histograms of every pass and the candidate counts
// (cleared together), two row states a row, the candidates, and for L >
// kSortMaxP a second buffer for the merge passes.
struct RadixLayout {
  int pos_bits, passes, cap, runs;
  size_t hist, counts, state, cand, tmp, bytes;
};

RadixLayout radix_layout(int B, int N, int L, int P) {
  RadixLayout w;
  w.pos_bits = 1;
  while ((1ll << w.pos_bits) < (long long)N) ++w.pos_bits;
  w.passes = (32 + w.pos_bits + kDigitBits - 1) / kDigitBits;
  w.cap = P > L ? P : L;
  w.runs = L > P ? (L + P - 1) / P : 1;
  size_t at = 0;
  w.hist = at;
  at += (size_t)w.passes * B * kBins * sizeof(int);
  w.counts = at;
  at += (size_t)B * sizeof(int);
  at = (at + 15) / 16 * 16;
  w.state = at;
  at += 2 * (size_t)B * sizeof(RowState);
  at = (at + 15) / 16 * 16;
  w.cand = at;
  at += (size_t)B * w.cap * sizeof(u64);
  w.tmp = at;
  if (w.runs > 1) at += (size_t)B * w.cap * sizeof(u64);
  w.bytes = at;
  return w;
}

cudaError_t launch_radix(const float* d, float* vals, int32_t* idx, void* ws, int B, int N,
                         int L, int S, int chunk, int P, int mark, cudaStream_t stream) {
  const RadixLayout w = radix_layout(B, N, L, P);
  char* base = static_cast<char*>(ws);
  int* hist = reinterpret_cast<int*>(base + w.hist);
  int* counts = reinterpret_cast<int*>(base + w.counts);
  RowState* state = reinterpret_cast<RowState*>(base + w.state);
  u64* cand = reinterpret_cast<u64*>(base + w.cand);
  u64* tmp = reinterpret_cast<u64*>(base + w.tmp);
  const int64_t clear = (int64_t)(w.counts / sizeof(int)) + B;  // hist and counts
  const int64_t clear_blocks = (clear / 4 + kThreads - 1) / kThreads;
  topk_radix_clear_kernel<<<(int)(clear_blocks < 1024 ? clear_blocks : 1024), kThreads, 0,
                            stream>>>(hist, clear);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid(B, S);
  const bool vec = N % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  for (int p = 0; p < w.passes; ++p) {
    if (vec) {
      topk_radix_hist_kernel<true><<<grid, kThreads, 0, stream>>>(d, hist, state, B, N, L, w.cap,
                                                                 w.pos_bits, p, chunk);
    } else {
      topk_radix_hist_kernel<false><<<grid, kThreads, 0, stream>>>(d, hist, state, B, N, L, w.cap,
                                                                  w.pos_bits, p, chunk);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (vec) {
    topk_radix_compact_kernel<true><<<grid, kThreads, 0, stream>>>(
        d, hist, state, cand, counts, B, N, L, w.cap, w.pos_bits, w.passes, chunk);
  } else {
    topk_radix_compact_kernel<false><<<grid, kThreads, 0, stream>>>(
        d, hist, state, cand, counts, B, N, L, w.cap, w.pos_bits, w.passes, chunk);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_sort_p(P, d, cand, counts, w.runs > 1 ? cand : nullptr, vals, idx, B, w.runs, N, L,
                    w.cap, w.pos_bits, mark, stream);
  if (e != cudaSuccess) return e;
  const u64* src = cand;
  u64* dst = tmp;
  for (int run = P; run < L; run *= 2) {
    const bool last = 2 * run >= L;
    topk_runs_merge_kernel<<<dim3((L + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
        src, last ? nullptr : dst, d, vals, idx, N, L, w.cap, run, w.pos_bits, mark);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    u64* next = const_cast<u64*>(src);
    src = dst;
    dst = next;
  }
  return cudaSuccess;
}

}  // namespace

// form: 0 rank (N <= kRankMaxN), 1 long (L <= kLongMaxL), 2 sort (N <=
// sort_p), 3 radix; ws: the long form's (B, S, L) int64 workspace or the
// radix form's (radix_layout), NULL for the others; chunk: entries per
// chunk, a multiple of 4, with S = ceil(N / chunk); sort_p: keys a sort
// block holds (2048, 4096, 8192 or kSortMaxP).
extern "C" int repro_topk_select(const float* d, float* vals, int32_t* idx, void* ws, int B,
                                 int N, int L, int S, int chunk, int sort_p, int mark_nonfinite,
                                 int form, cudaStream_t stream) {
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
    if (N > sort_p || L > N) return (int)cudaErrorInvalidValue;
    return (int)launch_sort_p(sort_p, d, nullptr, nullptr, nullptr, vals, idx, B, 1, N, L, 0, 32,
                              mark_nonfinite, stream);
  } else if (form == 3) {
    if (ws == nullptr || sort_p < kSortMinP || L > N || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_radix(d, vals, idx, ws, B, N, L, S, chunk, sort_p, mark_nonfinite, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
