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
// Three forms; ops.py picks one by shape (adc_form) and passes its code.
//  * staged (one search round: B=128 queries x C=W*R_slack=164 rows, V=2,
//    M=96, K=256): one block per query. Nearly every 32-byte sector of a
//    query's V*M*K*4 = 196,608-byte table is touched by its 164 x 96 lookups,
//    so the block copies the table into dynamic shared memory once, with TMA
//    1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes) in
//    chunks of subspaces, each chunk completing on its own mbarrier, and
//    looks up from there. Before any copy a block-wide OR over the
//    candidates' versions picks the schemas to copy: a round whose rows all
//    carry one schema moves half the table. A candidate has two threads
//    (lanes), each summing half of its subspaces; each lane loads its own
//    code bytes into shared memory in the same round trip as the row's
//    version, before the OR's barrier, so no other barrier is needed (rows of
//    an odd word count apart keep neighbouring candidates in different
//    banks). A lane sums its terms in subspace order as each chunk lands,
//    and lane 0 adds lane 1's sum, so a result never depends on timing.
//    Candidates go in tiles of kStagedTile. The copies (25 MB per round at
//    B=128) cost about 1.1 us; most of the rest is the launch and the round
//    trips for ids, versions and code bytes (PERF.md).
//  * l2 (fewer than STAGED_MIN_ROWS rows per query, such as the build's
//    rounds at W=1, C=41, and the start node, C=1, or a table too large for
//    one block, such as M=192 or three schemas at K=256): lookups straight
//    from global memory (L2). The build's round (B=100, C=41) needs about
//    1.7 MB, but its 394 000 lookups are random 4-byte reads, and its time
//    follows the 128-byte lines each warp load touches (PERF.md): a warp
//    whose lanes take different subspaces touches 32 lines a load. So a
//    block takes one query and 32 of its candidates, one a lane, and splits
//    the subspaces over its 4 warps (adc_l2_kernel): a warp's load reads
//    one subspace for 32 candidates of one query, inside that subspace's V
//    table rows (8 lines each at K=256). A lane's chain is three round
//    trips: the id; the row's version with its code units (8-byte words at
//    M=96), issued together; then 24 table loads in flight. With ids ==
//    NULL the rows are r = c.
//  * dense (Q-Flat over all N rows: B=128 queries x N=100 000 rows, V=2,
//    M=96, K=256): 1.23e9 lookups, so the limit is the SMs' instruction
//    issue and load/store path (a 32-lane lookup a clock an SM at best),
//    not the 86 MB the call moves. A block per query (more per query while
//    B is below the SM count) stages the query's table in shared memory
//    once, in a layout where each lane's entries sit in the lane's own
//    bank, so no lookup conflicts; a warp takes 32 rows at a time, each lane
//    summing its subspaces of every row, and a reduce-scatter over the warp
//    gives each lane one row's sum (adc_dense_kernel). Per row at M=96: two
//    coalesced code loads, three lookups, about one shuffle, ~19
//    instructions a warp (PERF.md).
//  * ids < 0 or >= N write +inf; the caller masks such lanes anyway.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace {

// form codes, as ops.py passes them
constexpr int kFormL2 = 0, kFormStaged = 1, kFormDense = 2;
// the dense form with one code byte a load (no pair groups), which ops.py
// does not take: a design for scripts/torch_scan_kernels.py
constexpr int kFormDenseSingles = 3;

constexpr int kStagedTile = 192;  // candidates per pass (STAGED_TILE)
constexpr int kLanes = 2;         // threads per candidate, each summing part of the subspaces
constexpr int kMaxChunks = 8;     // subspace chunks of a staged table, one mbarrier each
constexpr int kHeader = 128;      // the mbarriers and each warp's version mask, before the table
constexpr int kStagedWarps = kLanes * kStagedTile / 32;
static_assert(kMaxChunks * 8 + kStagedWarps * 4 <= kHeader, "the header holds the barriers and masks");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk copy global -> shared; dst, src 16-byte aligned, bytes % 16 == 0
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copy `bytes` bytes from src to dst, kU at a time, four loads in flight.
template <int kU>
__device__ void copy_bytes(uint8_t* dst, const uint8_t* __restrict__ src, int bytes) {
  typedef typename std::conditional<kU == 16, uint4,
                                    typename std::conditional<kU == 4, uint32_t, uint8_t>::type>::type
      Unit;
  constexpr int kBatch = 4;
  for (int o = 0; o < bytes; o += kBatch * kU) {
    Unit u[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (o + k * kU < bytes) u[k] = *reinterpret_cast<const Unit*>(src + o + k * kU);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (o + k * kU < bytes) {
        if constexpr (kU == 16) {  // the tile's rows are 4-byte aligned only
          uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + o + k * kU);
          d4[0] = u[k].x;
          d4[1] = u[k].y;
          d4[2] = u[k].z;
          d4[3] = u[k].w;
        } else {
          *reinterpret_cast<Unit*>(dst + o + k * kU) = u[k];
        }
      }
    }
  }
}

// Shared memory of the staged form (ops.staged_smem_bytes computes the same).
__host__ __device__ inline int staged_stride(int M) { return (((M + 3) / 4) | 1) * 4; }
__host__ __device__ inline size_t staged_smem(int V, int M, int K) {
  return kHeader + (size_t)V * M * K * 4 + (size_t)kStagedTile * staged_stride(M);
}

// One candidate's lane: its row, version and this lane's code bytes, which
// it stages itself (no other thread reads them, so no barrier is needed).
struct Candidate {
  int r;      // the row, or -1 for an id outside [0, N)
  int v;      // its schema version, clamped to V - 1
  int m0, m1; // this lane's subspaces
};

__device__ __forceinline__ Candidate stage_candidate(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ versions, int id, int V,
    int M, int N, int h, uint8_t* row, bool vec16, bool vec4) {
  Candidate k;
  const int mh = (M + kLanes - 1) / kLanes;
  k.m0 = min(M, h * mh);
  k.m1 = min(M, k.m0 + mh);
  k.r = id >= 0 && id < N ? id : -1;
  k.v = 0;
  if (k.r >= 0) {
    k.v = min((int)versions[k.r], V - 1);
    const uint8_t* src = codes + (int64_t)k.r * M + k.m0;
    if (vec16) {
      copy_bytes<16>(row + k.m0, src, k.m1 - k.m0);
    } else if (vec4) {
      copy_bytes<4>(row + k.m0, src, k.m1 - k.m0);
    } else {
      copy_bytes<1>(row + k.m0, src, k.m1 - k.m0);
    }
  }
  return k;
}

__global__ void __launch_bounds__(kLanes* kStagedTile)
    adc_staged_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                      const uint8_t* __restrict__ versions, const int32_t* __restrict__ ids,
                      float* __restrict__ out, int V, int M, int K, int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // each warp's OR of its candidates' versions: every slot is written before
  // the barrier that precedes its reading, so none needs clearing
  unsigned* warp_mask = reinterpret_cast<unsigned*>(smem + kMaxChunks * sizeof(uint64_t));
  const int stride = staged_stride(M);
  float* table = reinterpret_cast<float*>(smem + kHeader);  // V slots of M x K
  uint8_t* tile = smem + kHeader + (size_t)V * M * K * 4;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid / kLanes, h = tid % kLanes;  // candidate of the tile, lane of it
  const int Mc = 4 * ((M + 4 * kMaxChunks - 1) / (4 * kMaxChunks));  // subspaces per chunk
  const int chunks = Mc ? (M + Mc - 1) / Mc : 0;
  const int32_t* qids = ids + (int64_t)b * C;
  const int mh = (M + kLanes - 1) / kLanes;
  const bool vec16 = M % 16 == 0 && mh % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const bool vec4 = M % 4 == 0 && mh % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  uint8_t* row = tile + c * stride;

  if (tid == 0) {
    for (int j = 0; j < chunks; ++j) mbar_init(bars + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // 1. the first tile's candidates, staged while their versions are ORed:
  // one round trip for the version and the code bytes, which both need the id
  Candidate k =
      stage_candidate(codes, versions, c < C ? qids[c] : -1, V, M, N, h, row, vec16, vec4);
  unsigned mask = k.r >= 0 ? 1u << k.v : 0u;
  for (int i = kStagedTile + tid; i < C; i += kLanes * kStagedTile) {
    const int r = qids[i];
    if (r >= 0 && r < N) mask |= 1u << min((int)versions[r], V - 1);
  }
  mask = __reduce_or_sync(0xffffffffu, mask);
  if (tid % 32 == 0) warp_mask[tid / 32] = mask;
  __syncthreads();
  // 2. one thread issues the copies: chunk j of every referenced version lands on bars[j]
  if (tid == 0) {
    unsigned vmask = 0;
    for (int w = 0; w < kStagedWarps; ++w) vmask |= warp_mask[w];
    for (int j = 0; j < chunks; ++j) {
      const int m0 = j * Mc;
      const uint32_t bytes = (uint32_t)min(Mc, M - m0) * K * 4;
      mbar_expect_tx(bars + j, bytes * __popc(vmask));
      for (unsigned vs = vmask; vs; vs &= vs - 1) {
        const int v = __ffs(vs) - 1;
        bulk_copy(table + ((size_t)v * M + m0) * K, luts + (((int64_t)b * V + v) * M + m0) * K,
                  bytes, bars + j);
      }
    }
  }
  // 3. each lane sums its subspaces in order as their chunks land; the
  // candidate's two lanes add up lane 0's sum first
  for (int c0 = 0; c0 < C; c0 += kStagedTile) {
    if (c0 > 0)
      k = stage_candidate(codes, versions, c0 + c < C ? qids[c0 + c] : -1, V, M, N, h, row,
                          vec16, vec4);
    float acc = 0.f;
    if (k.r >= 0) {
      const float* t = table + (size_t)k.v * M * K;
      for (int j = k.m0 / max(Mc, 1); j * Mc < k.m1; ++j) {
        mbar_wait(bars + j, 0);
        const int m1 = min(k.m1, (j + 1) * Mc);
#pragma unroll 4
        for (int m = max(k.m0, j * Mc); m < m1; ++m) acc += t[m * K + row[m]];
      }
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, acc, off);
      if (h % (2 * off) == 0) acc += o;
    }
    if (h == 0 && c0 + c < C) out[(int64_t)b * C + c0 + c] = k.r >= 0 ? acc : CUDART_INF_F;
  }
}

// Loads through the read-only path whose order the compiler keeps (asm
// volatile): all of a lane's code units are issued before its first table
// load, which would otherwise sink each word's load to its lookups and
// chain one round trip per word.
__device__ __forceinline__ uint32_t ld_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_u64(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_f32(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The l2 form, by query: block (x, b) takes query b's candidates
// 32x..32x+31, one a lane, and its kQGroups warps split the subspaces, so a
// warp's table load looks up one subspace for 32 candidates of one query.
// kUnit is the code unit a lane loads: 8 bytes when M and the codes'
// address allow it, else 1. Order of the sum (tests/test_torch_kernels.py
// emulates it): warp g adds its subspaces [g*Mg, (g+1)*Mg) in order, Mg =
// kUnit * ceil(M / kUnit / kQGroups), and warp 0 adds the partial sums in
// warp order, ((p0 + p1) + p2) + p3.
constexpr int kQGroups = 4;                  // warps of a block, each a share of the subspaces
constexpr int kQBatch = 24;                  // table loads a lane has in flight

template <int kUnit>
__global__ void __launch_bounds__(32 * kQGroups)
    adc_l2_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                  const uint8_t* __restrict__ versions, const int32_t* __restrict__ ids,
                  float* __restrict__ out, int V, int M, int K, int N, int C) {
  __shared__ float part[kQGroups][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  const bool mine = c < C;
  int r = -1;
  if (mine) {
    const int id = ids ? ids[(int64_t)b * C + c] : c;
    r = id >= 0 && id < N ? id : -1;
  }
  const int Mg = kUnit * ((M / kUnit + kQGroups - 1) / kQGroups);  // a multiple of the unit
  const int m0 = min(M, g * Mg), m1 = min(M, m0 + Mg);
  float acc = 0.f;
  if (r >= 0) {
    const uint8_t* row = codes + (int64_t)r * M;
    const uint32_t vr = ld_u8(versions + r);
    for (int mb = m0; mb < m1; mb += kQBatch) {
      constexpr int kUnits = kQBatch / kUnit;
      uint32_t u[kUnit == 8 ? kQBatch / 4 : kQBatch];  // code bytes, 4 a word when kUnit = 8
#pragma unroll
      for (int t = 0; t < kUnits; ++t) {
        const bool in = mb + kUnit * t < m1;
        if constexpr (kUnit == 8) {
          const uint2 w = in ? ld_u64(row + mb + 8 * t) : make_uint2(0u, 0u);
          u[2 * t] = w.x;
          u[2 * t + 1] = w.y;
        } else {
          u[t] = in ? ld_u8(row + mb + t) : 0u;
        }
      }
      const int v = (int)vr < V ? (int)vr : V - 1;
      const float* lut = luts + (((int64_t)b * V + v) * M + mb) * K;
      float e[kQBatch];
#pragma unroll
      for (int t = 0; t < kQBatch; ++t) {
        const uint32_t code = kUnit == 8 ? (u[t / 4] >> (8 * (t % 4))) & 0xffu : u[t];
        e[t] = mb + t < m1 ? ld_f32(lut + t * K + code) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kQBatch; ++t)
        if (mb + t < m1) acc += e[t];
    }
  }
  part[g][lane] = acc;
  __syncthreads();
  if (g == 0 && mine) {
    float s = part[0][lane];
#pragma unroll
    for (int h = 1; h < kQGroups; ++h) s += part[h][lane];
    out[(int64_t)b * C + c] = r >= 0 ? s : CUDART_INF_F;
  }
}

// ---- dense form: Q-Flat, every row against every query's table -------------

constexpr int kDenseWarps = 16;
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kDenseMaxSlots = 7;  // ceil(M / 32): a table of V * slots * K * 128 bytes fits

// The lane plan of the bank-per-lane layout (ops.dense_subspace computes the
// same): slot s of lane i is subspace dense_m(s, i), or -1. With `pairs`
// (M even, codes 2-byte aligned) the first 64 * pairs subspaces go two to a
// lane (2i, 2i + 1 of each 64), one 2-byte code load for both; the rest one
// to a lane (i of each 32). Either way there are ceil(M / 32) slots.
__host__ __device__ inline int dense_m(int slot, int lane, int M, int pairs) {
  if (slot < 2 * pairs) return 64 * (slot / 2) + 2 * lane + slot % 2;
  const int m = 64 * pairs + 32 * (slot - 2 * pairs) + lane;
  return m < M ? m : -1;
}

__device__ __forceinline__ uint32_t ld_cs_u8(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.cs.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_cs_u16(const uint8_t* p) {
  uint32_t v;
  asm("ld.global.cs.u16 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Rows kH..kH+kRows-1 of a warp's 32 (the first nr exist; kSafe: all 32
// lie inside the codes, so none needs a bound check): their code loads,
// kS - kPairs a row (one per pair group, one per single slot).
template <int kS, int kPairs, int kH, int kRows, bool kSafe>
__device__ __forceinline__ void dense_load(uint32_t (&cw)[kRows][kS - kPairs],
                                           const uint8_t* __restrict__ rows, int M, int nr,
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const uint8_t* row = rows + (kH + rr) * M;
    const bool in = kSafe || kH + rr < nr;
#pragma unroll
    for (int c = 0; c < kS - kPairs; ++c) {
      if (c < kPairs) {
        cw[rr][c] = in ? ld_cs_u16(row + 64 * c + 2 * lane) : 0u;
      } else {
        const int m = 64 * kPairs + 32 * (c - kPairs) + lane;
        cw[rr][c] = in && m < M ? ld_cs_u8(row + m) : 0u;
      }
    }
  }
}

// The same rows' lookups, each row's slots summed in slot order from the
// first into p[kH + rr]; the row's version from the warp's ballots vb
// (kVBits of them). Byte offsets from the table: ((slot * K + code) * V +
// v) * 128 + lane * 4; at V=2 the code, version and lane parts fill bytes 1
// and 0 apart, so one byte move or mask makes a lookup's offset. Template
// offsets keep p's indices static, so p stays in registers.
template <int kS, int kPairs, int kVBits, int kH, int kRows>
__device__ __forceinline__ void dense_sum(float (&p)[32], const uint32_t (&cw)[kRows][kS - kPairs],
                                          const char* table, int lane, int K, int V,
                                          const unsigned (&vb)[3]) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = kH + rr;
    uint32_t v = (vb[0] >> r) & 1u;
    if (kVBits > 1) v |= ((vb[1] >> r) & 1u) << 1;
    if (kVBits > 2) v |= ((vb[2] >> r) & 1u) << 2;
    const uint32_t vl = (v << 7) | ((uint32_t)lane << 2);  // the version and lane part
    float acc;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const uint32_t c = s < 2 * kPairs ? cw[rr][s / 2] : cw[rr][s - kPairs];
      uint32_t off;
      if (V == 2) {  // code << 8 | vl: byte 0 of c (or its byte 1 in place) beside vl
        off = s < 2 * kPairs && s % 2 ? (c & 0xff00u) | vl : __byte_perm(c, vl, 0x5504);
      } else {
        off = (s < 2 * kPairs ? (s % 2 ? c >> 8 : c & 0xffu) : c) * (uint32_t)V * 128u + vl;
      }
      const float x = *reinterpret_cast<const float*>(table + off + s * K * V * 128);
      acc = s == 0 ? x : acc + x;
    }
    p[r] = acc;
  }
}

// The reduce-scatter of a warp's 32 row partials: at offset kO each lane
// keeps the half of its rows whose bit kO matches its own and adds its
// partner's partials of them, so p[j] becomes row j + (lane & ~(2kO - 1))'s
// sum so far; after kO = 1, p[0] is row lane's sum.
template <int kO>
__device__ __forceinline__ void reduce_scatter(float (&p)[32], int lane) {
  const bool upper = (lane & kO) != 0;
#pragma unroll
  for (int j = 0; j < kO; ++j) {
    const float lo = p[j], hi = p[j + kO];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    p[j] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
  }
  if constexpr (kO > 1) reduce_scatter<kO / 2>(p, lane);
}

// One group of a warp: the lookups of its 32 rows (codes ca, cb for rows
// 0-15 on entry), rows 16-31's loads issued as rows 0-15 are summed, and
// the next group's rows 0-15 (at rows1, n1 of them) as rows 16-31 are.
template <int kS, int kPairs, int kVBits, bool kSafe>
__device__ __forceinline__ void dense_group(float (&p)[32], uint32_t (&ca)[8][kS - kPairs],
                                            uint32_t (&cb)[8][kS - kPairs], const uint8_t* rows0,
                                            const uint8_t* rows1, int M, int K, int V, int nr,
                                            int n1, int lane, const char* t,
                                            const unsigned (&vb)[3]) {
  dense_sum<kS, kPairs, kVBits, 0, 8>(p, ca, t, lane, K, V, vb);
  dense_load<kS, kPairs, 16, 8, kSafe>(ca, rows0, M, nr, lane);
  dense_sum<kS, kPairs, kVBits, 8, 8>(p, cb, t, lane, K, V, vb);
  dense_load<kS, kPairs, 24, 8, kSafe>(cb, rows0, M, nr, lane);
  dense_sum<kS, kPairs, kVBits, 16, 8>(p, ca, t, lane, K, V, vb);
  dense_load<kS, kPairs, 0, 8, kSafe>(ca, rows1, M, n1, lane);
  dense_sum<kS, kPairs, kVBits, 24, 8>(p, cb, t, lane, K, V, vb);
  dense_load<kS, kPairs, 8, 8, kSafe>(cb, rows1, M, n1, lane);
}

// Block (x, b) takes query b's rows [x * rows, (x + 1) * rows). Its table
// goes to shared memory once, in the bank-per-lane layout: entry (v, m,
// code) at word ((slot * K + code) * V + v) * 32 + lane for the (slot,
// lane) of m, so lane i's lookups all fall in bank i and none conflict (the
// entries of a lane with no subspace in a slot are 0). A warp takes 32 rows
// at a time: one version a lane, spread to every lane by kVBits ballots;
// the rows' codes in four batches of 8, each batch's loads issued two
// batches ahead, into the next group too (at M=96 a row's 96 code bytes
// come as 64 B and 32 B coalesced); each lane sums its slots of each row in
// slot order, (t_0 + t_1) + t_2 + ..., and a reduce-scatter over the warp
// (31 shuffle-adds) leaves lane i with row i's sum, stored coalesced. Sum
// order: per row, the 32 lane partials combined as a butterfly, pairs at
// lane distance 16 first (tests/test_torch_kernels.py emulates it). kK,
// kM, kV: K, M and V fixed at compile time (the path's 256, 96 and 2,
// which turns every table and code offset into an immediate), or 0 for
// the values passed.
template <int kS, int kPairs, int kVBits, int kK, int kM, int kV>
__global__ void __launch_bounds__(kDenseThreads, 1)
    adc_dense_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ versions, float* __restrict__ out, int V_,
                     int M_, int K_, int N, int rows) {
  extern __shared__ __align__(16) float table[];  // kS * K * V * 32 floats of query b
  const int K = kK ? kK : K_, M = kM ? kM : M_, V = kV ? kV : V_;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = (int)(threadIdx.x & 31u);  // known to be < 32: no bound check on it
  const int kq = K / 4;
  for (int i = threadIdx.x; i < V * kS * kq * 32; i += kDenseThreads) {
    const int li = i % 32, q = (i / 32) % kq, vs = i / 32 / kq;
    const int v = vs / kS, slot = vs % kS;
    const int m = dense_m(slot, li, M, kPairs);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m >= 0)
      x = __ldg(reinterpret_cast<const float4*>(luts + (((int64_t)b * V + v) * M + m) * K + 4 * q));
    float* dst = table + (((size_t)slot * K + 4 * q) * V + v) * 32 + li;
    dst[0] = x.x;
    dst[V * 32] = x.y;
    dst[2 * V * 32] = x.z;
    dst[3 * V * 32] = x.w;
  }
  __syncthreads();
  const int64_t r_begin = (int64_t)blockIdx.x * rows;
  const int64_t r_end = min((int64_t)N, r_begin + rows);
  const char* t = reinterpret_cast<const char*>(table);
  constexpr int kCodes = kS - kPairs;
  constexpr int64_t kStride = 32 * kDenseWarps;
  // the warp's groups of 32 rows from r0; each group's codes in four
  // batches of 8 rows, loaded two batches ahead, across groups too
  int64_t r0 = r_begin + 32 * warp;
  if (r0 >= r_end) return;
  int nr = (int)min((int64_t)32, r_end - r0);  // rows of the group: the same in every lane
  uint32_t ca[8][kCodes], cb[8][kCodes];
  dense_load<kS, kPairs, 0, 8, false>(ca, codes + r0 * M, M, nr, lane);
  dense_load<kS, kPairs, 8, 8, false>(cb, codes + r0 * M, M, nr, lane);
  int my_v = lane < nr ? min((int)versions[r0 + lane], V - 1) : 0;
  while (true) {
    unsigned vb[3] = {__ballot_sync(0xffffffffu, my_v & 1), 0u, 0u};
    if (kVBits > 1) vb[1] = __ballot_sync(0xffffffffu, my_v & 2);
    if (kVBits > 2) vb[2] = __ballot_sync(0xffffffffu, my_v & 4);
    const int64_t r1 = r0 + kStride;  // the next group, its first two batches loaded now
    const int n1 = r1 < r_end ? (int)min((int64_t)32, r_end - r1) : 0;
    float p[32];  // p[r]: this lane's partial of row r0 + r
    if (r1 + 32 <= N) {  // this group's rows and the next one's lie inside the codes
      dense_group<kS, kPairs, kVBits, true>(p, ca, cb, codes + r0 * M, codes + r1 * M, M, K, V,
                                            nr, n1, lane, t, vb);
    } else {
      dense_group<kS, kPairs, kVBits, false>(p, ca, cb, codes + r0 * M, codes + r1 * M, M, K, V,
                                             nr, n1, lane, t, vb);
    }
    my_v = lane < n1 ? min((int)versions[r1 + lane], V - 1) : 0;
    reduce_scatter<16>(p, lane);
    if (lane < nr) out[(int64_t)b * N + r0 + lane] = p[0];
    if (n1 == 0) break;
    r0 = r1;
    nr = n1;
  }
}

// What the launcher needs of a device, queried once per device: its
// shared-memory limit, its SM count, and whether each shared-memory kernel's
// limit has been raised to it.
struct DeviceInfo {
  bool ready = false;
  int smem_optin = 0, sms = 0;
  bool raised[40] = {};  // by kernel: kRaisedStaged ... kRaisedDense + (slots - 1) * 4 + pairs
};
constexpr int kMaxDevices = 64;
constexpr int kRaisedStaged = 0, kRaisedDensePath = 1, kRaisedDense = 5;
DeviceInfo g_devices[kMaxDevices];

cudaError_t device_info(DeviceInfo** out) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[device];
  if (!d.ready) {
    e = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// Raise kernel's dynamic shared-memory limit to the device's, once; refuse
// a launch that needs more.
template <class Kernel>
cudaError_t allow_smem(DeviceInfo* d, int which, Kernel kernel, size_t smem) {
  if (smem > (size_t)d->smem_optin) return cudaErrorInvalidValue;
  if (!d->raised[which]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d->smem_optin);
    if (e != cudaSuccess) return e;
    d->raised[which] = true;
  }
  return cudaSuccess;
}

template <int kS, int kPairs, int kVBits = 3, int kK = 0, int kM = 0, int kV = 0>
cudaError_t launch_dense_t(DeviceInfo* d, dim3 grid, size_t smem, const float* luts,
                           const uint8_t* codes, const uint8_t* versions, float* out, int V,
                           int M, int K, int N, int rows, cudaStream_t stream) {
  const int which = kK ? kRaisedDensePath + 2 * kPairs + kV - 1
                       : kRaisedDense + (kS - 1) * 4 + kPairs;
  const cudaError_t e =
      allow_smem(d, which, adc_dense_kernel<kS, kPairs, kVBits, kK, kM, kV>, smem);
  if (e != cudaSuccess) return e;
  adc_dense_kernel<kS, kPairs, kVBits, kK, kM, kV><<<grid, kDenseThreads, smem, stream>>>(
      luts, codes, versions, out, V, M, K, N, rows);
  return cudaGetLastError();
}

template <int kS, int kPairs = 0>
cudaError_t launch_dense_s(int pairs, DeviceInfo* d, dim3 grid, size_t smem, const float* luts,
                           const uint8_t* codes, const uint8_t* versions, float* out, int V,
                           int M, int K, int N, int rows, cudaStream_t stream) {
  if constexpr (2 * kPairs <= kS) {
    if (pairs == kPairs)
      return launch_dense_t<kS, kPairs>(d, grid, smem, luts, codes, versions, out, V, M, K, N,
                                        rows, stream);
    return launch_dense_s<kS, kPairs + 1>(pairs, d, grid, smem, luts, codes, versions, out, V,
                                          M, K, N, rows, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

// The dense kernel for `slots` slots, `pairs` of them pair groups.
cudaError_t launch_dense(DeviceInfo* d, int slots, int pairs, dim3 grid, size_t smem,
                         const float* luts, const uint8_t* codes, const uint8_t* versions,
                         float* out, int V, int M, int K, int N, int rows, cudaStream_t stream) {
#define REPRO_DENSE_SLOTS(S)                                                                  \
  case S:                                                                                     \
    return launch_dense_s<S>(pairs, d, grid, smem, luts, codes, versions, out, V, M, K, N, rows, \
                             stream);
  switch (slots) {
    REPRO_DENSE_SLOTS(1)
    REPRO_DENSE_SLOTS(2)
    REPRO_DENSE_SLOTS(3)
    REPRO_DENSE_SLOTS(4)
    REPRO_DENSE_SLOTS(5)
    REPRO_DENSE_SLOTS(6)
    REPRO_DENSE_SLOTS(7)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DENSE_SLOTS
}

}  // namespace

// form: kFormL2 (ids may be NULL: rows r = c), kFormStaged, kFormDense (ids
// NULL); ops.py picks it by shape.
extern "C" int repro_pq_adc(const float* luts, const uint8_t* codes,
                            const uint8_t* versions, const int32_t* ids,
                            float* out, int B, int V, int M, int K, int N, int C, int form,
                            cudaStream_t stream) {
  if (form == kFormL2) {
    const dim3 grid((C + 31) / 32, B);
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
    if (M % 8 == 0 && at % 8 == 0)
      adc_l2_kernel<8><<<grid, 32 * kQGroups, 0, stream>>>(luts, codes, versions, ids, out, V, M,
                                                           K, N, C);
    else
      adc_l2_kernel<1><<<grid, 32 * kQGroups, 0, stream>>>(luts, codes, versions, ids, out, V, M,
                                                           K, N, C);
    return (int)cudaGetLastError();
  }
  DeviceInfo* d = nullptr;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return (int)e;
  if (form == kFormStaged) {
    if (ids == nullptr || V > 32 || K % 4 != 0 || reinterpret_cast<uintptr_t>(luts) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = staged_smem(V, M, K);
    e = allow_smem(d, kRaisedStaged, adc_staged_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    adc_staged_kernel<<<B, kLanes * kStagedTile, smem, stream>>>(luts, codes, versions, ids, out,
                                                                 V, M, K, N, C);
    return (int)cudaGetLastError();
  }
  if (ids != nullptr || K % 4 != 0 || reinterpret_cast<uintptr_t>(luts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // one table residency per block, every block resident at once: enough
  // blocks per query to fill the SMs, rows in whole warps' groups
  const int per_query = B >= d->sms ? 1 : d->sms / B;
  int rows = (N + per_query - 1) / per_query;
  rows = (rows + 31) / 32 * 32;
  const dim3 grid((N + rows - 1) / rows, B);
  if (form != kFormDense && form != kFormDenseSingles) return (int)cudaErrorInvalidValue;
  const int slots = (M + 31) / 32;
  if (slots > kDenseMaxSlots || V > 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * slots * K * 32 * sizeof(float);
  const bool pairs = form == kFormDense && M % 2 == 0 && reinterpret_cast<uintptr_t>(codes) % 2 == 0;
  if (M == 96 && K == 256 && V <= 2) {  // the paper configuration: offsets at compile time
#define REPRO_DENSE_PATH(P, VV)                                                              \
  return (int)launch_dense_t<3, P, 1, 256, 96, VV>(d, grid, smem, luts, codes, versions, out, V, \
                                                   M, K, N, rows, stream)
    if (pairs && V == 2) REPRO_DENSE_PATH(1, 2);
    if (pairs) REPRO_DENSE_PATH(1, 1);
    if (V == 2) REPRO_DENSE_PATH(0, 2);
    REPRO_DENSE_PATH(0, 1);
#undef REPRO_DENSE_PATH
  }
  return (int)launch_dense(d, slots, pairs ? M / 64 : 0, grid, smem, luts, codes, versions, out,
                           V, M, K, N, rows, stream);
}
