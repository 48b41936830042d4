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
//  * dense (Q-Flat over all N rows): every row is looked up in every table,
//    so one query's table is staged once in dynamic shared memory and a grid
//    of blocks per query sweeps the rows, one thread per row.
//  * ids < 0 or >= N write +inf; the caller masks such lanes anyway.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace {

// form codes, as ops.py passes them
constexpr int kFormL2 = 0, kFormStaged = 1, kFormDense = 2;

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

// What the launcher needs of a device, queried once per device: its
// shared-memory limit, its SM count, and whether each shared-memory kernel's
// limit has been raised to it.
struct DeviceInfo {
  bool ready = false;
  int smem_optin = 0, sms = 0;
  bool raised[2] = {false, false};  // staged, dense
};
constexpr int kMaxDevices = 64;
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
    e = allow_smem(d, 0, adc_staged_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    adc_staged_kernel<<<B, kLanes * kStagedTile, smem, stream>>>(luts, codes, versions, ids, out,
                                                                 V, M, K, N, C);
    return (int)cudaGetLastError();
  }
  if (form != kFormDense || ids != nullptr || (V * M * K) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(luts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * M * K * sizeof(float);
  e = allow_smem(d, 1, adc_dense_smem_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 512;
  // one table residency per block: enough blocks per query to fill the
  // card about twice over, never more than the rows need
  int per_query = (2 * d->sms + B - 1) / B;
  const int need = (N + threads - 1) / threads;
  per_query = per_query < need ? per_query : need;
  per_query = per_query < 1 ? 1 : per_query;
  dim3 grid(per_query, B);
  adc_dense_smem_kernel<<<grid, threads, smem, stream>>>(luts, codes, versions, out, V, M, K, N);
  return (int)cudaGetLastError();
}
