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
// Bound on the H100: operations. At the paper configuration (D=768, M=96,
// K=256, dsub=8) each row is compared with all M*K centroids: 2*K*dsub flops
// per 4*dsub bytes of x, ~128 flops per byte (f32 SIMT). The main path calls
// it at N=100 (each insert mini-batch), 1 000 (the bootstrap's k-means and
// backlog) and 25 000 (the re-quantization's k-means).
//
// Design: K spread over the lanes of a warp. The work is (subspace, tile of
// up to 128 rows) items, shared out evenly over one wave of blocks (or one
// item a block when there are few). A block stages its subspace's codebook
// in shared memory once, and lane l of every warp keeps centroids
// k = l + 32*s (s < 8, so K <= 256) and their norms in registers for the
// widths the repository uses (dsub 8, 4, 2: templated). Each item's
// subvectors are copied to shared memory by cp.async, one row a thread, the
// next item's while this one is scored. A warp scores 8 rows per pass with
// no branch (each lane its centroids in order, keeping a score only when it
// is below its best, so the first of equal scores), then merges the 32
// lanes' (score, k) by a reduce-scatter shuffle (8 rows to one per group of
// 4 lanes in three steps, then two more): the smaller score and, on equal
// scores, the lower k, the first index whatever the split or the order of
// the merge. Each score is the f32 expression a serial scan computes,
// (xx - 2*dot) + cnorm[k], with dot, xx and the norms summed in j order, so
// the codes are bit-equal to one thread per row scanning all K. No centroid
// is read per row: a thread that reads one from shared memory for every
// multiply-add is bound by those loads. At N=100 the grid runs 480 blocks
// of 24 rows. Any other dsub <= 32 (3, 6, 16, 32: examples and tests) takes
// the same kernel with the centroids read from shared memory as [dsub][K],
// so the lanes of a warp read consecutive words.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxDsub = 32;
constexpr int kSlots = 8;       // centroids per lane: K <= 32 * kSlots
constexpr int kThreads = 128;   // 4 warps a block
constexpr int kBlocksPerSM = 4; // blocks the grid aims for on each SM, all resident: one wave
constexpr int kRows = 8;        // rows a warp scores in one pass

// (best, k) merged with (d, kd): the smaller score, on equal scores the lower k
__device__ __forceinline__ void take_min(float& best, int& k, float d, int kd) {
  const bool take = d < best || (d == best && kd < k);
  best = take ? d : best;
  k = take ? kd : k;
}

// The rows of the tile at row0: tile, or fewer at the end.
__device__ __forceinline__ int rows_at(int64_t row0, int N, int tile) {
  return N - row0 < tile ? (int)(N - row0) : tile;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of kBytes (4, 8 or 16; both addresses aligned to it) into shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// One reduce-scatter step over lane bit o: of each pair of rows (j, j +
// kHalf) a lane keeps the one its bit names, merged with its partner's.
template <int kHalf>
__device__ __forceinline__ void scatter_round(float* bs, int* bk, int lane, int o) {
  const bool hi = lane & o;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float ss = hi ? bs[j] : bs[j + kHalf];
    const int sk = hi ? bk[j] : bk[j + kHalf];
    float ks = hi ? bs[j + kHalf] : bs[j];
    int kk = hi ? bk[j + kHalf] : bk[j];
    take_min(ks, kk, __shfl_xor_sync(0xffffffffu, ss, o), __shfl_xor_sync(0xffffffffu, sk, o));
    bs[j] = ks;
    bk[j] = kk;
  }
}

// Rows [row0, row0 + rows) of subspace m into dst (rows x d), one row a
// thread, as one cp.async group (committed, empty for threads past rows).
template <int kD>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ x, int64_t row0,
                                           int rows, int64_t D, int m, int d, bool vec) {
  const int t = threadIdx.x;
  if (t < rows) {
    const float* src = x + (row0 + t) * D + (int64_t)m * d;
    float* to = dst + t * d;
    if constexpr (kD > 0 && kD % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < kD; j += 4) cp_async<16>(to + j, src + j);
        return commit();
      }
    } else if constexpr (kD == 2) {
      if (vec) {
        cp_async<8>(to, src);
        return commit();
      }
    }
    for (int j = 0; j < d; ++j) cp_async<4>(to + j, src + j);
  }
  commit();
}

// Subspace m's codebook into shared memory, read once by the block ([K][kD]
// for kD > 0, [dsub][K] for kD == 0, so the lanes of a warp read consecutive
// words), and lane l's centroids k = l + 32 s with their norms into
// registers (the centroids only for kD > 0). A slot past K gets the norm
// +inf, so it never wins.
template <int kD>
__device__ __forceinline__ void load_centroids(float* cent, float* cnorm, float* cbs,
                                               const float* __restrict__ cbm, int lane, int K,
                                               int d, bool vec) {
  if (kD > 0 && vec && (K * d) % 4 == 0) {
    for (int i = threadIdx.x; i < K * d / 4; i += blockDim.x)
      reinterpret_cast<float4*>(cbs)[i] = reinterpret_cast<const float4*>(cbm)[i];
  } else {
    for (int i = threadIdx.x; i < K * d; i += blockDim.x)
      cbs[kD > 0 ? i : (i % d) * K + i / d] = cbm[i];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int k = lane + 32 * s;
    float nrm = CUDART_INF_F;
    if constexpr (kD > 0) {
#pragma unroll
      for (int j = 0; j < kD; ++j) cent[s * kD + j] = 0.f;
    }
    if (k < K) {
      nrm = 0.f;
      if constexpr (kD > 0) {
        const float* c = cbs + k * kD;
        if constexpr (kD % 4 == 0) {  // 16-byte aligned rows
#pragma unroll
          for (int j = 0; j < kD; j += 4) {
            const float4 q = *reinterpret_cast<const float4*>(c + j);
            cent[s * kD + j] = q.x;
            cent[s * kD + j + 1] = q.y;
            cent[s * kD + j + 2] = q.z;
            cent[s * kD + j + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kD; ++j) cent[s * kD + j] = c[j];
        }
#pragma unroll
        for (int j = 0; j < kD; ++j) nrm += cent[s * kD + j] * cent[s * kD + j];
      } else {
        for (int j = 0; j < d; ++j) nrm += cbs[j * K + k] * cbs[j * K + k];
      }
    }
    cnorm[s] = nrm;
  }
}

// kD > 0: dsub == kD, each lane's centroids in registers. kD == 0: any
// dsub <= kMaxDsub, centroids read from shared memory as [dsub][K]. The
// work is M * T items (subspace m, tile t of `tile` rows, tile <= kThreads);
// block b takes items [b*I/G, (b+1)*I/G) of I, in order, so its subspace
// changes at most a few times; the next item's rows copy (cp.async, two
// buffers) while this one's are scored. Each warp scores kRows rows per
// pass, then a reduce-scatter shuffle leaves lanes 4i..4i+3 with one row's
// (score, k).
template <int kD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    pq_encode_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     uint8_t* __restrict__ codes, int N, int M, int K, int dsub, int tile, int T,
                     bool vec) {
  extern __shared__ __align__(16) float smem[];  // [codebook] [2 x tile x dsub rows]
  constexpr int kR = kD > 0 ? kD : kMaxDsub;     // a row's values a lane holds
  const int d = kD > 0 ? kD : dsub;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t D = (int64_t)M * d;
  float* cbs = smem;
  float* xs = smem + ((K * d + 3) & ~3);
  const int64_t items = (int64_t)M * T;
  const int i0 = (int)(items * blockIdx.x / gridDim.x);
  const int i1 = (int)(items * (blockIdx.x + 1) / gridDim.x);

  if (i0 < i1) {
    const int64_t first = (int64_t)(i0 % T) * tile;
    stage_rows<kD>(xs, x, first, rows_at(first, N, tile), D, i0 / T, d, vec);
  }
  float cent[kD > 0 ? kSlots * kD : 1];
  float cnorm[kSlots];
  int m = -1;
  for (int i = i0; i < i1; ++i) {
    const int it = i - i0;
    const int64_t row0 = (int64_t)(i % T) * tile;
    const int rows = rows_at(row0, N, tile);
    float* cur = xs + (it & 1) * tile * d;
    if (i + 1 < i1) {
      const int64_t next = (int64_t)((i + 1) % T) * tile;
      stage_rows<kD>(xs + ((it + 1) & 1) * tile * d, x, next, rows_at(next, N, tile), D,
                     (i + 1) / T, d, vec);
    } else {
      commit();  // an empty group keeps wait_group 1 counting items
    }
    if (i / T != m) {  // the same for the whole block
      m = i / T;
      load_centroids<kD>(cent, cnorm, cbs, cb + (int64_t)m * K * d, lane, K, d, vec);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's copies have landed
    __syncthreads();
    for (int base = kRows * warp; base < rows; base += kRows * (kThreads / 32)) {
      // |x|^2 of row base + lane, for lanes below kRows; each row reads its own
      float xx_mine = 0.f;
      if (lane < kRows) {
        const float* xr = cur + (base + lane < rows ? base + lane : 0) * d;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const float v = j < d ? xr[j] : 0.f;
          xx_mine += v * v;
        }
      }
      float bs[kRows];
      int bk[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* xr = cur + (base + r < rows ? base + r : 0) * d;
        float xv[kR];
        if constexpr (kD > 0 && kD % 4 == 0) {  // the rows are 16-byte aligned
#pragma unroll
          for (int j = 0; j < kD; j += 4) {
            const float4 q = *reinterpret_cast<const float4*>(xr + j);
            xv[j] = q.x;
            xv[j + 1] = q.y;
            xv[j + 2] = q.z;
            xv[j + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kR; ++j) xv[j] = j < d ? xr[j] : 0.f;
        }
        const float xx = __shfl_sync(0xffffffffu, xx_mine, r);
        bs[r] = CUDART_INF_F;
        bk[r] = K;  // no centroid: loses to any lane that has one
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int k = lane + 32 * s;
          float dot = 0.f;
          if constexpr (kD > 0) {
#pragma unroll
            for (int j = 0; j < kD; ++j) dot += xv[j] * cent[s * kD + j];
          } else {
            const int kk = k < K ? k : 0;
#pragma unroll
            for (int j = 0; j < kR; ++j)
              if (j < d) dot += xv[j] * cbs[j * K + kk];
          }
          // (xx - 2 dot) + |c|^2: 2 dot is exact, so the fma rounds as the subtraction does
          const float sc = fmaf(-2.0f, dot, xx) + cnorm[s];
          bk[r] = sc < bs[r] ? k : bk[r];  // strict: a lane's first index wins its ties
          bs[r] = sc < bs[r] ? sc : bs[r];
        }
      }
      // reduce-scatter over lane bits 4, 3, 2: lane L keeps row
      // 4*bit4 + 2*bit3 + bit2 of L, merged with its partner's; then bits 1, 0
      static_assert(kRows == 8, "three scatter steps take 8 rows to one");
      scatter_round<4>(bs, bk, lane, 16);
      scatter_round<2>(bs, bk, lane, 8);
      scatter_round<1>(bs, bk, lane, 4);
#pragma unroll
      for (int o = 2; o > 0; o >>= 1)
        take_min(bs[0], bk[0], __shfl_xor_sync(0xffffffffu, bs[0], o),
                 __shfl_xor_sync(0xffffffffu, bk[0], o));
      const int r = 4 * (lane >> 4 & 1) + 2 * (lane >> 3 & 1) + (lane >> 2 & 1);
      if ((lane & 3) == 0 && base + r < rows)
        codes[(row0 + base + r) * M + m] = (uint8_t)(bk[0] < K ? bk[0] : 0);
    }
    __syncthreads();  // every warp is done with `cur` (and the codebook) before they are refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int g_sms[64] = {};  // SM count of each device, queried once

template <int kD>
cudaError_t launch(const float* x, const float* cb, uint8_t* codes, int N, int M, int K, int dsub,
                   bool vec, int sms, cudaStream_t stream) {
  // T tiles a subspace, of at most kThreads rows, and at least enough items
  // for kBlocksPerSM blocks on every SM; one block an item up to two waves,
  // else one wave of blocks sharing the items out evenly
  const int grid_max = kBlocksPerSM * sms;
  int T = (N + kThreads - 1) / kThreads;
  const int want = (grid_max + M - 1) / M;
  T = T > want ? T : want;
  T = T < N ? T : N;
  int tile = (N + T - 1) / T;
  tile = (tile + kRows - 1) / kRows * kRows;  // whole passes
  tile = tile < kThreads ? tile : kThreads;
  T = (N + tile - 1) / tile;
  const int64_t items = (int64_t)M * T;
  const int blocks = (int)(items <= 2 * grid_max ? items : grid_max);
  const size_t smem = ((((size_t)K * dsub + 3) & ~(size_t)3) + 2 * (size_t)tile * dsub) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(pq_encode_kernel<kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  pq_encode_kernel<kD><<<blocks, kThreads, smem, stream>>>(x, cb, codes, N, M, K,
                                                                         dsub, tile, T, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_pq_encode(const float* x, const float* codebooks, uint8_t* codes, int N,
                               int M, int K, int dsub, cudaStream_t stream) {
  if (dsub < 1 || dsub > kMaxDsub || K < 1 || K > 32 * kSlots || N < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_sms[device]) {
    e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  const int sms = g_sms[device];
  // 16-byte loads of a subvector and a centroid need 16-byte aligned rows
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(codebooks) % 16 == 0;
  switch (dsub) {
    case 8: e = launch<8>(x, codebooks, codes, N, M, K, dsub, vec, sms, stream); break;
    case 4: e = launch<4>(x, codebooks, codes, N, M, K, dsub, vec, sms, stream); break;
    case 2: e = launch<2>(x, codebooks, codes, N, M, K, dsub, vec, sms, stream); break;
    default: e = launch<0>(x, codebooks, codes, N, M, K, dsub, vec, sms, stream); break;
  }
  return (int)e;
}

