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
// byte. In f32 outside the tensor cores (67 TFLOP/s) operations bound it at
// 0.293 ms; on the tensor cores at f32 accuracy (three TF32 products, 495
// TFLOP/s) at 0.119 ms, close to the bytes (307 MB of x, 0.092 ms; with the
// output 0.107 ms). The gathered rerank (C=50 rows per query) reads each row
// once for 3 flops per 4 bytes: bytes bound it.
//
// Design:
//  * dense f32 ("3xTF32" on wgmma): each f32 operand a is split into a
//    high part, a itself, of which the tensor core reads the TF32 bits
//    (trunc(a)), and the f32 remainder lo = a - trunc(a), of which it reads
//    the top TF32 bits again; the tensor cores accumulate lo*hi + hi*lo +
//    hi*hi in f32. The dropped lo*lo term and the truncations are ~2^-20
//    relative, near f32 rounding, where TF32 alone (2^-11) is not. A block
//    of two warpgroups takes a 128x128 output tile (all of B=128, so x is
//    read from device memory once); each warpgroup issues
//    wgmma.m64n128k8 with its 64 rows of q as register fragments and x from
//    shared memory. Tiles of q and x (32 deep) stream through a 2-stage
//    cp.async ring, x into wgmma's K-major core-matrix layout (8 rows x 16
//    bytes per 128-byte core matrix, no swizzle); per tile one pass writes
//    x's low parts beside it and sums both norms, which are exact f32 sums
//    of the unsplit values, so the epilogue (norms, -2 q.x, clamp) needs no
//    second pass. At 128 registers and 86 KB of shared memory two blocks
//    share an SM, so one block's copies and splits overlap the other's
//    products. Ragged B and N zero-fill rows; D need not be a multiple of
//    32 (zero-filled tail), and when it is not a multiple of 4 the copies go
//    4 bytes at a time.
//  * dense bf16 (off the main path): a 64x64 SIMT tile per block of 256
//    threads, 4x4 outputs per thread, the D axis walked in steps of 16
//    through shared memory, f32 accumulation.
//  * gathered: one warp per (query, candidate); lanes stride over D with
//    float4 loads when D % 4 == 0 and the rows are 16-byte aligned, then a
//    shuffle reduction.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// ---- dense bf16: SIMT tile ---------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;

__global__ void flat_dense_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ x,
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
      As[kk][r] = (gr < B && gk < D) ? __bfloat162float(q[(int64_t)gr * D + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < BN * BK; e += blockDim.x) {
      const int r = e / BK, kk = e % BK;
      const int gr = col0 + r, gk = k0 + kk;
      Bs[kk][r] = (gr < N && gk < D) ? __bfloat162float(x[(int64_t)gr * D + gk]) : 0.f;
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

// ---- dense f32 on the tensor cores: 3xTF32 with wgmma ----------------------

constexpr int WBM = 128, WBN = 128, WBK = 32, WTHREADS = 256, WSTAGES = 2;
constexpr int QLD = WBK + 4;        // q tile row pitch in floats: fragment loads hit 32 banks
constexpr int QTILE = WBM * QLD;    // floats
constexpr int XTILE = WBN * WBK;    // floats, in core matrices (see x_offset)
constexpr int WSMEM = (WSTAGES * (QTILE + XTILE) + XTILE) * (int)sizeof(float);

// x tile element (n, k) at float x_offset(n, k): 8 rows x 4 k (16 bytes a row)
// make one 128-byte core matrix; core matrices neighbouring in n are 128 bytes
// apart, in k WBN * 16 bytes apart (wgmma's K-major layout without swizzle).
__device__ __forceinline__ int x_offset(int n, int k) {
  return (k / 4) * (WBN * 4) + n * 4 + k % 4;
}

__device__ __forceinline__ uint64_t x_desc(const float* tile, int k) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(tile + x_offset(0, k));
  const uint64_t lbo = WBN * 16, sbo = 128;  // bytes to the next core matrix in k, in n
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

// d (64 x 128 per warpgroup, f32, 64 registers a thread) += a (64 x 8 tf32 in
// registers: the mma.m16n8k8 A fragment of this warp's 16 rows) * b (8 x 128
// tf32 in shared memory, K-major, described by desc)
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ float trunc_tf32(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xFFFFE000u);
}

// rows [row0, row0 + 128) of src (n_rows x D), columns [k0, k0 + WBK), to
// smem element (r, k) at offset(r, k); out-of-range rows and columns read 0.
template <bool kVec, class Offset>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int n_rows, int D, int k0, Offset offset) {
  if (kVec) {  // D % 4 == 0: a 16-byte chunk is wholly inside D or wholly past it
    for (int c = threadIdx.x; c < 128 * (WBK / 4); c += WTHREADS) {
      const int r = c / (WBK / 4), kc = (c % (WBK / 4)) * 4;
      const bool ok = row0 + r < n_rows && k0 + kc < D;
      const float* g = ok ? src + (int64_t)(row0 + r) * D + k0 + kc : src;
      cp_async16(dst + offset(r, kc), g, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < 128 * WBK; c += WTHREADS) {
      const int r = c / WBK, kk = c % WBK;
      const bool ok = row0 + r < n_rows && k0 + kk < D;
      const float* g = ok ? src + (int64_t)(row0 + r) * D + k0 + kk : src;
      cp_async4(dst + offset(r, kk), g, ok ? 4 : 0);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(WTHREADS, 2) flat_dense_3xtf32_kernel(
    const float* __restrict__ q, const float* __restrict__ x, float* __restrict__ out, int B,
    int N, int D, int ip) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float qn_s[2][WBM], xn_s[2][WBN];
  float* Qs = smem;                      // [WSTAGES][WBM][QLD]
  float* Xs = smem + WSTAGES * QTILE;    // [WSTAGES][XTILE]
  float* Xlo = Xs + WSTAGES * XTILE;     // [XTILE]: x - trunc(x) of the current tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp * 16;  // this warp's 16 rows: warpgroup warp / 4, its warp warp % 4
  const int row0 = blockIdx.y * WBM, col0 = blockIdx.x * WBN;
  const int KT = (D + WBK - 1) / WBK;
  const auto q_off = [](int r, int k) { return r * QLD + k; };
  const auto x_off = [](int r, int k) { return x_offset(r, k); };
  // norms: thread t sums row t % 128 over half t / 128 of each tile's columns
  const int nr = threadIdx.x % 128, nh = threadIdx.x / 128;
  float qn = 0.f, xn = 0.f;
  float acc[WBN / 2];
#pragma unroll
  for (int i = 0; i < WBN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < KT) {
      load_tile<kVec>(Qs + s * QTILE, q, row0, B, D, s * WBK, q_off);
      load_tile<kVec>(Xs + s * XTILE, x, col0, N, D, s * WBK, x_off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(WSTAGES - 2) : "memory");
    __syncthreads();  // tile kt is in; tile kt - 1 is no longer read
    const int nxt = kt + WSTAGES - 1;
    if (nxt < KT) {
      load_tile<kVec>(Qs + (nxt % WSTAGES) * QTILE, q, row0, B, D, nxt * WBK, q_off);
      load_tile<kVec>(Xs + (nxt % WSTAGES) * XTILE, x, col0, N, D, nxt * WBK, x_off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* Q = Qs + (kt % WSTAGES) * QTILE;
    const float* X = Xs + (kt % WSTAGES) * XTILE;
    // the x tile's low parts, and both norms, one pass
#pragma unroll
    for (int k = nh * (WBK / 2); k < (nh + 1) * (WBK / 2); k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(X + x_offset(nr, k));
      const float4 lo = make_float4(v.x - trunc_tf32(v.x), v.y - trunc_tf32(v.y),
                                    v.z - trunc_tf32(v.z), v.w - trunc_tf32(v.w));
      *reinterpret_cast<float4*>(Xlo + x_offset(nr, k)) = lo;
      xn = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, xn))));
      const float4 u = *reinterpret_cast<const float4*>(Q + q_off(nr, k));
      qn = fmaf(u.x, u.x, fmaf(u.y, u.y, fmaf(u.z, u.z, fmaf(u.w, u.w, qn))));
    }
    // this warp's q fragments: hi as is (the tensor core reads its TF32
    // bits), lo the remainder
    uint32_t ahi[WBK / 8][4], alo[WBK / 8][4];
#pragma unroll
    for (int s8 = 0; s8 < WBK / 8; ++s8) {
      const float* p = Q + q_off(wr + g, 8 * s8 + t4);
      const float a[4] = {p[0], p[8 * QLD], p[4], p[8 * QLD + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[s8][i] = __float_as_uint(a[i]);
        alo[s8][i] = __float_as_uint(a[i] - trunc_tf32(a[i]));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the low parts are written
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < WBK / 8; ++s8) {
      const uint64_t dhi = x_desc(X, 8 * s8), dlo = x_desc(Xlo, 8 * s8);
      wgmma_tf32_m64n128k8(acc, alo[s8], dhi);  // the small terms first
      wgmma_tf32_m64n128k8(acc, ahi[s8], dlo);
      wgmma_tf32_m64n128k8(acc, ahi[s8], dhi);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  qn_s[nh][nr] = qn;
  xn_s[nh][nr] = xn;
  __syncthreads();
  // acc[4j + 2h + c]: row wr + g + 8h, column 8j + 2 t4 + c
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wr + g + 8 * h;
    if (row0 + rl >= B) continue;
    const float qq = qn_s[0][rl] + qn_s[1][rl];
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cl = 8 * j + 2 * t4 + c;
        if (col0 + cl >= N) continue;
        const float dot = acc[4 * j + 2 * h + c];
        float v;
        if (ip) {
          v = -dot;
        } else {
          v = qq + xn_s[0][cl] + xn_s[1][cl] - 2.0f * dot;
          v = v > 0.f ? v : 0.f;
        }
        out[(int64_t)(row0 + rl) * N + col0 + cl] = v;
      }
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
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
    const int threads = (BM / TM) * (BN / TN);
    flat_dense_bf16_kernel<<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), out, B, N, D,
        metric_ip);
    return (int)cudaGetLastError();
  }
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const bool vec =
      D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  void (*kernel)(const float*, const float*, float*, int, int, int, int) =
      vec ? &flat_dense_3xtf32_kernel<true> : &flat_dense_3xtf32_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             WSMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + WBN - 1) / WBN, (B + WBM - 1) / WBM);
  kernel<<<grid, WTHREADS, WSMEM, stream>>>(qf, xf, out, B, N, D, metric_ip);
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
