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
//  * dense bf16 (off the main path) on wgmma.m64n128k16.f32.bf16.bf16: two
//    bf16 values multiply exactly in f32 (8-bit significands, a 16-bit
//    product), so one tensor-core product with f32 accumulation computes
//    what the f32 reference computes after its cast, up to the order of the
//    sums, and no split is needed. Bytes bound it: (B + N) * D * 2 read and
//    B * N * 4 written, 205 MB at the main path's shapes (0.061 ms); the
//    products (19.7 GFLOP, 0.020 ms at 989 TFLOP/s) do not. One block per
//    SM walks 128 x 128 output tiles (all of B=128, so x is read from device
//    memory once, and q, 196 KB, from L2 once per tile). Warpgroup 0 keeps
//    a 6-stage ring of (q, x) tiles 64 deep filled by TMA (128-byte
//    swizzle, one mbarrier per stage, rows past B or N and columns past D
//    arrive as zeros), running ahead into the next tile while the consumers
//    write this one. Warpgroups 1 and 2 each multiply 64 q rows by the x
//    tile, both operands described in shared memory, and leave one step's
//    products in flight (wait_group 1) while they sum both norms in f32 from
//    the same staged tiles, so x is read once. The epilogue stages each
//    warp's 16 x 32 outputs in shared memory and writes 16 bytes a lane,
//    4 rows of 128 bytes a store. Where TMA cannot describe the rows (D % 8
//    != 0, or a pointer not 16-byte aligned) the copying warpgroup fills the
//    same swizzled tiles with 2-byte loads: a template parameter of the same
//    kernel. Design choices and their times: PERF.md, from
//    scripts/torch_flat_variants.py.
//  * gathered: one warp per (query, candidate); lanes stride over D with
//    float4 loads when D % 4 == 0 and the rows are 16-byte aligned, then a
//    shuffle reduction.
#include <cstdint>
#include <cstring>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// ---- dense bf16 on the tensor cores: wgmma.m64nNk16.f32.bf16.bf16 ---------

// The design the launcher takes (scripts/torch_flat_variants.py builds
// copies of this file with these three lines changed).
constexpr int kBf16TileN = 128;     // x rows per tile: the N of wgmma.m64nNk16
constexpr int kBf16Stages = 6;      // depth of the copy ring
constexpr int kBf16WaitDepth = 1;   // wgmma groups left in flight when a step ends

constexpr int HBM = 128;            // q rows per tile: two consumer warpgroups of 64
constexpr int HBK = 64;             // bf16 deep per step: one 128-byte swizzled row
constexpr int HTHREADS = 384;       // warpgroup 0 copies, warpgroups 1 and 2 multiply
constexpr int HCONSUMERS = 256;
constexpr int HPITCH = 40;          // floats a row of a warp's output staging (bank spread)
constexpr int HROWS = 16, HCOLS = 32;  // a warp stages 16 rows x 32 columns at a time

template <int kBN, int kStages>
struct Bf16Smem {
  static constexpr int kQTile = HBM * HBK * 2;  // bytes, 1024-aligned like every tile
  static constexpr int kXTile = kBN * HBK * 2;
  static constexpr int kStage = kQTile + kXTile;
  static constexpr int kXParts = HCONSUMERS / kBN;  // consumer threads summing one x row
  static constexpr int kOut = HCONSUMERS / 32 * HROWS * HPITCH * 4;
  static constexpr int kNorms = (2 * HBM + kXParts * kBN) * 4;
  static constexpr int kBytes = 1024 + kStages * kStage + kOut + kNorms + 2 * kStages * 8;
  static_assert(kBytes <= 232448, "one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// TMA: the box at (c0 = column, c1 = row) of map's tensor into dst, 128-byte swizzled,
// completing on bar; rows and columns past the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma operand descriptor: a K-major tile of 128-byte rows in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), 8-row groups 1024
// bytes apart; addr advances 32 bytes per 16-deep step inside the row
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x kN per warpgroup, f32, kN / 2 registers a thread) += a (64 x 16
// bf16) * b (kN x 16 bf16)^T, both K-major in shared memory (kN = 256: the
// n256 design of scripts/torch_flat_variants.py)
template <int kN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  static_assert(kN == 128 || kN == 256, "the two tile widths");
  if constexpr (kN == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
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
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
}

// the sum of squares of a swizzled tile row's logical 16-byte chunks
// [c0, c0 + kChunks), each square exact in f32
template <int kChunks>
__device__ __forceinline__ float row_sq(const uint8_t* tile, int r, int c0) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * 128 + (((c0 + i) ^ (r & 7)) << 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __uint_as_float(w[e] << 16), hi = __uint_as_float(w[e] & 0xFFFF0000u);
      s = fmaf(hi, hi, fmaf(lo, lo, s));
    }
  }
  return s;
}

// The narrow copy path (D % 8 != 0 or a pointer not 16-byte aligned, where TMA
// cannot describe the rows): the copying warpgroup reads rows [row0, row0 +
// rows) x columns [k0, k0 + 64) of src (n_rows x D) 2 bytes at a time and
// writes them in the swizzled layout TMA would; past the tensor, zeros.
__device__ __forceinline__ void narrow_tile(uint8_t* tile, const __nv_bfloat16* __restrict__ src,
                                            int row0, int rows, int n_rows, int D, int k0) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  for (int u = threadIdx.x; u < rows * 8; u += 128) {
    const int r = u / 8, c = u % 8, k = k0 + 8 * c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row0 + r < n_rows) {
      const unsigned short* p = s + (int64_t)(row0 + r) * D + k;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k + e < D) w[e / 2] |= (uint32_t)__ldg(p + e) << (16 * (e % 2));
    }
    *reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block per SM walks (128 q rows x kBN x rows) output tiles; warpgroup 0
// keeps a ring of kStages (q, x) tiles filled, warpgroups 1 and 2 each
// multiply 64 q rows by the x tile, sum the norms from the staged tiles,
// and write finished distances.
template <int kBN, int kStages, int kWait, bool kTma>
__global__ void __launch_bounds__(HTHREADS, 1) flat_dense_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x,
    float* __restrict__ out, int B, int N, int D, int ip) {
  using S = Bf16Smem<kBN, kStages>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  float* stage_out = reinterpret_cast<float*>(smem + kStages * S::kStage);
  float* qn_s = stage_out + S::kOut / 4;  // [2][HBM]: each half of a q row's sum
  float* xn_s = qn_s + 2 * HBM;           // [kXParts][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(xn_s + S::kXParts * kBN);
  uint64_t* empty = full + kStages;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_n * ((B + HBM - 1) / HBM);
  const int KT = (D + HBK - 1) / HBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kTma ? 1 : 128);
      mbar_init(empty + s, HCONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the copying warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (kTma && threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int col0 = (t % tiles_n) * kBN, row0 = (t / tiles_n) * HBM;
      for (int kt = 0; kt < KT; ++kt) {
        uint8_t* qt = smem + stage * S::kStage;
        uint8_t* xt = qt + S::kQTile;
        mbar_wait(empty + stage, phase ^ 1);
        if (kTma) {
          mbar_expect_tx(full + stage, S::kStage);
          tma_load_2d(qt, &qmap, kt * HBK, row0, full + stage);
          tma_load_2d(xt, &xmap, kt * HBK, col0, full + stage);
        } else {
          narrow_tile(qt, q, row0, HBM, B, D, kt * HBK);
          narrow_tile(xt, x, col0, kBN, N, D, kt * HBK);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
          mbar_arrive(full + stage);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = 16 * warp;  // this warp's 16 rows of the tile
  // norms: q row ct % 128 over half ct / 128 of each step's chunks; x row
  // ct % kBN over part ct / kBN
  const int qr = ct % HBM, qh = ct / HBM;
  const int xr = ct % kBN, xh = ct / kBN;
  constexpr int kXChunks = 8 / S::kXParts;
  float* st = stage_out + warp * HROWS * HPITCH;
  float acc[kBN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int col0 = (t % tiles_n) * kBN, row0 = (t / tiles_n) * HBM;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    float qn = 0.f, xn = 0.f;
    int held = -1;  // the stage whose products may still be in flight
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(full + stage, phase);
      const uint8_t* qt = smem + stage * S::kStage;
      const uint8_t* xt = qt + S::kQTile;
      const uint32_t qa = smem_u32(qt) + wg * 64 * 128, xa = smem_u32(xt);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < HBK / 16; ++kk)
        wgmma_bf16<kBN>(acc, sw128_desc(qa + 32 * kk), sw128_desc(xa + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the norms from the staged tiles while the products run
      qn += row_sq<4>(qt, qr, 4 * qh);
      xn += row_sq<kXChunks>(xt, xr, kXChunks * xh);
      asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kWait) : "memory");
      const int done = kWait == 0 ? stage : held;
      held = stage;
      if (done >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + done);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (kWait != 0 && held >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + held);
    }
    qn_s[qh * HBM + qr] = qn;
    xn_s[xh * kBN + xr] = xn;
    asm volatile("bar.sync 1, %0;\n" ::"n"(HCONSUMERS) : "memory");  // the norms are in

    // acc[4j + 2h + c]: row wr + g + 8h, column 8j + 2 t4 + c. A warp stages
    // 16 x 32 of them, then writes 4 rows of 128 bytes a store, 16 bytes a lane.
    const bool vec = N % 4 == 0;
#pragma unroll
    for (int cc = 0; cc < kBN / HCOLS; ++cc) {
#pragma unroll
      for (int jj = 0; jj < HCOLS / 8; ++jj) {
        const int j = HCOLS / 8 * cc + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(st + (g + 8 * h) * HPITCH + 8 * jj + 2 * t4) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < HROWS / 4; ++i) {
        const int r = 4 * i + lane / 8, c4 = 4 * (lane % 8);
        const int row = row0 + wr + r, lc = HCOLS * cc + c4, col = col0 + lc;
        if (row < B && col < N) {
          float4 v = *reinterpret_cast<const float4*>(st + r * HPITCH + c4);
          if (ip) {
            v = make_float4(-v.x, -v.y, -v.z, -v.w);
          } else {
            const float qq = qn_s[wr + r] + qn_s[HBM + wr + r];
            float4 xx = *reinterpret_cast<const float4*>(xn_s + lc);
            if (S::kXParts == 2) {
              const float4 x2 = *reinterpret_cast<const float4*>(xn_s + kBN + lc);
              xx = make_float4(xx.x + x2.x, xx.y + x2.y, xx.z + x2.z, xx.w + x2.w);
            }
            v = make_float4(fmaxf(qq + xx.x - 2.0f * v.x, 0.f), fmaxf(qq + xx.y - 2.0f * v.y, 0.f),
                            fmaxf(qq + xx.z - 2.0f * v.z, 0.f), fmaxf(qq + xx.w - 2.0f * v.w, 0.f));
          }
          float* o = out + (int64_t)row * N + col;
          if (vec) {
            *reinterpret_cast<float4*>(o) = v;
          } else {
            const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (col + k < N) o[k] = e[k];
          }
        }
      }
      __syncwarp();
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(HCONSUMERS) : "memory");  // the norms are read
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// rows x D bf16 at ptr, read in boxes of 64 columns x box_rows rows, 128-byte swizzle
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)HBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch_dense_bf16(const void* q, const void* x, float* out, int B, int N, int D, int ip,
                      cudaStream_t stream) {
  constexpr int kBN = kBf16TileN, kStages = kBf16Stages, kWait = kBf16WaitDepth;
  const bool tma =
      D > 0 && D % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16) == 0;
  CUtensorMap qmap, xmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&xmap, 0, sizeof(xmap));
  if (tma && !(bf16_map(&qmap, q, B, D, HBM) && bf16_map(&xmap, x, N, D, kBN)))
    return (int)cudaErrorNotSupported;  // the caller raises: no other route is taken
  void (*kernel)(const CUtensorMap, const CUtensorMap, const __nv_bfloat16*, const __nv_bfloat16*,
                 float*, int, int, int, int) =
      tma ? &flat_dense_bf16_kernel<kBN, kStages, kWait, true>
          : &flat_dense_bf16_kernel<kBN, kStages, kWait, false>;
  const int bytes = Bf16Smem<kBN, kStages>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles = ((N + kBN - 1) / kBN) * ((B + HBM - 1) / HBM);
  kernel<<<tiles < sms ? tiles : sms, HTHREADS, bytes, stream>>>(
      qmap, xmap, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), out,
      B, N, D, ip);
  return (int)cudaGetLastError();
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
  if (is_bf16) return launch_dense_bf16(q, x, out, B, N, D, metric_ip, stream);
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
