// Masked sparse-head kernels for Hopper (sm_90a): TMA ring + wgmma.
//
// Replaces the Pallas kernels of osr_tpu/ops/pallas/head.py, for both head
// dtypes:
//   K1    _head_kernel               int8 head   (scores only; the int8
//                                                 path below the
//                                                 block-prune floor)
//   K2    _head_blockmax_kernel      int8 head   (scores + per-128-row
//                                                 block maxima)
//   K3    _head_blockmax_kernel_i4   int4 head   (the same)
//   K4    _make_blocktopm_kernel + _blocktopm_epilogue, int8 and int4 heads
//         (per-128-row-block top-m (value, row); the scores are never
//         written)
// osr_tpu has no int4 scores-only kernel, so K1 is instantiated for int8
// only.
//
// What it computes, for a query batch q whose per-column head scales are
// already folded in and rounded to bf16 by the wrapper (ops/head.py):
//   s[b, r]    = valid[r] ? sum_f q[b, f] * code[r, f] : -inf   (f32 accum)
//   out[b, r]  = s[b, r]                                      (K1, K2, K3)
//   bmax[g, b] = max over r in [128 g, 128 g + 128) of s[b, r] (K2, K3)
//   vals[b, g, :m], rows[b, g, :m] = the m largest s[b, r] of block g in
//     descending order, ties to the lowest row (K4): a stable descending
//     sort's first m
// with rows r >= R counted as -inf. The heads:
// - int8: (R, HW) signed codes, column f is byte f. q is (B, HWq) bf16,
//   HWq = HW rounded up to 128, its columns permuted within each 128 by
//   the wrapper into the order the kernel's fragments read the head bytes
//   (ops/head.py:i8_kernel_query; see the decode below);
// - int4: (R, HW) uint8 block-packed, the low nibble of byte c is column
//   c, the high nibble column HW + c (codes 0..15). q is (B, 2 HW) bf16.
// Codes are exact in bf16, so each product is exact and only the f32
// summation order differs from the plain PyTorch version. The kernels of
// one dtype share one main loop, so K1's scores are bit for bit K2's, and
// K4's values are bit for bit the per-block top-m of K2's (K3's) scores.
//
// Bound on an H100: the tensor cores. At the FiQA bench shape (B=3,328,
// R=57,728, F=2,048): 7.87e11 FLOP against 989 TFLOP/s bf16 is 0.7957 ms;
// the bytes (head, queries, the (B, R) f32 scores and the maxima) take
// 0.27 ms at 3.35 TB/s. K4-i8 per 1M-corpus chunk (B=2,048, R=500,096):
// 4.24 ms against 0.46 ms of bytes.
//
// Design. One thread block owns a (128 queries x 128 head rows) output
// tile, so its rows are exactly one 128-row pruning block, and 288 threads:
// two consumer warpgroups (64 head rows each) and one producer warp. The
// dtype changes only the stage geometry and the decode.
// - TMA ring. One producer thread keeps kStages stages in flight with
//   cp.async.bulk.tensor.2d, each stage guarded by a full and an empty
//   mbarrier. A stage covers 128 logical columns: two query tiles (128
//   queries x 64 bf16 each, 128B swizzle) and the raw head tile.
//   - int8: 128 bytes a row (128 rows x 128 B, 128B swizzle); the query
//     tiles are columns [c, c + 64) and [c + 64, c + 128). 48 KB a stage.
//   - int4: 64 bytes a row (64B swizzle); the query tiles are the low
//     nibbles' columns [c, c + 64) and the high nibbles' [HW + c, HW + c +
//     64). 40 KB a stage.
//   Ragged edges come from TMA's zero fill: B, R and HW need not be
//   multiples of the tile. Head bytes past HW read as 0, so their codes
//   contribute 0 whatever query column they meet.
// - Decode into registers. Each consumer thread reads its own head bytes
//   from the raw tile and turns them into the bf16 A fragments of its
//   warpgroup's wgmma, exactly. A shared-memory decode (a bf16 tile read as
//   the B operand by both warpgroups) would move more shared-memory bytes
//   per stage than the SM serves in the stage's tensor-core time (PERF.md,
//   Findings). The fragments are double buffered across stages: stage
//   k + 1 decodes while stage k multiplies.
//   - int8: one 16-byte shared load gives a thread 4 codes of each of 4
//     k-steps; the queries' column order (above) matches. Each byte b is
//     (0x4300 | (b & 0x7f)) - (0x4300 | (b & 0x80)) in bf16: 128 + low
//     bits, minus 128 or 256. Exact for every code.
//   - int4: two 16-bit loads give 8 codes; 0x4300 | nibble, minus 128.
// - wgmma. Each consumer warpgroup runs m64n128k16 bf16 -> f32 with A (its
//   64 head rows) from registers and B (the 128 queries) from shared
//   memory, K-major with 128B swizzle: 4 k-steps on each query tile per
//   stage. wait_group 1 keeps one stage's products in flight while the
//   next decodes; then the previous stage is released.
// - Epilogues. The accumulators (head row 64 wg + 16 w + g (+ 8), query
//   8 j + 2 t + e for lane (g, t) of warp w, j < 16, e < 2) go to a
//   (128 queries x 128 rows) f32 tile in the freed ring. K1/K2/K3 then
//   write one query's 128 scores per warp instruction (512 contiguous
//   bytes); K2/K3 reduce their maximum over the warp. K4 gives each quad of
//   lanes one
//   query (lane t takes rows 8 j + 2 t + e) and runs m rounds of a
//   32-value scan (a 32-bit taken mask) and two xor shuffles keeping the
//   larger value, else the lower row.
// Block order walks the query tiles of one head row tile first, so the
// head tile is read from HBM about once and re-read from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileM = 128;        // queries per block
constexpr int kTileN = 128;        // head rows per block: one pruning block
constexpr int kQBoxCols = 64;      // bf16 query columns per query tile
constexpr int kStages = 4;         // TMA ring depth
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxM = 16;  // K4's largest m (ops/head.py:BLOCKTOPM_MAX_M)

constexpr int kEpiBlockMax = 0;  // K2/K3: masked scores + block maxima
constexpr int kEpiTopM = 1;      // K4: per-block top-m (value, row)
constexpr int kEpiScores = 2;    // K1: masked scores only

// Shared memory, from a 1024-byte aligned base (128B swizzle repeats every
// 8 rows of 128 bytes). Stage s: the two query tiles, then the raw head
// tile. After the main loop the epilogue reuses the ring as a (128 queries
// x kTileLd) f32 score tile; its padded rows keep the quads' reads free of
// bank conflicts.
constexpr int kQTileBytes = kTileM * kQBoxCols * 2;  // 16 KB
constexpr int kTileLd = kTileN + 4;                  // f32 per row

// Stage geometry of one head dtype.
template <bool kInt8>
struct Geometry {
  static constexpr int kRowBytes = kInt8 ? 128 : 64;  // head bytes a row
  static constexpr int kRawBytes = kTileN * kRowBytes;
  static constexpr int kStageBytes = 2 * kQTileBytes + kRawBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static_assert(kTileM * kTileLd * 4 <= kStages * kStageBytes,
                "the score tile must fit in the ring");
};

// ---- wgmma ----------------------------------------------------------------

// d (64 x 128, f32, this thread's 64 values) = a (64 x 16, this thread's
// fragment in registers) * b (16 x 128, shared memory) + (accumulate ? d :
// 0).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---- decode -----------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four packed bytes -> their low nibbles (lo[0..1]) and high nibbles
// (hi[0..1]) as bf16 pairs, in byte order: 0x4300 | code is bf16 128 +
// code, and subtracting 128 is exact.
__device__ __forceinline__ void nibbles_to_bf16(uint32_t x, uint32_t* lo,
                                                uint32_t* hi) {
  const uint32_t k128 = 0x43004300u;
  const uint32_t l = x & 0x0F0F0F0Fu;
  const uint32_t h = (x >> 4) & 0x0F0F0F0Fu;
  lo[0] = bf16x2_sub(__byte_perm(l, 0x43434343u, 0x4140), k128);
  lo[1] = bf16x2_sub(__byte_perm(l, 0x43434343u, 0x4342), k128);
  hi[0] = bf16x2_sub(__byte_perm(h, 0x43434343u, 0x4140), k128);
  hi[1] = bf16x2_sub(__byte_perm(h, 0x43434343u, 0x4342), k128);
}

// Four signed bytes -> bf16 pairs (bytes 0, 1) and (bytes 2, 3): 0x4300 |
// (b & 0x7f) is 128 + the low seven bits, 0x4300 | (b & 0x80) is 128 or
// 256 (the sign bit lands on the exponent's lowest bit), and their
// difference is the two's-complement code, exact in bf16.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t x, uint32_t* lo,
                                               uint32_t* hi) {
  const uint32_t mag = x & 0x7F7F7F7Fu;
  const uint32_t sgn = x & 0x80808080u;
  *lo = bf16x2_sub(__byte_perm(mag, 0x43434343u, 0x4140),
                   __byte_perm(sgn, 0x43434343u, 0x4140));
  *hi = bf16x2_sub(__byte_perm(mag, 0x43434343u, 0x4342),
                   __byte_perm(sgn, 0x43434343u, 0x4342));
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// This thread's A fragments of one stage, decoded from the raw tile. For
// the warp's rows row0 = 64 wg + 16 w + g and row0 + 8 and k-step kk, the
// wgmma A layout wants k slots 2 t, 2 t + 1 in regs 0 (row0) and 1 (row0 +
// 8), and slots 2 t + 8, 2 t + 9 in regs 2 and 3.
//
// int4 (rows of 64 bytes, 64B swizzle: 16-byte chunk c of row r sits at
// chunk c ^ ((r >> 1) & 3)): bytes 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of chunk
// kk; their low nibbles are k-step kk (a[kk]), their high nibbles k-step
// 4 + kk (a[4 + kk], the columns HW + ...).
//
// int8 (rows of 128 bytes, 128B swizzle: chunk c of row r sits at chunk
// c ^ (r & 7)): the thread loads chunks 2 t + G (G < 2) whole; word j of
// chunk 2 t + G is k-step 4 G + j, its bytes i < 4 the slots 2 t + (i & 1)
// + 8 (i >> 1). So k position 16 kk + slot of a stage holds the head's
// column 16 (2 t + G) + 4 j + i, and the wrapper orders the queries'
// columns the same way. A quarter warp (rows g, g ^ 1; t < 4) reads 8
// distinct chunks: no bank conflict.
template <bool kInt8>
__device__ __forceinline__ void decode_fragments(uint32_t raw, int row0,
                                                 int t, uint32_t (&a)[8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const uint32_t row = raw + r * Geometry<kInt8>::kRowBytes;
    if constexpr (kInt8) {
#pragma unroll
      for (int G = 0; G < 2; ++G) {
        const uint4 v = lds_v4(row + (((2 * t + G) ^ (r & 7)) << 4));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int8x4_to_bf16(w[j], &a[4 * G + j][h], &a[4 * G + j][2 + h]);
        }
      }
    } else {
      const int sw = (r >> 1) & 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t chunk = row + 2 * t + ((kk ^ sw) << 4);
        const uint32_t x =
            __byte_perm(lds_u16(chunk), lds_u16(chunk + 8), 0x5410);
        uint32_t lo[2], hi[2];
        nibbles_to_bf16(x, lo, hi);
        a[kk][h] = lo[0];
        a[kk][2 + h] = lo[1];
        a[4 + kk][h] = hi[0];
        a[4 + kk][2 + h] = hi[1];
      }
    }
  }
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- the kernel -------------------------------------------------------------

// Stage k of a consumer warpgroup's main loop: wait for the stage, decode
// its head bytes into the fragment buffer a (free: its last products were
// retired by the previous stage's wait), issue the stage's 8 products,
// then retire stage k - 1's products and release its stage to the
// producer.
template <bool kInt8>
__device__ __forceinline__ void consume_stage(
    int k, uint8_t* smem, uint64_t* full_bar, uint64_t* empty_bar, int row0,
    int lane, uint32_t (&a)[8][4], float* acc) {
  using Geo = Geometry<kInt8>;
  const int s = k % kStages;
  uint8_t* stage = smem + s * Geo::kStageBytes;
  mbar_wait(&full_bar[s], (k / kStages) & 1);
  decode_fragments<kInt8>(smem_u32(stage + 2 * kQTileBytes), row0, lane & 3,
                          a);
  const uint64_t b_lo = sw128_desc(stage);
  const uint64_t b_hi = sw128_desc(stage + kQTileBytes);
  keep_live(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_rs(acc, a[kk], b_lo + 2 * kk, k > 0 || kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_rs(acc, a[4 + kk], b_hi + 2 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (k > 0 && lane == 0) mbar_arrive(&empty_bar[(k - 1) % kStages]);
}

// tq:    int8: (B, HWq) bf16 queries in the kernel's column order; int4:
//        (B, 2 HW) bf16; box 64 columns x 128 rows, 128B swizzle
// th:    (R, HW) head bytes; box kRowBytes x 128 rows
// valid: (R,) bool
// K1:    out (B, R) f32
// K2/K3: out (B, R) f32;  aux (G, B) f32 block maxima, G = ceil(R / 128)
// K4:    out (B, G, m) f32 values;  rows (B, G, m) int32;  1 <= m <= kMaxM
template <bool kInt8, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    head_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap th,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, float* __restrict__ aux,
                      int32_t* __restrict__ rows, int B, int R, int HW,
                      int n_qtiles, int m) {
  using Geo = Geometry<kInt8>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // Offset, not cast, to the aligned base: the compiler then still knows
  // the pointer is shared memory.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int qt = blockIdx.x % n_qtiles;
  const int rt = blockIdx.x / n_qtiles;
  const int m0 = qt * kTileM;
  const int n0 = rt * kTileN;
  const int n_chunks = (HW + Geo::kRowBytes - 1) / Geo::kRowBytes;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if (tid == kConsumers) {
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty_bar[s], ((k / kStages) - 1) & 1);
        mbar_expect_tx(&full_bar[s], Geo::kStageBytes);
        uint8_t* stage = smem + s * Geo::kStageBytes;
        const int c = k * Geo::kRowBytes;
        tma_load_2d(stage, &tq, &full_bar[s], c, m0);
        tma_load_2d(stage + kQTileBytes, &tq, &full_bar[s],
                    kInt8 ? c + kQBoxCols : HW + c, m0);
        tma_load_2d(stage + 2 * kQTileBytes, &th, &full_bar[s], c, n0);
      }
    }
    return;
  }

  // Consumers. The accumulators are first written by the first product
  // (scale-d = 0), never by other instructions: those would make ptxas
  // serialize the asynchronous wgmma pipeline.
  const int wg = tid >> 7;  // warpgroup: head rows [64 wg, 64 wg + 64)
  const int w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 64 * wg + 16 * w + g;  // this thread's A rows: +0, +8
  float acc[64];
  uint32_t frag[2][8][4];  // A fragments, double buffered across stages

  int k = 0;
  for (; k + 1 < n_chunks; k += 2) {  // two stages, one per fragment buffer
    consume_stage<kInt8>(k, smem, full_bar, empty_bar, row0, lane, frag[0],
                         acc);
    consume_stage<kInt8>(k + 1, smem, full_bar, empty_bar, row0, lane,
                         frag[1], acc);
  }
  if (k < n_chunks) {
    consume_stage<kInt8>(k, smem, full_bar, empty_bar, row0, lane, frag[0],
                         acc);
  }
  wgmma_wait<0>();

  // Epilogue. Both warpgroups' products are done, so the ring is free:
  // acc[4 j + 2 h + e] (head row 64 wg + 16 w + g + 8 h, query 8 j + 2 t +
  // e) goes to tile[query][row].
  consumer_barrier();
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        tile[(8 * j + 2 * t + e) * kTileLd + 64 * wg + 16 * w + g + 8 * h] =
            acc[4 * j + 2 * h + e];
      }
  consumer_barrier();

  if constexpr (kEpi == kEpiBlockMax || kEpi == kEpiScores) {
    // One query (a tile row) per warp instruction: lane l takes head rows
    // n0 + 4 l .. + 3, masks them, stores them as one float4 (the warp
    // writes the row's 512 contiguous bytes) and, for the block maxima,
    // reduces their maximum over the warp.
    const int n = n0 + 4 * lane;
    const bool vec = (R & 3) == 0 && n + 3 < R &&
                     (reinterpret_cast<uintptr_t>(valid + n) & 3) == 0;
    uint32_t ok = 0;  // byte i: row n + i is valid
    if (vec) {
      ok = *reinterpret_cast<const uint32_t*>(valid + n);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n + i < R && valid[n + i]) ok |= 1u << (8 * i);
      }
    }
    const int warp = tid >> 5;
#pragma unroll 4
    for (int i = 0; i < kTileM / 8; ++i) {
      const int ql = warp + 8 * i;
      const int mq = m0 + ql;
      if (mq >= B) break;
      float4 x =
          *reinterpret_cast<const float4*>(&tile[ql * kTileLd + 4 * lane]);
      x.x = (ok & 0xffu) ? x.x : -CUDART_INF_F;
      x.y = (ok & 0xff00u) ? x.y : -CUDART_INF_F;
      x.z = (ok & 0xff0000u) ? x.z : -CUDART_INF_F;
      x.w = (ok & 0xff000000u) ? x.w : -CUDART_INF_F;
      float* dst = out + static_cast<size_t>(mq) * R + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = x;
      } else {
        if (n < R) dst[0] = x.x;
        if (n + 1 < R) dst[1] = x.y;
        if (n + 2 < R) dst[2] = x.z;
        if (n + 3 < R) dst[3] = x.w;
      }
      if constexpr (kEpi == kEpiBlockMax) {
        float rmax = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
#pragma unroll
        for (int sh = 16; sh >= 1; sh >>= 1) {
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, sh));
        }
        if (lane == 0) aux[static_cast<size_t>(rt) * B + mq] = rmax;
      }
    }
  } else {
    // Top-m: the quad of lane (g, t) takes queries 64 wg + 16 w + g + 8 h
    // (h < 2), lane t rows 8 j + 2 t + e of each. m rounds: each lane
    // offers its largest free score (the lowest row among equals), two xor
    // shuffles keep the larger value or, on equal values, the lower row,
    // and the owner marks it taken. A free -inf still ranks, so the rows of
    // -inf values follow row order.
    uint32_t ok = 0;  // bit 2 j + e: head row 8 j + 2 t + e is valid
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t + e;
        if (n < R && valid[n] != 0) ok |= 1u << (2 * j + e);
      }
    const int G = (R + kTileN - 1) / kTileN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = 64 * wg + 16 * w + g + 8 * h;
      const int mq = m0 + ql;
      float v[32];  // this lane's 32 scores of query mq, in row order
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 p = *reinterpret_cast<const float2*>(
            &tile[ql * kTileLd + 8 * j + 2 * t]);
        v[2 * j] = (ok >> (2 * j)) & 1u ? p.x : -CUDART_INF_F;
        v[2 * j + 1] = (ok >> (2 * j + 1)) & 1u ? p.y : -CUDART_INF_F;
      }
      const size_t base = (static_cast<size_t>(mq) * G + rt) * m;
      uint32_t taken = 0;
      for (int r = 0; r < m; ++r) {
        float best = -CUDART_INF_F;
        int best_x = -1;
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          if (!((taken >> x) & 1u) && (best_x < 0 || v[x] > best)) {
            best = v[x];
            best_x = x;
          }
        }
        int best_row = 8 * (best_x >> 1) + 2 * t + (best_x & 1);
        const int mine = best_row;
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, sh);
          const int orow = __shfl_xor_sync(0xffffffffu, best_row, sh);
          if (ov > best || (ov == best && orow < best_row)) {
            best = ov;
            best_row = orow;
          }
        }
        if (best_row == mine) taken |= 1u << best_x;
        if (t == 0 && mq < B) {
          out[base + r] = best;
          rows[base + r] = n0 + best_row;
        }
      }
    }
  }
}

template <bool kInt8, int kEpi>
int launch(const void* q, const void* head, const void* valid, void* out,
           void* aux, void* rows, int B, int R, int HW, int m,
           cudaStream_t stream) {
  using Geo = Geometry<kInt8>;
  if (B < 0 || R < 0 || HW <= 0 || HW % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qtiles = (B + kTileM - 1) / kTileM;
  const int n_rtiles = (R + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(n_qtiles) * n_rtiles;
  if (blocks == 0) return 0;
  // TMA takes 16-byte aligned bases; HW % 16 == 0 aligns every row.
  if (blocks > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(head)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // int8: the queries are padded to whole stages of 128 columns.
  const int q_cols = kInt8 ? (HW + 127) / 128 * 128 : 2 * HW;
  CUtensorMap tq, th;
  if (!encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, q_cols, B,
                 kQBoxCols, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&th, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, head, HW, R,
                 Geo::kRowBytes,
                 kInt8 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      head_wgmma_kernel<kInt8, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  head_wgmma_kernel<kInt8, kEpi>
      <<<static_cast<unsigned>(blocks), kThreads, Geo::kSmemBytes, stream>>>(
          tq, th, static_cast<const uint8_t*>(valid),
          static_cast<float*>(out), static_cast<float*>(aux),
          static_cast<int32_t*>(rows), B, R, HW, n_qtiles, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 on a successful launch.
// q is the wrapper's bf16 query operand (see the top of this file), head
// the (R, HW) head bytes, valid (R,) bool.

// K1: (B, R) f32 masked scores of an int8 head; bit for bit K2's scores.
extern "C" int osr_head_i8_scores(const void* q, const void* head,
                                  const void* valid, void* out, int B, int R,
                                  int HW, void* stream) {
  return launch<true, kEpiScores>(q, head, valid, out, nullptr, nullptr, B,
                                  R, HW, 0, static_cast<cudaStream_t>(stream));
}

// K2: (B, R) f32 masked scores and (G, B) f32 block maxima of an int8
// head.
extern "C" int osr_head_i8_blockmax(const void* q, const void* head,
                                    const void* valid, void* out, void* bmax,
                                    int B, int R, int HW, void* stream) {
  return launch<true, kEpiBlockMax>(q, head, valid, out, bmax, nullptr, B, R,
                                    HW, 0, static_cast<cudaStream_t>(stream));
}

// K4-i8: per-128-row-block top-m values (B, G, m) f32 and rows (B, G, m)
// int32 of an int8 head.
extern "C" int osr_head_i8_blocktopm(const void* q, const void* head,
                                     const void* valid, void* vals,
                                     void* rows, int B, int R, int HW, int m,
                                     void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, kEpiTopM>(q, head, valid, vals, nullptr, rows, B, R,
                                HW, m, static_cast<cudaStream_t>(stream));
}

// K3: as K2, of a block-packed int4 head.
extern "C" int osr_head_i4_blockmax(const void* q, const void* head,
                                    const void* valid, void* out, void* bmax,
                                    int B, int R, int HW, void* stream) {
  return launch<false, kEpiBlockMax>(q, head, valid, out, bmax, nullptr, B,
                                     R, HW, 0,
                                     static_cast<cudaStream_t>(stream));
}

// K4-i4: as K4-i8, of a block-packed int4 head.
extern "C" int osr_head_i4_blocktopm(const void* q, const void* head,
                                     const void* valid, void* vals,
                                     void* rows, int B, int R, int HW, int m,
                                     void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, kEpiTopM>(q, head, valid, vals, nullptr, rows, B, R,
                                 HW, m, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a launch requests, in bytes, for the int8 (int8 =
// 1) or the int4 kernels.
extern "C" int osr_head_wgmma_smem_bytes(int int8) {
  return int8 ? Geometry<true>::kSmemBytes : Geometry<false>::kSmemBytes;
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
