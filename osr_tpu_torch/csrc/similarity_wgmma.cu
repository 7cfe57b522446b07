// Dense similarity kernels for Hopper (sm_90a): K5 (int8 corpus) and K6
// (int4 corpus), one persistent TMA + integer wgmma kernel template whose
// output store overlaps the next tile.
//
// Replaces the Pallas kernels of osr_tpu/ops/pallas/matmul.py:
//   K5  _kernel     (:24), launched via int8_similarity_pallas
//   K6  _kernel_i4  (:36), launched via int4_similarity_pallas
//
// What they compute, for int8 queries q (B, D) with scales qs (B,) and a
// corpus of N rows with scales ds (N,):
//   acc[b, n] = sum_c q[b, c] * code[n, c]             (exact, in int32)
//   out[b, n] = (float(acc[b, n]) * qs[b]) * ds[n]     (two f32 multiplies)
// K5's corpus holds the int8 codes, (N, D). K6's holds D/2 packed bytes a
// row: byte c's low nibble is column c and its high nibble column c + D/2,
// each a two's-complement code ((v & 0xF) ^ 8) - 8. The integer sum is
// exact, the int32 -> f32 conversion rounds to nearest and the multiplies
// keep their order with no FMA, so each kernel equals its plain PyTorch
// version (ops/matmul.py:int8_similarity_plain, int4_similarity_plain) bit
// for bit.
//
// Operands, built by the wrappers (ops/matmul.py:int8_kernel_operands,
// int4_kernel_operands), W bytes a row with W a multiple of 16 (TMA's
// stride unit; a narrower row is zero-padded, and zeros add nothing):
// - K5: queries (B, W) and corpus (N, W) int8, W = D rounded up to 16.
// - K6: corpus (N, W) uint8, W = D/2 rounded up to 16 (zero bytes decode
//   to 0), and queries (B, 2 W) int8: columns [0, D/2) of q at 0 and
//   [D/2, D) at W, zeros elsewhere.
// At W = D (K5) or D/2 (K6) the operands are the inputs themselves.
//
// Bound on an H100. At the dense path's shape (B = 1,024, N = 1,000,000,
// D = 768) the products are 1.57e15 int8 operations, 0.79 ms at 1,979
// TOP/s; the bytes are the corpus (0.77 GB int8, 0.38 GB int4) and the
// 4.10 GB (B, N) f32 output: 1.45 ms (K5) and 1.34 ms (K6) at 3.35 TB/s.
// So the output write bounds both: each SM has to store a 64 KB tile every
// ~2.6 us (473.5 tiles per SM), while a tile's tensor math takes ~1.7 us.
// The design keeps the store stream busy.
//
// Design. One block per SM (the grid is the SM count), 288 threads: two
// consumer warpgroups (64 docs each) and one producer warp. A block walks
// (128 queries x 128 docs) output tiles tile = blockIdx.x + i * gridDim.x,
// the query tiles of one corpus tile first, so the corpus is read from HBM
// about once and the queries stay in L2.
// - TMA ring. One producer thread keeps kStages stages in flight with
//   cp.async.bulk.tensor.2d, each guarded by a full and an empty mbarrier;
//   it runs on into the next tile's stages while the consumers are in an
//   epilogue. B, N and W off the tiles come from TMA's zero fill.
//   - K5: a stage is 128 columns of the 128 queries and of the 128 corpus
//     rows, 16 KB each, 128B swizzle: 32 KB, 5 stages.
//   - K6: a stage covers 128 logical columns: 64 packed bytes of the 128
//     corpus rows (8 KB, raw) and two query tiles of 128 queries x 64
//     bytes, columns [c, c + 64) and [W + c, W + c + 64): 24 KB, 64B
//     swizzle throughout, 6 stages. A low query tile that runs into the
//     high half meets zero-filled corpus bytes there.
// - wgmma m64n128k32 s8 x s8 -> s32, the corpus rows as A (M = docs) and
//   the queries as B, both K-major, as TMA wrote them.
//   - K5: A and B both from shared memory (the "ss" form; 8-bit wgmma
//     takes K-major operands only), 4 k-steps a stage. No fragment
//     registers.
//   - K6: A in registers, decoded from the raw tile. One 32-bit load of 4
//     packed bytes gives a thread 4 low-nibble codes (a register of a low
//     k-step) and 4 high-nibble codes (the same register of the matching
//     high k-step): 8 loads a stage, conflict free under the swizzle. Each
//     code becomes v | (v & 8 ? 0xF0 : 0), byte for byte, in three integer
//     ops per 4 codes. The fragments are double buffered across stages and
//     pinned before wgmma.fence, or ptxas serializes the pipeline. 4
//     k-steps a stage (two low, two high).
//   wait_group 1 keeps one stage's products in flight while the next is
//   issued; each tile's first product has scale-d = 0, and no other
//   instruction writes the accumulators.
// - Epilogue. Each thread's scale (of a query or a doc of the tile) is
//   loaded into a register when the tile's main loop starts, so that its
//   latency hides there. The accumulators (doc 64 wg + 16 w + g (+ 8),
//   query 8 j + 2 t + e) are converted and scaled in registers and
//   written, transposed, to a dedicated (128 queries x 128 docs) f32
//   staging tile: four boxes of 32 docs, 128B swizzle, so the scalar
//   writes are conflict free. One thread then issues four TMA stores
//   (cp.async.bulk.tensor, one bulk group) and the block goes on to the
//   next tile; before the staging tile is written again it waits only for
//   the previous store's read of it (cp.async.bulk.wait_group.read), so a
//   tile's store overlaps the next tile's main loop. TMA's store clips rows
//   past B and columns past N. An output whose row stride is not a
//   multiple of 16 bytes (N % 4 != 0) has no tensor map: there (kTmaStore
//   false) the warps store the staging tile with guarded plain stores, one
//   query row of 128 bytes a box.
// - Block maxima (the *_blockmax entry points). One tile holds one
//   128-doc block of each of its 128 queries, so the epilogue can also
//   write maxima[n0 / 128, b], the largest score of query b over the
//   tile's real docs. The kernel tests the maxima pointer once, before
//   its consumers' first tile, and runs one of two compiled walks
//   (consume_tiles<..., kMaxima>): a null pointer (the plain entry
//   points') runs the epilogue above and nothing of the reduction. Tested
//   per tile instead, the branch cost the scores-only launch 1% (10 us at
//   B = 1, N = 2.68M).
//   - Values: the f32 scores the tile stores, reduced with NaN kept
//     (max.NaN), so they equal topk.block_max of the kernel's own scores
//     bit for bit. A doc >= N counts as -inf, never as the 0 that zero
//     fill and its zero scale give it; rows >= B are not written.
//   - Registers: a thread takes the larger of its two docs for each of
//     its 32 queries (bm[2 j + e]); three xor-shuffle rounds of lanes 16,
//     8 and 4 apart, each handing over half of what is left (28 shuffles),
//     leave lane (g, t) the warp's maxima of queries 16 g + 8 (i >> 1) + 2
//     t + (i & 1), i < 4.
//   - The 8 warps merge them by shared atomicMax on an int key whose
//     order is the float's: 128 slots, 512 bytes (a 4 KB array a warp
//     does not fit beside K5's ring and staging), swizzled so that each
//     round of a warp's atomics hits 32 banks. Thread q resets slot q
//     before the epilogue's first barrier and reads it after the second,
//     once the tile's TMA store is issued: no wait is added to the store,
//     which still overlaps the next tile's main loop.
//   - One query tile (B <= 128) leaves each block a long walk of doc tiles
//     whose epilogues hold up the next tile's loads (the ring holds 5 of a
//     tile's 6 stages at D = 768), so there the reduction's latency shows:
//     64 us of K5's 0.96 ms at B = 1, N = 2.68M, more than the block_max
//     pass it saves. The dense step therefore asks for the maxima only
//     from a batch size up (retrieval/engine.py:FUSED_MAXIMA_MIN_ROWS).
//   - Layout (G, B), G = ceil(N / 128), as K2 writes its maxima: a tile's
//     128 values are 512 contiguous bytes. Written (B, G), the layout the
//     selection sorts, each value went to a row of its own, and those
//     scattered stores cost K5 about 1 ms of 9.7 at B = 1,024, N = 2.68M;
//     the wrapper returns the (B, G) view.
//   - ptxas (sm_90a, CUDA 12.8): K5 168 registers (96 before the maxima
//     path), K6 168 (151 before): ptxas's cap for 288 threads, no spills.
// Shared memory: the ring (K5 160 KB, K6 144 KB) + staging (64 KB) + 1 KB
// alignment, and 1.6 KB of static arrays (barriers, scales, the maxima's
// slots): K5 232,016 of the 232,448 bytes a block may have, K6 215,648.
// Measured on an H100 and not taken (PERF.md, Findings):
// query tiles kept in shared memory while a block walks the corpus (a
// third (K6) or half (K5) of the L2 reads, but slower: the corpus ring
// left beside them is too shallow), the two warpgroups taking alternate
// 64-doc halves in turn (slower: one warpgroup alone issues its dependent
// products at well under the tensor rate), two accumulator sets per
// warpgroup for K6 (ptxas caps a block of this size at 168 registers,
// then spills and serializes), K5 with K6's 64-byte stages (slower) or
// with 256-query tiles (m64n256k32: a quarter fewer L2 reads, no faster),
// and K5 as clusters of two blocks that multicast each query stage to both
// (half the query reads, but much slower).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTileM = 128;       // queries per tile
constexpr int kTileN = 128;       // docs per tile
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
// The staging tile: four boxes of (128 queries x 32 docs) f32, 128-byte
// rows, 128B swizzle.
constexpr int kOutBoxCols = 32;
constexpr int kOutBoxBytes = kTileM * kOutBoxCols * 4;
constexpr int kStagingBytes = (kTileN / kOutBoxCols) * kOutBoxBytes;

// Stage geometry of one corpus dtype. Stage s, from a 1024-byte aligned
// base: 128-row boxes of kChunkBytes a row. K6: the low and the high query
// box, then the raw corpus box (64B swizzle); K5: the query box, then the
// corpus box (128B swizzle).
template <bool kInt4>
struct Geometry {
  static constexpr int kChunkBytes = kInt4 ? 64 : 128;
  static constexpr int kBoxBytes = kTileM * kChunkBytes;
  static constexpr int kStageBytes = (kInt4 ? 3 : 2) * kBoxBytes;
  static constexpr int kStages = kInt4 ? 6 : 5;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kStagingBytes + 1024;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kInt4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};

// d (64 x 128, s32, this thread's 64 values) = a (64 x 32 s8, this
// thread's fragment in registers) * b (32 x 128 s8, shared memory) +
// (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int* d,
                                                       const uint32_t* a,
                                                       uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The same product with a (64 x 32 s8) from shared memory too (K5).
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int* d, uint64_t da,
                                                       uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- K6's decode ------------------------------------------------------------

// Four packed bytes -> the signed codes of their low nibbles (*lo) and of
// their high nibbles (*hi), byte for byte: nibble v becomes v | (v & 8 ?
// 0xF0 : 0), which is ((v & 0xF) ^ 8) - 8 as a two's-complement byte.
// (n & 0x08080808) * 0x1E puts 0xF0 in each byte whose nibble has its sign
// bit set, with no carry into the next byte.
__device__ __forceinline__ void nibbles_to_s8(uint32_t x, uint32_t* lo,
                                              uint32_t* hi) {
  const uint32_t h = x >> 4;
  *lo = (x & 0x0F0F0F0Fu) | ((x & 0x08080808u) * 0x1Eu);
  *hi = (h & 0x0F0F0F0Fu) | ((h & 0x08080808u) * 0x1Eu);
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// This thread's A fragments of one stage, decoded from the raw tile. For
// the warp's rows row0 = 64 wg + 16 w + g and row0 + 8, the wgmma A layout
// of a k32 step wants k slots 4 t .. 4 t + 3 in regs 0 (row0) and 1 (row0
// + 8), and slots 16 + 4 t .. in regs 2 and 3. Packed bytes 32 kk + 16 o +
// 4 t .. + 3 (o < 2) of a row hold low k-step kk's slots 16 o + 4 t .. in
// their low nibbles (a[kk]) and high k-step kk's in their high nibbles
// (a[2 + kk]). 64B swizzle: 16-byte chunk c of row r sits at chunk c ^ ((r
// >> 1) & 3), so a warp's 32 lanes (8 rows, 4 words) hit 32 banks.
__device__ __forceinline__ void decode_fragments(uint32_t raw, int row0,
                                                 int t, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const uint32_t row = raw + r * Geometry<true>::kChunkBytes + 4 * t;
    const int sw = (r >> 1) & 3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const uint32_t x = lds_u32(row + (((2 * kk + o) ^ sw) << 4));
        nibbles_to_s8(x, &a[kk][2 * o + h], &a[2 + kk][2 * o + h]);
      }
  }
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- the epilogue's registers and the block maxima --------------------------

// The larger of a and b, NaN if either is (as torch.amax takes it).
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// An int whose signed order is the order of the float with these bits
// (-0.0 below +0.0, the canonical NaN above +inf); its own inverse.
__device__ __forceinline__ int ordered(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

// Query q's slot of the maxima array: bits 0 and 3 of q flipped by bits 5
// and 6, so that one round of a warp's atomics (queries 16 g + 2 t + c, c
// fixed) and the 32 queries a warp reads each hit 32 banks.
__device__ __forceinline__ int max_slot(int q) {
  return q ^ ((q >> 5) & 1) ^ (((q >> 6) & 1) << 3);
}

// One round of the warp's reduce-scatter: lanes kHalf apart swap the
// halves of m[0, 2 kHalf) that the other keeps; each leaves the max of
// its kept half in m[0, kHalf) (the upper lane's stands for entries
// [kHalf, 2 kHalf) of before).
template <int kHalf>
__device__ __forceinline__ void fold(float (&m)[32], int lane) {
  const bool up = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? m[i] : m[i + kHalf];
    const float keep = up ? m[i + kHalf] : m[i];
    m[i] = fmax_nan(keep, __shfl_xor_sync(0xffffffffu, send, kHalf));
  }
}

// This thread's 64 accumulators, converted and scaled, into the staging
// tile: acc[4 j + 2 h + e] is (doc row0 + 8 h, query 8 j + 2 t + e), at box
// doc / 32, row query, 16-byte chunk ((doc % 32) / 4) ^ (query & 7). With
// kMaxima also bm[2 j + e], the larger of the two, a doc >= live_docs
// counted as -inf.
template <bool kMaxima>
__device__ __forceinline__ void stage_tile(const int (&acc)[64],
                                           uint8_t* staging,
                                           const float* s_qs,
                                           const float* s_ds, int row0,
                                           int lane, int live_docs,
                                           float (&bm)[32]) {
  const int t = lane & 3;
  const float dsc[2] = {s_ds[row0], s_ds[row0 + 8]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 q2 = *reinterpret_cast<const float2*>(&s_qs[8 * j + 2 * t]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int doc = row0 + 8 * h;
        const int ql = 8 * j + 2 * t + e;
        const float v = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]),
                      e ? q2.y : q2.x),
            dsc[h]);
        *reinterpret_cast<float*>(
            staging + (doc >> 5) * kOutBoxBytes + ql * 128 +
            ((((doc & 31) >> 2) ^ (ql & 7)) << 4) + ((doc & 3) << 2)) = v;
        if constexpr (kMaxima) {
          const float m = doc < live_docs ? v : -CUDART_INF_F;
          bm[2 * j + e] = h ? fmax_nan(bm[2 * j + e], m) : m;
        }
      }
  }
}

// The warp's maxima from its threads' bm (stage_tile), merged into the
// block's slots: three fold rounds leave lane (g, t) those of queries 16 g
// + 8 (i >> 1) + 2 t + (i & 1) in bm[i], i < 4.
__device__ __forceinline__ void merge_maxima(float (&bm)[32], int lane,
                                             int* s_max) {
  fold<16>(bm, lane);
  fold<8>(bm, lane);
  fold<4>(bm, lane);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 16 * g + 8 * (i >> 1) + 2 * t + (i & 1);
    atomicMax(&s_max[max_slot(q)], ordered(__float_as_int(bm[i])));
  }
}

// ---- the kernel -------------------------------------------------------------

// Stage it (the block's running count; k-th of its tile) of a consumer
// warpgroup's main loop: wait for the stage, issue its products, then
// retire stage it - 1's products and release its stage to the producer
// (within the tile; the tile's last stage is released after its final
// wait). K6 first decodes its corpus bytes into the fragment buffer a
// (free: its last products were retired by the previous stage's wait); K5
// reads both operands from the stage (a is unused).
template <bool kInt4>
__device__ __forceinline__ void consume_stage(int it, int k, uint8_t* smem,
                                              uint64_t* full_bar,
                                              uint64_t* empty_bar, int wg,
                                              int row0, int lane,
                                              uint32_t (&a)[4][4],
                                              int* acc) {
  using Geo = Geometry<kInt4>;
  const int s = it % Geo::kStages;
  uint8_t* stage = smem + s * Geo::kStageBytes;
  mbar_wait(&full_bar[s], (it / Geo::kStages) & 1);
  if constexpr (kInt4) {
    decode_fragments(smem_u32(stage + 2 * Geo::kBoxBytes), row0, lane & 3,
                     a);
    const uint64_t b_lo = sw64_desc(stage);
    const uint64_t b_hi = sw64_desc(stage + Geo::kBoxBytes);
    keep_live(a);
    wgmma_fence();
    wgmma_m64n128k32_s8_rs(acc, a[0], b_lo, k > 0);
    wgmma_m64n128k32_s8_rs(acc, a[1], b_lo + 2, 1);
    wgmma_m64n128k32_s8_rs(acc, a[2], b_hi, 1);
    wgmma_m64n128k32_s8_rs(acc, a[3], b_hi + 2, 1);
  } else {
    // This warpgroup's 64 corpus rows as A, the 128 queries as B; a k32
    // step of the 128-byte row adds 2 to the address field.
    const uint64_t da =
        sw128_desc(stage + Geo::kBoxBytes + wg * 64 * Geo::kChunkBytes);
    const uint64_t db = sw128_desc(stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Geo::kChunkBytes / 32; ++kk) {
      wgmma_m64n128k32_s8_ss(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<1>();
  if (k > 0 && lane == 0) mbar_arrive(&empty_bar[(it - 1) % Geo::kStages]);
}

// The consumers' walk over the block's tiles: main loop, then the
// epilogue, with (kMaxima) or without the block maxima. The accumulators
// are written by each tile's first product (scale-d = 0) and read by its
// epilogue, never written by other instructions: those would make ptxas
// serialize the wgmma pipeline.
template <bool kInt4, bool kTmaStore, bool kMaxima>
__device__ __forceinline__ void consume_tiles(
    const CUtensorMap* to, const float* __restrict__ qs,
    const float* __restrict__ ds, float* __restrict__ out,
    float* __restrict__ maxima, int B, int N, int n_chunks, int n_qtiles,
    int n_tiles, uint8_t* smem, uint8_t* staging, uint64_t* full_bar,
    uint64_t* empty_bar, float* s_qs, float* s_ds, int* s_max, int tid) {
  using Geo = Geometry<kInt4>;
  const int wg = tid >> 7;  // warpgroup: docs [64 wg, 64 wg + 64)
  const int w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = 64 * wg + 16 * w + (lane >> 2);  // its docs: +0, +8
  int acc[64];
  uint32_t frag[2][4][4];  // K6's A fragments, double buffered

  int base = 0;  // the block's running stage count at this tile's start
  for (int tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, base += n_chunks) {
    const int m0 = (tile % n_qtiles) * kTileM;
    const int n0 = (tile / n_qtiles) * kTileN;
    // This thread's scale for the epilogue (query m0 + tid, or doc n0 +
    // tid - 128), loaded now so that its latency hides under the main loop.
    const int si = tid < kTileM ? m0 + tid : n0 + tid - kTileM;
    const float scale = tid < kTileM ? (si < B ? qs[si] : 0.0f)
                                     : (si < N ? ds[si] : 0.0f);
    int k = 0;
    for (; k + 1 < n_chunks; k += 2) {  // two stages, one per buffer
      consume_stage<kInt4>(base + k, k, smem, full_bar, empty_bar, wg, row0,
                           lane, frag[0], acc);
      consume_stage<kInt4>(base + k + 1, k + 1, smem, full_bar, empty_bar,
                           wg, row0, lane, frag[1], acc);
    }
    if (k < n_chunks) {
      consume_stage<kInt4>(base + k, k, smem, full_bar, empty_bar, wg, row0,
                           lane, frag[0], acc);
    }
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(&empty_bar[(base + n_chunks - 1) % Geo::kStages]);
    }

    // Epilogue. The scales of this tile's queries and docs go to shared
    // memory (the previous epilogue's reads of them ended before its
    // second barrier), and thread q resets maxima slot q (which only it
    // read, after the previous tile's second barrier). The staging tile is
    // free once the previous tile's store has read it (TMA) or every warp
    // has stored it (plain).
    if (tid < kTileM) {
      s_qs[tid] = scale;
      if constexpr (kMaxima) {
        s_max[max_slot(tid)] = ordered(__float_as_int(-CUDART_INF_F));
      }
    } else {
      s_ds[tid - kTileM] = scale;
    }
    if (kTmaStore && tid == 0) bulk_wait_read<0>();
    consumer_barrier();
    float bm[32];  // this thread's block maxima (stage_tile)
    stage_tile<kMaxima>(acc, staging, s_qs, s_ds, row0, lane, N - n0, bm);
    if constexpr (kMaxima) merge_maxima(bm, lane, s_max);
    if constexpr (kTmaStore) fence_proxy_async();
    consumer_barrier();
    if constexpr (kTmaStore) {
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < kTileN / kOutBoxCols; ++i) {
          if (n0 + kOutBoxCols * i < N) {
            tma_store_2d(to, staging + i * kOutBoxBytes,
                         n0 + kOutBoxCols * i, m0);
          }
        }
        bulk_commit();
      }
    } else {
      // Warp wp stores queries wp + 8 i; lane l reads doc 32 x + l of box
      // x (conflict free) and writes it: 128 contiguous bytes a box.
      const int wp = tid >> 5;
      for (int i = 0; i < kTileM / 8; ++i) {
        const int ql = wp + 8 * i;
        const int mq = m0 + ql;
        if (mq >= B) break;
#pragma unroll
        for (int x = 0; x < kTileN / kOutBoxCols; ++x) {
          const int n = n0 + kOutBoxCols * x + lane;
          const float v = *reinterpret_cast<const float*>(
              staging + x * kOutBoxBytes + ql * 128 +
              (((lane >> 2) ^ (ql & 7)) << 4) + ((lane & 3) << 2));
          if (n < N) out[static_cast<size_t>(mq) * N + n] = v;
        }
      }
    }
    if (kMaxima && tid < kTileM && m0 + tid < B) {
      maxima[static_cast<size_t>(n0 / kTileN) * B + m0 + tid] =
          __int_as_float(ordered(s_max[max_slot(tid)]));
    }
  }
}

// tq:  K5: (B, W) int8 queries; K6: (B, 2 W); box kChunkBytes x 128 rows
// td:  (N, W) corpus bytes; box kChunkBytes x 128 rows
// to:  (B, N) f32 output; box 32 x 128, 128B swizzle (kTmaStore only)
// qs (B,), ds (N,) f32 scales; out (B, N) f32 (the plain stores);
// maxima (ceil(N / 128), B) f32 block maxima, or null for none
template <bool kInt4, bool kTmaStore>
__global__ void __launch_bounds__(kThreads, 1)
    similarity_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap td,
                            const __grid_constant__ CUtensorMap to,
                            const float* __restrict__ qs,
                            const float* __restrict__ ds,
                            float* __restrict__ out,
                            float* __restrict__ maxima, int B, int N, int W,
                            int n_qtiles, int n_tiles) {
  using Geo = Geometry<kInt4>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[Geo::kStages];
  __shared__ __align__(8) uint64_t empty_bar[Geo::kStages];
  __shared__ __align__(16) float s_qs[kTileM];
  __shared__ float s_ds[kTileN];
  __shared__ int s_max[kTileM];  // the block maxima's slots (max_slot)
  // Offset, not cast, to the aligned base: the compiler then still knows
  // the pointer is shared memory.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = smem + Geo::kStages * Geo::kStageBytes;

  const int tid = threadIdx.x;
  const int n_chunks = (W + Geo::kChunkBytes - 1) / Geo::kChunkBytes;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < Geo::kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full, tile after tile.
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % n_qtiles) * kTileM;
        const int n0 = (tile / n_qtiles) * kTileN;
        for (int k = 0; k < n_chunks; ++k, ++it) {
          const int s = it % Geo::kStages;
          if (it >= Geo::kStages) {
            mbar_wait(&empty_bar[s], ((it / Geo::kStages) - 1) & 1);
          }
          mbar_expect_tx(&full_bar[s], Geo::kStageBytes);
          uint8_t* stage = smem + s * Geo::kStageBytes;
          const int c = k * Geo::kChunkBytes;
          tma_load_2d(stage, &tq, &full_bar[s], c, m0);
          if constexpr (kInt4) {
            tma_load_2d(stage + Geo::kBoxBytes, &tq, &full_bar[s], W + c,
                        m0);
          }
          tma_load_2d(stage + (kInt4 ? 2 : 1) * Geo::kBoxBytes, &td,
                      &full_bar[s], c, n0);
        }
      }
    }
    return;
  }

  // Consumers. Each path is compiled on its own, so a launch without
  // maxima runs the scores-only epilogue's code and nothing of the other.
  if (maxima) {
    consume_tiles<kInt4, kTmaStore, true>(&to, qs, ds, out, maxima, B, N,
                                          n_chunks, n_qtiles, n_tiles, smem,
                                          staging, full_bar, empty_bar, s_qs,
                                          s_ds, s_max, tid);
  } else {
    consume_tiles<kInt4, kTmaStore, false>(&to, qs, ds, out, nullptr, B, N,
                                           n_chunks, n_qtiles, n_tiles, smem,
                                           staging, full_bar, empty_bar,
                                           s_qs, s_ds, s_max, tid);
  }
  if (kTmaStore && tid == 0) bulk_wait_all();
}

template <bool kInt4, bool kTmaStore>
int launch(const void* q, const void* d, const void* qs, const void* ds,
           void* out, void* maxima, int B, int N, int W,
           cudaStream_t stream) {
  using Geo = Geometry<kInt4>;
  const int n_qtiles = (B + kTileM - 1) / kTileM;
  const int n_ntiles = (N + kTileN - 1) / kTileN;
  const long long tiles = static_cast<long long>(n_qtiles) * n_ntiles;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, td, to;
  if (!encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q,
                 kInt4 ? 2 * W : W, B, Geo::kChunkBytes, Geo::kSwizzle) ||
      !encode_2d(&td, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, d, W, N,
                 Geo::kChunkBytes, Geo::kSwizzle)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kTmaStore) {
    if (!encode_2d(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, N, B,
                   kOutBoxCols, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    to = td;  // unused
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(similarity_wgmma_kernel<kInt4, kTmaStore>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geo::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  similarity_wgmma_kernel<kInt4, kTmaStore>
      <<<grid, kThreads, Geo::kSmemBytes, stream>>>(
          tq, td, to, static_cast<const float*>(qs),
          static_cast<const float*>(ds), static_cast<float*>(out),
          static_cast<float*>(maxima), B, N, W, n_qtiles,
          static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kInt4>
int similarity(const void* q, const void* d, const void* qs, const void* ds,
               void* out, void* maxima, int B, int N, int W, void* stream) {
  if (B < 0 || N < 0 || W <= 0 || W % 16 != 0 || !aligned16(q) ||
      !aligned16(d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N % 4 == 0 && aligned16(out)
             ? launch<kInt4, true>(q, d, qs, ds, out, maxima, B, N, W, s)
             : launch<kInt4, false>(q, d, qs, ds, out, maxima, B, N, W, s);
}

}  // namespace

// K5: (B, N) f32 similarity of an int8 corpus. q is the (B, W) int8 query
// operand and d the (N, W) corpus operand (see the top of this file), both
// 16-byte aligned, W % 16 == 0. Returns a cudaError_t value: 0 on a
// successful launch.
extern "C" int osr_similarity_i8(const void* q, const void* d,
                                 const void* qs, const void* ds, void* out,
                                 int B, int N, int W, void* stream) {
  return similarity<false>(q, d, qs, ds, out, nullptr, B, N, W, stream);
}

// K5 with its block maxima: as osr_similarity_i8, and maxima, (ceil(N /
// 128), B) f32, receives the maximum of each 128-column block of each row
// of out: maxima[g, b] = max of out[b, 128 g .. 128 g + 127].
extern "C" int osr_similarity_i8_blockmax(const void* q, const void* d,
                                          const void* qs, const void* ds,
                                          void* out, void* maxima, int B,
                                          int N, int W, void* stream) {
  return similarity<false>(q, d, qs, ds, out, maxima, B, N, W, stream);
}

// K6: (B, N) f32 similarity of a packed int4 corpus. q is the (B, 2 W)
// int8 query operand and d the (N, W) corpus operand, both 16-byte
// aligned, W % 16 == 0. Returns a cudaError_t value.
extern "C" int osr_similarity_i4(const void* q, const void* d,
                                 const void* qs, const void* ds, void* out,
                                 int B, int N, int W, void* stream) {
  return similarity<true>(q, d, qs, ds, out, nullptr, B, N, W, stream);
}

// K6 with its block maxima, as osr_similarity_i8_blockmax.
extern "C" int osr_similarity_i4_blockmax(const void* q, const void* d,
                                          const void* qs, const void* ds,
                                          void* out, void* maxima, int B,
                                          int N, int W, void* stream) {
  return similarity<true>(q, d, qs, ds, out, maxima, B, N, W, stream);
}

// Dynamic shared memory a launch of K6 (int4 != 0) or K5 requests, in
// bytes.
extern "C" int osr_similarity_wgmma_smem_bytes(int int4) {
  return int4 ? Geometry<true>::kSmemBytes : Geometry<false>::kSmemBytes;
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
