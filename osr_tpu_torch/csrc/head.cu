// Masked int8 sparse-head scoring kernel for Hopper (sm_90a): K1, the
// scores only.
//
// Replaces osr_tpu/ops/pallas/head.py:_head_kernel (via
// head_scores_pallas), which the int8 path runs below the block-prune
// floor (top_k=1000 at FiQA scale). The block-pruned and extraction
// kernels (K2, K3, K4) are in head_wgmma.cu.
//
// What it computes, for a query batch q (B, HW) bf16 whose per-column head
// scales are already folded in and rounded to bf16 by the wrapper:
//   out[b, r] = valid[r] ? sum_f q[b, f] * head[r, f] : -inf   (f32 accum)
// int8 codes are exact in bf16, so each product is exact and only the f32
// summation order differs from the plain PyTorch version (ops/head.py).
//
// Design. One thread block owns a (128 queries x 128 head rows) output
// tile. The contraction walks the head width in chunks of 64 columns
// staged through shared memory: the head chunk is loaded as int8 and
// converted to bf16 while it is stored; the query chunk is copied as is.
// The next chunk's global loads are issued into registers before the
// current chunk is multiplied. Eight warps (2 along queries x 4 along
// rows) each run bf16 mma.sync m16n8k16 with f32 accumulators on a 64 x 32
// sub-tile, fed by ldmatrix from padded (conflict-free) rows.
//
// Bound on an H100: the tensor cores. At the FiQA bench shape (B=3,328,
// R=57,728, F=2,048): 7.87e11 FLOP against 989 TFLOP/s bf16 is 0.7957 ms,
// while the bytes (head read once, queries, the (B, R) f32 scores written
// once) take 0.27 ms at 3.35 TB/s. mma.sync reaches only part of the
// wgmma rate; head_wgmma.cu's TMA + wgmma loop is the next step for speed.
// Block order walks the query tiles of one head row tile first, so the
// head tile is read from HBM about once and re-read from L2 by the other
// query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;       // queries per block
constexpr int kTileN = 128;       // head rows per block: one pruning block
constexpr int kChunk = 64;        // logical head columns per chunk
constexpr int kLd = kChunk + 8;   // padded shared row, in bf16
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarpM = 64;        // warp sub-tile: queries
constexpr int kWarpN = 32;        // warp sub-tile: head rows

// Shared memory: the staging buffers of the main loop.
constexpr int kStageBytes = (kTileM + kTileN) * kLd * 2;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 signed bytes -> 16 bf16 (exact), as two uint4.
__device__ __forceinline__ void int8x16_to_bf16(uint4 v, uint4* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = pack_bf16x2(static_cast<float>(b[2 * i]),
                       static_cast<float>(b[2 * i + 1]));
  }
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// q:     (B, HW) bf16
// head:  (R, HW) int8; HW % 16 == 0
// valid: (R,) bool
// out:   (B, R) f32
__global__ void __launch_bounds__(kThreads)
    head_scores_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ head,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int B, int R, int HW,
                       int n_qtiles) {
  __shared__ __align__(16) unsigned char smem[kStageBytes];
  auto sq = reinterpret_cast<__nv_bfloat16(*)[kLd]>(smem);
  auto sh = reinterpret_cast<__nv_bfloat16(*)[kLd]>(smem + kTileM * kLd * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 64-query half
  const int wn = warp >> 1;  // 32-row quarter
  const int qt = blockIdx.x % n_qtiles;
  const int rt = blockIdx.x / n_qtiles;
  const int m0 = qt * kTileM;
  const int n0 = rt * kTileN;
  const int n_chunks = (HW + kChunk - 1) / kChunk;

  // Register staging for one chunk: 4 x 8 bf16 of q and 2 x 16 bytes of
  // head per thread.
  constexpr int kHeadVecs = 2;
  uint4 qreg[4];
  uint4 hreg[kHeadVecs];

  auto load_chunk = [&](int c) {
    const int k0 = c * kChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;
      const int seg = idx & 7;  // 8 bf16 per segment
      const int col = k0 + seg * 8;
      const bool in_k = col < HW;
      const int mq = m0 + row;
      qreg[i] = (in_k && mq < B)
                    ? *reinterpret_cast<const uint4*>(
                          q + static_cast<size_t>(mq) * HW + col)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kHeadVecs; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 2;
      const int seg = idx & 3;
      const int col = k0 + seg * 16;
      const int r = n0 + row;
      hreg[i] = (col < HW && r < R)
                    ? *reinterpret_cast<const uint4*>(
                          head + static_cast<size_t>(r) * HW + col)
                    : make_uint4(0, 0, 0, 0);
    }
  };

  auto store_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sq[idx >> 3][(idx & 7) * 8]) = qreg[i];
    }
#pragma unroll
    for (int i = 0; i < kHeadVecs; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 2, seg = idx & 3;
      uint4 v[2];
      int8x16_to_bf16(hreg[i], v);
      uint4* d = reinterpret_cast<uint4*>(&sh[row][seg * 16]);
      d[0] = v[0];
      d[1] = v[1];
    }
  };

  float acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's fragments are all read
    store_chunk();
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t a[kWarpM / 16][4];
      uint32_t b[kWarpN / 8][2];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i) {
        ldmatrix_x4(a[i], &sq[wm * kWarpM + i * 16 + (lane & 15)]
                             [ks * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j) {
        uint32_t r4[4];
        const int mat = lane >> 3;
        ldmatrix_x4(r4, &sh[wn * kWarpN + j * 16 + (mat >> 1) * 8 +
                            (lane & 7)][ks * 16 + (mat & 1) * 8]);
        b[2 * j][0] = r4[0];
        b[2 * j][1] = r4[1];
        b[2 * j + 1][0] = r4[2];
        b[2 * j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }

  // Epilogue: mask, then store the scores.
  const int g = lane >> 2;
  const int t = lane & 3;
  bool ok[kWarpN / 8][2];
#pragma unroll
  for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * kWarpN + j * 8 + 2 * t + e;
      ok[j][e] = n < R && valid[n] != 0;
    }

  const bool pair_store = (R & 1) == 0;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = wm * kWarpM + i * 16 + h * 8 + g;
      const int mq = m0 + ml;
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const float v0 = ok[j][0] ? acc[i][j][2 * h] : -CUDART_INF_F;
        const float v1 = ok[j][1] ? acc[i][j][2 * h + 1] : -CUDART_INF_F;
        const int n = n0 + wn * kWarpN + j * 8 + 2 * t;
        if (mq < B) {
          float* dst = out + static_cast<size_t>(mq) * R + n;
          if (pair_store && n + 1 < R) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < R) dst[0] = v0;
            if (n + 1 < R) dst[1] = v1;
          }
        }
      }
    }
  }
}

}  // namespace

// K1: (B, R) f32 masked scores of an int8 head. Returns a cudaError_t
// value: 0 on a successful launch.
extern "C" int osr_head_scores(const void* q, const void* head,
                               const void* valid, void* out, int B, int R,
                               int HW, void* stream) {
  if (B < 0 || R < 0 || HW <= 0 || HW % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qtiles = (B + kTileM - 1) / kTileM;
  const int n_rtiles = (R + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(n_qtiles) * n_rtiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  head_scores_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(head), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), B, R, HW, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
