// Masked int8 sparse-head scoring kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of osr_tpu/ops/pallas/head.py for the int8
// head:
//   K1    _head_kernel           (scores only)
//   K2    _head_blockmax_kernel  (scores + per-128-row maxima)
//   K4-i8 _make_blocktopm_kernel + _blocktopm_epilogue (per-128-row-block
//         top-m (value, row); the scores are never written)
// The int4 family (K3, K4-i4) lives in head_wgmma.cu; the entry points
// here refuse int4 = 1.
//
// What it computes, for a query batch q (B, HW) bf16 whose per-column head
// scales are already folded in and rounded to bf16 by the wrapper:
//   s[b, r]    = valid[r] ? sum_f q[b, f] * head[r, f] : -inf   (f32 accum)
//   out[b, r]  = s[b, r]                                  (K1, K2)
//   bmax[g, b] = max over r in [128 g, 128 g + 128) of s[b, r]  (K2)
//   vals[b, g, :m], rows[b, g, :m] = the m largest s[b, r] of block g in
//     descending order, ties to the lowest row, and equal values in row
//     order across ranks (K4): a stable descending sort's first m
// with rows r >= R counted as -inf. int8 codes are exact in bf16, so each
// product is exact and only the f32 summation order differs from the
// plain PyTorch version (ops/head.py).
//
// Design. One thread block owns a (128 queries x 128 head rows) output
// tile, so its rows are exactly one 128-row pruning block: the block
// maximum (K2) and the block top-m (K4) are computed inside the thread
// block, with no second pass over the (B, R) score matrix and no atomics.
// The contraction walks the head width in chunks of 64 columns staged
// through shared memory: the head chunk is loaded as int8 and converted to
// bf16 while it is stored; the query chunk is copied as is. The next
// chunk's global loads are issued into registers before the current chunk
// is multiplied. Eight warps (2 along queries x 4 along rows) each run bf16
// mma.sync m16n8k16 with f32 accumulators on a 64 x 32 sub-tile, fed by
// ldmatrix from padded (conflict-free) rows. All three kernels share this
// main loop, so K4's values are bit for bit the per-block top-m of K2's own
// scores.
//
// K4's epilogue. In a warp, the four lanes of one accumulator row hold 8
// scores each of one query's 32 rows. The warp takes the top m of its 32
// rows per query in m rounds: each lane offers its largest not-yet-taken
// score (the lowest row among equals), two xor-shuffles keep the larger
// value or, on equal values, the lower row, and the owner marks it taken.
// The four warps' sorted lists go to shared memory (aliasing the staging
// buffers, free once the main loop ends), and one thread per query merges
// them, taking the lower warp's entry on equal values: that is row order.
// The (B, G, m) values and int32 block-global rows are written directly.
//
// Bound on an H100: the tensor cores, for all three kernels. At the FiQA
// bench shape (B=3,328, R=57,728, F=2,048): 7.87e11 FLOP against 989
// TFLOP/s bf16 is 0.7957 ms, while the bytes (head read once, queries, the
// (B, R) f32 scores and the maxima written once) take 0.27 ms at 3.35 TB/s.
// K4 does the same FLOPs and writes 2 B G m values instead of B R: per 1M
// corpus chunk (B=2,048, R=500,096, F=2,048, m=8), 4.195e12 FLOP is 4.24
// ms against 0.46 ms of bytes. mma.sync reaches only part of the wgmma
// rate; head_wgmma.cu's TMA + wgmma loop is the next step for speed.
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
constexpr int kWarpsN = kTileN / kWarpN;  // 4 warps along the rows

// Epilogues of the one kernel template.
constexpr int kEpiScores = 0;    // K1: masked scores
constexpr int kEpiBlockMax = 1;  // K2: masked scores + block maxima
constexpr int kEpiTopM = 2;      // K4: per-block top-m (value, row)

constexpr int kMaxM = 16;  // K4's largest m (ops/head.py:BLOCKTOPM_MAX_M)

// Shared memory: the staging buffers of the main loop; K4's epilogue
// reuses them for the warps' (value, lane) lists, [kWarpsN][kMaxM][kTileM]
// f32 values followed by the same shape of uint8 lanes.
constexpr int kStageBytes = (kTileM + kTileN) * kLd * 2;
constexpr int kListBytes = kWarpsN * kMaxM * kTileM * (4 + 1);
__host__ __device__ constexpr int smem_bytes(int epi) {
  return (epi == kEpiTopM && kListBytes > kStageBytes) ? kListBytes
                                                       : kStageBytes;
}

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
// K1:    out (B, R) f32
// K2:    out (B, R) f32;  aux (G, B) f32 block maxima, G = ceil(R / 128)
// K4:    out (B, G, m) f32 values;  rows (B, G, m) int32;  1 <= m <= kMaxM
template <int kEpi>
__global__ void __launch_bounds__(kThreads)
    head_scores_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ head,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, float* __restrict__ aux,
                       int32_t* __restrict__ rows, int B, int R, int HW,
                       int n_qtiles, int m) {
  __shared__ __align__(16) unsigned char smem[smem_bytes(kEpi)];
  __shared__ float smax[kWarpsN][kTileM];
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

  // Epilogue: mask, then store the scores (and reduce the tile's row
  // maxima), or extract each query's top m of the tile.
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

  if constexpr (kEpi == kEpiTopM) {
    float* lv = reinterpret_cast<float*>(smem);
    uint8_t* ll = smem + kWarpsN * kMaxM * kTileM * 4;
    __syncthreads();  // every warp is done reading the staged chunk
#pragma unroll
    for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = wm * kWarpM + i * 16 + h * 8 + g;
        // This lane's 8 scores of the query, in row order: x = 2 j + e
        // is tile row wn * 32 + 8 j + 2 t + e.
        float v[8];
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[2 * j + e] = ok[j][e] ? acc[i][j][2 * h + e] : -CUDART_INF_F;
        unsigned taken = 0;
        for (int r = 0; r < m; ++r) {
          // The lane's largest free score, the lowest row among equals; a
          // lane with all 8 taken offers nothing (row past every row).
          float best = -CUDART_INF_F;
          int best_row = 0x7fffffff;
          int best_x = -1;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            if (!((taken >> x) & 1u) && (best_x < 0 || v[x] > best)) {
              best = v[x];
              best_row = wn * kWarpN + (x >> 1) * 8 + 2 * t + (x & 1);
              best_x = x;
            }
          }
          const int mine = best_row;
#pragma unroll
          for (int s = 1; s <= 2; s <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, s);
            const int orow = __shfl_xor_sync(0xffffffffu, best_row, s);
            if (ov > best || (ov == best && orow < best_row)) {
              best = ov;
              best_row = orow;
            }
          }
          if (best_x >= 0 && best_row == mine) taken |= 1u << best_x;
          if (t == 0) {
            lv[(wn * kMaxM + r) * kTileM + ml] = best;
            ll[(wn * kMaxM + r) * kTileM + ml] =
                static_cast<uint8_t>(best_row);
          }
        }
      }
    }
    __syncthreads();
    if (tid < kTileM && m0 + tid < B) {
      // Merge the four warps' descending lists; on equal values the lower
      // warp (the lower rows) goes first, so equal values stay in row order.
      const int G = (R + kTileN - 1) / kTileN;
      const size_t base = (static_cast<size_t>(m0 + tid) * G + rt) * m;
      int p[kWarpsN] = {0, 0, 0, 0};
      for (int r = 0; r < m; ++r) {
        float best = -CUDART_INF_F;
        int best_w = -1;
        int best_row = 0;
#pragma unroll
        for (int w = 0; w < kWarpsN; ++w) {
          const int at = (w * kMaxM + p[w]) * kTileM + tid;
          if (p[w] < m && (best_w < 0 || lv[at] > best)) {
            best = lv[at];
            best_w = w;
            best_row = ll[at];
          }
        }
#pragma unroll
        for (int w = 0; w < kWarpsN; ++w) p[w] += (w == best_w);
        out[base + r] = best;
        rows[base + r] = n0 + best_row;
      }
    }
    return;
  }

  const bool pair_store = (R & 1) == 0;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = wm * kWarpM + i * 16 + h * 8 + g;
      const int mq = m0 + ml;
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const float v0 = ok[j][0] ? acc[i][j][2 * h] : -CUDART_INF_F;
        const float v1 = ok[j][1] ? acc[i][j][2 * h + 1] : -CUDART_INF_F;
        rmax = fmaxf(rmax, fmaxf(v0, v1));
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
      if (kEpi == kEpiBlockMax) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (t == 0) smax[wn][ml] = rmax;
      }
    }
  }
  if (kEpi == kEpiBlockMax) {
    __syncthreads();
    if (tid < kTileM && m0 + tid < B) {
      float v = smax[0][tid];
#pragma unroll
      for (int w = 1; w < kWarpsN; ++w) v = fmaxf(v, smax[w][tid]);
      aux[static_cast<size_t>(rt) * B + m0 + tid] = v;
    }
  }
}

template <int kEpi>
int launch(const void* q, const void* head, const void* valid, void* out,
           void* aux, void* rows, int B, int R, int HW, int m,
           cudaStream_t stream) {
  const int n_qtiles = (B + kTileM - 1) / kTileM;
  const int n_rtiles = (R + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(n_qtiles) * n_rtiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  head_scores_kernel<kEpi>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const uint8_t*>(head),
          static_cast<const uint8_t*>(valid), static_cast<float*>(out),
          static_cast<float*>(aux), static_cast<int32_t*>(rows), B, R, HW,
          n_qtiles, m);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int R, int HW) {
  return B < 0 || R < 0 || HW <= 0 || HW % 16 != 0;
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.
// blockmax = 0 is K1, 1 is K2. int4 = 1 is refused: the int4 head's
// kernels are in head_wgmma.cu.
extern "C" int osr_head_scores(const void* q, const void* head,
                               const void* valid, void* out, void* bmax,
                               int B, int R, int HW, int int4, int blockmax,
                               void* stream) {
  if (bad_shape(B, R, HW) || int4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blockmax) {
    return launch<kEpiBlockMax>(q, head, valid, out, bmax, nullptr, B, R,
                                HW, 0, s);
  }
  return launch<kEpiScores>(q, head, valid, out, bmax, nullptr, B, R, HW, 0,
                            s);
}

// K4-i8: per-128-row-block top-m values (B, G, m) f32 and rows (B, G, m)
// int32 of an int8 head; int4 = 1 is refused (head_wgmma.cu). Returns a
// cudaError_t value: 0 on a successful launch.
extern "C" int osr_head_blocktopm(const void* q, const void* head,
                                  const void* valid, void* vals, void* rows,
                                  int B, int R, int HW, int int4, int m,
                                  void* stream) {
  if (bad_shape(B, R, HW) || int4 || m < 1 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<kEpiTopM>(q, head, valid, vals, nullptr, rows, B, R, HW, m,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
