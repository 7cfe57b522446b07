// Quantized dense similarity kernel for Hopper (sm_90a): K5, the int8
// corpus.
//
// Replaces osr_tpu/ops/pallas/matmul.py:_kernel (:24), launched via
// int8_similarity_pallas. K6 (_kernel_i4, the int4 corpus) is
// similarity_wgmma.cu.
//
// What it computes, for int8 queries q (B, D) with scales qs (B,) and an
// int8 corpus d (N, D) with scales ds (N,):
//   acc[b, n] = sum_c q[b, c] * d[n, c]                (exact, in int32)
//   out[b, n] = (float(acc[b, n]) * qs[b]) * ds[n]     (two f32 multiplies)
//
// Numerics. The integer sum is exact, the int32 -> f32 conversion rounds to
// nearest, and the epilogue multiplies in the stated order with no FMA, so
// the kernel equals the plain PyTorch version (ops/matmul.py) bit for bit.
//
// Bound. At the dense path's shape (B = 1,024 queries, N = 1,000,000 docs,
// D = 768) the products are 1.57e15 int8 operations, 0.79 ms at 1,979 TOP/s,
// but the bytes are 0.77 GB of corpus plus the 4.10 GB (B, N) f32 output,
// 1.45 ms at 3.35 TB/s. So the kernel is bound by bytes, and by the output
// write most of all.
//
// Design. One thread block owns a (128 queries x 128 docs) output tile. The
// contraction walks the width in chunks of 128 columns staged through
// shared memory. The next chunk's global loads are issued into registers
// before the current chunk is multiplied. Eight warps (2 along queries x 4
// along docs) each run int8 mma.sync m16n8k32 with s32 accumulators on a 64
// x 32 sub-tile, fed by ldmatrix from padded (conflict-free) rows. The
// kernel masks ragged B, N and D itself (zero-filled loads, guarded
// stores). Consecutive blocks walk the query tiles of one corpus tile, so
// each corpus tile is read from HBM about once and the queries stay in L2.
// similarity_wgmma.cu's persistent TMA + wgmma design is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;       // queries per block
constexpr int kTileN = 128;       // docs per block
constexpr int kChunk = 128;       // columns (int8 bytes) per chunk
constexpr int kLd = kChunk + 16;  // padded shared row, in bytes
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarpM = 64;        // warp sub-tile: queries
constexpr int kWarpN = 32;        // warp sub-tile: docs

// Bytes [col, col + 16) of a row whose valid bytes are [0, limit), zero
// outside it. kAligned: the row and limit allow one 16-byte load whenever
// the whole segment is valid.
template <bool kAligned>
__device__ __forceinline__ uint4 load16(const int8_t* row, int col,
                                        int limit, bool row_ok) {
  if (!row_ok || col >= limit) return make_uint4(0, 0, 0, 0);
  if (kAligned && col + 16 <= limit) {
    return *reinterpret_cast<const uint4*>(row + col);
  }
  uint4 r;
  uint8_t* b = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    b[i] = col + i < limit ? static_cast<uint8_t>(row[col + i]) : 0;
  }
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// q:   (B, D) int8;  qs: (B,) f32
// d:   (N, D) int8;  ds: (N,) f32;  out: (B, N) f32
// kAligned: D % 16 == 0, q and d 16-byte aligned.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    similarity_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ d,
                      const float* __restrict__ qs,
                      const float* __restrict__ ds, float* __restrict__ out,
                      int B, int N, int D, int n_qtiles) {
  __shared__ __align__(16) int8_t sq[kTileM][kLd];
  __shared__ __align__(16) int8_t sd[kTileN][kLd];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // 64-query half
  const int wn = warp >> 1;  // 32-doc quarter
  const int qt = blockIdx.x % n_qtiles;
  const int nt = blockIdx.x / n_qtiles;
  const int m0 = qt * kTileM;
  const int n0 = nt * kTileN;
  const int n_chunks = (D + kChunk - 1) / kChunk;

  // Register staging for one chunk: 4 x 16 query bytes and 4 x 16 corpus
  // bytes per thread.
  uint4 qreg[4];
  uint4 dreg[4];

  auto load_chunk = [&](int c) {
    const int k0 = c * kChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3;
      const int seg = idx & 7;  // 16 bytes per segment
      const int m = m0 + row;
      qreg[i] = load16<kAligned>(q + static_cast<size_t>(m) * D,
                                 k0 + seg * 16, D, m < B);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int n = n0 + (idx >> 3);
      dreg[i] = load16<kAligned>(d + static_cast<size_t>(n) * D,
                                 k0 + (idx & 7) * 16, D, n < N);
    }
  };

  auto store_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sq[idx >> 3][(idx & 7) * 16]) = qreg[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sd[idx >> 3][(idx & 7) * 16]) = dreg[i];
    }
  };

  int acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's fragments are all read
    store_chunk();
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      uint32_t a[kWarpM / 16][4];
      uint32_t b[kWarpN / 8][2];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i) {
        ldmatrix_x4(a[i], &sq[wm * kWarpM + i * 16 + (lane & 15)]
                             [ks * 32 + (lane >> 4) * 16]);
      }
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j) {
        uint32_t r4[4];
        const int mat = lane >> 3;
        ldmatrix_x4(r4, &sd[wn * kWarpN + j * 16 + (mat >> 1) * 8 +
                            (lane & 7)][ks * 32 + (mat & 1) * 16]);
        b[2 * j][0] = r4[0];
        b[2 * j][1] = r4[1];
        b[2 * j + 1][0] = r4[2];
        b[2 * j + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // Epilogue: (float(acc) * qs[b]) * ds[n], in that order, no FMA.
  const int g = lane >> 2;
  const int t = lane & 3;
  float dsc[kWarpN / 8][2];
#pragma unroll
  for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * kWarpN + j * 8 + 2 * t + e;
      dsc[j][e] = n < N ? ds[n] : 0.0f;
    }
  const bool pair_store = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * kWarpM + i * 16 + h * 8 + g;
      if (m >= B) continue;
      const float qsm = qs[m];
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const int n = n0 + wn * kWarpN + j * 8 + 2 * t;
        const float v0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h]), qsm), dsc[j][0]);
        const float v1 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), qsm), dsc[j][1]);
        float* dst = out + static_cast<size_t>(m) * N + n;
        if (pair_store && n + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (n < N) dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

template <bool kAligned>
int launch(const void* q, const void* d, const void* qs, const void* ds,
           void* out, int B, int N, int D, cudaStream_t stream) {
  const int n_qtiles = (B + kTileM - 1) / kTileM;
  const int n_ntiles = (N + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(n_qtiles) * n_ntiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  similarity_kernel<kAligned>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(d),
          static_cast<const float*>(qs), static_cast<const float*>(ds),
          static_cast<float*>(out), B, N, D, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K5: (B, N) f32 similarity of an int8 corpus. Returns a cudaError_t
// value: 0 on a successful launch.
extern "C" int osr_similarity(const void* q, const void* d, const void* qs,
                              const void* ds, void* out, int B, int N, int D,
                              void* stream) {
  if (B < 0 || N < 0 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = D % 16 == 0 && aligned16(q) && aligned16(d);
  return al ? launch<true>(q, d, qs, ds, out, B, N, D, s)
            : launch<false>(q, d, qs, ds, out, B, N, D, s);
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
