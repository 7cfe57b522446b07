// Per-row symmetric int8 quantization and dequantization for Hopper (sm_90a).
//
// Replaces the Pallas kernels of osr_tpu/ops/pallas/quantize.py:
//   K7 _quant_kernel (:24) and _quant_kernel_stochastic (:32), launched via
//      quantize_symmetric_pallas
//   K8 _dequant_kernel (:115), launched via dequantize_symmetric_pallas
//
// What they compute, for x (N, D) float32:
//   scale[r]    = max(max_c |x[r, c]|, 1e-8) * f32(1/127)
//   values[r,c] = rint(x[r, c] / scale[r])                    (half to even)
// or, stochastic, floor(s) + (u < s - floor(s)) clipped to [-127, 127], with
// s = x / scale and u = (bits >> 8) / 2^24 for 32 random bits per element;
// and the inverse out[r, c] = float(values[r, c]) * scale[r].
//
// Numerics. The scale is osr_tpu's absmax / 127.0 as its XLA computes it, a
// multiply by the reciprocal of 127 rounded to f32 (a single rounding, so no
// fused multiply-add can change it). The build has no --use_fast_math, so
// the codes' '/' is the IEEE division and rintf rounds half to even, as
// torch.round does: codes and scales equal the plain PyTorch versions
// (ops/quantize_kernels.py) and osr_tpu's bit for bit. The TPU's
// per-core PRNG cannot be reproduced, so stochastic rounding draws its bits
// from a counter-based hash, bits = fmix32(fmix32(seed ^ row * 0x9E3779B1)
// ^ col) (murmur3's finalizer), which the plain version computes with int64
// tensor ops: the two agree bit for bit too.
//
// Design. Both kernels are bound by bytes: at 1M x 768 the quantizer reads
// 3.07 GB and writes 0.77 GB, 1.15 ms at 3.35 TB/s, and the dequantizer
// moves the same bytes the other way; the arithmetic is a few operations per
// element. Both give each row to one warp, so a row's scale is one value.
// - The quantizer: a first pass reduces |x| with float4 loads and warp
//   shuffles, a second pass re-reads the row (a 3 KB row is still in L1/L2)
//   and writes four codes per lane and iteration.
// - The dequantizer (rebuilt for its 3.07 GB of stores): one wave of blocks
//   over the SMs, each warp walking rows with a stride of the grid's warp
//   count (no division). Lane l converts the 4 codes of word l + 32 i: one
//   32-bit load and one f32 x 4 store, so each warp store instruction writes
//   512 contiguous bytes (a lane-per-16-codes walk spreads one instruction
//   over 2 KB at a 64-byte stride). A lane loads up to 8 words (a whole
//   768-code row) before its first store, and the stores are streaming
//   (written once, never re-read).
// Rows whose width or address does not allow vector access take a scalar
// loop of the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr float kEps = 1e-8f;
constexpr int kDequantUnroll = 8;  // words a K8 lane loads before storing

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <bool kStochastic>
__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t row_key,
                                               uint32_t col) {
  const float s = x / scale;
  if (!kStochastic) {
    return static_cast<int8_t>(static_cast<int>(rintf(s)));
  }
  const float fl = floorf(s);
  const float frac = s - fl;
  const uint32_t bits = fmix32(row_key ^ col);
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  float r = fl + (u < frac ? 1.0f : 0.0f);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// x: (N, D) f32; values: (N, D) int8; scales: (N,) f32.
// kVec: D % 4 == 0, x 16-byte and values 4-byte aligned.
template <bool kStochastic, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const float* __restrict__ x,
                         int8_t* __restrict__ values,
                         float* __restrict__ scales, int N, int D,
                         uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* xr = x + row * D;
  int8_t* vr = values + row * D;

  float amax = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 v = x4[i];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(xr[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = fmaxf(amax, kEps) * (1.0f / 127.0f);
  if (lane == 0) scales[row] = scale;
  const uint32_t row_key =
      kStochastic ? fmix32(seed ^ (static_cast<uint32_t>(row) * 0x9E3779B1u))
                  : 0u;

  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* v4 = reinterpret_cast<char4*>(vr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 v = x4[i];
      const uint32_t c = 4u * i;
      v4[i] = make_char4(quantize_one<kStochastic>(v.x, scale, row_key, c),
                         quantize_one<kStochastic>(v.y, scale, row_key, c + 1),
                         quantize_one<kStochastic>(v.z, scale, row_key, c + 2),
                         quantize_one<kStochastic>(v.w, scale, row_key, c + 3));
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      vr[i] = quantize_one<kStochastic>(xr[i], scale, row_key, i);
    }
  }
}

// Code j (byte j, little-endian) of a word of 4 codes, as f32.
__device__ __forceinline__ float code_of(uint32_t w, int j) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}

// values: (N, D) int8; scales: (N,) f32; out: (N, D) f32.
// Warp v of the grid's V warps takes rows v, v + V, v + 2 V, ...: it knows
// its row without a division and loads the row's scale once.
// kVec (D % 4 == 0, values 4-byte and out 16-byte aligned): lane l takes
// words l + 32 i of the row, codes 4 (l + 32 i) .. + 3, one 32-bit load and
// one f32 x 4 store each, so that a warp's store instruction writes 512
// contiguous bytes; it loads kDequantUnroll words before it stores any
// (the row's tail guarded), and its stores carry the streaming hint
// (st.global.cs: the output is written once and never read again).
// Otherwise lane l takes columns l + 32 i one by
// one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows_kernel(const int8_t* __restrict__ values,
                           const float* __restrict__ scales,
                           float* __restrict__ out, int N, int D) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                       (threadIdx.x >> 5);
       row < N; row += warps) {
    const float s = scales[row];
    const long long base = row * D;
    if (kVec) {
      const int words = D >> 2;
      const uint32_t* vr = reinterpret_cast<const uint32_t*>(values + base);
      float4* orow = reinterpret_cast<float4*>(out + base);
      for (int i0 = lane; i0 < words; i0 += 32 * kDequantUnroll) {
        uint32_t w[kDequantUnroll];
#pragma unroll
        for (int u = 0; u < kDequantUnroll; ++u) {
          const int i = i0 + 32 * u;
          w[u] = i < words ? __ldg(vr + i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kDequantUnroll; ++u) {
          const int i = i0 + 32 * u;
          if (i < words) {
            __stcs(orow + i, make_float4(__fmul_rn(code_of(w[u], 0), s),
                                         __fmul_rn(code_of(w[u], 1), s),
                                         __fmul_rn(code_of(w[u], 2), s),
                                         __fmul_rn(code_of(w[u], 3), s)));
          }
        }
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        out[base + c] = __fmul_rn(static_cast<float>(values[base + c]), s);
      }
    }
  }
}

// One wave of K8's blocks over the card's SMs (at most the rows need), or
// 0 on an error (then in *err).
unsigned dequantize_grid(bool vec, int N, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        vec ? dequantize_rows_kernel<true> : dequantize_rows_kernel<false>,
        kThreads, 0);
  }
  if (*err == cudaSuccess && per_sm == 0) {
    *err = cudaErrorInvalidConfiguration;
  }
  if (*err != cudaSuccess) return 0;
  const long long need = (static_cast<long long>(N) + kRowsPerBlock - 1) /
                         kRowsPerBlock;
  const long long wave = static_cast<long long>(sms) * per_sm;
  return static_cast<unsigned>(need < wave ? need : wave);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.
extern "C" int osr_quantize_symmetric(const void* x, void* values,
                                      void* scales, int N, int D,
                                      int stochastic, unsigned int seed,
                                      void* stream) {
  if (N < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(N) + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool vec = D % 4 == 0 && aligned(x, 16) && aligned(values, 4);
  const float* xf = static_cast<const float*>(x);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  if (stochastic) {
    if (vec) {
      quantize_rows_kernel<true, true>
          <<<blocks, kThreads, 0, s>>>(xf, v, sc, N, D, seed);
    } else {
      quantize_rows_kernel<true, false>
          <<<blocks, kThreads, 0, s>>>(xf, v, sc, N, D, seed);
    }
  } else if (vec) {
    quantize_rows_kernel<false, true>
        <<<blocks, kThreads, 0, s>>>(xf, v, sc, N, D, seed);
  } else {
    quantize_rows_kernel<false, false>
        <<<blocks, kThreads, 0, s>>>(xf, v, sc, N, D, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int osr_dequantize_symmetric(const void* values,
                                        const void* scales, void* out, int N,
                                        int D, void* stream) {
  if (N < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned(values, 4) && aligned(out, 16);
  cudaError_t err;
  const unsigned blocks = dequantize_grid(vec, N, &err);
  if (blocks == 0) return static_cast<int>(err);
  const int8_t* v = static_cast<const int8_t*>(values);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (vec) {
    dequantize_rows_kernel<true><<<blocks, kThreads, 0, s>>>(v, sc, o, N, D);
  } else {
    dequantize_rows_kernel<false><<<blocks, kThreads, 0, s>>>(v, sc, o, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
