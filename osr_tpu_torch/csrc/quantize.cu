// Per-row symmetric int8 quantization and dequantization for Hopper (sm_90a).
//
// Replaces the Pallas kernels of osr_tpu/ops/pallas/quantize.py:
//   K7 _quant_kernel (:24) and _quant_kernel_stochastic (:32), launched via
//      quantize_symmetric_pallas
//   K8 _dequant_kernel (:115), launched via dequantize_symmetric_pallas
//
// What they compute, for x (N, D) float32:
//   scale[r]    = max(max_c |x[r, c]|, 1e-8) / 127            (IEEE division)
//   values[r,c] = rint(x[r, c] / scale[r])                    (half to even)
// or, stochastic, floor(s) + (u < s - floor(s)) clipped to [-127, 127], with
// s = x / scale and u = (bits >> 8) / 2^24 for 32 random bits per element;
// and the inverse out[r, c] = float(values[r, c]) * scale[r].
//
// Numerics. The build has no --use_fast_math, so '/' is the IEEE division
// and rintf rounds half to even, as torch.round does: codes and scales equal
// the plain PyTorch versions (ops/quantize_kernels.py) bit for bit. The TPU's
// per-core PRNG cannot be reproduced, so stochastic rounding draws its bits
// from a counter-based hash, bits = fmix32(fmix32(seed ^ row * 0x9E3779B1)
// ^ col) (murmur3's finalizer), which the plain version computes with int64
// tensor ops: the two agree bit for bit too.
//
// Design. Both kernels are bound by bytes: at 1M x 768 the quantizer reads
// 3.07 GB and writes 0.77 GB, 1.15 ms at 3.35 TB/s, and the dequantizer
// moves the same bytes the other way; the arithmetic is a few operations per
// element. The quantizer gives each row to one warp: a first pass reduces
// |x| with float4 loads and warp shuffles, a second pass re-reads the row
// (a 3 KB row is still in L1/L2) and writes four codes per lane and
// iteration. The dequantizer is a grid-stride loop over 16 codes per thread
// (one 16-byte load, four 16-byte stores). Rows whose width or address does
// not allow vector access take a scalar loop of the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr float kEps = 1e-8f;

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
  const float scale = fmaxf(amax, kEps) / 127.0f;
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

// values: (N, D) int8; scales: (N,) f32; out: (N, D) f32.
// kVec: D % 16 == 0, values and out 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows_kernel(const int8_t* __restrict__ values,
                           const float* __restrict__ scales,
                           float* __restrict__ out, long long N, int D) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    const long long n16 = N * D / 16;
    for (; i < n16; i += stride) {
      const long long e = i * 16;
      const float s = scales[e / D];
      const int4 raw = reinterpret_cast<const int4*>(values)[i];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      float4* o = reinterpret_cast<float4*>(out + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = make_float4(__fmul_rn(static_cast<float>(b[4 * j]), s),
                           __fmul_rn(static_cast<float>(b[4 * j + 1]), s),
                           __fmul_rn(static_cast<float>(b[4 * j + 2]), s),
                           __fmul_rn(static_cast<float>(b[4 * j + 3]), s));
      }
    }
  } else {
    const long long total = N * D;
    for (; i < total; i += stride) {
      out[i] = __fmul_rn(static_cast<float>(values[i]), scales[i / D]);
    }
  }
}

unsigned grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
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
  const long long total = static_cast<long long>(N) * D;
  const int8_t* v = static_cast<const int8_t*>(values);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (D % 16 == 0 && aligned(values, 16) && aligned(out, 16)) {
    dequantize_rows_kernel<true>
        <<<grid_for(total / 16), kThreads, 0, s>>>(v, sc, o, N, D);
  } else {
    dequantize_rows_kernel<false>
        <<<grid_for(total), kThreads, 0, s>>>(v, sc, o, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
