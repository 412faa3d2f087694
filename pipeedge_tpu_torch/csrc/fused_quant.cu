// QuantPipe edge codec for Hopper (sm_90a): per-item encode and decode.
//
// Replaces the Pallas kernels of pipeedge_tpu/ops/fused_quant.py:
//   _encode_kernel (:70, wrapped by fused_encode_outerdim :115)
//   _decode_kernel (:99, wrapped by fused_decode_outerdim :153)
//
// What bounds them on the card: bytes. Encode reads the f32 activation once
// and writes 32/bit times fewer bytes; decode the reverse. There is about
// one arithmetic operation per byte, far below the ~20 FLOP/byte at which
// the H100's f32 units would become the limit.
//
// Design. The TPU kernel gives one grid cell to each item (grid=(b,)); at a
// microbatch of 8 that would fill 8 of the card's 132 SMs. Here:
//   1. pe_minmax_kernel: grid (chunks, B). Each block reduces `chunk`
//      contiguous values of one item to a partial (min, max).
//   2. pe_pack_kernel: grid (word blocks, B). Each block first folds the
//      item's partials into (shift, scale), then each thread quantizes and
//      packs ONE output word from `per_word` contiguous floats (16-byte
//      vector loads where the item length allows).
//   3. pe_unpack_kernel: one thread per word, 16-byte vector stores.
//
// Bit identity with the plain PyTorch ops (ops/quant.py) on the same input:
//   - scale = max(x) - shift equals max(x - shift) exactly, because rounding
//     x - shift is monotone in x; so one pass over min and max suffices;
//   - q = rintf(...) rounds half to even, like torch.round (not roundf);
//   - every product, quotient and sum uses the _rn intrinsics, so nvcc
//     cannot contract q / L * s + h into an FMA and the division stays IEEE
//     whatever the build flags.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Block-wide (min, max); every thread gets the result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
  warp_minmax(lo, hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = lane < kThreads / 32 ? s_lo[lane] : INFINITY;
  hi = lane < kThreads / 32 ? s_hi[lane] : -INFINITY;
  warp_minmax(lo, hi);
}

// partial[b, c] = min, partial[b, chunks + c] = max of item b's chunk c.
__global__ void pe_minmax_kernel(const float* __restrict__ x,
                                 float* __restrict__ partial, int64_t n,
                                 int64_t chunk, int chunks, int vec) {
  const int b = blockIdx.y, c = blockIdx.x;
  const float* item = x + (int64_t)b * n;
  const int64_t start = (int64_t)c * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  float lo = INFINITY, hi = -INFINITY;
  if (vec) {  // n % 4 == 0 and 16-byte aligned; chunk is a multiple of 4
    const float4* v = reinterpret_cast<const float4*>(item);
    for (int64_t i = start / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const float4 f = __ldg(v + i);
      lo = fminf(fminf(lo, f.x), fminf(f.y, fminf(f.z, f.w)));
      hi = fmaxf(fmaxf(hi, f.x), fmaxf(f.y, fmaxf(f.z, f.w)));
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
      const float f = __ldg(item + i);
      lo = fminf(lo, f);
      hi = fmaxf(hi, f);
    }
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    partial[(int64_t)b * 2 * chunks + c] = lo;
    partial[(int64_t)b * 2 * chunks + chunks + c] = hi;
  }
}

template <int BIT>
__global__ void pe_pack_kernel(const float* __restrict__ x,
                               const float* __restrict__ partial,
                               uint32_t* __restrict__ data,
                               float* __restrict__ scale_out,
                               float* __restrict__ shift_out, int64_t n,
                               int64_t words, int chunks, int vec) {
  constexpr int kPerWord = 32 / BIT;
  const int b = blockIdx.y;
  __shared__ float s_shift, s_scale;
  float lo = INFINITY, hi = -INFINITY;
  const float* part = partial + (int64_t)b * 2 * chunks;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    lo = fminf(lo, part[c]);
    hi = fmaxf(hi, part[chunks + c]);
  }
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    const float scale = __fsub_rn(hi, lo);
    s_shift = lo;
    s_scale = scale;
    if (blockIdx.x == 0) {
      scale_out[b] = scale;
      shift_out[b] = lo;
    }
  }
  __syncthreads();
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  const float shift = s_shift;
  const float safe = s_scale > 0.f ? s_scale : 1.f;
  const float levels = (float)((1u << BIT) - 1u);
  const float* item = x + (int64_t)b * n;
  const int64_t base = w * kPerWord;
  float vals[kPerWord];
  if (vec && base + kPerWord <= n) {
#pragma unroll
    for (int j = 0; j < kPerWord; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(item + base + j));
      vals[j] = f.x;
      vals[j + 1] = f.y;
      vals[j + 2] = f.z;
      vals[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerWord; ++j)
      vals[j] = base + j < n ? __ldg(item + base + j) : 0.f;
  }
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < kPerWord; ++j) {
    if (base + j < n) {  // the packed tail holds zeros
      const float x01 = __fdiv_rn(__fsub_rn(vals[j], shift), safe);
      const uint32_t q = (uint32_t)rintf(__fmul_rn(x01, levels));
      word |= q << (j * BIT);
    }
  }
  data[(int64_t)b * words + w] = word;
}

template <int BIT>
__global__ void pe_unpack_kernel(const uint32_t* __restrict__ data,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 float* __restrict__ out, int64_t n,
                                 int64_t words, int vec) {
  constexpr int kPerWord = 32 / BIT;
  const int b = blockIdx.y;
  const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  const uint32_t word = __ldg(data + (int64_t)b * words + w);
  const float sc = __ldg(scale + b), sh = __ldg(shift + b);
  const float levels = (float)((1u << BIT) - 1u);
  constexpr uint32_t kMask = (1u << BIT) - 1u;
  float vals[kPerWord];
#pragma unroll
  for (int j = 0; j < kPerWord; ++j) {
    const float q = (float)((word >> (j * BIT)) & kMask);
    vals[j] = __fadd_rn(__fmul_rn(__fdiv_rn(q, levels), sc), sh);
  }
  float* item = out + (int64_t)b * n;
  const int64_t base = w * kPerWord;
  if (vec && base + kPerWord <= n) {
#pragma unroll
    for (int j = 0; j < kPerWord; j += 4)
      *reinterpret_cast<float4*>(item + base + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerWord; ++j)
      if (base + j < n) item[base + j] = vals[j];
  }
}

}  // namespace

extern "C" {

const char* pe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x f32 [B, n] contiguous -> data uint32 [B, words], scale/shift f32 [B].
// partial: f32 scratch [B, 2 * ceil(n / chunk)]. vec: n % 4 == 0 and x is
// 16-byte aligned. chunk must be a multiple of 4.
int pe_fused_encode(const void* x, void* data, void* scale, void* shift,
                    void* partial, int64_t B, int64_t n, int bit,
                    int64_t chunk, int vec, void* stream) {
  if (B <= 0 || n <= 0 || chunk <= 0 || chunk % 4 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t per_word = 32 / bit;
  const int64_t words = (n + per_word - 1) / per_word;
  const int64_t word_blocks = (words + kThreads - 1) / kThreads;
  if (chunks > 2147483647 || word_blocks > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partial);
  pe_minmax_kernel<<<dim3((unsigned)chunks, (unsigned)B), kThreads, 0, s>>>(
      xf, pf, n, chunk, (int)chunks, vec);
  const dim3 grid((unsigned)word_blocks, (unsigned)B);
  uint32_t* d = static_cast<uint32_t*>(data);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  if (bit == 8) {
    pe_pack_kernel<8><<<grid, kThreads, 0, s>>>(xf, pf, d, sc, sh, n, words,
                                                (int)chunks, vec);
  } else if (bit == 4) {
    pe_pack_kernel<4><<<grid, kThreads, 0, s>>>(xf, pf, d, sc, sh, n, words,
                                                (int)chunks, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// data uint32 [B, words], scale/shift f32 [B] -> out f32 [B, n]. vec: n % 4
// == 0 (out is a fresh, 256-byte aligned allocation).
int pe_fused_decode(const void* data, const void* scale, const void* shift,
                    void* out, int64_t B, int64_t n, int bit, int vec,
                    void* stream) {
  if (B <= 0 || n <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int64_t per_word = 32 / bit;
  const int64_t words = (n + per_word - 1) / per_word;
  const int64_t word_blocks = (words + kThreads - 1) / kThreads;
  if (word_blocks > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)word_blocks, (unsigned)B);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* o = static_cast<float*>(out);
  if (bit == 8) {
    pe_unpack_kernel<8><<<grid, kThreads, 0, s>>>(d, sc, sh, o, n, words, vec);
  } else if (bit == 4) {
    pe_unpack_kernel<4><<<grid, kThreads, 0, s>>>(d, sc, sh, o, n, words, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
