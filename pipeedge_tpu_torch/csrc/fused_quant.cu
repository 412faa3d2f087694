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
//   1. pe_encode_kernel: one launch, grid (C, B) in clusters of (C, 1, 1):
//      the C blocks of a cluster share one item (C up to 16, a non-portable
//      cluster size; ops/fused_quant.py ENCODE_CLUSTER picks 8, which timed
//      faster than 16 on the H100). Slices are whole groups of 32 floats
//      (16 bytes of output words at 4 bits, 32 at 8; encode_slices chooses
//      them). Each block starts copying its slice into shared memory with
//      16-byte cp.async, announces itself to the cluster under the copies,
//      and reduces its copies to a partial (min, max), which it writes
//      into every block's shared memory (distributed shared memory); after
//      one more cluster barrier each block folds the C partials locally and
//      packs its slice from shared memory into 16-byte word stores. x is
//      read from device memory once, and no second kernel waits on the
//      first one's tail. (The first design took two launches: a min/max
//      pass over 19 chunks per item, then a pack pass that re-read x from
//      L2.) The pack is most of the kernel's work: per element a subtract,
//      a division and a rounding, so the division uses one reciprocal per
//      block (div_rn) and the rounding an add, both exact, and the words
//      are assembled by byte permutes (pack_word).
//      A slice larger than the shared-memory budget (kMaxTile floats) is
//      walked in tiles by the same code: the reduction streams them, and
//      the pack reads each tile again from device memory. When the slice
//      is one tile, the pack finds it still in shared memory.
//   2. pe_unpack_kernel: one thread per word, 16-byte vector stores.
//
// Bit identity with the plain PyTorch ops (ops/quant.py) on the same input:
//   - scale = max(x) - shift equals max(x - shift) exactly, because rounding
//     x - shift is monotone in x; so one pass over min and max suffices,
//     and min and max are exact in any order of folding;
//   - q rounds half to even, like torch.round (not roundf): the encode
//     adds 1.5 * 2^23 in f32, which rounds exactly as rintf on [0, 2^22);
//   - the encode's division is correctly rounded (div_rn, or __fdiv_rn
//     outside div_rn's range), as IEEE division is;
//   - every product, quotient and sum uses the _rn intrinsics, so nvcc
//     cannot contract q / L * s + h into an FMA and the division stays IEEE
//     whatever the build flags.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // unpack
constexpr int kEncThreads = 512;       // encode
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kGroup = 32;          // floats per slice unit
constexpr int64_t kMaxTile = 24576;     // floats of a slice held (96 KB)
constexpr int kMaxCluster = 16;

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
}

// Block-wide (min, max) over kEncThreads threads; every thread gets it.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kEncThreads / 32], s_hi[kEncThreads / 32];
  warp_minmax(lo, hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = lane < kEncThreads / 32 ? s_lo[lane] : INFINITY;
  hi = lane < kEncThreads / 32 ? s_hi[lane] : -INFINITY;
  warp_minmax(lo, hi);
}

// rintf(v) for 0 <= v < 2^22, in the low mantissa bits of the result's
// bit pattern: adding 1.5 * 2^23 rounds v to an integer, half to even (one
// add in place of two quarter-rate conversions). kRounded0 is the pattern
// of a rounded 0.
constexpr uint32_t kRounded0 = 0x4B400000u;
__device__ __forceinline__ uint32_t rint_bits(float v) {
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

// One packed word from the rint_bits of its 32 / BIT codes: value j in
// bits [j * BIT, (j + 1) * BIT), by byte permutes (and, at 4 bits, one
// shift-add per pair of nibbles: the low byte of y0 + (y1 << 4) is
// q0 + 16 q1, since q1 < 16).
template <int BIT>
__device__ __forceinline__ uint32_t pack_word(const uint32_t* y);
template <>
__device__ __forceinline__ uint32_t pack_word<8>(const uint32_t* y) {
  return __byte_perm(__byte_perm(y[0], y[1], 0x0040),
                     __byte_perm(y[2], y[3], 0x0040), 0x5410);
}
template <>
__device__ __forceinline__ uint32_t pack_word<4>(const uint32_t* y) {
  const uint32_t b[4] = {y[0] + (y[1] << 4), y[2] + (y[3] << 4),
                         y[4] + (y[5] << 4), y[6] + (y[7] << 4)};
  return pack_word<8>(b);
}

// a / b rounded to nearest, as __fdiv_rn gives it, from r = 1/b rounded
// to nearest: q = a * r is within an ulp of a / b, e = a - q * b is exact
// (one FMA), and q + e * r rounded once is the correctly rounded quotient
// (Markstein's theorem), for b in [2^-60, 2^60] and 0 <= a <= b, where no
// step overflows or loses e to underflow. Two FMAs and a multiply in
// place of a division subroutine per element.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Start copying m floats of src into s_x. Each thread copies the 16-byte
// chunks c = threadIdx.x + k * kEncThreads (vec: m % 4 == 0, src 16-byte
// aligned) or the single floats at those indices, and may read them
// without a barrier once it has waited for them (wait_copies).
__device__ __forceinline__ void copy_tile(float* s_x, const float* src,
                                          int m, int vec) {
  if (vec) {
    for (int c = threadIdx.x; c < m / 4; c += kEncThreads)
      cp_async16(s_x + 4 * c, src + 4 * c);
  } else {
    for (int c = threadIdx.x; c < m; c += kEncThreads)
      cp_async4(s_x + c, src + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x [B, n] -> data [B, words], scale/shift [B]. Block (rank, b) holds
// item b's floats [rank * slice, min(n, (rank + 1) * slice)), slice a
// multiple of kGroup; tile = min(slice, kMaxTile) floats of dynamic
// shared memory.
template <int BIT>
__global__ void __launch_bounds__(kEncThreads)
pe_encode_kernel(const float* __restrict__ x, uint32_t* __restrict__ data,
                 float* __restrict__ scale_out, float* __restrict__ shift_out,
                 int64_t n, int64_t words, int64_t slice, int64_t tile,
                 int vec) {
  constexpr int kPerWord = 32 / BIT;
  extern __shared__ __align__(16) float s_x[];
  __shared__ float s_rank_lo[kMaxCluster], s_rank_hi[kMaxCluster];
  const int rank = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int ranks = (int)gridDim.x;
  const float* item = x + (int64_t)b * n;
  const int64_t s0 = min(n, (int64_t)rank * slice);
  const int64_t s1 = min(n, s0 + slice);
  const int tiles = (int)((s1 - s0 + tile - 1) / tile);
  cg::cluster_group cluster = cg::this_cluster();

  float lo = INFINITY, hi = -INFINITY;
  for (int i = 0; i < tiles; ++i) {
    const int64_t t0 = s0 + (int64_t)i * tile;
    const int m = (int)min(tile, s1 - t0);
    copy_tile(s_x, item + t0, m, vec);
    // announce that this block has started (its shared memory may be
    // written by a peer once every block has); the matching wait comes
    // just before the first remote write
    if (i == 0) cluster_arrive_relaxed();
    wait_copies();
    if (vec) {  // this thread's own chunks
      const float4* v = reinterpret_cast<const float4*>(s_x);
      for (int c = t; c < m / 4; c += kEncThreads) {
        const float4 f = v[c];
        lo = fminf(fminf(lo, f.x), fminf(f.y, fminf(f.z, f.w)));
        hi = fmaxf(fmaxf(hi, f.x), fmaxf(f.y, fmaxf(f.z, f.w)));
      }
    } else {
      for (int c = t; c < m; c += kEncThreads) {
        lo = fminf(lo, s_x[c]);
        hi = fmaxf(hi, s_x[c]);
      }
    }
  }
  if (tiles == 0) cluster_arrive_relaxed();  // an empty slice too
  block_minmax(lo, hi);   // its barrier also publishes s_x to the block

  // hand this block's (min, max) to every rank of the cluster, then fold
  // the ranks' partials from local shared memory
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (t < ranks) {
    cluster.map_shared_rank(s_rank_lo, t)[rank] = lo;
    cluster.map_shared_rank(s_rank_hi, t)[rank] = hi;
  }
  cluster.sync();
  float mn = INFINITY, mx = -INFINITY;
  for (int rk = 0; rk < ranks; ++rk) {
    mn = fminf(mn, s_rank_lo[rk]);
    mx = fmaxf(mx, s_rank_hi[rk]);
  }
  const float shift = mn;
  const float sc = __fsub_rn(mx, shift);
  if (rank == 0 && t == 0) {
    scale_out[b] = sc;
    shift_out[b] = shift;
  }
  const float safe = sc > 0.f ? sc : 1.f;
  const float rcp = __frcp_rn(safe);
  const bool fast_div = safe >= 0x1p-60f && safe <= 0x1p60f;
  const float levels = (float)((1u << BIT) - 1u);
  uint32_t* dst = data + (int64_t)b * words;
  const bool store16 = (words & 3) == 0;   // every item's words aligned

  for (int i = 0; i < tiles; ++i) {
    const int64_t t0 = s0 + (int64_t)i * tile;
    const int m = (int)min(tile, s1 - t0);
    if (tiles > 1) {  // the slice did not fit: read this tile again
      __syncthreads();
      copy_tile(s_x, item + t0, m, vec);
      wait_copies();
      __syncthreads();
    }
    const int nw = (m + kPerWord - 1) / kPerWord;
    uint32_t* tdst = dst + t0 / kPerWord;   // 16-byte aligned: t0 % 32 == 0
    for (int base = 0; base < nw; base += kEncThreads) {
      const int w = base + t;
      uint32_t word = 0;
      if (w < nw) {
        const float4* v = reinterpret_cast<const float4*>(s_x + w * kPerWord);
        uint32_t y[kPerWord];
#pragma unroll
        for (int j4 = 0; j4 < kPerWord / 4; ++j4) {
          const float4 f = v[j4];
          const float vals[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * j4 + k;
            const float a = __fsub_rn(vals[k], shift);
            const float x01 =
                fast_div ? div_rn(a, safe, rcp) : __fdiv_rn(a, safe);
            // the packed tail holds zeros
            y[j] = w * kPerWord + j < m ? rint_bits(__fmul_rn(x01, levels))
                                        : kRounded0;
          }
        }
        word = pack_word<BIT>(y);
      }
      // lanes 4k..4k+3 hand their words to lane 4k: one 16-byte store
      const uint32_t w1 = __shfl_down_sync(kFull, word, 1);
      const uint32_t w2 = __shfl_down_sync(kFull, word, 2);
      const uint32_t w3 = __shfl_down_sync(kFull, word, 3);
      const int wq = w - (t & 3);
      if (store16 && wq + 3 < nw) {
        if ((t & 3) == 0)
          *reinterpret_cast<uint4*>(tdst + w) = make_uint4(word, w1, w2, w3);
      } else if (w < nw) {
        tdst[w] = word;
      }
    }
  }
}

template <int BIT>
int launch_encode(const float* x, uint32_t* data, float* scale, float* shift,
                  int64_t B, int64_t n, int clusters, int64_t slice, int vec,
                  cudaStream_t stream) {
  constexpr int64_t kPerWord = 32 / BIT;
  const int64_t words = (n + kPerWord - 1) / kPerWord;
  const int64_t tile = slice < kMaxTile ? slice : kMaxTile;
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        pe_encode_kernel<BIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxTile * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(pe_encode_kernel<BIT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
    attributes_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters, (unsigned)B);
  cfg.blockDim = dim3(kEncThreads);
  cfg.dynamicSmemBytes = (size_t)(tile * sizeof(float));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, pe_encode_kernel<BIT>, x, data, scale,
                                 shift, n, words, slice, tile, vec);
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
// One cluster launch of `clusters` blocks per item, each taking `slice`
// floats (a multiple of 32; clusters * slice >= n). vec: n % 4 == 0 and x
// is 16-byte aligned. data is a fresh (256-byte aligned) allocation.
int pe_fused_encode(const void* x, void* data, void* scale, void* shift,
                    int64_t B, int64_t n, int bit, int clusters,
                    int64_t slice, int vec, void* stream) {
  if (B <= 0 || n <= 0 || B > 65535 || clusters < 1 ||
      clusters > kMaxCluster || slice <= 0 || slice % kGroup ||
      (int64_t)clusters * slice < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint32_t* d = static_cast<uint32_t*>(data);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  int rc;
  if (bit == 8) {
    rc = launch_encode<8>(xf, d, sc, sh, B, n, clusters, slice, vec, s);
  } else if (bit == 4) {
    rc = launch_encode<4>(xf, d, sc, sh, B, n, clusters, slice, vec, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
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
