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
//      Each block folds with NaN-propagating min and max (min.NaN), as
//      the plain ops do, and an item whose scale or shift is not finite
//      (NaN, an infinity, or a range past the f32 maximum) takes a second
//      pack path (SAT) whose codes go through XLA's saturating f32 ->
//      uint32 convert; the branch is uniform over the cluster, so finite
//      items keep the byte-permute path. B past the grid's 65535 is
//      launched in chunks by the wrapper: a 1-D grid of C * B blocks,
//      which lifts the limit in the kernel, ran slower on the H100 at
//      the main shape.
//   2. pe_decode_kernel. What bounds it is bytes too (the words in, 32/bit
//      times as many f32 out), but the first design (one thread per word,
//      grid (words/256, B)) spent its time elsewhere: an __fdiv_rn
//      subroutine per value, 1184 blocks at the main shape (a partial
//      second wave of 128), and gridDim.y = B, which capped B at 65535.
//      Now each thread step writes one float4 (a warp 512 contiguous
//      bytes) from one word load; the codes become exact floats by a byte
//      permute (8 bits) or a shift and mask (4 bits) into the mantissa of
//      2^23 and one subtract; q / L is div_rn with one reciprocal per
//      thread (exact for 0 <= q <= L); and at most one wave of blocks
//      walks the (item, float4) pairs in a grid-stride loop, the item
//      from a multiply-high division, so B has no launch limit. (A chunk
//      of 4 words per thread, one 16-byte load, wrote 64 or 128 bytes per
//      thread, so a warp's stores spread over 2-4 KB: on the H100 it ran
//      slower than the word-per-thread kernel it was to replace.)
//
// Bit identity with the plain PyTorch ops (ops/quant.py) on the same input:
//   - scale = max(x) - shift equals max(x - shift) exactly, because rounding
//     x - shift is monotone in x; so one pass over min and max suffices,
//     and min and max are exact in any order of folding;
//   - q rounds half to even, like torch.round (not roundf): the encode
//     adds 1.5 * 2^23 in f32, which rounds exactly as rintf on [0, 2^22);
//   - the encode's division is correctly rounded (div_rn, or __fdiv_rn
//     outside div_rn's range), as IEEE division is, and so is the
//     decode's q / L (div_rn);
//   - non-finite input: min and max propagate NaN, scale is NaN where
//     shift is -inf (max(x - shift) meets -inf - -inf), and the codes of
//     such items saturate as XLA's convert does (see pack_slice);
//   - every product, quotient and sum uses the _rn intrinsics, so nvcc
//     cannot contract q / L * s + h into an FMA and the division stays IEEE
//     whatever the build flags.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;          // decode
constexpr int kEncThreads = 512;       // encode
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kGroup = 32;          // floats per slice unit
constexpr int64_t kMaxTile = 24576;     // floats of a slice held (96 KB)
constexpr int kMaxCluster = 16;

// min and max that propagate NaN, as torch.amin / amax and jnp.min / max
// do (fminf / fmaxf skip it): one instruction each on sm_80 and later
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(kFull, hi, off));
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

// XLA's f32 -> uint32 convert, which the plain encode applies to its
// rounded codes: NaN -> 0, below 0 -> 0, 2^32 and above -> 0xFFFFFFFF.
__device__ __forceinline__ uint32_t saturate_u32(float v) {
  return v != v ? 0u : v >= 4294967296.f ? 0xffffffffu
                     : v > 0.f ? (uint32_t)v : 0u;
}

// Pack block `rank`'s slice [s0, s1) of one item into the item's words
// dst, tile by tile (when the slice is one tile, it is still in shared
// memory from the reduction). SAT: the item's scale or shift is not
// finite, so a quotient may be NaN, infinite or past 2^b - 1; each code
// then takes the saturating convert and the word is the OR of the shifted
// codes cut to 32 bits, as the plain encode packs them. With a finite
// scale and shift every quotient lies in [0, 1] and the codes in [0, 2^b
// - 1], where that is the byte-permute pack.
template <int BIT, bool SAT>
__device__ __forceinline__ void pack_slice(float* s_x, const float* item,
                                           uint32_t* dst, int64_t s0,
                                           int64_t s1, int64_t tile,
                                           int tiles, int vec, float shift,
                                           float safe, bool store16) {
  constexpr int kPerWord = 32 / BIT;
  const int t = threadIdx.x;
  const float rcp = __frcp_rn(safe);
  const bool fast_div = safe >= 0x1p-60f && safe <= 0x1p60f;
  const float levels = (float)((1u << BIT) - 1u);
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
            const bool live = w * kPerWord + j < m;  // the tail packs zeros
            if constexpr (SAT) {
              y[j] = live ? saturate_u32(rintf(
                                __fmul_rn(__fdiv_rn(a, safe), levels)))
                          : 0u;
            } else {
              const float x01 =
                  fast_div ? div_rn(a, safe, rcp) : __fdiv_rn(a, safe);
              y[j] = live ? rint_bits(__fmul_rn(x01, levels)) : kRounded0;
            }
          }
        }
        if constexpr (SAT) {
#pragma unroll
          for (int j = 0; j < kPerWord; ++j) word |= y[j] << (j * BIT);
        } else {
          word = pack_word<BIT>(y);
        }
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
        lo = min_nan(min_nan(lo, f.x), min_nan(f.y, min_nan(f.z, f.w)));
        hi = max_nan(max_nan(hi, f.x), max_nan(f.y, max_nan(f.z, f.w)));
      }
    } else {
      for (int c = t; c < m; c += kEncThreads) {
        lo = min_nan(lo, s_x[c]);
        hi = max_nan(hi, s_x[c]);
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
    mn = min_nan(mn, s_rank_lo[rk]);
    mx = max_nan(mx, s_rank_hi[rk]);
  }
  const float shift = mn;
  // max(x - shift) is max(x) - shift, but for shift = -inf, where the
  // min element's -inf - -inf makes it NaN
  const float sc = shift == -INFINITY ? __int_as_float(0x7fc00000)
                                      : __fsub_rn(mx, shift);
  if (rank == 0 && t == 0) {
    scale_out[b] = sc;
    shift_out[b] = shift;
  }
  const float safe = sc > 0.f ? sc : 1.f;
  uint32_t* dst = data + (int64_t)b * words;
  const bool store16 = (words & 3) == 0;   // every item's words aligned
  // uniform across the block (and the cluster): one item
  if (isfinite(sc) && isfinite(shift))
    pack_slice<BIT, false>(s_x, item, dst, s0, s1, tile, tiles, vec, shift,
                           safe, store16);
  else
    pack_slice<BIT, true>(s_x, item, dst, s0, s1, tile, tiles, vec, shift,
                          safe, store16);
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

// x / d for 0 <= x < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery; CUTLASS's FastDivmod): p = 31 + ceil(log2 d), mul =
// ceil(2^p / d) < 2^32, and x / d = umulhi(x, mul) >> (p - 32); d = 1
// divides by copying.
struct FastDiv {
  uint32_t d, mul, shr;
};
FastDiv make_fast_div(uint32_t d) {
  if (d == 1) return {1u, 0u, 0u};
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint32_t p = 31 + l;
  return {d, (uint32_t)(((1ull << p) + d - 1) / d), p - 32};
}
__device__ __forceinline__ uint32_t divide(uint32_t x, FastDiv f) {
  return f.d == 1 ? x : __umulhi(x, f.mul) >> f.shr;
}

// Code j of a word as an exact float, with no conversion instruction: the
// code becomes the low mantissa bits of 2^23 (a byte permute at 8 bits, a
// shift and mask at 4), and one subtract of 2^23 leaves it.
template <int BIT>
__device__ __forceinline__ float code_of(uint32_t word, int j);
template <>
__device__ __forceinline__ float code_of<8>(uint32_t word, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | j)),
      8388608.f);
}
template <>
__device__ __forceinline__ float code_of<4>(uint32_t word, int j) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((word >> (4 * j)) & 15u)),
                   8388608.f);
}

// data [B, words] -> out [B, n]. Each step of a thread writes float4 f of
// item b, flat index b * n4 + f, from one word (two float4 share a word at
// 4 bits). Each value is rn(rn(rn(q / L) * scale) + shift), the plain
// decode's ops.
template <int BIT>
__global__ void __launch_bounds__(kThreads)
pe_decode_kernel(const uint32_t* __restrict__ data,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ out,
                 int64_t n, int64_t words, uint32_t n4, uint32_t total,
                 FastDiv per_item, int vec) {
  constexpr int kF4 = 8 / BIT;            // float4 per word: 1, or 2
  const float levels = (float)((1u << BIT) - 1u);
  const float rcp = __frcp_rn(levels);
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t g = blockIdx.x * kThreads + threadIdx.x; g < total;
       g += stride) {
    const uint32_t b = divide(g, per_item);
    const uint32_t f = g - b * n4;
    uint32_t word = __ldg(data + (int64_t)b * words + f / kF4);
    if constexpr (kF4 > 1) word >>= 16 * (f % kF4);  // this float4's nibbles
    const float sc = __ldg(scale + b), sh = __ldg(shift + b);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __fadd_rn(
          __fmul_rn(div_rn(code_of<BIT>(word, j), levels, rcp), sc), sh);
    const int64_t e0 = 4 * (int64_t)f;
    float* dst = out + (int64_t)b * n + e0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j < n) dst[j] = v[j];
    }
  }
}

// One float4 per thread, at most the blocks the card holds at once (one
// wave), which then loop.
template <int BIT>
int launch_decode(const uint32_t* d, const float* sc, const float* sh,
                  float* o, int64_t B, int64_t n, int vec, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pe_decode_kernel<BIT>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
  }
  constexpr int64_t kPerWord = 32 / BIT;
  const int64_t n4 = (n + 3) / 4;
  const int64_t total = n4 * B;
  if (total >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const int64_t need = (total + kThreads - 1) / kThreads;
  pe_decode_kernel<BIT><<<(int)(need < resident ? need : resident), kThreads,
                          0, s>>>(
      d, sc, sh, o, n, (n + kPerWord - 1) / kPerWord, (uint32_t)n4,
      (uint32_t)total, make_fast_div((uint32_t)n4), vec);
  return 0;
}

}  // namespace

extern "C" {

const char* pe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x f32 [B, n] contiguous -> data uint32 [B, words], scale/shift f32 [B],
// B <= 65535 (ops/fused_quant.py launches more items in chunks).
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

// data uint32 [B, words], scale/shift f32 [B] -> out f32 [B, n]. vec: n %
// 4 == 0 (out is a fresh, 256-byte aligned allocation). B * ceil(n / 4) <
// 2^31.
int pe_fused_decode(const void* data, const void* scale, const void* shift,
                    void* out, int64_t B, int64_t n, int bit, int vec,
                    void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* o = static_cast<float*>(out);
  int rc;
  if (bit == 8) {
    rc = launch_decode<8>(d, sc, sh, o, B, n, vec, s);
  } else if (bit == 4) {
    rc = launch_decode<4>(d, sc, sh, o, B, n, vec, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
