// Block-scaled int8 matmul for Hopper (sm_90a): s8 x s8 -> s32 on the
// tensor cores per k-block, f32 fold of the block scales.
//
// Replaces the Pallas kernel of pipeedge_tpu/ops/int8_matmul.py:
//   _matmul_kernel (:106, wrapped by matmul_pallas :129)
//
// Computes y[m, n] = ws[n] * sum_kb xs[m, kb] * (sum_{k in kb} x[m, k] w[k, n])
// over int8 codes x [M, K] and w (read as wt [N, K], K contiguous), f32
// activation scales xs [M, K / bk] (any strides) and channel scales ws [N],
// f32 out [M, N].
//
// What bounds it on the card: at the ViT-Base shapes (M = 1576, K and N of
// 768 and 3072), mostly bytes: the f32 output alone is 4-5x the int8
// inputs, and at 1979 TOPS the products take about as long as the output
// write at 3.35 TB/s. This first version does not reach either bound:
// mma.sync (not wgmma), cp.async (not TMA), one 128 x 128 tile per block.
//
// Design. The TPU kernel carries an f32 VMEM accumulator across a
// sequential k grid axis; here the k axis is a loop inside the block. A
// block of 8 warps owns a 128 x 128 output tile (each warp 64 x 32, i.e.
// 4 x 4 mma.m16n8k32 tiles). Each step stages 32 bytes of k of the A and B
// tiles in shared memory (3-stage cp.async ring, rows padded to 48 bytes so
// the fragment loads hit 32 distinct banks), and the warps accumulate the
// k-block's product in int32 fragments, which is exact. After the last step
// of a k-block each fragment folds into the f32 accumulator as
// acc = __fadd_rn(acc, __fmul_rn((float)iacc, xs[row, kb])) and is zeroed;
// the epilogue is __fmul_rn(acc, ws[col]). The _rn intrinsics forbid FMA
// contraction, so the result equals the plain version (ops/int8_matmul.py
// matmul_reference) bit for bit.
//
// Edges: ragged M and N are zero-filled on load and masked on store. A
// block_k that is not a multiple of 32 (e.g. K = 100 taken whole) is
// zero-padded in shared memory: zero bytes of B add exactly 0, whatever A
// holds there. When K, bk and the pointers allow 16-byte copies the tiles
// move with cp.async; otherwise each thread gathers its 16 bytes one by one.
// `flip` reads every activation byte as byte ^ 0x80: the 8-bit wire codes
// q in 0..255 become q - 128 in int8 (-128 included), so the stage-seam
// tunnel feeds the packed words' bytes in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kStep = 32;      // bytes of k per step (one mma k)
constexpr int kPitch = 48;     // shared row pitch in bytes (32 + 16 pad)
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 (m) x 4 (n)
constexpr int kWM = 64;        // rows per warp
constexpr int kWN = 32;        // columns per warp
constexpr int kMT = kWM / 16;  // m16 tiles per warp
constexpr int kNT = kWN / 8;   // n8 tiles per warp

struct Smem {
  alignas(16) int8_t a[kStages][kBM * kPitch];
  alignas(16) int8_t b[kStages][kBN * kPitch];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte piece per thread of a [128 rows x 32 bytes] tile: row
// threadIdx.x / 2, half threadIdx.x % 2. Bytes at k >= kvalid within the
// step, and rows >= rows, are zero.
template <bool kVec>
__device__ __forceinline__ void load_tile(int8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int rows, int64_t K, int row0,
                                          int64_t kbase, int kvalid) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int grow = row0 + r;
  int8_t* d = dst + r * kPitch + h * 16;
  if (kVec) {  // kvalid is a multiple of 16: a piece is all in or all out
    const bool ok = grow < rows && h * 16 < kvalid;
    const int8_t* g = ok ? src + (int64_t)grow * K + kbase + h * 16 : src;
    cp_async16(d, g, ok ? 16 : 0);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = h * 16 + q * 4 + j;
        if (grow < rows && kk < kvalid)
          v |= (uint32_t)(uint8_t)src[(int64_t)grow * K + kbase + kk]
               << (8 * j);
      }
      w[q] = v;
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    pe_int8_matmul_kernel(const int8_t* __restrict__ x,
                          const float* __restrict__ xs,
                          const int8_t* __restrict__ wt,
                          const float* __restrict__ ws,
                          float* __restrict__ out, int M, int N, int64_t K,
                          int bk, int64_t xs_rs, int64_t xs_cs,
                          uint32_t flip) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int chunks = (bk + kStep - 1) / kStep;  // steps per k-block
  const int64_t steps = (K / bk) * chunks;

  float acc[kMT][kNT][4];
  int32_t iacc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        iacc[i][j][e] = 0;
      }

  auto prefetch = [&](int64_t step) {
    if (step < steps) {
      const int64_t kb = step / chunks;
      const int c = (int)(step - kb * chunks);
      const int64_t kbase = kb * bk + (int64_t)c * kStep;
      const int kvalid = min(kStep, bk - c * kStep);
      const int slot = (int)(step % kStages);
      load_tile<kVec>(sm.a[slot], x, M, K, m0, kbase, kvalid);
      load_tile<kVec>(sm.b[slot], wt, N, K, n0, kbase, kvalid);
    }
    if (kVec) cp_async_commit();  // an empty group keeps the count even
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  for (int64_t step = 0; step < steps; ++step) {
    if (kVec) cp_async_wait<kStages - 2>();
    __syncthreads();  // the step's tile is in; the slot refilled below is free
    prefetch(step + kStages - 1);
    const int slot = (int)(step % kStages);
    const int8_t* sa = sm.a[slot] + (wm * kWM) * kPitch;
    const int8_t* sb = sm.b[slot] + (wn * kWN) * kPitch;
    uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int8_t* p = sa + (i * 16 + g) * kPitch + t * 4;
      af[i][0] = lds32(p) ^ flip;
      af[i][1] = lds32(p + 8 * kPitch) ^ flip;
      af[i][2] = lds32(p + 16) ^ flip;
      af[i][3] = lds32(p + 8 * kPitch + 16) ^ flip;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int8_t* p = sb + (j * 8 + g) * kPitch + t * 4;
      bf[j][0] = lds32(p);
      bf[j][1] = lds32(p + 16);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_s8(iacc[i][j], af[i], bf[j]);

    if ((step + 1) % chunks == 0) {  // the k-block is complete: fold it
      const int64_t kb = step / chunks;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + wm * kWM + i * 16 + g + hr * 8;
          const float s = row < M ? __ldg(xs + row * xs_rs + kb * xs_cs) : 0.f;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = hr * 2 + e;
              acc[i][j][idx] = __fadd_rn(
                  acc[i][j][idx], __fmul_rn((float)iacc[i][j][idx], s));
              iacc[i][j][idx] = 0;
            }
        }
    }
  }
  if (kVec) cp_async_wait<0>();

  const bool pairs = (N % 2) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * kWM + i * 16 + g + hr * 8;
      if (row >= M) continue;
      float* orow = out + (int64_t)row * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + j * 8 + t * 2;
        if (col >= N) continue;
        const float v0 = __fmul_rn(acc[i][j][hr * 2], __ldg(ws + col));
        if (pairs) {  // col is even and N is even: col + 1 < N
          const float v1 =
              __fmul_rn(acc[i][j][hr * 2 + 1], __ldg(ws + col + 1));
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          orow[col] = v0;
          if (col + 1 < N)
            orow[col + 1] = __fmul_rn(acc[i][j][hr * 2 + 1], __ldg(ws + col + 1));
        }
      }
    }
}

}  // namespace

extern "C" {

// x int8 (or the uint8 wire bytes with flip = 1) [M, K] and wt int8 [N, K],
// both contiguous; xs f32 [M, K / bk] with strides (xs_rs, xs_cs); ws f32
// [N] contiguous; out f32 [M, N] contiguous.
int pe_int8_matmul(const void* x, const void* xs, const void* wt,
                   const void* ws, void* out, int64_t M, int64_t N, int64_t K,
                   int64_t bk, int64_t xs_rs, int64_t xs_cs, int flip,
                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || K % bk ||
      M > 2147483647 || N > 2147483647 || bk > 2147483647)
    return (int)cudaErrorInvalidValue;
  const int64_t gy = (M + kBM - 1) / kBM, gx = (N + kBN - 1) / kBN;
  if (gy > 65535 || gx > 2147483647) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && bk % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* xsp = static_cast<const float*>(xs);
  const float* wsp = static_cast<const float*>(ws);
  float* op = static_cast<float*>(out);
  const uint32_t mask = flip ? 0x80808080u : 0u;
  if (vec) {
    pe_int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(
        xp, xsp, wp, wsp, op, (int)M, (int)N, K, (int)bk, xs_rs, xs_cs, mask);
  } else {
    pe_int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(
        xp, xsp, wp, wsp, op, (int)M, (int)N, K, (int)bk, xs_rs, xs_cs, mask);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
