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
// write at 3.35 TB/s.
//
// Two kernels, chosen on the host by (K, bk, alignment) alone
// (ops/int8_matmul.py `kernel_choice`):
//
// 1. pe_int8_matmul_wgmma_kernel, for bk a multiple of 32 and 16-byte
//    aligned operands (every shape of the ViT main path and the tunnel).
//    Warp-specialised: warp 8 is the producer, one lane of it keeps a ring
//    of kStages stages in flight with TMA (cp.async.bulk.tensor, 2D tensor
//    maps, zero fill past M and N), each stage W bytes of k of the A [128,
//    W] and B [BN, W] tiles, where W is the largest of 128, 64, 32 that
//    divides bk (128 on the main path: one stage is one k-block) and the
//    swizzle is W bytes wide to match the wgmma descriptors. Warps 0-7 are
//    two consumer warpgroups of 64 rows each, issuing
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 straight from shared memory (both
//    operands K-major, which is how x [M, K] and wt [N, K] lie). The first
//    wgmma of each k-block has scale-d = 0, so the int32 product starts
//    fresh with no zeroing pass and never runs past one k-block (the int32
//    headroom holds per block only). After wgmma.wait_group it folds into
//    the f32 accumulator as acc = __fadd_rn(acc, __fmul_rn((float)iacc,
//    xs[row, kb])) in k order, then releases the stage to the producer
//    through an mbarrier. The epilogue multiplies by ws[col] with
//    __fmul_rn and writes 16-byte stores: lanes t and t^1 swap halves so
//    each holds four consecutive columns of one row. Tiles are 128 x 128,
//    or 128 x 64 when 128 x 128 tiles would leave SMs idle (N = 768: 156
//    tiles at two blocks per SM, not 78). No setmaxnreg: the consumers'
//    128 accumulator registers fit under the cap __launch_bounds__ sets.
//    The tunnel's wire bytes (`flip`) are uint8 codes q read as q - 128:
//    TMA copies bytes as they are and wgmma reads shared memory, so each
//    consumer warpgroup XORs its own 64 rows of the A stage with 0x80 in
//    shared memory, fences the generic writes to the async proxy
//    (fence.proxy.async) and syncs its 128 threads before its wgmma. Of
//    the two exact ways to do it this one needs nothing from the host (the
//    other, u8 x s8 products less 128 times per-k-block weight column
//    sums, needs those sums per bk beside the folded weight); it costs a
//    pass over the A stage in shared memory on the one tunnelled dense.
//    The weight's tensor map is a pure function of (pointer, N, K, box), so
//    it is cached on those (a folded weight's pointer is fixed); only the
//    activation's map is encoded per call. cuTensorMapEncodeTiled comes
//    from the driver through cudaGetDriverEntryPointByVersion, so the
//    library links against the runtime only.
//
// 2. pe_int8_matmul_kernel (mma.sync), for the shapes the first does not
//    take: a bk that is not a multiple of 32 (K = 100 taken whole, K = 320
//    with bk 80), or rows not 16-byte aligned. A block of 8 warps owns a
//    128 x 128 output tile (each warp 64 x 32, i.e. 4 x 4
//    mma.m16n8k32 tiles). Each step stages 32 bytes of k of the A and B
//    tiles in shared memory (3-stage cp.async ring, rows padded to 48 bytes
//    so the fragment loads hit 32 distinct banks), and the warps accumulate
//    the k-block's product in int32 fragments, folded as above after the
//    block's last step. A block_k that is not a multiple of 32 is
//    zero-padded in shared memory: zero bytes of B add exactly 0, whatever A
//    holds there. When K, bk and the pointers allow 16-byte copies the tiles
//    move with cp.async; otherwise each thread gathers its 16 bytes one by
//    one. `flip` XORs each activation word with 0x80808080 in registers.
//
// Both fold each exact int32 k-block product with one rounded multiply and
// one rounded add, in k order, and the _rn intrinsics forbid FMA
// contraction, so each equals the plain version (ops/int8_matmul.py
// matmul_reference) bit for bit. Ragged M and N are zero-filled on load and
// masked on store in both.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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


// --- the wgmma kernel --------------------------------------------------------

constexpr int kWgBM = 128;             // output rows per block: 2 x 64
constexpr int kWgStages = 4;
constexpr int kWgThreads = 288;        // 2 consumer warpgroups + 1 producer
constexpr int kStageA = kWgBM * 128;   // bytes of one A stage at W = 128
constexpr int kScaleChunk = 16;        // k-blocks of scales staged at once

template <int BN>
constexpr int wg_smem_bytes() {
  return 1024 /* alignment slack */ + kWgStages * (kStageA + BN * 128) +
         2 * kWgStages * 8 + 8 * kScaleChunk * 16 * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase differs from `parity`; a wait of ~10 s
// (a lost arrival) traps, so it fails the launch instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// K-major operand of `rows` x W bytes at `p` (1024-byte aligned tile base,
// TMA's W-byte swizzle): no leading offset (one k32 step lies inside the
// swizzled row), stride 8 rows = 8 W bytes, layout 1/2/3 = 128/64/32 B.
__device__ __forceinline__ uint64_t wg_desc(const void* p, int W) {
  const uint64_t layout = W == 128 ? 1 : (W == 64 ? 2 : 3);
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * W) >> 4) << 32) | (layout << 62);
}

#define PE_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define PE_R16(i) PE_R4(i), PE_R4(i + 4), PE_R4(i + 8), PE_R4(i + 12)

template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : PE_R16(0), PE_R16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : PE_R16(0), PE_R16(16), PE_R16(32), PE_R16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef PE_R16
#undef PE_R4

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, BN == 64 ? 2 : 1)
    pe_int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                                const __grid_constant__ CUtensorMap tmw,
                                const float* __restrict__ xs,
                                const float* __restrict__ ws,
                                float* __restrict__ out, int M, int N,
                                int steps, int W, int steps_per_kb,
                                int64_t xs_rs, int64_t xs_cs, int flip) {
  constexpr int NJ = BN / 8;  // n8 column groups per thread
  extern __shared__ unsigned char smem_raw[];
  int8_t* const sa = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* const sb = sa + kWgStages * kStageA;
  uint64_t* const full = reinterpret_cast<uint64_t*>(sb + kWgStages * BN * 128);
  uint64_t* const empty = full + kWgStages;
  float* const sxs_all = reinterpret_cast<float*>(empty + kWgStages);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);   // the producer's expect_tx
      mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      const int tx = (kWgBM + BN) * W;
      for (int step = 0; step < steps; ++step) {
        const int s = step % kWgStages;
        mbar_wait(empty + s, ((step / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full + s, tx);
        tma_load_2d(sa + s * kStageA, &tmx, full + s, step * W, m0);
        tma_load_2d(sb + s * BN * 128, &tmw, full + s, step * W, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg ... + 63
  const int wg = warp >> 2, tw = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = m0 + wg * 64 + (warp & 3) * 16;  // the warp's 16 rows
  const int row0 = wrow + g, row1 = row0 + 8;
  // the warp's activation scales, [kScaleChunk k-blocks][16 rows], staged
  // a chunk at a time: one load latency per chunk, not one per k-block
  float* const sxs = sxs_all + warp * kScaleChunk * 16;
  const int n_kb = steps / steps_per_kb;
  float acc[NJ][4];
  int32_t iacc[BN / 2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      iacc[j * 4 + e] = 0;
    }

  for (int step = 0; step < steps; ++step) {
    const int s = step % kWgStages;
    const int kb = step / steps_per_kb, sub = step - kb * steps_per_kb;
    if (sub == 0 && kb % kScaleChunk == 0) {
      __syncwarp();  // the previous chunk is read
      for (int i = lane; i < kScaleChunk * 16; i += 32) {
        const int row = wrow + (i & 15), kbi = kb + (i >> 4);
        sxs[i] = row < M && kbi < n_kb
                     ? __ldg(xs + (int64_t)row * xs_rs + (int64_t)kbi * xs_cs)
                     : 0.f;
      }
      __syncwarp();
    }
    mbar_wait(full + s, (step / kWgStages) & 1);
    int8_t* const a = sa + s * kStageA + wg * 64 * W;
    if (flip) {  // wire codes q -> q - 128 in the warpgroup's own rows
      uint4* a16 = reinterpret_cast<uint4*>(a);
      for (int i = tw; i < 4 * W; i += 128) {
        uint4 u = a16[i];
        u.x ^= 0x80808080u; u.y ^= 0x80808080u;
        u.z ^= 0x80808080u; u.w ^= 0x80808080u;
        a16[i] = u;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    const uint64_t da = wg_desc(a, W), db = wg_desc(sb + s * BN * 128, W);
    fence_regs(iacc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < W / 32; ++kk)  // +32 bytes of k = +2 in the desc
      wgmma_s8<BN>(iacc, da + 2 * kk, db + 2 * kk, sub > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(iacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);

    if (sub == steps_per_kb - 1) {  // the k-block is complete: fold it
      const float sc0 = sxs[(kb % kScaleChunk) * 16 + g];
      const float sc1 = sxs[(kb % kScaleChunk) * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fadd_rn(
              acc[j][e], __fmul_rn((float)iacc[j * 4 + e], e < 2 ? sc0 : sc1));
    }
  }

  // epilogue: lanes t and t^1 swap halves, so an even t holds four columns
  // of row0 and an odd t four columns of row1, and store 16 bytes each
  const bool odd = t & 1;
  const int row = odd ? row1 : row0;
  float* orow = out + (int64_t)row * N;
  const bool quads = (N & 3) == 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    const float w0 = col < N ? __ldg(ws + col) : 0.f;
    const float w1 = col + 1 < N ? __ldg(ws + col + 1) : 0.f;
    const float v00 = __fmul_rn(acc[j][0], w0), v01 = __fmul_rn(acc[j][1], w1);
    const float v10 = __fmul_rn(acc[j][2], w0), v11 = __fmul_rn(acc[j][3], w1);
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v00 : v10, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v01 : v11, 1);
    const int c0 = odd ? col - 2 : col;
    const float4 q = odd ? make_float4(r0, r1, v10, v11)
                         : make_float4(v00, v01, r0, r1);
    if (row >= M || c0 >= N) continue;
    if (quads) {  // c0 % 4 == 0 and N % 4 == 0: all four columns are in
      *reinterpret_cast<float4*>(orow + c0) = q;
    } else {
      const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < N) orow[c0 + e] = qv[e];
    }
  }
}

// --- host side of the wgmma kernel -------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// [rows, K] bytes, row-major, boxes of [box_rows, W] with the W-byte swizzle
bool encode_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t K,
                int box_rows, int W) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)W, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz =
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight's maps, keyed on everything a map encodes: an entry is valid
// for any tensor at that address with that shape, so reuse of freed memory
// cannot make it stale.
struct MapEntry {
  const void* ptr;
  int64_t rows, K;
  int box_rows, W;
  CUtensorMap map;
};

bool weight_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t K,
                int box_rows, int W) {
  constexpr int kEntries = 64;
  static MapEntry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const MapEntry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.K == K &&
        e.box_rows == box_rows && e.W == W) {
      *map = e.map;
      return true;
    }
  }
  if (!encode_map(map, ptr, rows, K, box_rows, W)) return false;
  MapEntry& e = cache[used < kEntries ? used++ : next];
  if (used == kEntries) next = (next + 1) % kEntries;
  e = MapEntry{ptr, rows, K, box_rows, W, *map};
  return true;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int BN>
int launch_wgmma(const void* x, const void* xs, const void* wt, const void* ws,
                 void* out, int64_t M, int64_t N, int64_t K, int64_t bk,
                 int64_t xs_rs, int64_t xs_cs, int flip, cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes<BN>();
  static bool configured = false;  // idempotent: a racing second set is fine
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        pe_int8_matmul_wgmma_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int W = bk % 128 == 0 ? 128 : (bk % 64 == 0 ? 64 : 32);
  CUtensorMap tmx, tmw;
  if (!encode_map(&tmx, x, M, K, kWgBM, W) ||
      !weight_map(&tmw, wt, N, K, BN, W))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + BN - 1) / BN),
                  (unsigned)((M + kWgBM - 1) / kWgBM));
  pe_int8_matmul_wgmma_kernel<BN><<<grid, kWgThreads, smem, stream>>>(
      tmx, tmw, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(out), (int)M, (int)N, (int)(K / W), W,
      (int)(bk / W), xs_rs, xs_cs, flip);
  return 0;
}

}  // namespace

extern "C" {


// The mma.sync kernel. x int8 (or the uint8 wire bytes with flip = 1)
// [M, K] and wt int8 [N, K], both contiguous; xs f32 [M, K / bk] with
// strides (xs_rs, xs_cs); ws f32 [N] contiguous; out f32 [M, N] contiguous.
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

// The same product on the wgmma kernel: bk % 32 == 0 (so K % 32 == 0), x
// and wt 16-byte aligned; the wrapper chooses (ops/int8_matmul.py
// kernel_choice) and this entry refuses what it cannot take.
int pe_int8_matmul_wgmma(const void* x, const void* xs, const void* wt,
                         const void* ws, void* out, int64_t M, int64_t N,
                         int64_t K, int64_t bk, int64_t xs_rs, int64_t xs_cs,
                         int flip, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || bk % 32 || K % bk ||
      M > 2147483647 || N > 2147483647 || K > 2147483647 ||
      (M + kWgBM - 1) / kWgBM > 65535 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) &
       15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles128 = ((M + kWgBM - 1) / kWgBM) * ((N + 127) / 128);
  const int rc = tiles128 < sm_count()
                     ? launch_wgmma<64>(x, xs, wt, ws, out, M, N, K, bk,
                                        xs_rs, xs_cs, flip, s)
                     : launch_wgmma<128>(x, xs, wt, ws, out, M, N, K, bk,
                                         xs_rs, xs_cs, flip, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
