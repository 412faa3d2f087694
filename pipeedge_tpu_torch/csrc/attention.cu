// Flash-attention forward for Hopper (sm_90a) on the tensor cores, f32 or
// bf16 in and out.
//
// Replaces the Pallas kernel of pipeedge_tpu/ops/attention.py:
//   _attention_kernel (:30, wrapped by fused_attention_bhsd :92 and
//   fused_attention :127).
//
// Computes, per (batch, head) and query row: softmax(q k^T / sqrt(D)) v with
// an f32 online softmax (running max, sum and accumulator) over tiles of
// keys, the ragged key tail masked in the kernel (no padding of S), and an
// optional causal mask that also stops the key loop at the query tile's
// frontier. The [S, S] scores never reach device memory.
//
// What bounds it on the card: at ViT shapes (S = 197, D = 64) the two
// products do 4*S*D flops per query row against 4*D elements moved per
// row, so f32 at 165 TFLOP/s is bound by bytes and operations alike and
// bf16 by bytes. In f32 the products run on the tensor cores as 3xTF32: each
// operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and
// hi*hi + hi*lo + lo*hi sums in f32 (the lo*lo term is below f32's last
// bit of the product). That keeps ~21 mantissa bits of each product, where
// one TF32 product keeps ~10 and would miss the f32 tolerance; the card
// runs it at 495/3 = 165 TFLOP/s against 67 for f32 on the CUDA cores. In
// bf16 the products are single bf16 tensor-core products, f32 accumulated.
//
// Design: one block of NW warps per (batch*head, tile of 16*NW query
// rows); each warp owns 16 query rows and keeps their Q fragments in
// registers for the whole key loop. K and V tiles of 32 or 64 keys stream
// through a two-stage shared-memory ring filled by 16-byte cp.async
// copies, so the next tile's load overlaps this tile's products.
// `dispatch` holds the tile shapes per head dim and dtype. bf16 blocks
// at D <= 64 have 3 warps: at ViT's S = 197 that makes four full 48-row
// tiles and a 5-row one per head, 384 full blocks for 132 SMs (2.9 each),
// where 64-row tiles make 288 (2.2 each), so 24 SMs would run three full
// blocks while the rest run two. f32 keeps 4 warps, which timed as fast
// at S = 197 and faster on the causal S = 1024 case. Products use
// mma.sync.m16n8k8.tf32 (f32) or mma.sync.m16n8k16.bf16 (bf16), not wgmma:
// a warp's 16 rows are independent, so warps whose rows all lie past S (the
// ragged last tile at S = 197) or past the causal frontier skip their
// products, and the score accumulator feeds P V straight from registers,
// where wgmma would take 64-row steps and need both tf32 operands in shared
// memory. P never leaves registers: for bf16 the m16n8k16 accumulator of two
// key tiles is the A fragment of P V as it stands; for tf32 the accumulator
// holds keys (2t, 2t+1) where the A fragment wants k indices (t, t+4), so
// the k index t is read as key 2t and t + 4 as key 2t + 1, and V's B
// fragment is loaded in the same key order (the sum over keys ignores it).
// bf16 K fragments come from ldmatrix, V's from ldmatrix.trans. The
// softmax runs in base 2 (one FFMA and one ex2 per score); the row max and
// sum reduce by shuffles within the quad of lanes that shares a row, and
// only a tile that holds a key past S or past the causal diagonal pays
// for the mask test. Key tiles past S are zero-filled by the copy;
// a head dim D below the template's DP is zero-padded in shared memory
// (ViT-H's D = 80 runs at DP = 80). Inputs are read through (batch, head,
// position) strides with a unit stride on D, so [B, S, H, D] and
// [B*H, S, D] layouts both run without a transpose; 16-byte copies need D,
// the strides and the pointers aligned to 16 bytes, else each element is
// copied on its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// shared row pitch in elements: rows stay 16-byte aligned and the fragment
// loads of a warp hit distinct banks
template <typename T, int DP>
__host__ __device__ constexpr int pitch() {
  return sizeof(T) == 4 ? DP + 4 : DP + 8;
}

// a ring of STAGES tiles, each K [BK][P] then V [BK][P]
template <typename T, int DP, int BK, int STAGES>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * 2 * BK * pitch<T, DP>() * (int)sizeof(T);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

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

// cvt.rna.tf32.f32 in two integer ops: add half a unit of bit 13 to the
// sign-magnitude bits and clear the 13 bits below (round to nearest, ties
// away from zero; a carry rounds up into the exponent). The cvt
// instruction gives the same bits for finite x but costs more issue
// slots, and the split spends them on every operand element.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo, both tf32 (round to nearest, ties away, as the card rounds)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += (ah + al)(bh + bl) without the al*bl term, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

template <int N>
__device__ __forceinline__ void split_all(const float (&x)[N],
                                          uint32_t (&hi)[N],
                                          uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 2^x on the special-function unit, denormal results flushed to zero
// (2^-126 and below is nothing beside a row's largest term, which is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One tile of K and V (keys k0 .. k0 + BK - 1) into shared memory; keys at
// or past S are zero. Columns past D are never written (zeroed once).
template <typename T, int DP, int BK, int NTH>
__device__ __forceinline__ void load_kv(T* sk, T* sv, const T* __restrict__ k,
                                        const T* __restrict__ v, int64_t base,
                                        int64_t ss, int k0, int S, int D,
                                        bool vec) {
  constexpr int P = pitch<T, DP>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = DP / EPC;
  if (vec) {  // D % EPC == 0, strides and pointers 16-byte aligned
    const int cpr = D / EPC;
    for (int i = threadIdx.x; i < BK * CPR; i += NTH) {
      const int r = i / CPR, c = i - r * CPR;
      if (c >= cpr) continue;
      const int key = k0 + r;
      const bool ok = key < S;
      const int64_t off = base + (int64_t)(ok ? key : 0) * ss + c * EPC;
      cp_async16(sk + r * P + c * EPC, k + off, ok ? 16 : 0);
      cp_async16(sv + r * P + c * EPC, v + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * D; i += NTH) {
      const int r = i / D, d = i - r * D, key = k0 + r;
      const bool ok = key < S;
      const int64_t off = base + (int64_t)key * ss + d;
      sk[r * P + d] = ok ? k[off] : zero<T>();
      sv[r * P + d] = ok ? v[off] : zero<T>();
    }
  }
}

// Online softmax over one tile's raw scores of the thread's two rows (a:
// e < 2, b: e >= 2), in base 2: the running max m is kept scaled by
// scale_log2 = log2(e)/sqrt(D), and each p = 2^(s * scale_log2 - m) takes
// one FFMA. Rescales the output accumulator by the change of the max.
// `mask` (warp-uniform) is set for a tile that holds a key past S or past
// one of the warp's rows under the causal mask; other tiles skip the test.
template <int BK, int NO>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 8][4], float (&o)[NO][4], float (&m)[2], float (&l)[2],
    int k0, int t, int row_a, int S, bool causal, bool mask,
    float scale_log2) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (mask) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (key >= S || (causal && key > row)) s[j][e] = -INFINITY;
      }
      mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mt[r]) * scale_log2);
    const bool none = m_new == -INFINITY;  // no valid key for the row yet
    corr[r] = none ? 1.f : exp2_ftz(m[r] - m_new);
    mt[r] = none ? 0.f : -m_new;  // the exponent's offset
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // -inf (masked) -> 0
      s[j][e] = exp2_ftz(fmaf(s[j][e], scale_log2, mt[e >> 1]));
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
}

template <int DP, int BK, int NW, int MT, int STAGES, int MINB, typename T>
__global__ void __launch_bounds__(32 * NW, MINB)
pe_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H,
                        int S, int D, int64_t sb, int64_t sh, int64_t ss,
                        float scale_log2, int causal, int vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int P = pitch<T, DP>();
  constexpr int NT = BK / 8;  // key n8 tiles of a tile's scores
  constexpr int NO = DP / 8;  // n8 tiles of the output
  constexpr int NTH = 32 * NW;
  constexpr int BQ = NW * 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  auto stage_k = [&](int it) { return ring + (it % STAGES) * 2 * BK * P; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int64_t base = (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  const int q0 = blockIdx.y * BQ;
  const int r0 = q0 + warp * 16 * MT;  // the warp's first row
  const bool active = r0 < S;
  // keys at or past this bound are masked for all the warp's rows
  const int warp_lim = causal ? min(S, r0 + 16 * MT) : S;
  const int kv_end = causal ? min(S, q0 + BQ) : S;  // the block's frontier
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (D < DP) {  // the pad columns, which no load writes, read as zero
    for (int i = threadIdx.x; i < smem_bytes<T, DP, BK, STAGES>() / 16;
         i += NTH)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  // keep STAGES - 1 tiles in flight: one commit group per tile
  auto load_tile = [&](int it) {
    if (it < n_tiles) {
      T* sk = stage_k(it);
      load_kv<T, DP, BK, NTH>(sk, sk + BK * P, k, v, base, ss, it * BK, S,
                              D, vec);
    }
    cp_async_commit();  // an empty group keeps the count even
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_tile(it);

  // Q as A fragments, one set per m16 tile: f32 raw (split per chunk),
  // bf16 packed pairs
  constexpr int QC = kF32 ? DP / 8 : DP / 16;
  float qf[MT][kF32 ? QC : 1][4];
  uint32_t qb[MT][kF32 ? 1 : QC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row_a = r0 + mt * 16 + g, row_b = row_a + 8;
    const T* qa = q + base + (int64_t)row_a * ss;
    const T* qr = q + base + (int64_t)row_b * ss;
    const bool ok_a = row_a < S, ok_b = row_b < S;
    auto ldq = [&](const T* p, bool ok, int d) {
      return ok && d < D ? ld_f32(p + d) : 0.f;
    };
    // a bf16 pair (d even): one 32-bit load when the rows are 16-byte
    // aligned (D % 8 == 0, so d + 1 < D), else two
    auto ldq2 = [&](const T* p, bool ok, int d) -> uint32_t {
      if (!ok || d >= D) return 0u;
      if (vec) return *reinterpret_cast<const uint32_t*>(p + d);
      return pack_bf16(ld_f32(p + d), ldq(p, ok, d + 1));
    };
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      if constexpr (kF32) {
        qf[mt][c][0] = ldq(qa, ok_a, c * 8 + t);
        qf[mt][c][1] = ldq(qr, ok_b, c * 8 + t);
        qf[mt][c][2] = ldq(qa, ok_a, c * 8 + t + 4);
        qf[mt][c][3] = ldq(qr, ok_b, c * 8 + t + 4);
      } else {
        const int d = c * 16 + 2 * t;
        qb[mt][c][0] = ldq2(qa, ok_a, d);
        qb[mt][c][1] = ldq2(qr, ok_b, d);
        qb[mt][c][2] = ldq2(qa, ok_a, d + 8);
        qb[mt][c][3] = ldq2(qr, ok_b, d + 8);
      }
    }
  }

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait<STAGES - 2>();
    // tile `it` is in for every thread, and every thread is done with the
    // stage of tile it - 1, which the next load refills
    __syncthreads();
    load_tile(it + STAGES - 1);
    const T* sk = stage_k(it);
    const T* sv = sk + BK * P;
    if (!active || k0 >= warp_lim) continue;  // warp-uniform

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    // S = Q K^T over the key n8 tiles that hold a key below warp_lim; each
    // K fragment serves the warp's MT row tiles
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      if constexpr (kF32) {
        uint32_t ah[MT][4], al[MT][4];  // Q's split, once per k8 chunk
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) split_all(qf[mt][c], ah[mt], al[mt]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (k0 + j * 8 >= warp_lim) continue;
          const float* kp = sk + (j * 8 + g) * P + c * 8 + t;
          const float b[2] = {kp[0], kp[4]};
          uint32_t bh[2], bl[2];
          split_all(b, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(s[mt][j], ah[mt], al[mt], bh, bl);
        }
      } else {
        // one ldmatrix.x4 gives the B fragments of key tiles j and j + 1:
        // lanes 0-7 address keys j*8 + lane at d c*16, 8-15 the same keys
        // at d c*16 + 8, 16-31 the keys of tile j + 1 likewise
        const T* kp = sk + (((lane >> 4) << 3) + (lane & 7)) * P + c * 16 +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (k0 + j * 8 >= warp_lim) continue;
          uint32_t r[4];
          ldmatrix_x4(r, kp + j * 8 * P);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], qb[mt][c], b0);
            mma_bf16(s[mt][j + 1], qb[mt][c], b1);
          }
        }
      }
    }
    const bool mask = k0 + BK > S || (causal && k0 + BK > r0 + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      online_softmax<BK, NO>(s[mt], acc[mt], m[mt], l[mt], k0, t,
                             r0 + mt * 16 + g, S, causal, mask, scale_log2);
    // O += P V, P straight from the score registers
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (k0 + j * 8 >= warp_lim) continue;
        // k index t <-> key 2t, t + 4 <-> key 2t + 1
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float a[4] = {s[mt][j][0], s[mt][j][2], s[mt][j][1],
                              s[mt][j][3]};
          split_all(a, ah[mt], al[mt]);
        }
        const float* vp = sv + (j * 8 + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float b[2] = {vp[n * 8], vp[P + n * 8]};
          uint32_t bh[2], bl[2];
          split_all(b, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(acc[mt][n], ah[mt], al[mt], bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        if (k0 + j2 * 16 >= warp_lim) continue;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack_bf16(s[mt][2 * j2][0], s[mt][2 * j2][1]);
          a[mt][1] = pack_bf16(s[mt][2 * j2][2], s[mt][2 * j2][3]);
          a[mt][2] = pack_bf16(s[mt][2 * j2 + 1][0], s[mt][2 * j2 + 1][1]);
          a[mt][3] = pack_bf16(s[mt][2 * j2 + 1][2], s[mt][2 * j2 + 1][3]);
        }
        // lanes 0-15 address keys j2*16 + lane of n-tile n, lanes 16-31
        // the same keys of n-tile n + 1
        const T* vp = sv + (j2 * 16 + (lane & 15)) * P + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vp + n * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][n], a[mt], b0);
            mma_bf16(acc[mt][n + 1], a[mt], b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float inv[2] = {1.f / quad_sum(l[mt][0]), 1.f / quad_sum(l[mt][1])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + mt * 16 + g + r * 8;
      if (row >= S) continue;
      T* out = o + base + (int64_t)row * ss;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + 2 * t;
        const float v0 = acc[mt][n][2 * r] * inv[r];
        const float v1 = acc[mt][n][2 * r + 1] * inv[r];
        if (vec) {  // D is a multiple of 4 (f32) or 8 (bf16): d, d+1 both in
          if (d >= D) continue;
          if constexpr (kF32) {
            *reinterpret_cast<float2*>(out + d) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + d) =
                __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if constexpr (kF32) {
            if (d < D) out[d] = v0;
            if (d + 1 < D) out[d + 1] = v1;
          } else {
            if (d < D) out[d] = __float2bfloat16_rn(v0);
            if (d + 1 < D) out[d + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <int DP, int BK, int NW, int MT, int STAGES, int MINB, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int D, int64_t sb, int64_t sh, int64_t ss,
           float scale_log2, int causal, int vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DP, BK, STAGES>();
  auto kernel = pe_attention_mma_kernel<DP, BK, NW, MT, STAGES, MINB, T>;
  static bool configured = false;  // idempotent: a racing second set is fine
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int BQ = NW * 16 * MT;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, S, D, sb, sh, ss,
      scale_log2, causal, vec);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int S, int D, int64_t sb, int64_t sh, int64_t ss,
             float scale_log2, int causal, cudaStream_t s) {
  constexpr int EPC = 16 / (int)sizeof(T);
  const bool vec = D % EPC == 0 && sb % EPC == 0 && sh % EPC == 0 &&
                   ss % EPC == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  // the smallest padded head dim DP >= D; per dtype: (DP, key tile BK,
  // warps NW, m16 row tiles per warp MT, ring stages, min blocks per SM)
#define PE_ATTN_CASE(DP, BK, NW, MT, ST, MB)                               \
  if (D <= DP)                                                             \
    return launch<DP, BK, NW, MT, ST, MB, T>(q, k, v, o, B, H, S, D, sb,   \
                                             sh, ss, scale_log2, causal,  \
                                             (int)vec, s);
  if constexpr (sizeof(T) == 4) {
    PE_ATTN_CASE(32, 32, 4, 1, 2, 3)
    PE_ATTN_CASE(64, 32, 4, 1, 2, 3)
    PE_ATTN_CASE(80, 32, 4, 1, 2, 3)
    PE_ATTN_CASE(96, 32, 4, 1, 2, 2)
    PE_ATTN_CASE(128, 32, 4, 1, 2, 2)
  } else {
    PE_ATTN_CASE(32, 32, 3, 1, 2, 5)
    PE_ATTN_CASE(64, 32, 3, 1, 2, 5)
    PE_ATTN_CASE(80, 64, 4, 1, 2, 3)
    PE_ATTN_CASE(96, 64, 4, 1, 2, 2)
    PE_ATTN_CASE(128, 64, 4, 1, 2, 2)
  }
#undef PE_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o: element (b, h, s, d) at b*sb + h*sh + s*ss + d, all four with
// the same strides. dtype 0 = f32, 1 = bf16. D <= 128.
int pe_fused_attention(const void* q, const void* k, const void* v, void* o,
                       int dtype, int B, int H, int S, int D, int64_t sb,
                       int64_t sh, int64_t ss, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > 128 ||
      (int64_t)B * H > 2147483647 || (S + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(q, k, v, o, B, H, S, D, sb, sh, ss, scale_log2,
                         causal, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(q, k, v, o, B, H, S, D, sb, sh, ss,
                                 scale_log2, causal, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
