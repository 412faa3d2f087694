// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, f32 or
// bf16 in and out: the gradient of kernel 3 (csrc/attention.cu).
//
// Replaces no Pallas kernel. The JAX package's training differentiates
// XLA's attention einsums (pipeedge_tpu/models/layers.py self_attention)
// with jax.grad; the port's attention is kernel 3 on the card, whose output
// carries no autograd graph, so its gradient is a kernel of its own
// (ops/attention.py FusedAttentionFunction).
//
// Computes, per (batch, head), from q, k, v, the forward's o, the output's
// gradient dO and the forward's row log-sum-exp in base 2 (lse):
//   delta_i = sum_d dO_id O_id
//   P_ij    = 2^(q_i . k_j * scale_log2 - lse_i)   (0 for a key past S or,
//                                                   causal, past row i)
//   dV_j    = sum_i P_ij dO_i
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i
// with scale = 1/sqrt(D) and scale_log2 = log2(e) * scale, sums in f32,
// written in the input dtype. The [S, S] matrices never reach device
// memory. A masked P is exactly 0, so dS past the causal frontier is
// exactly 0.
//
// What bounds it on the card: five products of 2*S*S*D flops per head (half
// under the causal mask) against ~8*S*D elements moved, so at the main
// path's shapes (S = 197 to 1024, D = 64 or 128) operations bound it.
//
// Design: two kernels on one stream, each a 256-thread block per (batch
// * head, 64-row tile), the tiles in shared memory as f32 with a row pitch
// of DP + 1 (DP: the head dim padded to a multiple of 16; the pad columns
// read as zero), so the 16 x 16 thread grid reads distinct banks. Each
// thread computes a 4 x 4 patch of a 64 x 64 score tile by FMAs, rows
// ty*4 + i and columns tx + 16*j.
//   1. dq_kernel: a query tile; computes delta for its rows (written to a
//      scratch row the second kernel reads), then walks the key tiles up to
//      the causal frontier: S and dO V^T in registers, dS to shared memory,
//      dQ += dS K in registers.
//   2. dkdv_kernel: a key tile; walks the query tiles from the frontier on:
//      S and dO V^T, P and dS to shared memory, dV += P^T dO and dK += dS^T
//      Q in registers.
// So the scores and dO V^T are computed twice (seven products where five
// are needed), and no atomics are used: the sums are deterministic. Tensor
// cores, TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;       // rows of a query tile and of a key tile
constexpr int NTH = 256;     // a 16 x 16 thread grid, 4 x 4 entries each
constexpr int SP = BT + 1;   // row pitch of a [64][64] score tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of shared memory: four [64][DP + 1] tiles, `scores` [64][65]
// tiles, two [64] rows (lse and delta)
template <int DP>
__host__ __device__ constexpr int smem_floats(int scores) {
  return 4 * BT * (DP + 1) + scores * BT * SP + 2 * BT;
}

// rows r0 .. r0 + 63 of one (batch, head) of x into s as f32; rows at or
// past S read as zero. Columns at or past D are never written.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* s, const T* __restrict__ x,
                                          int64_t base, int64_t ss, int r0,
                                          int S, int D) {
  constexpr int P = DP + 1;
  for (int i = threadIdx.x; i < BT * D; i += NTH) {
    const int r = i / D, d = i - r * D, row = r0 + r;
    s[r * P + d] = row < S ? ld(x + base + (int64_t)row * ss + d) : 0.f;
  }
}

// s[i][j] = a_(ty*4+i) . b_(tx+16j) and c[i][j] = e_(ty*4+i) . f_(tx+16j)
// over the DP columns of four [64][DP + 1] tiles
template <int DP>
__device__ __forceinline__ void two_products(float (&s)[4][4],
                                             float (&c)[4][4], const float* a,
                                             const float* b, const float* e,
                                             const float* f, int ty, int tx) {
  constexpr int P = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float av[4], ev[4], bv[4], fv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * P + d];
      ev[i] = e[(ty * 4 + i) * P + d];
      bv[i] = b[(tx + 16 * i) * P + d];
      fv[i] = f[(tx + 16 * i) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        c[i][j] = fmaf(ev[i], fv[j], c[i][j]);
      }
  }
}

// P and dS of the thread's 4 x 4 patch (query rows q0 + ty*4 + i, keys k0 +
// tx + 16j) from the raw scores s and dP = dO V^T; `ps` may be null
__device__ __forceinline__ void probs_and_ds(const float (&s)[4][4],
                                             const float (&dp)[4][4],
                                             float* ps, float* ds,
                                             const float* sl, const float* sd,
                                             int q0, int k0, int S,
                                             bool causal, float scale_log2,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kj = k0 + c;
      const bool ok = qi < S && kj < S && (!causal || kj <= qi);
      const float p = ok ? exp2f(fmaf(s[i][j], scale_log2, -sl[r])) : 0.f;
      if (ps != nullptr) ps[r * SP + c] = p;
      ds[r * SP + c] = p * (dp[i][j] - sd[r]);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(NTH)
pe_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, T* __restrict__ dq, int H,
                      int S, int D, int64_t sb, int64_t sh, int64_t ss,
                      float scale_log2, float scale, int causal) {
  constexpr int P = DP + 1;
  constexpr int NC = DP / 16;  // output columns per thread
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + BT * P;
  float* sK = sdO + BT * P;
  float* sV = sK + BT * P;
  float* sdS = sV + BT * P;
  float* sL = sdS + BT * SP;
  float* sD = sL + BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int64_t base = (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  const int64_t row0 = (int64_t)bh * S;
  const int q0 = blockIdx.y * BT;

  for (int i = tid; i < smem_floats<DP>(1); i += NTH) sm[i] = 0.f;
  __syncthreads();
  load_tile<T, DP>(sQ, q, base, ss, q0, S, D);
  load_tile<T, DP>(sdO, dout, base, ss, q0, S, D);
  for (int r = tid; r < BT; r += NTH)
    sL[r] = q0 + r < S ? lse[row0 + q0 + r] : 0.f;
  __syncthreads();
  // delta of the tile's rows: a warp per row, O read once from memory
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BT; r += NTH / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(sdO[r * P + d], ld(o + base + (int64_t)row * ss + d), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      sD[r] = acc;
      if (row < S) delta[row0 + row] = acc;
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  const int kv_end = causal ? min(S, q0 + BT) : S;  // the tile's frontier
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    load_tile<T, DP>(sK, k, base, ss, k0, S, D);
    load_tile<T, DP>(sV, v, base, ss, k0, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DP>(s, dp, sQ, sK, sdO, sV, ty, tx);
    probs_and_ds(s, dp, nullptr, sdS, sL, sD, q0, k0, S, causal, scale_log2,
                 ty, tx);
    __syncthreads();
    const int nk = min(BT, S - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[kk * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
    __syncthreads();  // the next tile overwrites sK, sV and sdS
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) st(dq + base + (int64_t)row * ss + d, acc[i][c] * scale);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(NTH)
pe_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int S, int D, int64_t sb,
                        int64_t sh, int64_t ss, float scale_log2, float scale,
                        int causal) {
  constexpr int P = DP + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BT * P;
  float* sQ = sV + BT * P;
  float* sdO = sQ + BT * P;
  float* sP = sdO + BT * P;
  float* sdS = sP + BT * SP;
  float* sL = sdS + BT * SP;
  float* sD = sL + BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int64_t base = (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  const int64_t row0 = (int64_t)bh * S;
  const int k0 = blockIdx.y * BT;

  for (int i = tid; i < smem_floats<DP>(2); i += NTH) sm[i] = 0.f;
  __syncthreads();
  load_tile<T, DP>(sK, k, base, ss, k0, S, D);
  load_tile<T, DP>(sV, v, base, ss, k0, S, D);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;
  // causal: query tiles wholly before the key tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BT) {
    load_tile<T, DP>(sQ, q, base, ss, q0, S, D);
    load_tile<T, DP>(sdO, dout, base, ss, q0, S, D);
    for (int r = tid; r < BT; r += NTH) {
      const bool ok = q0 + r < S;
      sL[r] = ok ? lse[row0 + q0 + r] : 0.f;
      sD[r] = ok ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<DP>(s, dp, sQ, sK, sdO, sV, ty, tx);
    probs_and_ds(s, dp, sP, sdS, sL, sD, q0, k0, S, causal, scale_log2, ty,
                 tx);
    __syncthreads();
    const int nq = min(BT, S - q0);
    for (int qq = 0; qq < nq; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[qq * SP + ty * 4 + i];
        dsv[i] = sdS[qq * SP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = sdO[qq * P + tx + 16 * c];
        const float x = sQ[qq * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i][c] = fmaf(pv[i], g, gv[i][c]);
          gk[i][c] = fmaf(dsv[i], x, gk[i][c]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sQ, sdO, sP and sdS
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      const int64_t off = base + (int64_t)key * ss + d;
      st(dk + off, gk[i][c] * scale);
      st(dv + off, gv[i][c]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return 0;  // idempotent: a racing second set is fine
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int H, int S, int D, int64_t sb,
           int64_t sh, int64_t ss, float scale_log2, float scale, int causal,
           cudaStream_t stream) {
  constexpr int smem_dq = smem_floats<DP>(1) * (int)sizeof(float);
  constexpr int smem_dkdv = smem_floats<DP>(2) * (int)sizeof(float);
  auto kdq = pe_attn_bwd_dq_kernel<DP, T>;
  auto kdkdv = pe_attn_bwd_dkdv_kernel<DP, T>;
  static bool set_dq = false, set_dkdv = false;
  int rc = allow_smem(kdq, smem_dq, set_dq);
  if (rc) return rc;
  rc = allow_smem(kdkdv, smem_dkdv, set_dkdv);
  if (rc) return rc;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + BT - 1) / BT));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  kdq<<<grid, NTH, smem_dq, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, delta,
      static_cast<T*>(dq), H, S, D, sb, sh, ss, scale_log2, scale, causal);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  kdkdv<<<grid, NTH, smem_dkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, S, D, sb, sh, ss, scale_log2, scale, causal);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int S, int D, int64_t sb,
             int64_t sh, int64_t ss, float scale_log2, float scale,
             int causal, cudaStream_t s) {
  // the smallest head dim DP >= D that is a multiple of 16
#define PE_ATTN_BWD_CASE(DP)                                                \
  if (D <= DP)                                                              \
    return launch<DP, T>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, S, \
                         D, sb, sh, ss, scale_log2, scale, causal, s);
  PE_ATTN_BWD_CASE(16)
  PE_ATTN_BWD_CASE(32)
  PE_ATTN_BWD_CASE(64)
  PE_ATTN_BWD_CASE(96)
  PE_ATTN_BWD_CASE(128)
#undef PE_ATTN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq, dk, dv: element (b, h, s, d) at b*sb + h*sh + s*ss +
// d, all eight with the same strides. lse: the forward's f32 [B*H, S]
// (pe_fused_attention_lse); delta: f32 [B*H, S] scratch. dtype 0 = f32,
// 1 = bf16. D <= 128.
int pe_fused_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* delta, void* dq, void* dk, void* dv,
                           int dtype, int B, int H, int S, int D, int64_t sb,
                           int64_t sh, int64_t ss, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > 128 ||
      (int64_t)B * H > 2147483647 || (S + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  // as the forward computes it, so P meets the forward's lse exactly
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, S, D, sb,
                         sh, ss, scale_log2, scale, causal, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, S,
                                 D, sb, sh, ss, scale_log2, scale, causal, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
