// Flash-attention forward for Hopper (sm_90a), f32 or bf16 in and out.
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
// What bounds it on the card: operations. At ViT shapes (S = 197, D = 64)
// the two products do 4*S*D flops per query row against 16*D bytes moved
// per row, about 50 flops per byte of f32. This kernel does the products
// in full f32 on the CUDA cores (67 TFLOP/s), not on the tensor cores
// (TF32 would round the inputs to 10 bits); wgmma and TMA are later work.
//
// Design: one block of 128 threads per (batch*head, tile of 64 query rows),
// looping over tiles of 32 keys. Both products are register-tiled like an
// SGEMM: thread (rg, cg) = (tid / 8, tid % 8) owns query rows rg*4..rg*4+3,
// computes their scores against keys cg*4..cg*4+3 of the tile (a 4x4 block
// from two 16-byte shared loads per step of d), and accumulates output
// columns in the float4 chunks cg, cg+8, ... of the head dim. The row max
// and sum are shared by the 8 lanes of a row group through warp shuffles.
// Q^T (once), K^T and V (per tile) and the tile's probabilities P^T are
// staged in shared memory as f32. The head dim is zero-padded to DP, a
// multiple of 32 (ViT-H's D = 80 runs as 96). Inputs are read through
// (batch, head, position) strides with a unit stride on D, so [B, S, H, D]
// and [B*H, S, D] layouts both run without a transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups

template <int DP>
struct Smem {
  float q[DP][kBQ];        // Q^T of the block's query rows
  float k[DP][kBK];        // K^T of the tile
  float v[kBK][DP + 4];    // V of the tile (rows padded against conflicts)
  float p[kBK][kBQ + 4];   // P^T of the tile
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
pe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int H, int S,
                    int D, int64_t sb, int64_t sh, int64_t ss,
                    float scale_log2, int causal) {
  constexpr int NC = DP / 32;  // float4 output chunks per thread
  extern __shared__ __align__(16) float smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int bh = blockIdx.x;
  const int64_t base = (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  const int q0 = blockIdx.y * kBQ;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i % kBQ, d = i / kBQ, row = q0 + r;
    sm.q[d][r] = (row < S && d < D) ? to_f32(q[base + (int64_t)row * ss + d])
                                    : 0.f;
  }

  float acc[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC * 4; ++j) acc[r][j] = 0.f;
  }
  const int kv_end = causal ? min(S, q0 + kBQ) : S;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q is stored; the previous tile's V and P are read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i % kBK, d = i / kBK, key = k0 + r;
      const bool ok = key < S && d < D;
      const int64_t off = base + (int64_t)key * ss + d;
      sm.k[d][r] = ok ? to_f32(k[off]) : 0.f;
      sm.v[r][d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores: 4 rows x 4 keys per thread
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.q[d][rg * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.k[d][cg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += av[r] * bv[c];
    }

    // online softmax, one row at a time; the row's 8 lanes agree on m
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + rg * 4 + r;
      float m_tile = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + cg * 4 + c;
        const bool valid = key < S && (!causal || key <= row);
        s[r][c] = valid ? s[r][c] * scale_log2 : -INFINITY;
        m_tile = fmaxf(m_tile, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group8_max(m_tile));
      const bool none = m_new == -INFINITY;  // no valid key for the row yet
      const float corr = none ? 1.f : exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = none ? 0.f : exp2f(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < NC * 4; ++j) acc[r][j] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&sm.p[cg * 4 + c][rg * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.p[kk][rg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sm.v[kk][(cg + 8 * j) * 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][j * 4 + 0] += av[r] * b.x;
          acc[r][j * 4 + 1] += av[r] * b.y;
          acc[r][j * 4 + 2] += av[r] * b.z;
          acc[r][j * 4 + 3] += av[r] * b.w;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float denom = group8_sum(l[r]);
    const int row = q0 + rg * 4 + r;
    if (row >= S) continue;
    T* out = o + base + (int64_t)row * ss;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (cg + 8 * j) * 4 + e;
        if (d < D) out[d] = from_f32<T>(acc[r][j * 4 + e] / denom);
      }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int D, int64_t sb, int64_t sh, int64_t ss,
           float scale_log2, int causal, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<DP>);
  static bool configured = false;  // idempotent: a racing second set is fine
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        pe_attention_kernel<DP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  pe_attention_kernel<DP, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, S, D, sb, sh, ss,
      scale_log2, causal);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int S, int D, int64_t sb, int64_t sh, int64_t ss,
             float scale_log2, int causal, cudaStream_t s) {
#define PE_ATTN_CASE(DP)                                                   \
  if (D <= DP)                                                             \
    return launch<DP, T>(q, k, v, o, B, H, S, D, sb, sh, ss, scale_log2,   \
                         causal, s);
  PE_ATTN_CASE(32)
  PE_ATTN_CASE(64)
  PE_ATTN_CASE(96)
  PE_ATTN_CASE(128)
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
      (int64_t)B * H > 2147483647 || (S + kBQ - 1) / kBQ > 65535)
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
