// Int8-KV decode-step attention for Hopper (sm_90a), f32 or bf16 q and out.
//
// Replaces the Pallas kernels of pipeedge_tpu/ops/decode_attention.py:
//   _kernel (:44, variant 1) and _kernel_v2 (:108, variant 2), both wrapped
//   by int8_decode_attention (:198). The two variants differ only in TPU
//   layout (VMEM blocks, sublanes); this one kernel computes their function.
//
// Computes, per (batch cell b, head h), for the one query row q[b, 0, h, :]:
//   K[r] = (k_q[b, r, h, :] + 128) * k_scale[b, r, h] + k_shift[b, r, h]
//   (V likewise) over the live rows r in [0, pos]; row pos is replaced by
//   the fresh, unquantized k_new / v_new; K, V and the softmax numerators
//   are rounded through the pipeline dtype (no-ops for f32);
//   out[b, 0, h*D:(h+1)*D] = softmax(q . K^T / sqrt(D)) V, in the dtype.
// Rows past pos are never read, whatever the window width: they are the
// rows the TPU kernel masks with -1e30.
//
// What bounds it on the card: bytes. One query row per head does ~4 flops
// per int8 byte of K and V; the live rows' int8 K and V and their f32
// scale/shift rows are the traffic (16 x 256 rows x 12 heads x 64 at the
// main path's bucket 256: ~7.3 MB, ~2.2 us at 3.35 TB/s).
//
// Design: one block of 8 warps per (head, batch cell). A row of one head
// is D int8 bytes, read as D/16 lanes x 16 bytes, so a warp takes 32/(D/16)
// consecutive rows per step (8 at D = 64) and the warps stride over rows
// 0..pos. The window is read in place through its (batch, row) strides, so
// a view of the stage cache needs no copy. Each lane dequantizes its 16
// values in registers with separate _rn multiply and add (no contraction:
// K and V equal the plain dequantization bit for bit), the row's score is
// reduced across its D/16 lanes by shuffles, and each row group keeps an
// online softmax (running max, sum, 16 output columns per lane). The row
// groups of a warp merge by shuffles, the warps through shared memory,
// into one output row. Split-K across blocks and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's running-max start
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round through the pipeline dtype (the TPU kernel's astype round trips)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (code + 128) * s + z for the 16 int8 codes of one 16-byte load
__device__ __forceinline__ void dequant16(const int4 codes, float s, float z,
                                          float* out) {
  const uint32_t w[4] = {(uint32_t)codes.x, (uint32_t)codes.y,
                         (uint32_t)codes.z, (uint32_t)codes.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = (int)(int8_t)(uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    out[j] = __fadd_rn(__fmul_rn(__fadd_rn((float)c, 128.f), s), z);
  }
}

template <int LPR, typename T>
__global__ void __launch_bounds__(kThreads)
pe_decode_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_new,
                           const T* __restrict__ v_new,
                           const int8_t* __restrict__ kq,
                           const int8_t* __restrict__ vq,
                           const float* __restrict__ ks,
                           const float* __restrict__ kz,
                           const float* __restrict__ vs,
                           const float* __restrict__ vz, T* __restrict__ out,
                           int H, int64_t pos, int64_t kv_sb, int64_t kv_sw,
                           int64_t sc_sb, int64_t sc_sw, float scale) {
  constexpr int D = LPR * 16;
  constexpr int kGroups = 32 / LPR;             // rows per warp per step
  constexpr int kRowsPerStep = kWarps * kGroups;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / LPR, col = (lane % LPR) * 16;
  const int64_t row = ((int64_t)b * H + h) * D + col;  // q, k_new, v_new, out

  float qv[16], acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    qv[j] = to_f32(q[row + j]);
    acc[j] = 0.f;
  }
  const int8_t* kb = kq + (int64_t)b * kv_sb + (int64_t)h * D + col;
  const int8_t* vb = vq + (int64_t)b * kv_sb + (int64_t)h * D + col;
  const int64_t sc = (int64_t)b * sc_sb + h;
  float m = kNegInf, l = 0.f;

  // r0 depends on the warp only, so every lane of a warp takes the same
  // trips and the shuffles below see the whole warp
  for (int64_t r0 = (int64_t)warp * kGroups; r0 <= pos; r0 += kRowsPerStep) {
    const int64_t r = r0 + group;
    const bool live = r <= pos;
    float kf[16], vf[16];
    if (r == pos) {  // the fresh row, unquantized
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        kf[j] = to_f32(k_new[row + j]);
        vf[j] = to_f32(v_new[row + j]);
      }
    } else if (live) {
      const int4 kc = __ldg(reinterpret_cast<const int4*>(kb + r * kv_sw));
      const int4 vc = __ldg(reinterpret_cast<const int4*>(vb + r * kv_sw));
      const int64_t si = sc + r * sc_sw;
      dequant16(kc, __ldg(ks + si), __ldg(kz + si), kf);
      dequant16(vc, __ldg(vs + si), __ldg(vz + si), vf);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) kf[j] = vf[j] = 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) dot = fmaf(qv[j], round_to<T>(kf[j]), dot);
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if (live) {
      const float s = dot * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = round_to<T>(expf(s - m_new));
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[j] = acc[j] * corr + p * round_to<T>(vf[j]);
      m = m_new;
    }
  }

  // merge the row groups of the warp (lanes with the same columns)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, o);
    const float l_o = __shfl_xor_sync(kFull, l, o);
    const float m_n = fmaxf(m, m_o);
    const float c = expf(m - m_n), c_o = expf(m_o - m_n);
    l = l * c + l_o * c_o;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc[j] = acc[j] * c + __shfl_xor_sync(kFull, acc[j], o) * c_o;
    m = m_n;
  }
  if (group == 0) {
    if (col == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) sm_acc[warp][col + j] = acc[j];
  }
  __syncthreads();

  // merge the warps: one thread per output column (row 0 is always live,
  // so the max is a real score and empty warps weigh exp(-1e30 - M) = 0)
  const int t = threadIdx.x;
  if (t < D) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);
      den += sm_l[w] * c;
      num += sm_acc[w][t] * c;
    }
    out[((int64_t)b * H + h) * D + t] = from_f32<T>(num / den);
  }
}

template <int LPR, typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* kq, const void* vq, const void* ks, const void* kz,
           const void* vs, const void* vz, void* out, int B, int H,
           int64_t pos, int64_t kv_sb, int64_t kv_sw, int64_t sc_sb,
           int64_t sc_sw, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)H, (unsigned)B);
  pe_decode_attention_kernel<LPR, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(kz), static_cast<const float*>(vs),
      static_cast<const float*>(vz), static_cast<T*>(out), H, pos, kv_sb,
      kv_sw, sc_sb, sc_sw, scale);
  return 0;
}

template <typename T>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* kq, const void* vq, const void* ks, const void* kz,
             const void* vs, const void* vz, void* out, int B, int H, int D,
             int64_t pos, int64_t kv_sb, int64_t kv_sw, int64_t sc_sb,
             int64_t sc_sw, float scale, cudaStream_t s) {
#define PE_DECODE_CASE(LPR)                                                 \
  if (D == LPR * 16)                                                        \
    return launch<LPR, T>(q, k_new, v_new, kq, vq, ks, kz, vs, vz, out, B,  \
                          H, pos, kv_sb, kv_sw, sc_sb, sc_sw, scale, s);
  PE_DECODE_CASE(1)
  PE_DECODE_CASE(2)
  PE_DECODE_CASE(4)
  PE_DECODE_CASE(8)
#undef PE_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k_new, v_new, out: contiguous [B, 1, H, D] (out read as [B, 1, H*D]).
// k_q, v_q: int8, element (b, r, h, d) at b*kv_sb + r*kv_sw + h*D + d, the
// base and both strides 16-byte aligned. k_scale ... v_shift: f32, element
// (b, r, h) at b*sc_sb + r*sc_sw + h. Rows 0..pos are read. dtype 0 = f32,
// 1 = bf16. D in {16, 32, 64, 128}.
int pe_decode_attention(const void* q, const void* k_new, const void* v_new,
                        const void* k_q, const void* v_q, const void* k_scale,
                        const void* k_shift, const void* v_scale,
                        const void* v_shift, void* out, int dtype, int B,
                        int H, int D, int64_t pos, int64_t kv_sb,
                        int64_t kv_sw, int64_t sc_sb, int64_t sc_sw,
                        float scale, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || pos < 0 ||
      (((uintptr_t)k_q | (uintptr_t)v_q | (uintptr_t)kv_sb |
        (uintptr_t)kv_sw) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(q, k_new, v_new, k_q, v_q, k_scale, k_shift,
                         v_scale, v_shift, out, B, H, D, pos, kv_sb, kv_sw,
                         sc_sb, sc_sw, scale, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(q, k_new, v_new, k_q, v_q, k_scale,
                                 k_shift, v_scale, v_shift, out, B, H, D,
                                 pos, kv_sb, kv_sw, sc_sb, sc_sw, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
