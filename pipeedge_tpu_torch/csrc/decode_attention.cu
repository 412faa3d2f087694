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
// What bounds it on the card. The bytes (the live rows' int8 K and V and
// their f32 scale/shift rows: ~5.7 MB at the main path's pos 200, ~1.7 us
// at 3.35 TB/s) set the bound in chip_smoke.py, but at the main path's
// shapes the kernel is bound by instruction issue: variants that skipped
// every K and V load ran nearly as long. One query row per head leaves
// ~4 flops per byte of K and V and few warps per SM (B 16 x H 12 = 192
// (head, batch cell) pairs), so each element's unpack, dequantization and
// products, on dependent chains, are the time.
//
// What the first design lost: one 8-warp block per (head, batch cell)
// walked its rows in trips whose loads issued only after the previous
// trip's were used, and the fresh row's k_new / v_new were two more
// dependent loads at the end of the last trip.
//
// Design. One 4-warp block per (head, batch cell) and row range; the
// rows [0, pos] split into 1 range up to 256 rows, 2 up to 512, else 4
// (split_count in ops/decode_attention.py states the same rule), and the
// blocks of one (head, batch cell) form one thread-block cluster: a grid
// of (splits, H, B) in clusters of (splits, 1, 1). B past the grid's
// 65535 is launched in chunks by the wrapper (ops/decode_attention.py).
//   - Loads. Warp w takes the row groups w, w + 4, ... of its range, 32 /
//     (D/C) rows a step, D/C lanes a row, C = min(D, 16) int8 codes of K
//     and of V (one 16-byte load each; at D = 8, whose rows are 8 bytes,
//     one 8-byte load and 32 rows a step) and the row's four scale/shift
//     values per lane, fetched two steps ahead in registers. The fresh
//     row is staged in shared memory while the first loads are in flight.
//   - Compute (f32). The codes become exact floats by a byte permute and
//     one add (no int-to-float conversion), and the affine dequantization
//     comes out of the products: score = s (q . u) + z sum(q), and the
//     value sum is sum (p s) u + sum p z. The running max moves only when
//     a score passes it by kLazy, so the C accumulators are rescaled
//     rarely. K and V are then not formed element by element, so they
//     are not bit-equal to the plain dequantization; the output stays
//     within the f32 tolerance (chip_smoke.py, tests/test_torch_*).
//   - Compute (bf16). K, V and the numerators round through bf16 as in
//     the plain version, so each element is dequantized with separate
//     _rn multiply and add (bit-equal to the plain dequantization) and
//     the running max moves every row.
//   - Merge. The lane groups of a warp merge by shuffles; every warp
//     writes its (m, l, acc[D]) into rank 0's shared memory (distributed
//     shared memory across the cluster), one barrier, and rank 0 merges by
//     the log-sum-exp rule and writes the row. The barrier's arrive that
//     makes peers' shared memory safe to write is issued at the start and
//     waited for just before the first remote write. One range takes a
//     plain launch, which costs less than a cluster of one block. One
//     launch, no workspace, no atomics.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 4;       // the most ranges splits_for gives
constexpr float kLazy = 8.f;        // f32: rescale when the max grows by e^8
constexpr float kNegInf = -1e30f;   // the TPU kernel's running-max start
constexpr unsigned kFull = 0xffffffffu;

// Row ranges: splits from the live row count n = pos + 1, rows_per =
// ceil(n / splits); range s is [s * rows_per, min(n, (s + 1) * rows_per)).
int splits_for(int64_t pos) {
  const int64_t n = pos + 1;
  return n <= 256 ? 1 : n <= 512 ? 2 : 4;
}

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

// code + 128 as an exact float (see dequant)
__device__ __forceinline__ float biased(uint32_t flipped, int j) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | j)),
      8388608.f);
}

// (code + 128) * s + z, separate _rn ops: the plain version's bits. The
// biased code u = code + 128 (the byte XOR 0x80, an integer in [0, 255])
// becomes a float exactly as 2^23 + u - 2^23, by one byte permute and one
// add, in place of a quarter-rate int-to-float conversion. `flipped` is
// the word of four codes XOR 0x80808080.
__device__ __forceinline__ float dequant(uint32_t flipped, int j, float s,
                                         float z) {
  const float u = __fsub_rn(
      __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | j)),
      8388608.f);
  return __fadd_rn(__fmul_rn(u, s), z);
}

// One lane's share of one row group: C int8 codes of K and of V (one
// 16-byte load each at C = 16, 8-byte at C = 8) and the row's four
// scale/shift values.
template <int C>
struct Frag {
  using Vec = typename std::conditional<C == 16, int4, int2>::type;
  Vec k, v;
  float ks, kz, vs, vz;
};

// The C / 4 words of a lane's codes, each XOR 0x80808080 (the biased
// codes code + 128, see dequant).
__device__ __forceinline__ void flip(const int4& c, uint32_t* w) {
  w[0] = (uint32_t)c.x ^ 0x80808080u;
  w[1] = (uint32_t)c.y ^ 0x80808080u;
  w[2] = (uint32_t)c.z ^ 0x80808080u;
  w[3] = (uint32_t)c.w ^ 0x80808080u;
}
__device__ __forceinline__ void flip(const int2& c, uint32_t* w) {
  w[0] = (uint32_t)c.x ^ 0x80808080u;
  w[1] = (uint32_t)c.y ^ 0x80808080u;
}

template <int D, typename T, bool kCluster>
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
                           int H, int64_t pos, int64_t rows_per,
                           int64_t kv_sb, int64_t kv_sw, int64_t sc_sb,
                           int64_t sc_sw, float scale) {
  constexpr int C = D < 16 ? D : 16;    // columns per lane
  constexpr int LPR = D / C;            // lanes per row
  constexpr int G = 32 / LPR;           // rows per warp step
  constexpr bool kFactored = std::is_same<T, float>::value;
  constexpr int kSlots = kCluster ? kMaxSplits * kWarps : kWarps;
  // rank 0's: every warp's partial (m, l, acc[D]) of the cluster, written
  // by that warp
  __shared__ float s_pm[kSlots], s_pl[kSlots];
  __shared__ __align__(16) float s_pa[kSlots][D];
  __shared__ float s_new[2][D];           // the fresh row's K and V

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / LPR, col = (lane % LPR) * C;
  const int64_t n = pos + 1;
  const int64_t r_begin = min(n, (int64_t)split * rows_per);
  const int64_t r_end = min(n, r_begin + rows_per);
  const int64_t qbase = ((int64_t)b * H + h) * D;  // q, k_new, v_new, out
  const int64_t qrow = qbase + col;
  const int8_t* kb = kq + (int64_t)b * kv_sb + (int64_t)h * D + col;
  const int8_t* vb = vq + (int64_t)b * kv_sb + (int64_t)h * D + col;
  const int64_t sc0 = (int64_t)b * sc_sb + h;

  // warp w takes the row groups w, w + kWarps, ... of the block's range;
  // a lane's row in step i is r_begin + (warp + i * kWarps) * G + group
  auto row_of = [&](int i) {
    return r_begin + ((int64_t)(warp + i * kWarps)) * G + group;
  };
  using Vec = typename Frag<C>::Vec;
  auto fetch = [&](int i, Frag<C>& f) {
    const int64_t r = row_of(i);
    if (r < r_end && r != pos) {
      f.k = __ldg(reinterpret_cast<const Vec*>(kb + r * kv_sw));
      f.v = __ldg(reinterpret_cast<const Vec*>(vb + r * kv_sw));
      const int64_t si = sc0 + r * sc_sw;
      f.ks = __ldg(ks + si);
      f.kz = __ldg(kz + si);
      f.vs = __ldg(vs + si);
      f.vz = __ldg(vz + si);
    }
  };
  // steps are uniform across the warp (the shuffles below)
  const int64_t groups = (r_end - r_begin + G - 1) / G;
  const int steps = (int)((groups - warp + kWarps - 1) / kWarps);

  // announce that this block has started (its shared memory may be
  // written by a peer once every block has): the matching wait comes just
  // before the first remote write, so neither waits on the other here
  if constexpr (kCluster)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the loads of the first two steps go out before anything waits
  Frag<C> f0 = {}, f1 = {};
  fetch(0, f0);
  fetch(1, f1);
  float qv[C], acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    qv[j] = to_f32(q[qrow + j]);
    acc[j] = 0.f;
  }
  // the fresh row, staged while the first loads are in flight: it is the
  // last live row, and two dependent loads there would end the kernel late
  if (pos >= r_begin && pos < r_end) {
    for (int c = threadIdx.x; c < D; c += kThreads) {
      s_new[0][c] = round_to<T>(to_f32(k_new[qbase + c]));
      s_new[1][c] = round_to<T>(to_f32(v_new[qbase + c]));
    }
  }
  __syncthreads();

  // f32: the affine dequantization is taken out of the products, and the
  // running max only moves when a score passes it by kLazy (the sums stay
  // below e^kLazy times the row count)
  float qsum = 0.f;
  if constexpr (kFactored) {
#pragma unroll
    for (int j = 0; j < C; ++j) qsum += qv[j];
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) qsum += __shfl_xor_sync(kFull, qsum, o);
  }
  float m = kNegInf, l = 0.f, accz = 0.f;
  for (int i = 0; i < steps; ++i) {
    Frag<C> f2 = {};
    fetch(i + 2, f2);                 // two steps ahead
    const int64_t r = row_of(i);
    const bool live = r < r_end;
    const bool fresh = r == pos;      // the fresh row, unquantized
    uint32_t kw[C / 4], vw[C / 4];
    flip(f0.k, kw);
    flip(f0.v, vw);
    float dot = 0.f;
    if (fresh) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        dot = fmaf(qv[j], s_new[0][col + j], dot);
    } else if constexpr (kFactored) {
      float d4[4] = {0.f, 0.f, 0.f, 0.f};   // four short chains, not one
#pragma unroll
      for (int j = 0; j < C; ++j)
        d4[j & 3] = fmaf(qv[j], biased(kw[j >> 2], j & 3), d4[j & 3]);
      dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j)
        dot = fmaf(qv[j],
                   round_to<T>(dequant(kw[j >> 2], j & 3, f0.ks, f0.kz)),
                   dot);
    }
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
    if constexpr (kFactored) {
      if (!fresh) dot = fmaf(dot, f0.ks, f0.kz * qsum);
    }
    if (live) {
      const float s = dot * scale;
      if constexpr (kFactored) {
        if (s > m + kLazy) {          // move the reference max
          const float corr = expf(m - s);
          l *= corr;
          accz *= corr;
#pragma unroll
          for (int j = 0; j < C; ++j) acc[j] *= corr;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
        if (fresh) {
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[j] = fmaf(p, s_new[1][col + j], acc[j]);
        } else {
          const float ps = p * f0.vs;
          accz = fmaf(p, f0.vz, accz);
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[j] = fmaf(ps, biased(vw[j >> 2], j & 3), acc[j]);
        }
      } else {
        const float m_new = fmaxf(m, s);
        const float corr = expf(m - m_new);
        const float p = round_to<T>(expf(s - m_new));
        l = l * corr + p;
        if (fresh) {
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[j] = acc[j] * corr + p * s_new[1][col + j];
        } else {
#pragma unroll
          for (int j = 0; j < C; ++j)
            acc[j] = acc[j] * corr +
                     p * round_to<T>(dequant(vw[j >> 2], j & 3, f0.vs, f0.vz));
        }
        m = m_new;
      }
    }
    f0 = f1;
    f1 = f2;
  }
  if constexpr (kFactored) {
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] += accz;
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
    for (int j = 0; j < C; ++j)
      acc[j] = acc[j] * c + __shfl_xor_sync(kFull, acc[j], o) * c_o;
    m = m_n;
  }

  // every warp hands its partial to rank 0 (an empty warp or range has
  // m = -1e30, l = 0, acc = 0 and weighs exp(-1e30 - max) = 0; rank 0
  // holds row 0, so the max is a real score); rank 0 merges by the
  // log-sum-exp rule after the barrier
  const int slot = split * kWarps + warp;
  float* pm = s_pm;
  float* pl = s_pl;
  float* pa = &s_pa[0][0];
  if constexpr (kCluster) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    pm = cluster.map_shared_rank(pm, 0);
    pl = cluster.map_shared_rank(pl, 0);
    pa = cluster.map_shared_rank(pa, 0);
  }
  if (group == 0) {
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(pa + slot * D + col + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    if (lane == 0) {
      pm[slot] = m;
      pl[slot] = l;
    }
  }
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (split == 0) {
    const int slots = (int)gridDim.x * kWarps;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float mx = kNegInf;
      for (int s = 0; s < slots; ++s) mx = fmaxf(mx, s_pm[s]);
      float den = 0.f, num = 0.f;
      for (int s = 0; s < slots; ++s) {
        const float e = expf(s_pm[s] - mx);
        den += s_pl[s] * e;
        num += s_pa[s][c] * e;
      }
      out[qbase + c] = from_f32<T>(num / den);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* kq, const void* vq, const void* ks, const void* kz,
           const void* vs, const void* vz, void* out, int B, int H,
           int64_t pos, int64_t kv_sb, int64_t kv_sw, int64_t sc_sb,
           int64_t sc_sw, float scale, cudaStream_t stream) {
  const int splits = splits_for(pos);
  const int64_t rows_per = (pos + splits) / splits;  // ceil((pos+1)/splits)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)H, (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one range: a plain launch (cheaper than a cluster of one block)
  cfg.numAttrs = splits > 1 ? 1 : 0;
  auto kernel = splits > 1 ? pe_decode_attention_kernel<D, T, true>
                           : pe_decode_attention_kernel<D, T, false>;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(kz), static_cast<const float*>(vs),
      static_cast<const float*>(vz), static_cast<T*>(out), H, pos, rows_per,
      kv_sb, kv_sw, sc_sb, sc_sw, scale);
}

template <typename T>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* kq, const void* vq, const void* ks, const void* kz,
             const void* vs, const void* vz, void* out, int B, int H, int D,
             int64_t pos, int64_t kv_sb, int64_t kv_sw, int64_t sc_sb,
             int64_t sc_sw, float scale, cudaStream_t s) {
#define PE_DECODE_CASE(DIM)                                                 \
  if (D == DIM)                                                             \
    return launch<DIM, T>(q, k_new, v_new, kq, vq, ks, kz, vs, vz, out, B,  \
                          H, pos, kv_sb, kv_sw, sc_sb, sc_sw, scale, s);
  PE_DECODE_CASE(8)
  PE_DECODE_CASE(16)
  PE_DECODE_CASE(32)
  PE_DECODE_CASE(64)
  PE_DECODE_CASE(128)
#undef PE_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k_new, v_new, out: contiguous [B, 1, H, D] (out read as [B, 1, H*D]).
// k_q, v_q: int8, element (b, r, h, d) at b*kv_sb + r*kv_sw + h*D + d, the
// base and both strides 16-byte aligned. k_scale ... v_shift: f32, element
// (b, r, h) at b*sc_sb + r*sc_sw + h. Rows 0..pos are read. dtype 0 = f32,
// 1 = bf16. D in {8, 16, 32, 64, 128}; B and H at most 65535 (ops/
// decode_attention.py launches larger B in chunks, and window_refusal
// states the rest). One cluster launch; a refused launch returns its
// error code.
int pe_decode_attention(const void* q, const void* k_new, const void* v_new,
                        const void* k_q, const void* v_q, const void* k_scale,
                        const void* k_shift, const void* v_scale,
                        const void* v_shift, void* out, int dtype, int B,
                        int H, int D, int64_t pos, int64_t kv_sb,
                        int64_t kv_sw, int64_t sc_sb, int64_t sc_sw,
                        float scale, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || pos < 0 ||
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

// The number of row ranges (cluster size) the launch takes at `pos`.
int pe_decode_attention_splits(int64_t pos) { return splits_for(pos); }

}  // extern "C"
