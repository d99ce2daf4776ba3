// Device code shared by the two decode-attention sources for Hopper
// (sm_90a): the ragged decode kernel K3 (ragged_decode.cu), which reads
// each slot's KV rows from one contiguous [T, D] stripe of the cache,
// and the paged decode kernel K4 (paged_decode.cu), which reads them
// through a page table from [pages, H, P, D] pools.
//
// Both compute one decode step, softmax((q * scale) . k_j) over
// j < n = clamp(lengths[slot], 1, T), times V, in float32. The kernel
// below is written once over a row addresser, a template parameter
// that maps (slot, head) to an object whose k_row(j) / v_row(j) return
// the address of key / value row j. Everything else — which warp reads
// which key, every product, sum, max and exp, and their order — is the
// same code for both, so on a paged view of the same cache K4 is
// bitwise equal to K3, for any page size and any table.
//
// Design (K3's): one thread block owns one (slot, head); its
// four warps split the keys between them, each scoring kKeysPerStep
// keys per step (their loads and shuffle reductions issued together,
// so four memory latencies overlap) and keeping an online-softmax carry
// (m, l, acc); the four carries merge once in shared memory at the end.
// Lane l holds head-dimension elements l, l + 32, ..., so each load
// instruction covers 32 consecutive elements of one row (coalesced)
// through the strides the addresser holds. Only rows below the slot's
// length are read: a slot 17 tokens into a 512 bucket reads 17 rows,
// and a paged slot reads only its first ceil(n / P) pages.
//
// Bound: device-memory bytes. Each valid K and V row is read once:
// sum_s n_s * H * D * 2 * itemsize bytes (plus q and the output), at
// most 3.35 TB/s on an H100 SXM; 4 flops per cached element, far below
// the card's ridge point.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace bigdl_decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerStep = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DPL: elements of the head dimension each lane holds (D = 32 * DPL).
// Rows: the row addresser; rows.at(slot, head) returns an object with
// k_row(j) and v_row(j). t_len: the rows a slot can hold (T, or
// pages_per_slot * P), the clamp of its length.
template <typename T, int DPL, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const int* __restrict__ lengths,
                  T* __restrict__ out, Rows rows, int heads, int t_len,
                  int64_t q_ss, int64_t q_sh, int64_t o_ss, int64_t o_sh,
                  float sm_scale) {
  constexpr int D = DPL * 32;
  const int slot = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int n = lengths[slot];
  n = n < 1 ? 1 : (n > t_len ? t_len : n);

  const T* qp = q + slot * q_ss + head * q_sh;
  const auto kv = rows.at(slot, head);

  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qr[i] = to_f32(qp[lane + 32 * i]) * sm_scale;

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  // warp w takes keys [j0, j0 + kKeysPerStep) for j0 = w * kKeysPerStep,
  // advancing by kWarps * kKeysPerStep; j0 and n are warp-uniform, so
  // every branch below is too and the shuffles see the whole warp
  for (int j0 = warp * kKeysPerStep; j0 < n; j0 += kWarps * kKeysPerStep) {
    float s[kKeysPerStep];
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      float part = 0.f;
      if (j0 + u < n) {
        const T* kr = kv.k_row(j0 + u);
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[i] * to_f32(kr[lane + 32 * i]);
      }
      s[u] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u)
        s[u] += __shfl_xor_sync(kFullMask, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      if (j0 + u < n) m_new = fmaxf(m_new, s[u]);
    }
    // key j0 < n is valid, so m_new is finite: on a warp's first step
    // alpha = exp(-inf) = 0 and the zero carry drops out exactly
    const float alpha = expf(m - m_new);
    float p[kKeysPerStep];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      p[u] = (j0 + u < n) ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      if (j0 + u < n) {
        const T* vr = kv.v_row(j0 + u);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += p[u] * to_f32(vr[lane + 32 * i]);
      }
    }
    m = m_new;
  }

  // merge the four warps' carries; a warp that saw no key keeps
  // m = -inf, l = 0, acc = 0 and its weight exp(-inf - m_all) is 0
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  float m_all = sm_m[0];  // warp 0 always scored key 0: finite
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float wgt[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - m_all);
    l_all += sm_l[w] * wgt[w];
  }
  T* op = out + slot * o_ss + head * o_sh;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wgt[w];
    op[d] = from_f32<T>(a / l_all);
  }
}

// Launch decode_kernel<T, d / 32, Rows> over slots x heads blocks on
// `stream`; returns the launch's cudaError_t (0 = launched).
template <typename T, typename Rows>
int launch(const void* q, const int* lengths, void* out, const Rows& rows,
           int slots, int heads, int t_len, int d, int64_t q_ss,
           int64_t q_sh, int64_t o_ss, int64_t o_sh, float sm_scale,
           int device, void* stream) {
  if (slots < 1 || heads < 1 || t_len < 1 || d < 32 || d > 256 || d % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(slots) * static_cast<unsigned>(heads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
#define BIGDL_DECODE_CASE(DPL)                                              \
  case DPL:                                                                 \
    decode_kernel<T, DPL, Rows><<<grid, kThreads, 0, st>>>(                 \
        qt, lengths, ot, rows, heads, t_len, q_ss, q_sh, o_ss, o_sh,        \
        sm_scale);                                                          \
    break;
  switch (d / 32) {
    BIGDL_DECODE_CASE(1)
    BIGDL_DECODE_CASE(2)
    BIGDL_DECODE_CASE(3)
    BIGDL_DECODE_CASE(4)
    BIGDL_DECODE_CASE(5)
    BIGDL_DECODE_CASE(6)
    BIGDL_DECODE_CASE(7)
    BIGDL_DECODE_CASE(8)
  }
#undef BIGDL_DECODE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bigdl_decode
