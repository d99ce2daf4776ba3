// Ragged decode attention for Hopper (sm_90a): one decode token per
// slot attends only the first lengths[slot] rows of its KV cache.
//
// Replaces bigdl_tpu/kernels/ragged_decode.py:_decode_kernel (the
// Pallas TPU kernel, launched by ragged_decode_attention there). It
// computes the same function — softmax((q * scale) . k_j) over
// j < clamp(lengths[slot], 1, T), times V, in float32 — but not tile by
// tile: the TPU walks block_k tiles of one (slot, head) in a sequential
// grid step; here one thread block owns one (slot, head) and its four
// warps split the keys between them.
//
// Bound: device-memory bytes. Each valid K and V row is read once, so a
// launch moves sum_s clamp(len_s, 1, T) * H * D * 2 * itemsize bytes
// (plus q and the output), at most 3.35 TB/s on an H100 SXM. At the
// serving slice's shape (16 slots, 8 heads, D 64, T 512, f32, every
// slot full) that is 33.5 MB, about 10 us per launch. The arithmetic is
// 4 flops per cached element, far below the card's ridge point.
//
// Design against that bound:
//  * only rows below the slot's length are read — the whole point of
//    the TPU kernel; a slot 17 tokens into a 512 bucket reads 17 rows;
//  * each K / V row is read by one warp, lane l holding elements
//    l, l+32, ..., so every load instruction covers 32 consecutive
//    elements (coalesced) through the strides it is given: the caller
//    passes a non-contiguous [slots, H, T, D] view of the cache and
//    nothing is copied;
//  * a warp scores kKeysPerStep keys per step, issuing their loads and
//    their shuffle reductions together, so four memory latencies
//    overlap instead of queueing;
//  * each warp keeps an online-softmax carry (m, l, acc); the four
//    carries are merged once in shared memory at the end.
// Not yet done (a later change): split-K across blocks when
// slots * heads < SMs, cp.async / TMA prefetch, bf16 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths,
                         T* __restrict__ out, int heads, int t_len,
                         int64_t q_ss, int64_t q_sh, int64_t k_ss,
                         int64_t k_sh, int64_t k_st, int64_t v_ss,
                         int64_t v_sh, int64_t v_st, int64_t o_ss,
                         int64_t o_sh, float sm_scale) {
  constexpr int D = DPL * 32;
  const int slot = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int n = lengths[slot];
  n = n < 1 ? 1 : (n > t_len ? t_len : n);

  const T* qp = q + slot * q_ss + head * q_sh;
  const T* kp = k + slot * k_ss + head * k_sh;
  const T* vp = v + slot * v_ss + head * v_sh;

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
        const T* kr = kp + (j0 + u) * k_st;
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
        const T* vr = vp + (j0 + u) * v_st;
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int slots, int heads, int t_len, int d, int64_t q_ss,
           int64_t q_sh, int64_t k_ss, int64_t k_sh, int64_t k_st,
           int64_t v_ss, int64_t v_sh, int64_t v_st, int64_t o_ss,
           int64_t o_sh, float sm_scale, int device, void* stream) {
  if (slots < 1 || heads < 1 || t_len < 1 || d < 32 || d > 256 || d % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(slots) * static_cast<unsigned>(heads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define BIGDL_RAGGED_CASE(DPL)                                              \
  case DPL:                                                                 \
    ragged_decode_kernel<T, DPL><<<grid, kThreads, 0, st>>>(                \
        qt, kt, vt, lengths, ot, heads, t_len, q_ss, q_sh, k_ss, k_sh, k_st, \
        v_ss, v_sh, v_st, o_ss, o_sh, sm_scale);                            \
    break;
  switch (d / 32) {
    BIGDL_RAGGED_CASE(1)
    BIGDL_RAGGED_CASE(2)
    BIGDL_RAGGED_CASE(3)
    BIGDL_RAGGED_CASE(4)
    BIGDL_RAGGED_CASE(5)
    BIGDL_RAGGED_CASE(6)
    BIGDL_RAGGED_CASE(7)
    BIGDL_RAGGED_CASE(8)
  }
#undef BIGDL_RAGGED_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; strides are in elements; the last dimension of q, k, v and
// out is contiguous. Returns the launch's cudaError_t (0 = launched).
extern "C" int bigdl_ragged_decode_f32(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, int slots, int heads, int t_len, int d, int64_t q_ss,
    int64_t q_sh, int64_t k_ss, int64_t k_sh, int64_t k_st, int64_t v_ss,
    int64_t v_sh, int64_t v_st, int64_t o_ss, int64_t o_sh, float sm_scale,
    int device, void* stream) {
  return launch<float>(q, k, v, lengths, out, slots, heads, t_len, d, q_ss,
                       q_sh, k_ss, k_sh, k_st, v_ss, v_sh, v_st, o_ss, o_sh,
                       sm_scale, device, stream);
}

extern "C" int bigdl_ragged_decode_bf16(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, int slots, int heads, int t_len, int d, int64_t q_ss,
    int64_t q_sh, int64_t k_ss, int64_t k_sh, int64_t k_st, int64_t v_ss,
    int64_t v_sh, int64_t v_st, int64_t o_ss, int64_t o_sh, float sm_scale,
    int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, out, slots, heads, t_len, d,
                               q_ss, q_sh, k_ss, k_sh, k_st, v_ss, v_sh, v_st,
                               o_ss, o_sh, sm_scale, device, stream);
}

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
