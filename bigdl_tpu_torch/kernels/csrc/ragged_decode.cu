// Ragged decode attention for Hopper (sm_90a): one decode token per
// slot attends only the first lengths[slot] rows of its KV cache.
//
// Replaces bigdl_tpu/kernels/ragged_decode.py:_decode_kernel (the
// Pallas TPU kernel, launched by ragged_decode_attention there). It
// computes the same function — softmax((q * scale) . k_j) over
// j < clamp(lengths[slot], 1, T), times V, in float32 — but not tile by
// tile: the TPU walks block_k tiles of one (slot, head) in a sequential
// grid step; here the keys of a (slot, head) are split across blocks,
// each streaming its chunk through a cp.async ring, and a second kernel
// merges the blocks' online-softmax partials (decode_common.cuh has the
// design; this file supplies its row addresser, key j of a slot at
// kp + j * k_st).
//
// Bound: device-memory bytes. Each valid K and V row is read once, so a
// launch moves sum_s clamp(len_s, 1, T) * H * D * 2 * itemsize bytes
// (plus q and the output), at most 3.35 TB/s on an H100 SXM. At the
// serving slice's shape (16 slots, 8 heads, D 64, T 512, f32) that is
// 15.8 MB at its ragged lengths (4.7 us) and 33.5 MB with every slot
// full (10 us); one slot at T = 8192 is 33.5 MB too. The arithmetic is
// 4 flops per cached element, far below the card's ridge point.
//
// Only rows below a slot's length are read (the whole point of the TPU
// kernel: a slot 17 tokens into a 512 bucket reads 17 rows), through
// the strides the caller gives: it passes a non-contiguous [slots, H,
// T, D] view of the cache and nothing is copied. Takes float32,
// bfloat16 and float16, any head_dim 1-256.
// Not yet done: see decode_common.cuh.

#include "decode_common.cuh"

namespace {

// Key / value rows of one (slot, head), r0, r0 + step, ...: a strided
// [T, D] stripe of the [slots, H, T, D] cache.
template <typename T>
struct StripeWalk {
  const T* kr;
  const T* vr;
  int64_t k_step, v_step;
  __device__ __forceinline__ const T* k_row(const int*) const { return kr; }
  __device__ __forceinline__ const T* v_row(const int*) const { return vr; }
  __device__ __forceinline__ void next() {
    kr += k_step;
    vr += v_step;
  }
};

template <typename T>
struct ContiguousRows {
  static constexpr bool kStaged = false;
  const T* k;
  const T* v;
  int64_t k_ss, k_sh, k_st, v_ss, v_sh, v_st;

  bool aligned16() const {
    const int64_t s = static_cast<int64_t>(sizeof(T));
    return (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
                   16 == 0 &&
           (k_ss * s | k_sh * s | k_st * s | v_ss * s | v_sh * s | v_st * s) %
                   16 == 0;
  }
  size_t staged_bytes(int) const { return 0; }
  __device__ __forceinline__ void stage(int*, int, int, int) const {}
  // row j of the walk's first row, advancing by `step` rows
  __device__ __forceinline__ StripeWalk<T> walk(int slot, int head, int j,
                                                int step, int) const {
    return {k + slot * k_ss + head * k_sh + j * k_st,
            v + slot * v_ss + head * v_sh + j * v_st, step * k_st,
            step * v_st};
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* partials, int slots, int heads, int t_len, int d,
           int stage_keys, int chunk, int splits, int64_t q_ss, int64_t q_sh,
           int64_t k_ss, int64_t k_sh, int64_t k_st, int64_t v_ss,
           int64_t v_sh, int64_t v_st, int64_t o_ss, int64_t o_sh,
           float sm_scale, int device, void* stream) {
  const ContiguousRows<T> rows{static_cast<const T*>(k),
                               static_cast<const T*>(v),
                               k_ss, k_sh, k_st, v_ss, v_sh, v_st};
  return bigdl_decode::launch<T>(q, lengths, out, partials, rows, slots,
                                 heads, t_len, d, stage_keys, chunk, splits,
                                 q_ss, q_sh, o_ss, o_sh, sm_scale, device,
                                 stream);
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; strides are in elements; the last dimension of q, k, v and
// out is contiguous. The plan (stage_keys, chunk, splits) is
// decode_plan's in kernels/ragged_decode.py; partials is float32
// scratch of slots * heads * splits * (d + 2) elements, not read when
// splits == 1. Returns the first launch's cudaError_t that is not
// cudaSuccess (0 = launched).
#define BIGDL_RAGGED_ENTRY(SUFFIX, T)                                         \
  extern "C" int bigdl_ragged_decode_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const int* lengths,        \
      void* out, float* partials, int slots, int heads, int t_len, int d,     \
      int stage_keys, int chunk, int splits, int64_t q_ss, int64_t q_sh,      \
      int64_t k_ss, int64_t k_sh, int64_t k_st, int64_t v_ss, int64_t v_sh,   \
      int64_t v_st, int64_t o_ss, int64_t o_sh, float sm_scale, int device,   \
      void* stream) {                                                         \
    return launch<T>(q, k, v, lengths, out, partials, slots, heads, t_len, d, \
                     stage_keys, chunk, splits, q_ss, q_sh, k_ss, k_sh, k_st, \
                     v_ss, v_sh, v_st, o_ss, o_sh, sm_scale, device, stream); \
  }

BIGDL_RAGGED_ENTRY(f32, float)
BIGDL_RAGGED_ENTRY(bf16, __nv_bfloat16)
BIGDL_RAGGED_ENTRY(f16, __half)

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
