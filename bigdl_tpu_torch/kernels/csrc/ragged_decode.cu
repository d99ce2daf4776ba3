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
// Design against that bound (the kernel itself is decode_common.cuh's,
// shared with the paged kernel K4; this file supplies its row
// addresser, key j of a slot at kp + j * k_st):
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

#include "decode_common.cuh"

namespace {

// Key / value row j of one (slot, head): a strided [T, D] stripe of the
// [slots, H, T, D] cache.
template <typename T>
struct StripeRows {
  const T* kp;
  const T* vp;
  int64_t k_st, v_st;
  __device__ __forceinline__ const T* k_row(int j) const {
    return kp + j * k_st;
  }
  __device__ __forceinline__ const T* v_row(int j) const {
    return vp + j * v_st;
  }
};

template <typename T>
struct ContiguousRows {
  const T* k;
  const T* v;
  int64_t k_ss, k_sh, k_st, v_ss, v_sh, v_st;
  __device__ __forceinline__ StripeRows<T> at(int slot, int head) const {
    return {k + slot * k_ss + head * k_sh, v + slot * v_ss + head * v_sh,
            k_st, v_st};
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int slots, int heads, int t_len, int d, int64_t q_ss,
           int64_t q_sh, int64_t k_ss, int64_t k_sh, int64_t k_st,
           int64_t v_ss, int64_t v_sh, int64_t v_st, int64_t o_ss,
           int64_t o_sh, float sm_scale, int device, void* stream) {
  const ContiguousRows<T> rows{static_cast<const T*>(k),
                               static_cast<const T*>(v),
                               k_ss, k_sh, k_st, v_ss, v_sh, v_st};
  return bigdl_decode::launch<T>(q, lengths, out, rows, slots, heads, t_len,
                                 d, q_ss, q_sh, o_ss, o_sh, sm_scale, device,
                                 stream);
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
