// Paged decode attention for Hopper (sm_90a): one decode token per slot
// attends the first lengths[slot] rows of its KV cache, read through a
// page table from shared page pools.
//
// Replaces bigdl_tpu/kernels/paged_decode.py:_paged_kernel (the Pallas
// TPU kernel, launched by paged_decode_attention there). The pools are
// k_pages / v_pages [num_pages, H, P, D]; page_table [slots,
// pages_per_slot] holds each slot's physical page ids in sequence
// order, so row j of a slot lives in page table[slot, j / P] at row
// j % P. The TPU kernel walks the pages of one (slot, head) as a
// sequential grid axis, each page one online-softmax tile, with the
// table scalar-prefetched into its index maps.
//
// Here the kernel is K3's (decode_common.cuh, shared with
// ragged_decode.cu) with its row address made a template parameter:
// this file supplies the paged addresser, key j at
// pool + table[slot, j / P] * page_stride + (j % P) * row_stride. K3's
// warps, key order and arithmetic are untouched, so on a paged view of
// a contiguous cache the result is bitwise K3's for any page size and
// any table (shuffled tables included); the TPU kernel's tiles are its
// pages, which ties it to the contiguous kernel only at page ==
// block_k. Lengths clamp to [1, pages_per_slot * P]; rows past a slot's
// length, and so pages past ceil(n / P), are never read, and their
// table entries never dereferenced.
//
// Bound: device-memory bytes, as K3: each valid K and V row read once,
// at most 3.35 TB/s on an H100 SXM, plus one 4-byte table read per key
// (cached). Not yet done (a later change): reading a page's rows as one
// tile (the page id once per page instead of once per key), split-K
// across blocks for few slots.

#include "decode_common.cuh"

namespace {

// Key / value row j of one (slot, head) through its row of the table.
template <typename T>
struct PageRows {
  const T* kp;  // the pools at this head
  const T* vp;
  const int* table;  // the slot's row of the page table
  int page_size;
  int64_t k_sp, k_st, v_sp, v_st;
  __device__ __forceinline__ const T* k_row(int j) const {
    return kp + table[j / page_size] * k_sp + (j % page_size) * k_st;
  }
  __device__ __forceinline__ const T* v_row(int j) const {
    return vp + table[j / page_size] * v_sp + (j % page_size) * v_st;
  }
};

template <typename T>
struct PagedRows {
  const T* k;
  const T* v;
  const int* table;
  int pages_per_slot, page_size;
  int64_t k_sp, k_sh, k_st, v_sp, v_sh, v_st;
  __device__ __forceinline__ PageRows<T> at(int slot, int head) const {
    return {k + head * k_sh, v + head * v_sh,
            table + static_cast<int64_t>(slot) * pages_per_slot, page_size,
            k_sp, k_st, v_sp, v_st};
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* out, int slots, int heads,
           int pages_per_slot, int page_size, int d, int64_t q_ss,
           int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_st,
           int64_t v_sp, int64_t v_sh, int64_t v_st, int64_t o_ss,
           int64_t o_sh, float sm_scale, int device, void* stream) {
  if (pages_per_slot < 1 || page_size < 1 ||
      static_cast<int64_t>(pages_per_slot) * page_size > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<T> rows{static_cast<const T*>(k), static_cast<const T*>(v),
                          table, pages_per_slot, page_size,
                          k_sp, k_sh, k_st, v_sp, v_sh, v_st};
  return bigdl_decode::launch<T>(q, lengths, out, rows, slots, heads,
                                 pages_per_slot * page_size, d, q_ss, q_sh,
                                 o_ss, o_sh, sm_scale, device, stream);
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; strides are in elements (k / v: page, head, row); the last
// dimension of q, the pools and out is contiguous; page_table is a
// contiguous int32 [slots, pages_per_slot]. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int bigdl_paged_decode_f32(
    const void* q, const void* k, const void* v, const int* table,
    const int* lengths, void* out, int slots, int heads, int pages_per_slot,
    int page_size, int d, int64_t q_ss, int64_t q_sh, int64_t k_sp,
    int64_t k_sh, int64_t k_st, int64_t v_sp, int64_t v_sh, int64_t v_st,
    int64_t o_ss, int64_t o_sh, float sm_scale, int device, void* stream) {
  return launch<float>(q, k, v, table, lengths, out, slots, heads,
                       pages_per_slot, page_size, d, q_ss, q_sh, k_sp, k_sh,
                       k_st, v_sp, v_sh, v_st, o_ss, o_sh, sm_scale, device,
                       stream);
}

extern "C" int bigdl_paged_decode_bf16(
    const void* q, const void* k, const void* v, const int* table,
    const int* lengths, void* out, int slots, int heads, int pages_per_slot,
    int page_size, int d, int64_t q_ss, int64_t q_sh, int64_t k_sp,
    int64_t k_sh, int64_t k_st, int64_t v_sp, int64_t v_sh, int64_t v_st,
    int64_t o_ss, int64_t o_sh, float sm_scale, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, table, lengths, out, slots, heads,
                               pages_per_slot, page_size, d, q_ss, q_sh, k_sp,
                               k_sh, k_st, v_sp, v_sh, v_st, o_ss, o_sh,
                               sm_scale, device, stream);
}

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
