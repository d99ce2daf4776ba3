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
// Here the kernels are K3's (decode_common.cuh, shared with
// ragged_decode.cu: keys split across blocks under the same plan,
// streamed through a cp.async ring, partials merged in split order),
// with this file's paged addresser. A block first stages the slice of
// its slot's table row that its chunk covers in shared memory; each
// copying thread then walks its rows with the page and the row in the
// page advanced incrementally (one division per thread per block, none
// per key), so no key's load waits on a table read. K3's keys, warps,
// order and arithmetic are untouched, so on a paged view of a
// contiguous cache the result is bitwise K3's for any page size and any
// table (shuffled tables included); the TPU kernel's tiles are its
// pages, which ties it to the contiguous kernel only at page ==
// block_k. Lengths clamp to [1, pages_per_slot * P]; rows past a slot's
// length, and so pages past ceil(n / P), are never read, and their
// table entries never staged.
//
// Bound: device-memory bytes, as K3: each valid K and V row read once,
// at most 3.35 TB/s on an H100 SXM, plus the table's 4 bytes a page.
// Not yet done: see decode_common.cuh.

#include "decode_common.cuh"

namespace {

// Key / value rows of one (slot, head), r0, r0 + step, ...: `page` is
// an index into the block's staged slice of the table row.
template <typename T>
struct PageWalk {
  const T* kp;  // the pools at this head
  const T* vp;
  int64_t k_sp, k_st, v_sp, v_st;
  int page, row, step_pages, step_rows, page_size;
  __device__ __forceinline__ const T* k_row(const int* tab) const {
    return kp + tab[page] * k_sp + row * k_st;
  }
  __device__ __forceinline__ const T* v_row(const int* tab) const {
    return vp + tab[page] * v_sp + row * v_st;
  }
  __device__ __forceinline__ void next() {
    page += step_pages;
    row += step_rows;
    if (row >= page_size) {
      row -= page_size;
      ++page;
    }
  }
};

template <typename T>
struct PagedRows {
  static constexpr bool kStaged = true;
  const T* k;
  const T* v;
  const int* table;
  int pages_per_slot, page_size;
  int64_t k_sp, k_sh, k_st, v_sp, v_sh, v_st;

  bool aligned16() const {
    const int64_t s = static_cast<int64_t>(sizeof(T));
    return (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
                   16 == 0 &&
           (k_sp * s | k_sh * s | k_st * s | v_sp * s | v_sh * s | v_st * s) %
                   16 == 0;
  }
  // table entries [j0 / P, ceil(j1 / P)) of a chunk: at most
  // chunk / P + 2, padded to 16 bytes
  size_t staged_bytes(int chunk) const {
    return (static_cast<size_t>(chunk / page_size + 2) * sizeof(int) + 15) /
           16 * 16;
  }
  __device__ __forceinline__ void stage(int* tab, int slot, int j0,
                                        int j1) const {
    const int p0 = j0 / page_size;
    const int p1 = (j1 + page_size - 1) / page_size;
    const int* row = table + static_cast<int64_t>(slot) * pages_per_slot;
    for (int i = threadIdx.x; i < p1 - p0; i += bigdl_decode::kThreads)
      tab[i] = row[p0 + i];
  }
  // row j of the walk's first row, advancing by `step` rows; j0 the
  // block's first key (the staged slice starts at its page)
  __device__ __forceinline__ PageWalk<T> walk(int, int head, int j, int step,
                                              int j0) const {
    return {k + head * k_sh, v + head * v_sh, k_sp, k_st, v_sp, v_st,
            j / page_size - j0 / page_size, j % page_size,
            step / page_size, step % page_size, page_size};
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* out, float* partials, int slots,
           int heads, int pages_per_slot, int page_size, int d,
           int stage_keys, int chunk, int splits, int64_t q_ss, int64_t q_sh,
           int64_t k_sp, int64_t k_sh, int64_t k_st, int64_t v_sp,
           int64_t v_sh, int64_t v_st, int64_t o_ss, int64_t o_sh,
           float sm_scale, int device, void* stream) {
  if (pages_per_slot < 1 || page_size < 1 ||
      static_cast<int64_t>(pages_per_slot) * page_size > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<T> rows{static_cast<const T*>(k), static_cast<const T*>(v),
                          table, pages_per_slot, page_size,
                          k_sp, k_sh, k_st, v_sp, v_sh, v_st};
  return bigdl_decode::launch<T>(q, lengths, out, partials, rows, slots,
                                 heads, pages_per_slot * page_size, d,
                                 stage_keys, chunk, splits, q_ss, q_sh, o_ss,
                                 o_sh, sm_scale, device, stream);
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; strides are in elements (k / v: page, head, row); the last
// dimension of q, the pools and out is contiguous; page_table is a
// contiguous int32 [slots, pages_per_slot]. The plan (stage_keys,
// chunk, splits) is K3's at T = pages_per_slot * page_size; partials
// as for K3. Returns the first launch's cudaError_t that is not
// cudaSuccess (0 = launched).
#define BIGDL_PAGED_ENTRY(SUFFIX, T)                                          \
  extern "C" int bigdl_paged_decode_##SUFFIX(                                 \
      const void* q, const void* k, const void* v, const int* table,          \
      const int* lengths, void* out, float* partials, int slots, int heads,   \
      int pages_per_slot, int page_size, int d, int stage_keys, int chunk,    \
      int splits, int64_t q_ss, int64_t q_sh, int64_t k_sp, int64_t k_sh,     \
      int64_t k_st, int64_t v_sp, int64_t v_sh, int64_t v_st, int64_t o_ss,   \
      int64_t o_sh, float sm_scale, int device, void* stream) {               \
    return launch<T>(q, k, v, table, lengths, out, partials, slots, heads,    \
                     pages_per_slot, page_size, d, stage_keys, chunk, splits, \
                     q_ss, q_sh, k_sp, k_sh, k_st, v_sp, v_sh, v_st, o_ss,    \
                     o_sh, sm_scale, device, stream);                         \
  }

BIGDL_PAGED_ENTRY(f32, float)
BIGDL_PAGED_ENTRY(bf16, __nv_bfloat16)
BIGDL_PAGED_ENTRY(f16, __half)

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
