// Device code shared by the two decode-attention sources for Hopper
// (sm_90a): the ragged decode kernel K3 (ragged_decode.cu), which reads
// each slot's KV rows from one strided [T, D] stripe of the cache, and
// the paged decode kernel K4 (paged_decode.cu), which reads them
// through a page table from [pages, H, P, D] pools.
//
// Both compute one decode step, softmax((q * scale) . k_j) over
// j < n = clamp(lengths[slot], 1, T), times V, in float32. The kernels
// below are written once over a row addresser (Rows, a template
// parameter): it stages what it needs in shared memory before the first
// copy, and gives each copying thread a walk over its rows. Everything
// that fixes the arithmetic — which block, warp and lane takes which
// key, every product, sum, max and exp, and their order — depends on
// key indices and the plan (chunk) only, never on the addresser, so on
// a paged view of the same cache K4 is bitwise equal to K3, for any
// page size and any table.
//
// Bound: device-memory bytes. Each valid K and V row is read once:
// sum_s n_s * H * D * 2 * itemsize bytes (plus q and the output), at
// most 3.35 TB/s on an H100 SXM; 4 flops per cached element, far below
// the card's ridge point. What stands between a decode kernel and that
// bound is latency: a block that walks its keys in a chain of
// dependent loads keeps a few KB in flight and waits a DRAM round trip
// a step, and one block per (slot, head) leaves a long slot's chain to
// one SM.
//
// Design against it:
//  * keys split across blocks: the grid is slots x heads x splits, and
//    block (slot, head, split) owns keys [split * chunk, (split + 1) *
//    chunk) of its slot — the plan (chunk, splits) comes from the
//    wrapper (decode_plan in kernels/ragged_decode.py), a function of
//    the shapes only, so the host never reads lengths; a block whose
//    chunk starts at or past n returns at once;
//  * the chunk's K and V rows stream into shared memory through a
//    cp.async ring of NS = 3 stages of SK rows (8 KB a tensor a stage):
//    every stage of the ring is issued before the first wait, so a
//    block has up to 48 KB in flight instead of a chain of loads.
//    16-byte copies where the row bytes and every base and stride allow
//    it, else the same ring filled element by element. Rows past n are
//    zero-filled in shared memory, never read from device memory, and
//    masked; columns past head_dim are zero in every ring row;
//  * the four warps score the stage's keys from shared memory in
//    float32, SK / 4 consecutive keys each, lane l holding head-dim
//    elements l, l + 32, ...; each warp keeps an online-softmax carry
//    (m, l, acc), and the four merge in shared memory at the end;
//  * with one split the block writes the normalised output; with more
//    it writes its partial (m, l, acc[d]) in float32 to per-call
//    scratch, and a second kernel (decode_merge_kernel) combines the
//    first ceil(n / chunk) partials of each (slot, head) in split
//    order: no atomics, so two calls give the same bits.
// Not yet done: the merge folded into the last block of a (slot, head)
// over a ticket counter (one launch instead of two), TMA bulk copies in
// place of per-thread cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace bigdl_decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// bytes of one tensor's rows a ring stage aims at
constexpr int kStageBytes = 8192;
// the merge kernel's threads, the loads each has in flight, and the
// most splits it combines
constexpr int kMergeThreads = 256;
constexpr int kMergeBatch = 16;
constexpr int kMaxSplits = 128;
// dynamic shared memory a kernel may take without opting in
constexpr size_t kDefaultSmem = 48 << 10;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of one head-dim width DT (32, 64, 128 or 256; head_dim <= DT,
// columns past it zero): SK keys a stage (kStageBytes of one tensor, at
// most 64 keys), a ring of NS stages — 48 KB of shared memory a block,
// so four blocks are resident on an SM — KPW keys a warp scores a
// stage, DPL head-dim elements a lane holds. kernels/ragged_decode.py's
// stage_keys mirrors SK.
template <typename T, int DT>
struct Tile {
  static constexpr int kRaw = kStageBytes / (DT * static_cast<int>(sizeof(T)));
  static constexpr int SK = kRaw > 64 ? 64 : kRaw;
  static constexpr int NS = 3;
  static constexpr int KPW = SK / kWarps;
  static constexpr int DPL = DT / 32;
  // K then V of each stage; the warps' merge reuses the ring's start
  static constexpr size_t kRingBytes =
      static_cast<size_t>(NS) * 2 * SK * DT * sizeof(T);
  static_assert(kRingBytes >= sizeof(float) * kWarps * (DT + 2),
                "the merge area fits in the ring");
};

// One block per (slot, head, split): keys [split * chunk, min((split +
// 1) * chunk, n)) through the ring, scored by four warps, merged, and
// written as the output (splits == 1) or as the partial (m, l, acc[d])
// at partials[((slot * heads + head) * splits + split) * (d + 2)].
// vec: 16-byte copies (row bytes and every base and stride aligned).
template <typename T, int DT, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ partials, Rows rows, int heads,
                        int t_len, int d, int chunk, int splits, int64_t q_ss,
                        int64_t q_sh, int64_t o_ss, int64_t o_sh,
                        float sm_scale, bool vec) {
  using C = Tile<T, DT>;
  constexpr int SK = C::SK, NS = C::NS, KPW = C::KPW, DPL = C::DPL;
  extern __shared__ __align__(16) uint8_t decode_smem[];
  T* ring = reinterpret_cast<T*>(decode_smem);
  int* tab = reinterpret_cast<int*>(decode_smem + C::kRingBytes);

  const int split = blockIdx.x % splits;
  const int sh = blockIdx.x / splits;
  const int head = sh % heads;
  const int slot = sh / heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int n = lengths[slot];
  n = n < 1 ? 1 : (n > t_len ? t_len : n);
  const int j0 = split * chunk;
  if (j0 >= n) return;  // block-uniform, before any barrier
  const int j1 = min(j0 + chunk, n);
  const int stages = (j1 - j0 + SK - 1) / SK;

  // the addresser's shared state (K4: its slice of the table row)
  if constexpr (Rows::kStaged) {
    rows.stage(tab, slot, j0, j1);
    __syncthreads();
  }

  // copy layout: a row is cpr copies of vw elements, taken by cw
  // threads; rs rows at a time (a power of two dividing SK), so each
  // copying thread walks rows r0, r0 + rs, ... of the chunk
  const int vw = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int cpr = d / vw;
  const int cw = cpr < kThreads ? cpr : kThreads;
  int rs = 1;
  while (rs * 2 * cw <= kThreads && rs * 2 <= SK) rs *= 2;
  const int r0 = threadIdx.x / cw;
  const int c0 = threadIdx.x % cw;
  const bool copier = r0 < rs;
  auto walk = rows.walk(slot, head, j0 + r0, rs, j0);

  // columns past d: zero in every ring row, once (copies never write
  // them), so the products below need no mask
  if (d < DT) {
    for (int e = threadIdx.x; e < NS * 2 * SK * (DT - d); e += kThreads) {
      const int row = e / (DT - d);
      ring[row * DT + d + e % (DT - d)] = from_f32<T>(0.f);
    }
  }

  // stage s -> ring slot s % NS: rows [s * SK, (s + 1) * SK) of the
  // chunk; rows at or past j1 zero-filled, not read
  auto issue = [&](int s) {
    if (!copier) return;
    T* kd = ring + (s % NS) * 2 * SK * DT;
    T* vd = kd + SK * DT;
    for (int r = r0; r < SK; r += rs) {
      const bool in = j0 + s * SK + r < j1;
      const T* ks = in ? walk.k_row(tab) : nullptr;
      const T* vs = in ? walk.v_row(tab) : nullptr;
      for (int c = c0; c < cpr; c += cw) {
        T* kdst = kd + r * DT + c * vw;
        T* vdst = vd + r * DT + c * vw;
        if (vec) {
          if (in) {
            cp_async16(kdst, ks + c * vw);
            cp_async16(vdst, vs + c * vw);
          } else {
            *reinterpret_cast<uint4*>(kdst) = make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(vdst) = make_uint4(0u, 0u, 0u, 0u);
          }
        } else {
          *kdst = in ? ks[c] : from_f32<T>(0.f);
          *vdst = in ? vs[c] : from_f32<T>(0.f);
        }
      }
      walk.next();
    }
  };

  const T* qp = q + slot * q_ss + head * q_sh;
  float qr[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? to_f32(qp[c]) * sm_scale : 0.f;
  }

  // every ring stage in flight before the first wait; a group is
  // committed every step, empty or not, so wait<NS - 1> always means
  // "the oldest stage has landed"
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < stages) issue(s);
    cp_async_commit();
  }

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int it = 0; it < stages; ++it) {
    cp_async_wait<NS - 1>();
    __syncthreads();  // stage it has landed in every thread's copies
    const T* kt = ring + (it % NS) * 2 * SK * DT + warp * KPW * DT;
    const T* vt = kt + SK * DT;
    const int jw = j0 + it * SK + warp * KPW;  // the warp's first key
    if (jw < j1) {  // warp-uniform: the shuffles see the whole warp
      float s[KPW];
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          part += qr[i] * to_f32(kt[u * DT + lane + 32 * i]);
        s[u] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < KPW; ++u)
          s[u] += __shfl_xor_sync(kFullMask, s[u], off);
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        if (jw + u < j1) m_new = fmaxf(m_new, s[u]);
      }
      // key jw < j1 is valid, so m_new is finite: on a warp's first
      // stage alpha = exp(-inf) = 0 and the zero carry drops out
      const float alpha = expf(m - m_new);
      float p[KPW];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        p[u] = jw + u < j1 ? expf(s[u] - m_new) : 0.f;
        psum += p[u];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        if (jw + u < j1) {
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[i] += p[u] * to_f32(vt[u * DT + lane + 32 * i]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // every warp is done with ring slot it % NS
    if (it + NS < stages) issue(it + NS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the four warps' carries (in the ring's first bytes, free
  // now); a warp that saw no key keeps m = -inf, l = 0, acc = 0 and
  // its weight exp(-inf - m_all) is 0
  float* sm_acc = reinterpret_cast<float*>(decode_smem);  // [kWarps][DT]
  float* sm_m = sm_acc + kWarps * DT;
  float* sm_l = sm_m + kWarps;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp * DT + lane + 32 * i] = acc[i];
  __syncthreads();

  float m_all = sm_m[0];  // warp 0 always scored key j0: finite
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float wgt[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - m_all);
    l_all += sm_l[w] * wgt[w];
  }
  float* part =
      splits == 1
          ? nullptr
          : partials + ((static_cast<int64_t>(slot) * heads + head) * splits +
                        split) * (d + 2);
  T* op = out + slot * o_ss + head * o_sh;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w * DT + c] * wgt[w];
    if (part == nullptr)
      op[c] = from_f32<T>(a / l_all);
    else
      part[2 + c] = a;
  }
  if (part != nullptr && threadIdx.x == 0) {
    part[0] = m_all;
    part[1] = l_all;
  }
}

// One block per (slot, head): the first ceil(n / chunk) partials in
// split order -> m_all, weights exp(m_s - m_all), l_all, and the
// output sum_s acc_s * w_s / l_all in T. The latency is the kernel's
// cost, so every split's partial is loaded into shared memory at once,
// beside the slot's length (rows of splits a short slot never wrote are
// loaded too, and never used): one round trip to device memory.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const float* __restrict__ partials,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int heads, int t_len, int d, int chunk, int splits,
                        int64_t o_ss, int64_t o_sh) {
  extern __shared__ __align__(16) float merge_smem[];
  float* wgt = merge_smem;           // [kMaxSplits]
  float* part = wgt + kMaxSplits;    // [splits][d + 2]
  const int slot = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int width = d + 2;
  const int total = splits * width;
  const float* p = partials + static_cast<int64_t>(blockIdx.x) * total;
  int n = lengths[slot];
  for (int e0 = 0; e0 < total; e0 += kMergeThreads * kMergeBatch) {
    float r[kMergeBatch];
#pragma unroll
    for (int b = 0; b < kMergeBatch; ++b) {
      const int e = e0 + b * kMergeThreads + threadIdx.x;
      r[b] = e < total ? p[e] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kMergeBatch; ++b) {
      const int e = e0 + b * kMergeThreads + threadIdx.x;
      if (e < total) part[e] = r[b];
    }
  }
  n = n < 1 ? 1 : (n > t_len ? t_len : n);
  const int used = (n + chunk - 1) / chunk;
  __syncthreads();
  float m_all = part[0];
  for (int s = 1; s < used; ++s) m_all = fmaxf(m_all, part[s * width]);
  for (int s = threadIdx.x; s < used; s += kMergeThreads)
    wgt[s] = expf(part[s * width] - m_all);
  __syncthreads();
  float l_all = 0.f;
  for (int s = 0; s < used; ++s) l_all += part[s * width + 1] * wgt[s];
  T* op = out + slot * o_ss + head * o_sh;
  for (int c = threadIdx.x; c < d; c += kMergeThreads) {
    float a = 0.f;
    for (int s = 0; s < used; ++s) a += part[s * width + 2 + c] * wgt[s];
    op[c] = from_f32<T>(a / l_all);
  }
}

template <typename T, int DT, typename Rows>
int launch_tile(const T* q, const int* lengths, T* out, float* partials,
                const Rows& rows, int slots, int heads, int t_len, int d,
                int stage_keys, int chunk, int splits, int64_t q_ss,
                int64_t q_sh, int64_t o_ss, int64_t o_sh, float sm_scale,
                cudaStream_t stream) {
  using C = Tile<T, DT>;
  if (stage_keys != C::SK || chunk % C::SK)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d * sizeof(T) % 16 == 0 && rows.aligned16();
  const size_t smem = C::kRingBytes + rows.staged_bytes(chunk);
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem)
    err = cudaFuncSetAttribute(decode_split_kernel<T, DT, Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(slots) * heads * splits);
  decode_split_kernel<T, DT, Rows><<<grid, kThreads, smem, stream>>>(
      q, lengths, out, partials, rows, heads, t_len, d, chunk, splits, q_ss,
      q_sh, o_ss, o_sh, sm_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t merge_smem =
      (kMaxSplits + static_cast<size_t>(splits) * (d + 2)) * sizeof(float);
  if (merge_smem > kDefaultSmem)
    err = cudaFuncSetAttribute(decode_merge_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(merge_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid(static_cast<unsigned>(slots) * heads);
  decode_merge_kernel<T><<<merge_grid, kMergeThreads, merge_smem, stream>>>(
      partials, lengths, out, heads, t_len, d, chunk, splits, o_ss, o_sh);
  return static_cast<int>(cudaGetLastError());
}

// Launch the split kernel (and, with splits > 1, the merge) on `stream`
// under the plan (stage_keys, chunk, splits): chunk a multiple of the
// tile's stage_keys, splits = ceil(t_len / chunk) <= kMaxSplits, and
// partials [slots, heads, splits, d + 2] float32 when splits > 1.
// Returns the first launch's cudaError_t that is not cudaSuccess.
template <typename T, typename Rows>
int launch(const void* q, const int* lengths, void* out, float* partials,
           const Rows& rows, int slots, int heads, int t_len, int d,
           int stage_keys, int chunk, int splits, int64_t q_ss, int64_t q_sh,
           int64_t o_ss, int64_t o_sh, float sm_scale, int device,
           void* stream) {
  if (slots < 1 || heads < 1 || t_len < 1 || d < 1 || d > 256 ||
      chunk < 1 || splits < 1 || splits > kMaxSplits ||
      static_cast<int64_t>(splits - 1) * chunk >= t_len ||
      static_cast<int64_t>(splits) * chunk < t_len ||
      static_cast<int64_t>(slots) * heads * splits > 0x7fffffff ||
      (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
#define BIGDL_DECODE_TILE(DT)                                               \
  return launch_tile<T, DT, Rows>(qt, lengths, ot, partials, rows, slots,   \
                                  heads, t_len, d, stage_keys, chunk,       \
                                  splits, q_ss, q_sh, o_ss, o_sh, sm_scale, \
                                  st);
  if (d <= 32) BIGDL_DECODE_TILE(32)
  if (d <= 64) BIGDL_DECODE_TILE(64)
  if (d <= 128) BIGDL_DECODE_TILE(128)
  BIGDL_DECODE_TILE(256)
#undef BIGDL_DECODE_TILE
}

}  // namespace bigdl_decode
