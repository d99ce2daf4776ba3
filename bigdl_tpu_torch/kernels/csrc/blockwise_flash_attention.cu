// Blockwise (online-softmax) flash attention for Hopper (sm_90a): the
// long-context training kernel, forward and backward of
// softmax((q * scale) . k^T, causal and/or same-segment mask) . v over
// [B, H, S, D] tensors, with the float32 log-sum-exp saved for the
// backward.
//
// Replaces bigdl_tpu/kernels/flash_attention.py's K2: the forward body
// _bw_fwd_kernel (launched by _bw_fwd_call) and the two backward bodies
// _bw_dq_kernel and _bw_dkv_kernel (launched by _bw_bwd_call). It
// computes the same function with the TPU kernel's carry: masked scores
// are -inf, and each query tile carries a running (m, l, acc) over the
// key tiles, rescaled by exp(m_old - m_new) at each one (alpha = 0 while
// every lane so far was masked, p = 0 on masked lanes), so a fully
// masked row gives o = 0 and lse = -inf and never NaN. The scale
// multiplies the q . k^T product (the TPU kernel scales q before it:
// the same value to within a rounding). The backward recomputes p from
// the saved lse. The TPU kernel's block_q / block_k are VMEM choices;
// here the tiles are 64 x 64, as in K1.
//
// Bound, at the long-context slice's shape (B 1, H 8, S 8192, D 64,
// causal): arithmetic. The forward does 4 * D flops per kept (query,
// key) pair: 6.9e10 here. In float32 that is 0.42 ms at the 165 TFLOP/s
// that 3xTF32 gets from the tensor cores' 495 TFLOP/s TF32 rate (1.03
// ms at the 67 TFLOP/s float32 SIMT rate), against 67 MB of q, k, v and
// O (20 us at 3.35 TB/s). In bfloat16 and float16 it is 0.0695 ms at
// the 989 TFLOP/s 16-bit rate against 0.0101 ms of bytes (P . V runs
// twice for the hi + lo split, so the MMAs issued are 1.5x the bound's).
// The backward (flash_common.cuh) does about 2.5x the forward's flops.
// At S = 32768 both are 16x that.
//
// Design against that bound:
//  * one block of four warps per (b, h, 64-row query tile) walks the key
//    tiles ONCE, FlashAttention-2's forward: per tile S = q . k^T and
//    acc += P . V. Warp w owns query rows 16w .. 16w + 15, so a row's
//    max and sum reduce over the 4 lanes of an mma quad, and P goes from
//    the S accumulators straight into the P . V product as its A operand
//    (no score tile in shared memory); the softmax runs in log2 units
//    (exp2, and lse = (m + log2 l) ln 2), fewer instructions than exp
//    where instruction slots are the bound;
//  * float32 runs both products in 3xTF32 on the tensor cores
//    (flash_common.cuh has the split, and the score_tile, pv_tile and
//    store_forward that K1's forward shares), each tile's P . V added
//    into the float32 carry outside the MMA accumulators (promote); its
//    K and V tiles stream through a cp.async ring of two;
//  * bfloat16 and float16 run blockwise_fwd16: 16-bit tiles (rows D + 8)
//    filled by 16-byte cp.async through a ring of three, the strip's q
//    fragments loaded once and held in registers, S one m16n8k16 MMA a
//    product (strip_by_rows), P split into hi + lo in T for P . V
//    (strip_times_tile), the carry float32; the key tiles that share no
//    segment id with the query tile are flagged first (mark_tiles) and
//    neither loaded nor computed, and the keep-mask runs only on edge,
//    diagonal and segmented tile pairs. On an H100 it takes about 0.51
//    ms at [1, 8, 8192, 64] (2.6x SDPA; PERF.md): where 3xTF32 on
//    upcast tiles took 2.70;
//  * causal blocks stop at the diagonal tile, and the longest query
//    tiles (the last) start first, so they do not form the tail of the
//    grid; tiles that need no mask skip it;
//  * O is written in q's dtype and the f32 lse in K1's layout, so the
//    backward — delta, dK/dV per key tile and dQ per query tile, no
//    atomics; wgmma in 16 bits — is flash_common.cuh's, shared with K1;
//  * q, k and v are read in place through their (batch, head, row)
//    strides; head dims 1-128 run in the narrowest 16/32/64/128 tile
//    width that holds them; any S (edge tiles are bounds-checked).

#include "flash_common.cuh"

namespace {

// Depth of the 16-bit forward's (k, v) ring: the copies of the next
// kRing16 - 1 kept key tiles are in flight while one is computed (three
// ran 0.4-0.6% faster than two on an H100 at [1, 8, 8192, 64]; PERF.md).
constexpr int kRing16 = 3;

// Shared memory of a 16-bit forward block: the query tile and a ring of
// kRing16 (k, v) tiles in T, the query tile's and the ring's segment
// ids, and mark_tiles' heads and flags.
template <int D>
constexpr size_t blockwise_fwd16_smem_bytes(int s_len) {
  return 2 * (1 + 2 * kRing16) * kTile * tile_ld16<D>() +
         sizeof(int) * (1 + kRing16) * kTile + tile_marks_bytes(s_len);
}

// blockwise_fwd_kernel for bfloat16 and float16: the same one walk over
// the key tiles with the online-softmax carry, on 16-bit tiles staged
// by 16-byte cp.async into a ring of kRing16. S = q . k^T is one
// m16n8k16 MMA a product from the strip's q fragments (loaded once,
// held across every key tile); P . V reads V with ldmatrix.trans and
// takes two, P split into hi + lo in T as it becomes the A operand
// (flash_common.cuh has why). The carry (m, l, acc), the rescale
// exp2(m_old - m_new) and lse stay float32. The key tiles that share no
// segment id with the query tile are flagged first (mark_tiles) and
// neither loaded nor computed; the keep-mask runs only where segments,
// the causal diagonal or the edge of S call for it.
template <typename T, int D>
__device__ __forceinline__ void blockwise_fwd16(const Params& p) {
  constexpr int LD = tile_ld16<D>();
  constexpr int KN = kTile / 8;             // 8-key tiles of S
  extern __shared__ __align__(16) float tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);    // [64][LD]
  T* ks = qs + kTile * LD;                  // [kRing16][64][LD]
  T* vs = ks + kRing16 * kTile * LD;        // [kRing16][64][LD]
  int* seg_q = reinterpret_cast<int*>(vs + kRing16 * kTile * LD);
  int* seg_k = seg_q + kTile;               // [kRing16][64]
  int* heads = seg_k + kRing16 * kTile;
  unsigned char* flags = reinterpret_cast<unsigned char*>(heads + kTile + 1);

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  // the longest query tiles (under causal, the last) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  auto stage_key_side = [&](int kt, int slot) {
    const int k0 = kt * kTile;
    stage_tile16<T, D>(ks + slot * kTile * LD, kb, p.sk.s, k0, s_len, p.d,
                       p.vec);
    stage_tile16<T, D>(vs + slot * kTile * LD, vb, p.sv.s, k0, s_len, p.d,
                       p.vec);
    if (segmented) stage_rows(seg_k + slot * kTile, seg_row, k0, s_len);
  };

  stage_tile16<T, D>(qs,
                     static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                     p.sq.s, q0, s_len, p.d, p.vec);
  if (segmented) stage_rows(seg_q, seg_row, q0, s_len);
  cp_async_commit();
  const int n_kt = key_tiles(q0, s_len, p.causal);
  if (segmented) {
    cp_async_wait<0>();
    __syncthreads();
    mark_tiles(flags, heads, seg_q, q0, seg_row, 0, n_kt,
               p.causal ? n_kt - 1 : -1, s_len);
  }
  auto next_kept = [&](int kt) {
    if (segmented)
      while (kt < n_kt && !flags[kt]) ++kt;
    return kt;
  };

  // the ring: every step commits one group (empty past the last kept
  // tile), so tile i's group always has kRing16 - 2 newer ones when
  // step i waits
  int fetch = next_kept(0);
  for (int slot = 0; slot < kRing16 - 1; ++slot) {
    if (fetch < n_kt) {
      stage_key_side(fetch, slot);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
  }

  // the carry of rows r0 + g and r0 + g + 8: m the running max in log2
  // units (the same in the row's 4 lanes), l this lane's partial sum of
  // p over its columns, acc its columns of p . v
  const float scale2 = p.scale * kLog2e;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  Frag16 qf[D / 16];
  const auto q_frag = [&](int kk) { return qf[kk]; };
  int id_r[2] = {0, 0};  // the segment ids of rows r0 + g and r0 + g + 8

  unsigned pairs = 0;
  for (int kt = next_kept(0), i = 0; kt < n_kt;
       kt = next_kept(kt + 1), ++i) {
    const int slot = i % kRing16;
    cp_async_wait<kRing16 - 2>();
    // tile i has landed for every thread, and every thread is done with
    // the slot step i - 1 read, which the next copy refills
    __syncthreads();
    if (fetch < n_kt) {
      stage_key_side(fetch, (i + kRing16 - 1) % kRing16);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        qf[kk] = load_a16<LD>(qs, r0, 16 * kk, lane);
      if (segmented) {
        id_r[0] = seg_q[r0 + g];
        id_r[1] = seg_q[r0 + g + 8];
      }
    }
    const int k0 = kt * kTile;
    float s[KN][4];
    strip_by_rows<T, D, kTile>(s, q_frag, ks + slot * kTile * LD, 0, lane);

    // scores in log2 units, -inf on masked lanes (the mask only where
    // segments, the diagonal or S's edge reach this tile pair), and each
    // row's max over the tile
    const bool edge = tile_masked(q0, k0, s_len, p.causal, false);
    const unsigned kept =
        edge || segmented
            ? keep_bits<kTile>(id_r, segmented ? seg_k + slot * kTile
                                               : nullptr,
                               q0 + r0, k0, 0, edge, true, s_len, p.causal,
                               g, t)
            : ~0u;
    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kept >> (4 * n + e) & 1u ? s[n][e] * scale2
                                                 : -CUDART_INF_F;
        s[n][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    // m_new is -inf only while every lane so far is masked: then the
    // row subtracts 0 instead, so p = exp2(-inf) = 0 on every lane, and
    // alpha = exp2(-inf) = 0 while m is -inf
    float m_use[2], alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], quad_max(tile_max[half]));
      m_use[half] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[half] = exp2_ftz(m[half] - m_use[half]);
      m[half] = m_new;
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2_ftz(s[n][e] - m_use[e >> 1]);
        l[e >> 1] += pv;
        s[n][e] = pv;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += P . V, P as hi + lo in T
    Frag16 pa[kTile / 16], pa_lo[kTile / 16];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      acc_as_a16<T>(pa[j], pa_lo[j], s[2 * j], s[2 * j + 1]);
    strip_times_tile<T, D, kTile>(acc, pa, pa_lo, vs + slot * kTile * LD, 0,
                                  lane);
    ++pairs;
  }
  if (threadIdx.x == 0 && pairs > 0)
    atomicAdd(&g_tile_pairs, static_cast<unsigned long long>(pairs));

  store_forward<T, D>(p, bh, q0 + r0, m, l, acc, g, t);
}

// grid (B * H, query tiles, longest first); one block per 64-row query
// tile.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) blockwise_fwd_kernel(Params p) {
  if constexpr (kHalfWidth<T>) return blockwise_fwd16<T, D>(p);
  constexpr int LD = tile_ld<D>();
  constexpr int DN = D / 8;                 // 8-column tiles of O
  constexpr int KN = kTile / 8;             // 8-key tiles of S
  extern __shared__ __align__(16) float tc_smem[];
  float* qs = tc_smem;                      // [64][LD]
  float* ks = qs + kTile * LD;              // [2][64][LD]
  float* vs = ks + 2 * kTile * LD;          // [2][64][LD]
  int* seg_q = reinterpret_cast<int*>(vs + 2 * kTile * LD);
  int* seg_k = seg_q + kTile;               // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  auto stage_key_side = [&](int kt, int slot) {
    const int k0 = kt * kTile;
    stage_tile<T, D>(ks + slot * kTile * LD, kb, p.sk.s, k0, s_len, p.d,
                     p.vec);
    stage_tile<T, D>(vs + slot * kTile * LD, vb, p.sv.s, k0, s_len, p.d,
                     p.vec);
    if (segmented) stage_rows(seg_k + slot * kTile, seg_row, k0, s_len);
  };

  stage_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                   p.sq.s, q0, s_len, p.d, p.vec);
  if (segmented) stage_rows(seg_q, seg_row, q0, s_len);
  stage_key_side(0, 0);
  cp_async_commit();
  const int n_kt = key_tiles(q0, s_len, p.causal);

  // the carry of rows r0 + g and r0 + g + 8: m the running max in log2
  // units (the same in the row's 4 lanes), l this lane's partial sum of
  // p over its columns, acc its columns of p . v
  const float scale2 = p.scale * kLog2e;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt & 1;
    if (kt + 1 < n_kt) {
      stage_key_side(kt + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kTile;
    const int* seg_t = seg_k + slot * kTile;
    float s[KN][4];
    score_tile<D>(s, q_from_tile<D>(qs, r0, lane), ks + slot * kTile * LD,
                  lane);

    // scores in log2 units (s * scale * log2(e), so p = exp2(x - m)),
    // -inf on masked lanes, and each row's max over this tile
    const bool masked = tile_masked(q0, k0, s_len, p.causal, segmented);
    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float x = s[n][e] * scale2;
        if (masked) {
          const int r = r0 + g + 8 * half;
          const int c = 8 * n + 2 * t + (e & 1);
          if (!keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_t, r, c,
                    segmented))
            x = -CUDART_INF_F;
        }
        s[n][e] = x;
        tile_max[half] = fmaxf(tile_max[half], x);
      }
    // m_new is -inf only while every lane so far is masked: then the
    // row subtracts 0 instead, so p = exp2(-inf) = 0 on every lane, and
    // alpha = exp2(-inf) = 0 while m is -inf
    float m_use[2], alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m_new = fmaxf(m[half], quad_max(tile_max[half]));
      m_use[half] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[half] = exp2f(m[half] - m_use[half]);
      m[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float pv = exp2f(s[n][e] - m_use[half]);
        lsum[half] += pv;
        s[n][e] = pv;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half)
      l[half] = l[half] * alpha[half] + lsum[half];

    // acc = acc * alpha + P . V
    float pv[DN][4];
    pv_tile<D>(pv, s, vs + slot * kTile * LD, g, t);
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * alpha[e >> 1] + pv[n][e];
    __syncthreads();
  }

  store_forward<T, D>(p, bh, q0 + r0, m, l, acc, g, t);
}

template <typename T, int D>
struct BlockwiseForward {
  static cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
    const dim3 grid(batch * p.heads, (p.s_len + kTile - 1) / kTile);
    return launch_with_smem(blockwise_fwd_kernel<T, D>, grid, kMmaThreads,
                            kHalfWidth<T> ? blockwise_fwd16_smem_bytes<D>(
                                                p.s_len)
                                          : fwd_smem_bytes<D>(),
                            stream, p);
  }
};

}  // namespace

// bigdl_blockwise_{fwd,bwd}_{f32,bf16,f16}, bigdl_blockwise_error_string
// and bigdl_blockwise_{tile_pairs,bwd_tile_pairs} (flash_common.cuh has
// the interface): the 16-bit forward's computed (query tile, key tile)
// pairs, and the 16-bit backward's dK/dV [0] and dQ [1] pairs (the
// float32 kernels count none).
BIGDL_FLASH_ENTRY_POINTS(bigdl_blockwise, BlockwiseForward)
