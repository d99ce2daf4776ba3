// Full-row flash attention for Hopper (sm_90a): forward and backward of
// softmax((q * scale) . k^T, causal and/or same-segment mask) . v over
// [B, H, S, D] tensors, with the float32 log-sum-exp saved for the
// backward.
//
// Replaces bigdl_tpu/kernels/flash_attention.py: the forward body
// _fwd_kernel (launched by _fwd_call) and the backward body _bwd_kernel
// (launched by _bwd_call). It computes the same function with the same
// arithmetic: masked scores are -inf with p = 0 on masked lanes, each
// query row is reduced over its FULL key row (row max first, then
// exp-sum-accumulate; no online rescaling, docs/kernels.md "Full-row
// softmax reductions"), a fully masked row gives o = 0 and lse = -inf,
// and the backward recomputes p from lse (p = 0 where lse is not
// finite). The scale multiplies the q . k^T product (the TPU kernel
// scales q before it: the same value to within a rounding). Inputs are
// float32, bfloat16 or float16; every sum is float32. float32 products
// run 3xTF32 (float32 accuracy); bfloat16 and float16 products run one
// 16-bit MMA on the operands as they are (m16n8k16 in the forward,
// wgmma m64nNk16 in the backward), two where p or dS (float32
// accumulators) is the operand, split into hi + lo in the input dtype
// (flash_common.cuh has why). Any head_dim d up to 128 is
// taken: the kernels are built for tile widths D of 16, 32, 64 and 128,
// and d runs in the narrowest that holds it, its columns past d staged
// as zeros (they add nothing to any product) and never stored. Past 128
// the float32 tiles of a backward block would not fit the 227 KB of
// shared memory.
//
// Bound, at the training slice's shape (B 16, H 8, S 512, D 64, causal,
// packed segments): bytes. In float32, q, k, v and o are 67 MB, 20 us at
// 3.35 TB/s; the forward's two passes do 6 * D flops per kept (query,
// key) pair (S twice, P . V once), about 0.005 ms at the 165 TFLOP/s
// of 3xTF32. The backward does about 2.5x the forward's flops: its 134
// MB of bytes bound it, 40 us. In bfloat16 or float16 the bytes halve
// (10 us forward, 20 us backward) and the flops run at 989 TFLOP/s
// (about 0.004 and 0.009 ms over the kept tiles, with P . V's and the
// backward's second products twice for the split), so the bytes still
// bound it. What the 16-bit kernels spend beyond the MMAs is the work
// per element: the keep-mask (keep_bits: the rows' segment ids in
// registers, the bounds and causal compares only on edge tiles), the
// exponentials and, in the forward, pass 1.
//
// Design of the forward:
//  * one block of four warps per (b, h, 64-row query tile), the longest
//    query tiles (the last, under causal) first; the TPU kernel holds a
//    [block_q, S] score strip in VMEM, which 227 KB of shared memory
//    cannot hold past a few thousand keys, so the block walks its key
//    tiles twice: pass 1 takes each row's max, pass 2 recomputes the
//    scores and accumulates p = exp2(s * scale * log2 e - m) and p . v;
//    lse = (m + log2 l) ln 2. In float32 both passes run
//    flash_common.cuh's 3xTF32 tensor-core kit, as K2's forward does
//    (score_tile, pv_tile, store_forward are shared with it); in 16 bits
//    its m16n8k16 kit (flash_fwd16 below): warp w owns query rows 16w ..
//    16w + 15, a row's max and sum reduce over the 4 lanes of an mma
//    quad, and P goes from the S accumulators straight into P . V. At
//    D <= 64 a warp splits its q fragments once and holds them across
//    every key tile of both passes, rather than loading and splitting
//    them again for each key tile (faster on an H100 at the training
//    shape, PERF.md; the 16-bit forward holds them at every D);
//  * the K tiles (pass 1), then the K and V tiles (pass 2), stream
//    through cp.async rings of two, so the next tile's copy overlaps
//    this tile's products;
//  * causal blocks stop at the diagonal tile. With segment ids, pass 1
//    tests every key tile exactly — does any key of it share an id with
//    any query of the block? — and skips the products of the tiles that
//    share none (they add exact zeros to l and nothing to m); pass 2
//    neither loads nor computes them. The test is one comparison pass
//    over the ids (128 threads, a key and half the queries each) and a
//    __syncthreads_or, so the decision is uniform across the block; a
//    min/max range test would keep every tile whose id range the pad's
//    id 0 overlaps. The causal diagonal tile is always kept (query r and
//    key r share an id), so no row loses all its tiles by skipping. On
//    the training rows 315 of 576 causal tile pairs are kept.
//    bigdl_flash_tile_pairs reads the pairs computed so far. The 16-bit
//    forward flags the kept tiles before pass 1 in one pass over the
//    ids (mark_tiles, the same exact test), so neither pass loads the
//    others;
//  * the backward is flash_common.cuh's, on the tensor cores (3xTF32,
//    or wgmma in 16 bits, where it skips the unshared tile pairs too and
//    bigdl_flash_bwd_tile_pairs reads the pairs it computed; wgmma ran
//    K1's 16-bit backward 10% faster than mma.sync m16n8k16 at the
//    training shape on an H100, PERF.md).
//    The TPU grid runs its query tiles in order and carries dK / dV in
//    scratch across them; GPU blocks run in no order, so the backward
//    splits without atomics (the gradient is bitwise the same from run
//    to run): a delta = rowsum(dO * O) pass, a dK/dV kernel with one
//    block per (b, h, key tile) streaming the query tiles that see it
//    through a cp.async ring, and a dQ kernel with one block per (b, h,
//    query tile) streaming the key tiles, longest tiles first. Both
//    recompute p and dS: 7 tile products where a fused kernel with
//    atomics would do 5;
//  * q, k, v, o and dO are read through their strides (the attention
//    layer hands over [B, S, H, D] -> [B, H, S, D] transposed views);
//    only the last dimension must be contiguous.
// Any S is taken: tiles past S stage zeros and are masked. Everything
// but the forward kernel — tile loads, the mask, the tile products, the
// epilogue and the three backward kernels — lives in flash_common.cuh,
// shared with the blockwise kernel K2 (blockwise_flash_attention.cu),
// whose backward is the same function.

#include "flash_common.cuh"

namespace {

// 32-bit words of a forward block's kept-key-tile bitmask.
__host__ __device__ constexpr int keep_words(int s_len) {
  return ((s_len + kTile - 1) / kTile + 31) / 32;
}

// Whether any key of the staged key tile k0 shares a segment id with
// any query of the block's tile q0 (rows and keys past S count for
// nothing). Thread i compares key i % 64 against half the queries; the
// block-wide OR is a barrier, so every thread gets the same answer.
__device__ __forceinline__ bool tile_shares_segment(const int* seg_q,
                                                    const int* seg_k,
                                                    int q0, int k0,
                                                    int s_len) {
  const int c = threadIdx.x % kTile;
  const int r_first = threadIdx.x / kTile * (kTile / 2);
  const int r_end = min(r_first + kTile / 2, s_len - q0);
  bool found = false;
  if (k0 + c < s_len) {
    const int id = seg_k[c];
    for (int r = r_first; r < r_end && !found; ++r) found = seg_q[r] == id;
  }
  return __syncthreads_or(found);
}

// Shared memory of a 16-bit forward block: the query tile and a ring of
// two (k, v) tiles in T, segment ids, and mark_tiles' flags and heads.
template <int D>
constexpr size_t fwd16_smem_bytes(int s_len) {
  return 2 * 5 * kTile * tile_ld16<D>() + sizeof(int) * 3 * kTile +
         tile_marks_bytes(s_len);
}

// flash_fwd_kernel for bfloat16 and float16: the same two passes over
// the key tiles, with 16-bit tiles staged by 16-byte cp.async. S = q .
// k^T is one m16n8k16 MMA a product, from the strip's q fragments
// (loaded once, held across both passes); P . V reads V with
// ldmatrix.trans and takes two, P split into hi + lo in T as it becomes
// the A operand. The row max, l (summed from the unsplit p), lse and
// O's sums stay float32. The key tiles that share no segment id with
// the query tile are flagged before pass 1 (mark_tiles), so neither
// pass loads or computes them.
template <typename T, int D>
__device__ __forceinline__ void flash_fwd16(const Params& p) {
  constexpr int LD = tile_ld16<D>();
  constexpr int DN = D / 8;                 // 8-column tiles of O
  constexpr int KN = kTile / 8;             // 8-key tiles of S
  extern __shared__ __align__(16) float tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);    // [64][LD]
  T* ks = qs + kTile * LD;                  // [2][64][LD]
  T* vs = ks + 2 * kTile * LD;              // [2][64][LD]
  int* seg_q = reinterpret_cast<int*>(vs + 2 * kTile * LD);
  int* seg_k = seg_q + kTile;               // [2][64]
  int* heads = seg_k + 2 * kTile;
  unsigned char* flags = reinterpret_cast<unsigned char*>(heads + kTile + 1);

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

  auto stage_key_side = [&](int kt, int slot, bool values) {
    const int k0 = kt * kTile;
    stage_tile16<T, D>(ks + slot * kTile * LD, kb, p.sk.s, k0, s_len, p.d,
                       p.vec);
    if (values)
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
  const float scale2 = p.scale * kLog2e;
  Frag16 qf[D / 16];
  const auto q_frag = [&](int kk) { return qf[kk]; };
  int id_r[2] = {0, 0};  // the segment ids of rows r0 + g and r0 + g + 8
  // the keep-mask of key tile kt, staged in slot, for this lane's strip
  const auto tile_keep = [&](int kt, int slot) {
    const int k0 = kt * kTile;
    return keep_bits<kTile>(id_r, segmented ? seg_k + slot * kTile : nullptr,
                            q0 + r0, k0, 0,
                            tile_masked(q0, k0, s_len, p.causal, false),
                            true, s_len, p.causal, g, t);
  };

  // pass 1: each row's max over its kept keys, in log2 units (this
  // lane's columns, then over the quad)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int kt = next_kept(0);
  if (kt < n_kt) {
    stage_key_side(kt, 0, false);
    cp_async_commit();
  }
  for (int slot = 0, first = 1; kt < n_kt; slot ^= 1, first = 0) {
    const int next = next_kept(kt + 1);
    if (next < n_kt) {
      stage_key_side(next, slot ^ 1, false);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        qf[kk] = load_a16<LD>(qs, r0, 16 * kk, lane);
      if (segmented) {
        id_r[0] = seg_q[r0 + g];
        id_r[1] = seg_q[r0 + g + 8];
      }
    }
    float s[KN][4];
    strip_by_rows<T, D, kTile>(s, q_frag, ks + slot * kTile * LD, 0, lane);
    const unsigned kept = tile_keep(kt, slot);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kept >> (4 * n + e) & 1u)
          m[e >> 1] = fmaxf(m[e >> 1], s[n][e] * scale2);
    __syncthreads();
    kt = next;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) m[half] = quad_max(m[half]);

  // pass 2, over the same tiles: p = exp2(x - m) on kept lanes (exact 0
  // elsewhere), l = sum p (unsplit), acc = P . V with P as hi + lo in T
  float l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  kt = next_kept(0);
  if (kt < n_kt) {
    stage_key_side(kt, 0, true);
    cp_async_commit();
  }
  unsigned pairs = 0;
  for (int slot = 0; kt < n_kt; slot ^= 1, ++pairs) {
    const int next = next_kept(kt + 1);
    if (next < n_kt) {
      stage_key_side(next, slot ^ 1, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[KN][4];
    strip_by_rows<T, D, kTile>(s, q_frag, ks + slot * kTile * LD, 0, lane);
    const unsigned kept = tile_keep(kt, slot);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = kept >> (4 * n + e) & 1u
                             ? exp2_ftz(s[n][e] * scale2 - m[e >> 1])
                             : 0.f;
        l[e >> 1] += pv;
        s[n][e] = pv;
      }
    Frag16 pa[kTile / 16], pa_lo[kTile / 16];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      acc_as_a16<T>(pa[j], pa_lo[j], s[2 * j], s[2 * j + 1]);
    strip_times_tile<T, D, kTile>(acc, pa, pa_lo, vs + slot * kTile * LD, 0,
                                  lane);
    __syncthreads();
    kt = next;
  }
  if (threadIdx.x == 0 && pairs > 0)
    atomicAdd(&g_tile_pairs, static_cast<unsigned long long>(pairs));

  store_forward<T, D>(p, bh, q0 + r0, m, l, acc, g, t);
}

// grid (B * H, query tiles, longest first); one block per 64-row query
// tile.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_kernel(Params p) {
  if constexpr (kHalfWidth<T>) return flash_fwd16<T, D>(p);
  constexpr int LD = tile_ld<D>();
  constexpr int DN = D / 8;                 // 8-column tiles of O
  constexpr int KN = kTile / 8;             // 8-key tiles of S
  extern __shared__ __align__(16) float tc_smem[];
  float* qs = tc_smem;                      // [64][LD]
  float* ks = qs + kTile * LD;              // [2][64][LD]
  float* vs = ks + 2 * kTile * LD;          // [2][64][LD]
  int* seg_q = reinterpret_cast<int*>(vs + 2 * kTile * LD);
  int* seg_k = seg_q + kTile;               // [2][64]
  unsigned* kept = reinterpret_cast<unsigned*>(seg_k + 2 * kTile);

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

  auto stage_key_side = [&](int kt, int slot, bool values) {
    const int k0 = kt * kTile;
    stage_tile<T, D>(ks + slot * kTile * LD, kb, p.sk.s, k0, s_len, p.d,
                     p.vec);
    if (values)
      stage_tile<T, D>(vs + slot * kTile * LD, vb, p.sv.s, k0, s_len, p.d,
                       p.vec);
    if (segmented) stage_rows(seg_k + slot * kTile, seg_row, k0, s_len);
  };

  stage_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                   p.sq.s, q0, s_len, p.d, p.vec);
  if (segmented) stage_rows(seg_q, seg_row, q0, s_len);
  stage_key_side(0, 0, false);
  cp_async_commit();
  const int n_kt = key_tiles(q0, s_len, p.causal);
  if (segmented)
    for (int w = threadIdx.x; w < keep_words(n_kt * kTile); w += kMmaThreads)
      kept[w] = 0u;
  const float scale2 = p.scale * kLog2e;
  // at D <= 64 the strip's q fragments are split once (at the first key
  // tile, when q has landed) and held across both passes; at D = 128
  // they would not fit the registers, and are loaded per key tile
  constexpr bool kHoldQ = D <= 64;
  FragA qf[kHoldQ ? D / 8 : 1];
  const auto q_frag = [&](int kk) {
    if constexpr (kHoldQ)
      return qf[kk / 8];
    else
      return q_from_tile<D>(qs, r0, lane)(kk);
  };

  // pass 1: each row's max over its kept keys, in log2 units (this
  // lane's columns, then over the quad)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt & 1;
    if (kt + 1 < n_kt) {
      stage_key_side(kt + 1, slot ^ 1, false);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHoldQ)
      if (kt == 0) load_q<D>(qf, qs, r0, lane);
    const int k0 = kt * kTile;
    const int* seg_t = seg_k + slot * kTile;
    bool live = true;
    if (segmented) {
      live = (p.causal && kt == n_kt - 1) ||
             tile_shares_segment(seg_q, seg_t, q0, k0, s_len);
      if (live && threadIdx.x == 0) kept[kt / 32] |= 1u << (kt % 32);
    }
    if (live) {
      float s[KN][4];
      score_tile<D>(s, q_frag, ks + slot * kTile * LD, lane);
      const bool masked = tile_masked(q0, k0, s_len, p.causal, segmented);
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int r = r0 + g + 8 * half;
          const int c = 8 * n + 2 * t + (e & 1);
          if (!masked || keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_t,
                              r, c, segmented))
            m[half] = fmaxf(m[half], s[n][e] * scale2);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) m[half] = quad_max(m[half]);

  // pass 2, over the kept tiles: p = exp2(x - m) on kept lanes (exact 0
  // elsewhere, so a fully masked row, m = -inf, never evaluates
  // exp2(-inf - -inf)), l = sum p, acc = p . v
  auto next_kept = [&](int kt) {
    if (segmented)
      while (kt < n_kt && !(kept[kt / 32] >> (kt % 32) & 1u)) ++kt;
    return kt;
  };
  float l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int kt = next_kept(0);
  if (kt < n_kt) {
    stage_key_side(kt, 0, true);
    cp_async_commit();
  }
  int pairs = 0;
  for (int slot = 0; kt < n_kt; slot ^= 1, ++pairs) {
    const int next = next_kept(kt + 1);
    if (next < n_kt) {
      stage_key_side(next, slot ^ 1, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * kTile;
    const int* seg_t = seg_k + slot * kTile;
    float s[KN][4];
    score_tile<D>(s, q_frag, ks + slot * kTile * LD, lane);
    const bool masked = tile_masked(q0, k0, s_len, p.causal, segmented);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int r = r0 + g + 8 * half;
        const int c = 8 * n + 2 * t + (e & 1);
        const float pv =
            !masked || keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_t, r,
                            c, segmented)
                ? exp2f(s[n][e] * scale2 - m[half])
                : 0.f;
        l[half] += pv;
        s[n][e] = pv;
      }
    float pv[DN][4];
    pv_tile<D>(pv, s, vs + slot * kTile * LD, g, t);
#pragma unroll
    for (int n = 0; n < DN; ++n) promote(acc[n], pv[n]);
    __syncthreads();
    kt = next;
  }
  if (threadIdx.x == 0 && pairs > 0)
    atomicAdd(&g_tile_pairs, static_cast<unsigned long long>(pairs));

  store_forward<T, D>(p, bh, q0 + r0, m, l, acc, g, t);
}

template <typename T, int D>
struct FullRowForward {
  static cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
    const dim3 grid(batch * p.heads, (p.s_len + kTile - 1) / kTile);
    return launch_with_smem(
        flash_fwd_kernel<T, D>, grid, kMmaThreads,
        kHalfWidth<T>
            ? fwd16_smem_bytes<D>(p.s_len)
            : fwd_smem_bytes<D>() + sizeof(unsigned) * keep_words(p.s_len),
        stream, p);
  }
};

}  // namespace

// bigdl_flash_{fwd,bwd}_{f32,bf16,f16}, bigdl_flash_error_string and
// bigdl_flash_{tile_pairs,bwd_tile_pairs} (flash_common.cuh has the
// interface): the forward's computed (query tile, key tile) pairs, and
// the 16-bit backward's dK/dV [0] and dQ [1] pairs (the float32 backward
// counts none). Each read synchronises the device and restarts its
// counts at 0.
BIGDL_FLASH_ENTRY_POINTS(bigdl_flash, FullRowForward)
