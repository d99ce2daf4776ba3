// Blockwise (online-softmax) flash attention for Hopper (sm_90a): the
// long-context training kernel, forward and backward of
// softmax((q * scale) . k^T, causal and/or same-segment mask) . v over
// [B, H, S, D] tensors, with the float32 log-sum-exp saved for the
// backward.
//
// Replaces bigdl_tpu/kernels/flash_attention.py's K2: the forward body
// _bw_fwd_kernel (launched by _bw_fwd_call) and the two backward bodies
// _bw_dq_kernel and _bw_dkv_kernel (launched by _bw_bwd_call). It
// computes the same function with the TPU kernel's arithmetic: q is
// scaled before the product, masked scores are -inf, and each query
// tile carries a running (m, l, acc) over the key tiles, rescaled by
// exp(m_old - m_new) at each one (alpha = 0 while every lane so far was
// masked, p = 0 where m_new is -inf), so a fully masked row gives o = 0
// and lse = -inf and never NaN. The backward recomputes p from the
// saved lse. The TPU kernel's block_q / block_k are VMEM choices; here
// the tiles are 64 x 64, as in K1.
//
// Bound, at the long-context slice's shape (B 1, H 8, S 8192, D 64,
// f32, causal): arithmetic. The forward does 4 * D flops per kept
// (query, key) pair: 6.9e10 here, 1.03 ms at the 67 TFLOP/s float32
// rate the card has outside the tensor cores, against 67 MB of q, k, v
// and O (20 us at 3.35 TB/s). The backward does about 2.5x the forward's
// flops (2.6 ms). At S = 32768 both are 16x that.
//
// Design against that bound (a first, simple kernel — tensor cores,
// wgmma, TMA and pipelining are later work):
//  * forward: one block per (b, h, 64-row query tile) walks the key
//    tiles ONCE, FlashAttention-2's forward: per tile one q . k^T and
//    one p . v product (K1's full-row forward walks the key row twice,
//    three products per tile), the tile's row max taken across the 16
//    threads of a row group, and the per-thread partial l and the
//    accumulator rescaled by alpha;
//  * causal blocks stop at the diagonal tile; segment ids mask per
//    tile (a key tile wholly of another segment keeps the carry as it
//    was);
//  * O is written in q's dtype and the f32 lse in K1's layout, so the
//    backward — delta, dK/dV per key tile and dQ per query tile, no
//    atomics — is flash_common.cuh's, shared with K1;
//  * q, k and v are read in place through their (batch, head, row)
//    strides; head dims 1-128 run in the narrowest 16/32/64/128 tile
//    width that holds them; any S (edge tiles are bounds-checked).

#include "flash_common.cuh"

namespace {

// grid (query tiles, B * H); one block per 64-row query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) blockwise_fwd_kernel(Params p) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [64][D+1], q * scale
  float* ks = qs + kTile * (D + 1);        // [64][D+1]
  float* vs = ks + kTile * (D + 1);        // [64][D+1]
  float* ps = vs + kTile * (D + 1);        // [64][65]
  int* seg_q = reinterpret_cast<int*>(ps + kTile * kLdP);
  int* seg_k = seg_q + kTile;

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;

  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  load_tile<T, D>(qs, qb, p.sq.s, q0, s_len, p.d, p.scale);
  load_seg(seg_q, seg_row, q0, s_len);
  const int n_kt = key_tiles(q0, s_len, p.causal);

  // the carry: m is the row group's running max (the same in its 16
  // threads), l each thread's partial sum of p over its columns, acc
  // its columns of p . v
  float m[kSub], l[kSub];
  float acc[kSub][DC];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  float s[kSub][kSub];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, p.sk.s, k0, s_len, p.d, 1.f);
    load_tile<T, D>(vs, vb, p.sv.s, k0, s_len, p.d, 1.f);
    load_seg(seg_k, seg_row, k0, s_len);
    __syncthreads();
    tile_abt<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + 16 * i;
      bool kept[kSub];
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + 16 * j;
        kept[j] = keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_k, r, c,
                       segmented);
        if (kept[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      // m_new is -inf only while every lane so far is masked (a kept
      // lane's score is finite): then p = 0 on every lane and alpha = 0
      const float m_new = fmaxf(m[i], group_max(tile_max));
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float pv = kept[j] ? expf(s[i][j] - m_new) : 0.f;
        lsum += pv;
        ps[r * kLdP + tx + 16 * j] = pv;
      }
      l[i] = l[i] * alpha + lsum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    tile_pv<D>(acc, ps, vs, ty, tx);
  }

  store_forward<T, D>(p, bh, q0, m, l, acc, ty, tx);
}

template <typename T, int D>
struct BlockwiseForward {
  static cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
    const dim3 grid((p.s_len + kTile - 1) / kTile, batch * p.heads);
    return launch_with_smem(blockwise_fwd_kernel<T, D>, grid,
                            fwd_smem_bytes<D>(), stream, p);
  }
};

}  // namespace

// bigdl_blockwise_{fwd,bwd}_{f32,bf16,f16} and
// bigdl_blockwise_error_string (flash_common.cuh has the interface).
BIGDL_FLASH_ENTRY_POINTS(bigdl_blockwise, BlockwiseForward)
