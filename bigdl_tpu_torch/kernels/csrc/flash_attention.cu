// Full-row flash attention for Hopper (sm_90a): forward and backward of
// softmax((q * scale) . k^T, causal and/or same-segment mask) . v over
// [B, H, S, D] tensors, with the float32 log-sum-exp saved for the
// backward.
//
// Replaces bigdl_tpu/kernels/flash_attention.py: the forward body
// _fwd_kernel (launched by _fwd_call) and the backward body _bwd_kernel
// (launched by _bwd_call). It computes the same function with the same
// arithmetic: q is scaled before the product, masked scores are -inf
// with p = 0 on masked lanes, each query row is reduced over its FULL
// key row (row max first, then exp-sum-accumulate; no online
// rescaling), a fully masked row gives o = 0 and lse = -inf, and the
// backward recomputes p from lse (p = 0 where lse is not finite).
// Inputs are float32, bfloat16 or float16; every product and sum is
// float32. Any head_dim d up to 128 is taken: the kernels are built for
// tile widths D of 16, 32, 64 and 128, and d runs in the narrowest that
// holds it, its columns past d loaded as zeros (they add nothing to any
// product) and never stored. Past 128 the float32 tiles of a backward
// block would not fit the 227 KB of shared memory.
//
// Bound, at the training slice's shape (B 16, H 8, S 512, D 64, f32,
// causal, packed segments): the forward does 4 * D flops per kept
// (query, key) pair, 1.3 GFLOP here, 20 us at the 67 TFLOP/s float32
// rate the card has outside the tensor cores, which is where this
// forward runs; q, k, v and o are 67 MB, 20 us at 3.35 TB/s. The
// backward does about 2.5x the forward's flops on the tensor cores in
// 3xTF32 (165 TFLOP/s): its 134 MB of bytes bound it, 40 us.
//
// Design:
//  * the forward stays on flash_common.cuh's SIMT kit (a first, simple
//    kernel: tensor cores, TMA and pipelining are its next step). The
//    TPU kernel holds one [block_q, S] score strip in VMEM; a block here
//    holds a 64 x 64 tile of scores, so the forward walks the key tiles
//    twice through shared memory: pass 1 takes each row's max, pass 2
//    recomputes the scores and accumulates exp and p . v. That keeps
//    the full-row semantics at any S (a [64, S] f32 strip would not fit
//    227 KB past a few thousand keys) at the price of one extra q . k^T
//    product; 256 threads as 16 x 16 over 64 x 64 tiles;
//  * causal blocks skip the key tiles wholly above the diagonal (they
//    add exact zeros to the row sums and nothing to the max);
//  * the backward is flash_common.cuh's, on the tensor cores in 3xTF32
//    (float32 accuracy from tf32 mma.sync, the operands split into hi
//    and lo halves in registers). The TPU grid runs its query tiles in
//    order and carries dK / dV in scratch across them; GPU blocks run in
//    no order, so the backward splits without atomics (the gradient is
//    bitwise the same from run to run): a delta = rowsum(dO * O) pass, a
//    dK/dV kernel with one block per (b, h, key tile) streaming the
//    query tiles that see it through a cp.async ring, and a dQ kernel
//    with one block per (b, h, query tile) streaming the key tiles,
//    longest tiles first. Both recompute p and dS: 7 tile products where
//    a fused kernel with atomics would do 5;
//  * q, k, v, o and dO are read through their strides (the attention
//    layer hands over [B, S, H, D] -> [B, H, S, D] transposed views);
//    only the last dimension must be contiguous.
// Any S is taken: tiles past S load zeros and are masked. Everything
// but the forward kernel — tile loads, the mask, the epilogue and the
// three backward kernels — lives in flash_common.cuh, shared with the
// blockwise kernel K2 (blockwise_flash_attention.cu), whose backward is
// the same function.

#include "flash_common.cuh"

namespace {

// grid (query tiles, B * H); one block per 64-row query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
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

  // pass 1: each row's max over its kept keys
  float m[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) m[i] = -CUDART_INF_F;
  float s[kSub][kSub];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, p.sk.s, k0, s_len, p.d, 1.f);
    load_seg(seg_k, seg_row, k0, s_len);
    __syncthreads();
    tile_abt<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_k, r, c,
                 segmented))
          m[i] = fmaxf(m[i], s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) m[i] = group_max(m[i]);

  // pass 2: p = exp(s - m) on kept lanes (exact 0 elsewhere, so a
  // fully masked row never evaluates exp(-inf - -inf)), l = sum p,
  // acc = p . v
  float l[kSub];
  float acc[kSub][DC];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, p.sk.s, k0, s_len, p.d, 1.f);
    load_tile<T, D>(vs, vb, p.sv.s, k0, s_len, p.d, 1.f);
    load_seg(seg_k, seg_row, k0, s_len);
    __syncthreads();
    tile_abt<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float pv = keep(q0 + r, k0 + c, s_len, p.causal, seg_q, seg_k,
                              r, c, segmented)
                             ? expf(s[i][j] - m[i])
                             : 0.f;
        l[i] += pv;
        ps[r * kLdP + c] = pv;
      }
    __syncthreads();
    tile_pv<D>(acc, ps, vs, ty, tx);
  }

  store_forward<T, D>(p, bh, q0, m, l, acc, ty, tx);
}

template <typename T, int D>
struct FullRowForward {
  static cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
    const dim3 grid((p.s_len + kTile - 1) / kTile, batch * p.heads);
    return launch_with_smem(flash_fwd_kernel<T, D>, grid, kThreads,
                            fwd_smem_bytes<D>(), stream, p);
  }
};

}  // namespace

// bigdl_flash_{fwd,bwd}_{f32,bf16,f16} and bigdl_flash_error_string
// (flash_common.cuh has the interface).
BIGDL_FLASH_ENTRY_POINTS(bigdl_flash, FullRowForward)
