// Device code shared by the two flash-attention sources for Hopper
// (sm_90a): the full-row kernel K1 (flash_attention.cu) and the
// blockwise long-context kernel K2 (blockwise_flash_attention.cu).
//
// Both compute softmax((q * scale) . k^T, causal and/or same-segment
// mask) . v over [B, H, S, D] tensors with the float32 log-sum-exp saved
// for the backward, and both backwards are the same function of (q, k,
// v, O, dO, lse). So this header holds everything but the two forward
// kernels: the tile loads, the keep-mask, the score recomputation, the
// forward epilogue (O and lse from a row's (m, l, acc)), and the whole
// backward — a delta = rowsum(dO * O) pass, a dK/dV kernel with one
// block per (b, h, key tile) streaming the query tiles from the causal
// diagonal on, and a dQ kernel with one block per (b, h, query tile)
// streaming the key tiles up to the diagonal. The backward uses no
// atomics, so a gradient is the same from run to run; it replaces the
// TPU kernels _bwd_kernel (K1) and _bw_dq_kernel / _bw_dkv_kernel (K2)
// of bigdl_tpu/kernels/flash_attention.py. Each source keeps its own
// extern "C" entry points, built into its own library.
//
// Layout: a block is 256 threads as 16 x 16 and works on 64 x 64 tiles;
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4)
// of a score tile — a 4 x 4 register tile of outer products per step,
// read from shared-memory rows padded by one float so a warp's 16
// distinct rows fall in 16 banks. Inputs are float32, bfloat16 or
// float16; every product and sum is float32. A head_dim d up to 128
// runs in the narrowest tile width D of 16, 32, 64 and 128 that holds
// it, its columns past d loaded as zeros (they add nothing to any
// product) and never stored. q, k, v, O and dO are read through their
// (batch, head, row) strides; only the last dimension must be
// contiguous. Any S is taken: tiles past S load zeros and are masked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kSub = kTile / 16;     // rows (cols) of a thread's sub-tile
constexpr int kLdP = kTile + 1;      // padded row of a 64 x 64 score tile
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

// Element strides (batch, head, row) of a [B, H, S, D] operand whose
// last dimension is contiguous.
struct Strides {
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // forward output (backward input)
  const void* dout;    // dO (backward)
  const int* seg;      // [B, S] int32 segment ids, or null
  void* out;           // O, contiguous [B, H, S, d] (forward)
  float* lse;          // [B, H, S] f32
  float* delta;        // [B, H, S] f32 scratch (backward)
  void* dq;            // contiguous [B, H, S, d] (backward)
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo;
  int heads, s_len, d, causal;  // d: the head_dim, at most the tile's D
  float scale;
};

// Copy rows [row0, row0 + 64) of one (b, h) slice into a [64][D + 1]
// float tile, times mul; rows past S and columns past d are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int s_len, int d, float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] =
        gr < s_len && c < d ? to_f32(src[gr * row_stride + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* seg_row,
                                         int row0, int s_len) {
  if (seg_row == nullptr) return;
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < s_len ? seg_row[row0 + r] : 0;
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two
// [64][D + 1] tiles (a 64 x 64 tile of A . B^T).
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[kSub][kSub],
                                         const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][c] += sum_jj P[ty + 16 i][jj] * V[jj][tx + 16 c]: a [64][65]
// probability tile times a [64][D + 1] value tile (the P . V step of a
// forward).
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[kSub][D / 16],
                                        const float* ps, const float* vs,
                                        int ty, int tx) {
#pragma unroll 4
  for (int jj = 0; jj < kTile; ++jj) {
    float pr[kSub], vr[D / 16];
#pragma unroll
    for (int i = 0; i < kSub; ++i) pr[i] = ps[(ty + 16 * i) * kLdP + jj];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) vr[c] = vs[jj * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] += pr[i] * vr[c];
  }
}

// The TPU kernels' keep-mask (_mask_for / _tile_mask): causal compares
// absolute positions, segments compare query against key; keys past S
// never count.
__device__ __forceinline__ bool keep(int row, int col, int s_len, int causal,
                                     const int* seg_q, const int* seg_k,
                                     int r, int c, bool segmented) {
  if (col >= s_len) return false;
  if (causal && col > row) return false;
  if (segmented && seg_q[r] != seg_k[c]) return false;
  return true;
}

// Number of key tiles a query tile starting at q0 reads: under causal,
// the tiles up to the one holding its last row (the rest are masked
// whole).
__device__ __forceinline__ int key_tiles(int q0, int s_len, int causal) {
  const int all = (s_len + kTile - 1) / kTile;
  if (!causal) return all;
  const int last_row = min(q0 + kTile, s_len) - 1;
  return min(all, last_row / kTile + 1);
}

// Reduce over the 16 threads of a row group (tx = lane % 16).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Shared memory of either forward block: q, k and v tiles, one score
// tile and the two tiles' segment ids.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdP) +
         sizeof(int) * 2 * kTile;
}

// The forward epilogue of query tile q0: each row's O = acc / l and
// lse = m + log(l) from the row group's partial sums l (a fully masked
// row, l = 0, gives O = 0 and lse = -inf).
template <typename T, int D>
__device__ __forceinline__ void store_forward(const Params& p, int bh, int q0,
                                              const float (&m)[kSub],
                                              const float (&l)[kSub],
                                              const float (&acc)[kSub][D / 16],
                                              int ty, int tx) {
  T* ob = static_cast<T*>(p.out) + static_cast<int64_t>(bh) * p.s_len * p.d;
  float* lb = p.lse + static_cast<int64_t>(bh) * p.s_len;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float li = group_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= p.s_len) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d)
        ob[static_cast<int64_t>(row) * p.d + col] =
            from_f32<T>(li > 0.f ? acc[i][c] / li : 0.f);
    }
    if (tx == 0) lb[row] = li > 0.f ? m[i] + logf(li) : -CUDART_INF_F;
  }
}

// delta[b, h, row] = sum_d dO * O, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(Params p,
                                                               int d,
                                                               int64_t rows) {
  const int64_t row_id =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row_id >= rows) return;
  const int64_t bh = row_id / p.s_len;
  const int row = static_cast<int>(row_id % p.s_len);
  const int b = static_cast<int>(bh / p.heads);
  const int h = static_cast<int>(bh % p.heads);
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h +
               row * p.so.s;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h +
               row * p.sdo.s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f32(g[c]) * to_f32(o[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane == 0) p.delta[row_id] = acc;
}

// p and dp for one (query tile, key tile) pair: P[r][c] and, in ds,
// p * (dp - delta) * ds_scale on the score tiles' [64][65] layout. p is
// recomputed from lse (p = 0 on masked lanes and where lse is not
// finite).
template <int D>
__device__ __forceinline__ void grad_tiles(const Params& p, const float* qs,
                                           const float* dos, const float* ks,
                                           const float* vs, const float* lse_s,
                                           const float* delta_s,
                                           const int* seg_q, const int* seg_k,
                                           bool segmented, int q0, int k0,
                                           float ds_scale, float* ps,
                                           float* dss, int ty, int tx) {
  float s[kSub][kSub], dp[kSub][kSub];
  tile_abt<D>(s, qs, ks, ty, tx);
  tile_abt<D>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    const float lse = lse_s[r];
    const bool live = isfinite(lse);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = tx + 16 * j;
      const float pv = live && keep(q0 + r, k0 + c, p.s_len, p.causal,
                                    seg_q, seg_k, r, c, segmented)
                           ? expf(s[i][j] - lse)
                           : 0.f;
      if (ps != nullptr) ps[r * kLdP + c] = pv;
      dss[r * kLdP + c] = pv * (dp[i][j] - delta_s[r]) * ds_scale;
    }
  }
}

// Load the query-side operands of tile q0: q * scale, dO, lse (-inf
// past S) and delta.
template <typename T, int D>
__device__ __forceinline__ void load_query_side(const Params& p, int b, int h,
                                                int q0, float* qs, float* dos,
                                                float* lse_s, float* delta_s,
                                                int* seg_q,
                                                const int* seg_row) {
  const int64_t bh = static_cast<int64_t>(b) * p.heads + h;
  load_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                  p.sq.s, q0, p.s_len, p.d, p.scale);
  load_tile<T, D>(dos,
                  static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
                  p.sdo.s, q0, p.s_len, p.d, 1.f);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < p.s_len;
    lse_s[r] = in ? p.lse[bh * p.s_len + q0 + r] : -CUDART_INF_F;
    delta_s[r] = in ? p.delta[bh * p.s_len + q0 + r] : 0.f;
  }
  load_seg(seg_q, seg_row, q0, p.s_len);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}

// grid (key tiles, B * H): dV = P^T . dO and dK = dS^T . q over every
// query tile that sees this key tile. The TPU kernels' dS carries the
// scale and multiplies the unscaled q; here dS is unscaled and the
// tile holds q * scale — the same product.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* ps = dos + kTile * (D + 1);
  float* dss = ps + kTile * kLdP;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kTile);
  int* seg_k = seg_q + kTile;

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;

  load_tile<T, D>(ks, static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h,
                  p.sk.s, k0, s_len, p.d, 1.f);
  load_tile<T, D>(vs, static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h,
                  p.sv.s, k0, s_len, p.d, 1.f);
  load_seg(seg_k, seg_row, k0, s_len);

  float dk[kSub][DC], dv[kSub][DC];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (s_len + kTile - 1) / kTile;
  // causal: query rows below k0 see none of these keys
  const int qt0 = p.causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_query_side<T, D>(p, b, h, q0, qs, dos, lse_s, delta_s, seg_q,
                          seg_row);
    __syncthreads();
    grad_tiles<D>(p, qs, dos, ks, vs, lse_s, delta_s, seg_q, seg_k, segmented,
                  q0, k0, 1.f, ps, dss, ty, tx);
    __syncthreads();
    // rows of dK / dV are keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pk[kSub], dsk[kSub], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        pk[i] = ps[r * kLdP + ty + 16 * i];
        dsk[i] = dss[r * kLdP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gv[c] = dos[r * (D + 1) + tx + 16 * c];
        qv[c] = qs[r * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] += pk[i] * gv[c];
          dk[i][c] += dsk[i] * qv[c];
        }
    }
  }

  const int64_t base = static_cast<int64_t>(bh) * s_len * p.d;
  T* dkb = static_cast<T*>(p.dk) + base;
  T* dvb = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col >= p.d) continue;
      dkb[static_cast<int64_t>(row) * p.d + col] = from_f32<T>(dk[i][c]);
      dvb[static_cast<int64_t>(row) * p.d + col] = from_f32<T>(dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}

// grid (query tiles, B * H): dQ = dS . K with dS = p * (dp - delta) *
// scale, as the TPU kernels form it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 1);
  float* ks = dos + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* dss = vs + kTile * (D + 1);
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kTile);
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
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  load_query_side<T, D>(p, b, h, q0, qs, dos, lse_s, delta_s, seg_q, seg_row);

  float dq[kSub][DC];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  const int n_kt = key_tiles(q0, s_len, p.causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, p.sk.s, k0, s_len, p.d, 1.f);
    load_tile<T, D>(vs, vb, p.sv.s, k0, s_len, p.d, 1.f);
    load_seg(seg_k, seg_row, k0, s_len);
    __syncthreads();
    grad_tiles<D>(p, qs, dos, ks, vs, lse_s, delta_s, seg_q, seg_k, segmented,
                  q0, k0, p.scale, nullptr, dss, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsr[kSub], kv[DC];
#pragma unroll
      for (int i = 0; i < kSub; ++i) dsr[i] = dss[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kv[cc] = ks[c * (D + 1) + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) dq[i][cc] += dsr[i] * kv[cc];
    }
  }

  T* dqb = static_cast<T*>(p.dq) + static_cast<int64_t>(bh) * s_len * p.d;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d)
        dqb[static_cast<int64_t>(row) * p.d + col] = from_f32<T>(dq[i][c]);
    }
  }
}

// Launch kernel<<<grid, 256, smem>>> after raising its dynamic shared
// memory cap (needed past 48 KB; idempotent, so a race between threads
// setting it is harmless).
template <typename Kernel>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

void fill_params(Params& p, const int64_t* strides, int heads, int s_len,
                 int d, int causal, float scale) {
  Strides* views[5] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo};
  for (int t = 0; t < 5; ++t) {
    views[t]->b = strides[3 * t];
    views[t]->h = strides[3 * t + 1];
    views[t]->s = strides[3 * t + 2];
  }
  p.heads = heads;
  p.s_len = s_len;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
}

bool bad_shape(int batch, int heads, int s_len, int d) {
  return batch < 1 || heads < 1 || s_len < 1 ||
         d < 1 || d > 128 ||
         static_cast<int64_t>(batch) * heads > 65535;
}

// The backward's kernels at tile width D: delta, dK/dV and dQ on one
// stream.
template <typename T, int D>
struct BwdLaunch {
  static cudaError_t run(const Params& p, int batch, cudaStream_t stream) {
    const int64_t rows = static_cast<int64_t>(batch) * p.heads * p.s_len;
    const int rows_per_block = kThreads / 32;
    flash_delta_kernel<T><<<static_cast<unsigned>(
                                (rows + rows_per_block - 1) / rows_per_block),
                            kThreads, 0, stream>>>(p, p.d, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((p.s_len + kTile - 1) / kTile, batch * p.heads);
    err = launch_with_smem(flash_dkv_kernel<T, D>, grid, dkv_smem_bytes<D>(),
                           stream, p);
    if (err != cudaSuccess) return err;
    return launch_with_smem(flash_dq_kernel<T, D>, grid, dq_smem_bytes<D>(),
                            stream, p);
  }
};

// Launch Launch<T, D>::run at the narrowest tile width D of 16, 32, 64
// and 128 that holds p.d (one instance each keeps the build short),
// after checking the shape and selecting the device. Returns the
// cudaError_t as an int.
template <typename T, template <typename, int> class Launch>
int launch_at_width(const Params& p, int batch, int device, void* stream) {
  if (bad_shape(batch, p.heads, p.s_len, p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.d <= 16)
    err = Launch<T, 16>::run(p, batch, st);
  else if (p.d <= 32)
    err = Launch<T, 32>::run(p, batch, st);
  else if (p.d <= 64)
    err = Launch<T, 64>::run(p, batch, st);
  else
    err = Launch<T, 128>::run(p, batch, st);
  return static_cast<int>(err);
}

// A forward's host side: FwdLaunch<T, D> is the source's own forward.
template <typename T, template <typename, int> class FwdLaunch>
int forward(const void* q, const void* k, const void* v, const int* seg,
            void* out, float* lse, int batch, int heads, int s_len, int d,
            const int64_t* strides, int causal, float scale, int device,
            void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.out = out;
  p.lse = lse;
  fill_params(p, strides, heads, s_len, d, causal, scale);
  return launch_at_width<T, FwdLaunch>(p, batch, device, stream);
}

// The backward's host side, shared by both sources.
template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, const int* seg, void* dq,
             void* dk, void* dv, float* delta, int batch, int heads,
             int s_len, int d, const int64_t* strides, int causal,
             float scale, int device, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.seg = seg;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = delta;
  fill_params(p, strides, heads, s_len, d, causal, scale);
  return launch_at_width<T, BwdLaunch>(p, batch, device, stream);
}

}  // namespace

// Plain C interface of each source, bound with ctypes. Every tensor
// pointer is a device pointer. strides is a host array of 15 element
// strides, (batch, head, row) for q, k, v, o and dO in that order (a
// forward reads the first three); the last dimension of each is
// contiguous. out, lse, dq, dk, dv and delta are contiguous; seg is a
// contiguous [B, S] int32 array or null. Each entry returns the first
// launch's cudaError_t that is not cudaSuccess (0 = every kernel
// launched). PREFIX names a source's entry points
// (PREFIX_fwd_{f32,bf16,f16}, PREFIX_bwd_{f32,bf16,f16},
// PREFIX_error_string); FWD_LAUNCH is its forward launcher, a template
// FWD_LAUNCH<T, D> with a static run(params, batch, stream).
#define BIGDL_FLASH_FWD_ENTRY(PREFIX, SUFFIX, T, FWD_LAUNCH)              \
  extern "C" int PREFIX##_fwd_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, const int* seg,        \
      void* out, float* lse, int batch, int heads, int s_len, int d,      \
      const int64_t* strides, int causal, float scale, int device,        \
      void* stream) {                                                     \
    return forward<T, FWD_LAUNCH>(q, k, v, seg, out, lse, batch, heads,   \
                                  s_len, d, strides, causal, scale,       \
                                  device, stream);                        \
  }

#define BIGDL_FLASH_BWD_ENTRY(PREFIX, SUFFIX, T)                           \
  extern "C" int PREFIX##_bwd_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, const void* o,         \
      const void* dout, const float* lse, const int* seg, void* dq,       \
      void* dk, void* dv, float* delta, int batch, int heads, int s_len,  \
      int d, const int64_t* strides, int causal, float scale, int device, \
      void* stream) {                                                     \
    return backward<T>(q, k, v, o, dout, lse, seg, dq, dk, dv, delta,     \
                       batch, heads, s_len, d, strides, causal, scale,    \
                       device, stream);                                   \
  }

#define BIGDL_FLASH_ENTRY_POINTS(PREFIX, FWD_LAUNCH)                      \
  BIGDL_FLASH_FWD_ENTRY(PREFIX, f32, float, FWD_LAUNCH)                   \
  BIGDL_FLASH_FWD_ENTRY(PREFIX, bf16, __nv_bfloat16, FWD_LAUNCH)          \
  BIGDL_FLASH_FWD_ENTRY(PREFIX, f16, __half, FWD_LAUNCH)                  \
  BIGDL_FLASH_BWD_ENTRY(PREFIX, f32, float)                               \
  BIGDL_FLASH_BWD_ENTRY(PREFIX, bf16, __nv_bfloat16)                      \
  BIGDL_FLASH_BWD_ENTRY(PREFIX, f16, __half)                              \
  extern "C" const char* PREFIX##_error_string(int code) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));            \
  }
