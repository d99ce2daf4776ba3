// Device code shared by the two flash-attention sources for Hopper
// (sm_90a): the full-row kernel K1 (flash_attention.cu) and the
// blockwise long-context kernel K2 (blockwise_flash_attention.cu).
//
// Both compute softmax((q * scale) . k^T, causal and/or same-segment
// mask) . v over [B, H, S, D] tensors with the float32 log-sum-exp saved
// for the backward, and both backwards are the same function of (q, k,
// v, O, dO, lse). So this header holds everything but the two forward
// kernels: the tile loads, the keep-mask, the tensor-core tile products,
// the pieces both forwards are made of (the score tile, the P . V tile,
// the epilogue), and the whole backward — a delta = rowsum(dO * O)
// pass, a dK/dV kernel with one block per (b, h, key tile) streaming
// the query tiles from the causal diagonal on, and a dQ kernel with one
// block per (b, h, query tile) streaming the key tiles up to the
// diagonal. It replaces the TPU kernels _bwd_kernel (K1) and
// _bw_dq_kernel / _bw_dkv_kernel (K2) of
// bigdl_tpu/kernels/flash_attention.py. Each source keeps its own
// extern "C" entry points, built into its own library.
//
// Every tile product runs on the tensor cores, 128 threads a block, four
// warps each owning a 16-row strip of a 64 x 64 tile, with float32
// accumulators; how depends on the dtype.
//
// float32 operands run 3xTF32 (stage_tile, load_a, load_bt2,
// load_b_perm, acc_as_a, mma3): mma.sync m16n8k8 with tf32 operands.
// TF32 keeps 10 mantissa bits, about 1e-3 relative: too coarse for the
// float32 contract (lse within 1e-5 at S = 8192, where lse is ~10). So
// each float operand is split in registers, as its fragment is loaded,
// into hi (x rounded to tf32, to nearest with ties away from zero, as
// cvt.rna rounds) and lo = x - hi, and a product takes a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi: float32 accuracy (what is left out is ~2^-22
// relative) at a third of the 495 TFLOP/s TF32 rate, 165 TFLOP/s.
// Shared memory holds the floats once (splitting into stored hi / lo
// tiles would double it). Rows are padded to D + 4 floats, so a
// fragment read — lane (g, t) at row g, column t by ldmatrix (four
// 8 x 4 float blocks an instruction), or row 2t, column g by plain
// loads — hits 32 distinct banks. An accumulator tile feeds the next
// product as its A operand with no trip through shared memory: its
// columns 2t and 2t + 1 become the product's k = t and t + 4, and
// load_b_perm reads the other operand's rows in that order. A sum over
// many tiles (O, dK, dV, dQ) is carried in float32 registers, one
// tile's MMAs at a time (promote). What bounds these kernels on this
// card is the rate of instructions per SM: the splits, address
// arithmetic and softmax share each SM's instruction slots with the
// MMAs, which is why the split is two integer instructions, the
// exponentials exp2 and the fragment loads ldmatrix.
//
// bfloat16 and float16 operands are exact on the tensor cores, so they
// go unsplit into 16-bit MMAs: twice an m16n8k8's k at the 989 TFLOP/s
// 16-bit rate, six times fewer MMA instructions than 3xTF32 and no
// splits of the inputs. The two forwards run mma.sync m16n8k16
// (stage_tile16, load_a16, load_bt16, load_b16, acc_as_a16, mma16):
// their tiles stay 16-bit in shared memory, rows padded to D + 8
// elements (conflict-free ldmatrix, 16-byte aligned rows), filled by
// 16-byte cp.async where d is a multiple of 8 and the rows are 16-byte
// aligned, by plain loads elsewhere; operands whose rows are the
// product's k (V) are read with ldmatrix.trans. The 16-bit backward runs
// wgmma.mma_async m64nNk16, the block's four warps one warpgroup (the
// wgmma kit below: swizzled tiles read through matrix descriptors, p^T
// and dS^T the register A operand). p and dS leave the float32
// accumulators as the A operand of the next product, split into hi + lo
// in the input dtype (two MMAs): rounded once, they put the bfloat16
// gradients past their 1e-2 contract at the training shape. The row
// max, l, lse, delta and every accumulator stay float32. These kernels
// also skip the tile pairs whose queries and keys share no segment id
// (mark_tiles), in both forwards and in the backward.
//
// The forwards (K1's full-row two-pass walk, K2's online softmax) share
// score_tile (S = q . k^T for a warp's strip; K1 at D <= 64 holds the
// strip's split q fragments across its key tiles), pv_tile (P . V with P
// straight from the S accumulators), fwd_smem_bytes (q, a cp.async ring
// of two (k, v) tiles, segment ids) and store_forward (O = acc / l and
// lse = (m + log2 l) ln 2 from a row max kept in log2 units). The 16-bit
// forwards share store_forward and the 16-bit kit (strip_by_rows,
// strip_times_tile).
//
// The backward (both kernels K1 and K2 launch it) splits into a pass
// per key tile (dV = P^T . dO and dK = dS^T . q) and a pass per query
// tile (dQ = dS . K), each recomputing S = q . k^T and dP = dO . v^T: 7
// tile products where a fused kernel would do 5, but no block ever adds
// into another's output, so there are no atomics on the gradients and
// a gradient is bitwise the same from run to run. The dK/dV block keeps
// its keys and values and the dQ block its queries and dO; the streamed
// tiles go through a cp.async ring (two deep in float32, three in 16
// bits) so the next tiles' copies overlap this tile's products. Bound at
// the long-context shape ([1, 8, 8192, 64] causal): operations, 1.04 ms
// at the 3xTF32 rate in float32, 0.174 ms at the 16-bit rate (its bytes
// take 40 and 20 us); with p and dS split, the 16-bit kernels issue 10
// products of 64^3 per tile pair to the bound's 5. On an H100 the 16-bit
// backward takes about 1.10 ms there (2.2x SDPA; 1.54 on mma.sync) and
// 0.14 ms at K1's [16, 8, 512, 64] (0.153 on mma.sync; PERF.md). The dQ
// kernel starts its longest query tiles (the last, under causal) first;
// the dK/dV kernel's longest key tiles are its first.
//
// Inputs are float32, bfloat16 or float16, and every sum is float32.
// A head_dim d up to 128 runs in the narrowest tile width D of 16, 32,
// 64 and 128 that holds it, its columns past d staged as zeros (they
// add nothing to any product) and never stored. q, k, v, O and dO are
// read through their (batch, head, row) strides; only the last
// dimension must be contiguous. Any S is taken: tiles past S stage
// zeros and are masked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kThreads = 256;        // the delta kernel: a warp a row
constexpr int kWarps = kTile / 16;   // tensor-core blocks: a warp a strip
constexpr int kMmaThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
  int vec;  // operands staged in 16-byte copies (aligned rows)
  float scale;
};

// ------------------------------------------------- tensor cores, 3xTF32

// Row stride (floats) of a staged [64][D] tile: D + 4 is 4 mod 32 for
// D = 32, 64, 128 (20 for D = 16), so a warp's fragment reads — lane
// (g = lane / 4, t = lane % 4) at (row g, column t) or at (row 2t,
// column g) — fall in 32 distinct banks; rows stay 16-byte aligned for
// cp.async and ldmatrix.
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 4;
}

// x = hi + lo for the tensor cores, which read only the top 19 bits
// (sign, exponent, 10 mantissa bits) of a tf32 operand. hi is x rounded
// to the nearest tf32 value, ties away from zero — cvt.rna.tf32.f32's
// rounding, done as an add and a mask on the bits (two instructions;
// the cvt compiles to about six, and the splits are most of the
// kernels' non-MMA work). lo = x - hi is exact in float32, |lo| <=
// 2^-11 |x|; the MMA drops its low 13 bits, which costs under 2^-22 |x|,
// the size of the lo . lo term 3xTF32 leaves out. (x is finite here.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An m16n8k8 operand split into tf32 halves: A holds rows g and g + 8,
// k = t and t + 4 (a0..a3 in the PTX order); B holds k = t and t + 4 of
// column g.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// c += a . b in 3xTF32: the two small cross terms first, then hi . hi.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// sum += part, in IEEE float32. A sum carried in one MMA accumulator
// through thousands of MMAs drifts: with dK and dV summed over all 128
// query tiles at S = 8192 (3,072 MMAs deep), they missed the plain
// version by 2.5e-4 and 4.1e-4 on an H100, against 7.9e-6 and 9.1e-6
// with each tile's products in a fresh accumulator (at most 24 MMAs
// deep) added here — the MMA's float32 adds do not round to nearest.
__device__ __forceinline__ void promote(float (&sum)[4],
                                        const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) sum[e] += part[e];
}

// Four 8 x 4 float blocks of shared memory in one instruction: lane
// 8j + r gives the address of row r of block j, and lane 4g + t gets
// x[j] = row g, column t of block j — the tf32 fragment layout (an 8 x 8
// b16 matrix is an 8 x 4 float block).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&x)[4],
                                            const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
}

// A = rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int r0,
                                       int k0, int lane) {
  const int j = lane / 8;
  uint32_t x[4];
  ldmatrix_x4(x, tile + (r0 + lane % 8 + 8 * (j & 1)) * LD + k0 +
                     4 * (j >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(__uint_as_float(x[i]), f.hi[i], f.lo[i]);
}

// B[k][n] = tile[n0 + n][k0 + k] and tile[n0 + 8 + n][k0 + k]: the
// transposes of two 8-row slices of a row-major tile whose rows are the
// product's columns (k^T in q . k^T).
template <int LD>
__device__ __forceinline__ void load_bt2(FragB& f0, FragB& f1,
                                         const float* tile, int n0, int k0,
                                         int lane) {
  const int j = lane / 8;
  uint32_t x[4];
  ldmatrix_x4(x, tile + (n0 + lane % 8 + 8 * (j >> 1)) * LD + k0 +
                     4 * (j & 1));
  split_tf32(__uint_as_float(x[0]), f0.hi[0], f0.lo[0]);
  split_tf32(__uint_as_float(x[1]), f0.hi[1], f0.lo[1]);
  split_tf32(__uint_as_float(x[2]), f1.hi[0], f1.lo[0]);
  split_tf32(__uint_as_float(x[3]), f1.hi[1], f1.lo[1]);
}

// B[k][n] = tile[k0 + 2k or 2(k - 4) + 1][n0 + n]: a row-major tile
// whose rows are the product's k, in the order acc_as_a gives A's k.
template <int LD>
__device__ __forceinline__ void load_b_perm(FragB& f, const float* tile,
                                            int k0, int n0, int g, int t) {
  const float* x = tile + (k0 + 2 * t) * LD + n0 + g;
  split_tf32(x[0], f.hi[0], f.lo[0]);
  split_tf32(x[LD], f.hi[1], f.lo[1]);
}

// An accumulator tile (rows g and g + 8, columns 2t and 2t + 1 of its 8)
// as the A operand of a product over its 8 columns: column 2t is k = t,
// column 2t + 1 is k = t + 4 (load_b_perm reads B in the same order).
__device__ __forceinline__ void acc_as_a(FragA& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
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

// Stage rows [row0, row0 + 64) of one (b, h) slice into a [64][D + 4]
// float tile; rows past S and columns past d are zeros. float32 goes by
// cp.async (16-byte copies when vec, else 4-byte), to be waited for
// with cp_async_wait; bfloat16 and float16 are converted on the way,
// synchronously.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int64_t row_stride, int row0,
                                           int s_len, int d, bool vec) {
  constexpr int LD = tile_ld<D>();
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = threadIdx.x; e < kTile * D / 4; e += kMmaThreads) {
        const int r = e / (D / 4);
        const int c = e % (D / 4) * 4;
        const bool in = row0 + r < s_len && c < d;
        cp_async16(dst + r * LD + c,
                   in ? src + (row0 + r) * row_stride + c : src, in);
      }
      return;
    }
    for (int e = threadIdx.x; e < kTile * D; e += kMmaThreads) {
      const int r = e / D;
      const int c = e % D;
      const bool in = row0 + r < s_len && c < d;
      cp_async4(dst + r * LD + c,
                in ? src + (row0 + r) * row_stride + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * D; e += kMmaThreads) {
      const int r = e / D;
      const int c = e % D;
      const int gr = row0 + r;
      dst[r * LD + c] =
          gr < s_len && c < d ? to_f32(src[gr * row_stride + c]) : 0.f;
    }
  }
}

// Stage src[row0 .. row0 + 63] (lse, delta or segment ids) by cp.async;
// zeros past S.
template <typename U>
__device__ __forceinline__ void stage_rows(U* dst, const U* src, int row0,
                                           int s_len) {
  for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
    const bool in = row0 + r < s_len;
    cp_async4(dst + r, in ? src + row0 + r : src, in);
  }
}

// ------------------------------------------- tensor cores, 16-bit operands

// bfloat16 and float16 operands need no split: the tensor cores take
// them exactly, one mma.sync m16n8k16 (twice an m16n8k8's k) with
// float32 accumulators per product, at the 989 TFLOP/s 16-bit rate.
// Their tiles stay in the input dtype in shared memory, rows padded to
// D + 8 elements: a row is then an odd number (D / 8 + 1) of 16-byte
// chunks, so the 8 rows an ldmatrix phase reads start in 8 distinct
// 16-byte bank groups, and every row stays 16-byte aligned for cp.async
// and ldmatrix.
template <typename T>
constexpr bool kHalfWidth = !std::is_same<T, float>::value;

template <int D>
__host__ __device__ constexpr int tile_ld16() {
  return D + 8;
}

// An A fragment of m16n8k16: rows g and g + 8, k = 2t, 2t + 1 (a0, a1)
// and k = 2t + 8, 2t + 9 (a2, a3), two 16-bit values a register, the
// lower k in the low half.
struct Frag16 {
  uint32_t x[4];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float (&c)[4],
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// c += a . b, B's k = 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const Frag16& a,
                                      uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a.x, b);
  else
    mma_bf16(c, a.x, b);
}

// lo and hi rounded to the nearest bfloat16 / float16 (ties to even),
// packed into one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16x2(lo, hi);
  else
    return pack_bf16x2(lo, hi);
}

// Four 8 x 8 16-bit matrices of shared memory: lane 8j + r gives the
// address of row r of matrix j; lane 4g + t gets x[j] = row g, columns
// 2t and 2t + 1 of matrix j (non-transposed), or rows 2t and 2t + 1 of
// column g (transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&x)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&x)[4],
                                              const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
}

// A = rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a row-major tile:
// matrix j is rows + 8 (j & 1), columns + 8 (j >> 1).
template <int LD, typename T>
__device__ __forceinline__ Frag16 load_a16(const T* tile, int r0, int k0,
                                           int lane) {
  const int j = lane / 8;
  Frag16 f;
  ldsm_x4(f.x, tile + (r0 + lane % 8 + 8 * (j & 1)) * LD + k0 + 8 * (j >> 1));
  return f;
}

// B[k][n] = tile[n0 + n][k0 + k] for two 8-column blocks (n0 in b[0..1],
// n0 + 8 in b[2..3]): a tile whose rows are the product's columns (k^T
// in q . k^T).
template <int LD, typename T>
__device__ __forceinline__ void load_bt16(uint32_t (&b)[4], const T* tile,
                                          int n0, int k0, int lane) {
  const int j = lane / 8;
  ldsm_x4(b, tile + (n0 + lane % 8 + 8 * (j >> 1)) * LD + k0 + 8 * (j & 1));
}

// B[k][n] = tile[k0 + k][n0 + n] for two 8-column blocks, read
// transposed: a row-major tile whose rows are the product's k (V in
// P . V, dO in P^T . dO, q in dS^T . q, K in dS . K).
template <int LD, typename T>
__device__ __forceinline__ void load_b16(uint32_t (&b)[4], const T* tile,
                                         int k0, int n0, int lane) {
  const int j = lane / 8;
  ldsm_x4_trans(b, tile + (k0 + lane % 8 + 8 * (j & 1)) * LD + n0 +
                       8 * (j >> 1));
}

// The two 16-bit values of a register as floats (exact).
template <typename T>
__device__ __forceinline__ void unpack16(uint32_t x, float& lo, float& hi) {
  if constexpr (std::is_same<T, __half>::value) {
    lo = __half2float(__ushort_as_half(static_cast<unsigned short>(x)));
    hi = __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16)));
  } else {
    lo = __uint_as_float(x << 16);
    hi = __uint_as_float(x & 0xffff0000u);
  }
}

// x0, x1 as hi + lo in T: hi = x rounded to T, lo = (x - hi) rounded to
// T (x - hi is exact in float32), so hi + lo keeps x to about 2^-16
// relative in bfloat16 (2^-22 in float16) where hi alone keeps 2^-9
// (2^-12).
template <typename T>
__device__ __forceinline__ void split16(uint32_t& hi, uint32_t& lo, float x0,
                                        float x1) {
  hi = pack16<T>(x0, x1);
  float h0, h1;
  unpack16<T>(hi, h0, h1);
  lo = pack16<T>(x0 - h0, x1 - h1);
}

// Two adjacent m16n8 accumulator tiles (columns 8j .. 8j + 7 and the next
// 8) as the A operand of a k16 product over their 16 columns, split into
// hi + lo in T: the accumulator layout is exactly the A fragment, so p
// and dS go from the accumulators into the next product without a trip
// through shared memory. p or dS rounded to T alone (hi only) puts an
// error of up to 1.25 output ulps into bfloat16 gradients at the
// training shape, past the 1e-2 contract (scripts/flash16_rounding.py);
// with lo it is 0.002 ulps.
template <typename T>
__device__ __forceinline__ void acc_as_a16(Frag16& hi, Frag16& lo,
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  split16<T>(hi.x[0], lo.x[0], c0[0], c0[1]);
  split16<T>(hi.x[1], lo.x[1], c0[2], c0[3]);
  split16<T>(hi.x[2], lo.x[2], c1[0], c1[1]);
  split16<T>(hi.x[3], lo.x[3], c1[2], c1[3]);
}

// out[n] = A . B for a warp's 16-row strip over k < D, B[k][n] =
// tile[c0 + n][k] for n < N: the score-like products q . k^T, dO . v^T
// (and transposed, k . q^T, v . dO^T). a(kk) gives A at columns 16 kk.
template <typename T, int D, int N, typename AFrag>
__device__ __forceinline__ void strip_by_rows(float (&out)[N / 8][4],
                                              AFrag a, const T* tile,
                                              int c0, int lane) {
  constexpr int LD = tile_ld16<D>();
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const Frag16 af = a(kk);
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t b[4];
      load_bt16<LD>(b, tile, c0 + 8 * n, 16 * kk, lane);
      mma16<T>(out[n], af, b[0], b[1]);
      mma16<T>(out[n + 1], af, b[2], b[3]);
    }
  }
}

// sum[n] += A . tile[k0 .. k0 + K) for a warp's strip, A = hi + lo the
// split fragments (k = 16 j .. 16 j + 15) and the tile row-major [k][D]:
// the P . V-like products, two MMAs each (lo first). Each pair of
// 8-column blocks goes through fresh accumulators, then into the
// float32 sum (promote has why).
template <typename T, int D, int K>
__device__ __forceinline__ void strip_times_tile(float (&sum)[D / 8][4],
                                                 const Frag16 (&hi)[K / 16],
                                                 const Frag16 (&lo)[K / 16],
                                                 const T* tile, int k0,
                                                 int lane) {
  constexpr int LD = tile_ld16<D>();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < K / 16; ++j) {
      uint32_t b[4];
      load_b16<LD>(b, tile, k0 + 16 * j, 16 * n, lane);
      mma16<T>(t0, lo[j], b[0], b[1]);
      mma16<T>(t1, lo[j], b[2], b[3]);
      mma16<T>(t0, hi[j], b[0], b[1]);
      mma16<T>(t1, hi[j], b[2], b[3]);
    }
    promote(sum[2 * n], t0);
    promote(sum[2 * n + 1], t1);
  }
}

// 2^x by the MUFU's ex2.approx.ftz: exp2f without its handling of
// results below float32's normal range, which a probability that small
// does not need (it flushes to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Segment ids of the columns a lane holds of an N-column chunk at c0:
// ids[n].x for column c0 + 8n + 2t, ids[n].y for the next: one 8-byte
// shared load per pair of columns, compared with the rows' ids held in
// registers (keep_bits). keep's loads and branches per element cost the
// 16-bit forward about 40% of its time on an H100 (PERF.md).
template <int N>
__device__ __forceinline__ void lane_ids(int2 (&ids)[N / 8], const int* seg,
                                         int c0, int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
    ids[n] = *reinterpret_cast<const int2*>(seg + c0 + 8 * n + 2 * t);
}

// The keep-mask of the elements a lane holds of a warp's strip of one
// tile pair, bit 4n + e for element [n][e] (N <= 64 columns): rows row0 +
// g and row0 + g + 8, columns col0 + c0 + 8n + 2t (+ 1), absolute
// positions, queries or keys as rows_are_queries says. With segment ids
// (cols_seg, the column tile's staged ids; id_r, the rows' ids) a pair
// is kept when the ids match; on an edge tile pair (tile_masked without
// segments: a tile reaching past S, or keys right of a query row) also
// only when both positions are below S and, under causal, the key is
// not right of the query: keep's function, with the compares an
// interior pair does not need left out.
template <int N>
__device__ __forceinline__ unsigned keep_bits(const int (&id_r)[2],
                                              const int* cols_seg, int row0,
                                              int col0, int c0, bool edge,
                                              bool rows_are_queries,
                                              int s_len, int causal, int g,
                                              int t) {
  unsigned bits = ~0u;
  if (cols_seg != nullptr) {
    int2 ids[N / 8];
    lane_ids<N>(ids, cols_seg, c0, t);
    bits = 0u;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bits |= static_cast<unsigned>(
                    id_r[e >> 1] == ((e & 1) ? ids[n].y : ids[n].x))
                << (4 * n + e);
  }
  if (edge) {
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int col = col0 + c0 + 8 * n + 2 * t + (e & 1);
        const int q = rows_are_queries ? row : col;
        const int k = rows_are_queries ? col : row;
        if (q >= s_len || k >= s_len || (causal && k > q))
          bits &= ~(1u << (4 * n + e));
      }
  }
  return bits;
}

// Stage rows [row0, row0 + 64) of one (b, h) slice into a [64][D + 8]
// tile of T, or (Swizzled) into a swizzled [64][D] one (sw_offset,
// below: a 16-byte chunk stays whole under the swizzle); rows past S and
// columns past d are zeros. When vec, by 16-byte cp.async (to be waited
// for with cp_async_wait); else, with plain loads and stores (any d, any
// stride).
template <int D>
__device__ __forceinline__ int sw_offset(int r, int c);

template <typename T, int D, bool Swizzled = false>
__device__ __forceinline__ void stage_tile16(T* dst, const T* src,
                                             int64_t row_stride, int row0,
                                             int s_len, int d, bool vec) {
  constexpr int LD = tile_ld16<D>();
  const auto at = [](int r, int c) {
    if constexpr (Swizzled)
      return sw_offset<D>(r, c);
    else
      return r * LD + c;
  };
  if (vec) {
    for (int e = threadIdx.x; e < kTile * D / 8; e += kMmaThreads) {
      const int r = e / (D / 8);
      const int c = e % (D / 8) * 8;
      const bool in = row0 + r < s_len && c < d;
      cp_async16(dst + at(r, c),
                 in ? src + (row0 + r) * row_stride + c : src, in);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * D; e += kMmaThreads) {
    const int r = e / D;
    const int c = e % D;
    const int gr = row0 + r;
    dst[at(r, c)] =
        gr < s_len && c < d ? src[gr * row_stride + c] : from_f32<T>(0.f);
  }
}

// Shared memory of mark_tiles: the own tile's run heads and their
// count, and a byte per tile of the row.
__host__ __device__ constexpr size_t tile_marks_bytes(int s_len) {
  return sizeof(int) * (kTile + 1) +
         ((s_len + kTile - 1) / kTile + 15) / 16 * 16;
}

// flags[t] for the tiles t0 <= t < t1 of the other side (key tiles for a
// query tile, query tiles for a key tile): 1 when some row of tile t
// shares a segment id with some row of the block's own tile (its ids
// staged in own, its first row own0; rows past S count for nothing), or
// when t is `always` (the causal diagonal), else 0. The forward's exact
// test, one pass for all the tiles: the own tile's ids reduce first to
// their run heads (an id that differs from the row before; every id of
// the tile is one), a few for packed documents, so a row of tile t
// costs one load and a few compares. Every thread reads the same flags
// after the closing barrier, so a walk that skips the tiles flagged 0
// is uniform across the block. own must be staged and visible.
__device__ __forceinline__ void mark_tiles(unsigned char* flags, int* heads,
                                           const int* own, int own0,
                                           const int* seg_row, int t0,
                                           int t1, int always, int s_len) {
  if (threadIdx.x < 32) {
    const int own_rows = min(kTile, s_len - own0);
    int n = 0;
    for (int r = threadIdx.x; r < kTile; r += 32) {
      const bool head = r < own_rows && (r == 0 || own[r] != own[r - 1]);
      const unsigned mask = __ballot_sync(kFullMask, head);
      if (head) heads[n + __popc(mask & ((1u << threadIdx.x) - 1u))] = own[r];
      n += __popc(mask);
    }
    if (threadIdx.x == 0) heads[kTile] = n;
  }
  for (int t = t0 + threadIdx.x; t < t1; t += kMmaThreads)
    flags[t] = t == always;
  __syncthreads();
  const int n_heads = heads[kTile];
  const int c = threadIdx.x % kTile;
#pragma unroll 4
  for (int t = t0 + threadIdx.x / kTile; t < t1; t += kMmaThreads / kTile) {
    const int row = t * kTile + c;
    if (row >= s_len) continue;
    const int id = seg_row[row];
    for (int i = 0; i < n_heads; ++i)
      if (heads[i] == id) flags[t] = 1;
  }
  __syncthreads();
}

// ------------------------------------------ tensor cores, wgmma (Hopper)

// The 16-bit backward of K2 runs its tile products as wgmma.mma_async
// m64nNk16: the block's four warps are one warpgroup, and warp w's part
// of the 64-row accumulator is rows 16w .. 16w + 15 in the m16n8
// accumulator layout (d[4j + e] is element [j][e] of the mma.sync
// kit's [N / 8][4] arrays), so keep_bits, acc_as_a16 and store_strip
// carry over. B, and the A of the score-like products, come from
// shared memory through matrix descriptors; p^T and dS^T are the
// register A operand (the m16n8k16 A layout, which acc_as_a16 builds).
//
// The descriptors read a swizzled tile: a [64][D] tile of 16-bit values
// is D * 2 / R atoms of 64 rows x R bytes (R = min(2 D, 128): the 32-,
// 64- or 128-byte swizzle), a row's R bytes in 16-byte chunks, chunk c
// of row r stored at chunk c ^ (r / (128 / R) % (R / 16)): the address
// bits [4, 4 + log2(R / 16)) XORed with bits [7, ...), as the hardware
// reads them. The same tile is read K-major (rows are the product's M
// or N, its k contiguous: q, dO, k, v in S^T = k . q^T, dP^T = v . dO^T,
// S = q . k^T, dP = dO . v^T) and MN-major (rows are its k: dO, q in
// dV = P^T . dO, dK = dS^T . q, k in dQ = dS . K). Atoms start on
// 1024-byte boundaries (sw_base), so the swizzle of an address is that
// of its offset in the atom.
template <int D>
__host__ __device__ constexpr int sw_row_bytes() {
  return 2 * D < 128 ? 2 * D : 128;
}

// Element offset of (row r, column c) in a swizzled [64][D] tile.
template <int D>
__device__ __forceinline__ int sw_offset(int r, int c) {
  constexpr int R = sw_row_bytes<D>();
  const int byte = 2 * c;
  int o = r * R + byte % R;
  o ^= ((o >> 7) & (R / 16 - 1)) << 4;
  return (byte / R * kTile * R + o) / 2;
}

// The first 1024-byte boundary of the block's dynamic shared memory at
// or past smem (the launch asks for 1024 bytes more than it lays out).
template <typename T>
__device__ __forceinline__ T* sw_base(void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return reinterpret_cast<T*>(static_cast<char*>(smem) +
                              ((1024u - a % 1024u) % 1024u));
}

// A wgmma matrix descriptor of a swizzled tile: bits 0-13 the start
// address / 16, 16-29 the leading byte offset / 16, 32-45 the stride
// byte offset / 16 (8 rows: 8 R bytes, in both readings), 62-63 the
// swizzle (1: 128 bytes, 2: 64, 3: 32).
template <int D>
__device__ __forceinline__ uint64_t sw_desc(const void* start,
                                            uint32_t lbo) {
  constexpr int R = sw_row_bytes<D>();
  constexpr uint64_t layout = R == 128 ? 1 : R == 64 ? 2 : 3;
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(start));
  return static_cast<uint64_t>((a >> 4) & 0x3fffu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>(((8 * R) >> 4) & 0x3fff) << 32 |
         layout << 62;
}

// K-major: the operand whose rows r0 .. are its M (or N) and whose k
// is the tile's columns 16 kk .. 16 kk + 15 (the leading byte offset is
// unused under a swizzle).
template <typename T, int D>
__device__ __forceinline__ uint64_t desc_k(const T* tile, int r0, int kk) {
  constexpr int R = sw_row_bytes<D>();
  return sw_desc<D>(reinterpret_cast<const char*>(tile) +
                        (32 * kk / R) * kTile * R + r0 * R + 32 * kk % R,
                    16);
}

// MN-major: the operand whose k is the tile's rows k0 .. k0 + 15 and
// whose N is its columns; the leading byte offset steps from one atom
// of R / 2 columns to the next.
template <typename T, int D>
__device__ __forceinline__ uint64_t desc_mn(const T* tile, int k0) {
  constexpr int R = sw_row_bytes<D>();
  return sw_desc<D>(reinterpret_cast<const char*>(tile) + k0 * R,
                    kTile * R);
}

// wgmma.fence: the registers an ordinary instruction wrote (accumulators,
// A fragments) are in place before the next wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed wgmma groups are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (cp.async, stores) made visible
// to the async proxy that wgmma reads it through; before the barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator
// across an asynchronous wgmma (after wgmma_wait, before the next one).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (the warpgroup's 64 x N accumulator, N / 2 floats a thread) = A .
// B, plus d when accumulate: A [64][16] and B [16][N] from shared
// memory, K-major (0) or MN-major (1) as TransA / TransB say.
template <typename T, int N, int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  static_assert(N == 32 || N == 64, "the score-like products' widths");
  if constexpr (N == 32 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransA),
          "n"(TransB));
  else if constexpr (N == 32 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransA),
          "n"(TransB));
  else if constexpr (N == 64 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransA),
          "n"(TransB));
  else if constexpr (N == 64 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TransA),
          "n"(TransB));
}

// d = A . B (+ d): A [64][16] from registers (a: this thread's m16n8k16
// A fragment of its warp's 16 rows), B [16][N] from shared memory.
template <typename T, int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "a tile width");
  if constexpr (N == 16 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 16 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 32 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 32 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 64 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 64 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 128 && !kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
  else if constexpr (N == 128 && kF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(accumulate), "n"(TransB));
}

// A [rows][4] array of m16n8 accumulator tiles as wgmma's flat operand.
template <int N>
__device__ __forceinline__ float (&flat(float (&acc)[N][4]))[4 * N] {
  return reinterpret_cast<float(&)[4 * N]>(acc);
}

// ------------------------------------------------------------- shared

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

// Whether a (query tile q0, key tile k0) pair needs the keep-mask at
// all: segments, a tile reaching past S, or keys right of a query row.
__device__ __forceinline__ bool tile_masked(int q0, int k0, int s_len,
                                            int causal, bool segmented) {
  return segmented || q0 + kTile > s_len || k0 + kTile > s_len ||
         (causal && k0 + kTile - 1 > q0);
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

// Reduce over the 4 lanes of an mma quad (the lanes holding one row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// ------------------------------------------------------------- forward

// Shared memory of a forward block (K1 and K2): the query tile, a ring
// of two (k, v) tiles, and the query tile's and the ring's segment ids.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * 5 * kTile * tile_ld<D>() + sizeof(int) * 3 * kTile;
}

// S = q . k^T for a warp's 16-row strip (query rows r0 .. r0 + 15)
// against the 64 keys of the staged tile ks, in 3xTF32: s[n][e] is (row
// r0 + g + 8 (e >> 1), key 8n + 2t + (e & 1)). q_frag(kk) gives the
// strip's split q fragment at columns kk .. kk + 7: loaded from the
// staged query tile as needed (q_from_tile), or split once per block
// and held in registers (load_q), which saves the A loads and splits
// of every key tile at the price of D registers.
template <int D, typename QFrag>
__device__ __forceinline__ void score_tile(float (&s)[kTile / 8][4],
                                           QFrag q_frag, const float* ks,
                                           int lane) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    const FragA aq = q_frag(kk);
#pragma unroll
    for (int n = 0; n < kTile / 8; n += 2) {
      FragB bk[2];
      load_bt2<LD>(bk[0], bk[1], ks, 8 * n, kk, lane);
      mma3(s[n], aq, bk[0]);
      mma3(s[n + 1], aq, bk[1]);
    }
  }
}

// score_tile's q fragments loaded from the staged query tile qs.
template <int D>
__device__ __forceinline__ auto q_from_tile(const float* qs, int r0,
                                            int lane) {
  return [=](int kk) {
    FragA a;
    load_a<tile_ld<D>()>(a, qs, r0, kk, lane);
    return a;
  };
}

// The strip's split q fragments, every column, for score_tile to hold.
template <int D>
__device__ __forceinline__ void load_q(FragA (&qf)[D / 8], const float* qs,
                                       int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 8)
    load_a<tile_ld<D>()>(qf[kk / 8], qs, r0, kk, lane);
}

// pv = P . V for the strip, P in score_tile's accumulator layout (it
// goes straight into the product as its A operand) and V the staged
// [64][D] tile: a fresh accumulator, which the caller adds into its
// float32 carry (promote has why).
template <int D>
__device__ __forceinline__ void pv_tile(float (&pv)[D / 8][4],
                                        const float (&p)[kTile / 8][4],
                                        const float* vs, int g, int t) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    FragA ap;
    acc_as_a(ap, p[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB bv;
      load_b_perm<LD>(bv, vs, 8 * j, 8 * n, g, t);
      mma3(pv[n], ap, bv);
    }
  }
}

// A forward's epilogue for a warp's strip, query rows row0 + g and
// row0 + g + 8: O = acc / l and lse = (m + log2(l)) * ln(2), m the row
// max in log2 units (the same in a row's 4 lanes) and l this lane's
// partial sum of p; a fully masked row, l = 0, gives O = 0 and
// lse = -inf.
template <typename T, int D>
__device__ __forceinline__ void store_forward(const Params& p, int bh,
                                              int row0, const float (&m)[2],
                                              const float (&l)[2],
                                              const float (&acc)[D / 8][4],
                                              int g, int t) {
  T* ob = static_cast<T*>(p.out) + static_cast<int64_t>(bh) * p.s_len * p.d;
  float* lb = p.lse + static_cast<int64_t>(bh) * p.s_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lr = quad_sum(l[half]);
    const int row = row0 + g + 8 * half;
    if (row >= p.s_len) continue;
    if (t == 0)
      lb[row] = lr > 0.f ? (m[half] + log2f(lr)) * kLn2 : -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < p.d)
          ob[static_cast<int64_t>(row) * p.d + col] =
              from_f32<T>(lr > 0.f ? acc[n][2 * half + e] / lr : 0.f);
      }
  }
}

// Store a warp's 16-row strip of a [64][D] accumulator (rows r0 + g and
// r0 + g + 8, columns 8n + 2t and 8n + 2t + 1), times mul, into rows
// row0 + r0 .. of a contiguous [S, d] output.
template <typename T, int D>
__device__ __forceinline__ void store_strip(T* out, const float (&acc)[D / 8][4],
                                            int row0, int s_len, int d,
                                            float mul, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= s_len) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < d)
          out[static_cast<int64_t>(row) * d + col] =
              from_f32<T>(acc[n][2 * half + e] * mul);
      }
  }
}

// ------------------------------------------------------------ backward

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

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k and v; a ring of two (q, dO) tiles; two (lse, delta) rows; the
  // ring's query and the block's key segment ids
  return sizeof(float) * (6 * kTile * tile_ld<D>() + 4 * kTile) +
         sizeof(int) * 3 * kTile;
}

// (query tile, key tile) pairs the 16-bit forward has computed since it
// was last read (K1's forward counts in every dtype): the record that its
// tile skipping ran.
__device__ unsigned long long g_tile_pairs;

// (query tile, key tile) pairs the 16-bit backward's dK/dV kernel [0]
// and dQ kernel [1] have computed since they were last read: the record
// that their segment-tile skipping ran. One add per block when it ends;
// no block adds into another's gradients.
__device__ unsigned long long g_bwd_tile_pairs[2];

// Depth of the 16-bit backward's ring of streamed tiles: the copies of
// the next kRingBwd - 1 kept tiles are in flight while one is computed.
constexpr int kRingBwd = 3;

// Shared memory of the 16-bit dK/dV and dQ blocks: two resident and
// 2 kRingBwd streamed swizzled tiles, the ring's (and the resident
// tile's) rows of lse, delta and segment ids, mark_tiles' heads and
// flags, and 1024 bytes to align the tiles on (sw_base).
template <int D>
constexpr size_t bwd16_smem_bytes(int s_len) {
  return 1024 + 2 * (2 + 2 * kRingBwd) * kTile * D +
         (sizeof(float) * 2 + sizeof(int)) * kRingBwd * kTile +
         sizeof(int) * kTile + tile_marks_bytes(s_len);
}

// flash_dkv_kernel for bfloat16 and float16, on wgmma: the same grid,
// masks and float32 lse, delta and sums, with the 16-bit tiles swizzled
// for the descriptors and the query tiles streamed through a ring of
// kRingBwd. Per chunk of QC queries: S^T = k . q^T and dP^T = v . dO^T
// as wgmma m64nQCk16 with both operands in shared memory (one group),
// then dV += P^T . dO and dK += dS^T . q as m64nDk16 with p^T and dS^T
// split into hi + lo in T (two products each) as the register A
// operand, accumulated by the wgmma in dV and dK themselves across the
// sweep. The next tiles' copies run under both groups. The query tiles
// that share no segment id with the key tile are skipped (mark_tiles;
// they add exact zeros).
template <typename T, int D>
__device__ __forceinline__ void flash_dkv16(const Params& p) {
  constexpr int TILE = kTile * D;           // elements of a swizzled tile
  constexpr int QC = D > 64 ? 32 : 64;      // queries per chunk
  constexpr int QN = QC / 8;
  extern __shared__ __align__(16) float tc_smem[];
  T* ks = sw_base<T>(tc_smem);
  T* vs = ks + TILE;
  T* qs = vs + TILE;                        // [kRingBwd][TILE]
  T* dos = qs + kRingBwd * TILE;            // [kRingBwd][TILE]
  float* lse_s = reinterpret_cast<float*>(dos + kRingBwd * TILE);
  float* delta_s = lse_s + kRingBwd * kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kRingBwd * kTile);
  int* seg_k = seg_q + kRingBwd * kTile;
  int* heads = seg_k + kTile;
  unsigned char* flags = reinterpret_cast<unsigned char*>(heads + kTile + 1);

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* lseb = p.lse + static_cast<int64_t>(bh) * s_len;
  const float* deltab = p.delta + static_cast<int64_t>(bh) * s_len;

  auto stage_query_side = [&](int qt, int slot) {
    const int q0 = qt * kTile;
    stage_tile16<T, D, true>(qs + slot * TILE, qb, p.sq.s, q0, s_len, p.d,
                             p.vec);
    stage_tile16<T, D, true>(dos + slot * TILE, dob, p.sdo.s, q0, s_len,
                             p.d, p.vec);
    stage_rows(lse_s + slot * kTile, lseb, q0, s_len);
    stage_rows(delta_s + slot * kTile, deltab, q0, s_len);
    if (segmented) stage_rows(seg_q + slot * kTile, seg_row, q0, s_len);
  };

  stage_tile16<T, D, true>(
      ks, static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h,
      p.sk.s, k0, s_len, p.d, p.vec);
  stage_tile16<T, D, true>(
      vs, static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h,
      p.sv.s, k0, s_len, p.d, p.vec);
  if (segmented) stage_rows(seg_k, seg_row, k0, s_len);
  cp_async_commit();
  const int n_qt = (s_len + kTile - 1) / kTile;
  // causal: query rows below k0 see none of these keys
  const int qt0 = p.causal ? blockIdx.y : 0;
  if (segmented) {
    cp_async_wait<0>();
    __syncthreads();
    mark_tiles(flags, heads, seg_k, k0, seg_row, qt0, n_qt,
               p.causal ? static_cast<int>(blockIdx.y) : -1, s_len);
  }
  auto next_kept = [&](int qt) {
    if (segmented)
      while (qt < n_qt && !flags[qt]) ++qt;
    return qt;
  };
  // the ring: one group a step (empty past the last kept tile)
  int fetch = next_kept(qt0);
  for (int slot = 0; slot < kRingBwd - 1; ++slot) {
    if (fetch < n_qt) {
      stage_query_side(fetch, slot);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
  }
  // p = exp(s * scale - lse) = exp2(s * scale2 - lse * log2(e))
  const float scale2 = p.scale * kLog2e;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  int id_r[2] = {0, 0};  // the segment ids of keys r0 + g and r0 + g + 8

  unsigned pairs = 0;
  for (int qt = next_kept(qt0), i = 0; qt < n_qt;
       qt = next_kept(qt + 1), ++i) {
    const int slot = i % kRingBwd;
    cp_async_wait<kRingBwd - 2>();
    fence_async_shared();
    // tile i has landed for every thread (and for wgmma), and every
    // thread's products of step i - 1 are done with the slot the next
    // copy refills
    __syncthreads();
    if (fetch < n_qt) {
      stage_query_side(fetch, (i + kRingBwd - 1) % kRingBwd);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
    const int q0 = qt * kTile;
    const T* qt_s = qs + slot * TILE;
    const T* dot_s = dos + slot * TILE;
    const float* lse_t = lse_s + slot * kTile;
    const float* delta_t = delta_s + slot * kTile;
    const int* seg_t = seg_q + slot * kTile;
    const bool edge = tile_masked(q0, k0, s_len, p.causal, false);
    if (i == 0 && segmented) {
      id_r[0] = seg_k[r0 + g];
      id_r[1] = seg_k[r0 + g + 8];
    }

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QC) {
      float st[QN][4], dpt[QN][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<T, QC, 0, 0>(flat(st), desc_k<T, D>(ks, 0, kk),
                              desc_k<T, D>(qt_s, c0, kk), kk > 0);
        wgmma_ss<T, QC, 0, 0>(flat(dpt), desc_k<T, D>(vs, 0, kk),
                              desc_k<T, D>(dot_s, c0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(flat(st));
      fence_operands(flat(dpt));
      const unsigned kept = keep_bits<QC>(
          id_r, segmented ? seg_t : nullptr, k0 + r0, q0, c0, edge, false,
          s_len, p.causal, g, t);
      // p^T and dS^T: element (key r0 + g (+ 8), query c0 + 8n + 2t (+ 1))
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        const float2 lse = *reinterpret_cast<const float2*>(
            lse_t + c0 + 8 * n + 2 * t);
        const float2 delta = *reinterpret_cast<const float2*>(
            delta_t + c0 + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = e & 1 ? lse.y : lse.x;
          const bool live = (kept >> (4 * n + e) & 1u) && isfinite(lse_c);
          const float pv =
              live ? exp2_ftz(fmaf(st[n][e], scale2, -lse_c * kLog2e)) : 0.f;
          st[n][e] = pv;
          dpt[n][e] = pv * (dpt[n][e] - (e & 1 ? delta.y : delta.x));
        }
      }
      Frag16 ap[QC / 16], ap_lo[QC / 16], ads[QC / 16], ads_lo[QC / 16];
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        acc_as_a16<T>(ap[j], ap_lo[j], st[2 * j], st[2 * j + 1]);
        acc_as_a16<T>(ads[j], ads_lo[j], dpt[2 * j], dpt[2 * j + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        const uint64_t bdo = desc_mn<T, D>(dot_s, c0 + 16 * j);
        const uint64_t bq = desc_mn<T, D>(qt_s, c0 + 16 * j);
        wgmma_rs<T, D, 1>(flat(dv), ap_lo[j].x, bdo, 1);
        wgmma_rs<T, D, 1>(flat(dv), ap[j].x, bdo, 1);
        wgmma_rs<T, D, 1>(flat(dk), ads_lo[j].x, bq, 1);
        wgmma_rs<T, D, 1>(flat(dk), ads[j].x, bq, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(flat(dv));
      fence_operands(flat(dk));
    }
    ++pairs;
  }
  if (threadIdx.x == 0 && pairs > 0)
    atomicAdd(&g_bwd_tile_pairs[0], static_cast<unsigned long long>(pairs));

  const int64_t base = static_cast<int64_t>(bh) * s_len * p.d;
  store_strip<T, D>(static_cast<T*>(p.dk) + base, dk, k0 + r0, s_len, p.d,
                    p.scale, g, t);
  store_strip<T, D>(static_cast<T*>(p.dv) + base, dv, k0 + r0, s_len, p.d,
                    1.f, g, t);
}

// flash_dq_kernel for bfloat16 and float16, as flash_dkv16 is to its
// kernel: per key tile S = q . k^T and dP = dO . v^T as wgmma m64n64k16
// from shared memory, then dQ += dS . K as m64nDk16 with dS (scaled,
// hi + lo in T) the register A operand and K read MN-major; the key
// tiles stream through a ring of kRingBwd, those that share no segment
// id with the query tile skipped.
template <typename T, int D>
__device__ __forceinline__ void flash_dq16(const Params& p) {
  constexpr int TILE = kTile * D;
  constexpr int KN = kTile / 8;
  extern __shared__ __align__(16) float tc_smem[];
  T* qs = sw_base<T>(tc_smem);
  T* dos = qs + TILE;
  T* ks = dos + TILE;                       // [kRingBwd][TILE]
  T* vs = ks + kRingBwd * TILE;             // [kRingBwd][TILE]
  float* lse_s = reinterpret_cast<float*>(vs + kRingBwd * TILE);
  float* delta_s = lse_s + kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kTile);
  int* seg_k = seg_q + kTile;               // [kRingBwd][64]
  int* heads = seg_k + kRingBwd * kTile;
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
    stage_tile16<T, D, true>(ks + slot * TILE, kb, p.sk.s, k0, s_len, p.d,
                             p.vec);
    stage_tile16<T, D, true>(vs + slot * TILE, vb, p.sv.s, k0, s_len, p.d,
                             p.vec);
    if (segmented) stage_rows(seg_k + slot * kTile, seg_row, k0, s_len);
  };

  stage_tile16<T, D, true>(
      qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
      p.sq.s, q0, s_len, p.d, p.vec);
  stage_tile16<T, D, true>(
      dos, static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
      p.sdo.s, q0, s_len, p.d, p.vec);
  stage_rows(lse_s, p.lse + static_cast<int64_t>(bh) * s_len, q0, s_len);
  stage_rows(delta_s, p.delta + static_cast<int64_t>(bh) * s_len, q0, s_len);
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
  int fetch = next_kept(0);
  for (int slot = 0; slot < kRingBwd - 1; ++slot) {
    if (fetch < n_kt) {
      stage_key_side(fetch, slot);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  // this thread's rows r0 + g and r0 + g + 8: lse, delta, and whether
  // the row exists and saw any key (lse finite)
  float lse2_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  bool live_r[2] = {false, false};
  int id_r[2] = {0, 0};  // and its segment ids
  // p = exp(s * scale - lse) = exp2(s * scale2 - lse * log2(e))
  const float scale2 = p.scale * kLog2e;

  unsigned pairs = 0;
  for (int kt = next_kept(0), i = 0; kt < n_kt;
       kt = next_kept(kt + 1), ++i) {
    const int slot = i % kRingBwd;
    cp_async_wait<kRingBwd - 2>();
    fence_async_shared();
    __syncthreads();
    if (fetch < n_kt) {
      stage_key_side(fetch, (i + kRingBwd - 1) % kRingBwd);
      fetch = next_kept(fetch + 1);
    }
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        lse2_r[half] = lse_s[r] * kLog2e;
        delta_r[half] = delta_s[r];
        live_r[half] = q0 + r < s_len && isfinite(lse_s[r]);
        if (segmented) id_r[half] = seg_q[r];
      }
    }
    const int k0 = kt * kTile;
    const T* kt_s = ks + slot * TILE;
    const T* vt_s = vs + slot * TILE;
    const int* seg_t = seg_k + slot * kTile;
    const bool edge = tile_masked(q0, k0, s_len, p.causal, false);

    float s[KN][4], dp[KN][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kTile, 0, 0>(flat(s), desc_k<T, D>(qs, 0, kk),
                               desc_k<T, D>(kt_s, 0, kk), kk > 0);
      wgmma_ss<T, kTile, 0, 0>(flat(dp), desc_k<T, D>(dos, 0, kk),
                               desc_k<T, D>(vt_s, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(flat(s));
    fence_operands(flat(dp));
    const unsigned kept = keep_bits<kTile>(
        id_r, segmented ? seg_t : nullptr, q0 + r0, k0, 0, edge, true, s_len,
        p.causal, g, t);
    // dS: element (query r0 + g (+ 8), key 8n + 2t (+ 1))
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const bool live = live_r[half] && (kept >> (4 * n + e) & 1u);
        const float pv =
            live ? exp2_ftz(fmaf(s[n][e], scale2, -lse2_r[half])) : 0.f;
        s[n][e] = pv * (dp[n][e] - delta_r[half]) * p.scale;
      }
    Frag16 ads[kTile / 16], ads_lo[kTile / 16];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      acc_as_a16<T>(ads[j], ads_lo[j], s[2 * j], s[2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      const uint64_t bk = desc_mn<T, D>(kt_s, 16 * j);
      wgmma_rs<T, D, 1>(flat(dq), ads_lo[j].x, bk, 1);
      wgmma_rs<T, D, 1>(flat(dq), ads[j].x, bk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(flat(dq));
    ++pairs;
  }
  if (threadIdx.x == 0 && pairs > 0)
    atomicAdd(&g_bwd_tile_pairs[1], static_cast<unsigned long long>(pairs));

  store_strip<T, D>(static_cast<T*>(p.dq) + static_cast<int64_t>(bh) *
                                                s_len * p.d,
                    dq, q0 + r0, s_len, p.d, 1.f, g, t);
}

// grid (B * H, key tiles): dV = P^T . dO and dK = scale * dS^T . q over
// every query tile that sees this key tile, dS = p * (dp - delta). Warp
// w owns keys 16w .. 16w + 15: S^T = k . q^T and dP^T = v . dO^T come
// out with keys as rows, which is the A operand dV and dK need, so p
// and dS never leave registers. The query tiles stream through a ring
// of two, QC queries at a time (16 at D = 128 to bound the registers);
// each chunk's dV and dK go through fresh MMA accumulators and are then
// added into the running float32 sums (promote).
// The TPU kernels' dS carries the scale and multiplies the unscaled q;
// here the scale multiplies dK once at the end — the same product.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_kernel(Params p) {
  if constexpr (kHalfWidth<T>) return flash_dkv16<T, D>(p);
  constexpr int LD = tile_ld<D>();
  constexpr int DN = D / 8;                 // 8-column tiles of dK, dV
  constexpr int QC = D > 64 ? 16 : 32;      // queries per chunk
  constexpr int QN = QC / 8;
  extern __shared__ __align__(16) float tc_smem[];
  float* ks = tc_smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;              // [2][64][LD]
  float* dos = qs + 2 * kTile * LD;         // [2][64][LD]
  float* lse_s = dos + 2 * kTile * LD;      // [2][64]
  float* delta_s = lse_s + 2 * kTile;       // [2][64]
  int* seg_q = reinterpret_cast<int*>(delta_s + 2 * kTile);  // [2][64]
  int* seg_k = seg_q + 2 * kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;
  const int s_len = p.s_len;
  const bool segmented = p.seg != nullptr;
  const int* seg_row = segmented ? p.seg + static_cast<int64_t>(b) * s_len
                                 : nullptr;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* lseb = p.lse + static_cast<int64_t>(bh) * s_len;
  const float* deltab = p.delta + static_cast<int64_t>(bh) * s_len;

  auto stage_query_side = [&](int qt, int slot) {
    const int q0 = qt * kTile;
    stage_tile<T, D>(qs + slot * kTile * LD, qb, p.sq.s, q0, s_len, p.d,
                     p.vec);
    stage_tile<T, D>(dos + slot * kTile * LD, dob, p.sdo.s, q0, s_len, p.d,
                     p.vec);
    stage_rows(lse_s + slot * kTile, lseb, q0, s_len);
    stage_rows(delta_s + slot * kTile, deltab, q0, s_len);
    if (segmented) stage_rows(seg_q + slot * kTile, seg_row, q0, s_len);
  };

  stage_tile<T, D>(ks, static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h,
                   p.sk.s, k0, s_len, p.d, p.vec);
  stage_tile<T, D>(vs, static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h,
                   p.sv.s, k0, s_len, p.d, p.vec);
  if (segmented) stage_rows(seg_k, seg_row, k0, s_len);
  const int n_qt = (s_len + kTile - 1) / kTile;
  // causal: query rows below k0 see none of these keys
  const int qt0 = p.causal ? blockIdx.y : 0;
  // p = exp(s * scale - lse) = exp2(s * scale2 - lse * log2(e))
  const float scale2 = p.scale * kLog2e;
  stage_query_side(qt0, 0);
  cp_async_commit();

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int slot = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      stage_query_side(qt + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kTile;
    const float* qt_s = qs + slot * kTile * LD;
    const float* dot_s = dos + slot * kTile * LD;
    const float* lse_t = lse_s + slot * kTile;
    const float* delta_t = delta_s + slot * kTile;
    const int* seg_t = seg_q + slot * kTile;
    const bool masked = tile_masked(q0, k0, s_len, p.causal, segmented);

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QC) {
      float st[QN][4], dpt[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        FragA ak, av;
        load_a<LD>(ak, ks, r0, kk, lane);
        load_a<LD>(av, vs, r0, kk, lane);
#pragma unroll
        for (int n = 0; n < QN; n += 2) {
          FragB bq[2], bdo[2];
          load_bt2<LD>(bq[0], bq[1], qt_s, c0 + 8 * n, kk, lane);
          load_bt2<LD>(bdo[0], bdo[1], dot_s, c0 + 8 * n, kk, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma3(st[n + i], ak, bq[i]);
            mma3(dpt[n + i], av, bdo[i]);
          }
        }
      }
      // p^T and dS^T: element (key r0 + g (+ 8), query c0 + 8n + 2t (+ 1))
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + g + (e >> 1) * 8;
          const int qc = c0 + 8 * n + 2 * t + (e & 1);
          const float lse = lse_t[qc];
          const bool live =
              isfinite(lse) &&
              (!masked || (q0 + qc < s_len &&
                           keep(q0 + qc, k0 + kr, s_len, p.causal, seg_t,
                                seg_k, qc, kr, segmented)));
          const float pv =
              live ? exp2f(fmaf(st[n][e], scale2, -lse * kLog2e)) : 0.f;
          st[n][e] = pv;
          dpt[n][e] = pv * (dpt[n][e] - delta_t[qc]);
        }
      if constexpr (DN <= 8) {
        // every column's partial sums live at once: 2 DN independent
        // MMA chains (10% faster at D = 64 than the order below, which
        // has 2)
        float tv[DN][4], tk[DN][4];
#pragma unroll
        for (int n = 0; n < DN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) tv[n][e] = tk[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          FragA ap, ads;
          acc_as_a(ap, st[j]);
          acc_as_a(ads, dpt[j]);
#pragma unroll
          for (int n = 0; n < DN; ++n) {
            FragB bdo, bq;
            load_b_perm<LD>(bdo, dot_s, c0 + 8 * j, 8 * n, g, t);
            load_b_perm<LD>(bq, qt_s, c0 + 8 * j, 8 * n, g, t);
            mma3(tv[n], ap, bdo);
            mma3(tk[n], ads, bq);
          }
        }
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          promote(dv[n], tv[n]);
          promote(dk[n], tk[n]);
        }
      } else {
        // D = 128: dK and dV already hold 128 registers; split p and dS
        // once and take the columns 8 at a time
        FragA ap[QN], ads[QN];
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          acc_as_a(ap[j], st[j]);
          acc_as_a(ads[j], dpt[j]);
        }
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < QN; ++j) {
            FragB bdo, bq;
            load_b_perm<LD>(bdo, dot_s, c0 + 8 * j, 8 * n, g, t);
            load_b_perm<LD>(bq, qt_s, c0 + 8 * j, 8 * n, g, t);
            mma3(tv, ap[j], bdo);
            mma3(tk, ads[j], bq);
          }
          promote(dv[n], tv);
          promote(dk[n], tk);
        }
      }
    }
    __syncthreads();
  }

  const int64_t base = static_cast<int64_t>(bh) * s_len * p.d;
  store_strip<T, D>(static_cast<T*>(p.dk) + base, dk, k0 + r0, s_len, p.d,
                    p.scale, g, t);
  store_strip<T, D>(static_cast<T*>(p.dv) + base, dv, k0 + r0, s_len, p.d,
                    1.f, g, t);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q and dO; a ring of two (k, v) tiles; the lse and delta rows; the
  // block's query and the ring's key segment ids
  return sizeof(float) * (6 * kTile * tile_ld<D>() + 2 * kTile) +
         sizeof(int) * 3 * kTile;
}

// grid (B * H, query tiles, longest first): dQ = dS . K with dS = p *
// (dp - delta) * scale, as the TPU kernels form it. Warp w owns queries
// 16w .. 16w + 15; S = q . k^T and dP = dO . v^T come out with queries
// as rows, the A operand of dS . K, so dS never leaves registers. The
// key tiles stream through a ring of two, KC keys at a time (32 at D =
// 128 to bound the registers); each chunk's dQ goes through fresh MMA
// accumulators and is then added into the running float32 sum.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_kernel(Params p) {
  if constexpr (kHalfWidth<T>) return flash_dq16<T, D>(p);
  constexpr int LD = tile_ld<D>();
  constexpr int DN = D / 8;
  constexpr int KC = D > 64 ? 32 : 64;      // keys per chunk
  constexpr int KN = KC / 8;
  extern __shared__ __align__(16) float tc_smem[];
  float* qs = tc_smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;             // [2][64][LD]
  float* vs = ks + 2 * kTile * LD;          // [2][64][LD]
  float* lse_s = vs + 2 * kTile * LD;
  float* delta_s = lse_s + kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kTile);
  int* seg_k = seg_q + kTile;               // [2][64]

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
    stage_tile<T, D>(ks + slot * kTile * LD, kb, p.sk.s, k0, s_len, p.d,
                     p.vec);
    stage_tile<T, D>(vs + slot * kTile * LD, vb, p.sv.s, k0, s_len, p.d,
                     p.vec);
    if (segmented) stage_rows(seg_k + slot * kTile, seg_row, k0, s_len);
  };

  stage_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h,
                   p.sq.s, q0, s_len, p.d, p.vec);
  stage_tile<T, D>(dos,
                   static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
                   p.sdo.s, q0, s_len, p.d, p.vec);
  stage_rows(lse_s, p.lse + static_cast<int64_t>(bh) * s_len, q0, s_len);
  stage_rows(delta_s, p.delta + static_cast<int64_t>(bh) * s_len, q0, s_len);
  if (segmented) stage_rows(seg_q, seg_row, q0, s_len);
  stage_key_side(0, 0);
  cp_async_commit();

  float dq[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  // this thread's rows r0 + g and r0 + g + 8: lse, delta, and whether
  // the row exists and saw any key (lse finite)
  float lse2_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  bool live_r[2] = {false, false};
  // p = exp(s * scale - lse) = exp2(s * scale2 - lse * log2(e))
  const float scale2 = p.scale * kLog2e;

  const int n_kt = key_tiles(q0, s_len, p.causal);
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
    if (kt == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        lse2_r[half] = lse_s[r] * kLog2e;
        delta_r[half] = delta_s[r];
        live_r[half] = q0 + r < s_len && isfinite(lse_s[r]);
      }
    }
    const int k0 = kt * kTile;
    const float* kt_s = ks + slot * kTile * LD;
    const float* vt_s = vs + slot * kTile * LD;
    const int* seg_t = seg_k + slot * kTile;
    const bool masked = tile_masked(q0, k0, s_len, p.causal, segmented);

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += KC) {
      float s[KN][4], dp[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        FragA aq, ado;
        load_a<LD>(aq, qs, r0, kk, lane);
        load_a<LD>(ado, dos, r0, kk, lane);
#pragma unroll
        for (int n = 0; n < KN; n += 2) {
          FragB bk[2], bv[2];
          load_bt2<LD>(bk[0], bk[1], kt_s, c0 + 8 * n, kk, lane);
          load_bt2<LD>(bv[0], bv[1], vt_s, c0 + 8 * n, kk, lane);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma3(s[n + i], aq, bk[i]);
            mma3(dp[n + i], ado, bv[i]);
          }
        }
      }
      // dS: element (query r0 + g (+ 8), key c0 + 8n + 2t (+ 1))
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int qr = r0 + g + 8 * half;
          const int kc = c0 + 8 * n + 2 * t + (e & 1);
          const bool live =
              live_r[half] &&
              (!masked || keep(q0 + qr, k0 + kc, s_len, p.causal, seg_q,
                               seg_t, qr, kc, segmented));
          const float pv =
              live ? exp2f(fmaf(s[n][e], scale2, -lse2_r[half])) : 0.f;
          s[n][e] = pv * (dp[n][e] - delta_r[half]) * p.scale;
        }
      float tq[DN][4];
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tq[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        FragA ads;
        acc_as_a(ads, s[j]);
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          FragB bk;
          load_b_perm<LD>(bk, kt_s, c0 + 8 * j, 8 * n, g, t);
          mma3(tq[n], ads, bk);
        }
      }
#pragma unroll
      for (int n = 0; n < DN; ++n) promote(dq[n], tq[n]);
    }
    __syncthreads();
  }

  store_strip<T, D>(static_cast<T*>(p.dq) + static_cast<int64_t>(bh) *
                                                s_len * p.d,
                    dq, q0 + r0, s_len, p.d, 1.f, g, t);
}

// Launch kernel<<<grid, threads, smem>>> after raising its dynamic
// shared memory cap (needed past 48 KB; idempotent, so a race between
// threads setting it is harmless).
template <typename Kernel>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int threads,
                             size_t smem, cudaStream_t stream,
                             const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Whether an operand's rows can be staged in 16-byte copies of `elems`
// elements (4 float32, 8 bfloat16 or float16): a 16-byte aligned base
// and (batch, head, row) strides of whole 16 bytes.
bool rows_vec(const void* ptr, const Strides& s, int elems) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % elems == 0 &&
         s.h % elems == 0 && s.s % elems == 0;
}

// vec_elems: elements of T in 16 bytes; d must be a whole number of them.
void fill_params(Params& p, const int64_t* strides, int heads, int s_len,
                 int d, int causal, float scale, int vec_elems) {
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
  p.vec = d % vec_elems == 0 && rows_vec(p.q, p.sq, vec_elems) &&
          rows_vec(p.k, p.sk, vec_elems) && rows_vec(p.v, p.sv, vec_elems) &&
          (p.dout == nullptr || rows_vec(p.dout, p.sdo, vec_elems));
}

bool bad_shape(int batch, int heads, int s_len, int d) {
  return batch < 1 || heads < 1 || s_len < 1 ||
         d < 1 || d > 128 ||
         static_cast<int64_t>(batch) * heads > 65535 ||
         (s_len + kTile - 1) / kTile > 65535;
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
    const dim3 grid(batch * p.heads, (p.s_len + kTile - 1) / kTile);
    err = launch_with_smem(flash_dkv_kernel<T, D>, grid, kMmaThreads,
                           kHalfWidth<T> ? bwd16_smem_bytes<D>(p.s_len)
                                         : dkv_smem_bytes<D>(),
                           stream, p);
    if (err != cudaSuccess) return err;
    return launch_with_smem(flash_dq_kernel<T, D>, grid, kMmaThreads,
                            kHalfWidth<T> ? bwd16_smem_bytes<D>(p.s_len)
                                          : dq_smem_bytes<D>(),
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
  fill_params(p, strides, heads, s_len, d, causal, scale,
              16 / sizeof(T));
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
  fill_params(p, strides, heads, s_len, d, causal, scale,
              16 / sizeof(T));
  return launch_at_width<T, BwdLaunch>(p, batch, device, stream);
}

// Copy `n` tile-pair counters from `counter` on `device` into pairs and
// set them to 0 (synchronises the device); the first cudaError_t that is
// not cudaSuccess.
int read_tile_pairs(int device, unsigned long long* counter,
                    unsigned long long* pairs, int n) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(pairs, *counter, n * sizeof(*pairs));
  const unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(*counter, zero, n * sizeof(*pairs));
  return static_cast<int>(err);
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
// PREFIX_error_string, and PREFIX_tile_pairs / PREFIX_bwd_tile_pairs);
// FWD_LAUNCH is its forward launcher, a template FWD_LAUNCH<T, D> with a
// static run(params, batch, stream).
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

#define BIGDL_FLASH_BWD_ENTRY(PREFIX, SUFFIX, T)                          \
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
  }                                                                       \
  extern "C" int PREFIX##_tile_pairs(int device,                          \
                                     unsigned long long* pairs) {         \
    return read_tile_pairs(device, &g_tile_pairs, pairs, 1);              \
  }                                                                       \
  extern "C" int PREFIX##_bwd_tile_pairs(int device,                      \
                                         unsigned long long* pairs) {     \
    return read_tile_pairs(device, g_bwd_tile_pairs, pairs, 2);           \
  }
