// Fused dequant int8 GEMM for Hopper (sm_90a):
//   out[m, n] = float(sum_k x_q[m, k] * w_q[n, k]) * x_scale[m] * w_scale[n]
// with x_q [M, K] and w_q [N, K] int8 (both row-major, K contiguous),
// per-row x_scale [M] and per-channel w_scale [N] float32, out [M, N]
// float32.
//
// Replaces bigdl_tpu/kernels/int8_gemm.py:_qmm_kernel (the Pallas TPU
// kernel, launched by pallas_quantized_matmul there): int8 products
// with int32 accumulation, and the float32 dequant epilogue fused so
// the int32 accumulator never goes to device memory. The TPU kernel
// walks K as a sequential grid axis with the accumulator in VMEM
// scratch; here one thread block owns one 64 x 64 output tile and
// walks K itself, 64 bytes at a time, with the accumulator in
// registers.
//
// Bitwise contract (docs/kernels.md "Equivalence contract"): integer
// accumulation is exact in any order, and the epilogue is
// __int2float_rn(acc) * x_scale[m] * w_scale[n], left to right, each
// product rounded on its own (__fmul_rn: nvcc may not reassociate or
// contract it), which is what the plain version's two tensor
// multiplies do. The bias add stays outside, in the dispatch layer's
// one add, as in the JAX package. Exact while |sum| < 2**31, i.e.
// K <= 133,144 for values in [-127, 127].
//
// Bound: at the serving shape (ResNet-50's classifier, M <= 64,
// N = 1000, K = 2048) device-memory bytes, ~2.4 MB, about 0.7 us at
// 3.35 TB/s; at large square shapes the int8 tensor-core rate
// (1,979 TOP/s dense on an H100 SXM), 4096^3 about 70 us.
//
// Design (a simple kernel that is right; a later change pipelines it):
//  * tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32): four
//    warps, each a 32 x 32 quarter of the block tile as 2 x 4 mma tiles;
//  * each 64-byte K step stages both operands' 64 x 64 byte tiles in
//    shared memory with 16-byte loads (byte loads, zero-filled, at a
//    ragged edge or when K is not a multiple of 16); rows are padded to
//    80 bytes, so the fragment loads of a warp hit 32 distinct banks;
//  * rows past M, columns past N and depth past K load as zeros and
//    are never stored, so every M, N, K >= 1 runs.
// Not yet done (a later change): wgmma and TMA, a multi-stage cp.async
// pipeline, split-K for the short, wide serving shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;                 // bytes of K per stage
constexpr int kLd = kBK + 16;           // padded shared-memory row
constexpr int kThreads = 128;           // four warps

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + 64) x bytes [k0, k0 + 64) of a [rows, K]
// int8 matrix into smem (64 rows of kLd bytes), zero past the edges.
// 128 threads x two 16-byte chunks each.
__device__ __forceinline__ void load_tile(int8_t* smem,
                                          const int8_t* __restrict__ g,
                                          int rows, int k, int row0, int k0,
                                          bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2;
    const int col = (c & 3) * 16;
    const int gr = row0 + r;
    const int gk = k0 + col;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && gk < k) {
      const int8_t* src = g + static_cast<int64_t>(gr) * k + gk;
      if (vec && gk + 16 <= k) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned word = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = gk + q * 4 + e;
            const unsigned byte =
                kk < k ? static_cast<unsigned>(
                             static_cast<uint8_t>(src[q * 4 + e]))
                       : 0u;
            word |= byte << (8 * e);
          }
          w[q] = word;
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(smem + r * kLd + col) = v;
  }
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int m, int n, int k, bool vec) {
  __shared__ __align__(16) int8_t as[kBM * kLd];
  __shared__ __align__(16) int8_t bs[kBN * kLd];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // mma groupID
  const int t = lane & 3;           // mma threadID_in_group
  const int wm = (warp >> 1) * 32;  // the warp's quarter of the tile
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous stage's fragments are read
    load_tile(as, xq, m, k, m0, k0, vec);
    load_tile(bs, wq, n, k, n0, k0, vec);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = as + (wm + i * 16 + g) * kLd + ks + t * 4;
        const int8_t* r8 = r0 + 8 * kLd;
        a[i][0] = lds32(r0);
        a[i][1] = lds32(r8);
        a[i][2] = lds32(r0 + 16);
        a[i][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = bs + (wn + j * 8 + g) * kLd + ks + t * 4;
        const unsigned b[2] = {lds32(c0), lds32(c0 + 16)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
  }

  // accumulator fragment: e = 0, 1 at row g, columns 2t, 2t + 1;
  // e = 2, 3 at row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + i * 16 + g + half * 8;
      if (row >= m) continue;
      const float xr = xs[row];
      float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + t * 2 + e;
          if (col < n) {
            const float v = __int2float_rn(acc[i][j][half * 2 + e]);
            orow[col] = __fmul_rn(__fmul_rn(v, xr), ws[col]);
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; x_q [m, k], w_q [n, k] and out [m, n] are contiguous
// row-major, x_scale [m] and w_scale [n] contiguous float32. Returns
// the launch's cudaError_t (0 = launched).
extern "C" int bigdl_int8_gemm(const void* x_q, const void* w_q,
                               const float* x_scale, const float* w_scale,
                               float* out, int m, int n, int k, int device,
                               void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = k % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x_q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
      x_scale, w_scale, out, m, n, k, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
