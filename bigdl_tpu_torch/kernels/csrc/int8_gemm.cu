// Fused dequant int8 GEMM for Hopper (sm_90a):
//   out[m, n] = float(sum_k x_q[m, k] * w_q[n, k]) * x_scale[m] * w_scale[n]
// with x_q [M, K] and w_q [N, K] int8 (both row-major, K contiguous),
// per-row x_scale [M] and per-channel w_scale [N] float32, out [M, N]
// float32.
//
// Replaces bigdl_tpu/kernels/int8_gemm.py:_qmm_kernel (the Pallas TPU
// kernel, launched by pallas_quantized_matmul there): int8 products
// with int32 accumulation, and the float32 dequant epilogue fused so
// the int32 accumulator never goes to device memory (except as split-K
// partial sums, below). The TPU kernel walks K as a sequential grid
// axis with the accumulator in VMEM scratch; here a thread block owns
// an output tile and walks its share of K itself, with the accumulator
// in registers.
//
// Bitwise contract (docs/kernels.md "Equivalence contract"): integer
// accumulation is exact in any order (the split-K partial sums too),
// and the epilogue is __int2float_rn(acc) * x_scale[m] * w_scale[n],
// left to right, each product rounded on its own (__fmul_rn: nvcc may
// not reassociate or contract it), which is what the plain version's
// two tensor multiplies do; it runs once per output element. The bias
// add stays outside, in the dispatch layer's one add, as in the JAX
// package. Exact while |sum| < 2**31, i.e. K <= 133,144 for values in
// [-127, 127].
//
// Bound on this card: at the serving shape (ResNet-50's classifier,
// M <= 64, N = 1000, K = 2048) device-memory bytes, ~2.4 MB, about
// 0.7 us at 3.35 TB/s; what a call really waits on there is latency —
// a DRAM round trip per pipeline fill and two launches. At large
// square shapes the int8 tensor-core rate bounds it (1,979 TOP/s dense
// on an H100 SXM through wgmma; mma.sync, used here, reaches a part of
// that): 4096^3 about 70 us.
//
// Design:
//  * tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32); fragments
//    come from shared memory by ldmatrix.x4 (an 8 x 16-byte block of
//    byte rows is the b16 8 x 8 matrix ldmatrix moves, and lane 4g + t
//    receives bytes 4t .. 4t + 3 of row g: the s8 A and B fragment
//    layouts);
//  * a ring of stages of K in shared memory, filled by cp.async 16-byte
//    copies (zero-filled past M, N or K) with all but one stage in
//    flight while the tensor cores work on the oldest; one __syncthreads
//    a stage. Rows are padded by 16 bytes, so the eight 16-byte rows an
//    ldmatrix phase reads fall in eight distinct bank groups;
//  * two block tiles (Tile): where M > 64, 128 x 256 of eight warps of
//    64 x 64 (32 MMAs per k32 step a warp from 8 ldmatrix), three stages
//    of 128 bytes of K — on an H100 at 4096^3 faster than 128 x 128 of
//    four warps or 64-byte stages (PERF.md); and 64 x 64 of four warps
//    of 32 x 32, four stages of 64 bytes, for the short rows of a
//    serving batch;
//  * split-K where the output tiles alone would not give every SM a
//    block (the classifier has 16 tiles for 132 SMs): the wrapper picks
//    the split (gemm_plan in kernels/int8_gemm.py), grid.z blocks each
//    sum a run of whole stages of K, write their int32 partial tile
//    to a scratch array the wrapper allocates for the call, and a second
//    kernel adds the partials in split order and runs the epilogue —
//    exact, and the same bits as one block summing all of K;
//  * K not a multiple of 16, or operands not 16-byte aligned: the same
//    ring filled by byte loads (zeros past K) instead of cp.async;
//  * rows past M, columns past N and depth past K stage as zeros and
//    are never stored, so every M, N, K >= 1 runs.
// Not done: wgmma and TMA (the card's full int8 rate), a persistent
// grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 256;

// A block tile: BM x BN outputs, WM x WN warps, BK bytes of K a stage,
// a ring of STAGES stages; rows padded by 16 bytes (LD).
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_,
                       STAGES = STAGES_;
  static constexpr int LD = BK + 16;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * (BM + BN) * LD;
};
using SmallTile = Tile<64, 64, 2, 2, 64, 4>;    // M <= 64
using LargeTile = Tile<128, 256, 2, 4, 128, 3>;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 16-byte blocks of shared memory in one instruction: lane
// 8j + r gives the address of row r of block j, and lane 4g + t gets
// x[j] = bytes 4t .. 4t + 3 of row g of block j.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&x)[4],
                                            const int8_t* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
}

// 16 bytes from device memory to shared memory, or 16 zeros when !in
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
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

// Stage rows [row0, row0 + ROWS) x bytes [k0, k0 + C::BK) of a
// [rows, K] int8 matrix into ROWS rows of C::LD bytes, zeros past the
// edges: cp.async 16-byte copies when vec (K a multiple of 16, aligned
// rows), else byte loads.
template <int ROWS, class C>
__device__ __forceinline__ void stage(int8_t* smem,
                                      const int8_t* __restrict__ g,
                                      int rows, int k, int row0, int k0,
                                      bool vec) {
  constexpr int kChunks = C::BK / 16;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % C::THREADS == 0, "chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / C::THREADS; ++i) {
    const int c = threadIdx.x + i * C::THREADS;
    const int r = c / kChunks;
    const int col = c % kChunks * 16;
    const int gr = row0 + r;
    const int gk = k0 + col;
    const bool in = gr < rows && gk < k;
    const int8_t* src = g + (in ? static_cast<int64_t>(gr) * k + gk : 0);
    int8_t* dst = smem + r * C::LD + col;
    if (vec) {
      cp_async16(dst, src, in);
      continue;
    }
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned word = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = gk + q * 4 + e;
        const unsigned byte =
            in && kk < k ? static_cast<unsigned>(
                               static_cast<uint8_t>(src[q * 4 + e]))
                         : 0u;
        word |= byte << (8 * e);
      }
      w[q] = word;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The dequant epilogue of one element, in the plain version's order.
__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// grid (N tiles, M tiles, splits) of C tiles. Block z sums K steps
// [z * steps, (z + 1) * steps) of C::BK bytes. With one split it writes
// the dequant output; with more, its int32 partial tile to partials[z]
// ([M, N]).
template <class C>
__global__ void __launch_bounds__(C::THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int* __restrict__ partials, int m, int n, int k,
                     int steps, bool vec) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, LD = C::LD,
                STAGES = C::STAGES;
  constexpr int TM = BM / C::WM;  // a warp's rows and columns
  constexpr int TN = BN / C::WN;
  constexpr int MI = TM / 16;
  constexpr int NI = TN / 8;
  extern __shared__ __align__(16) int8_t gemm_smem[];
  int8_t* as = gemm_smem;                      // [STAGES][BM][LD]
  int8_t* bs = gemm_smem + STAGES * BM * LD;   // [STAGES][BN][LD]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // mma groupID
  const int t = lane & 3;            // mma threadID_in_group
  const int wm = warp / C::WN * TM;  // the warp's part of the tile
  const int wn = warp % C::WN * TN;
  const int j = lane >> 3;           // ldmatrix: the block whose row
  const int r8 = lane & 7;           // this lane addresses

  const int total = (k + BK - 1) / BK;
  const int first = blockIdx.z * steps;
  const int count = min(steps, total - first);

  auto load = [&](int step, int slot) {
    const int k0 = (first + step) * BK;
    stage<BM, C>(as + slot * BM * LD, xq, m, k, m0, k0, vec);
    stage<BN, C>(bs + slot * BN * LD, wq, n, k, n0, k0, vec);
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int jn = 0; jn < NI; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;

  // STAGES - 1 stages in flight; a group is committed every step, empty
  // or not, so wait<STAGES - 2> always means "the oldest has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it is here; stage it - 1's reads are done
    const int next = it + STAGES - 1;
    if (next < count) load(next, next % STAGES);
    cp_async_commit();
    const int8_t* at = as + (it % STAGES) * BM * LD;
    const int8_t* bt = bs + (it % STAGES) * BN * LD;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[MI][4];
      unsigned b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], at + (wm + 16 * i + r8 + 8 * (j & 1)) * LD + ks +
                              16 * (j >> 1));
#pragma unroll
      for (int jn = 0; jn < NI; jn += 2) {
        unsigned x[4];
        ldmatrix_x4(x, bt + (wn + 8 * jn + r8 + 8 * (j >> 1)) * LD + ks +
                           16 * (j & 1));
        b[jn][0] = x[0];
        b[jn][1] = x[1];
        b[jn + 1][0] = x[2];
        b[jn + 1][1] = x[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_s8(acc[i][jn], a[i], b[jn]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: e = 0, 1 at row g, columns 2t, 2t + 1;
  // e = 2, 3 at row g + 8
  const bool pairs = n % 2 == 0;  // 8-byte aligned column pairs
  int* part = partials == nullptr
                  ? nullptr
                  : partials + static_cast<int64_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * i + g + 8 * half;
      if (row >= m) continue;
      const int64_t base = static_cast<int64_t>(row) * n;
      const float xr = part == nullptr ? xs[row] : 0.f;
#pragma unroll
      for (int jn = 0; jn < NI; ++jn) {
        const int col = n0 + wn + 8 * jn + 2 * t;
        const int v0 = acc[i][jn][2 * half];
        const int v1 = acc[i][jn][2 * half + 1];
        if (part != nullptr) {
          if (pairs && col + 1 < n) {
            *reinterpret_cast<int2*>(part + base + col) = make_int2(v0, v1);
          } else {
            if (col < n) part[base + col] = v0;
            if (col + 1 < n) part[base + col + 1] = v1;
          }
        } else if (pairs && col + 1 < n) {
          *reinterpret_cast<float2*>(out + base + col) =
              make_float2(dequant(v0, xr, ws[col]),
                          dequant(v1, xr, ws[col + 1]));
        } else {
          if (col < n) out[base + col] = dequant(v0, xr, ws[col]);
          if (col + 1 < n) out[base + col + 1] = dequant(v1, xr, ws[col + 1]);
        }
      }
    }
  }
}

// out[i] = the epilogue of sum_z partials[z][i], z in order.
__global__ void __launch_bounds__(kReduceThreads)
    int8_splitk_reduce_kernel(const int* __restrict__ partials,
                              const float* __restrict__ xs,
                              const float* __restrict__ ws,
                              float* __restrict__ out, int m, int n,
                              int splits) {
  const int64_t size = static_cast<int64_t>(m) * n;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads +
                   threadIdx.x;
       i < size; i += static_cast<int64_t>(gridDim.x) * kReduceThreads) {
    int acc = 0;
    for (int z = 0; z < splits; ++z) acc += partials[z * size + i];
    out[i] = dequant(acc, xs[i / n], ws[i % n]);
  }
}

// Launch the GEMM (and, split, the reduce) of C tiles; splits must leave
// every run of K steps non-empty.
template <class C>
cudaError_t launch_gemm(const int8_t* xq, const int8_t* wq, const float* xs,
                        const float* ws, float* out, int* partials, int m,
                        int n, int k, int splits, bool vec,
                        cudaStream_t stream) {
  const int total = (k + C::BK - 1) / C::BK;
  const int steps = (total + splits - 1) / splits;
  if ((m + C::BM - 1) / C::BM > 65535 || (splits - 1) * steps >= total)
    return cudaErrorInvalidValue;
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, splits);
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  int8_gemm_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      xq, wq, xs, ws, out, splits > 1 ? partials : nullptr, m, n, k, steps,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t size = static_cast<int64_t>(m) * n;
  const int64_t want = (size + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  int8_splitk_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      partials, xs, ws, out, m, n, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device
// pointer; x_q [m, k], w_q [n, k] and out [m, n] are contiguous
// row-major, x_scale [m] and w_scale [n] contiguous float32. tile 64
// runs SmallTile, tile 128 LargeTile. splits > 1 splits K into that
// many runs of whole steps of the tile's BK bytes (every run non-empty:
// each run ceil(ceil(k / BK) / splits) steps long), with partials an
// int32 scratch array of splits * m * n elements; with splits == 1
// partials is not read. Returns the first launch's cudaError_t that is
// not cudaSuccess (0 = launched).
extern "C" int bigdl_int8_gemm(const void* x_q, const void* w_q,
                               const float* x_scale, const float* w_scale,
                               float* out, void* partials, int m, int n,
                               int k, int tile, int splits, int device,
                               void* stream) {
  if (m < 1 || n < 1 || k < 1 || (tile != 64 && tile != 128) ||
      splits < 1 || splits > 65535 || (splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = k % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x_q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  const auto* xq = static_cast<const int8_t*>(x_q);
  const auto* wq = static_cast<const int8_t*>(w_q);
  auto* part = static_cast<int*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = tile == 64 ? launch_gemm<SmallTile>(xq, wq, x_scale, w_scale, out,
                                            part, m, n, k, splits, vec, st)
                   : launch_gemm<LargeTile>(xq, wq, x_scale, w_scale, out,
                                            part, m, n, k, splits, vec, st);
  return static_cast<int>(err);
}

extern "C" const char* bigdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
