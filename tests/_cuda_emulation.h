// A CPU stand-in for the CUDA features the port's flash-attention and
// int8 GEMM kernels use, so their sources compile with g++ and run on
// the CPU (tests/test_torch_flash_emulated.py,
// tests/test_torch_int8_emulated.py). Each CUDA thread of a block is a
// fiber (ucontext) on one OS thread, run round robin: a thread that
// waits at __syncthreads or at a warp collective yields to the next, so
// an emulation uses one core and runs the same way every time. Blocks
// run one after another, so an atomic is a plain add. mma.sync m16n8k8
// tf32, mma.sync m16n8k16 bf16 / f16 (float32 accumulators), mma.sync
// m16n8k32 s8, wgmma.mma_async m64nNk16 bf16 / f16 (operands in
// registers or read through shared-memory matrix descriptors, swizzles
// decoded), ldmatrix (plain and .trans) and the packing conversions
// cvt.rn.{bf16x2,f16x2}.f32 follow the PTX fragment layouts and
// definitions (written here from the PTX ISA, independently of the
// kernels); a tf32 operand's low 13 bits are dropped, as the tensor
// cores read it. cp.async copies at once (its ordering is the kernels'
// own barriers and waits, which this cannot check). The test rewrites
// the kernels' inline PTX, kernel launches and dynamic shared memory
// into the emu_* calls below; nothing here models timing or the
// hardware's float32 accumulation inside an MMA; a wgmma completes when
// it is issued, so its commit, wait and fences are no-ops here.
#pragma once

#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define CUDART_INF_F INFINITY

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx;  // the running fiber's
inline dim3 blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

using std::fmaf;
using std::isfinite;
using std::max;
using std::min;
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float exp2f(float x) { return std::exp2(x); }
inline float __uint_as_float(uint32_t x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  return x;
}
inline float* emu_smem;
inline size_t emu_smem_bytes;
// A pointer into the block's dynamic shared memory as its offset there
// (the shared window's address; anything else as the pointer itself).
inline size_t __cvta_generic_to_shared(const void* p) {
  const char* c = static_cast<const char*>(p);
  const char* base = reinterpret_cast<const char*>(emu_smem);
  if (base != nullptr && c >= base && c < base + emu_smem_bytes)
    return static_cast<size_t>(c - base);
  return reinterpret_cast<size_t>(p);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __int2float_rn(int x) { return static_cast<float>(x); }

struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct int2 {
  int x, y;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }

template <typename T>
T atomicAdd(T* address, T value) {
  const T old = *address;
  *address = old + value;
  return old;
}
enum { cudaMemcpyDefault = 4 };
template <typename T>
cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t bytes,
                                 size_t offset = 0, int = 0) {
  std::memcpy(dst, reinterpret_cast<const char*>(&symbol) + offset, bytes);
  return 0;
}
template <typename T>
cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t bytes,
                               size_t offset = 0, int = 0) {
  std::memcpy(reinterpret_cast<char*>(&symbol) + offset, src, bytes);
  return 0;
}

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float(uint32_t(b.x) << 16);
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // to nearest, ties even
  uint32_t u = __float_as_uint(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
struct __half {
  _Float16 x;
};
inline float __half2float(__half h) { return static_cast<float>(h.x); }
inline __half __ushort_as_half(unsigned short bits) {
  __half h;
  std::memcpy(&h, &bits, 2);
  return h;
}
inline __half __float2half(float f) { return {static_cast<_Float16>(f)}; }

constexpr int kEmuWarps = 32;
constexpr size_t kEmuStack = 256 << 10;

// The block's fibers: contexts, done flags, and the one running.
struct EmuBlock {
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  int running = 0, left = 0;
  ucontext_t host;
  std::function<void()> body;
};
inline EmuBlock emu_block;

// Switch to the next fiber that has not finished (round robin); when
// this one resumes, it is the running thread again.
inline void emu_yield() {
  EmuBlock& b = emu_block;
  const int self = b.running;
  int next = self;
  do next = (next + 1) % static_cast<int>(b.ctx.size());
  while (b.done[next]);
  if (next == self) return;
  b.running = next;
  swapcontext(&b.ctx[self], &b.ctx[next]);
  b.running = self;
  threadIdx = dim3(self);
}

struct EmuBarrier {
  int count = 0, arrived = 0, any = 0, result = 0;
  unsigned generation = 0;
  // returns whether any arriving thread's pred was nonzero
  int wait(int pred = 0) {
    const unsigned g = generation;
    any |= pred != 0;
    if (++arrived == count) {
      arrived = 0;
      result = any;
      any = 0;
      ++generation;
      return result;
    }
    while (generation == g) emu_yield();
    return result;
  }
};
inline EmuBarrier emu_block_barrier;
inline EmuBarrier emu_warp_barrier[kEmuWarps];
inline EmuBarrier emu_wg_barrier[kEmuWarps / 4];
// per-warp exchange slots, one per lane
inline float emu_shfl[kEmuWarps][32];
inline const char* emu_rows[kEmuWarps][32];
inline uint32_t emu_a[kEmuWarps][32][4], emu_b[kEmuWarps][32][2];
inline float emu_c[kEmuWarps][32][4];
inline int emu_ci[kEmuWarps][32][4];

inline int emu_pred[kEmuWarps][32];

inline void emu_warp_sync() { emu_warp_barrier[threadIdx.x / 32].wait(); }

// Every lane of the warp takes part (the kernels' only use).
inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_pred[w][l] = pred != 0;
  emu_warp_sync();
  unsigned mask = 0;
  for (int lane = 0; lane < 32; ++lane)
    mask |= static_cast<unsigned>(emu_pred[w][lane]) << lane;
  emu_warp_sync();
  return mask;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline void __syncthreads() { emu_block_barrier.wait(); }
inline int __syncthreads_or(int pred) {
  return emu_block_barrier.wait(pred);
}

inline float __shfl_xor_sync(unsigned, float x, int mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_shfl[w][l] = x;
  emu_warp_sync();
  const float r = emu_shfl[w][l ^ mask];
  emu_warp_sync();
  return r;
}

// ldmatrix.x4.b16: lane 8j + r holds the address of row r (16 bytes) of
// matrix j; lane i receives the 32-bit word i % 4 of row i / 4 of each
// matrix.
inline void emu_ldmatrix_x4(uint32_t (&x)[4], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_rows[w][l] = static_cast<const char*>(row);
  emu_warp_sync();
  for (int j = 0; j < 4; ++j)
    std::memcpy(&x[j], emu_rows[w][8 * j + l / 4] + 4 * (l % 4), 4);
  emu_warp_sync();
}

// ldmatrix.x4.trans.b16: the addresses as in emu_ldmatrix_x4; lane i
// receives, of each matrix, the 16-bit elements at (row 2 (i % 4),
// column i / 4) in the low half and (row 2 (i % 4) + 1, column i / 4) in
// the high half: row i / 4 of the transposed matrix.
inline void emu_ldmatrix_x4_trans(uint32_t (&x)[4], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_rows[w][l] = static_cast<const char*>(row);
  emu_warp_sync();
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    std::memcpy(&lo, emu_rows[w][8 * j + 2 * (l % 4)] + 2 * (l / 4), 2);
    std::memcpy(&hi, emu_rows[w][8 * j + 2 * (l % 4) + 1] + 2 * (l / 4), 2);
    x[j] = lo | static_cast<uint32_t>(hi) << 16;
  }
  emu_warp_sync();
}

// ex2.approx.ftz.f32: 2^x, with a subnormal input read as 0 and a
// subnormal result flushed to 0 (the approximation's own error, about
// 2^-22 relative, is the card's to show).
inline float emu_exp2_ftz(float x) {
  if (std::fpclassify(x) == FP_SUBNORMAL) x = 0.f;
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}

// The 16-bit value of type T in the low (half 0) or high (half 1) half
// of a register, as a float (exact).
template <typename T>
inline float emu_b16(uint32_t word, int half) {
  const uint16_t bits = static_cast<uint16_t>(word >> (16 * half));
  T v;
  std::memcpy(&v, &bits, 2);
  if constexpr (std::is_same<T, __half>::value)
    return __half2float(v);
  else
    return __bfloat162float(v);
}

// cvt.rn.{bf16x2,f16x2}.f32: lo and hi rounded to nearest even, hi in
// the high half.
template <typename T>
inline uint32_t emu_pack16(float lo, float hi) {
  T a, b;
  if constexpr (std::is_same<T, __half>::value) {
    a = __float2half(lo);
    b = __float2half(hi);
  } else {
    a = __float2bfloat16(lo);
    b = __float2bfloat16(hi);
  }
  uint16_t la, lb;
  std::memcpy(&la, &a, 2);
  std::memcpy(&lb, &b, 2);
  return la | static_cast<uint32_t>(lb) << 16;
}

// mma.sync.m16n8k16.row.col.f32.{bf16,f16}.{bf16,f16}.f32, c += a . b.
// Lane 4g + t holds A[g][2t + e] (a0), A[g + 8][2t + e] (a1),
// A[g][8 + 2t + e] (a2), A[g + 8][8 + 2t + e] (a3), B[2t + e][g] (b0),
// B[8 + 2t + e][g] (b1), e the register's half; C as in emu_mma. The
// products are exact in float32; they are summed in k order.
template <typename T>
inline void emu_mma16(float (&c)[4], const uint32_t (&a)[4],
                      const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) {
    emu_a[w][l][i] = a[i];
    emu_c[w][l][i] = c[i];
  }
  emu_b[w][l][0] = b[0];
  emu_b[w][l][1] = b[1];
  emu_warp_sync();
  float A[16][16], B[16][8], C[16][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane / 4, t = lane % 4;
    for (int i = 0; i < 4; ++i) {
      for (int e = 0; e < 2; ++e)
        A[g + 8 * (i & 1)][8 * (i >> 1) + 2 * t + e] =
            emu_b16<T>(emu_a[w][lane][i], e);
      C[g + 8 * (i >> 1)][2 * t + (i & 1)] = emu_c[w][lane][i];
    }
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 2; ++e)
        B[8 * i + 2 * t + e][g] = emu_b16<T>(emu_b[w][lane][i], e);
  }
  const int g = l / 4, t = l % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float acc = C[row][col];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    out[i] = acc;
  }
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}

// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, d += a . b, exact. Each
// register holds four int8 elements, the lowest index in the lowest
// byte. Lane 4g + t holds A[g][4t + e] (a0), A[g + 8][4t + e] (a1),
// A[g][16 + 4t + e] (a2), A[g + 8][16 + 4t + e] (a3); B[4t + e][g] (b0),
// B[16 + 4t + e][g] (b1); D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1].
inline void emu_mma_s8(int (&d)[4], const unsigned (&a)[4],
                       const unsigned (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) {
    emu_a[w][l][i] = a[i];
    emu_ci[w][l][i] = d[i];
  }
  emu_b[w][l][0] = b[0];
  emu_b[w][l][1] = b[1];
  emu_warp_sync();
  int A[16][32], B[32][8], D[16][8];
  auto byte = [](uint32_t word, int e) {
    return static_cast<int>(static_cast<int8_t>(word >> (8 * e)));
  };
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane / 4, t = lane % 4;
    for (int i = 0; i < 4; ++i) {
      for (int e = 0; e < 4; ++e)
        A[g + 8 * (i & 1)][16 * (i >> 1) + 4 * t + e] =
            byte(emu_a[w][lane][i], e);
      D[g + 8 * (i >> 1)][2 * t + (i & 1)] = emu_ci[w][lane][i];
    }
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 4; ++e)
        B[16 * i + 4 * t + e][g] = byte(emu_b[w][lane][i], e);
  }
  const int g = l / 4, t = l % 4;
  int out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    int acc = D[row][col];
    for (int k = 0; k < 32; ++k) acc += A[row][k] * B[k][col];
    out[i] = acc;
  }
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, c += a . b. Lane 4g + t
// holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; B[t][g],
// B[t + 4][g]; C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
inline void emu_mma(float (&c)[4], const uint32_t (&a)[4],
                    const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) {
    emu_a[w][l][i] = a[i];
    emu_c[w][l][i] = c[i];
  }
  emu_b[w][l][0] = b[0];
  emu_b[w][l][1] = b[1];
  emu_warp_sync();
  float A[16][8], B[8][8], C[16][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane / 4, t = lane % 4;
    for (int i = 0; i < 4; ++i) {
      A[g + 8 * (i & 1)][t + 4 * (i >> 1)] =
          __uint_as_float(emu_a[w][lane][i] & 0xffffe000u);
      C[g + 8 * (i >> 1)][2 * t + (i & 1)] = emu_c[w][lane][i];
    }
    for (int i = 0; i < 2; ++i)
      B[t + 4 * i][g] = __uint_as_float(emu_b[w][lane][i] & 0xffffe000u);
  }
  const int g = l / 4, t = l % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float acc = C[row][col];
    for (int k = 0; k < 8; ++k) acc += A[row][k] * B[k][col];
    out[i] = acc;
  }
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}

// wgmma.mma_async.sync.aligned.m64nNk16.f32.{bf16,f16}: D (64 x N) = A
// (64 x 16) . B (16 x N), plus D when scale_d; the warpgroup's 128
// threads take part together. Thread (warp w, lane 4g + t) holds D[16w +
// g + 8 (i >> 1)][8j + 2t + (i & 1)] in d[4j + i]. A from registers
// holds rows 16w + g (a0, a2) and 16w + g + 8 (a1, a3), k = 2t + e (a0,
// a1) and 8 + 2t + e (a2, a3), e the register's half: the m16n8k16 A
// layout. An operand in shared memory is read through its matrix
// descriptor: bits 0-13 the start address >> 4, 16-29 the leading byte
// offset >> 4, 32-45 the stride byte offset >> 4, 62-63 the swizzle
// (1: 128 bytes, 2: 64, 3: 32; 0, none, is not emulated). With R the
// swizzle's bytes, element (mn, k) of a K-major operand (transpose 0:
// its k contiguous) sits at start + (mn / 8) SBO + (mn % 8) R + 2k; of
// an MN-major one (transpose 1) at start + (mn / (R / 2)) LBO + (k / 8)
// SBO + (k % 8) R + 2 (mn % (R / 2)); and the swizzle XORs address bits
// [4, 4 + log2(R / 16)) with bits [7, 7 + log2(R / 16)). The products
// are exact in float32 and summed in k order.
template <typename T>
inline float emu_wg_element(uint64_t desc, int mn, int k, int trans) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3fffu) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3fffu) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3fffu) << 4;
  const int mode = static_cast<int>(desc >> 62);
  if (mode == 0) std::abort();
  const uint32_t R = mode == 1 ? 128 : mode == 2 ? 64 : 32;
  uint32_t a = trans ? start + mn / (R / 2) * lbo + k / 8 * sbo + k % 8 * R +
                           2 * (mn % (R / 2))
                     : start + mn / 8 * sbo + mn % 8 * R + 2 * k;
  a ^= ((a >> 7) & (R / 16 - 1)) << 4;
  if (a + 2 > emu_smem_bytes) std::abort();
  uint16_t bits;
  std::memcpy(&bits, reinterpret_cast<const char*>(emu_smem) + a, 2);
  return emu_b16<T>(bits, 0);
}

inline uint32_t emu_wg_a[128][4];

template <typename T, int N>
inline void emu_wgmma_any(float (&d)[N / 2], const uint32_t* a_regs,
                          uint64_t desc_a, int trans_a, uint64_t desc_b,
                          int trans_b, int scale_d) {
  const int wg = threadIdx.x / 128, me = threadIdx.x % 128;
  if (a_regs != nullptr)
    for (int i = 0; i < 4; ++i) emu_wg_a[me][i] = a_regs[i];
  emu_wg_barrier[wg].wait();
  const int w = me / 32, g = me % 32 / 4, t = me % 4;
  float out[N / 2];
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + g + 8 * (i >> 1), col = 8 * j + 2 * t + (i & 1);
      float acc = scale_d ? d[4 * j + i] : 0.f;
      for (int k = 0; k < 16; ++k) {
        float av;
        if (a_regs != nullptr) {
          // the register of row `row`, column k: its warp, lane, index
          const int r = row % 16, lane = 4 * (r % 8) + k % 8 / 2;
          const int reg = r / 8 + 2 * (k / 8);
          av = emu_b16<T>(emu_wg_a[32 * (row / 16) + lane][reg], k % 2);
        } else {
          av = emu_wg_element<T>(desc_a, row, k, trans_a);
        }
        acc += av * emu_wg_element<T>(desc_b, col, k, trans_b);
      }
      out[4 * j + i] = acc;
    }
  emu_wg_barrier[wg].wait();
  for (int i = 0; i < N / 2; ++i) d[i] = out[i];
}

template <typename T, int N, int TransA, int TransB>
inline void emu_wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                         int scale_d) {
  emu_wgmma_any<T, N>(d, nullptr, desc_a, TransA, desc_b, TransB, scale_d);
}

template <typename T, int N, int TransB>
inline void emu_wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc_b, int scale_d) {
  emu_wgmma_any<T, N>(d, a, 0, 0, desc_b, TransB, scale_d);
}

inline void emu_copy(void* dst, const void* src, bool in, size_t bytes) {
  if (in)
    std::memcpy(dst, src, bytes);
  else
    std::memset(dst, 0, bytes);
}

inline void emu_fiber_entry() {
  EmuBlock& b = emu_block;
  threadIdx = dim3(b.running);
  b.body();
  b.done[b.running] = 1;
  if (--b.left == 0) setcontext(&b.host);
  int next = b.running;
  do next = (next + 1) % static_cast<int>(b.ctx.size());
  while (b.done[next]);
  b.running = next;
  threadIdx = dim3(next);
  setcontext(&b.ctx[next]);
}

// kernel<<<grid, threads, smem, stream>>>(args...): every block in turn,
// its threads as fibers, dynamic shared memory filled with NaN first so
// a read of anything not staged shows.
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                A... args) {
  std::vector<float> buf(smem / 4 + 64);
  std::vector<char> stacks(static_cast<size_t>(threads) * kEmuStack);
  EmuBlock& b = emu_block;
  gridDim = grid;
  blockDim = dim3(threads);
  b.body = [&] { kernel(args...); };
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
      std::fill(buf.begin(), buf.end(), std::nanf(""));
      emu_smem = buf.data();
      emu_smem_bytes = smem;
      emu_block_barrier = EmuBarrier{threads};
      for (int w = 0; w < (threads + 31) / 32; ++w)
        emu_warp_barrier[w] = EmuBarrier{std::min(32, threads - 32 * w)};
      for (int w = 0; w < (threads + 127) / 128; ++w)
        emu_wg_barrier[w] = EmuBarrier{std::min(128, threads - 128 * w)};
      b.ctx.assign(threads, ucontext_t{});
      b.done.assign(threads, 0);
      b.left = threads;
      for (int t = 0; t < threads; ++t) {
        getcontext(&b.ctx[t]);
        b.ctx[t].uc_stack.ss_sp = stacks.data() + t * kEmuStack;
        b.ctx[t].uc_stack.ss_size = kEmuStack;
        b.ctx[t].uc_link = nullptr;
        makecontext(&b.ctx[t], emu_fiber_entry, 0);
      }
      b.running = 0;
      threadIdx = dim3(0);
      swapcontext(&b.host, &b.ctx[0]);
    }
  emu_smem = nullptr;
}
