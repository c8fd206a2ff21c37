// CPU emulation of the CUDA subset that csrc/*.cu use, for testing their
// logic where there is no GPU and no nvcc
// (tests/test_torch_kernel_emulation_*.py).
//
// A source is rewritten for g++ (cuda_runtime.h -> this header, dynamic
// shared memory -> g_smem, `k<<<grid, block, smem, stream>>>(args)` ->
// emu_launch) and run with one std::thread per CUDA thread:
// __syncthreads is a barrier over the block, __syncwarp one over the warp,
// __shfl_xor_sync exchanges through a per-warp buffer between two per-warp
// barriers. Lanes run as independent threads, as the CUDA memory model
// allows, so a missing __syncwarp shows as a race. Blocks run one
// after another; each starts with its shared memory filled with NaN, so a
// read of shared memory that the block never wrote shows in the results.
// It checks indexing, masking and barrier placement, not speed, and it
// does not model warp-synchronous execution.
//
// The PTX wrappers of csrc/fused_klist.cu, csrc/fused_dual.cu and
// csrc/fused_dense.cu (mma_tf32, mma_bf16, cp_async16, cp_async_commit,
// cp_async_wait<N>, prefetch_l2; compiled there only without NN_CUDA_EMU)
// are replaced here: mma.sync m16n8k8 tf32 and m16n8k16 bf16 with the PTX
// ISA's fragment layouts, each lane depositing its fragments in a per-warp
// buffer between two warp barriers and computing its four outputs from
// the whole warp's (fp32 sums over k in order); cp.async as a plain
// 16-byte copy, its commit and wait as nothing; an L2 prefetch as nothing;
// __expf and __fdividef exactly.
#pragma once
#define NN_CUDA_EMU 1
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

using std::min;

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
inline std::barrier<>* g_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_barriers;
inline float g_shfl[32][32];
inline float* g_smem = nullptr;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)

// the 16-byte vector type of vector_types.h
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kEmuMaxDynamicSmem = 232448;  // H100: 227 KB per block

template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return bytes > kEmuMaxDynamicSmem ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  g_shfl[warp][lane] = v;
  g_warp_barriers[warp]->arrive_and_wait();
  const float out = g_shfl[warp][lane ^ lane_mask];
  g_warp_barriers[warp]->arrive_and_wait();
  return out;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// the fast intrinsics, exactly
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}

inline unsigned g_mma_a[32][32][4];
inline unsigned g_mma_b[32][32][2];

// d += A B for the warp's 16x8 tile: A 16x8 row-major (a0 (g, t), a1
// (g+8, t), a2 (g, t+4), a3 (g+8, t+4)), B 8x8 column-major (b0 (k=t,
// n=g), b1 (k=t+4, n=g)), D (d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3
// (g+8, 2t+1)), g = lane / 4, t = lane % 4; operands as tf32 (the low 13
// bits ignored).
inline void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                     const unsigned (&b)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < 4; ++r) g_mma_a[warp][lane][r] = a[r];
  g_mma_b[warp][lane][0] = b[0];
  g_mma_b[warp][lane][1] = b[1];
  g_warp_barriers[warp]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int o = 0; o < 4; ++o) {
    const int row = g + (o >= 2 ? 8 : 0), col = 2 * t + (o & 1);
    float s = d[o];
    for (int k = 0; k < 8; ++k) {
      const unsigned av = g_mma_a[warp][(row & 7) * 4 + (k & 3)]
                                 [(row >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)];
      const unsigned bv = g_mma_b[warp][col * 4 + (k & 3)][k >= 4 ? 1 : 0];
      s = std::fma(__uint_as_float(av & 0xffffe000u),
                   __uint_as_float(bv & 0xffffe000u), s);
    }
    d[o] = s;
  }
  g_warp_barriers[warp]->arrive_and_wait();
}

// d += A B for the warp's 16x8 tile, bf16 operands packed two to a
// register, the lower k (or column) in the low half: A 16x16 row-major
// (a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9), a3 (g+8,
// 2t+8..2t+9)), B 16x8 column-major (b0 (k=2t..2t+1, n=g), b1 (k=2t+8..
// 2t+9, n=g)), D as mma_tf32's.
inline float emu_bf16_half(unsigned v, int hi) {
  return __uint_as_float(hi ? (v & 0xffff0000u) : (v << 16));
}
inline void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                     const unsigned (&b)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < 4; ++r) g_mma_a[warp][lane][r] = a[r];
  g_mma_b[warp][lane][0] = b[0];
  g_mma_b[warp][lane][1] = b[1];
  g_warp_barriers[warp]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int o = 0; o < 4; ++o) {
    const int row = g + (o >= 2 ? 8 : 0), col = 2 * t + (o & 1);
    float s = d[o];
    for (int k = 0; k < 16; ++k) {
      const int kt = (k & 7) >> 1, half = k & 1, upper = k >= 8;
      const unsigned av = g_mma_a[warp][(row & 7) * 4 + kt]
                                 [(row >= 8 ? 1 : 0) + (upper ? 2 : 0)];
      const unsigned bv = g_mma_b[warp][col * 4 + kt][upper];
      s = std::fma(emu_bf16_half(av, half), emu_bf16_half(bv, half), s);
    }
    d[o] = s;
  }
  g_warp_barriers[warp]->arrive_and_wait();
}

inline void cp_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void prefetch_l2(const void*) {}

// bf16 as cuda_bf16.h gives it: round to nearest even, NaN kept quiet.
struct __nv_bfloat16 {
  unsigned short x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned u = (unsigned)h.x << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline void emu_launch(unsigned grid, unsigned block, size_t smem_bytes,
                       const std::function<void()>& body) {
  blockDim.x = block;
  gridDim.x = grid;
  std::vector<float> smem(smem_bytes / sizeof(float) + 1);
  for (unsigned b = 0; b < grid; ++b) {
    std::fill(smem.begin(), smem.end(), std::nanf(""));
    g_smem = smem.data();
    std::barrier<> bar(block);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      g_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
