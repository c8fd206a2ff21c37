// CPU emulation of the CUDA subset that csrc/*.cu use, for testing their
// logic where there is no GPU and no nvcc
// (tests/test_torch_kernel_emulation_*.py).
//
// A source is rewritten for g++ (cuda_runtime.h -> this header, dynamic
// shared memory -> g_smem, `k<<<grid, block, smem, stream>>>(args)` ->
// emu_launch) and run with one fiber per CUDA thread on the launching
// thread (each on a stack of its own, switched by emu_ctx_switch: the
// callee-saved registers and the stack pointer, no system call):
// __syncthreads is a barrier over the block, __syncwarp one over the
// warp, __shfl_xor_sync exchanges through a per-warp buffer between two
// per-warp barriers. A fiber runs from one barrier to the next. The
// scheduler always resumes the runnable fiber first in an order of the
// block's threads (the warps in a random order, each warp's lanes in a
// random order), drawn anew at each barrier of the block from a generator
// seeded by the launch itself (its kernel's name, grid, block and shared
// memory bytes: the same orders in every run, whatever ran before in the
// process): the first warp runs
// as far as the block's next barrier before the second starts, so a read
// that a missing barrier lets run before its write, or a write before
// another warp's read, shows in the results, in either direction across
// the phases. Lanes run independently, as the CUDA memory model allows,
// so a missing __syncwarp shows the same way. A barrier costs each fiber
// one switch, where a thread per CUDA thread cost the machine's scheduler
// a wake-up of every waiter, so the emulation's time does not follow the
// machine's load. A block whose fibers all wait on barriers that cannot
// complete (a barrier some threads skip) aborts with a message, and so
// does a launch that runs past kEmuLaunchSeconds (a fiber that never
// reaches its next barrier, as a mutant's out-of-range writes can make
// it), checked by a watchdog thread. Blocks
// run one after another; each starts with its shared memory filled with
// NaN, so a read of shared memory that the block never wrote shows in the
// results. It checks indexing, masking and barrier placement, not speed,
// and it does not model warp-synchronous execution.
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
#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <random>
#include <string_view>
#include <thread>
#include <vector>

using std::min;

struct emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
// the running fiber's indices: the scheduler sets them before each resume
inline emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;

// emu_ctx_switch(&from_sp, to_sp): save the callee-saved registers on the
// current stack and its pointer in from_sp, then resume the stack to_sp
// saved the same way (or prepared by emu_fiber_stack).
#if !defined(__x86_64__)
#error "the CUDA emulation's fibers switch x86-64 stacks"
#endif
extern "C" void emu_ctx_switch(void** from_sp, void* to_sp);
asm(R"(
  .text
  .p2align 4
  .hidden emu_ctx_switch
  .type emu_ctx_switch, @function
emu_ctx_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_ctx_switch, .-emu_ctx_switch
)");

struct emu_fiber {
  void* sp = nullptr;
  char* stack = nullptr;  // kEmuFiberStack bytes, the lowest page a guard
  bool done = false;
  const void* waiting = nullptr;  // the barrier it waits on, if any
};
constexpr std::size_t kEmuFiberStack = 256 * 1024;
inline std::vector<emu_fiber> g_fibers;
inline void* g_sched_sp = nullptr;
inline unsigned g_cur = 0;
inline const std::function<void()>* g_body = nullptr;

// The watchdog: a thread that aborts the process when the running launch
// is past its deadline (steady-clock seconds; 0 while none runs).
constexpr long long kEmuLaunchSeconds = 120;
inline std::atomic<long long> g_deadline{0};
inline long long emu_now_s() {
  return std::chrono::duration_cast<std::chrono::seconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline void emu_watchdog_start() {
  static std::once_flag once;
  std::call_once(once, [] {
    std::thread([] {
      for (;;) {
        std::this_thread::sleep_for(std::chrono::seconds(1));
        const long long d = g_deadline.load();
        if (d && emu_now_s() > d) {
          std::fprintf(stderr,
                       "cuda_emu: a launch ran past %lld s (a fiber that "
                       "never reaches its next barrier)\n",
                       kEmuLaunchSeconds);
          std::abort();
        }
      }
    }).detach();
  });
}

// The seed of a launch's orders: FNV-1a over its kernel's name, then its
// grid, block and shared memory bytes.
inline std::uint32_t emu_seed(std::string_view name, unsigned grid,
                              unsigned block, std::size_t smem_bytes) {
  std::uint64_t h = 0xcbf29ce484222325ull;
  auto mix = [&](std::uint64_t v) {
    h ^= v;
    h *= 0x100000001b3ull;
  };
  for (char c : name) mix((unsigned char)c);
  mix(grid);
  mix(block);
  mix(smem_bytes);
  return (std::uint32_t)(h ^ (h >> 32));
}

// back to the scheduler
inline void emu_yield() { emu_ctx_switch(&g_fibers[g_cur].sp, g_sched_sp); }

// The scheduler's order (emu_launch): the fibers in order of priority,
// each fiber's place in it, the first place a barrier just released, and
// whether the block's barrier did (which draws a new order).
inline std::vector<unsigned> g_by_prio, g_prio_pos;
inline unsigned g_released = ~0u;
inline bool g_phase_done = false;

class emu_barrier {
 public:
  explicit emu_barrier(unsigned n, bool block = false)
      : n_(n), block_(block) {}
  void arrive_and_wait() {
    if (++arrived_ == n_) {
      arrived_ = 0;
      for (unsigned t = 0; t < g_by_prio.size(); ++t)
        if (g_fibers[t].waiting == this) {
          g_fibers[t].waiting = nullptr;
          g_released = std::min(g_released, g_prio_pos[t]);
        }
      g_phase_done = g_phase_done || block_;
    } else {
      g_fibers[g_cur].waiting = this;
    }
    // every fiber yields at a barrier, the last one too: the scheduler
    // picks who runs first past it
    emu_yield();
  }

 private:
  const unsigned n_;
  const bool block_;
  unsigned arrived_ = 0;
};
inline emu_barrier* g_block_barrier = nullptr;
inline std::vector<std::unique_ptr<emu_barrier>> g_warp_barriers;

[[noreturn]] inline void emu_fiber_main() {
  (*g_body)();
  g_fibers[g_cur].done = true;
  emu_yield();  // never resumed
  std::abort();
}

// A fiber's stack, mapped once per fiber and kept: an overflow runs into
// the guard page at its bottom and faults, rather than writing past it.
inline char* emu_fiber_map() {
  void* p = mmap(nullptr, kEmuFiberStack, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED || mprotect(p, 4096, PROT_NONE) != 0) {
    std::fprintf(stderr, "cuda_emu: cannot map a fiber stack\n");
    std::abort();
  }
  return static_cast<char*>(p);
}

// A new fiber's stack: emu_ctx_switch's six saved registers (zero) under
// the address of emu_fiber_main, entered by its `ret` with the stack
// aligned as after a call.
inline void* emu_fiber_stack(char* base) {
  auto top = reinterpret_cast<std::uintptr_t>(base + kEmuFiberStack) &
             ~std::uintptr_t(15);
  auto* sp = reinterpret_cast<void**>(top);
  *--sp = nullptr;  // emu_fiber_main's return address: never used
  *--sp = reinterpret_cast<void*>(&emu_fiber_main);
  for (int r = 0; r < 6; ++r) *--sp = nullptr;
  return sp;
}
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

inline void emu_launch(const char* name, unsigned grid, unsigned block,
                       size_t smem_bytes, const std::function<void()>& body) {
  blockDim.x = block;
  gridDim.x = grid;
  g_body = &body;
  std::vector<float> smem(smem_bytes / sizeof(float) + 1);
  if (g_fibers.size() < block) g_fibers.resize(block);
  std::mt19937 rng(emu_seed(name, grid, block, smem_bytes));
  emu_watchdog_start();
  g_deadline.store(emu_now_s() + kEmuLaunchSeconds);
  const unsigned warps = (block + 31) / 32;
  std::vector<unsigned> warp_order(warps), lane_order(32);
  // a new order: the warps in a random order, and within each warp its
  // lanes in a random order
  auto draw = [&] {
    for (unsigned w = 0; w < warps; ++w) warp_order[w] = w;
    std::shuffle(warp_order.begin(), warp_order.end(), rng);
    g_by_prio.clear();
    for (unsigned w : warp_order) {
      for (unsigned l = 0; l < 32; ++l) lane_order[l] = l;
      std::shuffle(lane_order.begin(), lane_order.end(), rng);
      for (unsigned l : lane_order)
        if (w * 32 + l < block) g_by_prio.push_back(w * 32 + l);
    }
    for (unsigned i = 0; i < block; ++i) g_prio_pos[g_by_prio[i]] = i;
  };
  g_prio_pos.assign(block, 0);
  for (unsigned b = 0; b < grid; ++b) {
    std::fill(smem.begin(), smem.end(), std::nanf(""));
    g_smem = smem.data();
    emu_barrier bar(block, true);
    g_block_barrier = &bar;
    g_warp_barriers.clear();
    for (unsigned w = 0; w < (block + 31) / 32; ++w)
      g_warp_barriers.push_back(std::make_unique<emu_barrier>(32));
    for (unsigned t = 0; t < block; ++t) {
      emu_fiber& f = g_fibers[t];
      if (!f.stack) f.stack = emu_fiber_map();
      f.sp = emu_fiber_stack(f.stack);
      f.done = false;
      f.waiting = nullptr;
    }
    // Always resume the runnable fiber first in the order: the first warp
    // runs as far as the block's next barrier before the second starts, so
    // a warp that a missing barrier lets run ahead of another (a write
    // before the other's read, or the reverse) does so. The order is drawn
    // anew at each of the block's barriers, so either warp of a pair leads
    // in some phase.
    draw();
    for (unsigned left = block, pos = 0; left;) {
      if (pos == block) {
        std::fprintf(stderr,
                     "cuda_emu: block %u of %u threads: %u threads wait on "
                     "barriers the others never reach\n",
                     b, block, left);
        std::abort();
      }
      const unsigned t = g_by_prio[pos];
      if (g_fibers[t].done || g_fibers[t].waiting) {
        ++pos;
        continue;
      }
      g_cur = t;
      threadIdx.x = t;
      blockIdx.x = b;
      emu_ctx_switch(&g_sched_sp, g_fibers[t].sp);
      if (g_fibers[t].done) --left;
      if (g_phase_done) {
        g_phase_done = false;
        g_released = ~0u;
        draw();
        pos = 0;
      } else if (g_released < pos) {
        pos = g_released;
      }
      g_released = ~0u;
    }
  }
  g_deadline.store(0);
}
