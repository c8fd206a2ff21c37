// Windowed neighbour gather and its transpose for Hopper (sm_90a).
//
// Replaces the TPU kernels of newtonnet_tpu/ops/pallas_window.py:
// _gather_kernel (K10) and _scatter_kernel (K11). Over a K-major list idx
// (B, K, N) of cell-sorted atoms, atom n's window is the W rows from
// start(n) = (T * (n / T) + T/2 - W/2) mod N on (circularly), and an edge
// (k, n) counts only where loc = (idx[b,k,n] - start(n)) mod N < W:
//
//   K10  out[b,k,n,:] = bf16(x[b, idx[b,k,n], :]) in x's type, 0 outside
//   K11  out[b,j,:]   = sum over in-window (k, n) with idx[b,k,n] == j of
//                       bf16(y[b,k,n,:]), summed in fp32, stored in y's type
//
// the exact transpose of each other (the TPU kernels' semantics: their
// one-hot matrix products round the payload to bf16 and accumulate in fp32).
// The one-hot product is how a TPU feeds a gather to its matrix unit; it is
// not carried over.
//
// What bounds them on this card: bytes. K10 writes B*K*N rows and reads
// as many from an N-row source that stays in L2; K11 reads B*K*N rows once
// and writes B*N, and moves its scratch of window rows (B*(N/T)*W*F fp32)
// once each way besides.
//
// K10: one thread per output vector (8 bf16 or 4 fp32 values where F
// allows, else one value), the window test per row, consecutive threads on
// consecutive vectors (coalesced stores and loads).
//
// K11, deterministic and without float atomics, in four steps:
//   window_sort_kernel: one block per (b, T-atom block i) sorts the block's
//     K*T edges by key (loc << 16 | e), e = k*T + t (bitonic sort in shared
//     memory; edges out of the window get key 0xffffffff and sort last), so
//     each window row's edges form one run, in edge order.
//   window_segment_kernel: one warp per segment of kSeg sorted positions,
//     lanes across features, sums each run piece of its segment in key
//     order (fp32): a piece that starts a run into dslab[b, i, w] (the
//     block's window rows, zeroed first), a piece that continues a run from
//     the segment before into head[b, i, segment]. A long run (masked slots
//     pointed at one atom give thousands of edges) is spread over many
//     warps this way.
//   window_join_kernel: the warp of the segment where a run starts adds the
//     heads of the following segments it runs into, in segment order.
//   window_overlap_kernel: one warp per output row (b, j) adds the window
//     rows of the blocks whose window holds j, in block order.
// The order of every sum is fixed, so a run repeats its bits.
// Limits (cudaErrorInvalidValue otherwise): N % T == 0, 0 < W <= N,
// W < 65536, and K*T <= 32768 (the sort's keys in 128 KB of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSortThreads = 512;
constexpr int kMaxKeys = 32768;
constexpr int kFeatPerLane = 8;  // features per lane in one pass of K11
constexpr unsigned kNoKey = 0xffffffffu;
constexpr unsigned kNoRow = kNoKey >> 16;  // the window row of kNoKey
constexpr int kSeg = 32;  // sorted positions per warp in K11's segment sums

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// the payload as the TPU kernels' bf16 products see it
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_bf16(bf16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int window_start(int n, int N, int W, int T) {
  return (((n / T) * T + T / 2 - W / 2) % N + N) % N;
}
// (j - start(n)) mod N for 0 <= j < N, in 32-bit arithmetic
__device__ __forceinline__ int window_loc(int j, int n, int N, int W, int T) {
  const int loc = j - window_start(n, N, W, T);
  return loc < 0 ? loc + N : loc;
}

template <class E, int VE>
struct alignas(sizeof(E) * VE) Vec {
  E v[VE];
};

// ---------------------------------------------------------------- K10 --
template <class E, int VE, class I>
__global__ void __launch_bounds__(kThreads)
    window_gather_kernel(const Vec<E, VE>* __restrict__ x,
                         const I* __restrict__ idx,
                         Vec<E, VE>* __restrict__ out,
                         unsigned n_vec, unsigned vpr, int K, int N, int W,
                         int T) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += gridDim.x * blockDim.x) {
    const unsigned row = v / vpr;  // (b * K + k) * N + n
    const unsigned c = v - row * vpr;
    const int n = (int)(row % (unsigned)N);
    const long long b = row / ((unsigned)K * (unsigned)N);
    const long long j = (long long)idx[row];
    const bool in = j >= 0 && j < N && window_loc((int)j, n, N, W, T) < W;
    Vec<E, VE> val;
    if (in) val = x[(b * N + j) * vpr + c];
#pragma unroll
    for (int q = 0; q < VE; ++q)
      from_f(&val.v[q], in ? round_bf16(val.v[q]) : 0.0f);
    out[v] = val;
  }
}

// ---------------------------------------------------------------- K11 --
template <class I>
__global__ void __launch_bounds__(kSortThreads)
    window_sort_kernel(const I* __restrict__ idx, unsigned* __restrict__ keys,
                       int K, int N, int W, int T, int P) {
  extern __shared__ float smem[];
  unsigned* s = reinterpret_cast<unsigned*>(smem);
  const int nb = N / T;
  const int b = blockIdx.x / nb, i = blockIdx.x % nb;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    unsigned key = kNoKey;
    if (e < K * T) {
      const int k = e / T, t = e - (e / T) * T;
      const long long j =
          (long long)idx[((long long)b * K + k) * N + i * T + t];
      if (j >= 0 && j < N) {
        const int loc = window_loc((int)j, i * T, N, W, T);
        if (loc < W) key = ((unsigned)loc << 16) | (unsigned)e;
      }
    }
    s[e] = key;
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < P; e += blockDim.x) {
        const int partner = e ^ stride;
        if (partner > e) {
          const unsigned a = s[e], c = s[partner];
          const bool up = (e & size) == 0;
          if ((a > c) == up) {
            s[e] = c;
            s[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  unsigned* out = keys + (long long)blockIdx.x * P;
  for (int e = threadIdx.x; e < P; e += blockDim.x) out[e] = s[e];
}

// K11 step 2: one warp per segment of kSeg sorted positions of block
// (b, i). It sums each run piece of its segment in key order; a piece that
// starts a run goes to dslab[b, i, w], a piece that continues a run from the
// segment before to head[b, i, segment].
template <class E>
__global__ void __launch_bounds__(kThreads)
    window_segment_kernel(const E* __restrict__ y,
                          const unsigned* __restrict__ keys,
                          float* __restrict__ dslab, float* __restrict__ head,
                          int B, int K, int N, int F, int W, int T, int P) {
  const int nb = N / T, nseg = P / kSeg;
  const long long seg = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= (long long)B * nb * nseg) return;
  const long long bi = seg / nseg;  // b * nb + i
  const int s = (int)(seg - bi * nseg), i = (int)(bi % nb);
  const int b = (int)(bi / nb);
  const unsigned* ks = keys + bi * P;
  const int p0 = s * kSeg;
  if (ks[p0] == kNoKey) return;
  const unsigned prev = p0 > 0 ? ks[p0 - 1] >> 16 : kNoRow;
  for (int f0 = 0; f0 < F; f0 += 32 * kFeatPerLane) {
    float acc[kFeatPerLane];
#pragma unroll
    for (int q = 0; q < kFeatPerLane; ++q) acc[q] = 0.0f;
    unsigned cur = ks[p0] >> 16;
    int piece = p0;
    for (int p = p0;; ++p) {
      const unsigned key = p < p0 + kSeg ? ks[p] : kNoKey;
      if ((key >> 16) != cur) {  // the piece of row cur ends: store it
        float* dst = piece == p0 && prev == cur
                         ? head + seg * F
                         : dslab + (bi * W + cur) * F;
#pragma unroll
        for (int q = 0; q < kFeatPerLane; ++q) {
          const int f = f0 + q * 32 + lane;
          if (f < F) dst[f] = acc[q];
          acc[q] = 0.0f;
        }
        if (key == kNoKey) break;
        cur = key >> 16;
        piece = p;
      }
      const int e = (int)(key & 0xffffu);
      const int k = e / T, n = i * T + (e - (e / T) * T);
      const E* yr = y + (((long long)b * K + k) * N + n) * F;
#pragma unroll
      for (int q = 0; q < kFeatPerLane; ++q) {
        const int f = f0 + q * 32 + lane;
        if (f < F) acc[q] += round_bf16(yr[f]);
      }
    }
  }
}

// K11 step 3: one warp per segment whose last run starts in it and goes on
// into the next: it adds the heads of the following segments to the run's
// dslab row, in segment order.
__global__ void __launch_bounds__(kThreads)
    window_join_kernel(const unsigned* __restrict__ keys,
                       float* __restrict__ dslab,
                       const float* __restrict__ head, int B, int N, int F,
                       int W, int T, int P) {
  const int nb = N / T, nseg = P / kSeg;
  const long long seg = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= (long long)B * nb * nseg) return;
  const long long bi = seg / nseg;
  const int s = (int)(seg - bi * nseg);
  const unsigned* ks = keys + bi * P;
  const int last = s * kSeg + kSeg - 1;
  const unsigned w = ks[last] >> 16;
  if (w == kNoRow || last + 1 >= P || (ks[last + 1] >> 16) != w) return;
  if (s > 0 && (ks[s * kSeg - 1] >> 16) == w) return;  // started earlier
  float* row = dslab + (bi * W + w) * F;
  for (int s2 = s + 1; s2 < nseg; ++s2) {
    const float* h = head + (bi * nseg + s2) * F;
    for (int f = lane; f < F; f += 32) row[f] += h[f];
    const int next = (s2 + 1) * kSeg;
    if (next >= P || (ks[next] >> 16) != w) break;
  }
}

// K11 step 4: one warp per output row (b, j): the blocks' window rows that
// hold j, summed in order of the block.
template <class E>
__global__ void __launch_bounds__(kThreads)
    window_overlap_kernel(const float* __restrict__ dslab,
                          E* __restrict__ out, int B, int N, int F, int W,
                          int T) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * N) return;
  const int b = (int)(row / N), j = (int)(row % N), nb = N / T;
  for (int f = lane; f < F; f += 32) {
    float acc = 0.0f;
    for (int i = 0; i < nb; ++i) {
      const int w = window_loc(j, i * T, N, W, T);
      if (w < W) acc += dslab[(((long long)b * nb + i) * W + w) * F + f];
    }
    from_f(out + row * F + f, acc);
  }
}

bool window_ok(int B, int K, int N, int F, int W, int T) {
  return B > 0 && K > 0 && N > 0 && F > 0 && T > 0 && N % T == 0 && W > 0 &&
         W <= N && W < 65536;
}

// the sort's length: a power of two, at least K*T and one segment
int sort_capacity(int K, int T) {
  int P = kSeg;
  while (P < K * T) P <<= 1;
  return P;
}

template <class E, int VE, class I>
cudaError_t launch_gather(const void* x, const void* idx, void* out, int B,
                          int K, int N, int F, int W, int T,
                          cudaStream_t stream) {
  const unsigned long long n_vec = (unsigned long long)B * K * N * F / VE;
  if (n_vec >= (1ull << 31)) return cudaErrorInvalidValue;
  const unsigned long long want = (n_vec + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  window_gather_kernel<E, VE, I><<<blocks, kThreads, 0, stream>>>(
      (const Vec<E, VE>*)x, (const I*)idx, (Vec<E, VE>*)out,
      (unsigned)n_vec, (unsigned)(F / VE), K, N, W, T);
  return cudaGetLastError();
}

template <class E, class I>
cudaError_t gather_dispatch(const void* x, const void* idx, void* out, int B,
                            int K, int N, int F, int W, int T,
                            cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(E);
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (F % VE == 0 && align % 16 == 0)
    return launch_gather<E, VE, I>(x, idx, out, B, K, N, F, W, T, stream);
  return launch_gather<E, 1, I>(x, idx, out, B, K, N, F, W, T, stream);
}

// K11's scratch: the sorted keys, the blocks' window rows (dslab) and
// the segments' head pieces, each 256-byte aligned.
struct Scratch {
  size_t keys, dslab, head, total;
};

Scratch scratch_layout(int B, int K, int N, int F, int W, int T) {
  const size_t nb = N / T, P = sort_capacity(K, T);
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  Scratch s;
  s.keys = 0;
  s.dslab = up(B * nb * P * sizeof(unsigned));
  s.head = s.dslab + up(B * nb * (size_t)W * F * sizeof(float));
  s.total = s.head + up(B * nb * (P / kSeg) * F * sizeof(float));
  return s;
}

template <class E, class I>
cudaError_t scatter(const void* y, const void* idx, void* scratch, void* out,
                    int B, int K, int N, int F, int W, int T,
                    cudaStream_t stream) {
  const int P = sort_capacity(K, T);
  const Scratch sl = scratch_layout(B, K, N, F, W, T);
  unsigned* keys = (unsigned*)((char*)scratch + sl.keys);
  float* dslab = (float*)((char*)scratch + sl.dslab);
  float* head = (float*)((char*)scratch + sl.head);
  const size_t smem = (size_t)P * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      window_sort_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  window_sort_kernel<I><<<B * (N / T), kSortThreads, smem, stream>>>(
      (const I*)idx, keys, K, N, W, T, P);
  err = cudaMemsetAsync(dslab, 0, sl.head - sl.dslab, stream);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = kThreads / 32;
  const long long segs = (long long)B * (N / T) * (P / kSeg);
  const unsigned seg_blocks = (unsigned)((segs + kWarps - 1) / kWarps);
  window_segment_kernel<E><<<seg_blocks, kThreads, 0, stream>>>(
      (const E*)y, keys, dslab, head, B, K, N, F, W, T, P);
  window_join_kernel<<<seg_blocks, kThreads, 0, stream>>>(
      keys, dslab, head, B, N, F, W, T, P);
  const long long rows = (long long)B * N;
  window_overlap_kernel<E><<<(unsigned)((rows + kWarps - 1) / kWarps),
                             kThreads, 0, stream>>>(dslab, (E*)out, B, N, F,
                                                    W, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch K11 needs (scratch_layout); 0 where the shapes are
// out of its limits.
size_t nn_window_scratch_bytes(int B, int K, int N, int F, int W, int T) {
  if (!window_ok(B, K, N, F, W, T) || K * T > kMaxKeys) return 0;
  return scratch_layout(B, K, N, F, W, T).total;
}

// K10. x (B, N, F), fp32 or (bf16 != 0) bf16; idx (B, K, N) int64 when
// idx64 != 0, else int32; out (B, K, N, F) in x's type.
int nn_window_gather(const void* x, const void* idx, void* out, int B, int K,
                     int N, int F, int W, int T, int bf16_, int idx64,
                     void* stream) {
  if (!window_ok(B, K, N, F, W, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_)
    return (int)(idx64 ? gather_dispatch<bf16, long long>(x, idx, out, B, K,
                                                          N, F, W, T, s)
                       : gather_dispatch<bf16, int>(x, idx, out, B, K, N, F,
                                                    W, T, s));
  return (int)(idx64 ? gather_dispatch<float, long long>(x, idx, out, B, K, N,
                                                         F, W, T, s)
                     : gather_dispatch<float, int>(x, idx, out, B, K, N, F, W,
                                                   T, s));
}

// K11. y (B, K, N, F), fp32 or (bf16 != 0) bf16; idx as K10's; scratch:
// nn_window_scratch_bytes of device memory; out (B, N, F) in y's type.
int nn_window_scatter(const void* y, const void* idx, void* scratch, void* out,
                      int B, int K, int N, int F, int W, int T, int bf16_,
                      int idx64, void* stream) {
  if (!window_ok(B, K, N, F, W, T) || K * T > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_)
    return (int)(idx64 ? scatter<bf16, long long>(y, idx, scratch, out, B, K, N,
                                                  F, W, T, s)
                       : scatter<bf16, int>(y, idx, scratch, out, B, K, N, F, W,
                                            T, s));
  return (int)(idx64 ? scatter<float, long long>(y, idx, scratch, out, B, K, N, F,
                                                 W, T, s)
                     : scatter<float, int>(y, idx, scratch, out, B, K, N, F, W,
                                           T, s));
}

}  // extern "C"
