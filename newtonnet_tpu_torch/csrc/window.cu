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
// and writes B*N.
//
// K10: one thread per output vector (8 bf16 or 4 fp32 values where F
// allows, else one value), the window test per row, consecutive threads on
// consecutive vectors (coalesced stores and loads).
//
// K11, deterministic and without float atomics: the list transposed by
// destination row, then a fixed-order sum per row, so that its traffic is
// the payload (no scratch of window rows).
//   A stable LSD radix sort of the edge ids e = (b*K + k)*N + n by key
//     b*N + j (key B*N for an edge out of its window, which sorts last), 8
//     bits a pass (two passes up to 65535 rows), in tiles of kTile edges
//     staged in shared memory: window_hist_kernel counts each tile's
//     digits (per thread, no atomics), window_offsets_kernel (one warp
//     per digit) scans each digit's counts over the tiles,
//     window_scatter_kernel moves each edge to its digit's offset plus its
//     rank in the tile, threads in order and each thread's edges in order.
//     The first pass computes the keys from idx.
//   window_bounds_kernel: each row's run of sorted positions.
//   window_segment_kernel: one warp per segment of kSeg sorted positions,
//     lanes across features (16-byte loads where F allows), sums each run
//     piece of its segment in sorted order in fp32, kRowsInFlight payload
//     rows in flight: a run inside the segment goes straight to its output
//     row, a piece that continues a run from the segment before to the
//     segment's head partial, a piece that starts a run going on into the
//     next segment to its tail partial. Long runs (masked slots pointed at
//     one atom give thousands of edges) are spread over many warps so.
//   window_finish_kernel: one warp per output row: zeros for a row with no
//     edge; for a run over several segments its tail and heads, summed in
//     segment order.
// The order of every sum is fixed, so a run repeats its bits.
// Limits (cudaErrorInvalidValue otherwise): N % T == 0, 0 < W <= N,
// W < 65536 (K10's and K11's common test), and B*K*N < 2^31 (edge ids in
// 32 bits). The sort keeps no per-block edge set in shared memory, so the
// old limit K*T <= 32768 is gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
// K11's radix sort: tiles of kTile edges, kItems per thread of a block of
// kRadixThreads; per-thread digit counts at row stride kCountLd (16-bit
// words, so that a thread scanning one digit's column over the threads
// reads consecutive words as its neighbours do)
constexpr int kRadixThreads = 128;
constexpr int kItems = 16;
constexpr int kTile = kRadixThreads * kItems;
constexpr int kDigits = 256;
constexpr int kDigitBits = 8;
constexpr int kCountLd = kDigits + 2;
constexpr unsigned kPastEnd = 0xffffffffu;  // a tile's slots past E
// K11's sums: sorted positions per warp, 16-byte vectors per lane and
// payload rows in flight per warp
constexpr int kSeg = 256;
constexpr int kVecPerLane = 2;
constexpr int kRowsInFlight = 4;
constexpr int kSegMinBlocks = 1;  // resident blocks per SM it is built for
// K11's join: vectors per lane and partials in flight
constexpr int kJoinVec = 4;
constexpr int kJoinInFlight = 8;

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
// the sort key of edge e = (b*K + k)*N + n (< 2^31): b*N + j when j =
// idx[e] lies in n's window, else R = B*N
template <class I>
__device__ __forceinline__ unsigned edge_key(const I* __restrict__ idx,
                                             unsigned e, int K, int N, int W,
                                             int T, unsigned R) {
  const int n = (int)(e % (unsigned)N);
  const unsigned b = e / ((unsigned)K * (unsigned)N);
  const long long j = (long long)idx[e];
  const bool in = j >= 0 && j < N && window_loc((int)j, n, N, W, T) < W;
  return in ? b * (unsigned)N + (unsigned)j : R;
}

// A tile's edges are staged in shared memory, loaded coalesced: edge q of
// thread t at t*(kItems + 1) + q (conflict-free reads of a thread's run),
// kPastEnd past E.
__device__ __forceinline__ int tile_at(int l) {
  return (l / kItems) * (kItems + 1) + l % kItems;
}

// The tile's keys: from keys, or with idx computed from idx and stored to
// keys (the first pass).
template <class I>
__device__ void tile_keys(const I* __restrict__ idx, unsigned* keys,
                          long long E, int K, int N, int W, int T, unsigned R,
                          unsigned* key_s) {
  for (int l = threadIdx.x; l < kTile; l += kRadixThreads) {
    const long long e = (long long)blockIdx.x * kTile + l;
    unsigned key = kPastEnd;
    if (e < E && idx != nullptr) {
      key = edge_key(idx, (unsigned)e, K, N, W, T, R);
      keys[e] = key;
    } else if (e < E) {
      key = keys[e];
    }
    key_s[tile_at(l)] = key;
  }
}

// The tile's keys and edge ids (vals, or with first the ids e themselves).
__device__ void tile_pairs(const unsigned* __restrict__ keys,
                           const int* __restrict__ vals, bool first,
                           long long E, unsigned* key_s, int* val_s) {
  for (int l = threadIdx.x; l < kTile; l += kRadixThreads) {
    const long long e = (long long)blockIdx.x * kTile + l;
    key_s[tile_at(l)] = e < E ? keys[e] : kPastEnd;
    if (e < E) val_s[tile_at(l)] = first ? (int)e : vals[e];
  }
}

// Per-thread digit counts of the tile: cnt[t*kCountLd + d] counts the
// digits d = (key >> shift) & 255 of thread t's kItems edges. Ends with a
// __syncthreads.
__device__ void tile_counts(const unsigned* key_s, int shift,
                            unsigned short* cnt) {
  unsigned short* mine = cnt + threadIdx.x * kCountLd;
  for (int d = 0; d < kDigits; ++d) mine[d] = 0;
  __syncthreads();  // the keys are in
  const unsigned* run = key_s + threadIdx.x * (kItems + 1);
  for (int q = 0; q < kItems; ++q)
    if (run[q] != kPastEnd) ++mine[(run[q] >> shift) & (kDigits - 1)];
  __syncthreads();
}

// hist[d * n_tiles + tile] = the number of the tile's edges with digit d.
// The first pass (idx not null) computes the keys from idx into keys.
template <class I>
__global__ void __launch_bounds__(kRadixThreads)
    window_hist_kernel(const I* __restrict__ idx, unsigned* keys,
                       unsigned* __restrict__ hist, long long E, int K, int N,
                       int W, int T, unsigned R, int shift) {
  extern __shared__ float smem[];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);
  unsigned* key_s =
      reinterpret_cast<unsigned*>(cnt + kRadixThreads * kCountLd);
  tile_keys(idx, keys, E, K, N, W, T, R, key_s);
  tile_counts(key_s, shift, cnt);
  for (int d = threadIdx.x; d < kDigits; d += kRadixThreads) {
    unsigned s = 0;
    for (int t = 0; t < kRadixThreads; ++t) s += cnt[t * kCountLd + d];
    hist[(long long)d * gridDim.x + blockIdx.x] = s;
  }
}

// One warp per digit d: hist[d][0..n_tiles) -> its exclusive prefix sums
// over the tiles, tot[d] -> the digit's total. Each lane sums a
// contiguous run of tiles, the warp scans the lanes' sums in shared
// memory, each lane rewrites its run.
__global__ void __launch_bounds__(kThreads)
    window_offsets_kernel(unsigned* __restrict__ hist,
                          unsigned* __restrict__ tot, int n_tiles) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * (kThreads / 32) + w;
  unsigned* part = reinterpret_cast<unsigned*>(smem) + w * 32;
  unsigned* row = hist + (long long)d * n_tiles;
  const int per = (n_tiles + 31) / 32, lo = lane * per;
  const int hi = lo + per < n_tiles ? lo + per : n_tiles;
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += row[i];
  part[lane] = s;
  __syncwarp();
  for (int o = 1; o < 32; o <<= 1) {  // inclusive scan
    const unsigned v = lane >= o ? part[lane - o] : 0u;
    __syncwarp();
    part[lane] += v;
    __syncwarp();
  }
  unsigned run = part[lane] - s;
  for (int i = lo; i < hi; ++i) {
    const unsigned c = row[i];
    row[i] = run;
    run += c;
  }
  if (lane == 31) tot[d] = part[31];
}

// One stable pass: each of the tile's edges to the offset of its digit d
// (the edges of the smaller digits, from tot, plus those of d in earlier
// tiles, off) plus its rank among the tile's edges of digit d (threads in
// order, each thread's edges in order). The first pass (first) takes the
// edge ids e for vals_in.
__global__ void __launch_bounds__(kRadixThreads)
    window_scatter_kernel(const unsigned* __restrict__ keys_in,
                          const int* __restrict__ vals_in, int first,
                          const unsigned* __restrict__ off,
                          const unsigned* __restrict__ tot,
                          unsigned* __restrict__ keys_out,
                          int* __restrict__ vals_out, long long E, int shift) {
  extern __shared__ float smem[];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);
  unsigned* key_s =
      reinterpret_cast<unsigned*>(cnt + kRadixThreads * kCountLd);
  int* val_s = reinterpret_cast<int*>(key_s + kRadixThreads * (kItems + 1));
  unsigned* base =
      reinterpret_cast<unsigned*>(val_s + kRadixThreads * (kItems + 1));
  unsigned* part = base + kDigits;  // kRadixThreads
  const int t = threadIdx.x;
  tile_pairs(keys_in, vals_in, first != 0, E, key_s, val_s);
  // base[d] = the edges of the digits below d; thread t takes digits 2t
  // and 2t + 1 (kDigits = 2 kRadixThreads)
  const unsigned t0 = tot[2 * t], t1 = tot[2 * t + 1];
  part[t] = t0 + t1;
  tile_counts(key_s, shift, cnt);  // its barriers order part too
  for (int o = 1; o < kRadixThreads; o <<= 1) {  // inclusive scan
    const unsigned v = t >= o ? part[t - o] : 0u;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  base[2 * t] = part[t] - t0 - t1 + off[(2ll * t) * gridDim.x + blockIdx.x];
  base[2 * t + 1] =
      part[t] - t1 + off[(2ll * t + 1) * gridDim.x + blockIdx.x];
  // each digit's counts -> the threads' exclusive prefix sums
  for (int d = t; d < kDigits; d += kRadixThreads) {
    unsigned short run = 0;  // at most kTile
    for (int u = 0; u < kRadixThreads; ++u) {
      const unsigned short c = cnt[u * kCountLd + d];
      cnt[u * kCountLd + d] = run;
      run = (unsigned short)(run + c);
    }
  }
  __syncthreads();
  unsigned short* mine = cnt + t * kCountLd;
  const unsigned* krun = key_s + t * (kItems + 1);
  const int* vrun = val_s + t * (kItems + 1);
  for (int q = 0; q < kItems; ++q) {
    const unsigned key = krun[q];
    if (key == kPastEnd) break;
    const int d = (key >> shift) & (kDigits - 1);
    const unsigned pos = base[d] + mine[d];
    mine[d] = (unsigned short)(mine[d] + 1);
    keys_out[pos] = key;
    vals_out[pos] = vrun[q];
  }
}

// start[r] = the first sorted position whose key is >= r, r = 0..R (start[R]
// = the number of in-window edges): position p sets the rows from the key
// before it (exclusive) to its own key (inclusive).
__global__ void __launch_bounds__(kThreads)
    window_bounds_kernel(const unsigned* __restrict__ keys,
                         int* __restrict__ start, long long E, unsigned R) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p <= E; p += (long long)gridDim.x * blockDim.x) {
    const long long lo = p == 0 ? 0 : (long long)keys[p - 1] + 1;
    const long long hi = p == E ? (long long)R : (long long)keys[p];
    for (long long r = lo; r <= hi; ++r) start[r] = (int)p;
  }
}

// K11's sums: one warp per segment s of kSeg sorted positions, its keys
// and edge ids staged in shared memory, lanes across features; each run
// piece of the segment is summed in sorted order. A run inside the
// segment goes straight to its output row; a piece that continues a run
// from the segment before goes to the segment's head partial part[s], a
// piece that starts a run going on into the next segment to its tail
// partial part[n_seg + s] (F fp32 values each), and window_finish_kernel
// joins them.
template <class E, int VE>
__global__ void __launch_bounds__(kThreads, kSegMinBlocks)
    window_segment_kernel(const Vec<E, VE>* __restrict__ y,
                          const unsigned* __restrict__ keys,
                          const int* __restrict__ vals,
                          const int* __restrict__ start,
                          float* __restrict__ part,
                          Vec<E, VE>* __restrict__ out, int F, unsigned R,
                          long long n_seg) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* key_s = reinterpret_cast<unsigned*>(smem) + w * 2 * kSeg;
  int* val_s = reinterpret_cast<int*>(key_s + kSeg);
  const long long s = (long long)blockIdx.x * (kThreads / 32) + w;
  const long long n_kept = start[R];
  const long long p0 = s * kSeg;
  if (s >= n_seg || p0 >= n_kept) return;
  const int len = (int)(p0 + kSeg < n_kept ? kSeg : n_kept - p0);
  for (int i = lane; i < len; i += 32) {
    key_s[i] = keys[p0 + i];
    val_s[i] = vals[p0 + i];
  }
  __syncwarp();
  // the keys just before and just after the segment (none: R + 1)
  const unsigned k_before = p0 > 0 ? keys[p0 - 1] : R + 1;
  const unsigned k_after = p0 + kSeg < n_kept ? keys[p0 + kSeg] : R + 1;
  const int vpr = F / VE;  // vectors per row
  for (int c0 = 0; c0 < vpr; c0 += 32 * kVecPerLane) {
    for (int p = 0; p < len;) {
      const unsigned r = key_s[p];
      int q = p + 1;
      while (q < len && key_s[q] == r) ++q;
      float acc[kVecPerLane][VE];
#pragma unroll
      for (int v = 0; v < kVecPerLane; ++v)
#pragma unroll
        for (int x = 0; x < VE; ++x) acc[v][x] = 0.0f;
      for (int pp = p; pp < q; pp += kRowsInFlight) {
        Vec<E, VE> row[kRowsInFlight][kVecPerLane];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const long long e = pp + u < q ? val_s[pp + u] : -1;
#pragma unroll
          for (int v = 0; v < kVecPerLane; ++v) {
            const int c = c0 + v * 32 + lane;
            if (e >= 0 && c < vpr) row[u][v] = y[e * vpr + c];
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
          for (int v = 0; v < kVecPerLane; ++v)
#pragma unroll
            for (int x = 0; x < VE; ++x)
              if (pp + u < q && c0 + v * 32 + lane < vpr)
                acc[v][x] += round_bf16(row[u][v].v[x]);
      }
      const bool before = p == 0 && k_before == r;
      const bool after = q == kSeg && k_after == r;
#pragma unroll
      for (int v = 0; v < kVecPerLane; ++v) {
        const int c = c0 + v * 32 + lane;
        if (c >= vpr) continue;
        if (before || after) {
          float* dst = part + (before ? s : n_seg + s) * F + (long long)c * VE;
#pragma unroll
          for (int x = 0; x < VE; ++x) dst[x] = acc[v][x];
        } else {
          Vec<E, VE> o;
#pragma unroll
          for (int x = 0; x < VE; ++x) from_f(&o.v[x], acc[v][x]);
          out[(long long)r * vpr + c] = o;
        }
      }
      p = q;
    }
  }
}

// One warp per output row r: zeros for a row with no edge; a run over
// several segments as its first segment's tail plus the heads of the
// segments after, in segment order, each lane holding kJoinVec vectors of
// VP values and loading kJoinInFlight partials of each at a time. A run
// inside one segment was written by window_segment_kernel.
template <class E, int VP>
__global__ void __launch_bounds__(kThreads)
    window_finish_kernel(const int* __restrict__ start,
                         const Vec<float, VP>* __restrict__ part,
                         E* __restrict__ out, int F, unsigned R,
                         long long n_seg) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const long long p0 = start[r], p1 = start[r + 1];
  const long long s0 = p0 / kSeg, s1 = p1 > p0 ? (p1 - 1) / kSeg : s0;
  if (p1 > p0 && s0 == s1) return;
  const int vpr = F / VP;
  for (int c0 = 0; c0 < vpr; c0 += 32 * kJoinVec) {
    float acc[kJoinVec][VP];
#pragma unroll
    for (int v = 0; v < kJoinVec; ++v) {
      const int c = c0 + v * 32 + lane;
      Vec<float, VP> tail;
      if (p1 > p0 && c < vpr) tail = part[(n_seg + s0) * vpr + c];
#pragma unroll
      for (int x = 0; x < VP; ++x)
        acc[v][x] = p1 > p0 && c < vpr ? tail.v[x] : 0.0f;
    }
    for (long long sa = s0 + 1; p1 > p0 && sa <= s1; sa += kJoinInFlight) {
      Vec<float, VP> h[kJoinInFlight][kJoinVec];
#pragma unroll
      for (int u = 0; u < kJoinInFlight; ++u)
#pragma unroll
        for (int v = 0; v < kJoinVec; ++v) {
          const int c = c0 + v * 32 + lane;
          if (sa + u <= s1 && c < vpr) h[u][v] = part[(sa + u) * vpr + c];
        }
#pragma unroll
      for (int u = 0; u < kJoinInFlight; ++u)
#pragma unroll
        for (int v = 0; v < kJoinVec; ++v)
#pragma unroll
          for (int x = 0; x < VP; ++x)
            if (sa + u <= s1 && c0 + v * 32 + lane < vpr)
              acc[v][x] += h[u][v].v[x];
    }
#pragma unroll
    for (int v = 0; v < kJoinVec; ++v) {
      const int c = c0 + v * 32 + lane;
      if (c >= vpr) continue;
#pragma unroll
      for (int x = 0; x < VP; ++x)
        from_f(out + r * F + (long long)c * VP + x, acc[v][x]);
    }
  }
}

bool window_ok(int B, int K, int N, int F, int W, int T) {
  return B > 0 && K > 0 && N > 0 && F > 0 && T > 0 && N % T == 0 && W > 0 &&
         W <= N && W < 65536;
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

// K11's limits beyond window_ok: edge ids and sorted positions in 32 bits
bool scatter_ok(int B, int K, int N, int F, int W, int T) {
  return window_ok(B, K, N, F, W, T) &&
         (long long)B * K * N < (1ll << 31) - kTile;
}

// K11's scratch: two buffers of sorted keys and edge ids (a pass reads one
// and writes the other), the tiles' digit counts and the digits' totals,
// the rows' run starts and the segments' head and tail partials, each
// 256-byte aligned.
struct Scratch {
  size_t keys[2], vals[2], hist, start, part, total;
};

long long n_tiles_of(long long E) { return (E + kTile - 1) / kTile; }
long long n_seg_of(long long E) { return (E + kSeg - 1) / kSeg; }

Scratch scratch_layout(int B, int K, int N, int F) {
  const size_t E = (size_t)B * K * N;
  auto up = [](size_t n) { return (n + 255) / 256 * 256; };
  Scratch s;
  size_t at = 0;
  for (int x = 0; x < 2; ++x) {
    s.keys[x] = at;
    at += up(E * sizeof(unsigned));
    s.vals[x] = at;
    at += up(E * sizeof(int));
  }
  s.hist = at;  // the counts, then the digits' totals
  at += up((size_t)kDigits * (n_tiles_of(E) + 1) * sizeof(unsigned));
  s.start = at;
  at += up(((size_t)B * N + 1) * sizeof(int));
  s.part = at;
  at += up((size_t)2 * n_seg_of(E) * F * sizeof(float));
  s.total = at;
  return s;
}

template <class E, int VE, class I>
cudaError_t scatter_sum(const void* y, const void* idx, void* scratch,
                        void* out, int B, int K, int N, int F, int W, int T,
                        cudaStream_t stream) {
  const long long n_edges = (long long)B * K * N;
  const unsigned R = (unsigned)B * N;
  const Scratch sl = scratch_layout(B, K, N, F);
  char* base = static_cast<char*>(scratch);
  unsigned* keys[2] = {(unsigned*)(base + sl.keys[0]),
                       (unsigned*)(base + sl.keys[1])};
  int* vals[2] = {(int*)(base + sl.vals[0]), (int*)(base + sl.vals[1])};
  unsigned* hist = (unsigned*)(base + sl.hist);
  int* start = (int*)(base + sl.start);
  float* part = (float*)(base + sl.part);
  const long long n_tiles = n_tiles_of(n_edges), n_seg = n_seg_of(n_edges);
  unsigned* tot = hist + (size_t)kDigits * n_tiles;
  const size_t hist_smem = (size_t)kRadixThreads * kCountLd * 2 +
                           (size_t)kRadixThreads * (kItems + 1) * 4;
  const size_t scatter_smem = hist_smem +
                              (size_t)kRadixThreads * (kItems + 1) * 4 +
                              (size_t)(kDigits + kRadixThreads) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      window_hist_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hist_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(window_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scatter_smem);
  if (err != cudaSuccess) return err;
  // the passes: enough digits for the keys 0..R
  int bits = 0;
  while (bits < 32 && (R >> bits) != 0) ++bits;
  const I* id = static_cast<const I*>(idx);
  int cur = 0;
  for (int shift = 0; shift < bits; shift += kDigitBits) {
    const I* src = shift == 0 ? id : nullptr;  // the first pass reads idx
    window_hist_kernel<I><<<(unsigned)n_tiles, kRadixThreads, hist_smem,
                            stream>>>(src, keys[cur], hist, n_edges, K, N, W,
                                      T, R, shift);
    window_offsets_kernel<<<kDigits / (kThreads / 32), kThreads,
                            kThreads * sizeof(unsigned), stream>>>(
        hist, tot, (int)n_tiles);
    window_scatter_kernel<<<(unsigned)n_tiles, kRadixThreads, scatter_smem,
                            stream>>>(keys[cur], vals[cur], shift == 0, hist,
                                      tot, keys[cur ^ 1], vals[cur ^ 1],
                                      n_edges, shift);
    cur ^= 1;
  }
  const long long want = (n_edges + kThreads) / kThreads;
  window_bounds_kernel<<<(unsigned)(want < kMaxBlocks ? want : kMaxBlocks),
                         kThreads, 0, stream>>>(keys[cur], start, n_edges, R);
  constexpr int kWarps = kThreads / 32;
  window_segment_kernel<E, VE><<<(unsigned)((n_seg + kWarps - 1) / kWarps),
                                 kThreads, kWarps * 2 * kSeg * 4, stream>>>(
      (const Vec<E, VE>*)y, keys[cur], vals[cur], start, part,
      (Vec<E, VE>*)out, F, R, n_seg);
  const unsigned rows = (unsigned)((R + kWarps - 1) / kWarps);
  if (F % 4 == 0)
    window_finish_kernel<E, 4><<<rows, kThreads, 0, stream>>>(
        start, (const Vec<float, 4>*)part, (E*)out, F, R, n_seg);
  else
    window_finish_kernel<E, 1><<<rows, kThreads, 0, stream>>>(
        start, (const Vec<float, 1>*)part, (E*)out, F, R, n_seg);
  return cudaGetLastError();
}

template <class E, class I>
cudaError_t scatter(const void* y, const void* idx, void* scratch, void* out,
                    int B, int K, int N, int F, int W, int T,
                    cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(E);
  const uintptr_t align = (uintptr_t)y | (uintptr_t)out;
  if (F % VE == 0 && align % 16 == 0)
    return scatter_sum<E, VE, I>(y, idx, scratch, out, B, K, N, F, W, T,
                                 stream);
  return scatter_sum<E, 1, I>(y, idx, scratch, out, B, K, N, F, W, T,
                              stream);
}

}  // namespace

extern "C" {

// Bytes of the scratch K11 needs (scratch_layout); 0 where the shapes are
// out of its limits.
size_t nn_window_scratch_bytes(int B, int K, int N, int F, int W, int T) {
  if (!scatter_ok(B, K, N, F, W, T)) return 0;
  return scratch_layout(B, K, N, F).total;
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
  if (!scatter_ok(B, K, N, F, W, T)) return (int)cudaErrorInvalidValue;
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
