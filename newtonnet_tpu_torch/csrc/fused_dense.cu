// Fused dense pair-interaction layer for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels newtonnet_tpu/ops/pallas_dense.py:_fwd_kernel
// (K1) and newtonnet_tpu/ops/pallas_dense.py:_bwd_kernel (K2). Both are
// templated on FIRST (the stack's first layer, whose force_node input is
// identically zero, so the phi2 branch is skipped) and on the feature width
// F (32, 64 or 128); R (the radial basis size) and N (atoms) are runtime.
//
// Computation (B molecules, N atoms, pair slot (i, j), Cartesian d):
//     me   = rbf[i,j] @ We                          (F)
//     msg  = me * np_i * np_j * adj[i,j]
//     inv1[i]  = sum_j msg
//     phi1 = (silu(msg @ W1a) @ W1b) * adj[i,j]
//     phi2 = (silu(msg @ W2a) @ W2b) * adj[i,j]
//     eq[d,i]  = sum_j phi1 * dir[d,i,j] + sum_j phi2 * force[d,j]
//
// What bounds it on this card: operations. Per pair slot K1 does
// 2(R*F + 4F^2) flops of matrix products (136 kflop at F=128, R=20) and reads
// R+4 floats of pair data, so it sits far above the H100's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). K2 recomputes the chain and
// adds the transposed products: about 2x the flops of K1.
//
// K1's design. One block of 8 warps per (molecule, tile of TI=8 rows i);
// the block loops over tiles of TJ=8 columns j. A tile is M=64 pair slots;
// warp w owns the TJ slots of row i0+w, lane l owns feature columns l+32c.
// The per-slot chain (me, msg, p, h, phi) lives only in shared memory and
// registers; the weights stay in L2 and stream through shared memory in
// KC-row chunks. Sums over j (inv1, eq) are per-thread register sums over
// the warp's own slots, so they are deterministic and need no atomics.
// Plain IEEE fp32 FMAs: no TF32, no tensor cores. K1 takes 109 KB of
// shared memory at F=128, R=20 (two blocks per SM).
//
// K2 has its own design, on the tensor cores in 3xTF32 (the note above
// pair_bwd_kernel): fp32-level products (each operand split in a tf32 high
// and low part, three products summed in fp32; never 1xTF32). Its sums
// over i and j and its weight cotangents cross blocks and are summed by
// second kernels in a fixed order: no float atomics, a run gives the same
// bits every time.
//
// The host functions return the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TI = kWarps;   // rows i per block: one per warp
constexpr int TJ = 8;        // columns j per tile: all held by one warp
constexpr int M = TI * TJ;   // pair slots per tile; slot p = il * TJ + jl
constexpr int KC = 32;       // rows of a streamed weight chunk

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f + x * (1.0f - s));
}

// acc[r][c] = sum_k A[(w*TJ + r)*lda + k] * W[k*F + l + 32c], k < K (W is
// K x F), for the calling thread's warp w and lane l. A holds the warp's
// own slots only, so a warp may write its A rows just before the call; the
// leading __syncthreads of each chunk orders everything else. All threads
// of the block must call it.
template <int F>
__device__ __forceinline__ void gemm_rows(const float* __restrict__ A, int lda,
                                          int K, const float* __restrict__ W,
                                          float* __restrict__ w_s,
                                          float (&acc)[TJ][F / 32]) {
  constexpr int C = F / 32;
  constexpr int WLD = F + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  const float* arow = A + (size_t)(warp * TJ) * lda;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kc * F; idx += kThreads) {
      const int kk = idx / F, n = idx - kk * F;
      w_s[kk * WLD + n] = W[(size_t)(k0 + kk) * F + n];
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float bv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c] = w_s[kk * WLD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const float a = arow[r * lda + k0 + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
      }
    }
  }
}

// Loads the tile's column-side inputs: np_j, force_j (unless FIRST), and
// the per-slot adj, dir and rbf. Slots outside the molecule read as zero,
// so they contribute nothing and stay finite (silu(0) = 0).
template <int F, bool FIRST>
__device__ void load_tile(const float* __restrict__ np_,
                          const float* __restrict__ rbf,
                          const float* __restrict__ dir,
                          const float* __restrict__ adj,
                          const float* __restrict__ force, int b, int i0,
                          int j0, int N, int R, float* npj_s, float* fj_s,
                          float* adj_s, float* dir_s, float* rbf_s) {
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    npj_s[idx] = j < N ? np_[((size_t)b * N + j) * F + f] : 0.0f;
  }
  if (!FIRST) {
    for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
      const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
      const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
      fj_s[idx] = j < N ? force[(((size_t)b * 3 + d) * N + j) * F + f] : 0.0f;
    }
  }
  for (int idx = threadIdx.x; idx < 4 * M; idx += kThreads) {
    const int d = idx / M, p = idx - d * M;  // d = 0: adj, 1..3: dir
    const int i = i0 + p / TJ, j = j0 + p % TJ;
    const bool ok = i < N && j < N;
    if (d == 0)
      adj_s[p] = ok ? adj[((size_t)b * N + i) * N + j] : 0.0f;
    else
      dir_s[(d - 1) * M + p] =
          ok ? dir[(((size_t)b * 3 + d - 1) * N + i) * N + j] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < M * R; idx += kThreads) {
    const int p = idx / R, r = idx - p * R;
    const int i = i0 + p / TJ, j = j0 + p % TJ;
    rbf_s[idx] =
        (i < N && j < N) ? rbf[(((size_t)b * N + i) * N + j) * R + r] : 0.0f;
  }
}

// ------------------------------------------------------------------ K1 --
template <int F>
constexpr size_t fwd_smem_floats(int R) {
  return (size_t)2 * M * (F + 1) + (size_t)KC * (F + 1) + (size_t)TI * F +
         (size_t)4 * TJ * F + (size_t)4 * M + (size_t)M * R;
}

template <int F, bool FIRST>
__global__ void __launch_bounds__(kThreads, 2)
pair_fwd_kernel(const float* __restrict__ np_, const float* __restrict__ rbf,
                const float* __restrict__ dir, const float* __restrict__ adj,
                const float* __restrict__ force, const float* __restrict__ We,
                const float* __restrict__ W1a, const float* __restrict__ W1b,
                const float* __restrict__ W2a, const float* __restrict__ W2b,
                float* __restrict__ inv1, float* __restrict__ eq, int N,
                int R, int n_itiles) {
  constexpr int C = F / 32;
  constexpr int LD = F + 1;
  extern __shared__ float smem[];
  float* msg_s = smem;                 // M x LD
  float* h_s = msg_s + M * LD;         // M x LD
  float* w_s = h_s + M * LD;           // KC x LD
  float* npi_s = w_s + KC * LD;        // TI x F
  float* npj_s = npi_s + TI * F;       // TJ x F
  float* fj_s = npj_s + TJ * F;        // 3 x TJ x F
  float* adj_s = fj_s + 3 * TJ * F;    // M
  float* dir_s = adj_s + M;            // 3 x M
  float* rbf_s = dir_s + 3 * M;        // M x R

  const int b = blockIdx.x / n_itiles;
  const int i0 = (blockIdx.x - b * n_itiles) * TI;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    npi_s[idx] = i0 + il < N ? np_[((size_t)b * N + i0 + il) * F + f] : 0.0f;
  }

  float inv_acc[C], eq_acc[3][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    inv_acc[c] = 0.0f;
    eq_acc[0][c] = eq_acc[1][c] = eq_acc[2][c] = 0.0f;
  }
  float acc[TJ][C];

  for (int j0 = 0; j0 < N; j0 += TJ) {
    __syncthreads();
    load_tile<F, FIRST>(np_, rbf, dir, adj, force, b, i0, j0, N, R, npj_s,
                        fj_s, adj_s, dir_s, rbf_s);
    gemm_rows<F>(rbf_s, R, R, We, w_s, acc);  // me
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        const float m = acc[r][c] * npi_s[warp * F + f] * npj_s[r * F + f] * a;
        msg_s[p * LD + f] = m;
        inv_acc[c] += m;
      }
    }
    gemm_rows<F>(msg_s, LD, F, W1a, w_s, acc);
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        h_s[(warp * TJ + r) * LD + lane + 32 * c] = silu_f(acc[r][c]);
    gemm_rows<F>(h_s, LD, F, W1b, w_s, acc);
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
      const float d0 = dir_s[p], d1 = dir_s[M + p], d2 = dir_s[2 * M + p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float phi = acc[r][c] * a;
        eq_acc[0][c] += phi * d0;
        eq_acc[1][c] += phi * d1;
        eq_acc[2][c] += phi * d2;
      }
    }
    if (!FIRST) {
      gemm_rows<F>(msg_s, LD, F, W2a, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          h_s[(warp * TJ + r) * LD + lane + 32 * c] = silu_f(acc[r][c]);
      gemm_rows<F>(h_s, LD, F, W2b, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const float a = adj_s[warp * TJ + r];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const float phi = acc[r][c] * a;
          eq_acc[0][c] += phi * fj_s[(0 * TJ + r) * F + f];
          eq_acc[1][c] += phi * fj_s[(1 * TJ + r) * F + f];
          eq_acc[2][c] += phi * fj_s[(2 * TJ + r) * F + f];
        }
      }
    }
  }

  const int i = i0 + warp;
  if (i < N) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      inv1[((size_t)b * N + i) * F + f] = inv_acc[c];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        eq[(((size_t)b * 3 + d) * N + i) * F + f] = eq_acc[d][c];
    }
  }
}

// ------------------------------------------------------------------ K2 --
// K2 on the tensor cores (its own design; K1 above keeps the CUDA cores).
// What bounds it: its products, 2(2RF + 8F^2) flops per pair slot at a
// full layer (no weight cotangents; 12.2 GFLOP at the serving shape B=100,
// N=21, F=128, R=20). The CUDA-core version ran one block per (molecule,
// 8 rows), 300 blocks at the serving shape and 30 at the training shape
// (B=10, N=24) for 132 SMs, each product on the CUDA cores with its weight
// re-streamed, me computed twice and drbf as scalar dot products. So:
//
// * Grid: one block of 8 warps per (molecule, tile of TI=8 rows i, tile of
//   TJ2=4 columns j), M2=32 pair slots: B * ceil(N/8) * ceil(N/4) blocks,
//   1,800 at the serving shape and 180 at the training shape. Warp w owns
//   the TJ2 slots of row i0+w and lane l the feature columns l+32c in the
//   elementwise chain.
// * Products on the tensor cores (k2_prod): mma.sync m16n8k8 tf32 in
//   3xTF32 (hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi in fp32;
//   no 1xTF32), 32 x Q @ Q x NC, warp w taking the 16-row half (w & 1) and
//   NC/4 columns. The two branches run paired: p1/p2 (both from msg), phi1/
//   phi2, dh1/dh2 and dmsg = dp1 W1a^T + dp2 W2a^T in one pass each, so a
//   pass has two independent products to overlap. me is computed once per
//   tile and kept; drbf = dme We^T is a product too.
// * Weights split once per launch: pair_bwd_prep_kernel writes We^T, We,
//   the four W^T and the four W as (hi, lo) tf32 word pairs, n-major with
//   the depth contiguous (R padded with zeros to a multiple of 32), into
//   the launch's scratch (nn_pair_scratch_floats). A pass stages chunks of
//   KC2 depth steps of its one or two weights by cp.async into a two-slot
//   ring (rows at a stride of RS2 pairs: the B fragments' 64-bit loads take
//   the minimum two wavefronts); the next chunk loads while the current one
//   multiplies. Slot operands are fp32 and split at fragment load.
// * Summing: each chunk's products accumulate in fresh tensor-core
//   registers and are added to the running sum on the CUDA cores.
// * Sums that cross blocks: the row part of dnp (over j) goes to
//   per-(molecule, j-tile) partials, the column parts over i (dnp, dforce)
//   to per-(molecule, i-tile) partials; pair_bwd_nodesum_kernel adds them
//   in a fixed order. Weight cotangents (WGRAD, off in the force pass) on
//   the same tensor cores (k2_wgrad): each block writes its partial once
//   and pair_bwd_wsum_kernel sums them in a fixed order. No float atomics:
//   a run gives the same bits every time.
// * Shared memory at F=128, R=20: the ring 80 KB, six fp32 slot buffers
//   (me, msg, p1, p2 and two that carry h, phi, dphi, dh, dp, dmsg, t, dme
//   in turn) 99 KB, rbf (then drbf) 4.5 KB, the row and column inputs
//   16 KB: 200 KB, one block per SM.
// * Code size: k2_prod and k2_wgrad are out of line (__noinline__).
// On the card its time splits three ways (PERF.md, dual_breakdown.py
// k2k7): the elementwise chain and tile loads, the weight stream (each
// 32-slot tile streams all the weights from L2, 1.1 MB of pairs at F=128)
// with the fragment loads and splits, and the mma.
constexpr int TJ2 = 4;         // columns j per K2 tile
constexpr int M2 = TI * TJ2;   // pair slots per K2 tile; p = il * TJ2 + jl
constexpr int KC2 = 16;        // depth steps of a staged weight chunk
constexpr int RS2 = KC2 + 4;   // (hi, lo) pairs per staged chunk row
constexpr int kColSlots = 4;   // column partials: dnp, dforce[3]

__host__ __device__ constexpr int pad32(int q) { return (q + 31) / 32 * 32; }

// The prepared weights, in (hi, lo) pairs, n-major: block 0 We^T (F x Rp),
// 1 We (Rp x F, zero rows past R), 2-5 W1a^T, W2a^T, W1b^T, W2b^T (products
// with W), 6-9 W1a, W2a, W1b, W2b (products with W^T), F x F each.
__host__ __device__ inline size_t k2_prep_offset(int F, int R, int block) {
  const size_t fr = (size_t)F * pad32(R);
  return block < 2 ? block * fr : 2 * fr + (size_t)(block - 2) * F * F;
}

__host__ __device__ inline size_t wgrad_size(int F, int R) {
  return (size_t)R * F + (size_t)4 * F * F;
}

template <int F>
constexpr size_t bwd_smem_floats(int R) {
  return (size_t)2 * 2 * 2 * F * RS2 + (size_t)6 * M2 * (F + 4) +
         (size_t)M2 * (pad32(R) + 4) + (size_t)2 * TI * F +
         (size_t)4 * TJ2 * F + (size_t)4 * M2;
}

#ifndef NN_CUDA_EMU
// One inline-PTX site per instruction (csrc/emu/cuda_emu.h replaces these
// functions on the CPU).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
#endif

// x rounded to tf32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, from two integer operations.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__global__ void pair_bwd_prep_kernel(const float* __restrict__ We,
                                     const float* __restrict__ W1a,
                                     const float* __restrict__ W1b,
                                     const float* __restrict__ W2a,
                                     const float* __restrict__ W2b,
                                     uint2* __restrict__ out, int F, int R) {
  const int Rp = pad32(R);
  const size_t fr = (size_t)F * Rp, total = k2_prep_offset(F, R, 10);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v;
    if (e < fr) {  // We^T: n = f, q = r
      const int n = (int)(e / Rp), q = (int)(e % Rp);
      v = q < R ? We[(size_t)q * F + n] : 0.0f;
    } else if (e < 2 * fr) {  // We: n = r, q = f
      const int n = (int)((e - fr) / F), q = (int)((e - fr) % F);
      v = n < R ? We[(size_t)n * F + q] : 0.0f;
    } else {
      const size_t e2 = e - 2 * fr, ff = (size_t)F * F;
      const int k = (int)(e2 / ff), r = (int)(e2 % ff);
      const int n = r / F, q = r % F;
      const float* W = (k & 3) == 0 ? W1a : (k & 3) == 1 ? W2a
                       : (k & 3) == 2 ? W1b : W2b;
      v = k < 4 ? W[(size_t)q * F + n] : W[(size_t)n * F + q];
    }
    const unsigned hi = tf32_rna(v);
    out[e] = make_uint2(hi, tf32_rna(v - __uint_as_float(hi)));
  }
}

// Chunk ch of a prepared weight (NC rows of Qp pairs) into a ring slot: per
// row n the KC2 pairs of depth [ch*KC2, ch*KC2 + KC2) at pair n*RS2, as
// eight 16-byte cp.async copies.
template <int NC>
__device__ __forceinline__ void k2_stage(const uint2* __restrict__ Bt, int Qp,
                                         int ch, uint2* slot) {
  for (int v = threadIdx.x; v < NC * 8; v += kThreads) {
    const int n = v >> 3, part = v & 7;
    cp_async16(slot + n * RS2 + part * 2,
               Bt + (size_t)n * Qp + (size_t)ch * KC2 + part * 2);
  }
}

// For the tile's 32 slot rows m and n < NC, q < Qp (a multiple of 32), in
// 3xTF32: D1[m*ldd + n] = sum_q A1[m*lda + q] B1(q, n), and with B2
// D2[m*ldd + n] = sum_q A2[m*lda + q] B2(q, n), or with `sum` D1 = the sum
// of both. A's columns past the true depth hold zeros; B(q, n) = Bt[n*Qp +
// q] is a prepared weight. Warp w computes the 16-row half (w & 1) and
// NC/4 columns. Every warp reads every A row after the loop's first
// barrier and D is written after a barrier that follows the last read, so
// A may be written just before the call and D may be A. Ends with a
// __syncthreads. All threads of the block must call it. Not inlined.
template <int NC>
__device__ __noinline__ void k2_prod(const float* A1, const float* A2,
                                     int lda, int Qp,
                                     const uint2* __restrict__ B1,
                                     const uint2* __restrict__ B2,
                                     uint2* ring, float* D1, float* D2,
                                     int ldd, bool sum) {
  constexpr int NT = NC / 32;  // 16 x 8 tiles per warp and product
  constexpr int SLOT = 2 * NC * RS2;  // pairs per ring slot: two weights
  const bool two = B2 != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * (NC / 4);
  float tot[2][NT][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tot[x][j][0] = tot[x][j][1] = tot[x][j][2] = tot[x][j][3] = 0.0f;
  const float* A2s = two ? A2 : A1;
  const float* rows[2][2] = {
      {A1 + (size_t)(m0 + g) * lda, A1 + (size_t)(m0 + g + 8) * lda},
      {A2s + (size_t)(m0 + g) * lda, A2s + (size_t)(m0 + g + 8) * lda}};
  const int nch = Qp / KC2;
  k2_stage<NC>(B1, Qp, 0, ring);
  if (two) k2_stage<NC>(B2, Qp, 0, ring + NC * RS2);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    if (ch + 1 < nch) {
      uint2* next = ring + ((ch + 1) & 1) * SLOT;
      k2_stage<NC>(B1, Qp, ch + 1, next);
      if (two) k2_stage<NC>(B2, Qp, ch + 1, next + NC * RS2);
    }
    cp_async_commit();
    const uint2* wc = ring + (ch & 1) * SLOT;
    float d[2][NT][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        d[x][j][0] = d[x][j][1] = d[x][j][2] = d[x][j][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // two k-steps per chunk
      const int k = ch * KC2 + s * 8 + t;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (x == 1 && !two) break;
        unsigned ah[4], al[4];
        split_tf32(rows[x][0][k], ah[0], al[0]);
        split_tf32(rows[x][1][k], ah[1], al[1]);
        split_tf32(rows[x][0][k + 4], ah[2], al[2]);
        split_tf32(rows[x][1][k + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2* w = wc + (x * NC + n0 + j * 8 + g) * RS2 + s * 8 + t;
          const uint2 b0 = w[0], b1 = w[4];  // depth k, k + 4
          const unsigned bh[2] = {b0.x, b1.x}, bl[2] = {b0.y, b1.y};
          mma3(d[x][j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[x][j][e] += d[x][j][e];
  }
  __syncthreads();  // every warp is done reading A: D may overwrite it
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (x == 1 && (sum || !two)) break;
    float* D = x == 0 ? D1 : D2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // (n, n + 1) as one 8-byte store
      const int n = n0 + j * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (x == 0 && sum) ? tot[0][j][e] + tot[1][j][e] : tot[x][j][e];
      *reinterpret_cast<float2*>(D + (m0 + g) * ldd + n) =
          make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(D + (m0 + g + 8) * ldd + n) =
          make_float2(v[2], v[3]);
    }
  }
  __syncthreads();
}

// part[q*F + n] = sum_p a(p, q) B[p*(F+4) + n] over the tile's 32 slots,
// q < qrows, where a(p, q) = A[p*lda + q], or silu of it with `silu` (h
// from p), on the tensor cores in 3xTF32: warp w takes the (16-row,
// 32-column) groups w, w + 8, ... and writes each element of the block's
// partial once (part 8-byte aligned). A's columns up to the next multiple
// of 16 past qrows must be readable and finite. Starts with a
// __syncthreads. Not inlined.
template <int F>
__device__ __noinline__ void k2_wgrad(const float* __restrict__ A, int lda,
                                      int qrows, bool silu,
                                      const float* __restrict__ Bm,
                                      float* __restrict__ part) {
  constexpr int LD = F + 4;
  constexpr int NG = F / 32;  // 32-column groups per 16-row band
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  const int n_groups = (qrows + 15) / 16 * NG;
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int qa = (grp / NG) * 16 + g, qb = qa + 8;
    const int nb = (grp % NG) * 32;
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < M2; kk += 8) {
      const int p = kk + t;
      float av[4] = {A[p * lda + qa], A[p * lda + qb], A[(p + 4) * lda + qa],
                     A[(p + 4) * lda + qb]};
      unsigned ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(silu ? silu_f(av[e]) : av[e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nb + j * 8 + g;
        unsigned bh[2], bl[2];
        split_tf32(Bm[p * LD + n], bh[0], bl[0]);
        split_tf32(Bm[(p + 4) * LD + n], bh[1], bl[1]);
        mma3(d[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + j * 8 + 2 * t;
      if (qa < qrows)
        *reinterpret_cast<float2*>(part + (size_t)qa * F + n) =
            make_float2(d[j][0], d[j][1]);
      if (qb < qrows)
        *reinterpret_cast<float2*>(part + (size_t)qb * F + n) =
            make_float2(d[j][2], d[j][3]);
    }
  }
}

template <int F, bool FIRST, bool WGRAD>
__global__ void __launch_bounds__(kThreads, 1)
pair_bwd_kernel(const float* __restrict__ np_, const float* __restrict__ rbf,
                const float* __restrict__ dir, const float* __restrict__ adj,
                const float* __restrict__ force,
                const uint2* __restrict__ wprep,
                const float* __restrict__ dinv1,
                const float* __restrict__ deq, float* __restrict__ drbf,
                float* __restrict__ ddir, float* __restrict__ rowpart,
                float* __restrict__ colpart, float* __restrict__ wpart, int N,
                int R, int n_it, int n_jt) {
  constexpr int C = F / 32;
  constexpr int LD = F + 4;
  constexpr int TJ = TJ2, M = M2;
  const int Rp = pad32(R), lr = Rp + 4;
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // 2 slots x 2 weights
  float* me_s = smem + 2 * 2 * 2 * F * RS2;  // M x LD: me
  float* msg_s = me_s + M * LD;       // M x LD: msg
  float* p1_s = msg_s + M * LD;       // M x LD: p1
  float* p2_s = p1_s + M * LD;        // M x LD: p2
  float* x1_s = p2_s + M * LD;        // M x LD: h1, phi1, dphi1, dh1, dp1,
                                      //   dmsg, t
  float* x2_s = x1_s + M * LD;        // M x LD: h2, phi2, dphi2, dh2, dp2,
                                      //   dme
  float* rbf_s = x2_s + M * LD;       // M x lr: rbf, then drbf
  float* npi_s = rbf_s + M * lr;      // TI x F
  float* dinv_s = npi_s + TI * F;     // TI x F
  float* npj_s = dinv_s + TI * F;     // TJ x F
  float* fj_s = npj_s + TJ * F;       // 3 x TJ x F
  float* adj_s = fj_s + 3 * TJ * F;   // M
  float* dir_s = adj_s + M;           // 3 x M

  const int rest = blockIdx.x / n_jt, jt = blockIdx.x - rest * n_jt;
  const int b = rest / n_it, it = rest - b * n_it;
  const int i0 = it * TI, j0 = jt * TJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = i0 + warp;
  const size_t nf = (size_t)N * F;

  for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    const bool ok = i0 + il < N;
    const size_t row = ((size_t)b * N + i0 + il) * F + f;
    npi_s[idx] = ok ? np_[row] : 0.0f;
    dinv_s[idx] = ok ? dinv1[row] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    npj_s[idx] = j < N ? np_[((size_t)b * N + j) * F + f] : 0.0f;
  }
  if (!FIRST) {
    for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
      const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
      const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
      fj_s[idx] = j < N ? force[((size_t)b * 3 + d) * nf + (size_t)j * F + f]
                        : 0.0f;
    }
  }
  for (int idx = threadIdx.x; idx < 4 * M; idx += kThreads) {
    const int d = idx / M, p = idx - d * M;  // d = 0: adj, 1..3: dir
    const int ii = i0 + p / TJ, j = j0 + p % TJ;
    const bool ok = ii < N && j < N;
    if (d == 0)
      adj_s[p] = ok ? adj[((size_t)b * N + ii) * N + j] : 0.0f;
    else
      dir_s[(d - 1) * M + p] =
          ok ? dir[(((size_t)b * 3 + d - 1) * N + ii) * N + j] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < M * Rp; idx += kThreads) {
    const int p = idx / Rp, r = idx - p * Rp;
    const int ii = i0 + p / TJ, j = j0 + p % TJ;
    rbf_s[p * lr + r] = (ii < N && j < N && r < R)
                            ? rbf[(((size_t)b * N + ii) * N + j) * R + r]
                            : 0.0f;
  }
  // deq of the warp's row i, held in registers (zero past N)
  float gq[3][C];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int c = 0; c < C; ++c)
      gq[d][c] = i < N ? deq[((size_t)b * 3 + d) * nf + (size_t)i * F + lane +
                             32 * c]
                       : 0.0f;

  const uint2* WeT = wprep + k2_prep_offset(F, R, 0);
  const uint2* Wer = wprep + k2_prep_offset(F, R, 1);
  const uint2* W1aT = wprep + k2_prep_offset(F, R, 2);
  const uint2* W2aT = wprep + k2_prep_offset(F, R, 3);
  const uint2* W1bT = wprep + k2_prep_offset(F, R, 4);
  const uint2* W2bT = wprep + k2_prep_offset(F, R, 5);
  const uint2* W1a = wprep + k2_prep_offset(F, R, 6);
  const uint2* W2a = wprep + k2_prep_offset(F, R, 7);
  const uint2* W1b = wprep + k2_prep_offset(F, R, 8);
  const uint2* W2b = wprep + k2_prep_offset(F, R, 9);
  float* wp = WGRAD ? wpart + (size_t)blockIdx.x * wgrad_size(F, R) : nullptr;
  float* colb = colpart + ((size_t)b * n_it + it) * kColSlots * nf;

  // me, then msg = me np_i np_j adj
  // me, then msg = me np_i np_j adj
  k2_prod<F>(rbf_s, nullptr, lr, Rp, WeT, nullptr, ring, me_s, nullptr, LD,
             false);
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c, o = p * LD + f;
      msg_s[o] = me_s[o] * npi_s[warp * F + f] * npj_s[r * F + f] * a;
    }
  }
  // p1, p2; h = silu(p); phi = h @ Wb (the second branch is skipped at the
  // first layer: force_node is zero)
  k2_prod<F>(msg_s, msg_s, LD, F, W1aT, FIRST ? nullptr : W2aT, ring, p1_s,
             p2_s, LD, false);
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (warp * TJ + r) * LD + lane + 32 * c;
      x1_s[o] = silu_f(p1_s[o]);
      if (!FIRST) x2_s[o] = silu_f(p2_s[o]);
    }
  k2_prod<F>(x1_s, x2_s, LD, F, W1bT, FIRST ? nullptr : W2bT, ring, x1_s,
             x2_s, LD, false);
  // ddir[d,i,j] = sum_f phi1 deq[d,i]; dphi1 = sum_d deq[d,i] dir[d,i,j] adj
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
    const float d0 = dir_s[p], d1 = dir_s[M + p], d2 = dir_s[2 * M + p];
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = p * LD + lane + 32 * c;
      const float phi = x1_s[o] * a;
      s0 += phi * gq[0][c];
      s1 += phi * gq[1][c];
      s2 += phi * gq[2][c];
      x1_s[o] = (gq[0][c] * d0 + gq[1][c] * d1 + gq[2][c] * d2) * a;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const int j = j0 + r;
    if (lane == 0 && i < N && j < N) {
      ddir[(((size_t)b * 3 + 0) * N + i) * N + j] = s0;
      ddir[(((size_t)b * 3 + 1) * N + i) * N + j] = s1;
      ddir[(((size_t)b * 3 + 2) * N + i) * N + j] = s2;
    }
  }
  if (!FIRST) {
    // column part: dforce[d,j] = sum_i phi2[i,j] deq[d,i]
    for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
      const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
      if (j >= N) continue;
      float s[3] = {0.0f, 0.0f, 0.0f};
      for (int il = 0; il < TI && i0 + il < N; ++il) {
        const int p = il * TJ + jl;
        const float phi = x2_s[p * LD + f] * adj_s[p];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s[d] += phi * deq[((size_t)b * 3 + d) * nf +
                            (size_t)(i0 + il) * F + f];
      }
#pragma unroll
      for (int d = 0; d < 3; ++d)
        colb[(1 + d) * nf + (size_t)j * F + f] = s[d];
    }
    __syncthreads();  // phi2 is replaced next
    // dphi2 = sum_d deq[d,i] force[d,j] adj
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        x2_s[p * LD + f] = (gq[0][c] * fj_s[r * F + f] +
                            gq[1][c] * fj_s[(TJ + r) * F + f] +
                            gq[2][c] * fj_s[(2 * TJ + r) * F + f]) * a;
      }
    }
  }
  if (WGRAD) {  // dW1b = h1^T dphi1, dW2b = h2^T dphi2 (h = silu(p))
    k2_wgrad<F>(p1_s, LD, F, true, x1_s, wp + (size_t)R * F + F * F);
    if (!FIRST)
      k2_wgrad<F>(p2_s, LD, F, true, x2_s, wp + (size_t)R * F + 3 * F * F);
  }
  // dh = dphi @ Wb^T; dp = dh silu'(p)
  k2_prod<F>(x1_s, x2_s, LD, F, W1b, FIRST ? nullptr : W2b, ring, x1_s, x2_s,
             LD, false);
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (warp * TJ + r) * LD + lane + 32 * c;
      x1_s[o] = x1_s[o] * dsilu_f(p1_s[o]);
      if (!FIRST) x2_s[o] = x2_s[o] * dsilu_f(p2_s[o]);
    }
  if (WGRAD) {  // dW1a = msg^T dp1, dW2a = msg^T dp2
    k2_wgrad<F>(msg_s, LD, F, false, x1_s, wp + (size_t)R * F);
    if (!FIRST)
      k2_wgrad<F>(msg_s, LD, F, false, x2_s, wp + (size_t)R * F + 2 * F * F);
  }
  // dmsg = dp1 @ W1a^T + dp2 @ W2a^T
  k2_prod<F>(x1_s, x2_s, LD, F, W1a, FIRST ? nullptr : W2a, ring, x1_s,
             nullptr, LD, true);

  // dmsg4 = (dmsg + dinv1_i) adj; t = dmsg4 me: row part of dnp (t np_j),
  // column part (t np_i); dme = dmsg4 np_i np_j
  float dnp_acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dnp_acc[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c, o = p * LD + f;
      const float d4 = (x1_s[o] + dinv_s[warp * F + f]) * a;
      const float t = d4 * me_s[o];
      const float nj = npj_s[r * F + f];
      dnp_acc[c] += t * nj;
      x1_s[o] = t;
      x2_s[o] = d4 * npi_s[warp * F + f] * nj;  // dme
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    if (j >= N) continue;
    float s = 0.0f;
    for (int il = 0; il < TI; ++il)
      s += x1_s[(il * TJ + jl) * LD + f] * npi_s[il * F + f];
    colb[(size_t)j * F + f] = s;
  }
  if (WGRAD) k2_wgrad<F>(rbf_s, lr, R, false, x2_s, wp);  // dWe = rbf^T dme
  // drbf = dme @ We^T, 32 columns r at a time, into rbf_s
  for (int cb = 0; cb < Rp; cb += 32)
    k2_prod<32>(x2_s, nullptr, LD, F, Wer + (size_t)cb * F, nullptr, ring,
                rbf_s + cb, nullptr, lr, false);
  for (int idx = threadIdx.x; idx < M * R; idx += kThreads) {
    const int p = idx / R, r = idx - p * R;
    const int ii = i0 + p / TJ, j = j0 + p % TJ;
    if (ii < N && j < N)
      drbf[(((size_t)b * N + ii) * N + j) * R + r] = rbf_s[p * lr + r];
  }

  // this tile's row part of dnp over j
  if (i < N) {
    float* rp = rowpart + ((size_t)b * n_jt + jt) * nf + (size_t)i * F;
#pragma unroll
    for (int c = 0; c < C; ++c) rp[lane + 32 * c] = dnp_acc[c];
  }
}

// dnp = sum_jt rowpart[., jt] + sum_it colpart[., it, 0]; dforce[d] =
// sum_it colpart[., it, 1+d] (zero at the first layer). Fixed summation
// order.
__global__ void pair_bwd_nodesum_kernel(float* __restrict__ dnp,
                                        float* __restrict__ dforce,
                                        const float* __restrict__ rowpart,
                                        const float* __restrict__ colpart,
                                        int B, int N, int F, int n_it,
                                        int n_jt, int first) {
  const size_t nf = (size_t)N * F;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nf) return;
  const size_t b = idx / nf, rem = idx - b * nf;
  float s[kColSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int jt = 0; jt < n_jt; ++jt) s[0] += rowpart[(b * n_jt + jt) * nf + rem];
  for (int it = 0; it < n_it; ++it) {
    const float* c = colpart + (b * n_it + it) * kColSlots * nf + rem;
    s[0] += c[0];
    if (!first)
      for (int k = 1; k < kColSlots; ++k) s[k] += c[k * nf];
  }
  dnp[idx] = s[0];
  for (int d = 0; d < 3; ++d) dforce[(b * 3 + d) * nf + rem] = s[1 + d];
}

// out[e] = sum_blk part[blk, e] for e < n_valid; 0 for the rest (the
// first layer's W2a/W2b). Fixed summation order.
__global__ void pair_bwd_wsum_kernel(float* __restrict__ out,
                                     const float* __restrict__ part,
                                     int n_blocks, size_t n, size_t n_valid) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  if (e < n_valid)
    for (int k = 0; k < n_blocks; ++k) s += part[(size_t)k * n + e];
  out[e] = s;
}

// Scratch of one K2 launch, in floats: the prepared weights, the row and
// column partials and, with weight cotangents, one partial per block.
size_t bwd_scratch_floats(int B, int N, int F, int R, bool wgrad) {
  const size_t n_it = (N + TI - 1) / TI, n_jt = (N + TJ2 - 1) / TJ2;
  const size_t nf = (size_t)N * F;
  return 2 * k2_prep_offset(F, R, 10) + B * n_jt * nf +
         B * n_it * kColSlots * nf +
         (wgrad ? B * n_it * n_jt * wgrad_size(F, R) : 0);
}

template <int F, bool FIRST>
cudaError_t launch_fwd(const float* np_, const float* rbf, const float* dir,
                       const float* adj, const float* force, const float* We,
                       const float* W1a, const float* W1b, const float* W2a,
                       const float* W2b, float* inv1, float* eq, int B, int N,
                       int R, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<F>(R) * sizeof(float);
  auto kern = pair_fwd_kernel<F, FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (N + TI - 1) / TI;
  kern<<<B * n_itiles, kThreads, smem, stream>>>(
      np_, rbf, dir, adj, force, We, W1a, W1b, W2a, W2b, inv1, eq, N, R,
      n_itiles);
  return cudaGetLastError();
}

// in: the ten inputs of K1 then dinv1, deq; out: dnp, drbf, ddir, dforce,
// dw.
template <int F, bool FIRST, bool WGRAD>
cudaError_t launch_bwd(const float* const* in, float* const* out,
                       float* scratch, int B, int N, int R,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<F>(R) * sizeof(float);
  auto kern = pair_bwd_kernel<F, FIRST, WGRAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_it = (N + TI - 1) / TI, n_jt = (N + TJ2 - 1) / TJ2;
  const size_t nf = (size_t)N * F;
  uint2* wprep = reinterpret_cast<uint2*>(scratch);
  float* rowpart = scratch + 2 * k2_prep_offset(F, R, 10);
  float* colpart = rowpart + (size_t)B * n_jt * nf;
  float* wpart = colpart + (size_t)B * n_it * kColSlots * nf;
  const size_t want = (k2_prep_offset(F, R, 10) + 255) / 256;
  pair_bwd_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                         stream>>>(in[5], in[6], in[7], in[8], in[9], wprep,
                                   F, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_blocks = B * n_it * n_jt;
  kern<<<n_blocks, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], wprep, in[10], in[11], out[1],
      out[2], rowpart, colpart, wpart, N, R, n_it, n_jt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((size_t)B * nf + 255) / 256);
  pair_bwd_nodesum_kernel<<<grid, 256, 0, stream>>>(
      out[0], out[3], rowpart, colpart, B, N, F, n_it, n_jt, FIRST ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || !WGRAD) return err;
  const size_t n = wgrad_size(F, R);
  const size_t n_valid = FIRST ? (size_t)R * F + 2 * (size_t)F * F : n;
  pair_bwd_wsum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      out[4], wpart, n_blocks, n, n_valid);
  return cudaGetLastError();
}

template <int F>
cudaError_t dispatch_bwd(bool first, bool wgrad, const float* const* in,
                         float* const* out, float* scratch, int B, int N,
                         int R, cudaStream_t s) {
#define NN_BWD(FI, WG) \
  return launch_bwd<F, FI, WG>(in, out, scratch, B, N, R, s)
  if (first) {
    if (wgrad) NN_BWD(true, true);
    NN_BWD(true, false);
  }
  if (wgrad) NN_BWD(false, true);
  NN_BWD(false, false);
#undef NN_BWD
}

}  // namespace

extern "C" {

// K1. Shapes: np (B,N,F), rbf (B,N,N,R), dir (B,3,N,N), adj (B,N,N),
// force (B,3,N,F), We (R,F), W* (F,F) -> inv1 (B,N,F), eq (B,3,N,F); all
// fp32, contiguous, on the device of `stream`. F must be 32, 64 or 128.
int nn_pair_fwd(const float* np_, const float* rbf, const float* dir,
                const float* adj, const float* force, const float* We,
                const float* W1a, const float* W1b, const float* W2a,
                const float* W2b, float* inv1, float* eq, int B, int N, int F,
                int R, int first_layer, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NN_FWD(FF)                                                            \
  return first_layer ? launch_fwd<FF, true>(np_, rbf, dir, adj, force, We,    \
                                            W1a, W1b, W2a, W2b, inv1, eq, B,  \
                                            N, R, s)                          \
                     : launch_fwd<FF, false>(np_, rbf, dir, adj, force, We,   \
                                             W1a, W1b, W2a, W2b, inv1, eq, B, \
                                             N, R, s)
  switch (F) {
    case 32: NN_FWD(32);
    case 64: NN_FWD(64);
    case 128: NN_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NN_FWD
}

// K2. Inputs of K1 plus dinv1 (B,N,F), deq (B,3,N,F). Outputs dnp (B,N,F),
// drbf (B,N,N,R), ddir (B,3,N,N), dforce (B,3,N,F) and, with weight_grads,
// dw (R*F+4F^2: dWe, dW1a, dW1b, dW2a, dW2b one after the other; else
// unused). Scratch: 16-byte aligned, nn_pair_scratch_floats(B, N, F, R,
// weight_grads) floats.
int nn_pair_bwd(const float* np_, const float* rbf, const float* dir,
                const float* adj, const float* force, const float* We,
                const float* W1a, const float* W1b, const float* W2a,
                const float* W2b, const float* dinv1, const float* deq,
                float* dnp, float* drbf, float* ddir, float* dforce,
                float* dw, float* scratch, int B, int N, int F, int R,
                int first_layer, int weight_grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool first = first_layer != 0, wgrad = weight_grads != 0;
  const float* in[12] = {np_, rbf, dir, adj, force, We,
                         W1a, W1b, W2a, W2b, dinv1, deq};
  float* out[5] = {dnp, drbf, ddir, dforce, dw};
#define NN_BWD_F(FF) \
  return (int)dispatch_bwd<FF>(first, wgrad, in, out, scratch, B, N, R, s)
  switch (F) {
    case 32: NN_BWD_F(32);
    case 64: NN_BWD_F(64);
    case 128: NN_BWD_F(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef NN_BWD_F
}

// Scratch of one K2 launch without (kind 0) or with (kind 1) weight
// cotangents, in floats.
size_t nn_pair_scratch_floats(int B, int N, int F, int R, int kind) {
  return bwd_scratch_floats(B, N, F, R, kind != 0);
}

}  // extern "C"
