// Dual (primal + position tangent) fused pair-interaction layer for Hopper
// (sm_90a): the parameter-gradient path of force training.
//
// Replaces the TPU kernels newtonnet_tpu/ops/pallas_dense.py:
// _dual_fwd_kernel (K3) and _dual_bwd_kernel (K4). Both are templated on
// the padded feature width F (a multiple of 32), on FIRST (the stack's
// first layer, where force, forcedot and npdot are zero: the phi2 branch
// and every npdot term are skipped, and K4's dforce, dforcedot, dnpdot,
// dW2a and dW2b are exact zeros) and on BF (bf16 mode). R (radial basis
// size), N (atoms) and the tensors' true width Fg (1 <= Fg <= F) are
// runtime.
//
// Any width: the tiles hold F columns, every F-wide tensor is read at its
// true width Fg with the pad lanes zero-filled, and the weight preparation
// writes zero pad rows and columns (a zero rounds to a zero bf16), so the
// pad lanes of every slot buffer stay zero (silu(0) = 0) and change no
// sum. The cross-block partials are kept at F in the scratch; the kernels
// that sum them write the outputs at Fg.
//
// Computation, per molecule and pair slot (i, j), primal and tangent:
//     me = rbf @ We, medot = rbfdot @ We
//     msg = me np_i np_j adj,  msgdot = (medot np_i np_j + me npdot_i np_j
//                                        + me np_i npdot_j) adj
//     p = msg @ Wa, pdot = msgdot @ Wa, h = silu(p), hdot = silu'(p) pdot
//     phi = (h @ Wb) adj, phidot = (hdot @ Wb) adj        (branches 1, 2)
//     K3: inv1 = sum_j msg, inv1dot = sum_j msgdot,
//         eq[d] = sum_j phi1 dir[d] + phi2 force_j[d],
//         eqdot[d] = sum_j phi1dot dir + phi1 dirdot + phi2dot force_j
//                    + phi2 forcedot_j
//     K4: the reverse of K3 given (di, dq, didot, dqdot): dnp, dnpdot,
//         dforce, dforcedot and the five weight cotangents, summed over
//         every molecule. rbf/dir cotangents are not produced (the
//         geometry is constant in the surrogate train/fastgrad.py builds).
//
// What bounds it on this card: operations. Per pair slot K3 does
// 16F^2 + 4RF flops of matrix products and K4 44F^2 + 8RF (276 and 737
// kflop at F=128, R=20) against 2R+8 floats of pair data read. At the
// training shape (B=10, N=24: 5,760 slots) that is 4.35 GFLOP per
// full-layer K4, a few microseconds of the bf16 tensor cores: the time is
// latency, and the design is about keeping every SM busy.
//
// Design.
// * Grid: one block of 8 warps per (molecule, tile of TI=8 rows i, tile
//   of TJ=4 columns j), M=32 pair slots: B * ceil(N/8) * ceil(N/4) blocks,
//   180 at the training shape for 132 SMs. Warp w owns the TJ slots of row
//   i0+w and lane l the feature columns l+32c in the elementwise chain.
// * Products on the tensor cores (tc_pair): each weight is used by two
//   products with the same B (me/medot, p/pdot, phi/phidot, dh/dhdot,
//   dmsg/dmsgdot), so one call computes both, 32 x Q @ Q x F each, warp w
//   taking the 16-row half (w & 1) and F/4 columns. bf16 mode:
//   mma.sync m16n8k16 bf16 -> fp32; fp32 mode: mma.sync m16n8k8 tf32 in
//   3xTF32 (hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi; tf32
//   rounding by integer ops). Plain 1xTF32 is not used.
// * Weights: a small kernel rounds (bf16) or copies (fp32) the five
//   weights once per launch into the n-major layout the B fragments read,
//   W^T for a product with W and W for one with W^T, the depth padded with
//   zeros to a multiple of 32 (prep_weights). A product stages its weight
//   by cp.async in a two-slot ring of 64-byte chunk rows (32 bf16 or 16
//   fp32 of depth) at a stride of 20 words, so the B fragments' 32 lanes
//   hit 32 banks; the next chunk loads while the current one multiplies.
// * Summing: each chunk's products accumulate in a fresh tensor-core
//   accumulator and are added to the running sum on the CUDA cores (the
//   tensor cores' fp32 accumulation drops bits against a large addend).
// * Weight cotangents (wgrad_pair) on the same tensor cores: A^T over the
//   slot axis read transposed from the fp32 slot buffers; each block
//   writes its partial of R*F + 4F^2 floats once (266 KB at F=128, R=20;
//   180 partials, 48 MB, summed by dual_bwd_wsum_kernel in a fixed order).
// * Sums that cross blocks: K3's row sums over j and K4's row parts
//   (dnp, dnpdot) go to per-(molecule, j-tile) partials, K4's column parts
//   over i (dnp, dnpdot, dforce, dforcedot) to per-(molecule, i-tile)
//   partials; dual_fwd_rowsum_kernel / dual_bwd_nodesum_kernel add them
//   in a fixed order. No float atomics: a run gives the same bits every
//   time.
// * Occupancy: K4's block holds 8 fp32 slot buffers (msg, msgdot, p, pdot,
//   h, hdot, g, gdot) and takes 199 KB of shared memory at F=128, R=20
//   (K3 157 KB), and about 220 registers a thread: one block per SM, so
//   the 180 blocks run in two waves (180 / 264 of the SM time).
// * Past F=128 (wide) a tile has TJ=2 columns, M=16 pair slots (each warp
//   takes all 16 rows and an eighth of the columns of a product), so that
//   K4 fits: 225 KB at F=256, R=20 in bf16 mode.
// * Code size: tc_pair and wgrad_pair are out of line (__noinline__), one
//   copy per (F, BF), so that the kernels fit the instruction cache.
//
// Precision. With BF every operand of every matrix product is rounded to
// bf16 (round to nearest even) where the JAX package's `dot`/`dotT` round
// it (pallas_dense.py :267-269, :369-378): the weights once per launch,
// the slot operands (rbf, msg, h, g, dp, dme and their tangents) when a
// fragment is loaded (cvt.rn.bf16x2.f32; rounding is idempotent, so where
// it happens does not change the value). Products of two bf16 values are
// exact in fp32 and summed in fp32; all elementwise arithmetic stays fp32,
// on the fp32 slot buffers. The kernels and the plain versions
// (ops/fused_dual.py) differ only in summation order.
//
// The host functions return the cudaError_t of the launches; the scratch
// sizes come from nn_dual_scratch_floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TI = kWarps;   // rows i per tile: one per warp
// Columns j per tile (all held by one warp) and pair slots per tile (slot
// p = il * TJ + jl) at a padded width F: 4 and 32, and past 128 (wide) 2
// and 16, so that the slot buffers fit the shared memory.
template <int F>
constexpr int kTJ = F > 128 ? 2 : 4;
template <int F>
constexpr int kM = TI * kTJ<F>;
constexpr int kRowSlotsFwd = 8;  // K3 row partials: inv1, inv1dot, eq[3],
                                 // eqdot[3]
constexpr int kRowSlotsBwd = 2;  // K4 row partials: dnp, dnpdot
constexpr int kColSlots = 8;     // K4 column partials: dnp, dnpdot,
                                 // dforce[3], dforcedot[3]
constexpr int KW = 20;       // 32-bit words per staged chunk row: 16 + 4
constexpr int kStages = 2;   // chunk slots of the weight ring

__host__ __device__ constexpr int pad32(int q) { return (q + 31) / 32 * 32; }

// A library runs one padded width, NN_WIDTH: either that width exactly
// (Fg == F, the masks of the pad lanes folded away at compile time) or,
// built with NN_PADDED, the widths below it that pad to it (ops/_build.py
// builds one per (padded width, padded) at the first call of such a
// width: width_flags).
#ifndef NN_WIDTH
#error "build with -DNN_WIDTH=<padded width> (ops/_build.py: width_flags)"
#endif
#ifdef NN_PADDED
constexpr bool kPadded = true;
#else
constexpr bool kPadded = false;
#endif
constexpr int kMaxWidth = 256;  // the widest F the kernels take

// The padded width a true width F runs at: the next multiple of 32, and
// past 128 of 64 (the wide tiles split their columns eight ways).
__host__ __device__ constexpr int padded_width(int F) {
  return F > 128 ? (F + 63) / 64 * 64 : (F + 31) / 32 * 32;
}

// Whether this library runs width F.
__host__ __device__ constexpr bool library_runs(int F) {
  return F >= 1 && F <= kMaxWidth && padded_width(F) == NN_WIDTH &&
         (F != NN_WIDTH) == kPadded;
}

// Index of element (row, f) of an (rows, Fg) tensor in its copy at padded
// width F, for the partials and weight cotangents the scratch keeps at F.
__host__ __device__ inline size_t padded_at(size_t e, int Fg, int F) {
  return kPadded ? e / Fg * F + e % Fg : e;
}

template <int F, bool BF>
struct Shape {
  static constexpr int LD = F + (BF ? 8 : 4);  // slot buffers (M x LD)
  static constexpr int KC = BF ? 32 : 16;      // depth of a weight chunk
  static constexpr int ES = BF ? 2 : 4;        // bytes of a weight element
  static constexpr int RING = F * KW;          // words per ring slot
};

// Row stride of the staged rbf and rbfdot (M x ldr, zero past R).
__host__ __device__ constexpr int ldr(int R, bool bf) {
  return pad32(R) + (bf ? 8 : 4);
}

// The prepared weights, in elements of the mode's type, n-major with the
// depth contiguous: block 0 is We^T (F x pad32(R)), blocks 1-8 are F x F:
// W1a^T, W1b^T, W2a^T, W2b^T (products with W), then W1a, W1b, W2a, W2b
// (products with W^T).
__host__ __device__ inline size_t prep_offset(int F, int R, int block) {
  return block == 0 ? 0
                    : (size_t)F * pad32(R) + (size_t)(block - 1) * F * F;
}
__host__ __device__ inline size_t prep_floats(int F, int R) {
  return prep_offset(F, R, 9);
}

__host__ __device__ inline size_t wgrad_size(int F, int R) {
  return (size_t)R * F + (size_t)4 * F * F;
}

// Element e of the weight cotangents at width Fg (dWe, dW1a, dW1b, dW2a,
// dW2b one after the other) in a block's partial at width F.
__host__ __device__ inline size_t wgrad_padded_at(size_t e, int R, int F,
                                                  int Fg) {
  if (!kPadded) return e;
  const size_t rf = (size_t)R * Fg, ff = (size_t)Fg * Fg;
  if (e < rf) return padded_at(e, Fg, F);
  const size_t k = (e - rf) / ff;
  return (size_t)R * F + k * F * F + padded_at(e - rf - k * ff, Fg, F);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f + x * (1.0f - s));
}
__device__ __forceinline__ float d2silu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f - s) * (2.0f + x * (1.0f - 2.0f * s));
}

#ifndef NN_CUDA_EMU
// One inline-PTX site per instruction (csrc/emu/cuda_emu.h replaces these
// functions on the CPU; mma_bf16 is bf16_mma.cuh's).
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

// The prepared weights (prep_offset's layout) from We, W1a, W1b, W2a, W2b,
// rounded to bf16 with BF, else copied; zeros past R in We^T's depth.
template <bool BF>
__device__ void prep_weights(const float* __restrict__ We,
                             const float* __restrict__ W1a,
                             const float* __restrict__ W1b,
                             const float* __restrict__ W2a,
                             const float* __restrict__ W2b, void* out, int F,
                             int Fg, int R) {
  const int Rp = pad32(R);
  const size_t n_e = (size_t)F * Rp, total = prep_floats(F, R);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v;
    if (e < n_e) {
      const int n = (int)(e / Rp), q = (int)(e % Rp);
      v = q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f;
    } else {
      const size_t e2 = e - n_e, ff = (size_t)F * F;
      const int k = (int)(e2 / ff), r = (int)(e2 % ff);
      const int n = r / F, q = r % F;
      const float* W = (k & 3) == 0 ? W1a : (k & 3) == 1 ? W1b
                       : (k & 3) == 2 ? W2a : W2b;
      v = n >= Fg || q >= Fg ? 0.0f
          : k < 4            ? W[(size_t)q * Fg + n]
                             : W[(size_t)n * Fg + q];
    }
    if constexpr (BF)
      static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[e] = v;
  }
}

template <bool BF>
__global__ void dual_fwd_prep_kernel(const float* We, const float* W1a,
                                     const float* W1b, const float* W2a,
                                     const float* W2b, void* out, int F,
                                     int Fg, int R) {
  prep_weights<BF>(We, W1a, W1b, W2a, W2b, out, F, Fg, R);
}
template <bool BF>
__global__ void dual_bwd_prep_kernel(const float* We, const float* W1a,
                                     const float* W1b, const float* W2a,
                                     const float* W2b, void* out, int F,
                                     int Fg, int R) {
  prep_weights<BF>(We, W1a, W1b, W2a, W2b, out, F, Fg, R);
}

// Chunk ch of a prepared weight (F rows of Qp elements) into a ring slot:
// per row n the 64 bytes of depth [ch*KC, ch*KC + KC) at word n*KW, as
// four 16-byte cp.async copies.
template <int F, bool BF>
__device__ __forceinline__ void stage_chunk(const char* __restrict__ Bt,
                                            int Qp, int ch, unsigned* slot) {
  using S = Shape<F, BF>;
  for (int v = threadIdx.x; v < F * 4; v += kThreads) {
    const int n = v >> 2, part = v & 3;
    cp_async16(slot + n * KW + part * 4,
               Bt + ((size_t)n * Qp + (size_t)ch * S::KC) * S::ES + part * 16);
  }
}

// D1[m*LD + n] = sum_q A1[m*lda + q] B(q, n) and D2 likewise from A2, for
// the tile's M slot rows m and n < F, q < Qp (Qp a multiple of 32; A's
// columns past the true depth hold zeros). Bt is the prepared weight:
// B(q, n) = Bt[n*Qp + q]. Warp w computes the 16-row group w % RG and F/CG
// columns (RG = M/16 groups, CG = 8/RG: the 16-row half (w & 1) and F/4
// columns, and past F=128 all 16 rows and F/8 columns). Each chunk
// accumulates in fresh tensor-core registers and is added to the running
// sum on the CUDA cores. A1 and A2 are read by every
// warp, so they must be written before the call; D1 and D2 are written at
// its end and must be free during it (neither may be A1 or A2). Ends with
// a __syncthreads, after which the D rows may be read by any thread. All
// threads of the block must call it. Not inlined (code size).
template <int F, bool BF>
__device__ __noinline__ void tc_pair(const float* __restrict__ A1,
                                     const float* __restrict__ A2, int lda,
                                     int Qp, const void* Bt_,
                                     unsigned* ring, float* __restrict__ D1,
                                     float* __restrict__ D2) {
  using S = Shape<F, BF>;
  constexpr int RG = kM<F> / 16;  // 16-row groups
  constexpr int CG = kWarps / RG;  // column groups: F/CG columns a warp
  constexpr int NT = F / (8 * CG);  // 16 x 8 tiles per warp and product
  const char* Bt = static_cast<const char*>(Bt_);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % RG) * 16, n0 = (warp / RG) * (F / CG);
  float tot[2][NT][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tot[x][j][0] = tot[x][j][1] = tot[x][j][2] = tot[x][j][3] = 0.0f;
  const float* rows[2][2] = {
      {A1 + (size_t)(m0 + g) * lda, A1 + (size_t)(m0 + g + 8) * lda},
      {A2 + (size_t)(m0 + g) * lda, A2 + (size_t)(m0 + g + 8) * lda}};
  const int nch = Qp / S::KC;
  stage_chunk<F, BF>(Bt, Qp, 0, ring);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    if (ch + 1 < nch)
      stage_chunk<F, BF>(Bt, Qp, ch + 1, ring + ((ch + 1) % kStages) * S::RING);
    cp_async_commit();
    const unsigned* wc = ring + (ch % kStages) * S::RING;
    float d[2][NT][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        d[x][j][0] = d[x][j][1] = d[x][j][2] = d[x][j][3] = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // two k-steps per chunk
      if constexpr (BF) {
        const int k = ch * S::KC + s * 16 + 2 * t;
        unsigned a[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float2 v0 = *reinterpret_cast<const float2*>(rows[x][0] + k);
          const float2 v1 = *reinterpret_cast<const float2*>(rows[x][1] + k);
          const float2 v2 =
              *reinterpret_cast<const float2*>(rows[x][0] + k + 8);
          const float2 v3 =
              *reinterpret_cast<const float2*>(rows[x][1] + k + 8);
          a[x][0] = pack_bf16(v0.x, v0.y);
          a[x][1] = pack_bf16(v1.x, v1.y);
          a[x][2] = pack_bf16(v2.x, v2.y);
          a[x][3] = pack_bf16(v3.x, v3.y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned* w = wc + (n0 + j * 8 + g) * KW + s * 8 + t;
          const unsigned b[2] = {w[0], w[4]};
          mma_bf16(d[0][j], a[0], b);
          mma_bf16(d[1][j], a[1], b);
        }
      } else {
        const int k = ch * S::KC + s * 8 + t;
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          split_tf32(rows[x][0][k], ah[x][0], al[x][0]);
          split_tf32(rows[x][1][k], ah[x][1], al[x][1]);
          split_tf32(rows[x][0][k + 4], ah[x][2], al[x][2]);
          split_tf32(rows[x][1][k + 4], ah[x][3], al[x][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned* w = wc + (n0 + j * 8 + g) * KW + s * 8 + t;
          unsigned bh[2], bl[2];
          split_tf32(__uint_as_float(w[0]), bh[0], bl[0]);
          split_tf32(__uint_as_float(w[4]), bh[1], bl[1]);
          mma3(d[0][j], ah[0], al[0], bh, bl);
          mma3(d[1][j], ah[1], al[1], bh, bl);
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
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float* D = x == 0 ? D1 : D2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      D[(m0 + g) * S::LD + n] = tot[x][j][0];
      D[(m0 + g) * S::LD + n + 1] = tot[x][j][1];
      D[(m0 + g + 8) * S::LD + n] = tot[x][j][2];
      D[(m0 + g + 8) * S::LD + n + 1] = tot[x][j][3];
    }
  }
  __syncthreads();
}

// part[q*F + n] = sum_p A1[p*lda + q] B1[p*LD + n] + A2[p*lda + q]
// B2[p*LD + n] over the tile's M slots, q < qrows, on the tensor cores
// (bf16, or 3xTF32): warp w takes the (16-row, 32-column) groups w, w + 8,
// ...; each source sums its 32 slots in the tensor cores and the two are
// added on the CUDA cores. A's columns up to the next multiple of 16 past
// qrows must be readable and finite (zeros). Every element of the block's
// partial is written once (part 8-byte aligned, F even). Starts with a
// __syncthreads. Not inlined.
template <int F, bool BF>
__device__ __noinline__ void wgrad_pair(const float* __restrict__ A1,
                                        const float* __restrict__ B1,
                                        const float* __restrict__ A2,
                                        const float* __restrict__ B2,
                                        int lda, int qrows,
                                        float* __restrict__ part) {
  constexpr int M = kM<F>;
  constexpr int LD = Shape<F, BF>::LD;
  constexpr int NG = F / 32;  // 32-column groups per 16-row band
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  const int n_groups = (qrows + 15) / 16 * NG;
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int qa = (grp / NG) * 16 + g, qb = qa + 8;
    const int nb = (grp % NG) * 32;
    float d[2][4][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[x][j][0] = d[x][j][1] = d[x][j][2] = d[x][j][3] = 0.0f;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float* A = x == 0 ? A1 : A2;
      const float* B = x == 0 ? B1 : B2;
      if constexpr (BF) {
#pragma unroll
        for (int kk = 0; kk < M; kk += 16) {
          const int p = kk + 2 * t;
          const unsigned a[4] = {
              pack_bf16(A[p * lda + qa], A[(p + 1) * lda + qa]),
              pack_bf16(A[p * lda + qb], A[(p + 1) * lda + qb]),
              pack_bf16(A[(p + 8) * lda + qa], A[(p + 9) * lda + qa]),
              pack_bf16(A[(p + 8) * lda + qb], A[(p + 9) * lda + qb])};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = nb + j * 8 + g;
            const unsigned b[2] = {
                pack_bf16(B[p * LD + n], B[(p + 1) * LD + n]),
                pack_bf16(B[(p + 8) * LD + n], B[(p + 9) * LD + n])};
            mma_bf16(d[x][j], a, b);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < M; kk += 8) {
          const int p = kk + t;
          unsigned ah[4], al[4];
          split_tf32(A[p * lda + qa], ah[0], al[0]);
          split_tf32(A[p * lda + qb], ah[1], al[1]);
          split_tf32(A[(p + 4) * lda + qa], ah[2], al[2]);
          split_tf32(A[(p + 4) * lda + qb], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = nb + j * 8 + g;
            unsigned bh[2], bl[2];
            split_tf32(B[p * LD + n], bh[0], bl[0]);
            split_tf32(B[(p + 4) * LD + n], bh[1], bl[1]);
            mma3(d[x][j], ah, al, bh, bl);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // (n, n + 1) as one 8-byte store
      const int n = nb + j * 8 + 2 * t;
      if (qa < qrows)
        *reinterpret_cast<float2*>(part + (size_t)qa * F + n) = make_float2(
            d[0][j][0] + d[1][j][0], d[0][j][1] + d[1][j][1]);
      if (qb < qrows)
        *reinterpret_cast<float2*>(part + (size_t)qb * F + n) = make_float2(
            d[0][j][2] + d[1][j][2], d[0][j][3] + d[1][j][3]);
    }
  }
}

// Row-side inputs of the tile's TI rows (zero past N and past Fg): TI x F
// each, from rows of Fg.
__device__ void load_rows(const float* __restrict__ src, int b, int i0,
                          int N, int F, int Fg, float* dst) {
  for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    dst[idx] = i0 + il < N && f < Fg
                   ? src[((size_t)b * N + i0 + il) * Fg + f]
                   : 0.0f;
  }
}

// The tile's column-side inputs: np_j and, unless FIRST, npdot_j, force_j
// and forcedot_j; the per-slot adj, dir, dirdot, rbf and rbfdot (rows of
// stride lr, zeros from R to pad32(R)). Slots outside the molecule read as
// zero, so they contribute nothing and stay finite (silu(0) = 0).
template <int F, bool FIRST>
__device__ void load_tile(const float* __restrict__ np_,
                          const float* __restrict__ npdot,
                          const float* __restrict__ rbf,
                          const float* __restrict__ rbfdot,
                          const float* __restrict__ dir,
                          const float* __restrict__ dirdot,
                          const float* __restrict__ adj,
                          const float* __restrict__ force,
                          const float* __restrict__ forcedot, int b, int i0,
                          int j0, int N, int Fg, int R, int lr,
                          float* npj_s,
                          float* npdotj_s, float* fj_s, float* fjdot_s,
                          float* adj_s, float* dir_s, float* dirdot_s,
                          float* rbf_s, float* rbfdot_s) {
  constexpr int TJ = kTJ<F>, M = kM<F>;
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    const bool ok = j < N && f < Fg;
    const size_t at = ((size_t)b * N + j) * Fg + f;
    npj_s[idx] = ok ? np_[at] : 0.0f;
    if (!FIRST) npdotj_s[idx] = ok ? npdot[at] : 0.0f;
  }
  if (!FIRST) {
    for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
      const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
      const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
      const bool ok = j < N && f < Fg;
      const size_t at = (((size_t)b * 3 + d) * N + j) * Fg + f;
      fj_s[idx] = ok ? force[at] : 0.0f;
      fjdot_s[idx] = ok ? forcedot[at] : 0.0f;
    }
  }
  for (int idx = threadIdx.x; idx < 7 * M; idx += kThreads) {
    const int d = idx / M, p = idx - d * M;  // 0: adj, 1-3: dir, 4-6: dirdot
    const int i = i0 + p / TJ, j = j0 + p % TJ;
    const bool ok = i < N && j < N;
    if (d == 0) {
      adj_s[p] = ok ? adj[((size_t)b * N + i) * N + j] : 0.0f;
    } else if (d < 4) {
      dir_s[(d - 1) * M + p] =
          ok ? dir[(((size_t)b * 3 + d - 1) * N + i) * N + j] : 0.0f;
    } else {
      dirdot_s[(d - 4) * M + p] =
          ok ? dirdot[(((size_t)b * 3 + d - 4) * N + i) * N + j] : 0.0f;
    }
  }
  const int Rp = pad32(R);
  for (int idx = threadIdx.x; idx < M * Rp; idx += kThreads) {
    const int p = idx / Rp, r = idx - p * Rp;
    const int i = i0 + p / TJ, j = j0 + p % TJ;
    const bool ok = i < N && j < N && r < R;
    const size_t at = (((size_t)b * N + i) * N + j) * R + r;
    rbf_s[p * lr + r] = ok ? rbf[at] : 0.0f;
    rbfdot_s[p * lr + r] = ok ? rbfdot[at] : 0.0f;
  }
}

// msg and msgdot of the warp's own slots into msg_s / msgdot_s from me and
// medot (me_s, medot_s: tc_pair's output).
template <int F, bool FIRST, bool BF>
__device__ void messages(const float* me_s, const float* medot_s,
                         const float* npi_s, const float* npdoti_s,
                         const float* npj_s, const float* npdotj_s,
                         const float* adj_s, float* msg_s, float* msgdot_s) {
  constexpr int TJ = kTJ<F>;
  constexpr int C = F / 32;
  constexpr int LD = Shape<F, BF>::LD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c, o = p * LD + f;
      const float ai = npi_s[warp * F + f], aj = npj_s[r * F + f];
      const float me = me_s[o];
      msg_s[o] = me * ai * aj * a;
      float v = medot_s[o] * ai * aj;
      if (!FIRST)
        v = v + me * npdoti_s[warp * F + f] * aj + me * ai * npdotj_s[r * F + f];
      msgdot_s[o] = v * a;
    }
  }
}

// (b, it, jt) of this block: blockIdx.x = (b * n_it + it) * n_jt + jt.
struct Tile {
  int b, it, jt;
  __device__ Tile(int n_it, int n_jt) {
    const int rest = blockIdx.x / n_jt;
    jt = blockIdx.x - rest * n_jt;
    b = rest / n_it;
    it = rest - b * n_it;
  }
};

// ------------------------------------------------------------------ K3 --
template <int F, bool BF>
constexpr size_t fwd_smem_floats(int R) {
  constexpr int TJ = kTJ<F>, M = kM<F>;
  return (size_t)kStages * Shape<F, BF>::RING +
         (size_t)6 * M * Shape<F, BF>::LD + (size_t)2 * TI * F +
         (size_t)8 * TJ * F + (size_t)7 * M + (size_t)2 * M * ldr(R, BF);
}

template <int F, bool FIRST, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
dual_fwd_kernel(const float* __restrict__ np_, const float* __restrict__ npdot,
                const float* __restrict__ rbf,
                const float* __restrict__ rbfdot,
                const float* __restrict__ dir,
                const float* __restrict__ dirdot,
                const float* __restrict__ adj, const float* __restrict__ force,
                const float* __restrict__ forcedot,
                const char* __restrict__ wprep, float* __restrict__ rowpart,
                int N, int Fg_, int R, int n_it, int n_jt) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = Shape<F, BF>;
  constexpr int TJ = kTJ<F>, M = kM<F>;
  constexpr int C = F / 32;
  constexpr int LD = S::LD;
  const int lr = ldr(R, BF), Rp = pad32(R);
  extern __shared__ float smem[];
  unsigned* ring = reinterpret_cast<unsigned*>(smem);  // kStages x RING
  float* msg_s = smem + kStages * S::RING;  // M x LD
  float* msgdot_s = msg_s + M * LD;         // M x LD
  float* h_s = msgdot_s + M * LD;           // M x LD: me, p, h
  float* hdot_s = h_s + M * LD;             // M x LD: medot, pdot, hdot
  float* phi_s = hdot_s + M * LD;           // M x LD
  float* phidot_s = phi_s + M * LD;         // M x LD
  float* npi_s = phidot_s + M * LD;         // TI x F
  float* npdoti_s = npi_s + TI * F;         // TI x F
  float* npj_s = npdoti_s + TI * F;         // TJ x F
  float* npdotj_s = npj_s + TJ * F;         // TJ x F
  float* fj_s = npdotj_s + TJ * F;          // 3 x TJ x F
  float* fjdot_s = fj_s + 3 * TJ * F;       // 3 x TJ x F
  float* adj_s = fjdot_s + 3 * TJ * F;      // M
  float* dir_s = adj_s + M;                 // 3 x M
  float* dirdot_s = dir_s + 3 * M;          // 3 x M
  float* rbf_s = dirdot_s + 3 * M;          // M x lr
  float* rbfdot_s = rbf_s + M * lr;         // M x lr

  const Tile tl(n_it, n_jt);
  const int b = tl.b, i0 = tl.it * TI, j0 = tl.jt * TJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t es = S::ES;

  load_rows(np_, b, i0, N, F, Fg, npi_s);
  if (!FIRST) load_rows(npdot, b, i0, N, F, Fg, npdoti_s);
  load_tile<F, FIRST>(np_, npdot, rbf, rbfdot, dir, dirdot, adj, force,
                      forcedot, b, i0, j0, N, Fg, R, lr, npj_s, npdotj_s,
                      fj_s, fjdot_s, adj_s, dir_s, dirdot_s, rbf_s,
                      rbfdot_s);
  tc_pair<F, BF>(rbf_s, rbfdot_s, lr, Rp, wprep, ring, h_s, hdot_s);
  messages<F, FIRST, BF>(h_s, hdot_s, npi_s, npdoti_s, npj_s, npdotj_s,
                         adj_s, msg_s, msgdot_s);

  float inv_acc[C], invdot_acc[C], eq_acc[3][C], eqdot_acc[3][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    inv_acc[c] = invdot_acc[c] = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) eq_acc[d][c] = eqdot_acc[d][c] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (warp * TJ + r) * LD + lane + 32 * c;
      inv_acc[c] += msg_s[o];
      invdot_acc[c] += msgdot_s[o];
    }

#pragma unroll 1
  for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
    const char* Wa = wprep + prep_offset(F, R, 1 + 2 * br) * es;
    const char* Wb = wprep + prep_offset(F, R, 2 + 2 * br) * es;
    tc_pair<F, BF>(msg_s, msgdot_s, LD, F, Wa, ring, h_s, hdot_s);  // p, pdot
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        const float pv = h_s[o];
        h_s[o] = silu_f(pv);
        hdot_s[o] = dsilu_f(pv) * hdot_s[o];
      }
    tc_pair<F, BF>(h_s, hdot_s, LD, F, Wb, ring, phi_s, phidot_s);
    // eq += phi x, eqdot += phi xdot + phidot x, where (x, xdot) is
    // (dir, dirdot) in branch 1 and (force_j, forcedot_j) in branch 2
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        const float phi = phi_s[p * LD + f] * a;
        const float phidot = phidot_s[p * LD + f] * a;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float x = br == 0 ? dir_s[d * M + p] : fj_s[(d * TJ + r) * F + f];
          const float xdot =
              br == 0 ? dirdot_s[d * M + p] : fjdot_s[(d * TJ + r) * F + f];
          eq_acc[d][c] += phi * x;
          eqdot_acc[d][c] += phi * xdot + phidot * x;
        }
      }
    }
  }

  // this tile's part of the row sums over j
  const int i = i0 + warp;
  if (i < N) {
    const size_t nf = (size_t)N * F;
    float* rp = rowpart + ((size_t)b * n_jt + tl.jt) * kRowSlotsFwd * nf +
                (size_t)i * F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      rp[f] = inv_acc[c];
      rp[nf + f] = invdot_acc[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        rp[(2 + d) * nf + f] = eq_acc[d][c];
        rp[(5 + d) * nf + f] = eqdot_acc[d][c];
      }
    }
  }
}

// inv1 = sum_jt rowpart[., jt, 0], inv1dot ... [1], eq[d] ... [2 + d],
// eqdot[d] ... [5 + d]. Fixed summation order.
__global__ void dual_fwd_rowsum_kernel(float* __restrict__ inv1,
                                       float* __restrict__ eq,
                                       float* __restrict__ inv1dot,
                                       float* __restrict__ eqdot,
                                       const float* __restrict__ rowpart,
                                       int B, int N, int F, int Fg,
                                       int n_jt) {
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nfg) return;
  const size_t b = idx / nfg, remg = idx - b * nfg;
  const size_t rem = padded_at(remg, Fg, F);
  float s[kRowSlotsFwd];
  for (int k = 0; k < kRowSlotsFwd; ++k) s[k] = 0.0f;
  for (int jt = 0; jt < n_jt; ++jt) {
    const float* c = rowpart + (b * n_jt + jt) * kRowSlotsFwd * nf + rem;
    for (int k = 0; k < kRowSlotsFwd; ++k) s[k] += c[k * nf];
  }
  inv1[idx] = s[0];
  inv1dot[idx] = s[1];
  for (int d = 0; d < 3; ++d) {
    eq[(b * 3 + d) * nfg + remg] = s[2 + d];
    eqdot[(b * 3 + d) * nfg + remg] = s[5 + d];
  }
}

// ------------------------------------------------------------------ K4 --
template <int F, bool BF>
constexpr size_t bwd_smem_floats(int R) {
  constexpr int TJ = kTJ<F>, M = kM<F>;
  return (size_t)kStages * Shape<F, BF>::RING +
         (size_t)8 * M * Shape<F, BF>::LD + (size_t)4 * TI * F +
         (size_t)8 * TJ * F + (size_t)7 * M + (size_t)2 * M * ldr(R, BF);
}

template <int F, bool FIRST, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
dual_bwd_kernel(const float* __restrict__ np_, const float* __restrict__ npdot,
                const float* __restrict__ rbf,
                const float* __restrict__ rbfdot,
                const float* __restrict__ dir,
                const float* __restrict__ dirdot,
                const float* __restrict__ adj, const float* __restrict__ force,
                const float* __restrict__ forcedot,
                const char* __restrict__ wprep, const float* __restrict__ di,
                const float* __restrict__ dq, const float* __restrict__ didot,
                const float* __restrict__ dqdot, float* __restrict__ rowpart,
                float* __restrict__ colpart, float* __restrict__ wpart, int N,
                int Fg_, int R, int n_it, int n_jt) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = Shape<F, BF>;
  constexpr int TJ = kTJ<F>, M = kM<F>;
  constexpr int C = F / 32;
  constexpr int LD = S::LD;
  const int lr = ldr(R, BF), Rp = pad32(R);
  extern __shared__ float smem[];
  unsigned* ring = reinterpret_cast<unsigned*>(smem);  // kStages x RING
  float* msg_s = smem + kStages * S::RING;  // M x LD: msg
  float* msgdot_s = msg_s + M * LD;  // M x LD: msgdot
  float* p_s = msgdot_s + M * LD;    // M x LD: me, p; at the end t me
  float* pdot_s = p_s + M * LD;      // M x LD: medot, pdot; tdot medot
  float* h_s = pdot_s + M * LD;      // M x LD: h, dh, dmsg; tdot me
  float* hdot_s = h_s + M * LD;      // M x LD: hdot, dhdot, dmsgdot; dme
  float* g_s = hdot_s + M * LD;      // M x LD: phi2, g, dp; dmedot
  float* gdot_s = g_s + M * LD;      // M x LD: phi2dot, gdot, dpdot
  float* npi_s = gdot_s + M * LD;    // TI x F
  float* npdoti_s = npi_s + TI * F;  // TI x F
  float* di_s = npdoti_s + TI * F;   // TI x F
  float* didot_s = di_s + TI * F;    // TI x F
  float* npj_s = didot_s + TI * F;   // TJ x F
  float* npdotj_s = npj_s + TJ * F;  // TJ x F
  float* fj_s = npdotj_s + TJ * F;   // 3 x TJ x F
  float* fjdot_s = fj_s + 3 * TJ * F;   // 3 x TJ x F
  float* adj_s = fjdot_s + 3 * TJ * F;  // M
  float* dir_s = adj_s + M;             // 3 x M
  float* dirdot_s = dir_s + 3 * M;      // 3 x M
  float* rbf_s = dirdot_s + 3 * M;      // M x lr
  float* rbfdot_s = rbf_s + M * lr;     // M x lr

  const Tile tl(n_it, n_jt);
  const int b = tl.b, i0 = tl.it * TI, j0 = tl.jt * TJ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = i0 + warp;
  const size_t es = S::ES, nf = (size_t)N * F, nfg = (size_t)N * Fg;

  load_rows(np_, b, i0, N, F, Fg, npi_s);
  if (!FIRST) load_rows(npdot, b, i0, N, F, Fg, npdoti_s);
  load_rows(di, b, i0, N, F, Fg, di_s);
  load_rows(didot, b, i0, N, F, Fg, didot_s);
  load_tile<F, FIRST>(np_, npdot, rbf, rbfdot, dir, dirdot, adj, force,
                      forcedot, b, i0, j0, N, Fg, R, lr, npj_s, npdotj_s,
                      fj_s, fjdot_s, adj_s, dir_s, dirdot_s, rbf_s,
                      rbfdot_s);
  tc_pair<F, BF>(rbf_s, rbfdot_s, lr, Rp, wprep, ring, p_s, pdot_s);
  messages<F, FIRST, BF>(p_s, pdot_s, npi_s, npdoti_s, npj_s, npdotj_s,
                         adj_s, msg_s, msgdot_s);

  float* wp = wpart + (size_t)blockIdx.x * wgrad_size(F, R);
  float* colb = colpart + ((size_t)b * n_it + tl.it) * kColSlots * nf;
  float dmsg[TJ][C], dmsgdot[TJ][C];

#pragma unroll 1
  for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
    const char* WaT = wprep + prep_offset(F, R, 1 + 2 * br) * es;
    const char* WbT = wprep + prep_offset(F, R, 2 + 2 * br) * es;
    const char* Wa = wprep + prep_offset(F, R, 5 + 2 * br) * es;
    const char* Wb = wprep + prep_offset(F, R, 6 + 2 * br) * es;
    float* wpa = wp + (size_t)R * F + (size_t)(2 * br) * F * F;
    float* wpb = wpa + (size_t)F * F;
    tc_pair<F, BF>(msg_s, msgdot_s, LD, F, WaT, ring, p_s, pdot_s);
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        h_s[o] = silu_f(p_s[o]);
        hdot_s[o] = dsilu_f(p_s[o]) * pdot_s[o];
      }
    if (br == 1) {
      // phi2, phi2dot for the column sums over i:
      // dforce[d,j] = sum_i phi2 dq[d,i] + phi2dot dqdot[d,i],
      // dforcedot[d,j] = sum_i phi2 dqdot[d,i]
      tc_pair<F, BF>(h_s, hdot_s, LD, F, WbT, ring, g_s, gdot_s);
      for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
        const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
        if (j >= N) continue;
        float sf[3] = {0.0f, 0.0f, 0.0f}, sfd[3] = {0.0f, 0.0f, 0.0f};
        for (int il = 0; il < TI && i0 + il < N && f < Fg; ++il) {
          const int p = il * TJ + jl;
          const float phi = g_s[p * LD + f] * adj_s[p];
          const float phid = gdot_s[p * LD + f] * adj_s[p];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const size_t at =
                ((size_t)b * 3 + d) * nfg + (size_t)(i0 + il) * Fg + f;
            const float q = dq[at], qd = dqdot[at];
            sf[d] += phi * q + phid * qd;
            sfd[d] += phi * qd;
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          colb[(2 + d) * nf + (size_t)j * F + f] = sf[d];
          colb[(5 + d) * nf + (size_t)j * F + f] = sfd[d];
        }
      }
      __syncthreads();  // g_s and gdot_s are replaced next
    }
    // g = dphi * adj, gdot = dphidot * adj, where
    // dphi = sum_d dq[d,i] x[d] + dqdot[d,i] xdot[d], dphidot = sum_d
    // dqdot[d,i] x[d], with (x, xdot) = (dir, dirdot) or (force_j,
    // forcedot_j)
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        float dphi = 0.0f, dphidot = 0.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const bool ok = i < N && f < Fg;
          const size_t at = ((size_t)b * 3 + d) * nfg + (size_t)i * Fg + f;
          const float q = ok ? dq[at] : 0.0f;
          const float qd = ok ? dqdot[at] : 0.0f;
          const float x = br == 0 ? dir_s[d * M + p] : fj_s[(d * TJ + r) * F + f];
          const float xdot =
              br == 0 ? dirdot_s[d * M + p] : fjdot_s[(d * TJ + r) * F + f];
          dphi = dphi + q * x + qd * xdot;
          dphidot = dphidot + qd * x;
        }
        g_s[p * LD + f] = dphi * a;
        gdot_s[p * LD + f] = dphidot * a;
      }
    }
    wgrad_pair<F, BF>(h_s, g_s, hdot_s, gdot_s, LD, F, wpb);  // dWb
    tc_pair<F, BF>(g_s, gdot_s, LD, F, Wb, ring, h_s, hdot_s);  // dh, dhdot
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        const float pv = p_s[o], dh = h_s[o], dhdot = hdot_s[o];
        g_s[o] = dsilu_f(pv) * dh + d2silu_f(pv) * pdot_s[o] * dhdot;  // dp
        gdot_s[o] = dsilu_f(pv) * dhdot;  // dpdot
      }
    wgrad_pair<F, BF>(msg_s, g_s, msgdot_s, gdot_s, LD, F, wpa);  // dWa
    tc_pair<F, BF>(g_s, gdot_s, LD, F, Wa, ring, h_s, hdot_s);  // dmsg(dot)
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        dmsg[r][c] = br == 0 ? h_s[o] : dmsg[r][c] + h_s[o];
        dmsgdot[r][c] = br == 0 ? hdot_s[o] : dmsgdot[r][c] + hdot_s[o];
      }
  }

  // ---- t = (dmsg + di_i) adj, tdot = (dmsgdot + didot_i) adj; dnp,
  // dnpdot, dme, dmedot, dWe. me and medot are recomputed.
  tc_pair<F, BF>(rbf_s, rbfdot_s, lr, Rp, wprep, ring, p_s, pdot_s);
  float dnp_acc[C], dnpdot_acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dnp_acc[c] = dnpdot_acc[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const int o = p * LD + f;
      const float t = (dmsg[r][c] + di_s[warp * F + f]) * a;
      const float tdot = (dmsgdot[r][c] + didot_s[warp * F + f]) * a;
      const float me = p_s[o], medot = pdot_s[o];
      const float ai = npi_s[warp * F + f], aj = npj_s[r * F + f];
      if (FIRST) {
        dnp_acc[c] += t * me * aj + tdot * medot * aj;
        hdot_s[o] = t * ai * aj;  // dme
      } else {
        const float aidot = npdoti_s[warp * F + f];
        const float ajdot = npdotj_s[r * F + f];
        dnp_acc[c] += t * me * aj + tdot * (medot * aj + me * ajdot);
        dnpdot_acc[c] += tdot * me * aj;
        hdot_s[o] = t * ai * aj + tdot * (aidot * aj + ai * ajdot);
      }
      g_s[o] = tdot * ai * aj;  // dmedot
      p_s[o] = t * me;
      pdot_s[o] = tdot * medot;
      h_s[o] = tdot * me;
    }
  }
  __syncthreads();
  // column parts over i: dnp[j] += sum_i t me np_i + tdot (medot np_i +
  // me npdot_i), dnpdot[j] += sum_i tdot me np_i
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    if (j >= N) continue;
    float s = 0.0f, sd = 0.0f;
    for (int il = 0; il < TI; ++il) {
      const int o = (il * TJ + jl) * LD + f;
      const float ai = npi_s[il * F + f];
      if (FIRST) {
        s += p_s[o] * ai + pdot_s[o] * ai;
      } else {
        s += p_s[o] * ai + (pdot_s[o] * ai + h_s[o] * npdoti_s[il * F + f]);
        sd += h_s[o] * ai;
      }
    }
    colb[(size_t)j * F + f] = s;
    colb[nf + (size_t)j * F + f] = sd;
  }
  wgrad_pair<F, BF>(rbf_s, hdot_s, rbfdot_s, g_s, lr, R, wp);  // dWe

  // this tile's row parts over j
  if (i < N) {
    float* rp = rowpart + ((size_t)b * n_jt + tl.jt) * kRowSlotsBwd * nf +
                (size_t)i * F;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      rp[lane + 32 * c] = dnp_acc[c];
      rp[nf + lane + 32 * c] = dnpdot_acc[c];
    }
  }
}

// dnp = sum_jt rowpart[., jt, 0] + sum_it colpart[., it, 0]; dnpdot
// likewise from slot 1; dforce[d] = sum_it colpart[., it, 2+d];
// dforcedot[d] = sum_it colpart[., it, 5+d]. The first layer's dnpdot,
// dforce and dforcedot are zero. Fixed summation order.
__global__ void dual_bwd_nodesum_kernel(float* __restrict__ dnp,
                                        float* __restrict__ dnpdot,
                                        float* __restrict__ dforce,
                                        float* __restrict__ dforcedot,
                                        const float* __restrict__ rowpart,
                                        const float* __restrict__ colpart,
                                        int B, int N, int F, int Fg,
                                        int n_it, int n_jt, int first) {
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nfg) return;
  const size_t b = idx / nfg, remg = idx - b * nfg;
  const size_t rem = padded_at(remg, Fg, F);
  float s[kColSlots];
  for (int k = 0; k < kColSlots; ++k) s[k] = 0.0f;
  for (int jt = 0; jt < n_jt; ++jt) {
    const float* c = rowpart + (b * n_jt + jt) * kRowSlotsBwd * nf + rem;
    s[0] += c[0];
    if (!first) s[1] += c[nf];
  }
  for (int it = 0; it < n_it; ++it) {
    const float* c = colpart + (b * n_it + it) * kColSlots * nf + rem;
    s[0] += c[0];
    if (!first)
      for (int k = 1; k < kColSlots; ++k) s[k] += c[k * nf];
  }
  dnp[idx] = s[0];
  dnpdot[idx] = s[1];
  for (int d = 0; d < 3; ++d) {
    dforce[(b * 3 + d) * nfg + remg] = s[2 + d];
    dforcedot[(b * 3 + d) * nfg + remg] = s[5 + d];
  }
}

// out[e] = sum_blk part[blk, e] for e < n_valid; 0 for the rest (the
// first layer's W2a/W2b). out is at width Fg, the partials at F. Fixed
// summation order.
__global__ void dual_bwd_wsum_kernel(float* __restrict__ out,
                                     const float* __restrict__ part,
                                     int n_blocks, int R, int F, int Fg,
                                     size_t n_valid) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= wgrad_size(Fg, R)) return;
  float s = 0.0f;
  if (e < n_valid) {
    const size_t n = wgrad_size(F, R), at = wgrad_padded_at(e, R, F, Fg);
    for (int k = 0; k < n_blocks; ++k) s += part[(size_t)k * n + at];
  }
  out[e] = s;
}

// Scratch of one launch, in floats: the prepared weights, then K3's row
// partials, or K4's row, column and weight partials.
size_t scratch_floats(int B, int N, int F, int R, bool bwd) {
  const int tj = F > 128 ? kTJ<256> : kTJ<128>;
  const size_t n_it = (N + TI - 1) / TI, n_jt = (N + tj - 1) / tj;
  const size_t nf = (size_t)N * F;
  if (!bwd) return prep_floats(F, R) + B * n_jt * kRowSlotsFwd * nf;
  return prep_floats(F, R) + B * n_jt * kRowSlotsBwd * nf +
         B * n_it * kColSlots * nf + B * n_it * n_jt * wgrad_size(F, R);
}

template <class Prep>
cudaError_t launch_prep(Prep prep, const float* const* in, void* out, int F,
                        int Fg, int R, cudaStream_t stream) {
  const size_t total = prep_floats(F, R);
  const size_t want = (total + 255) / 256;
  const unsigned grid = (unsigned)(want < 264 ? want : 264);
  prep<<<grid, 256, 0, stream>>>(in[9], in[10], in[11], in[12], in[13], out,
                                 F, Fg, R);
  return cudaGetLastError();
}

template <int F, bool FIRST, bool BF>
cudaError_t launch_fwd(const float* const* in, float* const* out,
                       float* scratch, int B, int N, int Fg, int R,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<F, BF>(R) * sizeof(float);
  auto kern = dual_fwd_kernel<F, FIRST, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_it = (N + TI - 1) / TI, n_jt = (N + kTJ<F> - 1) / kTJ<F>;
  char* wprep = reinterpret_cast<char*>(scratch);
  float* rowpart = scratch + prep_floats(F, R);
  err = launch_prep(dual_fwd_prep_kernel<BF>, in, wprep, F, Fg, R, stream);
  if (err != cudaSuccess) return err;
  const unsigned n_blocks = (unsigned)(B * n_it * n_jt);
  kern<<<n_blocks, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], wprep,
      rowpart, N, Fg, R, n_it, n_jt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((size_t)B * N * Fg + 255) / 256);
  dual_fwd_rowsum_kernel<<<grid, 256, 0, stream>>>(
      out[0], out[1], out[2], out[3], rowpart, B, N, F, Fg, n_jt);
  return cudaGetLastError();
}

// in: the 14 inputs of K3 then di, dq, didot, dqdot; out: dnp, dnpdot,
// dforce, dforcedot, dw.
template <int F, bool FIRST, bool BF>
cudaError_t launch_bwd(const float* const* in, float* const* out,
                       float* scratch, int B, int N, int Fg, int R,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<F, BF>(R) * sizeof(float);
  auto kern = dual_bwd_kernel<F, FIRST, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_it = (N + TI - 1) / TI, n_jt = (N + kTJ<F> - 1) / kTJ<F>;
  const size_t nf = (size_t)N * F;
  char* wprep = reinterpret_cast<char*>(scratch);
  float* rowpart = scratch + prep_floats(F, R);
  float* colpart = rowpart + (size_t)B * n_jt * kRowSlotsBwd * nf;
  float* wpart = colpart + (size_t)B * n_it * kColSlots * nf;
  err = launch_prep(dual_bwd_prep_kernel<BF>, in, wprep, F, Fg, R, stream);
  if (err != cudaSuccess) return err;
  const int n_blocks = B * n_it * n_jt;
  kern<<<n_blocks, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], wprep,
      in[14], in[15], in[16], in[17], rowpart, colpart, wpart, N, Fg, R, n_it,
      n_jt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((size_t)B * N * Fg + 255) / 256);
  dual_bwd_nodesum_kernel<<<grid, 256, 0, stream>>>(
      out[0], out[1], out[2], out[3], rowpart, colpart, B, N, F, Fg, n_it,
      n_jt, FIRST ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = wgrad_size(Fg, R);
  const size_t n_valid = FIRST ? (size_t)R * Fg + 2 * (size_t)Fg * Fg : n;
  const unsigned wgrid = (unsigned)((n + 255) / 256);
  dual_bwd_wsum_kernel<<<wgrid, 256, 0, stream>>>(out[4], wpart, n_blocks, R,
                                                  F, Fg, n_valid);
  return cudaGetLastError();
}

typedef cudaError_t (*launch_fn)(const float* const*, float* const*, float*,
                                 int, int, int, int, cudaStream_t);

// The instantiation for (F, first, bf16), where F is the true width, or
// nullptr for an F this library does not run.
template <template <int, bool, bool> class L>
launch_fn pick(int F, bool first, bool bf) {
  constexpr int FF = NN_WIDTH;
  if (!library_runs(F)) return nullptr;
  return first ? (bf ? L<FF, true, true>::fn : L<FF, true, false>::fn)
               : (bf ? L<FF, false, true>::fn : L<FF, false, false>::fn);
}

template <int F, bool FIRST, bool BF>
struct FwdLaunch {
  static constexpr launch_fn fn = launch_fwd<F, FIRST, BF>;
};
template <int F, bool FIRST, bool BF>
struct BwdLaunch {
  static constexpr launch_fn fn = launch_bwd<F, FIRST, BF>;
};

}  // namespace

extern "C" {

// K3. Shapes: np, npdot (B,N,F); rbf, rbfdot (B,N,N,R); dir, dirdot
// (B,3,N,N); adj (B,N,N); force, forcedot (B,3,N,F); We (R,F); W* (F,F)
// -> inv1, inv1dot (B,N,F); eq, eqdot (B,3,N,F). Scratch: 16-byte aligned,
// nn_dual_scratch_floats(B, N, F, R, 0) floats. All fp32, contiguous, on
// the device of `stream`. Any F this library runs (library_runs), else
// cudaErrorInvalidValue; bf16 != 0 rounds the product operands to bf16.
int nn_dual_fwd(const float* np_, const float* npdot, const float* rbf,
                const float* rbfdot, const float* dir, const float* dirdot,
                const float* adj, const float* force, const float* forcedot,
                const float* We, const float* W1a, const float* W1b,
                const float* W2a, const float* W2b, float* inv1, float* eq,
                float* inv1dot, float* eqdot, float* scratch, int B, int N,
                int F, int R, int first_layer, int bf16, void* stream) {
  const launch_fn fn = pick<FwdLaunch>(F, first_layer != 0, bf16 != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* in[14] = {np_, npdot, rbf, rbfdot, dir, dirdot, adj,
                         force, forcedot, We, W1a, W1b, W2a, W2b};
  float* out[4] = {inv1, eq, inv1dot, eqdot};
  return (int)fn(in, out, scratch, B, N, F, R,
                 static_cast<cudaStream_t>(stream));
}

// K4. Inputs of K3 plus di, didot (B,N,F) and dq, dqdot (B,3,N,F).
// Outputs dnp, dnpdot (B,N,F), dforce, dforcedot (B,3,N,F) and dw
// (R*F+4F^2: dWe, dW1a, dW1b, dW2a, dW2b one after the other). Scratch:
// 16-byte aligned, nn_dual_scratch_floats(B, N, F, R, 1) floats.
int nn_dual_bwd(const float* np_, const float* npdot, const float* rbf,
                const float* rbfdot, const float* dir, const float* dirdot,
                const float* adj, const float* force, const float* forcedot,
                const float* We, const float* W1a, const float* W1b,
                const float* W2a, const float* W2b, const float* di,
                const float* dq, const float* didot, const float* dqdot,
                float* dnp, float* dnpdot, float* dforce, float* dforcedot,
                float* dw, float* scratch, int B, int N, int F, int R,
                int first_layer, int bf16, void* stream) {
  const launch_fn fn = pick<BwdLaunch>(F, first_layer != 0, bf16 != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* in[18] = {np_, npdot, rbf, rbfdot, dir, dirdot,
                         adj, force, forcedot, We, W1a, W1b,
                         W2a, W2b, di, dq, didot, dqdot};
  float* out[5] = {dnp, dnpdot, dforce, dforcedot, dw};
  return (int)fn(in, out, scratch, B, N, F, R,
                 static_cast<cudaStream_t>(stream));
}

// Scratch of one K3 (kind 0) or K4 (kind 1) launch at true width F, in
// floats.
size_t nn_dual_scratch_floats(int B, int N, int F, int R, int kind) {
  return scratch_floats(B, N, padded_width(F), R, kind != 0);
}

// Dynamic shared memory of one block of K3 (kind 0) or K4 (kind 1) in
// bf16 (bf16 != 0) or fp32 mode at true width F, in bytes; 0 for an F
// this library does not run.
size_t nn_dual_smem_bytes(int F, int R, int kind, int bf16) {
  constexpr int FF = NN_WIDTH;
  if (!library_runs(F)) return 0;
  return (kind ? (bf16 ? bwd_smem_floats<FF, true>(R)
                       : bwd_smem_floats<FF, false>(R))
               : (bf16 ? fwd_smem_floats<FF, true>(R)
                       : fwd_smem_floats<FF, false>(R))) * sizeof(float);
}

}  // extern "C"
