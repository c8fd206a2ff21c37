// Fused dense pair-interaction layer for Hopper (sm_90a), fp32 or the
// Pallas kernels' bf16 mode.
//
// Replaces the TPU kernels newtonnet_tpu/ops/pallas_dense.py:_fwd_kernel
// (K1) and newtonnet_tpu/ops/pallas_dense.py:_bwd_kernel (K2). Both are
// templated on FIRST (the stack's first layer, whose force_node input is
// identically zero, so the phi2 branch is skipped) and on the padded
// feature width F, a multiple of 32; R (the radial basis size), N (atoms)
// and the tensors' true width Fg (1 <= Fg <= F) are runtime.
//
// Any width: the tiles, rings and slot buffers hold F columns, and the
// kernels read every F-wide tensor (np_, force, dinv1, deq, the weights) at
// its true width Fg, zero-filling the pad lanes Fg..F in shared memory or
// registers; the weight preparation writes zero pad rows and columns.
// silu(0) = 0, so the pad lanes of every slot buffer stay zero and change
// no sum. The cross-block partials are kept at F in the scratch, and the
// kernels that sum them write the outputs at Fg: no pad lane reaches an
// output.
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
// Both multiply on the tensor cores in 3xTF32 (the notes above
// pair_bwd_kernel and pair_fwd_kernel): fp32-level products (each operand
// split in a tf32 high and low part, three products summed in fp32; never
// 1xTF32). Their sums over i and j and K2's weight cotangents cross blocks
// and are summed by second kernels in a fixed order: no float atomics, a
// run gives the same bits every time.
//
// bf16 mode (a library built with -DNN_BF16: kBF; the JAX package's
// pallas_dot_dtype bfloat16). The Pallas kernels round to bf16 both
// operands of the chain's products (pallas_dense.py `_chain`: me = rbf We,
// p = msg Wa, phi = h Wb) and of K2's weight cotangents (`dotT`), and
// accumulate in fp32; K2's cotangent products (dh, dmsg, drbf) take fp32
// operands. Here those products run as mma.sync m16n8k16 bf16 with fp32
// accumulation (bf16_mma.cuh), one per 16 depth steps of a 16 x 8 tile
// where 3xTF32 takes six m16n8k8: the weights are rounded once per launch
// by the prep kernels, the slot operands (rbf, msg, h, and for the weight
// cotangents dme, dp, dphi) where a fragment is loaded (rounding is
// idempotent, so where it happens does not change the value); K2's
// cotangent products keep their 3xTF32 path and its (hi, lo) weights.
// Every elementwise operation and every sum stays fp32, on the same fp32
// slot buffers, so the kernels and the plain versions (ops/fused_dense.py,
// dot_dtype='bfloat16') differ only in summation order. The bf16 weights
// stream through the same rings in chunks of 32 depth steps (two k-steps)
// of one or two weights, rows of 16 words (K1: XOR-swizzled, bf16_swz;
// K2: at a stride of 20 words), so that the B fragments' 32-bit loads hit
// 32 banks.
//
// The host functions return the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16_mma.cuh"

namespace {

// The library's mode: the Pallas kernels' bf16 products (ops/_build.py
// builds it with -DNN_BF16 for pallas_dot_dtype bfloat16) or fp32.
#ifdef NN_BF16
constexpr bool kBF = true;
#else
constexpr bool kBF = false;
#endif
// Elements of the prepared weights' type per uint2 of the scratch: four
// bf16, or one (hi, lo) tf32 pair.
constexpr int kEPP = kBF ? 4 : 1;
// bf16 weight chunks: depth steps (two m16n8k16 k-steps), 32-bit words
// per row, and K2's row stride in the ring (16 + 4: conflict-free B
// fragment loads)
constexpr int KB = 32;
constexpr int KBW = KB / 2;
constexpr int KB2S = KBW + 4;

// The XOR swizzle of a bf16 chunk row of 16 words: word w of row r at w ^
// bf16_swz(r), so that the B fragments' 32-bit loads (rows g = 0..7 at a
// stride of 16 words) hit 32 banks.
__host__ __device__ constexpr int bf16_swz(int r) {
  return ((r >> 1) & 3) << 2;
}

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TI = kWarps;   // rows i per block: one per warp

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f + x * (1.0f - s));
}

// silu and its derivative with the fast exponential and division (a few
// ulp, far inside the kernels' bar): the activations of the tensor-core
// kernels K1 and K6, where the IEEE ones cost a fifth of the launch.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float silu_fast(float x) {
  return x * sigmoid_fast(x);
}
__device__ __forceinline__ float dsilu_fast(float x) {
  const float s = sigmoid_fast(x);
  return s * (1.0f + x * (1.0f - s));
}

// ------------------------------------------------------------------ K2 --
// K2 on the tensor cores.
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
// * Past F=128 (wide) the tile has 2 columns (16 slot rows: each warp takes
//   all of them and an eighth of the columns), chunks of 8 depth steps and
//   drbf products of 64 columns r (R padded to 64), so that it fits: 222 KB
//   at F=256, R=20.
// * Code size: k2_prod and k2_wgrad are out of line (__noinline__).
// On the card its time splits three ways (PERF.md, dual_breakdown.py
// k2k7): the elementwise chain and tile loads, the weight stream (each
// 32-slot tile streams all the weights from L2, 1.1 MB of pairs at F=128)
// with the fragment loads and splits, and the mma.
constexpr int kColSlots = 4;   // column partials: dnp, dforce[3]

// K2's columns j per tile, depth steps of a staged weight chunk, and
// columns r of a drbf product (its radial depth is padded to a multiple).
__host__ __device__ constexpr int k2_tj(int F) { return F > 128 ? 2 : 4; }
__host__ __device__ constexpr int k2_kc(int F) { return F > 128 ? 8 : 16; }
__host__ __device__ constexpr int k2_rc(int F) { return F > 128 ? 64 : 32; }
__host__ __device__ constexpr int k2_rp(int F, int R) {
  return (R + k2_rc(F) - 1) / k2_rc(F) * k2_rc(F);
}

template <bool WIDE>
struct K2Shape {
  static constexpr int TJ = k2_tj(WIDE ? 256 : 128);  // columns j per tile
  static constexpr int M = TI * TJ;  // pair slots per tile; p = il * TJ + jl
  static constexpr int KC = k2_kc(WIDE ? 256 : 128);  // depth steps a chunk
  static constexpr int RS = KC + 4;  // (hi, lo) pairs per staged chunk row
  static constexpr int RG = M / 16;  // 16-row groups of a product
  static constexpr int CG = kWarps / RG;  // column groups of a product
};

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

// The prepared weights, in (hi, lo) pairs, n-major: block 0 We^T (F x Rp),
// 1 We (Rp x F, zero rows past R), 2-5 W1a^T, W2a^T, W1b^T, W2b^T (products
// with W), 6-9 W1a, W2a, W1b, W2b (products with W^T), F x F each.
__host__ __device__ inline size_t k2_prep_offset(int F, int R, int block) {
  const size_t fr = (size_t)F * k2_rp(F, R);
  return block < 2 ? block * fr : 2 * fr + (size_t)(block - 2) * F * F;
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

template <int F>
constexpr size_t bwd_smem_floats(int R) {
  using S = K2Shape<(F > 128)>;
  return (size_t)2 * 2 * 2 * F * S::RS + (size_t)6 * S::M * (F + 4) +
         (size_t)S::M * (k2_rp(F, R) + 4) + (size_t)2 * TI * F +
         (size_t)4 * S::TJ * F + (size_t)4 * S::M;
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

// split_tf32 in three integer and float operations instead of five, for
// operands that go straight to mma_tf32, which reads the top 19 bits of
// each word: hi is x plus half a tf32 ulp (the mma's truncation of it is
// tf32_rna(x)) and lo = x - tf32_rna(x) whole (truncated by the mma).
__device__ __forceinline__ void split_tf32_mma(float x, unsigned& hi,
                                               unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
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
                                     uint2* __restrict__ out, int F, int Fg,
                                     int R) {
  const int Rp = k2_rp(F, R);
  const size_t fr = (size_t)F * Rp, total = k2_prep_offset(F, R, 10);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v;
    if (e < fr) {  // We^T: n = f, q = r
      const int n = (int)(e / Rp), q = (int)(e % Rp);
      v = q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f;
    } else if (e < 2 * fr) {  // We: n = r, q = f
      const int n = (int)((e - fr) / F), q = (int)((e - fr) % F);
      v = n < R && q < Fg ? We[(size_t)n * Fg + q] : 0.0f;
    } else {
      const size_t e2 = e - 2 * fr, ff = (size_t)F * F;
      const int k = (int)(e2 / ff), r = (int)(e2 % ff);
      const int n = r / F, q = r % F;
      const float* W = (k & 3) == 0 ? W1a : (k & 3) == 1 ? W2a
                       : (k & 3) == 2 ? W1b : W2b;
      v = n >= Fg || q >= Fg ? 0.0f
          : k < 4            ? W[(size_t)q * Fg + n]
                             : W[(size_t)n * Fg + q];
    }
    // bf16 mode: the chain's weights (blocks 0 and 2-5) rounded to bf16,
    // n-major with the depth contiguous, from the block's start; the
    // cotangent products' weights stay (hi, lo) tf32 pairs
    const bool chain = e < fr || (e >= 2 * fr && (e - 2 * fr) / F / F < 4);
    if (kBF && chain) {
      const size_t base =
          e < fr ? 0 : 2 * fr + (e - 2 * fr) / ((size_t)F * F) * F * F;
      reinterpret_cast<unsigned short*>(out + base)[e - base] = bf16_bits(v);
      continue;
    }
    const unsigned hi = tf32_rna(v);
    out[e] = make_uint2(hi, tf32_rna(v - __uint_as_float(hi)));
  }
}

// Chunk ch of a prepared weight (NC rows of Qp pairs) into a ring slot: per
// row n the KC pairs of depth [ch*KC, ch*KC + KC) at pair n*RS, as KC/2
// 16-byte cp.async copies.
template <int NC, bool WIDE>
__device__ __forceinline__ void k2_stage(const uint2* __restrict__ Bt, int Qp,
                                         int ch, uint2* slot) {
  using S = K2Shape<WIDE>;
  // copies per row, a power of two: with v unsigned, v / P and v % P are
  // a shift and a mask (signed, their rounding code cost K2 7% at F=128:
  // PERF.md, dual_breakdown.py k2diag)
  constexpr unsigned P = S::KC / 2;
  static_assert((P & (P - 1)) == 0, "copies per row");
  for (unsigned v = threadIdx.x; v < NC * P; v += kThreads) {
    const int n = (int)(v / P), part = (int)(v % P);
    cp_async16(slot + n * S::RS + part * 2,
               Bt + (size_t)n * Qp + (size_t)ch * S::KC + part * 2);
  }
}

// Chunk ch (KB depth steps) of a prepared bf16 weight (NC rows of Qp
// elements) into a ring slot: per row n its 16 words at word n*KB2S, as
// four 16-byte cp.async copies.
template <int NC>
__device__ __forceinline__ void k2_stage_bf16(const uint2* __restrict__ Bt,
                                              int Qp, int ch, unsigned* slot) {
  const char* src = reinterpret_cast<const char*>(Bt);
  for (unsigned v = threadIdx.x; v < NC * 4u; v += kThreads) {
    const int n = (int)(v >> 2), part = (int)(v & 3);
    cp_async16(slot + n * KB2S + part * 4,
               src + ((size_t)n * Qp + (size_t)ch * KB) * 2 + part * 16);
  }
}

// For the tile's M slot rows m and n < NC, q < Qp (a multiple of 32), in
// 3xTF32: D1[m*ldd + n] = sum_q A1[m*lda + q] B1(q, n), and with B2
// D2[m*ldd + n] = sum_q A2[m*lda + q] B2(q, n), or with `sum` D1 = the sum
// of both. A's columns past the true depth hold zeros; B(q, n) = Bt[n*Qp +
// q] is a prepared weight. With BFW the weights are bf16 (n-major, Qp
// elements a row) and the products m16n8k16 bf16, A rounded to bf16 where
// its fragments are loaded. Warp w computes the 16-row group w % RG and
// NC/CG columns (RG = M/16 groups, CG = 8/RG; NC >= 8 CG). Every warp
// reads every A row after the loop's first
// barrier and D is written after a barrier that follows the last read, so
// A may be written just before the call and D may be A. Ends with a
// __syncthreads. All threads of the block must call it. Not inlined.
template <int NC, bool WIDE, bool BFW = false>
__device__ __noinline__ void k2_prod(const float* A1, const float* A2,
                                     int lda, int Qp,
                                     const uint2* __restrict__ B1,
                                     const uint2* __restrict__ B2,
                                     uint2* ring, float* D1, float* D2,
                                     int ldd, bool sum) {
  using S = K2Shape<WIDE>;
  constexpr int NT = NC / (8 * S::CG);  // 16 x 8 tiles per warp, product
  constexpr int RS = S::RS, KC = S::KC;
  constexpr int SLOT = 2 * NC * RS;  // pairs per ring slot: two weights
  static_assert(NT >= 1, "NC < 8 column groups");
  const bool two = B2 != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % S::RG) * 16, n0 = (warp / S::RG) * (NC / S::CG);
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
  if constexpr (BFW) {
    unsigned* ringw = reinterpret_cast<unsigned*>(ring);
    const int nch = Qp / KB;
    k2_stage_bf16<NC>(B1, Qp, 0, ringw);
    if (two) k2_stage_bf16<NC>(B2, Qp, 0, ringw + NC * KB2S);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<0>();
      __syncthreads();  // chunk ch is in; every warp is done with ch - 1
      if (ch + 1 < nch) {
        unsigned* next = ringw + ((ch + 1) & 1) * 2 * SLOT;
        k2_stage_bf16<NC>(B1, Qp, ch + 1, next);
        if (two) k2_stage_bf16<NC>(B2, Qp, ch + 1, next + NC * KB2S);
      }
      cp_async_commit();
      const unsigned* wc = ringw + (ch & 1) * 2 * SLOT;
      float d[2][NT][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          d[x][j][0] = d[x][j][1] = d[x][j][2] = d[x][j][3] = 0.0f;
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) {  // k-steps of a chunk
        const int k = ch * KB + s * 16 + 2 * t;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (x == 1 && !two) break;
          const unsigned a[4] = {
              pack_bf16_at(rows[x][0] + k), pack_bf16_at(rows[x][1] + k),
              pack_bf16_at(rows[x][0] + k + 8),
              pack_bf16_at(rows[x][1] + k + 8)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned* w =
                wc + (x * NC + n0 + j * 8 + g) * KB2S + s * 8 + t;
            const unsigned b[2] = {w[0], w[4]};  // depth 2t.., 2t + 8..
            mma_bf16(d[x][j], a, b);
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
  } else {
  const int nch = Qp / KC;
  k2_stage<NC, WIDE>(B1, Qp, 0, ring);
  if (two) k2_stage<NC, WIDE>(B2, Qp, 0, ring + NC * RS);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    if (ch + 1 < nch) {
      uint2* next = ring + ((ch + 1) & 1) * SLOT;
      k2_stage<NC, WIDE>(B1, Qp, ch + 1, next);
      if (two) k2_stage<NC, WIDE>(B2, Qp, ch + 1, next + NC * RS);
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
    for (int s = 0; s < KC / 8; ++s) {  // k-steps of a chunk
      const int k = ch * KC + s * 8 + t;
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
          const uint2* w = wc + (x * NC + n0 + j * 8 + g) * RS + s * 8 + t;
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
// of 16 past qrows must be readable and finite. In bf16 mode both
// operands are rounded to bf16 (K2's `dotT`) and multiplied by m16n8k16
// bf16. Starts with a __syncthreads. Not inlined.
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
    if constexpr (kBF) {
#pragma unroll
      for (int kk = 0; kk < K2Shape<(F > 128)>::M; kk += 16) {
        const int p = kk + 2 * t;  // slots p, p + 1 and p + 8, p + 9
        auto av = [&](int pp, int q) {
          const float v = A[pp * lda + q];
          return silu ? silu_f(v) : v;
        };
        const unsigned a[4] = {pack_bf16(av(p, qa), av(p + 1, qa)),
                               pack_bf16(av(p, qb), av(p + 1, qb)),
                               pack_bf16(av(p + 8, qa), av(p + 9, qa)),
                               pack_bf16(av(p + 8, qb), av(p + 9, qb))};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nb + j * 8 + g;
          const unsigned b[2] = {
              pack_bf16(Bm[p * LD + n], Bm[(p + 1) * LD + n]),
              pack_bf16(Bm[(p + 8) * LD + n], Bm[(p + 9) * LD + n])};
          mma_bf16(d[j], a, b);
        }
      }
    } else {
#pragma unroll
    for (int kk = 0; kk < K2Shape<(F > 128)>::M; kk += 8) {
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
                int Fg_, int R, int n_it, int n_jt) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  constexpr bool WIDE = F > 128;
  using S = K2Shape<WIDE>;
  constexpr int C = F / 32;
  constexpr int LD = F + 4;
  constexpr int TJ = S::TJ, M = S::M, RC = k2_rc(F);
  const int Rp = k2_rp(F, R), lr = Rp + 4;
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // 2 slots x 2 weights
  float* me_s = smem + 2 * 2 * 2 * F * S::RS;  // M x LD: me
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
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;

  for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    const bool ok = i0 + il < N && f < Fg;
    const size_t row = ((size_t)b * N + i0 + il) * Fg + f;
    npi_s[idx] = ok ? np_[row] : 0.0f;
    dinv_s[idx] = ok ? dinv1[row] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    npj_s[idx] = j < N && f < Fg ? np_[((size_t)b * N + j) * Fg + f] : 0.0f;
  }
  if (!FIRST) {
    for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
      const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
      const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
      fj_s[idx] = j < N && f < Fg ? force[((size_t)b * 3 + d) * nfg +
                                          (size_t)j * Fg + f]
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
      gq[d][c] = i < N && lane + 32 * c < Fg
                     ? deq[((size_t)b * 3 + d) * nfg + (size_t)i * Fg + lane +
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

  // me, then msg = me np_i np_j adj (in bf16 mode the chain's products,
  // me, p and phi, are bf16; the cotangent products dh, dmsg and drbf
  // stay 3xTF32)
  k2_prod<F, WIDE, kBF>(rbf_s, nullptr, lr, Rp, WeT, nullptr, ring, me_s,
                        nullptr, LD, false);
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
  k2_prod<F, WIDE, kBF>(msg_s, msg_s, LD, F, W1aT, FIRST ? nullptr : W2aT,
                        ring, p1_s, p2_s, LD, false);
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (warp * TJ + r) * LD + lane + 32 * c;
      x1_s[o] = silu_f(p1_s[o]);
      if (!FIRST) x2_s[o] = silu_f(p2_s[o]);
    }
  k2_prod<F, WIDE, kBF>(x1_s, x2_s, LD, F, W1bT, FIRST ? nullptr : W2bT,
                        ring, x1_s, x2_s, LD, false);
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
      for (int il = 0; il < TI && i0 + il < N && f < Fg; ++il) {
        const int p = il * TJ + jl;
        const float phi = x2_s[p * LD + f] * adj_s[p];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s[d] += phi * deq[((size_t)b * 3 + d) * nfg +
                            (size_t)(i0 + il) * Fg + f];
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
  k2_prod<F, WIDE>(x1_s, x2_s, LD, F, W1b, FIRST ? nullptr : W2b, ring, x1_s,
                   x2_s, LD, false);
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
  k2_prod<F, WIDE>(x1_s, x2_s, LD, F, W1a, FIRST ? nullptr : W2a, ring, x1_s,
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
  // drbf = dme @ We^T, RC columns r at a time, into rbf_s
  for (int cb = 0; cb < Rp; cb += RC)
    k2_prod<RC, WIDE>(x2_s, nullptr, LD, F, Wer + (size_t)cb * F, nullptr,
                      ring, rbf_s + cb, nullptr, lr, false);
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
                                        int B, int N, int F, int Fg,
                                        int n_it, int n_jt, int first) {
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nfg) return;
  const size_t b = idx / nfg, remg = idx - b * nfg;
  const size_t rem = padded_at(remg, Fg, F);
  float s[kColSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int jt = 0; jt < n_jt; ++jt) s[0] += rowpart[(b * n_jt + jt) * nf + rem];
  for (int it = 0; it < n_it; ++it) {
    const float* c = colpart + (b * n_it + it) * kColSlots * nf + rem;
    s[0] += c[0];
    if (!first)
      for (int k = 1; k < kColSlots; ++k) s[k] += c[k * nf];
  }
  dnp[idx] = s[0];
  for (int d = 0; d < 3; ++d) dforce[(b * 3 + d) * nfg + remg] = s[1 + d];
}

// out[e] = sum_blk part[blk, e] for e < n_valid; 0 for the rest (the
// first layer's W2a/W2b). out is at width Fg, the partials at F. Fixed
// summation order.
__global__ void pair_bwd_wsum_kernel(float* __restrict__ out,
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

// ------------------------------------------------------------------ K1 --
// K1 on the tensor cores, the design of K6 (csrc/fused_klist.cu) over pair
// slots. What bounds it: its products, 2(RF + 4F^2) flops per pair slot at
// a full layer (6.0 GFLOP at the serving shape B=100, N=21, F=128, R=20).
// The CUDA-core version ran one block per (molecule, 8 rows), 300 blocks at
// the serving shape and 30 at the training shape (B=10, N=24) for 132 SMs,
// fed every FMA from shared memory and loaded each weight chunk with no
// product in flight. So:
//
// * 64-slot tiles, (molecule, 8 rows i, 8 columns j), walked by at most one
//   block per SM (the wrapper passes the SM count): 900 tiles at the
//   serving shape, 90 at the training shape (one each). Every staged weight
//   chunk feeds 64 slot rows. Warp w owns the 8 slots of row i0+w and lane
//   l the feature columns l+32c in the elementwise chain, so a tile's sums
//   over its 8 columns j are per-thread register sums; they go to a
//   per-(molecule, column tile) partial, and pair_fwd_rowsum_kernel adds a
//   row's partials in a fixed order (no float atomics: a run gives the same
//   bits every time).
// * Products on the tensor cores (k1_prod): mma.sync m16n8k8 tf32 in
//   3xTF32 (no 1xTF32), 64 x Q @ Q x F, warp w taking the 32 rows (w & 1)
//   and F/4 columns; each chunk's products accumulate in fresh registers
//   and are added to the running sum on the CUDA cores. me is a product;
//   p1/p2 run paired from msg (its A fragments split once for both),
//   phi1/phi2 paired from h1/h2; the first layer skips branch 2.
// * Weights split once per launch by pair_fwd_prep_kernel into tf32 (hi,
//   lo) pairs, chunk-major in the order the tile multiplies them and
//   swizzled as a ring slot holds them, so a chunk stages as one
//   contiguous cp.async copy; streamed through a two-slot ring of 32 depth
//   steps of one weight or 16 of each of two, the stream running across
//   products and tiles (a product stages the first chunk of the one after
//   it). Slot operands are fp32 and split at fragment load in three
//   operations (split_tf32_mma). Activations with the fast exponential and
//   division (silu_fast).
// * Shared memory at F=128, R=20: the ring 64 KB, three fp32 slot buffers
//   (me then msg; p1, h1, phi1; p2, h2, phi2) 99 KB, rbf 9 KB, the row and
//   column inputs 24 KB: 196 KB, one block per SM.
// * Past F=128 (wide) the tile has 4 columns (32 slot rows, one 32-row
//   group per warp pair) and a ring slot 16 depth steps of one weight or 8
//   of each of two, so that it fits: 190 KB at F=256, R=20.
constexpr int kRowSlots = 4;    // row partials: inv1, eq[3]

// The XOR swizzle of a ring row of rw pairs (rw >= 8): pair q of row r at
// q ^ ring_swz(r, rw), so that the B fragments' 64-bit loads spread over
// the banks.
__host__ __device__ constexpr int ring_swz(int r, int rw) {
  return (r & (rw >= 16 ? 3 : 1)) << 2;
}

// K1's columns j per tile and depth pairs of one weight in a ring slot.
__host__ __device__ constexpr int k1_tj(int F) { return F > 128 ? 4 : 8; }
__host__ __device__ constexpr int k1_rw(int F) { return F > 128 ? 16 : 32; }

template <int F>
struct K1Shape {
  static constexpr int TJ = k1_tj(F);    // columns j per tile
  static constexpr int M = TI * TJ;      // pair slots; p = il * TJ + jl
  static constexpr int RW = k1_rw(F);    // depth pairs of one weight
  static constexpr int LD = F + 4;       // fp32 slot buffers (M x LD)
  static constexpr int RING = RW * F;    // pairs per ring slot
};

template <int F>
constexpr size_t fwd_smem_floats(int R) {
  using S = K1Shape<F>;
  return (size_t)4 * S::RING + (size_t)3 * S::M * S::LD +
         (size_t)S::M * (pad32(R) + 4) + (size_t)TI * F +
         (size_t)4 * S::TJ * F + (size_t)4 * S::M;
}

// K1's prepared weights, in (hi, lo) tf32 pairs: me's We^T (B(q, n) =
// We[q][n], q < pad32(R)), then p's W1a and phi's W1b (B(q, n) = W[q][n]),
// each with its second branch's weight (W2a, W2b) except at the first
// layer; each chunk-major and swizzled as a ring slot holds it, so that a
// chunk stages as one contiguous copy: chunks of k1_rw(F) depth steps of
// one weight (rows n of rw = k1_rw(F) pairs), or of half that of each of
// two (rows x*F + n of rw = k1_rw(F) / 2 pairs), pair q of row r at r*rw +
// (q ^ ring_swz(r, rw)).
__host__ __device__ inline size_t k1_prep_pairs(int F, int R) {
  return (size_t)F * pad32(R) + (size_t)4 * F * F;
}

__global__ void pair_fwd_prep_kernel(const float* __restrict__ We,
                                     const float* __restrict__ W1a,
                                     const float* __restrict__ W1b,
                                     const float* __restrict__ W2a,
                                     const float* __restrict__ W2b,
                                     uint2* __restrict__ out, int F, int Fg,
                                     int R, int first) {
  const size_t fr = (size_t)F * pad32(R), ff = (size_t)F * F;
  const size_t total = fr + (first ? 2 : 4) * ff;
  if constexpr (kBF) {
    // words of two bf16 (depth q, q + 1), in chunks of KB depth steps of
    // one weight (rows n) or of each of two (rows x*F + n), KBW words a
    // row, word w of row r at r*KBW + (w ^ bf16_swz(r))
    unsigned* outw = reinterpret_cast<unsigned*>(out);
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < total / 2; e += (size_t)gridDim.x * blockDim.x) {
      const bool me = e < fr / 2;  // else p (k = 0) or phi (k = 1)
      const int nx = me || first ? 1 : 2;
      const int k = me ? 0 : (int)((e - fr / 2) / (nx * ff / 2));
      const size_t local = me ? e : e - fr / 2 - k * (nx * ff / 2);
      const size_t chunk = (size_t)nx * F * KBW;
      const int ch = (int)(local / chunk), rem = (int)(local % chunk);
      const int r = rem / KBW, w = (rem % KBW) ^ bf16_swz(r);
      const int x = r / F, n = r - x * F;
      const float* W = k == 0 ? (x ? W2a : W1a) : (x ? W2b : W1b);
      unsigned word = 0;
      for (int h = 0; h < 2; ++h) {
        const int q = ch * KB + 2 * w + h;
        const float v = me ? (q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f)
                           : (q < Fg && n < Fg ? W[(size_t)q * Fg + n]
                                               : 0.0f);
        word |= (unsigned)bf16_bits(v) << (16 * h);
      }
      outw[e] = word;
    }
    return;
  }
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const bool me = e < fr;  // else p (k = 0) or phi (k = 1)
    const int k = me ? 0 : (int)((e - fr) / ((first ? 1 : 2) * ff));
    const size_t local = me ? e : e - fr - k * (first ? 1 : 2) * ff;
    const int rwd = k1_rw(F), rw = me || first ? rwd : rwd / 2;
    const int ch = (int)(local / ((size_t)rwd * F));
    const int rem = (int)(local % ((size_t)rwd * F));
    const int r = rem / rw, j = rem - r * rw;
    const int q = ch * rw + (j ^ ring_swz(r, rw)), x = r / F, n = r - x * F;
    float v;
    if (me) {
      v = q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f;
    } else {
      const float* W = k == 0 ? (x ? W2a : W1a) : (x ? W2b : W1b);
      v = q < Fg && n < Fg ? W[(size_t)q * Fg + n] : 0.0f;
    }
    const unsigned hi = tf32_rna(v);
    out[e] = make_uint2(hi, tf32_rna(v - __uint_as_float(hi)));
  }
}

// A product's prepared weight: chunks of k1_rw(F) depth pairs by F rows
// (bf16: of KB depth steps by nx F rows) from b, qp depth steps in all.
struct K1W {
  const uint2* b;
  int qp;
  int nx;  // weights per chunk (bf16 mode's chunk size)
};

// Chunk ch of w into a ring slot: one contiguous copy (the preparation
// laid it out as the slot holds it), by 16-byte cp.async copies.
template <int F>
__device__ __forceinline__ void k1_stage(const K1W& w, int ch, uint2* slot) {
  if constexpr (kBF) {
    const int words = w.nx * F * KBW;  // of a chunk
    const unsigned* src =
        reinterpret_cast<const unsigned*>(w.b) + (size_t)ch * words;
    unsigned* dst = reinterpret_cast<unsigned*>(slot);
    for (int v = threadIdx.x; v < words / 4; v += kThreads)
      cp_async16(dst + 4 * v, src + 4 * v);
    return;
  }
  constexpr int RING = K1Shape<F>::RING;
  const uint2* src = w.b + (size_t)ch * RING;
  for (int v = threadIdx.x; v < RING / 2; v += kThreads)
    cp_async16(slot + 2 * v, src + 2 * v);
}

// For the tile's M slot rows m and n < F, q < cur.qp, in 3xTF32 (bf16
// mode: one m16n8k16 bf16 mma per tile and k-step, A rounded to bf16
// where its fragments are loaded): MODE 0
// D1 = A1 B1; MODE 1 D1 = A1 B1 and D2 = A1 B2; MODE 2 D1 = A1 B1 and D2 =
// A2 B2, where A is fp32 at row stride lda (zeros past the true depth) and
// B the prepared weight of cur (pair_fwd_prep_kernel's layout). Chunk 0 of
// cur sits in ring slot `slot`, staged by the product before; while its
// last chunk multiplies this product stages chunk 0 of `next` (none if
// next.b is null) and returns that chunk's slot. Every warp reads every A
// row after the loop's first barrier and D is written after a barrier that
// follows the last read, so A may be written just before the call and D
// may be A. Ends with a __syncthreads. All threads of the block must call
// it. Not inlined (code size).
template <int F, int MODE>
__device__ __noinline__ int k1_prod(const float* A1, const float* A2,
                                    int lda, K1W cur, K1W next, int slot,
                                    uint2* ring, float* D1, float* D2,
                                    int ldd) {
  using S = K1Shape<F>;
  constexpr int NT = F / 32;             // 16 x 8 tiles per row group
  constexpr int RG = S::M / 32;          // 16-row groups per warp
  constexpr int NX = MODE == 0 ? 1 : 2;  // weights per chunk and products
  constexpr int RW = S::RW / NX;         // pairs per ring row
  constexpr int RING = S::RING;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * (S::M / 2), n0 = (warp >> 1) * (F / 4);
  const int o0 = t ^ ring_swz(g, RW);  // the swizzled pair of depth t
  const int nch = cur.qp / (kBF ? KB : RW);
  float tot[NX][RG][NT][4];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tot[x][rg][j][0] = tot[x][rg][j][1] = tot[x][rg][j][2] =
            tot[x][rg][j][3] = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    uint2* other = ring + (slot ^ 1) * RING;
    if (ch + 1 < nch)
      k1_stage<F>(cur, ch + 1, other);
    else if (next.b != nullptr)
      k1_stage<F>(next, 0, other);
    cp_async_commit();
    const uint2* wc = ring + slot * RING;
    float d[NX][RG][NT][4];
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
      for (int rg = 0; rg < RG; ++rg)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          d[x][rg][j][0] = d[x][rg][j][1] = d[x][rg][j][2] =
              d[x][rg][j][3] = 0.0f;
    if constexpr (kBF) {
      const unsigned* wb = reinterpret_cast<const unsigned*>(wc);
      const int sw = bf16_swz(g);  // rows x*F + n0 + j*8 + g: r & 7 == g
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) {
        const int k = ch * KB + s * 16 + 2 * t;  // depth of the A words
        unsigned a[RG][4];
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          if (x == 0 || MODE == 2) {
            const float* A = x == 0 ? A1 : A2;
#pragma unroll
            for (int rg = 0; rg < RG; ++rg) {
              const float* r0 = A + (size_t)(m0 + rg * 16 + g) * lda;
              const float* r8 = r0 + (size_t)8 * lda;
              a[rg][0] = pack_bf16_at(r0 + k);
              a[rg][1] = pack_bf16_at(r8 + k);
              a[rg][2] = pack_bf16_at(r0 + k + 8);
              a[rg][3] = pack_bf16_at(r8 + k + 8);
            }
          }
          unsigned b[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned* w = wb + (x * F + n0 + j * 8 + g) * KBW;
            b[j][0] = w[(s * 8 + t) ^ sw];
            b[j][1] = w[(s * 8 + t + 4) ^ sw];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int rg = 0; rg < RG; ++rg)
              mma_bf16(d[x][rg][j], a[rg], b[j]);
        }
      }
    } else {
#pragma unroll
    for (int s = 0; s < RW / 8; ++s) {
      const int k = ch * RW + s * 8 + t;  // depth of the A words k, k + 4
      unsigned ah[RG][4], al[RG][4];
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        if (x == 0 || MODE == 2) {
          const float* A = x == 0 ? A1 : A2;
#pragma unroll
          for (int rg = 0; rg < RG; ++rg) {
            const float* r0 = A + (size_t)(m0 + rg * 16 + g) * lda;
            const float* r8 = r0 + (size_t)8 * lda;
            split_tf32_mma(r0[k], ah[rg][0], al[rg][0]);
            split_tf32_mma(r8[k], ah[rg][1], al[rg][1]);
            split_tf32_mma(r0[k + 4], ah[rg][2], al[rg][2]);
            split_tf32_mma(r8[k + 4], ah[rg][3], al[rg][3]);
          }
        }
        unsigned bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2* w = wc + (x * F + n0 + j * 8 + g) * RW;
          const uint2 wk = w[(s * 8) ^ o0], wk4 = w[(s * 8) ^ o0 ^ 4];
          bh[j][0] = wk.x, bh[j][1] = wk4.x, bl[j][0] = wk.y, bl[j][1] = wk4.y;
        }
        // lo*hi, hi*lo, hi*hi of every tile in turn: RG NT independent
        // accumulators between two dependent products
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[x][rg][j], al[rg], bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[x][rg][j], ah[rg], bl[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[x][rg][j], ah[rg], bh[j]);
      }
    }
    }
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
      for (int rg = 0; rg < RG; ++rg)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[x][rg][j][e] += d[x][rg][j][e];
    slot ^= 1;
  }
  __syncthreads();  // every warp is done reading A: D may overwrite it
#pragma unroll
  for (int x = 0; x < NX; ++x) {
    float* D = x == 0 ? D1 : D2;
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // (n, n + 1) as one 8-byte store
        const int m = m0 + rg * 16 + g, n = n0 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(D + m * ldd + n) =
            make_float2(tot[x][rg][j][0], tot[x][rg][j][1]);
        *reinterpret_cast<float2*>(D + (m + 8) * ldd + n) =
            make_float2(tot[x][rg][j][2], tot[x][rg][j][3]);
      }
  }
  __syncthreads();
  return slot;
}

template <int F, bool FIRST>
__global__ void __launch_bounds__(kThreads, 1)
pair_fwd_kernel(const float* __restrict__ np_, const float* __restrict__ rbf,
                const float* __restrict__ dir, const float* __restrict__ adj,
                const float* __restrict__ force,
                const uint2* __restrict__ wprep,
                float* __restrict__ rowpart, int N, int Fg_, int R, int n_it,
                int n_jt, int n_tiles) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = K1Shape<F>;
  constexpr int C = F / 32;
  constexpr int LD = S::LD;
  constexpr int TJ = S::TJ, M = S::M;
  const int Rp = pad32(R), lr = Rp + 4;
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // 2 x RING
  float* x_s = smem + 4 * S::RING;   // M x LD: me, then msg
  float* p1_s = x_s + M * LD;        // M x LD: p1, h1, phi1
  float* p2_s = p1_s + M * LD;       // M x LD: p2, h2, phi2
  float* rbf_s = p2_s + M * LD;      // M x lr
  float* npi_s = rbf_s + M * lr;     // TI x F
  float* npj_s = npi_s + TI * F;     // TJ x F
  float* fj_s = npj_s + TJ * F;      // 3 x TJ x F
  float* adj_s = fj_s + 3 * TJ * F;  // M
  float* dir_s = adj_s + M;          // 3 x M

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;
  // the products of a tile, in the order of the prepared weights (offsets
  // in uint2: kEPP elements of the prepared type)
  constexpr int NXB = FIRST ? 1 : 2;  // weights of p's and phi's chunks
  const size_t wbr = (size_t)NXB * F * F / kEPP;
  const K1W w_me = {wprep, Rp, 1};
  const K1W w_p = {wprep + (size_t)F * Rp / kEPP, F, NXB};
  const K1W w_phi = {w_p.b + wbr, F, NXB};
  const K1W none = {nullptr, 0, 0};

  int slot = 0;  // the ring slot of the next product's first chunk
  if ((int)blockIdx.x < n_tiles) k1_stage<F>(w_me, 0, ring);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool more = tile + (int)gridDim.x < n_tiles;
    const int rest = tile / n_jt, jt = tile - rest * n_jt;
    const int b = rest / n_it, it = rest - b * n_it;
    const int i0 = it * TI, j0 = jt * TJ, i = i0 + warp;
    __syncthreads();  // the last tile's reads of the tile buffers are done
    for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
      const int il = idx / F, f = idx - il * F;
      npi_s[idx] = i0 + il < N && f < Fg
                       ? np_[((size_t)b * N + i0 + il) * Fg + f]
                       : 0.0f;
    }
    for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
      const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
      npj_s[idx] = j < N && f < Fg ? np_[((size_t)b * N + j) * Fg + f] : 0.0f;
    }
    if (!FIRST) {
      for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
        const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
        const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
        fj_s[idx] = j < N && f < Fg ? force[((size_t)b * 3 + d) * nfg +
                                            (size_t)j * Fg + f]
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
    // me, then msg = me np_i np_j adj in place; inv1 over the tile's j
    slot = k1_prod<F, 0>(rbf_s, nullptr, lr, w_me, w_p, slot, ring, x_s,
                         nullptr, LD);
    float inv_acc[C], eq_acc[3][C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      inv_acc[c] = 0.0f;
      eq_acc[0][c] = eq_acc[1][c] = eq_acc[2][c] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c, o = p * LD + f;
        const float m = x_s[o] * npi_s[warp * F + f] * npj_s[r * F + f] * a;
        x_s[o] = m;
        inv_acc[c] += m;
      }
    }
    // p1, p2; h = silu(p); phi = h @ Wb (the second branch is skipped at
    // the first layer: force_node is zero)
    slot = k1_prod<F, FIRST ? 0 : 1>(x_s, nullptr, LD, w_p, w_phi, slot,
                                     ring, p1_s, p2_s, LD);
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        p1_s[o] = silu_fast(p1_s[o]);
        if (!FIRST) p2_s[o] = silu_fast(p2_s[o]);
      }
    slot = k1_prod<F, FIRST ? 0 : 2>(p1_s, p2_s, LD, w_phi,
                                     more ? w_me : none, slot, ring, p1_s,
                                     p2_s, LD);
    // eq[d,i] += phi1 adj dir[d,i,j] + phi2 adj force[d,j]
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r;
      const float a = adj_s[p];
      const float d0 = dir_s[p], d1 = dir_s[M + p], d2 = dir_s[2 * M + p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c, o = p * LD + f;
        const float phi = p1_s[o] * a;
        eq_acc[0][c] += phi * d0;
        eq_acc[1][c] += phi * d1;
        eq_acc[2][c] += phi * d2;
      }
    }
    if (!FIRST) {
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r;
        const float a = adj_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const float phi = p2_s[p * LD + f] * a;
          eq_acc[0][c] += phi * fj_s[(0 * TJ + r) * F + f];
          eq_acc[1][c] += phi * fj_s[(1 * TJ + r) * F + f];
          eq_acc[2][c] += phi * fj_s[(2 * TJ + r) * F + f];
        }
      }
    }
    // this tile's part of the row sums over j
    if (i < N) {
      float* rp = rowpart + ((size_t)b * n_jt + jt) * kRowSlots * nf +
                  (size_t)i * F;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        rp[f] = inv_acc[c];
#pragma unroll
        for (int d = 0; d < 3; ++d) rp[(1 + d) * nf + f] = eq_acc[d][c];
      }
    }
  }
}

// inv1 = sum_jt rowpart[., jt, 0], eq[d] = sum_jt rowpart[., jt, 1+d]:
// fixed summation order.
__global__ void pair_fwd_rowsum_kernel(float* __restrict__ inv1,
                                       float* __restrict__ eq,
                                       const float* __restrict__ rowpart,
                                       int B, int N, int F, int Fg,
                                       int n_jt) {
  const size_t nf = (size_t)N * F, nfg = (size_t)N * Fg;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nfg) return;
  const size_t b = idx / nfg, remg = idx - b * nfg;
  const size_t rem = padded_at(remg, Fg, F);
  float s[kRowSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int jt = 0; jt < n_jt; ++jt) {
    const float* r = rowpart + (b * n_jt + jt) * kRowSlots * nf + rem;
#pragma unroll
    for (int k = 0; k < kRowSlots; ++k) s[k] += r[k * nf];
  }
  inv1[idx] = s[0];
  for (int d = 0; d < 3; ++d) eq[(b * 3 + d) * nfg + remg] = s[1 + d];
}

// Scratch of one K2 launch, in floats: the prepared weights, the row and
// column partials and, with weight cotangents, one partial per block.
size_t bwd_scratch_floats(int B, int N, int F, int R, bool wgrad) {
  const size_t n_it = (N + TI - 1) / TI;
  const size_t n_jt = (N + k2_tj(F) - 1) / k2_tj(F);
  const size_t nf = (size_t)N * F;
  return 2 * k2_prep_offset(F, R, 10) + B * n_jt * nf +
         B * n_it * kColSlots * nf +
         (wgrad ? B * n_it * n_jt * wgrad_size(F, R) : 0);
}

// Scratch of one K1 launch, in floats: the prepared weights and the row
// partials.
size_t fwd_scratch_floats(int B, int N, int F, int R) {
  const size_t n_jt = (N + k1_tj(F) - 1) / k1_tj(F);
  return 2 * k1_prep_pairs(F, R) + B * n_jt * kRowSlots * (size_t)N * F;
}

template <int F, bool FIRST>
cudaError_t launch_fwd(const float* const* in, float* inv1, float* eq,
                       float* scratch, int B, int N, int Fg, int R,
                       int max_blocks, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<F>(R) * sizeof(float);
  auto kern = pair_fwd_kernel<F, FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_it = (N + TI - 1) / TI;
  const int n_jt = (N + K1Shape<F>::TJ - 1) / K1Shape<F>::TJ;
  const int n_tiles = B * n_it * n_jt;
  const int n_blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  if (n_blocks < 1) return cudaErrorInvalidValue;
  uint2* wprep = reinterpret_cast<uint2*>(scratch);
  float* rowpart = scratch + 2 * k1_prep_pairs(F, R);
  const size_t want = (k1_prep_pairs(F, R) + 255) / 256;
  pair_fwd_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                         stream>>>(in[5], in[6], in[7], in[8], in[9], wprep,
                                   F, Fg, R, FIRST ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kern<<<n_blocks, kThreads, smem, stream>>>(in[0], in[1], in[2], in[3],
                                             in[4], wprep, rowpart, N, Fg, R,
                                             n_it, n_jt, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((size_t)B * N * Fg + 255) / 256);
  pair_fwd_rowsum_kernel<<<grid, 256, 0, stream>>>(inv1, eq, rowpart, B, N,
                                                   F, Fg, n_jt);
  return cudaGetLastError();
}

// in: the ten inputs of K1 then dinv1, deq; out: dnp, drbf, ddir, dforce,
// dw.
template <int F, bool FIRST, bool WGRAD>
cudaError_t launch_bwd(const float* const* in, float* const* out,
                       float* scratch, int B, int N, int Fg, int R,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<F>(R) * sizeof(float);
  auto kern = pair_bwd_kernel<F, FIRST, WGRAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_it = (N + TI - 1) / TI;
  const int n_jt = (N + K2Shape<(F > 128)>::TJ - 1) / K2Shape<(F > 128)>::TJ;
  const size_t nf = (size_t)N * F;
  uint2* wprep = reinterpret_cast<uint2*>(scratch);
  float* rowpart = scratch + 2 * k2_prep_offset(F, R, 10);
  float* colpart = rowpart + (size_t)B * n_jt * nf;
  float* wpart = colpart + (size_t)B * n_it * kColSlots * nf;
  const size_t want = (k2_prep_offset(F, R, 10) + 255) / 256;
  pair_bwd_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                         stream>>>(in[5], in[6], in[7], in[8], in[9], wprep,
                                   F, Fg, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_blocks = B * n_it * n_jt;
  kern<<<n_blocks, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], wprep, in[10], in[11], out[1],
      out[2], rowpart, colpart, wpart, N, Fg, R, n_it, n_jt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((size_t)B * N * Fg + 255) / 256);
  pair_bwd_nodesum_kernel<<<grid, 256, 0, stream>>>(
      out[0], out[3], rowpart, colpart, B, N, F, Fg, n_it, n_jt,
      FIRST ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || !WGRAD) return err;
  const size_t n = wgrad_size(Fg, R);
  const size_t n_valid = FIRST ? (size_t)R * Fg + 2 * (size_t)Fg * Fg : n;
  pair_bwd_wsum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      out[4], wpart, n_blocks, R, F, Fg, n_valid);
  return cudaGetLastError();
}

template <int F>
cudaError_t dispatch_bwd(bool first, bool wgrad, const float* const* in,
                         float* const* out, float* scratch, int B, int N,
                         int Fg, int R, cudaStream_t s) {
#define NN_BWD(FI, WG) \
  return launch_bwd<F, FI, WG>(in, out, scratch, B, N, Fg, R, s)
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
// fp32, contiguous, on the device of `stream`. Any F this library runs
// (library_runs); else cudaErrorInvalidValue.
// Scratch: 16-byte aligned, nn_pair_scratch_floats(B, N, F, R, 2) floats;
// max_blocks bounds the grid (the wrapper passes the SM count).
int nn_pair_fwd(const float* np_, const float* rbf, const float* dir,
                const float* adj, const float* force, const float* We,
                const float* W1a, const float* W1b, const float* W2a,
                const float* W2b, float* inv1, float* eq, float* scratch,
                int B, int N, int F, int R, int first_layer, int max_blocks,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[10] = {np_, rbf, dir, adj, force, We, W1a, W1b, W2a, W2b};
  if (!library_runs(F)) return (int)cudaErrorInvalidValue;
  return first_layer ? launch_fwd<NN_WIDTH, true>(in, inv1, eq, scratch, B,
                                                  N, F, R, max_blocks, s)
                     : launch_fwd<NN_WIDTH, false>(in, inv1, eq, scratch, B,
                                                   N, F, R, max_blocks, s);
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
  if (!library_runs(F)) return (int)cudaErrorInvalidValue;
  return (int)dispatch_bwd<NN_WIDTH>(first, wgrad, in, out, scratch, B, N, F,
                                     R, s);
}

// Scratch of one K2 launch without (kind 0) or with (kind 1) weight
// cotangents, or of one K1 launch (kind 2), in floats, for true width F.
size_t nn_pair_scratch_floats(int B, int N, int F, int R, int kind) {
  const int Fp = padded_width(F);
  return kind == 2 ? fwd_scratch_floats(B, N, Fp, R)
                   : bwd_scratch_floats(B, N, Fp, R, kind != 0);
}

}  // extern "C"
