// Fused neighbour-list (K-list) pair-interaction layer for Hopper (sm_90a).
//
// Replaces the TPU kernels of newtonnet_tpu/ops/pallas_klist.py:
// _fwd_kernel (K5), _bwd_kernel (K6), _dual_fwd_kernel (K7) and
// _dual_bwd_kernel (K8). All are templated on the padded feature width F
// (a multiple of 32), on FIRST (the stack's first layer: cat holds np_j
// only, C = F, and the phi2 branch is skipped) and on the edge storage type
// E (float or __nv_bfloat16) of cat, rbf and their tangents; every read
// converts to fp32, and K6/K8 store the per-edge cotangents dcat, dcatdot
// and drbf in E. K6 is also templated on WGRAD (the five weight
// cotangents; off in the force pass). R (radial basis), N (atoms), K (list
// width) and the tensors' true width Fg (1 <= Fg <= F) are runtime.
//
// Any width: the tiles, rings and slot buffers hold F columns. Every
// F-wide tensor is read at its true width Fg, the edge tensors cat and
// catdot (blocks at offsets d*Fg) included, with the pad lanes Fg..F
// zero-filled in registers or shared memory; outputs are stored at Fg
// (dcat, dcatdot included). No edge tensor is copied at another width.
// The weight preparations write zero pad rows and columns (K8, which
// stages the weights as they are, reads a zero-padded copy that its launch
// writes first), so the pad lanes of every slot buffer stay zero (silu(0)
// = 0) and change no sum. The weight partials are kept at F; the kernel
// that sums them writes the cotangents at Fg.
//
// Computation, per molecule b, atom i and list slot k (neighbour j):
//     npj = cat[i,k,:F], force_j[d] = cat[i,k,(d+1)F:(d+2)F]
//     me  = rbf[i,k] @ We,  msg = me * np_i * npj * mask[i,k]
//     inv1[i] = sum_k msg
//     phi1 = (silu(msg @ W1a) @ W1b) * mask,  phi2 = (silu(msg @ W2a) @ W2b) * mask
//     eq[d,i] = sum_k phi1 * dir[d,i,k] + phi2 * force_j[d]
// K6 is its reverse: dnpi, dcat (per slot), drbf, ddir and the weight
// cotangents. K7 carries a position tangent through the same chain (npidot,
// catdot, rbfdot, dirdot; the weights carry none) and K8 is its reverse:
// dnpi, dnpidot, dcat, dcatdot and the weight cotangents (rbf/dir get none:
// the parameter-gradient surrogate of train/fastgrad.py holds the geometry
// constant).
//
// What bounds it on this card: operations. Per slot K5 does 2(R*F + 4F^2)
// flops of matrix products (136 kflop at F=128, R=20) and reads C+R+4 edge
// values, far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// flop/byte); K6 about 2x K5, K7 2x, K8 about 6x.
//
// Design: every kernel multiplies on the tensor cores in 3xTF32, at
// fp32-level accuracy (no 1xTF32 anywhere; the notes above
// klist_fwd_kernel, klist_bwd_kernel, klist_dual_fwd_kernel and
// klist_dual_bwd_kernel). Warp w owns the list slots of its atoms and lane l
// the feature columns l+32c in the elementwise chain. The j-side operand is
// per slot here, not per column: it is not staged in shared memory (4F
// floats per slot would not fit beside the chain) but read from device
// memory (or L2, where prefetched) where it is used, each warp reading one
// slot's row of F contiguous values at a time (coalesced). Sums over k are
// per-thread register sums, the cotangents of the j side leave as per-slot
// outputs (gather_nodes' backward sums them onto atoms outside), so no sum
// crosses blocks except the weight cotangents: each block writes its
// partial to scratch and a second kernel sums them in a fixed order. No
// float atomics: a run gives the same bits every time.
//
// Shared memory at F=128, R=20: K5 206 KB, K6 214 KB, K7 223 KB, K8
// 215 KB. The host functions return the cudaError_t of the launch.
//
// bf16 mode (a library built with -DNN_BF16: kBF; the JAX package's
// pallas_dot_dtype bfloat16) of K5-K8. The Pallas K-list kernels round
// to bf16 both operands of every product (pallas_klist.py `_mk_dot`,
// `_mk_dotT`: the chains me, p, phi and, in K7/K8, their tangents medot,
// pdot, phidot; the cotangent products dh, dmsg, drbf of K6 and dh, dhdot,
// dmsg, dmsgdot of K8; the weight cotangents) and accumulate in fp32. Here
// each runs as mma.sync m16n8k16 bf16 with fp32 accumulation
// (bf16_mma.cuh), one per 16 depth steps of a 16 x 8 tile where 3xTF32
// takes six m16n8k8. The weights are rounded once per launch by the prep
// kernels into chunks of 32 depth steps (two k-steps), rows of 16 words
// XOR-swizzled (bf16_swz) so that the B fragments' 32-bit loads hit 32
// banks: klist_prep_kernel (K5/K6, in their product table and order,
// chunks of one weight or of each of two, through the same two-slot ring),
// klist_dual_fwd_prep_kernel (K7, n-major rows, swizzled as they stage,
// through a two-slot ring with one chunk in flight) and
// klist_dual_bwd_prep_kernel (K8, its products' B operands chunk-major,
// through a ring of up to four slots in the space of the fp32 one). The
// slot operands are rounded where a fragment is loaded (rounding is
// idempotent); K7 keeps its slot buffers' (hi, lo) layout, holding (x, 0).
// Every elementwise operation and every sum stays fp32, on the same fp32
// slot buffers, the weight partials are summed in the same fixed order,
// and bf16 edges are read into fp32 first, so the kernels and the plain
// versions (ops/fused_klist.py, dot_dtype='bfloat16') differ only in
// summation order. The fp32 libraries compile the code they compiled
// before bf16 mode existed (`if constexpr` on kBF).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16_mma.cuh"

namespace {

// The library's mode: K5-K8 with the Pallas kernels' bf16 products
// (ops/_build.py builds it with -DNN_BF16 for pallas_dot_dtype bfloat16)
// or fp32.
#ifdef NN_BF16
constexpr bool kBF = true;
#else
constexpr bool kBF = false;
#endif
// Elements of K5-K7's prepared weights' type per uint2 of the scratch:
// four bf16, or one (hi, lo) tf32 pair.
constexpr int kEPP = kBF ? 4 : 1;
// bf16 weight chunks: depth steps (two m16n8k16 k-steps) and 32-bit words
// per row
constexpr int KB = 32;
constexpr int KBW = KB / 2;

// The XOR swizzle of a bf16 chunk row of 16 words: word w of row r at w ^
// bf16_swz(r), so that the B fragments' 32-bit loads (rows g = 0..7 at a
// stride of 16 words) hit 32 banks.
__host__ __device__ constexpr int bf16_swz(int r) {
  return ((r >> 1) & 3) << 2;
}

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TI = kWarps;  // atoms i per block in K6-K8: one per warp
// list slots per tile in K7/K8: 4, and past F=128 (wide) 2
__host__ __device__ constexpr int tj_d(int F) { return F > 128 ? 2 : 4; }

// The XOR swizzle of a ring row of rw pairs (rw >= 8): pair q of row r at
// q ^ ring_swz(r, rw), so that the B fragments' 64-bit loads spread over
// the banks.
__host__ __device__ constexpr int ring_swz(int r, int rw) {
  return (r & (rw >= 16 ? 3 : 1)) << 2;
}

typedef __nv_bfloat16 bf16;

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
// width F.
__host__ __device__ inline size_t padded_at(size_t e, int Fg, int F) {
  return kPadded ? e / Fg * F + e % Fg : e;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
__device__ __forceinline__ float d2silu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.0f - s) * (2.0f + x * (1.0f - 2.0f * s));
}

__host__ __device__ inline size_t slot_at(int b, int i, int k, int N,
                                          int K) {
  return ((size_t)b * N + i) * K + k;
}

// Row-side inputs of the block's `rows` atoms (zero past N and past Fg):
// rows x F, from rows of Fg.
__device__ void load_rows(const float* __restrict__ src, int b, int i0,
                          int N, int F, int Fg, float* dst, int rows = TI) {
  for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    dst[idx] = i0 + il < N && f < Fg
                   ? src[((size_t)b * N + i0 + il) * Fg + f]
                   : 0.0f;
  }
}

// The tile's per-slot geometry: mask, dir (and with DUAL dirdot), rbf (and
// rbfdot), converted to fp32. Slots past N or K read as zero, so they
// contribute nothing and stay finite (silu(0) = 0).
template <int TJ, bool DUAL, class E>
__device__ void load_slots(const float* __restrict__ mask,
                           const float* __restrict__ dir,
                           const float* __restrict__ dirdot,
                           const E* __restrict__ rbf,
                           const E* __restrict__ rbfdot, int b, int i0,
                           int k0, int N, int K, int R, float* mask_s,
                           float* dir_s, float* dirdot_s, float* rbf_s,
                           float* rbfdot_s) {
  constexpr int M = TI * TJ;
  constexpr int NG = DUAL ? 7 : 4;  // 0: mask, 1-3: dir, 4-6: dirdot
  for (int idx = threadIdx.x; idx < NG * M; idx += kThreads) {
    const int g = idx / M, p = idx - g * M;
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    const bool ok = i < N && k < K;
    if (g == 0) {
      mask_s[p] = ok ? mask[slot_at(b, i, k, N, K)] : 0.0f;
    } else if (g < 4) {
      dir_s[(g - 1) * M + p] =
          ok ? dir[slot_at(b * 3 + g - 1, i, k, N, K)] : 0.0f;
    } else {
      dirdot_s[(g - 4) * M + p] =
          ok ? dirdot[slot_at(b * 3 + g - 4, i, k, N, K)] : 0.0f;
    }
  }
  for (int idx = threadIdx.x; idx < M * R; idx += kThreads) {
    const int p = idx / R, r = idx - p * R;
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    const bool ok = i < N && k < K;
    const size_t at = slot_at(b, i, k, N, K) * R + r;
    rbf_s[idx] = ok ? ld(rbf + at) : 0.0f;
    if (DUAL) rbfdot_s[idx] = ok ? ld(rbfdot + at) : 0.0f;
  }
}

// Weight cotangents inside one block's partial slot (and inside the
// reduced output): We, W1a, W1b, W2a, W2b one after the other.
__host__ __device__ inline size_t wgrad_size(int F, int R) {
  return (size_t)R * F + (size_t)4 * F * F;
}

// Element e of the weight cotangents at width Fg in a block's partial at
// width F.
__host__ __device__ inline size_t wgrad_padded_at(size_t e, int R, int F,
                                                  int Fg) {
  if (!kPadded) return e;
  const size_t rf = (size_t)R * Fg, ff = (size_t)Fg * Fg;
  if (e < rf) return padded_at(e, Fg, F);
  const size_t k = (e - rf) / ff;
  return (size_t)R * F + k * F * F + padded_at(e - rf - k * ff, Fg, F);
}

// The five weights at width Fg copied to width F with zero pad rows and
// columns (We R x F, then W1a, W1b, W2a, W2b F x F), for K8, which stages
// them as they are.
__global__ void klist_pad_weights_kernel(const float* __restrict__ We,
                                         const float* __restrict__ W1a,
                                         const float* __restrict__ W1b,
                                         const float* __restrict__ W2a,
                                         const float* __restrict__ W2b,
                                         float* __restrict__ out, int F,
                                         int Fg, int R) {
  const size_t rf = (size_t)R * F, ff = (size_t)F * F;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < rf + 4 * ff; e += (size_t)gridDim.x * blockDim.x) {
    const size_t k = e < rf ? 0 : 1 + (e - rf) / ff;
    const size_t local = k == 0 ? e : e - rf - (k - 1) * ff;
    const int r = (int)(local / F), n = (int)(local % F);
    const float* W = k == 0 ? We : k == 1 ? W1a : k == 2 ? W1b
                     : k == 3 ? W2a : W2b;
    out[e] = n < Fg && (k == 0 || r < Fg) ? W[(size_t)r * Fg + n] : 0.0f;
  }
}

// ------------------------------------------------------------------ K8 --
// What bounds K8: its products, about 6x K5's flops per slot (272 GFLOP
// per full layer at the box shape B=1, N=4096, K=88, F=128, R=20), above
// the fp32 ridge. The CUDA-core version (per-row FMA loops) capped near
// half the FMA rate on shared-memory loads, its weight chunks loaded with
// no product in flight, and its weight-cotangent partials were rewritten every tile. So:
//
// * Products on the tensor cores at fp32-level accuracy:
//   mma.sync.m16n8k8 tf32 with the 3xTF32 split. Each operand x is split
//   as hi = tf32_rna(x), lo = tf32_rna(x - hi), and the sum takes
//   lo*hi + hi*lo + hi*hi in fp32 (lo*lo, about 2^-22 relative, is
//   dropped). Plain 1xTF32 (about 3 digits) is not used anywhere.
// * mma_rows: the 32-slot tile's M x Q @ Q x F products. Warp w owns the
//   16-row half (w & 1) and F/4 columns as F/32 tiles of 16 x 8. The
//   weight streams through a ring of KSTAGES chunks of KC8 rows by
//   cp.async: three chunks load while one multiplies, one __syncthreads
//   per chunk. The ring holds W rows at stride F+8, or W^T rows (a
//   transposed product) at stride KC8+4, so the B fragments' 32 lanes hit
//   32 banks; the slot buffers have stride F+4, so the A fragments do
//   too. The products land in c_s and each thread reads back the entries
//   the elementwise code of the chain owns (slot rows of its warp, columns
//   lane + 32c), so that code is the CUDA-core version's.
// * wgrad_tc: the weight cotangents dW = A1^T B1 + A2^T B2 over the tile's
//   32 slots on the same tensor cores, summed in registers; the partial's
//   old values are loaded before the products and the sum is stored once
//   per tile.
// * Fewer, larger partials: the grid is at most one block per SM (the
//   wrapper passes the SM count), and each block walks the atom tiles
//   blockIdx, blockIdx + gridDim, ..., summing all of them into one
//   partial: 132 partials instead of 512 at the box shape. The partials
//   are then summed in a fixed order (klist_wsum_kernel); no atomics.
// * Occupancy: one block of 8 warps per SM (about 215 KB of shared memory
//   at F=128, R=20); the cp.async ring keeps the weights' latency off the
//   products.
// * Issue: the splits round with integer operations (tf32_rna), not
//   through the conversion unit, and mma_product and wgrad_tc are out of
//   line with the branch body unrolled once, so that the kernel's code
//   fits the instruction cache (inlined, the same kernel ran 27% slower).
// * Past F=128 (wide) a tile has 2 slots of its 8 atoms (16 slot rows:
//   each warp takes all of them and an eighth of the columns), chunks of 8
//   depth rows in a ring of 3, so that it fits: 217 KB at F=256, R=20.
// * bf16 mode: the products' B operands are prepared once per launch
//   (klist_dual_bwd_prep_kernel, into the launch's wpart after the
//   partials) and stream as 32-depth chunks of bf16 words through a ring
//   of 4 slots (2 past F=128) in the fp32 ring's space; the shared memory
//   is the fp32 mode's.
template <int F>
struct K8Shape {
  static constexpr int TJ = tj_d(F);    // list slots per tile
  static constexpr int M = TI * TJ;     // slot rows of a tile
  static constexpr int KC = F > 128 ? 8 : 16;     // depth rows a chunk
  static constexpr int STAGES = F > 128 ? 3 : 4;  // chunk slots of the ring
  static constexpr int RG = M / 16;     // 16-row groups of a product
  static constexpr int CG = kWarps / RG;  // its column groups
  static constexpr int LD = F + 4;      // slot buffers (M x LD)
  static constexpr int WLD = F + 8;     // a chunk of W rows (KC x WLD)
  static constexpr int TLD = KC + 4;    // a chunk of W^T rows (F x TLD)
  static constexpr int RING =
      KC * WLD > F * TLD ? KC * WLD : F * TLD;  // floats per ring slot
  // bf16 mode: chunk slots of KB depth steps (F rows of KBW words) in the
  // same space
  static constexpr int BSTAGES = F > 128 ? 2 : 4;
  static_assert(BSTAGES * F * KBW <= STAGES * RING, "the bf16 ring fits");
};

// K8's prepared weights in bf16 mode (klist_dual_bwd_prep_kernel), in
// 32-bit words: product 0 is We (depth pad32(R)), then per branch br
// products 1 + 4br.. 4 + 4br: Wa, Wb, Wb^T, Wa^T (depth F).
__host__ __device__ inline size_t k8_prep_offset(int F, int R, int prod) {
  return prod == 0 ? 0
                   : (size_t)F * pad32(R) / 2 +
                         (size_t)(prod - 1) * F * F / 2;
}

// The B operands of K8's products rounded to bf16, once per launch (bf16
// mode): product prod of k8_prep_offset is B(q, n) = W[q][n] (We, Wa, Wb)
// or W[n][q] (Wb^T, Wa^T), zero past R and past the true width Fg, each
// chunk-major in chunks of KB depth steps by F rows n of KBW words, word w
// of row n at n*KBW + (w ^ bf16_swz(n)) holding depths 2w, 2w + 1 of the
// chunk (the lower in the low half): a chunk stages as one contiguous
// copy, and its B fragments' loads hit 32 banks, as K5/K6's bf16 chunks.
__global__ void klist_dual_bwd_prep_kernel(const float* __restrict__ We,
                                           const float* __restrict__ W1a,
                                           const float* __restrict__ W1b,
                                           const float* __restrict__ W2a,
                                           const float* __restrict__ W2b,
                                           unsigned* __restrict__ out, int F,
                                           int Fg, int R) {
  const size_t n_e = k8_prep_offset(F, R, 1), ff = (size_t)F * F / 2;
  const size_t total = k8_prep_offset(F, R, 9);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int prod = e < n_e ? 0 : 1 + (int)((e - n_e) / ff);
    const size_t local = e < n_e ? e : (e - n_e) % ff;
    const int ch = (int)(local / (F * KBW)), rem = (int)(local % (F * KBW));
    const int n = rem / KBW, w = (rem % KBW) ^ bf16_swz(n);
    const int kind = (prod - 1) & 3, br = (prod - 1) >> 2;  // prod > 0
    const float* W = kind == 0 || kind == 3 ? (br ? W2a : W1a)
                                            : (br ? W2b : W1b);
    unsigned word = 0;
    for (int h = 0; h < 2; ++h) {
      const int q = ch * KB + 2 * w + h;
      float v;
      if (prod == 0)
        v = q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f;
      else if (q >= Fg || n >= Fg)
        v = 0.0f;
      else
        v = kind < 2 ? W[(size_t)q * Fg + n] : W[(size_t)n * Fg + q];
      word |= (unsigned)bf16_bits(v) << (16 * h);
    }
    out[e] = word;
  }
}

// x rounded to tf32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, from two integer operations. The
// conversion unit issues 16 results per clock per SM, a quarter of the
// integer rate, and the splits took most of a product's time through it.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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
// bring the 128-byte line of device memory at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
#endif

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

// Rows [q0, q0 + KC8) of the depth of B into one ring slot: W (Q x F) rows
// at stride WLD, or with TRANS (W is F x Q; needs Q % KC8 == 0) the
// columns q0.. of every W row at stride TLD. 16-byte cp.async copies; a
// chunk past Q copies nothing.
template <int F, bool TRANS>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ W,
                                            int Q, int q0, float* buf) {
  using S = K8Shape<F>;
  constexpr int KC = S::KC;
  if (q0 >= Q) return;
  if (!TRANS) {
    const int qc = min(KC, Q - q0);
    for (int v = threadIdx.x; v < qc * (F / 4); v += kThreads) {
      const int qq = v / (F / 4), n = (v - qq * (F / 4)) * 4;
      cp_async16(buf + qq * S::WLD + n, W + (size_t)(q0 + qq) * F + n);
    }
  } else {
    for (int v = threadIdx.x; v < F * (KC / 4); v += kThreads) {
      const int n = v / (KC / 4), qq = (v - n * (KC / 4)) * 4;
      cp_async16(buf + n * S::TLD + qq, W + (size_t)n * Q + q0 + qq);
    }
  }
}

// c_s[m*LD + n] = sum_q A[m*lda + q] * B(q, n), q < Q, for the tile's M
// slot rows m: B(q, n) = W[q*F + n], or with TRANS W[n*Q + q]. Warp w
// computes the 16-row half (w & 1) and F/4 columns (wide: all 16 rows and
// F/8 columns). The weight streams through a ring of STAGES chunk slots:
// STAGES - 1 chunks are in flight while one multiplies, one __syncthreads
// per chunk. Every warp reads rows of other warps' slots, so A must be
// written before the call; it may be overwritten after it (the last
// barrier orders that). bf16 mode: W is the product's prepared B operand
// (klist_dual_bwd_prep_kernel; TRANS is in its layout), one bf16 mma per
// 16 depth steps. All threads of the
// block must call it. Not inlined: K8 runs 18 products per tile, and one
// copy of each of the two variants keeps the kernel's code small enough
// for the instruction cache.
template <int F, bool TRANS>
__device__ __noinline__ void mma_product(const float* __restrict__ A,
                                         int lda, int Q,
                                         const float* __restrict__ W,
                                         float* ring, float* c_s) {
  using S = K8Shape<F>;
  constexpr int NT = F / (8 * S::CG);  // 16 x 8 tiles per warp
  constexpr int KC = S::KC, KSTAGES = S::STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % S::RG) * 16, n0 = (warp / S::RG) * (F / S::CG);
  float d[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
  const float* a_lo = A + (size_t)(m0 + g) * lda;  // rows g and g + 8
  const float* a_hi = a_lo + (size_t)8 * lda;
  if constexpr (kBF) {
    // W is the prepared product (klist_dual_bwd_prep_kernel), its chunks
    // of KB depth steps streamed whole through a ring of BSTAGES slots,
    // BSTAGES - 1 in flight while one multiplies: one m16n8k16 bf16 mma
    // per 16 x 8 tile and 16 depth steps, A rounded to bf16 where its
    // fragments are loaded (zero past Q).
    constexpr int BST = S::BSTAGES, CHW = F * KBW;  // words of a chunk
    const unsigned* Wp = reinterpret_cast<const unsigned*>(W);
    unsigned* rw = reinterpret_cast<unsigned*>(ring);
    const int nch = (Q + KB - 1) / KB;
    auto stage = [&](int ch) {  // one commit group, empty past the last
      if (ch < nch)
        for (int v = threadIdx.x; v < CHW / 4; v += kThreads)
          cp_async16(rw + (ch % BST) * CHW + 4 * v,
                     Wp + (size_t)ch * CHW + 4 * v);
      cp_async_commit();
    };
    auto a_at = [&](const float* row, int k) {  // depths k, k + 1
      return pack_bf16(k < Q ? row[k] : 0.0f, k + 1 < Q ? row[k + 1] : 0.0f);
    };
    const int sw = bf16_swz(g);  // rows n0 + 8j + g: n & 7 == g
#pragma unroll
    for (int st = 0; st < BST - 1; ++st) stage(st);
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<BST - 2>();
      __syncthreads();  // chunk ch is in; every warp is done with ch - 1
      stage(ch + BST - 1);
      const unsigned* wc = rw + (ch % BST) * CHW;
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) {
        const int k = ch * KB + s * 16 + 2 * t;  // depth of the A words
        const unsigned a[4] = {a_at(a_lo, k), a_at(a_hi, k),
                               a_at(a_lo, k + 8), a_at(a_hi, k + 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned* wr = wc + (n0 + j * 8 + g) * KBW;
          const unsigned bw[2] = {wr[(s * 8 + t) ^ sw],
                                  wr[(s * 8 + t + 4) ^ sw]};
          mma_bf16(d[j], a, bw);
        }
      }
    }
  } else {
  const int nch = (Q + KC - 1) / KC;
#pragma unroll
  for (int st = 0; st < KSTAGES - 1; ++st) {  // one group per stage
    stage_chunk<F, TRANS>(W, Q, st * KC, ring + st * S::RING);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<KSTAGES - 2>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    stage_chunk<F, TRANS>(W, Q, (ch + KSTAGES - 1) * KC,
                          ring + ((ch + KSTAGES - 1) % KSTAGES) * S::RING);
    cp_async_commit();
    const float* wc = ring + (ch % KSTAGES) * S::RING;
    const int q0 = ch * KC, qc = min(KC, Q - q0);
    for (int kk = 0; kk < qc; kk += 8) {
      const int ka = q0 + kk + t, kb = kk + t;
      unsigned ah[4], al[4];
      split_tf32(ka < Q ? a_lo[ka] : 0.0f, ah[0], al[0]);
      split_tf32(ka < Q ? a_hi[ka] : 0.0f, ah[1], al[1]);
      split_tf32(ka + 4 < Q ? a_lo[ka + 4] : 0.0f, ah[2], al[2]);
      split_tf32(ka + 4 < Q ? a_hi[ka + 4] : 0.0f, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + g;
        const float b0 = kb >= qc ? 0.0f
                         : TRANS  ? wc[n * S::TLD + kb]
                                  : wc[kb * S::WLD + n];
        const float b1 = kb + 4 >= qc ? 0.0f
                         : TRANS      ? wc[n * S::TLD + kb + 4]
                                      : wc[(kb + 4) * S::WLD + n];
        unsigned bh[2], bl[2];
        split_tf32(b0, bh[0], bl[0]);
        split_tf32(b1, bh[1], bl[1]);
        mma3(d[j], ah, al, bh, bl);
      }
    }
  }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    c_s[(m0 + g) * S::LD + n] = d[j][0];
    c_s[(m0 + g) * S::LD + n + 1] = d[j][1];
    c_s[(m0 + g + 8) * S::LD + n] = d[j][2];
    c_s[(m0 + g + 8) * S::LD + n + 1] = d[j][3];
  }
  __syncthreads();
}

// acc[r][c] = sum_q A[(w*TJ + r)*lda + q] * B(q, l + 32c), q < Q, for the
// calling thread's warp w and lane l (the ownership of the elementwise code),
// through mma_product.
template <int F, bool TRANS>
__device__ __forceinline__ void mma_rows(const float* __restrict__ A,
                                         int lda, int Q,
                                         const float* __restrict__ W,
                                         float* ring, float* c_s,
                                         float (&acc)[tj_d(F)][F / 32]) {
  constexpr int LD = K8Shape<F>::LD, TJ = tj_d(F);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  mma_product<F, TRANS>(A, lda, Q, W, ring, c_s);
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < F / 32; ++c)
      acc[r][c] = c_s[(warp * TJ + r) * LD + lane + 32 * c];
}

// part[q*F + n] (+)= sum_p a1(p, q) B1[p*LD + n] (+ A2[p*lda + q] B2[p*LD +
// n] with TWO) over the tile's M slots (16, or a multiple of 32), q < qrows,
// where
// a1(p, q) = A1[p*lda + q], or silu_fast of it with SILU (h from p), as 16
// x 8 tensor-core tiles in 3xTF32: warp w takes the (16-row, 32-column) groups
// w, w + 8, ..., sums each 32 slots' products in fresh registers, adds them
// on the CUDA cores and adds the block's 16 x 32 block to its partial once
// (`init`, the block's first tile: overwrites). The partial's old values
// are loaded before the products, so their latency hides behind them. Each
// element has one owning thread and each block its own partial. Starts
// with a __syncthreads. Not inlined, as mma_product. K8 takes 32 slots (16
// wide) and two sources, K6 64 slots (32 wide) and one.
template <int F, int M = K8Shape<F>::M, bool SILU = false, bool TWO = true,
          bool BF = false>
__device__ __noinline__ void wgrad_tc(const float* __restrict__ A1,
                         const float* __restrict__ B1,
                         const float* __restrict__ A2,
                         const float* __restrict__ B2, int lda, int qrows,
                         float* __restrict__ part, bool init) {
  constexpr int LD = K8Shape<F>::LD;
  constexpr int NG = F / 32;  // 32-column groups per 16-row band
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  const int n_groups = (qrows + 15) / 16 * NG;
  for (int grp = warp; grp < n_groups; grp += kWarps) {
    const int qa = (grp / NG) * 16 + g, qb = qa + 8;
    const int nb = (grp % NG) * 32;
    float acc[4][4], old[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = h == 0 ? qa : qb;
        const bool keep = !init && q < qrows;
        old[j][2 * h] = keep ? part[(size_t)q * F + n] : 0.0f;
        old[j][2 * h + 1] = keep ? part[(size_t)q * F + n + 1] : 0.0f;
      }
    }
#pragma unroll
    constexpr int KH = M < 32 ? M : 32;  // slots summed in fresh registers
#pragma unroll
    for (int half = 0; half < M / KH; ++half) {
      float d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
#pragma unroll
      for (int src = 0; src < (TWO ? 2 : 1); ++src) {
        const float* A = src == 0 ? A1 : A2;
        const float* B = src == 0 ? B1 : B2;
        const bool silu = SILU && src == 0;
        if constexpr (BF) {  // both operands rounded to bf16 (K6's dotT)
#pragma unroll
          for (int kk = half * KH; kk < half * KH + KH; kk += 16) {
            const int p = kk + 2 * t;  // slots p, p + 1 and p + 8, p + 9
            auto av = [&](int pp, int q) {
              const float v = q < qrows ? A[pp * lda + q] : 0.0f;
              return silu ? silu_fast(v) : v;
            };
            const unsigned a[4] = {pack_bf16(av(p, qa), av(p + 1, qa)),
                                   pack_bf16(av(p, qb), av(p + 1, qb)),
                                   pack_bf16(av(p + 8, qa), av(p + 9, qa)),
                                   pack_bf16(av(p + 8, qb), av(p + 9, qb))};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = nb + j * 8 + g;
              const unsigned b[2] = {
                  pack_bf16(B[p * LD + n], B[(p + 1) * LD + n]),
                  pack_bf16(B[(p + 8) * LD + n], B[(p + 9) * LD + n])};
              mma_bf16(d[j], a, b);
            }
          }
          continue;
        }
#pragma unroll
        for (int kk = half * KH; kk < half * KH + KH; kk += 8) {
          const int p = kk + t;
          float av[4] = {qa < qrows ? A[p * lda + qa] : 0.0f,
                         qb < qrows ? A[p * lda + qb] : 0.0f,
                         qa < qrows ? A[(p + 4) * lda + qa] : 0.0f,
                         qb < qrows ? A[(p + 4) * lda + qb] : 0.0f};
          unsigned ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(silu ? silu_fast(av[e]) : av[e], ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = nb + j * 8 + g;
            unsigned bh[2], bl[2];
            split_tf32(B[p * LD + n], bh[0], bl[0]);
            split_tf32(B[(p + 4) * LD + n], bh[1], bl[1]);
            mma3(d[j], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = half == 0 ? d[j][e] : acc[j][e] + d[j][e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = h == 0 ? qa : qb;
        if (q >= qrows) continue;
        part[(size_t)q * F + n] = old[j][2 * h] + acc[j][2 * h];
        part[(size_t)q * F + n + 1] = old[j][2 * h + 1] + acc[j][2 * h + 1];
      }
    }
  }
}

// msg and msgdot on the tensor cores (mma_rows; slot buffers at stride
// K8Shape<F>::LD); cat rows of CW values, np_j their first Fg.
template <int F, class E>
__device__ void dual_messages_tc(const float* rbf_s, const float* rbfdot_s,
                                 int R, const float* __restrict__ We,
                                 float* ring, float* c_s, const float* npi_s,
                                 const float* npidot_s,
                                 const E* __restrict__ cat,
                                 const E* __restrict__ catdot, int CW, int Fg,
                                 int b, int i, int k0, int N, int K,
                                 const float* mask_s, float* msg_s,
                                 float* msgdot_s,
                                 float (&acc)[tj_d(F)][F / 32]) {
  constexpr int TJ = tj_d(F);
  constexpr int C = F / 32;
  constexpr int LD = K8Shape<F>::LD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  mma_rows<F, false>(rbf_s, R, R, We, ring, c_s, acc);  // me
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r, k = k0 + r;
    const bool ok = i < N && k < K;
    const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
    const float a = mask_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const float aj = ok && f < Fg ? ld(cat + at + f) : 0.0f;
      msg_s[p * LD + f] = acc[r][c] * npi_s[warp * F + f] * aj * a;
      msgdot_s[p * LD + f] = acc[r][c];
    }
  }
  mma_rows<F, false>(rbfdot_s, R, R, We, ring, c_s, acc);  // medot
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r, k = k0 + r;
    const bool ok = i < N && k < K;
    const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
    const float a = mask_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const float ai = npi_s[warp * F + f], aidot = npidot_s[warp * F + f];
      const float aj = ok && f < Fg ? ld(cat + at + f) : 0.0f;
      const float ajdot = ok && f < Fg ? ld(catdot + at + f) : 0.0f;
      const float me = msgdot_s[p * LD + f];
      msgdot_s[p * LD + f] =
          (acc[r][c] * ai * aj + me * aidot * aj + me * ai * ajdot) * a;
    }
  }
}

template <int F>
constexpr size_t dual_bwd_smem_floats(int R) {
  using S = K8Shape<F>;
  constexpr int M = S::M;
  return (size_t)S::STAGES * S::RING + (size_t)9 * M * S::LD +
         (size_t)4 * TI * F +
         (size_t)7 * M + (size_t)2 * M * R;
}

template <int F, bool FIRST, class E>
__global__ void __launch_bounds__(kThreads, 1)
klist_dual_bwd_kernel(const float* __restrict__ npi,
                      const float* __restrict__ npidot,
                      const E* __restrict__ cat, const E* __restrict__ catdot,
                      const E* __restrict__ rbf, const E* __restrict__ rbfdot,
                      const float* __restrict__ dir,
                      const float* __restrict__ dirdot,
                      const float* __restrict__ mask,
                      const float* __restrict__ We,
                      const float* __restrict__ W1a,
                      const float* __restrict__ W1b,
                      const float* __restrict__ W2a,
                      const float* __restrict__ W2b,
                      const float* __restrict__ di,
                      const float* __restrict__ dq,
                      const float* __restrict__ didot,
                      const float* __restrict__ dqdot,
                      float* __restrict__ dnpi, float* __restrict__ dnpidot,
                      E* __restrict__ dcat, E* __restrict__ dcatdot,
                      float* __restrict__ wpart, int N, int K, int Fg_, int R,
                      int n_itiles, int n_tiles) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = K8Shape<F>;
  constexpr int TJ = S::TJ;
  constexpr int M = S::M;
  constexpr int C = F / 32;
  constexpr int LD = S::LD;
  const int CW = FIRST ? Fg : 4 * Fg;
  extern __shared__ float smem[];
  float* ring = smem;  // STAGES x RING: weight chunks
  float* c_s = ring + S::STAGES * S::RING;  // M x LD: mma products
  float* msg_s = c_s + M * LD;         // M x LD: msg
  float* msgdot_s = msg_s + M * LD;    // M x LD: msgdot
  float* p_s = msgdot_s + M * LD;      // M x LD: p; tail: me
  float* pdot_s = p_s + M * LD;        // M x LD: pdot, then s'' pdot dhdot
  float* h_s = pdot_s + M * LD;        // M x LD: h
  float* hdot_s = h_s + M * LD;        // M x LD: hdot; tail: dme
  float* g_s = hdot_s + M * LD;        // M x LD: phi2, g, dp; tail: dmedot
  float* gdot_s = g_s + M * LD;        // M x LD: gdot, dpdot
  float* npi_s = gdot_s + M * LD;      // TI x F
  float* npidot_s = npi_s + TI * F;    // TI x F
  float* di_s = npidot_s + TI * F;     // TI x F
  float* didot_s = di_s + TI * F;      // TI x F
  float* mask_s = didot_s + TI * F;    // M
  float* dir_s = mask_s + M;           // 3 x M
  float* dirdot_s = dir_s + 3 * M;     // 3 x M
  float* rbf_s = dirdot_s + 3 * M;     // M x R
  float* rbfdot_s = rbf_s + M * R;     // M x R

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* wp = wpart + (size_t)blockIdx.x * wgrad_size(F, R);
  float acc[TJ][C], dmsg[TJ][C], dmsgdot[TJ][C];
  // the B operand of a product: the weight W, or in bf16 mode the
  // prepared product prod (k8_prep_offset), which the launch passes as We
  auto wt = [&](int prod, const float* W) {
    return kBF ? We + k8_prep_offset(F, R, prod) : W;
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first_tile = tile == (int)blockIdx.x;
    const int b = tile / n_itiles;
    const int i0 = (tile - b * n_itiles) * TI;
    const int i = i0 + warp;
    __syncthreads();  // the last tile's reads of the row buffers are done
    load_rows(npi, b, i0, N, F, Fg, npi_s);
    load_rows(npidot, b, i0, N, F, Fg, npidot_s);
    load_rows(di, b, i0, N, F, Fg, di_s);
    load_rows(didot, b, i0, N, F, Fg, didot_s);
    // dq, dqdot of the warp's atom (zero past N and Fg), read through L1
    // where they are used
    auto row3 = [&](const float* src, int d, int f) {
      return i < N && f < Fg
                 ? __ldg(src + (((size_t)b * 3 + d) * N + i) * Fg + f)
                 : 0.0f;
    };
    float dnp_acc[C], dnpdot_acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dnp_acc[c] = dnpdot_acc[c] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += TJ) {
      const bool init = first_tile && k0 == 0;
      __syncthreads();
      load_slots<TJ, true, E>(mask, dir, dirdot, rbf, rbfdot, b, i0, k0, N,
                              K, R, mask_s, dir_s, dirdot_s, rbf_s, rbfdot_s);
      dual_messages_tc<F, E>(rbf_s, rbfdot_s, R, wt(0, We), ring, c_s,
                             npi_s, npidot_s, cat, catdot, CW, Fg, b, i, k0,
                             N, K, mask_s, msg_s, msgdot_s, acc);

#pragma unroll 1  // one copy of the branch body: code size
      for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
        const float* Wa = br == 0 ? W1a : W2a;
        const float* Wb = br == 0 ? W1b : W2b;
        float* wpa = wp + (size_t)R * F + (size_t)(2 * br) * F * F;
        float* wpb = wpa + (size_t)F * F;
        mma_rows<F, false>(msg_s, LD, F, wt(1 + 4 * br, Wa), ring, c_s,
                           acc);  // p
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            p_s[o] = acc[r][c];
            h_s[o] = silu_f(acc[r][c]);
          }
        mma_rows<F, false>(msgdot_s, LD, F, wt(1 + 4 * br, Wa), ring, c_s,
                           acc);  // pdot
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            pdot_s[o] = acc[r][c];
            hdot_s[o] = dsilu_f(p_s[o]) * acc[r][c];
          }
        if (br == 1) {
          // phi2, phi2dot -> the per-slot force cotangents:
          // dcat[force_j[d]] = phi2 dq[d,i] + phi2dot dqdot[d,i],
          // dcatdot[force_j[d]] = phi2 dqdot[d,i]
          mma_rows<F, false>(h_s, LD, F, wt(2 + 4 * br, Wb), ring, c_s,
                             acc);
#pragma unroll
          for (int r = 0; r < TJ; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c)
              g_s[(warp * TJ + r) * LD + lane + 32 * c] =
                  acc[r][c] * mask_s[warp * TJ + r];
          mma_rows<F, false>(hdot_s, LD, F, wt(2 + 4 * br, Wb), ring, c_s,
                             acc);
#pragma unroll
          for (int r = 0; r < TJ; ++r) {
            const int p = warp * TJ + r, k = k0 + r;
            if (!(i < N && k < K)) continue;
            const size_t at = slot_at(b, i, k, N, K) * CW;
            const float a = mask_s[p];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int f = lane + 32 * c;
              if (f >= Fg) continue;
              const float phi = g_s[p * LD + f];
              const float phid = acc[r][c] * a;
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                const float q = row3(dq, d, f), qd = row3(dqdot, d, f);
                st(dcat + at + (d + 1) * Fg + f, phi * q + phid * qd);
                st(dcatdot + at + (d + 1) * Fg + f, phi * qd);
              }
            }
          }
        }
        // g = dphi * mask, gdot = dphidot * mask, where
        // dphi = sum_d dq[d,i] x[d] + dqdot[d,i] xdot[d], dphidot = sum_d
        // dqdot[d,i] x[d], with (x, xdot) = (dir, dirdot) or (force_j,
        // forcedot_j)
#pragma unroll
        for (int r = 0; r < TJ; ++r) {
          const int p = warp * TJ + r, k = k0 + r;
          const bool ok = i < N && k < K;
          const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
          const float a = mask_s[p];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int f = lane + 32 * c;
            float dphi = 0.0f, dphidot = 0.0f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float q = row3(dq, d, f), qd = row3(dqdot, d, f);
              float x, xdot;
              if (br == 0) {
                x = dir_s[d * M + p];
                xdot = dirdot_s[d * M + p];
              } else {
                x = ok && f < Fg ? ld(cat + at + (d + 1) * Fg + f) : 0.0f;
                xdot =
                    ok && f < Fg ? ld(catdot + at + (d + 1) * Fg + f) : 0.0f;
              }
              dphi = dphi + q * x + qd * xdot;
              dphidot = dphidot + qd * x;
            }
            g_s[p * LD + f] = dphi * a;
            gdot_s[p * LD + f] = dphidot * a;
          }
        }
        wgrad_tc<F, M, false, true, kBF>(h_s, g_s, hdot_s, gdot_s, LD, F,
                                         wpb, init);  // dWb
        mma_rows<F, true>(gdot_s, LD, F, wt(3 + 4 * br, Wb), ring, c_s,
                          acc);  // dhdot
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            const float pv = p_s[o];
            pdot_s[o] = d2silu_f(pv) * pdot_s[o] * acc[r][c];
            gdot_s[o] = dsilu_f(pv) * acc[r][c];  // dpdot
          }
        mma_rows<F, true>(g_s, LD, F, wt(3 + 4 * br, Wb), ring, c_s,
                          acc);  // dh
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            g_s[o] = dsilu_f(p_s[o]) * acc[r][c] + pdot_s[o];  // dp
          }
        wgrad_tc<F, M, false, true, kBF>(msg_s, g_s, msgdot_s, gdot_s, LD,
                                         F, wpa, init);  // dWa
        mma_rows<F, true>(g_s, LD, F, wt(4 + 4 * br, Wa), ring, c_s, acc);
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            dmsg[r][c] = br == 0 ? acc[r][c] : dmsg[r][c] + acc[r][c];
        mma_rows<F, true>(gdot_s, LD, F, wt(4 + 4 * br, Wa), ring, c_s,
                          acc);
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            dmsgdot[r][c] = br == 0 ? acc[r][c] : dmsgdot[r][c] + acc[r][c];
      }

      // ---- t = (dmsg + di_i) mask, tdot = (dmsgdot + didot_i) mask; dnpi,
      // dnpidot, dcat[np_j], dcatdot[np_j], dme, dmedot, dWe. me and medot
      // are recomputed.
      mma_rows<F, false>(rbf_s, R, R, wt(0, We), ring, c_s, acc);  // me
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          p_s[(warp * TJ + r) * LD + lane + 32 * c] = acc[r][c];
      mma_rows<F, false>(rbfdot_s, R, R, wt(0, We), ring, c_s,
                         acc);  // medot
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r, k = k0 + r;
        const bool ok = i < N && k < K;
        const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
        const float a = mask_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const int o = p * LD + f;
          const float t = (dmsg[r][c] + di_s[warp * F + f]) * a;
          const float tdot = (dmsgdot[r][c] + didot_s[warp * F + f]) * a;
          const float me = p_s[o], medot = acc[r][c];
          const float ai = npi_s[warp * F + f];
          const float aidot = npidot_s[warp * F + f];
          const bool okf = ok && f < Fg;
          const float aj = okf ? ld(cat + at + f) : 0.0f;
          const float ajdot = okf ? ld(catdot + at + f) : 0.0f;
          dnp_acc[c] += t * me * aj + tdot * (medot * aj + me * ajdot);
          dnpdot_acc[c] += tdot * me * aj;
          hdot_s[o] = t * ai * aj + tdot * (aidot * aj + ai * ajdot);  // dme
          g_s[o] = tdot * ai * aj;                                    // dmedot
          if (okf) {
            st(dcat + at + f, t * me * ai + tdot * (medot * ai + me * aidot));
            st(dcatdot + at + f, tdot * me * ai);
          }
        }
      }
      wgrad_tc<F, M, false, true, kBF>(rbf_s, hdot_s, rbfdot_s, g_s, R, R,
                                       wp, init);  // dWe
    }

    if (i < N) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        if (f >= Fg) continue;
        dnpi[((size_t)b * N + i) * Fg + f] = dnp_acc[c];
        dnpidot[((size_t)b * N + i) * Fg + f] = dnpdot_acc[c];
      }
    }
  }
}

// ------------------------------------------------------------------ K7 --
// K7 is its own design too. What bounds it: its products, 2x K5's flops
// per slot (100 GFLOP per full layer at the box shape B=1, N=4096, K=88,
// F=128, R=20), above the fp32 ridge. The CUDA-core version fed every FMA
// from shared memory (4 broadcast A and 4 B loads per 16 FMAs), staged each
// weight twice per pair of products that share it, and loaded its chunks
// with no product in flight: 27% of the fp32 peak. K8's tensor-core
// product re-splits every operand at every use. So:
//
// * Paired products on the tensor cores (k7_pair): me/medot share We,
//   p/pdot share Wa and phi/phidot share Wb, so one pass computes both
//   members of a pair, 32 x Q @ Q x F each, warp w taking the 16-row half
//   (w & 1) and F/4 columns: mma.sync m16n8k8 tf32 in 3xTF32 (hi =
//   tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi in fp32; no 1xTF32).
//   Each chunk's products accumulate in fresh tensor-core registers and are
//   added to the running sum on the CUDA cores (the tensor cores' fp32
//   accumulation drops bits against a large addend).
// * Weights split once per launch: klist_dual_fwd_prep_kernel writes We^T,
//   W1a^T, W1b^T, W2a^T and W2b^T as (hi, lo) tf32 word pairs, n-major with
//   the depth contiguous (We^T's depth padded with zeros to a multiple of
//   32), into the launch's scratch (nn_klist_scratch_floats). Chunks of
//   KC depth steps stream by cp.async through a ring of K7_STAGES slots,
//   two in flight while one multiplies, and the stream runs across
//   products: a product stages the first two chunks of the one after it
//   (the next tile's We after the last), so no product starts on an empty
//   ring. Ring rows are XOR-swizzled (pair q of row n at q ^ 4(n & 3)), so
//   that the B fragments' 64-bit loads take the minimum two wavefronts
//   with no padding. The product loop does no split arithmetic on B.
// * Activations split once, where they are written: the tile loader stores
//   rbf and rbfdot, the elementwise chain msg, msgdot, h and hdot, as (hi,
//   lo) pairs (row stride Q + 4 pairs: the A fragments' 64-bit loads take
//   two wavefronts too). msg and msgdot feed both branches; every A element
//   is read by the four column-group warps. The product loop splits
//   nothing.
// * Shared memory at F=128, R=20: the ring 48 KB, msg/msgdot 66 KB, h/hdot
//   66 KB (rbf/rbfdot at a tile's start), the fp32 products 34 KB (me,
//   then p, then phi, and tangents), npi/npidot 8 KB: 223 KB, one block of
//   8 warps per SM (the CUDA-core version: 96 KB, two).
// * The next tile's edge rows (cat, catdot, rbf, rbfdot) are prefetched
//   into L2 at the start of a tile, so the elementwise chain's reads of
//   them wait on L2 rather than device memory.
// * Grid as before: one block per (molecule, 8 atoms), looping over tiles
//   of tj_d(F) list slots; sums over k are per-thread register sums, so no sum
//   crosses blocks and no float atomics: a run gives the same bits every
//   time.
// * Code size: k7_pair is out of line (one copy per F), as K8's products.
// On the card its time splits three ways (PERF.md, dual_breakdown.py
// k2k7): the elementwise chain and tile loads, the weight stream (each
// 32-slot tile streams all five weights from L2, 544 KB of pairs at
// F=128) with the fragment loads, and the mma.
// * Past F=128 (wide) a tile has 2 slots of its 8 atoms (16 slot rows:
//   each warp takes all of them and an eighth of the columns) and chunks of
//   8 depth steps, so that it fits: 227 KB at F=256.
// * bf16 mode: the prepared weights are bf16 words (two depth steps each)
//   in 32-depth chunks, a two-slot ring with one chunk in flight (We and
//   the products at F=32 are one chunk each, and the stream stages only
//   the next product's first chunk); the slot buffers hold (x, 0) in the
//   fp32 mode's (hi, lo) layout, rounded where the fragments are loaded.
//   The shared memory is the fp32 mode's.
constexpr int K7_STAGES = 3;  // chunk slots of K7's weight ring

template <int F>
struct K7Shape {
  static constexpr int TJ = tj_d(F);    // list slots per tile
  static constexpr int M = TI * TJ;     // slots of a tile
  static constexpr int KC = F > 128 ? 8 : 16;  // depth steps of a chunk
  static constexpr int RG = M / 16;     // 16-row groups of a product
  static constexpr int CG = kWarps / RG;  // its column groups
  static constexpr int LDA = F + 4;     // split slot buffers, in pairs
  static constexpr int LDP = F + (F > 128 ? 4 : 8);  // fp32 product buffers
  static constexpr int RING = F * KC;   // pairs per ring slot
};

// The prepared weights, in (hi, lo) pairs: block 0 is We^T (F x pad32(R)),
// blocks 1-4 W1a^T, W1b^T, W2a^T, W2b^T (F x F), each n-major.
__host__ __device__ inline size_t k7_prep_offset(int F, int R, int block) {
  return block == 0 ? 0
                    : (size_t)F * pad32(R) + (size_t)(block - 1) * F * F;
}

// Row stride (pairs) of the h/hdot buffers, which hold rbf/rbfdot (depth
// pad32(R)) at the start of a tile.
__host__ __device__ constexpr int k7_ldh(int F, int R) {
  return (pad32(R) > F ? pad32(R) : F) + 4;
}

template <int F>
constexpr size_t k7_smem_floats(int R) {
  using S = K7Shape<F>;
  return 2 * ((size_t)K7_STAGES * S::RING + (size_t)2 * S::M * S::LDA +
              (size_t)2 * S::M * k7_ldh(F, R)) +
         (size_t)2 * S::M * S::LDP + (size_t)2 * TI * F + (size_t)7 * S::M;
}

// x as (tf32 hi, tf32 lo): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ uint2 split2(float x) {
  const unsigned hi = tf32_rna(x);
  return make_uint2(hi, tf32_rna(x - __uint_as_float(hi)));
}

// A slot operand of K7's products as its buffers hold it: split2(x), or in
// bf16 mode (x, 0), rounded to bf16 where its fragments are loaded.
__device__ __forceinline__ uint2 k7_operand(float x) {
  if constexpr (kBF)
    return make_uint2(__float_as_uint(x), 0u);
  else
    return split2(x);
}

__global__ void klist_dual_fwd_prep_kernel(const float* __restrict__ We,
                                           const float* __restrict__ W1a,
                                           const float* __restrict__ W1b,
                                           const float* __restrict__ W2a,
                                           const float* __restrict__ W2b,
                                           uint2* __restrict__ out, int F,
                                           int Fg, int R) {
  const int Rp = pad32(R);
  const size_t n_e = (size_t)F * Rp, total = k7_prep_offset(F, R, 5);
  if constexpr (kBF) {
    // the same elements in bf16, two of consecutive depth q, q + 1 a word
    // (the lower in the low half): row n of a block is Qp/2 words
    unsigned* outw = reinterpret_cast<unsigned*>(out);
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < total / 2; e += (size_t)gridDim.x * blockDim.x) {
      unsigned word = 0;
      for (int h = 0; h < 2; ++h) {
        const size_t el = 2 * e + h;
        float v;
        if (el < n_e) {
          const int n = (int)(el / Rp), q = (int)(el % Rp);
          v = q < R && n < Fg ? We[(size_t)q * Fg + n] : 0.0f;
        } else {
          const size_t e2 = el - n_e, ff = (size_t)F * F;
          const int k = (int)(e2 / ff), r = (int)(e2 % ff);
          const int n = r / F, q = r % F;
          const float* W = k == 0 ? W1a : k == 1 ? W1b : k == 2 ? W2a : W2b;
          v = q < Fg && n < Fg ? W[(size_t)q * Fg + n] : 0.0f;
        }
        word |= (unsigned)bf16_bits(v) << (16 * h);
      }
      outw[e] = word;
    }
    return;
  }
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
      const float* W = k == 0 ? W1a : k == 1 ? W1b : k == 2 ? W2a : W2b;
      v = q < Fg && n < Fg ? W[(size_t)q * Fg + n] : 0.0f;
    }
    out[e] = split2(v);
  }
}

// Chunk ch of a prepared weight (F rows of Qp pairs) into a ring slot: per
// row n the KC pairs of depth [ch*KC, ch*KC + KC), swizzled (pair q at
// n*KC + (q ^ ring_swz(n, KC))), as KC/2 16-byte cp.async copies.
template <int F>
__device__ __forceinline__ void k7_stage(const uint2* __restrict__ Bt, int Qp,
                                         int ch, uint2* slot) {
  if constexpr (kBF) {
    // bf16 mode: per row n the KBW words of depth [ch*KB, ch*KB + KB),
    // word w at n*KBW + (w ^ bf16_swz(n)), as KBW/4 16-byte copies
    const unsigned* src = reinterpret_cast<const unsigned*>(Bt);
    unsigned* dst = reinterpret_cast<unsigned*>(slot);
    constexpr unsigned P = KBW / 4;
    for (unsigned v = threadIdx.x; v < F * P; v += kThreads) {
      const int n = (int)(v / P), part = (int)(v % P);
      cp_async16(dst + n * KBW + ((part * 4) ^ bf16_swz(n)),
                 src + (size_t)n * (Qp / 2) + (size_t)ch * KBW + part * 4);
    }
    return;
  }
  constexpr int KC = K7Shape<F>::KC;
  constexpr unsigned P = KC / 2;  // a power of two: unsigned, a shift and
                                  // a mask (as K2's k2_stage)
  static_assert((P & (P - 1)) == 0, "copies per row");
  for (unsigned v = threadIdx.x; v < F * P; v += kThreads) {
    const int n = (int)(v / P), part = (int)(v % P);
    cp_async16(slot + n * KC + ((part * 2) ^ ring_swz(n, KC)),
               Bt + (size_t)n * Qp + (size_t)ch * KC + part * 2);
  }
}

// D1[m*LDP + n] = sum_q A1(m, q) B(q, n) and D2 likewise from A2, for the
// tile's 32 slot rows m and n < F, q < Qp (a multiple of 32), in 3xTF32.
// A1 and A2 are split slot buffers (row m at A + m*lda, (hi, lo) pairs,
// zeros past the true depth); Bt is the prepared weight, B(q, n) =
// Bt[n*Qp + q]. The weight stream: chunk c of this product sits in ring
// slot (slot0 + c) % K7_STAGES; unless `staged`, chunks 0 and 1 are staged
// here (else the product before staged them, one commit group each). While
// it runs, the product stages the first two chunks of the next one (Bn,
// depth Qn; none if Bn is null) and returns the slot of its chunk 0. Every
// warp reads every A row after the loop's first barrier, so A may be
// written just before the call; D is written after the last chunk and must
// not be A. Ends with a __syncthreads, after which any thread may read D.
// All threads of the block must call it. Not inlined (code size).
template <int F>
__device__ __noinline__ int k7_pair(const uint2* __restrict__ A1,
                                    const uint2* __restrict__ A2, int lda,
                                    int Qp, const uint2* __restrict__ Bt,
                                    const uint2* __restrict__ Bn, int Qn,
                                    int slot0, bool staged, uint2* ring,
                                    float* __restrict__ D1,
                                    float* __restrict__ D2) {
  using S = K7Shape<F>;
  constexpr int NT = F / (8 * S::CG);  // 16 x 8 tiles per warp and product
  constexpr int KC = S::KC;
  // the ring: K7_STAGES slots of KC depth steps, two chunks in flight while
  // one multiplies; bf16 mode: two slots of KB depth steps (F rows of KBW
  // words), one in flight (a product of depth 32 is a single chunk there)
  constexpr int NS = kBF ? 2 : K7_STAGES, AHEAD = NS - 1;
  constexpr int SLOT = kBF ? F * KBW / 2 : S::RING;  // uint2 per slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % S::RG) * 16, n0 = (warp / S::RG) * (F / S::CG);
  const int o0 = t ^ ring_swz(g, KC);  // the swizzled pair of depth t
  const int nch = Qp / (kBF ? KB : KC);
  // chunk v of the stream from this product's chunk 0, one commit group
  auto stage = [&](int v) {
    uint2* dst = ring + ((slot0 + v) % NS) * SLOT;
    if (v < nch)
      k7_stage<F>(Bt, Qp, v, dst);
    else if (Bn != nullptr)
      k7_stage<F>(Bn, Qn, v - nch, dst);
    cp_async_commit();
  };
  float tot[2][NT][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tot[x][j][0] = tot[x][j][1] = tot[x][j][2] = tot[x][j][3] = 0.0f;
  const uint2* rows[2][2] = {
      {A1 + (size_t)(m0 + g) * lda, A1 + (size_t)(m0 + g + 8) * lda},
      {A2 + (size_t)(m0 + g) * lda, A2 + (size_t)(m0 + g + 8) * lda}};
  if (!staged) {
#pragma unroll
    for (int v = 0; v < AHEAD; ++v) stage(v);
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    stage(ch + AHEAD);
    const uint2* wc = ring + ((slot0 + ch) % NS) * SLOT;
    float d[2][NT][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        d[x][j][0] = d[x][j][1] = d[x][j][2] = d[x][j][3] = 0.0f;
    if constexpr (kBF) {
      // one m16n8k16 bf16 mma per tile and 16 depth steps; the slot
      // buffers hold (x, 0) pairs, depths k and k + 1 one 16-byte load,
      // rounded to bf16 here
      const unsigned* wb = reinterpret_cast<const unsigned*>(wc);
      const int sw = bf16_swz(g);  // rows n0 + 8j + g: n & 7 == g
      auto a_at = [&](const uint2* row, int k) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + k);
        return pack_bf16(__uint_as_float(v.x), __uint_as_float(v.z));
      };
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) {
        const int k = ch * KB + s * 16 + 2 * t;  // depth of the A words
        unsigned a[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          a[x][0] = a_at(rows[x][0], k), a[x][1] = a_at(rows[x][1], k);
          a[x][2] = a_at(rows[x][0], k + 8), a[x][3] = a_at(rows[x][1], k + 8);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const unsigned* wk = wb + (n0 + j * 8 + g) * KBW;
          const unsigned bw[2] = {wk[(s * 8 + t) ^ sw],
                                  wk[(s * 8 + t + 4) ^ sw]};
#pragma unroll
          for (int x = 0; x < 2; ++x) mma_bf16(d[x][j], a[x], bw);
        }
      }
    } else {
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {  // k-steps of a chunk
      const int k = ch * KC + s * 8 + t;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint2 v0 = rows[x][0][k], v1 = rows[x][1][k];
        const uint2 v2 = rows[x][0][k + 4], v3 = rows[x][1][k + 4];
        ah[x][0] = v0.x, ah[x][1] = v1.x, ah[x][2] = v2.x, ah[x][3] = v3.x;
        al[x][0] = v0.y, al[x][1] = v1.y, al[x][2] = v2.y, al[x][3] = v3.y;
      }
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2* w = wc + (n0 + j * 8 + g) * KC;
        const uint2 wk = w[(s * 8) ^ o0], wk4 = w[(s * 8) ^ o0 ^ 4];
        bh[j][0] = wk.x, bh[j][1] = wk4.x, bl[j][0] = wk.y, bl[j][1] = wk4.y;
      }
      // lo*hi, hi*lo, hi*hi of every tile in turn: 2 NT independent
      // accumulators between two dependent products
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) mma_tf32(d[x][j], al[x], bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) mma_tf32(d[x][j], ah[x], bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) mma_tf32(d[x][j], ah[x], bh[j]);
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
    for (int j = 0; j < NT; ++j) {  // (n, n + 1) as one 8-byte store
      const int n = n0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(D + (m0 + g) * S::LDP + n) =
          make_float2(tot[x][j][0], tot[x][j][1]);
      *reinterpret_cast<float2*>(D + (m0 + g + 8) * S::LDP + n) =
          make_float2(tot[x][j][2], tot[x][j][3]);
    }
  }
  __syncthreads();
  return (slot0 + nch) % NS;
}

// The tile's per-slot mask, dir and dirdot (fp32), and rbf, rbfdot split
// into (hi, lo) pairs at row stride ldh, zeros from R to pad32(R). Slots
// past N or K read as zero, so they contribute nothing and stay finite.
template <int TJ, class E>
__device__ void k7_load_slots(const float* __restrict__ mask,
                              const float* __restrict__ dir,
                              const float* __restrict__ dirdot,
                              const E* __restrict__ rbf,
                              const E* __restrict__ rbfdot, int b, int i0,
                              int k0, int N, int K, int R, int ldh,
                              float* mask_s, float* dir_s, float* dirdot_s,
                              uint2* rbf2, uint2* rbfdot2) {
  constexpr int M = TI * TJ;
  for (int idx = threadIdx.x; idx < 7 * M; idx += kThreads) {
    const int g = idx / M, p = idx - g * M;  // 0: mask, 1-3: dir, 4-6: dirdot
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    const bool ok = i < N && k < K;
    if (g == 0)
      mask_s[p] = ok ? mask[slot_at(b, i, k, N, K)] : 0.0f;
    else if (g < 4)
      dir_s[(g - 1) * M + p] =
          ok ? dir[slot_at(b * 3 + g - 1, i, k, N, K)] : 0.0f;
    else
      dirdot_s[(g - 4) * M + p] =
          ok ? dirdot[slot_at(b * 3 + g - 4, i, k, N, K)] : 0.0f;
  }
  const int Rp = pad32(R);
  for (int idx = threadIdx.x; idx < M * Rp; idx += kThreads) {
    const int p = idx / Rp, r = idx - p * Rp;
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    const bool ok = i < N && k < K && r < R;
    const size_t at = slot_at(b, i, k, N, K) * R + r;
    rbf2[p * ldh + r] = k7_operand(ok ? ld(rbf + at) : 0.0f);
    rbfdot2[p * ldh + r] = k7_operand(ok ? ld(rbfdot + at) : 0.0f);
  }
}

template <int F, bool FIRST, class E>
__global__ void __launch_bounds__(kThreads, 1)
klist_dual_fwd_kernel(const float* __restrict__ npi,
                      const float* __restrict__ npidot,
                      const E* __restrict__ cat, const E* __restrict__ catdot,
                      const E* __restrict__ rbf, const E* __restrict__ rbfdot,
                      const float* __restrict__ dir,
                      const float* __restrict__ dirdot,
                      const float* __restrict__ mask,
                      const uint2* __restrict__ wprep,
                      float* __restrict__ inv1, float* __restrict__ eq,
                      float* __restrict__ inv1dot, float* __restrict__ eqdot,
                      int N, int K, int Fg_, int R, int n_itiles) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = K7Shape<F>;
  constexpr int TJ = S::TJ;
  constexpr int M = S::M;
  constexpr int C = F / 32;
  constexpr int LDA = S::LDA, LDP = S::LDP;
  const int CW = FIRST ? Fg : 4 * Fg;
  const int ldh = k7_ldh(F, R), Rp = pad32(R);
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // K7_STAGES x RING
  uint2* msg2 = ring + K7_STAGES * S::RING;  // M x LDA: msg
  uint2* msgdot2 = msg2 + M * LDA;     // M x LDA: msgdot
  uint2* h2 = msgdot2 + M * LDA;       // M x ldh: rbf, then h
  uint2* hdot2 = h2 + M * ldh;         // M x ldh: rbfdot, then hdot
  float* p_s = reinterpret_cast<float*>(hdot2 + M * ldh);  // M x LDP
  float* pdot_s = p_s + M * LDP;       // M x LDP
  float* npi_s = pdot_s + M * LDP;     // TI x F
  float* npidot_s = npi_s + TI * F;    // TI x F
  float* mask_s = npidot_s + TI * F;   // M
  float* dir_s = mask_s + M;           // 3 x M
  float* dirdot_s = dir_s + 3 * M;     // 3 x M

  const int b = blockIdx.x / n_itiles;
  const int i0 = (blockIdx.x - b * n_itiles) * TI;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = i0 + warp;

  load_rows(npi, b, i0, N, F, Fg, npi_s);
  load_rows(npidot, b, i0, N, F, Fg, npidot_s);
  float inv_acc[C], invdot_acc[C], eq_acc[3][C], eqdot_acc[3][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    inv_acc[c] = invdot_acc[c] = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) eq_acc[d][c] = eqdot_acc[d][c] = 0.0f;
  }

  const uint2* W1a = wprep + k7_prep_offset(F, R, 1) / kEPP;
  int slot = 0;  // the ring slot of the next product's first chunk
  for (int k0 = 0; k0 < K; k0 += TJ) {
    const bool last = k0 + TJ >= K;
    if (!last) {  // the next tile's edge rows into L2
      const int kn = k0 + TJ, nk = min(TJ, K - kn);
      const int lines = (nk * CW * (int)sizeof(E) + 127) / 128;
      const int rlines = (nk * R * (int)sizeof(E) + 127) / 128;
      for (int v = threadIdx.x; v < TI * (lines + rlines); v += kThreads) {
        const int il = v / (lines + rlines), l = v - il * (lines + rlines);
        if (i0 + il >= N) continue;
        const size_t at = slot_at(b, i0 + il, kn, N, K);
        if (l < lines) {
          prefetch_l2(reinterpret_cast<const char*>(cat + at * CW) + l * 128);
          prefetch_l2(reinterpret_cast<const char*>(catdot + at * CW) +
                      l * 128);
        } else {
          const int lr = (l - lines) * 128;
          prefetch_l2(reinterpret_cast<const char*>(rbf + at * R) + lr);
          prefetch_l2(reinterpret_cast<const char*>(rbfdot + at * R) + lr);
        }
      }
    }
    __syncthreads();  // the last tile's reads of the slot buffers are done
    k7_load_slots<TJ, E>(mask, dir, dirdot, rbf, rbfdot, b, i0, k0, N, K, R,
                         ldh, mask_s, dir_s, dirdot_s, h2, hdot2);
    slot = k7_pair<F>(h2, hdot2, ldh, Rp, wprep, W1a, F, slot, k0 > 0, ring,
                      p_s, pdot_s);  // me, medot
    // msg and msgdot of the warp's own slots; np_j and its tangent from
    // cat / catdot
#pragma unroll
    for (int r = 0; r < TJ; ++r) {
      const int p = warp * TJ + r, k = k0 + r;
      const bool ok = i < N && k < K;
      const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
      const float a = mask_s[p];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int f = lane + 32 * c;
        const float ai = npi_s[warp * F + f], aidot = npidot_s[warp * F + f];
        const float aj = ok && f < Fg ? ld(cat + at + f) : 0.0f;
        const float ajdot = ok && f < Fg ? ld(catdot + at + f) : 0.0f;
        const float me = p_s[p * LDP + f], medot = pdot_s[p * LDP + f];
        const float msg = me * ai * aj * a;
        const float msgdot = (medot * ai * aj + me * aidot * aj +
                              me * ai * ajdot) * a;
        inv_acc[c] += msg;
        invdot_acc[c] += msgdot;
        msg2[p * LDA + f] = k7_operand(msg);
        msgdot2[p * LDA + f] = k7_operand(msgdot);
      }
    }

#pragma unroll 1  // one copy of the branch body: code size
    for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
      const uint2* Wa = wprep + k7_prep_offset(F, R, 1 + 2 * br) / kEPP;
      const uint2* Wb = wprep + k7_prep_offset(F, R, 2 + 2 * br) / kEPP;
      // after phi: the second branch's Wa, or the next tile's We
      const bool last_br = FIRST || br == 1;
      const uint2* Wn = !last_br ? wprep + k7_prep_offset(F, R, 3) / kEPP
                        : last   ? nullptr
                                 : wprep;
      slot = k7_pair<F>(msg2, msgdot2, LDA, F, Wa, Wb, F, slot, true, ring,
                        p_s, pdot_s);  // p, pdot
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int p = warp * TJ + r, f = lane + 32 * c;
          const float pv = p_s[p * LDP + f], sg = sigmoid_f(pv);
          h2[p * ldh + f] = k7_operand(pv * sg);  // silu, silu' as silu_f,
                                                  // dsilu_f
          hdot2[p * ldh + f] = k7_operand(sg * (1.0f + pv * (1.0f - sg)) *
                                          pdot_s[p * LDP + f]);
        }
      slot = k7_pair<F>(h2, hdot2, ldh, F, Wb, Wn, last_br ? Rp : F, slot,
                        true, ring, p_s, pdot_s);  // phi, phidot
      // eq += phi x, eqdot += phi xdot + phidot x, with (x, xdot) = (dir,
      // dirdot) in branch 1 and (force_j, forcedot_j) in branch 2
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r, k = k0 + r;
        const bool ok = i < N && k < K;
        const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
        const float a = mask_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const float phi = p_s[p * LDP + f] * a;
          const float phidot = pdot_s[p * LDP + f] * a;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            float x, xdot;
            if (br == 0) {
              x = dir_s[d * M + p];
              xdot = dirdot_s[d * M + p];
            } else {
              x = ok && f < Fg ? ld(cat + at + (d + 1) * Fg + f) : 0.0f;
              xdot = ok && f < Fg ? ld(catdot + at + (d + 1) * Fg + f) : 0.0f;
            }
            eq_acc[d][c] += phi * x;
            eqdot_acc[d][c] += phi * xdot + phidot * x;
          }
        }
      }
    }
  }

  if (i < N) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      if (f >= Fg) continue;
      inv1[((size_t)b * N + i) * Fg + f] = inv_acc[c];
      inv1dot[((size_t)b * N + i) * Fg + f] = invdot_acc[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        eq[(((size_t)b * 3 + d) * N + i) * Fg + f] = eq_acc[d][c];
        eqdot[(((size_t)b * 3 + d) * N + i) * Fg + f] = eqdot_acc[d][c];
      }
    }
  }
}

// ------------------------------------------------------------------ K6 --
// K6 is its own design too: the K-list twin of K2 (csrc/fused_dense.cu),
// the same chain over list slots. What bounds it: its products, 2(2RF +
// 8F^2) flops per slot at a full layer (98 GFLOP per full layer at the box
// shape B=1, N=4096, K=88, F=128, R=20), above the fp32 ridge. The
// CUDA-core version fed every FMA from shared memory, loaded each weight
// chunk with no product in flight, computed me twice per tile and drbf as
// scalar dot products; K7 and K2 moved to the tensor cores but stream all
// their weights from L2 for every 32-slot tile (1.1 MB of tf32 pairs per
// tile here). So:
//
// * 64-slot tiles: one block of 8 warps walks (molecule, 8 atoms) tiles
//   blockIdx, blockIdx + gridDim, ... (at most one block per SM: the
//   wrapper passes the SM count), each in steps of TJ6 = 8 list slots: 64
//   slot rows per step, so every staged weight chunk feeds 64 rows and a
//   full layer streams half the weight bytes of a 32-slot tile design.
//   Warp w owns the 8 slots of atom i0+w and lane l the feature columns
//   l+32c in the elementwise chain, so the sums over k (dnpi) are per-thread
//   register sums and ddir a warp sum; no sum crosses blocks except the
//   weight cotangents.
// * Products on the tensor cores (k6_prod): mma.sync m16n8k8 tf32 in
//   3xTF32 (hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi in fp32;
//   no 1xTF32), 64 x Q @ Q x NB, warp w taking the 32 rows (w & 1) and NB/4
//   columns: 2 NB/32 independent 16 x 8 tiles per product. Each chunk's
//   products accumulate in fresh registers and are added to the running
//   sum on the CUDA cores. p1/p2 run paired (one pass, both from msg, its
//   A fragments split once for both) and dmsg = dp1 W1a^T + dp2 W2a^T as
//   one summed pass; phi and dh run per branch (each warp already has 8
//   tiles in flight per product, and a fifth 64-row buffer for pairing
//   them would not fit beside the ring). me is computed once per tile and
//   kept; drbf = dme We^T is a product (32 columns r at a time).
// * Weights split once per launch: klist_prep_kernel writes them as
//   (hi, lo) tf32 pairs into the launch's scratch, chunk-major in the order
//   the step multiplies them and swizzled as a ring slot holds them, so a
//   chunk stages as one contiguous run of 16-byte cp.async copies
//   (per-row staging, its index arithmetic issued by every thread, cost
//   more than a millisecond of a box launch). They stream through a
//   two-slot ring of 32 depth steps of one weight, or 16 of each of two:
//   one chunk in flight while one multiplies, and the stream runs across
//   products and tiles (a product stages the first chunk of the one after
//   it), so no product starts on an empty ring. Smaller chunks in a deeper
//   ring (16 depth steps, five slots) ran slower: each chunk costs a
//   barrier and a drain of the products in flight. Ring rows are
//   XOR-swizzled, so the B fragments' 64-bit loads take the minimum two
//   wavefronts. Slot operands are fp32 (row stride F + 4: conflict-free A
//   fragment loads) and split at fragment load in three operations
//   (split_tf32_mma: the mma itself truncates to tf32).
// * Activations with the fast exponential and division (silu_fast,
//   dsilu_fast): the IEEE ones cost a fifth of the launch.
// * The next step's edge rows (cat, rbf) are prefetched into L2 at the
//   start of a step, so the chain's reads of np_j and force_j wait on L2.
// * Weight cotangents (WGRAD, off in the force pass) on the same tensor
//   cores (wgrad_tc over 64 slots): each block adds them into its one
//   partial, and klist_wsum_kernel sums the partials in a fixed order. No
//   float atomics: a run gives the same bits every time.
// * Shared memory at F=128, R=20: the ring 64 KB, four fp32 slot buffers
//   (me; msg, h1, phi1, dphi1, dh1, dp1, dmsg; p1, then h2 ... dp2, dme;
//   p2, then msg again for WGRAD) 132 KB, rbf (then drbf) 9 KB, the row
//   inputs 8 KB: 214 KB, one block per SM.
// * Past F=128 (wide) a step takes 4 slots of its 8 atoms (32 slot rows,
//   one 32-row group per warp pair) and a ring slot 16 depth steps of one
//   weight or 8 of each of two, so that it fits: 215 KB at F=256, R=20.
// List slots per atom in a K6 (and K5) step, and depth pairs of one weight
// in a ring slot of K5/K6.
__host__ __device__ constexpr int k6_tj(int F) { return F > 128 ? 4 : 8; }
__host__ __device__ constexpr int k6_rw(int F) { return F > 128 ? 16 : 32; }

template <int F>
struct K6Shape {
  static constexpr int TJ = k6_tj(F);    // list slots per atom in a step
  static constexpr int M = TI * TJ;      // slot rows of a K6 step
  static constexpr int RW = k6_rw(F);    // depth pairs of one weight
  static constexpr int LD = F + 4;       // fp32 slot buffers (M x LD)
  static constexpr int RING = RW * F;    // pairs per ring slot
};

template <int F>
constexpr size_t k6_smem_floats(int R) {
  using S = K6Shape<F>;
  return (size_t)4 * S::RING + (size_t)4 * S::M * S::LD +
         (size_t)S::M * (pad32(R) + 4) + (size_t)2 * TI * F +
         (size_t)4 * S::M;
}

// K6's prepared weights, in (hi, lo) tf32 pairs: the products of a step in
// the order it runs them (me, p, phi1, dh1, phi2, dh2, dmsg, then drbf 32
// columns at a time; the first layer has no phi2 and dh2, and its p and
// dmsg take one weight), each chunk-major and swizzled as a ring slot
// holds it, so that a chunk stages as one contiguous copy. Product p is
// B(q, n), n < nb, q < qp, in chunks of 32 depth steps of one weight (rows
// n of 32 pairs), or of 16 of each of two (rows x*nb + n of 16 pairs);
// pair q of row r of a chunk sits at r*rw + (q ^ 4(r & 3)), so that the B
// fragments' 64-bit loads take the minimum two wavefronts.
struct K6P {
  int src;     // B(q, n) = 0: We[q][n], 1: W[q][n], 2: W[n][q], 3: We[n][q]
  int w1, w2;  // W1a, W1b, W2a or W2b (0-3); w2 < 0: one weight
  int nb, qp;  // rows and depth
  int row0;    // src 3: the first row of We
};

__host__ __device__ inline int k6_n_products(int R, bool first) {
  return (first ? 5 : 7) + pad32(R) / 32;
}

__host__ __device__ inline K6P k6_product(int p, int F, int R, bool first) {
  const int d = first ? 4 : 6;  // dmsg
  if (p == 0) return {0, 0, -1, F, pad32(R), 0};          // me
  if (p == 1) return {1, 0, first ? -1 : 2, F, F, 0};     // p1, p2
  if (p == 2) return {1, 1, -1, F, F, 0};                 // phi1
  if (p == 3) return {2, 1, -1, F, F, 0};                 // dh1
  if (p == 4 && !first) return {1, 3, -1, F, F, 0};       // phi2
  if (p == 5 && !first) return {2, 3, -1, F, F, 0};       // dh2
  if (p == d) return {2, 0, first ? -1 : 2, F, F, 0};     // dmsg
  return {3, 0, -1, 32, F, 32 * (p - d - 1)};             // drbf
}

__host__ __device__ inline size_t k6_product_pairs(const K6P& q) {
  return (size_t)q.nb * q.qp * (q.w2 >= 0 ? 2 : 1);
}

// K5 (fwd) runs the first products of K6's table: me, p, phi1 and (not
// at the first layer) phi2, K6's product 4.
__host__ __device__ inline int prep_n_products(bool fwd, int R, bool first) {
  return fwd ? (first ? 3 : 4) : k6_n_products(R, first);
}

__host__ __device__ inline K6P prep_product(bool fwd, int p, int F, int R,
                                            bool first) {
  return k6_product(fwd && p == 3 ? 4 : p, F, R, first);
}

// pairs of the prepared weights of K5 (fwd) or K6 (the full layer's table,
// the larger)
__host__ __device__ inline size_t prep_pairs(bool fwd, int F, int R) {
  size_t n = 0;
  for (int p = 0; p < prep_n_products(fwd, R, false); ++p)
    n += k6_product_pairs(prep_product(fwd, p, F, R, false));
  return n;
}

// The weights of K5 (fwd != 0) or K6 in (hi, lo) tf32 pairs, laid out as
// k6_product describes, once per launch.
__global__ void klist_prep_kernel(const float* __restrict__ We,
                                  const float* __restrict__ W1a,
                                  const float* __restrict__ W1b,
                                  const float* __restrict__ W2a,
                                  const float* __restrict__ W2b,
                                  uint2* __restrict__ out, int F, int Fg,
                                  int R, int first, int fwd) {
  const float* Ws[4] = {W1a, W1b, W2a, W2b};
  const int np = prep_n_products(fwd != 0, R, first != 0);
  if constexpr (kBF) {
    // words of two bf16 (depth dq, dq + 1), product after product (base
    // offsets in words: half of its pairs), in chunks of KB depth steps of
    // one weight (rows n) or of each of two (rows x*nb + n), KBW words a
    // row, word w of row r at r*KBW + (w ^ bf16_swz(r))
    unsigned* outw = reinterpret_cast<unsigned*>(out);
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;;
         e += (size_t)gridDim.x * blockDim.x) {
      size_t base = 0;  // the product of e, in words
      int p = 0;
      K6P q = prep_product(fwd != 0, 0, F, R, first != 0);
      while (e >= base + k6_product_pairs(q) / 2) {
        base += k6_product_pairs(q) / 2;
        if (++p == np) return;
        q = prep_product(fwd != 0, p, F, R, first != 0);
      }
      const int nx = q.w2 >= 0 ? 2 : 1;
      const size_t local = e - base, chunk = (size_t)nx * q.nb * KBW;
      const int ch = (int)(local / chunk), rem = (int)(local % chunk);
      const int r = rem / KBW, w = (rem % KBW) ^ bf16_swz(r);
      const int x = r / q.nb, n = r - x * q.nb;
      const float* W = Ws[x ? q.w2 : q.w1];
      unsigned word = 0;
      for (int h = 0; h < 2; ++h) {  // B(dq, n) as the tf32 layout's below
        const int dq = ch * KB + 2 * w + h;
        const bool in = q.src == 0   ? dq < R && n < Fg
                        : q.src == 3 ? q.row0 + n < R && dq < Fg
                                     : dq < Fg && n < Fg;
        const size_t at = q.src == 0   ? (size_t)dq * Fg + n
                          : q.src == 3 ? (size_t)(q.row0 + n) * Fg + dq
                          : q.src == 1 ? (size_t)dq * Fg + n
                                       : (size_t)n * Fg + dq;
        const float v = in ? (q.src == 0 || q.src == 3 ? We : W)[at] : 0.0f;
        word |= (unsigned)bf16_bits(v) << (16 * h);
      }
      outw[e] = word;
    }
  }
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;;
       e += (size_t)gridDim.x * blockDim.x) {
    size_t base = 0;  // the product of e
    int p = 0;
    K6P q = prep_product(fwd != 0, 0, F, R, first != 0);
    while (e >= base + k6_product_pairs(q)) {
      base += k6_product_pairs(q);
      if (++p == np) return;
      q = prep_product(fwd != 0, p, F, R, first != 0);
    }
    const int rwd = k6_rw(F), rw = q.w2 >= 0 ? rwd / 2 : rwd;
    const size_t local = e - base, chunk = (size_t)rwd * q.nb;
    const int ch = (int)(local / chunk), rem = (int)(local % chunk);
    const int r = rem / rw, j = rem - r * rw;
    const int dq = ch * rw + (j ^ ring_swz(r, rw)), x = r / q.nb;
    const int n = r - x * q.nb;
    const float* W = Ws[x ? q.w2 : q.w1];
    float v;
    if (q.src == 0)
      v = dq < R && n < Fg ? We[(size_t)dq * Fg + n] : 0.0f;
    else if (q.src == 3)
      v = q.row0 + n < R && dq < Fg ? We[(size_t)(q.row0 + n) * Fg + dq]
                                    : 0.0f;
    else if (dq >= Fg || n >= Fg)
      v = 0.0f;
    else
      v = q.src == 1 ? W[(size_t)dq * Fg + n] : W[(size_t)n * Fg + dq];
    out[e] = split2(v);
  }
}

// A product's prepared weight: chunks of RW depth pairs by nb rows (bf16:
// of KB depth steps by nx nb rows) from b, qp depth steps in all.
struct K6W {
  const uint2* b;
  int qp, nb;
  int nx;  // weights per chunk (bf16 mode's chunk size)
};

// Chunk ch of w, of RW depth pairs of one weight (bf16: KB depth steps of
// nx weights), into a ring slot: one contiguous copy (the preparation laid
// it out as the slot holds it), by 16-byte cp.async copies.
template <int RW>
__device__ __forceinline__ void k6_stage(const K6W& w, int ch, uint2* slot) {
  if constexpr (kBF) {
    const int words = w.nx * w.nb * KBW;  // of a chunk
    const unsigned* src =
        reinterpret_cast<const unsigned*>(w.b) + (size_t)ch * words;
    unsigned* dst = reinterpret_cast<unsigned*>(slot);
    for (int v = threadIdx.x; v < words / 4; v += kThreads)
      cp_async16(dst + 4 * v, src + 4 * v);
    return;
  }
  const uint2* src = w.b + (size_t)ch * RW * w.nb;
  for (int v = threadIdx.x; v < RW / 2 * w.nb; v += kThreads)
    cp_async16(slot + 2 * v, src + 2 * v);
}

// For the step's 64 slot rows m and n < NB, q < cur.qp, in 3xTF32 (bf16
// mode: one m16n8k16 bf16 mma per tile and k-step, A rounded to bf16
// where its fragments are loaded): MODE 0
// D1 = A1 B1; MODE 1 (pair) D1 = A1 B1 and D2 = A1 B2; MODE 2 (sum) D1 =
// A1 B1 + A2 B2, where A is fp32 at row stride lda (zeros past the true
// depth) and B the prepared weight of cur (k6_product's layout). Chunk 0
// of cur sits in ring slot `slot`, staged by the product before; while
// its last chunk multiplies this product stages chunk 0 of `next` (none if
// next.b is null) and returns that chunk's slot. Every warp reads every A
// row after the loop's first barrier and D is written after a barrier
// that follows the last read, so A may be written just before the call
// and D may be A. Ends with a __syncthreads. All threads of the block must
// call it. Not inlined (code size).
template <int F, int NB, int MODE>
__device__ __noinline__ int k6_prod(const float* A1, const float* A2,
                                    int lda, K6W cur, K6W next, int slot,
                                    uint2* ring, float* D1, float* D2,
                                    int ldd) {
  using S = K6Shape<F>;
  constexpr int NT = NB / 32;            // 16 x 8 tiles per row group
  constexpr int RG = S::M / 32;          // 16-row groups per warp
  constexpr int NX = MODE == 0 ? 1 : 2;  // weights per chunk
  constexpr int ND = MODE == 1 ? 2 : 1;  // products kept apart
  constexpr int RW = S::RW / NX;         // pairs per ring row
  constexpr int RING = S::RING;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * (S::M / 2), n0 = (warp >> 1) * (NB / 4);
  const int o0 = t ^ ring_swz(g, RW);  // the swizzled pair of depth t
  const int nch = cur.qp / (kBF ? KB : RW);
  float tot[ND][RG][NT][4];
#pragma unroll
  for (int o = 0; o < ND; ++o)
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tot[o][rg][j][0] = tot[o][rg][j][1] = tot[o][rg][j][2] =
            tot[o][rg][j][3] = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    uint2* other = ring + (slot ^ 1) * RING;
    if (ch + 1 < nch)
      k6_stage<S::RW>(cur, ch + 1, other);
    else if (next.b != nullptr)
      k6_stage<S::RW>(next, 0, other);
    cp_async_commit();
    const uint2* wc = ring + slot * RING;
    float d[ND][RG][NT][4];
#pragma unroll
    for (int o = 0; o < ND; ++o)
#pragma unroll
      for (int rg = 0; rg < RG; ++rg)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          d[o][rg][j][0] = d[o][rg][j][1] = d[o][rg][j][2] =
              d[o][rg][j][3] = 0.0f;
    if constexpr (kBF) {
      const unsigned* wb = reinterpret_cast<const unsigned*>(wc);
      const int sw = bf16_swz(g);  // rows x*NB + n0 + j*8 + g: r & 7 == g
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
            const unsigned* w = wb + (x * NB + n0 + j * 8 + g) * KBW;
            b[j][0] = w[(s * 8 + t) ^ sw];
            b[j][1] = w[(s * 8 + t + 4) ^ sw];
          }
          const int o = MODE == 1 ? x : 0;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int rg = 0; rg < RG; ++rg)
              mma_bf16(d[o][rg][j], a[rg], b[j]);
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
          const uint2* w = wc + (x * NB + n0 + j * 8 + g) * RW;
          const uint2 b0 = w[(s * 8) ^ o0], b4 = w[(s * 8) ^ o0 ^ 4];
          bh[j][0] = b0.x, bh[j][1] = b4.x, bl[j][0] = b0.y, bl[j][1] = b4.y;
        }
        const int o = MODE == 1 ? x : 0;
        // lo*hi, hi*lo, hi*hi of every tile in turn: RG NT independent
        // accumulators between two dependent products
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[o][rg][j], al[rg], bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[o][rg][j], ah[rg], bl[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(d[o][rg][j], ah[rg], bh[j]);
      }
    }
    }
#pragma unroll
    for (int o = 0; o < ND; ++o)
#pragma unroll
      for (int rg = 0; rg < RG; ++rg)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[o][rg][j][e] += d[o][rg][j][e];
    slot ^= 1;
  }
  __syncthreads();  // every warp is done reading A: D may overwrite it
#pragma unroll
  for (int o = 0; o < ND; ++o) {
    float* D = o == 0 ? D1 : D2;
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // (n, n + 1) as one 8-byte store
        const int m = m0 + rg * 16 + g, n = n0 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(D + m * ldd + n) =
            make_float2(tot[o][rg][j][0], tot[o][rg][j][1]);
        *reinterpret_cast<float2*>(D + (m + 8) * ldd + n) =
            make_float2(tot[o][rg][j][2], tot[o][rg][j][3]);
      }
  }
  __syncthreads();
  return slot;
}

// The step's per-slot mask and dir (fp32), and rbf in fp32 at row stride
// lr, zeros from R to pad32(R), for its M slot rows (TJ slots of M/TJ
// atoms; K5 takes 128). Slots past N or K read as zero, so they
// contribute nothing and stay finite (silu(0) = 0).
template <class E, int M, int TJ>
__device__ void k6_load_slots(const float* __restrict__ mask,
                              const float* __restrict__ dir,
                              const E* __restrict__ rbf, int b, int i0,
                              int k0, int N, int K, int R, int lr,
                              float* mask_s, float* dir_s, float* rbf_s) {
  for (int idx = threadIdx.x; idx < 4 * M; idx += kThreads) {
    const int gi = idx / M, p = idx - gi * M;  // 0: mask, 1-3: dir
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    const bool ok = i < N && k < K;
    if (gi == 0)
      mask_s[p] = ok ? mask[slot_at(b, i, k, N, K)] : 0.0f;
    else
      dir_s[(gi - 1) * M + p] =
          ok ? dir[slot_at(b * 3 + gi - 1, i, k, N, K)] : 0.0f;
  }
  const int Rp = pad32(R);
  for (int idx = threadIdx.x; idx < M * Rp; idx += kThreads) {
    const int p = idx / Rp, r = idx - p * Rp;
    const int i = i0 + p / TJ, k = k0 + p % TJ;
    rbf_s[p * lr + r] = i < N && k < K && r < R
                            ? ld(rbf + slot_at(b, i, k, N, K) * R + r)
                            : 0.0f;
  }
}

template <int F, bool FIRST, bool WGRAD, class E>
__global__ void __launch_bounds__(kThreads, 1)
klist_bwd_kernel(const float* __restrict__ npi, const E* __restrict__ cat,
                 const E* __restrict__ rbf, const float* __restrict__ dir,
                 const float* __restrict__ mask,
                 const uint2* __restrict__ wprep,
                 const float* __restrict__ dinv1,
                 const float* __restrict__ deq, float* __restrict__ dnpi,
                 E* __restrict__ dcat, E* __restrict__ drbf,
                 float* __restrict__ ddir, float* __restrict__ wpart, int N,
                 int K, int Fg_, int R, int n_itiles, int n_tiles) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  using S = K6Shape<F>;
  constexpr int TJ = S::TJ, M = S::M;
  constexpr int C = F / 32;
  constexpr int LD = S::LD;
  const int CW = FIRST ? Fg : 4 * Fg;
  const int Rp = pad32(R), lr = Rp + 4;
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // 2 x RING
  float* me_s = smem + 4 * S::RING;  // M x LD: me
  float* x_s = me_s + M * LD;        // M x LD: msg, h1, phi1, dphi1, dh1,
                                     //   dp1, dmsg
  float* y_s = x_s + M * LD;         // M x LD: p1, then h2, phi2, dphi2,
                                     //   dh2, dp2, dme
  float* z_s = y_s + M * LD;         // M x LD: p2, then msg (WGRAD)
  float* rbf_s = z_s + M * LD;       // M x lr: rbf, then drbf
  float* npi_s = rbf_s + M * lr;     // TI x F
  float* dinv_s = npi_s + TI * F;    // TI x F
  float* mask_s = dinv_s + TI * F;   // M
  float* dir_s = mask_s + M;         // 3 x M

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the products of a step, in the order of the prepared weights
  // (offsets in uint2: kEPP elements of the prepared type)
  const uint2* wb = wprep;
  auto next_w = [&](int qp, int two) {
    const K6W w = {wb, qp, F, two ? 2 : 1};
    wb += (size_t)F * qp * (two ? 2 : 1) / kEPP;
    return w;
  };
  const K6W w_me = next_w(Rp, 0);
  const K6W w_p = next_w(F, !FIRST);
  const K6W w_phi1 = next_w(F, 0), w_dh1 = next_w(F, 0);
  const K6W w_phi2 = FIRST ? w_dh1 : next_w(F, 0);
  const K6W w_dh2 = FIRST ? w_dh1 : next_w(F, 0);
  const K6W w_dmsg = next_w(F, !FIRST);
  const uint2* w_rbf = wb;  // 32 x F elements for each 32 columns r
  const K6W none = {nullptr, 0, 0, 0};
  // the block's weight partial: dWe, then dW1a, dW1b, dW2a, dW2b
  float* wp = WGRAD ? wpart + (size_t)blockIdx.x * wgrad_size(F, R) : nullptr;
  float* wp1a = WGRAD ? wp + (size_t)R * F : nullptr;
  const size_t ff = (size_t)F * F;

  int slot = 0;  // the ring slot of the next product's first chunk
  if ((int)blockIdx.x < n_tiles) k6_stage<S::RW>(w_me, 0, ring);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first_tile = tile == (int)blockIdx.x;
    const int b = tile / n_itiles;
    const int i0 = (tile - b * n_itiles) * TI;
    const int i = i0 + warp;
    __syncthreads();  // the last tile's reads of the row buffers are done
    load_rows(npi, b, i0, N, F, Fg, npi_s);
    load_rows(dinv1, b, i0, N, F, Fg, dinv_s);
    // deq of the warp's atom (zero past N and Fg), read through L1 where
    // used
    auto deq_at = [&](int d, int f) {
      return i < N && f < Fg
                 ? __ldg(deq + (((size_t)b * 3 + d) * N + i) * Fg + f)
                 : 0.0f;
    };
    float dnp_acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dnp_acc[c] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += TJ) {
      const bool init = first_tile && k0 == 0;
      const bool more = k0 + TJ < K || tile + (int)gridDim.x < n_tiles;
      if (k0 + TJ < K) {  // the next step's edge rows into L2
        const int kn = k0 + TJ, nk = min(TJ, K - kn);
        const int lines = (nk * CW * (int)sizeof(E) + 127) / 128;
        const int rlines = (nk * R * (int)sizeof(E) + 127) / 128;
        for (int v = threadIdx.x; v < TI * (lines + rlines); v += kThreads) {
          const int il = v / (lines + rlines), l = v - il * (lines + rlines);
          if (i0 + il >= N) continue;
          const size_t at = slot_at(b, i0 + il, kn, N, K);
          prefetch_l2(l < lines ? reinterpret_cast<const char*>(cat + at * CW)
                                      + l * 128
                                : reinterpret_cast<const char*>(rbf + at * R)
                                      + (l - lines) * 128);
        }
      }
      __syncthreads();  // the last step's reads of the slot buffers are done
      k6_load_slots<E, M, TJ>(mask, dir, rbf, b, i0, k0, N, K, R, lr, mask_s,
                              dir_s, rbf_s);
      slot = k6_prod<F, F, 0>(rbf_s, nullptr, lr, w_me, w_p, slot, ring,
                              me_s, nullptr, LD);  // me
      // msg = me np_i np_j mask, np_j from cat
      auto msg_into = [&](float* dst) {
#pragma unroll
        for (int r = 0; r < TJ; ++r) {
          const int p = warp * TJ + r, k = k0 + r;
          const bool ok = i < N && k < K;
          const E* cj = cat + (ok ? slot_at(b, i, k, N, K) * CW : 0);
          const float a = mask_s[p];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int f = lane + 32 * c;
            const float npj = ok && f < Fg ? ld(cj + f) : 0.0f;
            dst[p * LD + f] = me_s[p * LD + f] * npi_s[warp * F + f] * npj * a;
          }
        }
      };
      msg_into(x_s);
      // p1, p2 (the second branch is skipped at the first layer: force_node
      // is zero)
      if (FIRST)
        slot = k6_prod<F, F, 0>(x_s, nullptr, LD, w_p, w_phi1, slot, ring,
                                y_s, nullptr, LD);
      else
        slot = k6_prod<F, F, 1>(x_s, nullptr, LD, w_p, w_phi1, slot, ring,
                                y_s, z_s, LD);
      // ---- branch 1: h1 = silu(p1), phi1 = (h1 @ W1b) mask
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          x_s[o] = silu_fast(y_s[o]);
        }
      slot = k6_prod<F, F, 0>(x_s, nullptr, LD, w_phi1, w_dh1, slot, ring,
                              x_s, nullptr, LD);
      // ddir[d,i,k] = sum_f phi1 deq[d,i]; dphi1 = sum_d deq[d,i] dir[d,i,k]
      {
        float gq[3][C];
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int c = 0; c < C; ++c) gq[d][c] = deq_at(d, lane + 32 * c);
#pragma unroll
        for (int r = 0; r < TJ; ++r) {
          const int p = warp * TJ + r, k = k0 + r;
          const float a = mask_s[p];
          const float d0 = dir_s[p], d1 = dir_s[M + p], d2 = dir_s[2 * M + p];
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = p * LD + lane + 32 * c;
            const float phi = x_s[o] * a;
            s0 += phi * gq[0][c];
            s1 += phi * gq[1][c];
            s2 += phi * gq[2][c];
            x_s[o] = (gq[0][c] * d0 + gq[1][c] * d1 + gq[2][c] * d2) * a;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          if (lane == 0 && i < N && k < K) {
            ddir[slot_at(b * 3 + 0, i, k, N, K)] = s0;
            ddir[slot_at(b * 3 + 1, i, k, N, K)] = s1;
            ddir[slot_at(b * 3 + 2, i, k, N, K)] = s2;
          }
        }
      }
      if (WGRAD)  // dW1b = h1^T dphi1, h1 = silu(p1)
        wgrad_tc<F, M, true, false, kBF>(y_s, x_s, nullptr, nullptr, LD, F,
                                         wp1a + ff, init);
      // dh1 = dphi1 @ W1b^T; dp1 = dh1 silu'(p1)
      slot = k6_prod<F, F, 0>(x_s, nullptr, LD, w_dh1,
                              FIRST ? w_dmsg : w_phi2, slot, ring, x_s,
                              nullptr, LD);
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          x_s[o] = x_s[o] * dsilu_fast(y_s[o]);
        }

      // ---- branch 2: phi2 = (silu(p2) @ W2b) mask, in y_s
      if (!FIRST) {
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            y_s[o] = silu_fast(z_s[o]);
          }
        slot = k6_prod<F, F, 0>(y_s, nullptr, LD, w_phi2, w_dh2, slot, ring,
                                y_s, nullptr, LD);
        // dcat[force_j[d]] = phi2 deq[d,i]; dphi2 = sum_d deq[d,i] force_j[d]
        float gq[3][C];
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int c = 0; c < C; ++c) gq[d][c] = deq_at(d, lane + 32 * c);
#pragma unroll
        for (int r = 0; r < TJ; ++r) {
          const int p = warp * TJ + r, k = k0 + r;
          const bool ok = i < N && k < K;
          const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
          const float a = mask_s[p];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int f = lane + 32 * c, o = p * LD + f;
            const float phi = y_s[o] * a;
            float dphi = 0.0f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float gd = gq[d][c];
              if (ok && f < Fg) {
                st(dcat + at + (d + 1) * Fg + f, phi * gd);
                dphi += gd * ld(cat + at + (d + 1) * Fg + f);
              }
            }
            y_s[o] = dphi * a;
          }
        }
        if (WGRAD)  // dW2b = h2^T dphi2
          wgrad_tc<F, M, true, false, kBF>(z_s, y_s, nullptr, nullptr, LD,
                                           F, wp1a + 3 * ff, init);
        slot = k6_prod<F, F, 0>(y_s, nullptr, LD, w_dh2, w_dmsg, slot, ring,
                                y_s, nullptr, LD);
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int o = (warp * TJ + r) * LD + lane + 32 * c;
            y_s[o] = y_s[o] * dsilu_fast(z_s[o]);  // dp2
          }
      }
      if (WGRAD) {  // dW1a = msg^T dp1, dW2a = msg^T dp2; msg again, in z_s
        msg_into(z_s);
        wgrad_tc<F, M, false, false, kBF>(z_s, x_s, nullptr, nullptr, LD, F,
                                          wp1a, init);
        if (!FIRST)
          wgrad_tc<F, M, false, false, kBF>(z_s, y_s, nullptr, nullptr, LD,
                                            F, wp1a + 2 * ff, init);
      }
      // dmsg = dp1 @ W1a^T + dp2 @ W2a^T
      const K6W w_rbf0 = {w_rbf, F, 32, 1};
      if (FIRST)
        slot = k6_prod<F, F, 0>(x_s, nullptr, LD, w_dmsg, w_rbf0, slot, ring,
                                x_s, nullptr, LD);
      else
        slot = k6_prod<F, F, 2>(x_s, y_s, LD, w_dmsg, w_rbf0, slot, ring,
                                x_s, nullptr, LD);

      // d3 = (dmsg + dinv1_i) mask; t = d3 me: dnpi += t np_j, dcat[np_j] =
      // t np_i; dme = d3 np_i np_j
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r, k = k0 + r;
        const bool ok = i < N && k < K;
        const size_t at = ok ? slot_at(b, i, k, N, K) * CW : 0;
        const float a = mask_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c, o = p * LD + f;
          const float d3 = (x_s[o] + dinv_s[warp * F + f]) * a;
          const float tt = d3 * me_s[o];
          const float ni = npi_s[warp * F + f];
          const bool okf = ok && f < Fg;
          const float nj = okf ? ld(cat + at + f) : 0.0f;
          dnp_acc[c] += tt * nj;
          if (okf) st(dcat + at + f, tt * ni);
          y_s[o] = d3 * ni * nj;  // dme
        }
      }
      if (WGRAD)  // dWe = rbf^T dme
        wgrad_tc<F, M, false, false, kBF>(rbf_s, y_s, nullptr, nullptr, lr,
                                          R, wp, init);
      // drbf = dme @ We^T, 32 columns r at a time, into rbf_s; then the
      // next step's me
      for (int cb = 0; cb < Rp; cb += 32) {
        const K6W w_cb = {w_rbf + (size_t)cb * F / kEPP, F, 32, 1};
        const K6W w_next = {w_rbf + (size_t)(cb + 32) * F / kEPP, F, 32, 1};
        slot = k6_prod<F, 32, 0>(y_s, nullptr, LD, w_cb,
                                 cb + 32 < Rp ? w_next : more ? w_me : none,
                                 slot, ring, rbf_s + cb, nullptr, lr);
      }
      for (int idx = threadIdx.x; idx < M * R; idx += kThreads) {
        const int p = idx / R, r = idx - p * R;
        const int ii = i0 + p / TJ, k = k0 + p % TJ;
        if (ii < N && k < K)
          st(drbf + slot_at(b, ii, k, N, K) * R + r, rbf_s[p * lr + r]);
      }
    }

    if (i < N) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (lane + 32 * c < Fg)
          dnpi[((size_t)b * N + i) * Fg + lane + 32 * c] = dnp_acc[c];
    }
  }
}

// ------------------------------------------------------------------ K5 --
// K5, the forward, in the design of K6 (the notes above klist_bwd_kernel)
// with more slot rows per step. What bounds it: its products, 2(R*F + 4F^2)
// flops per slot at a full layer (50 GFLOP at the box shape B=1, N=4096,
// K=88, F=128, R=20), above the fp32 ridge. The CUDA-core version fed every
// FMA from shared memory, loaded each weight chunk with no product in
// flight and streamed all the weights from L2 for every 64-slot tile. So:
//
// * 128-slot steps: one block of 8 warps walks (molecule, TA5 = 16 atoms)
//   tiles blockIdx, blockIdx + gridDim, ... (at most one block per SM: the
//   wrapper passes the SM count), each in steps of TJ5 = 8 list slots: 128
//   slot rows per step, so every staged weight chunk feeds 128 rows and a
//   full layer streams half the weight bytes of K6's 64-row steps. K5 keeps
//   no cotangents, so two fp32 slot buffers hold the chain: x (me, msg, p1,
//   h1, phi1) and y (rbf, p2, h2, phi2), each product writing over its
//   input. Warp w owns the 16 slot rows of atoms 2w and 2w+1 and lane l
//   the F/32 contiguous features from l F/32 in the elementwise chain, so
//   inv1 and eq are per-thread register sums over k in a fixed order; no
//   sum crosses blocks.
// * Products on the tensor cores (k5_prod): mma.sync m16n8k8 tf32 in 3xTF32
//   (hi = tf32(x), lo = tf32(x - hi), lo*hi + hi*lo + hi*hi in fp32; no
//   1xTF32), 128 x Q @ Q x NB, warp w taking the 64 rows (w & 1) and NB/4
//   columns: 4 NB/32 independent 16 x 8 tiles per product, summed straight
//   into their accumulators (fresh registers per chunk, as K6 keeps, would
//   not fit beside them). p1/p2 run paired from msg, its A fragments split
//   once for both; phi1 and phi2 run one after the other.
// * Weights split once per launch: klist_prep_kernel writes the first
//   products of K6's table (me, p, phi1, phi2) as (hi, lo) tf32 pairs,
//   chunk-major and swizzled as a ring slot holds them; they stream through
//   K6's two-slot ring (32 depth steps of one weight or 16 of each of two),
//   the stream running across products, steps and tiles.
// * Activations with the fast exponential and division (silu_fast).
// * The next step's edge rows (cat, rbf) are prefetched into L2 at the
//   start of a step, so the chain's reads of np_j and force_j wait on L2;
//   a lane reads its features of a row (np_j, force_j[d], a slot buffer)
//   as one vector load.
// * Shared memory at F=128, R=20: the ring 64 KB, the two 128-row buffers
//   132 KB, the row inputs 8 KB: 206 KB, one block per SM.
// * Past F=128 (wide) a step takes K6's 4 slots of its 16 atoms (64 slot
//   rows) and K6's ring of 16 depth steps: 211 KB at F=256, R=20.
constexpr int TA5 = 16;             // atoms of a K5 tile
constexpr int APW5 = TA5 / kWarps;  // atoms per warp

// slot rows of a K5 step: TA5 atoms of K6's list slots per atom
template <int F>
constexpr int kM5 = TA5 * k6_tj(F);
// slots of an atom unrolled in the elementwise passes (a tuning knob:
// loads in flight against registers)
constexpr int kRowUnroll5 = 8;

// Row stride of K5's slot buffers: the wider of a feature row and an rbf
// row, plus 4 (conflict-free A fragment loads).
__host__ __device__ constexpr int k5_ld(int F, int R) {
  return (pad32(R) > F ? pad32(R) : F) + 4;
}

template <int F>
constexpr size_t k5_smem_floats(int R) {
  return (size_t)4 * K6Shape<F>::RING + (size_t)2 * kM5<F> * k5_ld(F, R) +
         (size_t)TA5 * F + (size_t)4 * kM5<F>;
}

// For the step's M5 slot rows m and n < NB, q < cur.qp, in 3xTF32 (bf16
// mode: one m16n8k16 bf16 mma per tile and k-step, A rounded to bf16
// where its fragments are loaded): MODE 0
// D1 = A B1; MODE 1 (pair) D1 = A B1 and D2 = A B2, where A is fp32 at row
// stride lda (zeros past the true depth) and B the prepared weight of cur
// (k6_product's layout); D1 and D2 at row stride lda. The weight stream is
// k6_prod's: chunk 0 of cur sits in ring slot `slot`, staged by the
// product before; while its last chunk multiplies this product stages
// chunk 0 of `next` (none if next.b is null) and returns that chunk's slot.
// Every warp reads every A row after the loop's first barrier and D is
// written after a barrier that follows the last read, so A may be written
// just before the call and D may be A. Ends with a __syncthreads. All
// threads of the block must call it. Not inlined (code size).
template <int F, int NB, int MODE>
__device__ __noinline__ int k5_prod(const float* A, int lda, K6W cur,
                                    K6W next, int slot, uint2* ring,
                                    float* D1, float* D2) {
  constexpr int M5 = kM5<F>;
  constexpr int RG = M5 / 32;            // 16-row groups per warp
  constexpr int NT = NB / 32;            // 16 x 8 tiles per row group
  constexpr int NX = MODE == 1 ? 2 : 1;  // weights per chunk
  constexpr int RW = K6Shape<F>::RW / NX;  // pairs per ring row
  constexpr int RING = K6Shape<F>::RING;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * (M5 / 2), n0 = (warp >> 1) * (NB / 4);
  const int o0 = t ^ ring_swz(g, RW);  // the swizzled pair of depth t
  const int n_chunks = cur.qp / (kBF ? KB : RW);
  float acc[NX][RG][NT][4];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[x][rg][j][0] = acc[x][rg][j][1] = acc[x][rg][j][2] =
            acc[x][rg][j][3] = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch is in; every warp is done with ch - 1
    uint2* other = ring + (slot ^ 1) * RING;
    if (ch + 1 < n_chunks)
      k6_stage<K6Shape<F>::RW>(cur, ch + 1, other);
    else if (next.b != nullptr)
      k6_stage<K6Shape<F>::RW>(next, 0, other);
    cp_async_commit();
    const uint2* wc = ring + slot * RING;
    if constexpr (kBF) {
      const unsigned* wb = reinterpret_cast<const unsigned*>(wc);
      const int sw = bf16_swz(g);  // rows x*NB + n0 + j*8 + g: r & 7 == g
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) {
        const int k = ch * KB + s * 16 + 2 * t;  // depth of the A words
        unsigned a[RG][4];
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          const float* r0 = A + (size_t)(m0 + rg * 16 + g) * lda;
          const float* r8 = r0 + (size_t)8 * lda;
          a[rg][0] = pack_bf16_at(r0 + k);
          a[rg][1] = pack_bf16_at(r8 + k);
          a[rg][2] = pack_bf16_at(r0 + k + 8);
          a[rg][3] = pack_bf16_at(r8 + k + 8);
        }
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          unsigned b[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const unsigned* w = wb + (x * NB + n0 + j * 8 + g) * KBW;
            b[j][0] = w[(s * 8 + t) ^ sw];
            b[j][1] = w[(s * 8 + t + 4) ^ sw];
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int rg = 0; rg < RG; ++rg)
              mma_bf16(acc[x][rg][j], a[rg], b[j]);
        }
      }
    } else {
#pragma unroll
    for (int s = 0; s < RW / 8; ++s) {
      const int k = ch * RW + s * 8 + t;  // depth of the A words k, k + 4
      unsigned ah[RG][4], al[RG][4];
#pragma unroll
      for (int rg = 0; rg < RG; ++rg) {
        const float* r0 = A + (size_t)(m0 + rg * 16 + g) * lda;
        const float* r8 = r0 + (size_t)8 * lda;
        split_tf32_mma(r0[k], ah[rg][0], al[rg][0]);
        split_tf32_mma(r8[k], ah[rg][1], al[rg][1]);
        split_tf32_mma(r0[k + 4], ah[rg][2], al[rg][2]);
        split_tf32_mma(r8[k + 4], ah[rg][3], al[rg][3]);
      }
#pragma unroll
      for (int x = 0; x < NX; ++x) {
        unsigned bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2* w = wc + (x * NB + n0 + j * 8 + g) * RW;
          const uint2 u0 = w[(s * 8) ^ o0], u4 = w[(s * 8) ^ o0 ^ 4];
          bh[j][0] = u0.x, bh[j][1] = u4.x, bl[j][0] = u0.y, bl[j][1] = u4.y;
        }
        // lo*hi, hi*lo, hi*hi of every tile in turn: RG NT independent
        // accumulators between two dependent products
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(acc[x][rg][j], al[rg], bh[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(acc[x][rg][j], ah[rg], bl[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int rg = 0; rg < RG; ++rg)
            mma_tf32(acc[x][rg][j], ah[rg], bh[j]);
      }
    }
    }
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
        *reinterpret_cast<float2*>(D + m * lda + n) =
            make_float2(acc[x][rg][j][0], acc[x][rg][j][1]);
        *reinterpret_cast<float2*>(D + (m + 8) * lda + n) =
            make_float2(acc[x][rg][j][2], acc[x][rg][j][3]);
      }
  }
  __syncthreads();
  return slot;
}

// The largest power of two that divides n: the alignment of a Pack.
__host__ __device__ constexpr size_t pack_align(size_t n) {
  return n & (~n + 1);
}

// C contiguous values, loaded or stored as one vector (as several, where
// C is no power of two)
template <int C, class T>
struct alignas(pack_align(C * sizeof(T))) Pack {
  T v[C];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// p[0..C) in fp32, one vector load
template <int C, class T>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[C]) {
  const Pack<C, T> q = *reinterpret_cast<const Pack<C, T>*>(p);
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = to_f(q.v[c]);
}

template <int C>
__device__ __forceinline__ void store_pack(float* p, const float (&in)[C]) {
  Pack<C, float> q;
#pragma unroll
  for (int c = 0; c < C; ++c) q.v[c] = in[c];
  *reinterpret_cast<Pack<C, float>*>(p) = q;
}

// The lane's C features f0.. of a row of a tensor of width Fg, zero from
// Fg on: one vector load where the tensor is at the padded width (full),
// else one masked load each.
template <int C, class T>
__device__ __forceinline__ void load_feats(const T* row, int f0, int Fg,
                                           bool full, float (&out)[C]) {
  if (full) {
    load_pack<C>(row + f0, out);
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = f0 + c < Fg ? to_f(row[f0 + c]) : 0.0f;
}

template <int C>
__device__ __forceinline__ void store_feats(float* row, int f0, int Fg,
                                            bool full, const float (&in)[C]) {
  if (full) {
    store_pack<C>(row + f0, in);
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (f0 + c < Fg) row[f0 + c] = in[c];
}

template <int F, bool FIRST, class E>
__global__ void __launch_bounds__(kThreads, 1)
klist_fwd_kernel(const float* __restrict__ npi, const E* __restrict__ cat,
                 const E* __restrict__ rbf, const float* __restrict__ dir,
                 const float* __restrict__ mask,
                 const uint2* __restrict__ wprep, float* __restrict__ inv1,
                 float* __restrict__ eq, int N, int K, int Fg_, int R,
                 int n_itiles, int n_tiles) {
  const int Fg = kPadded ? Fg_ : F;  // the tensors' width
  constexpr int TJ = K6Shape<F>::TJ, M = kM5<F>;
  constexpr int RPW = M / kWarps;  // slot rows per warp (silu pass)
  constexpr int C = F / 32;        // features per lane: lane*C ..
  const int CW = FIRST ? Fg : 4 * Fg;
  const bool full = Fg == F;  // the global rows as vectors
  const int Rp = pad32(R), L = k5_ld(F, R);
  extern __shared__ float smem[];
  uint2* ring = reinterpret_cast<uint2*>(smem);  // 2 x RING
  float* x_s = smem + 4 * K6Shape<F>::RING;  // M x L: me, msg, p1, h1, phi1
  float* y_s = x_s + M * L;                  // M x L: rbf, p2, h2, phi2
  float* npi_s = y_s + M * L;                // TA5 x F
  float* mask_s = npi_s + TA5 * F;           // M
  float* dir_s = mask_s + M;                 // 3 x M

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = lane * C;  // the lane's first feature
  // the products of a step, in the order of the prepared weights
  // (offsets in uint2: kEPP elements of the prepared type)
  const uint2* wb = wprep;
  auto next_w = [&](int qp, int two) {
    const K6W w = {wb, qp, F, two ? 2 : 1};
    wb += (size_t)F * qp * (two ? 2 : 1) / kEPP;
    return w;
  };
  const K6W w_me = next_w(Rp, 0);
  const K6W w_p = next_w(F, !FIRST);
  const K6W w_phi1 = next_w(F, 0);
  const K6W w_phi2 = FIRST ? w_phi1 : next_w(F, 0);
  const K6W none = {nullptr, 0, 0, 0};

  int slot = 0;  // the ring slot of the next product's first chunk
  if ((int)blockIdx.x < n_tiles) k6_stage<K6Shape<F>::RW>(w_me, 0, ring);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_itiles;
    const int i0 = (tile - b * n_itiles) * TA5;
    __syncthreads();  // the last tile's reads of npi_s are done
    load_rows(npi, b, i0, N, F, Fg, npi_s, TA5);
    float inv_acc[APW5][C], eq_acc[APW5][3][C];
#pragma unroll
    for (int a = 0; a < APW5; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c)
        inv_acc[a][c] = eq_acc[a][0][c] = eq_acc[a][1][c] = eq_acc[a][2][c] =
            0.0f;

    for (int k0 = 0; k0 < K; k0 += TJ) {
      const bool more = k0 + TJ < K || tile + (int)gridDim.x < n_tiles;
      if (k0 + TJ < K) {  // the next step's edge rows into L2
        const int kn = k0 + TJ, nk = min(TJ, K - kn);
        const int lines = (nk * CW * (int)sizeof(E) + 127) / 128;
        const int rlines = (nk * R * (int)sizeof(E) + 127) / 128;
        for (int v = threadIdx.x; v < TA5 * (lines + rlines); v += kThreads) {
          const int il = v / (lines + rlines), l = v - il * (lines + rlines);
          if (i0 + il >= N) continue;
          const size_t at = slot_at(b, i0 + il, kn, N, K);
          prefetch_l2(l < lines ? reinterpret_cast<const char*>(cat + at * CW)
                                      + l * 128
                                : reinterpret_cast<const char*>(rbf + at * R)
                                      + (l - lines) * 128);
        }
      }
      __syncthreads();  // the last step's reads of the slot buffers are done
      k6_load_slots<E, M, TJ>(mask, dir, rbf, b, i0, k0, N, K, R, L, mask_s,
                              dir_s, y_s);
      slot = k5_prod<F, F, 0>(y_s, L, w_me, w_p, slot, ring, x_s,
                              nullptr);  // me
      // msg = me np_i np_j mask in place, np_j from cat; inv1 += msg
#pragma unroll
      for (int a = 0; a < APW5; ++a) {
        const int al = warp * APW5 + a, i = i0 + al;  // the warp's atoms
        float ni[C];
        load_pack<C>(npi_s + al * F + f0, ni);
#pragma unroll(kRowUnroll5)
        for (int kk = 0; kk < TJ; ++kk) {
          const int p = al * TJ + kk, k = k0 + kk;
          float nj[C] = {}, v[C];
          if (i < N && k < K)
            load_feats<C>(cat + slot_at(b, i, k, N, K) * CW, f0, Fg, full, nj);
          load_pack<C>(x_s + p * L + f0, v);
          const float m = mask_s[p];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            v[c] = v[c] * ni[c] * nj[c] * m;
            inv_acc[a][c] += v[c];
          }
          store_pack<C>(x_s + p * L + f0, v);
        }
      }
      // p1 into x, p2 into y (the second branch is skipped at the first
      // layer: force_node is zero)
      if (FIRST)
        slot = k5_prod<F, F, 0>(x_s, L, w_p, w_phi1, slot, ring, x_s,
                                nullptr);
      else
        slot = k5_prod<F, F, 1>(x_s, L, w_p, w_phi1, slot, ring, x_s, y_s);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float* row[2] = {x_s + (warp * RPW + r) * L + f0,
                         y_s + (warp * RPW + r) * L + f0};
#pragma unroll
        for (int x = 0; x < (FIRST ? 1 : 2); ++x) {
          float v[C];
          load_pack<C>(row[x], v);
#pragma unroll
          for (int c = 0; c < C; ++c) v[c] = silu_fast(v[c]);
          store_pack<C>(row[x], v);
        }
      }
      // phi1 = h1 @ W1b, phi2 = h2 @ W2b (masked below); then the next
      // step's me
      slot = k5_prod<F, F, 0>(x_s, L, w_phi1,
                              !FIRST ? w_phi2 : more ? w_me : none, slot,
                              ring, x_s, nullptr);
      if (!FIRST)
        slot = k5_prod<F, F, 0>(y_s, L, w_phi2, more ? w_me : none, slot,
                                ring, y_s, nullptr);
      // eq[d] += phi1 dir[d] + phi2 force_j[d]
#pragma unroll
      for (int a = 0; a < APW5; ++a) {
        const int al = warp * APW5 + a, i = i0 + al;
#pragma unroll(kRowUnroll5)
        for (int kk = 0; kk < TJ; ++kk) {
          const int p = al * TJ + kk, k = k0 + kk;
          const float m = mask_s[p];
          const float dd[3] = {dir_s[p], dir_s[M + p], dir_s[2 * M + p]};
          float phi[C];
          load_pack<C>(x_s + p * L + f0, phi);
#pragma unroll
          for (int d = 0; d < 3; ++d)
#pragma unroll
            for (int c = 0; c < C; ++c) eq_acc[a][d][c] += phi[c] * m * dd[d];
          if (!FIRST) {
            load_pack<C>(y_s + p * L + f0, phi);
            float fj[3][C] = {};
            if (i < N && k < K) {
              const E* cj = cat + slot_at(b, i, k, N, K) * CW;
#pragma unroll
              for (int d = 0; d < 3; ++d)
                load_feats<C>(cj + (d + 1) * Fg, f0, Fg, full, fj[d]);
            }
#pragma unroll
            for (int d = 0; d < 3; ++d)
#pragma unroll
              for (int c = 0; c < C; ++c)
                eq_acc[a][d][c] += phi[c] * m * fj[d][c];
          }
        }
      }
    }

#pragma unroll
    for (int a = 0; a < APW5; ++a) {
      const int i = i0 + warp * APW5 + a;
      if (i >= N) continue;
      store_feats<C>(inv1 + ((size_t)b * N + i) * Fg, f0, Fg, full,
                     inv_acc[a]);
#pragma unroll
      for (int d = 0; d < 3; ++d)
        store_feats<C>(eq + (((size_t)b * 3 + d) * N + i) * Fg, f0, Fg, full,
                       eq_acc[a][d]);
    }
  }
}

// out[e] = sum_blk part[blk, e] for e < n_valid; 0 for the rest (the
// first layer's W2a/W2b). out is at width Fg, the partials at F. Fixed
// summation order.
__global__ void klist_wsum_kernel(float* __restrict__ out,
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

cudaError_t sum_weights(float* dw, const float* wpart, int n_blocks, int F,
                        int Fg, int R, bool first, cudaStream_t stream) {
  const size_t n = wgrad_size(Fg, R);
  const size_t n_valid = first ? (size_t)R * Fg + 2 * (size_t)Fg * Fg : n;
  klist_wsum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dw, wpart, n_blocks, R, F, Fg, n_valid);
  return cudaGetLastError();
}

// ------------------------------------------------------------- launches --
// Pointers of one call: inputs, outputs and scratch, in the order of the C
// functions below. Edge tensors are untyped until the launch picks E.
struct Args {
  const void* in[18];
  void* out[7];
  int B, N, K, R;
  bool wgrad;
  cudaStream_t stream;
  int max_blocks;  // K5, K6, K8: the grid's upper bound (one block per SM)
  int Fg;          // the tensors' true width
};

template <class T>
const T* cin(const Args& a, int k) {
  return static_cast<const T*>(a.in[k]);
}
template <class T>
T* cout_(const Args& a, int k) {
  return static_cast<T*>(a.out[k]);
}

// The weights of K5 (fwd) or K6 split into tf32 pairs, into wprep.
cudaError_t prep_weights(const float* const* W, uint2* wprep, int F, int Fg,
                         int R, bool first, bool fwd, cudaStream_t stream) {
  const size_t want = (prep_pairs(fwd, F, R) + 255) / 256;
  klist_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0, stream>>>(
      W[0], W[1], W[2], W[3], W[4], wprep, F, Fg, R, first ? 1 : 0,
      fwd ? 1 : 0);
  return cudaGetLastError();
}

template <int F, bool FIRST, class E>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = k5_smem_floats<F>(a.R) * sizeof(float);
  auto kern = klist_fwd_kernel<F, FIRST, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (a.N + TA5 - 1) / TA5;
  const int n_tiles = a.B * n_itiles;
  const int n_blocks = n_tiles < a.max_blocks ? n_tiles : a.max_blocks;
  if (n_blocks < 1) return cudaErrorInvalidValue;
  // the vector loads of the elementwise chain at the padded width: F/32
  // values of npi, cat, inv1 and eq at a time
  const size_t vec = pack_align((size_t)(F / 32) * sizeof(E));
  const size_t vecf = pack_align((size_t)(F / 32) * sizeof(float));
  if (a.Fg == F && ((size_t)a.in[1] % vec || (size_t)a.in[0] % vecf ||
                    (size_t)a.out[0] % vecf || (size_t)a.out[1] % vecf))
    return cudaErrorInvalidValue;
  const float* W[5];
  for (int k = 0; k < 5; ++k) W[k] = cin<float>(a, 5 + k);
  uint2* wprep = cout_<uint2>(a, 2);  // the launch's scratch
  err = prep_weights(W, wprep, F, a.Fg, a.R, FIRST, true, a.stream);
  if (err != cudaSuccess) return err;
  kern<<<n_blocks, kThreads, smem, a.stream>>>(
      cin<float>(a, 0), cin<E>(a, 1), cin<E>(a, 2), cin<float>(a, 3),
      cin<float>(a, 4), wprep, cout_<float>(a, 0), cout_<float>(a, 1), a.N,
      a.K, a.Fg, a.R, n_itiles, n_tiles);
  return cudaGetLastError();
}

template <int F, bool FIRST, bool WGRAD, class E>
cudaError_t launch_bwd_w(const Args& a) {
  const size_t smem = k6_smem_floats<F>(a.R) * sizeof(float);
  auto kern = klist_bwd_kernel<F, FIRST, WGRAD, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (a.N + TI - 1) / TI;
  const int n_tiles = a.B * n_itiles;
  const int n_blocks = n_tiles < a.max_blocks ? n_tiles : a.max_blocks;
  if (n_blocks < 1) return cudaErrorInvalidValue;
  const float* W[5];
  for (int k = 0; k < 5; ++k) W[k] = cin<float>(a, 5 + k);
  uint2* wprep = cout_<uint2>(a, 6);  // the launch's scratch
  err = prep_weights(W, wprep, F, a.Fg, a.R, FIRST, false, a.stream);
  if (err != cudaSuccess) return err;
  float* wpart = cout_<float>(a, 4);
  kern<<<n_blocks, kThreads, smem, a.stream>>>(
      cin<float>(a, 0), cin<E>(a, 1), cin<E>(a, 2), cin<float>(a, 3),
      cin<float>(a, 4), wprep, cin<float>(a, 10), cin<float>(a, 11),
      cout_<float>(a, 0), cout_<E>(a, 1), cout_<E>(a, 2), cout_<float>(a, 3),
      wpart, a.N, a.K, a.Fg, a.R, n_itiles, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || !WGRAD) return err;
  return sum_weights(cout_<float>(a, 5), wpart, n_blocks, F, a.Fg, a.R,
                     FIRST, a.stream);
}

template <int F, bool FIRST, class E>
cudaError_t launch_bwd(const Args& a) {
  return a.wgrad ? launch_bwd_w<F, FIRST, true, E>(a)
                 : launch_bwd_w<F, FIRST, false, E>(a);
}

template <int F, bool FIRST, class E>
cudaError_t launch_dual_fwd(const Args& a) {
  const size_t smem = k7_smem_floats<F>(a.R) * sizeof(float);
  auto kern = klist_dual_fwd_kernel<F, FIRST, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (a.N + TI - 1) / TI;
  const float* W[5];
  for (int k = 0; k < 5; ++k) W[k] = cin<float>(a, 9 + k);
  uint2* wprep = cout_<uint2>(a, 4);  // the launch's scratch
  const size_t want = (k7_prep_offset(F, a.R, 5) + 255) / 256;
  klist_dual_fwd_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                               a.stream>>>(W[0], W[1], W[2], W[3], W[4],
                                           wprep, F, a.Fg, a.R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const E* cat = cin<E>(a, 2);
  const E* catdot = cin<E>(a, 3);
  const E* rbf = cin<E>(a, 4);
  const E* rbfdot = cin<E>(a, 5);
  kern<<<a.B * n_itiles, kThreads, smem, a.stream>>>(
      cin<float>(a, 0), cin<float>(a, 1), cat, catdot, rbf, rbfdot,
      cin<float>(a, 6), cin<float>(a, 7), cin<float>(a, 8), wprep,
      cout_<float>(a, 0), cout_<float>(a, 1), cout_<float>(a, 2),
      cout_<float>(a, 3), a.N, a.K, a.Fg, a.R, n_itiles);
  return cudaGetLastError();
}

template <int F, bool FIRST, class E>
cudaError_t launch_dual_bwd(const Args& a) {
  const size_t smem = dual_bwd_smem_floats<F>(a.R) * sizeof(float);
  auto kern = klist_dual_bwd_kernel<F, FIRST, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (a.N + TI - 1) / TI;
  const int n_tiles = a.B * n_itiles;
  const int n_blocks = n_tiles < a.max_blocks ? n_tiles : a.max_blocks;
  if (n_blocks < 1) return cudaErrorInvalidValue;
  const int N = a.N, K = a.K, Fg = a.Fg, R = a.R;
  float* wpart = cout_<float>(a, 4);
  const float* W[5];
  for (int k = 0; k < 5; ++k) W[k] = cin<float>(a, 9 + k);
  if constexpr (kBF) {
    // the products' weights in bf16 (zero-padded), after the partials; the
    // kernel finds them at W[0]
    unsigned* wprep = reinterpret_cast<unsigned*>(
        wpart + (size_t)n_blocks * wgrad_size(F, R));
    const size_t want = (k8_prep_offset(F, R, 9) + 255) / 256;
    klist_dual_bwd_prep_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                                 a.stream>>>(W[0], W[1], W[2], W[3], W[4],
                                             wprep, F, Fg, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    W[0] = reinterpret_cast<const float*>(wprep);
  } else if (Fg != F) {  // the weights at width F, zero-padded, after the
                         // partials
    float* wpad = wpart + (size_t)n_blocks * wgrad_size(F, R);
    const size_t want = (wgrad_size(F, R) + 255) / 256;
    klist_pad_weights_kernel<<<(unsigned)(want < 264 ? want : 264), 256, 0,
                               a.stream>>>(W[0], W[1], W[2], W[3], W[4],
                                           wpad, F, Fg, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    W[0] = wpad;
    for (int k = 1; k < 5; ++k)
      W[k] = wpad + (size_t)R * F + (size_t)(k - 1) * F * F;
  }
  const float* npi = cin<float>(a, 0);
  const float* npidot = cin<float>(a, 1);
  const E* cat = cin<E>(a, 2);
  const E* catdot = cin<E>(a, 3);
  const E* rbf = cin<E>(a, 4);
  const E* rbfdot = cin<E>(a, 5);
  const float* dir = cin<float>(a, 6);
  const float* dirdot = cin<float>(a, 7);
  const float* mask = cin<float>(a, 8);
  const float* di = cin<float>(a, 14);
  const float* dq = cin<float>(a, 15);
  const float* didot = cin<float>(a, 16);
  const float* dqdot = cin<float>(a, 17);
  float* dnpi = cout_<float>(a, 0);
  float* dnpidot = cout_<float>(a, 1);
  E* dcat = cout_<E>(a, 2);
  E* dcatdot = cout_<E>(a, 3);
  kern<<<n_blocks, kThreads, smem, a.stream>>>(
      npi, npidot, cat, catdot, rbf, rbfdot, dir, dirdot, mask, W[0], W[1],
      W[2], W[3], W[4], di, dq, didot, dqdot, dnpi, dnpidot, dcat, dcatdot,
      wpart, N, K, Fg, R, n_itiles, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_weights(cout_<float>(a, 5), wpart, n_blocks, F, Fg, R, FIRST,
                     a.stream);
}

typedef cudaError_t (*launch_fn)(const Args&);

// The instantiation for (F, first, bf16), where F is the true width, or
// nullptr for an F this library does not run.
template <template <int, bool, class> class L>
launch_fn pick(int F, bool first, bool bf) {
  constexpr int FF = NN_WIDTH;
  if (!library_runs(F)) return nullptr;
  return first ? (bf ? L<FF, true, bf16>::fn : L<FF, true, float>::fn)
               : (bf ? L<FF, false, bf16>::fn : L<FF, false, float>::fn);
}

template <int F, bool FIRST, class E>
struct Fwd {
  static constexpr launch_fn fn = launch_fwd<F, FIRST, E>;
};
template <int F, bool FIRST, class E>
struct Bwd {
  static constexpr launch_fn fn = launch_bwd<F, FIRST, E>;
};
template <int F, bool FIRST, class E>
struct DualFwd {
  static constexpr launch_fn fn = launch_dual_fwd<F, FIRST, E>;
};
template <int F, bool FIRST, class E>
struct DualBwd {
  static constexpr launch_fn fn = launch_dual_bwd<F, FIRST, E>;
};

template <template <int, bool, class> class L>
int run(int F, int first, int bf16, Args& a) {
  const launch_fn fn = pick<L>(F, first != 0, bf16 != 0);
  if (fn == nullptr || a.B * a.N * a.K == 0) return (int)cudaErrorInvalidValue;
  a.Fg = F;
  return (int)fn(a);
}

}  // namespace

extern "C" {

// K5. npi (B,N,F) f32; cat (B,N,K,C), C = F if first_layer else 4F, and
// rbf (B,N,K,R) in the edge type (fp32, or bf16 when bf16 != 0); dir
// (B,3,N,K), mask (B,N,K) f32; We (R,F), W* (F,F) f32 -> inv1 (B,N,F),
// eq (B,3,N,F) f32. Contiguous, on the device of `stream`; any F this
// library runs (library_runs), else cudaErrorInvalidValue. Scratch: 16-byte aligned,
// nn_klist_scratch_floats(F, R, 0) floats (the weights split into tf32
// pairs); max_blocks bounds the grid (the wrapper passes the SM count).
int nn_klist_fwd(const float* npi, const void* cat, const void* rbf,
                 const float* dir, const float* mask, const float* We,
                 const float* W1a, const float* W1b, const float* W2a,
                 const float* W2b, float* inv1, float* eq, float* scratch,
                 int B, int N, int K, int F, int R, int first_layer, int bf16,
                 int max_blocks, void* stream) {
  Args a = {{npi, cat, rbf, dir, mask, We, W1a, W1b, W2a, W2b},
            {inv1, eq, scratch},
            B, N, K, R, false, static_cast<cudaStream_t>(stream),
            max_blocks};
  return run<Fwd>(F, first_layer, bf16, a);
}

// K6. Inputs of K5 plus dinv1 (B,N,F), deq (B,3,N,F) f32. Outputs dnpi
// (B,N,F) f32, dcat (B,N,K,C) and drbf (B,N,K,R) in the edge type, ddir
// (B,3,N,K) f32. With weight_grads: scratch wpart, 16-byte aligned,
// nn_klist_wpart_floats(min(B*ceil(N/8), max_blocks), F, R) floats, and
// output dw (R*F+4F^2: dWe, dW1a, dW1b, dW2a, dW2b). Scratch: 16-byte
// aligned, nn_klist_scratch_floats(F, R, 1) floats (the weights split
// into tf32 pairs); max_blocks bounds the grid (the wrapper passes the SM
// count).
int nn_klist_bwd(const float* npi, const void* cat, const void* rbf,
                 const float* dir, const float* mask, const float* We,
                 const float* W1a, const float* W1b, const float* W2a,
                 const float* W2b, const float* dinv1, const float* deq,
                 float* dnpi, void* dcat, void* drbf, float* ddir,
                 float* wpart, float* dw, float* scratch, int B, int N, int K,
                 int F, int R, int first_layer, int weight_grads, int bf16,
                 int max_blocks, void* stream) {
  Args a = {{npi, cat, rbf, dir, mask, We, W1a, W1b, W2a, W2b, dinv1, deq},
            {dnpi, dcat, drbf, ddir, wpart, dw, scratch},
            B, N, K, R, weight_grads != 0,
            static_cast<cudaStream_t>(stream), max_blocks};
  return run<Bwd>(F, first_layer, bf16, a);
}

// K7. npi, npidot (B,N,F) f32; cat, catdot (B,N,K,C) and rbf, rbfdot
// (B,N,K,R) in the edge type; dir, dirdot (B,3,N,K), mask (B,N,K) f32;
// We, W* f32 -> inv1, inv1dot (B,N,F), eq, eqdot (B,3,N,F) f32. Scratch:
// 16-byte aligned, nn_klist_scratch_floats(F, R, 2) floats (the weights
// split into tf32 pairs, or in bf16).
int nn_klist_dual_fwd(const float* npi, const float* npidot, const void* cat,
                      const void* catdot, const void* rbf, const void* rbfdot,
                      const float* dir, const float* dirdot,
                      const float* mask, const float* We, const float* W1a,
                      const float* W1b, const float* W2a, const float* W2b,
                      float* inv1, float* eq, float* inv1dot, float* eqdot,
                      float* scratch, int B, int N, int K, int F, int R,
                      int first_layer, int bf16, void* stream) {
  Args a = {{npi, npidot, cat, catdot, rbf, rbfdot, dir, dirdot, mask, We,
             W1a, W1b, W2a, W2b},
            {inv1, eq, inv1dot, eqdot, scratch},
            B, N, K, R, false, static_cast<cudaStream_t>(stream)};
  return run<DualFwd>(F, first_layer, bf16, a);
}

// K8. Inputs of K7 plus di, didot (B,N,F) and dq, dqdot (B,3,N,F) f32.
// Outputs dnpi, dnpidot (B,N,F)
// f32, dcat, dcatdot (B,N,K,C) in the edge type and dw (R*F+4F^2).
// The weights 16-byte aligned (cp.async). Scratch wpart, 16-byte aligned,
// nn_klist_wpart_floats(min(B*ceil(N/8), max_blocks), F, R) floats (the
// weight partials and the weights prepared in bf16 or, in an fp32 library
// where F is no multiple of 32, padded to one); max_blocks bounds the grid
// (the wrapper passes the SM count).
int nn_klist_dual_bwd(const float* npi, const float* npidot, const void* cat,
                      const void* catdot, const void* rbf, const void* rbfdot,
                      const float* dir, const float* dirdot,
                      const float* mask, const float* We, const float* W1a,
                      const float* W1b, const float* W2a, const float* W2b,
                      const float* di, const float* dq, const float* didot,
                      const float* dqdot, float* dnpi, float* dnpidot,
                      void* dcat, void* dcatdot, float* wpart, float* dw,
                      int B, int N, int K, int F, int R, int first_layer,
                      int bf16, int max_blocks, void* stream) {
  Args a = {{npi, npidot, cat, catdot, rbf, rbfdot, dir, dirdot, mask, We,
             W1a, W1b, W2a, W2b, di, dq, didot, dqdot},
            {dnpi, dnpidot, dcat, dcatdot, wpart, dw},
            B, N, K, R, false, static_cast<cudaStream_t>(stream),
            max_blocks};
  return run<DualBwd>(F, first_layer, bf16, a);
}

// Dynamic shared memory of one block of K5 (kind 0), K6 (1), K7 (2) or K8
// (3) at true width F, in bytes; 0 for an F this library does not run.
size_t nn_klist_smem_bytes(int F, int R, int kind) {
  constexpr int FF = NN_WIDTH;
  if (!library_runs(F)) return 0;
  return (kind == 0   ? k5_smem_floats<FF>(R)
          : kind == 1 ? k6_smem_floats<FF>(R)
          : kind == 2 ? k7_smem_floats<FF>(R)
                      : dual_bwd_smem_floats<FF>(R)) * sizeof(float);
}

// Scratch of one launch of K5 (kind 0), K6 (1), K7 (2) or K8 (3) at true
// width F, in floats, beyond the weight partials that K6 and K8 take as an
// argument: the weights split into tf32 pairs (K5: four blocks, K6: ten,
// K7: five); 0 for K8.
size_t nn_klist_scratch_floats(int F, int R, int kind) {
  const int Fp = padded_width(F);
  return kind <= 1   ? 2 * prep_pairs(kind == 0, Fp, R)
         : kind == 2 ? 2 * k7_prep_offset(Fp, R, 5)
                     : 0;
}

// The weight partials' scratch (wpart) of a K6 or K8 launch of n_blocks
// blocks at true width F, in floats: one partial at the padded width per
// block and K8's weights: in bf16 its products' prepared B operands, in
// fp32 where F is no multiple of 32 the weights zero-padded.
size_t nn_klist_wpart_floats(int n_blocks, int F, int R) {
  const int Fp = padded_width(F);
  return (size_t)n_blocks * wgrad_size(Fp, R) +
         (kBF ? k8_prep_offset(Fp, R, 9) : Fp != F ? wgrad_size(Fp, R) : 0);
}

}  // extern "C"
