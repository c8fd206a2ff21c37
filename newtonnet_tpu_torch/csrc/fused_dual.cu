// Dual (primal + position tangent) fused pair-interaction layer for Hopper
// (sm_90a): the parameter-gradient path of force training.
//
// Replaces the TPU kernels newtonnet_tpu/ops/pallas_dense.py:
// _dual_fwd_kernel (K3) and _dual_bwd_kernel (K4). Both are templated on
// the feature width F (32, 64 or 128), on FIRST (the stack's first layer,
// where force, forcedot and npdot are zero: the phi2 branch and every npdot
// term are skipped, and K4's dforce, dforcedot, dnpdot, dW2a and dW2b are
// exact zeros) and on BF (bf16 mode). R (radial basis size) and N (atoms)
// are runtime.
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
// Precision. With BF every operand of every matrix product (the gemm A
// rows and weights, both operands of the weight-cotangent products) is
// rounded to bf16 with __float2bfloat16_rn and the product accumulated in
// fp32, where the JAX package's `dot`/`dotT` round (pallas_dense.py
// :267-269, :369-378); all elementwise arithmetic stays fp32. A product of
// two bf16 values is exact in fp32, so the kernels and the plain versions
// (ops/fused_dual.py) differ only in summation order. Plain IEEE fp32 FMAs,
// no tensor cores.
//
// What bounds it on this card: operations. Per pair slot K3 does
// 16F^2 + 4RF flops of matrix products and K4 44F^2 + 8RF (276 and 737
// kflop at F=128, R=20) against 2R+8 floats of pair data read.
//
// Design: K1/K2's (csrc/fused_dense.cu). One block of 8 warps per
// (molecule, tile of TI=8 rows i), looping over tiles of TJ=4 columns j, so
// a tile is M=32 pair slots; warp w owns the TJ slots of row i0+w, lane l
// owns feature columns l+32c. The per-slot chain lives only in shared
// memory and registers, the weights stay in L2 and stream through shared
// memory in KC-row chunks, and sums over j are per-thread register sums.
// K4 carries a primal and a tangent of every intermediate (msg, p, h, g,
// dp and their dots: 8 slot buffers of M x (F+1) floats), so its tile is
// half of K2's 64 slots: 207 KB of shared memory at F=128, R=20, one block
// per SM; K3 takes 110 KB.
//
// K4's sums over i (the column parts of dnp and dnpdot, dforce, dforcedot)
// and its weight cotangents cross blocks: each block writes its partials
// to scratch (one slot per (molecule, i-tile)) and a second kernel sums
// them in a fixed order. No float atomics: a run gives the same bits every
// time. The host functions return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TI = kWarps;   // rows i per block: one per warp
constexpr int TJ = 4;        // columns j per tile: all held by one warp
constexpr int M = TI * TJ;   // pair slots per tile; slot p = il * TJ + jl
constexpr int KC = 32;       // rows of a streamed weight chunk
constexpr int kColSlots = 8; // K4 column partials: dnp, dnpdot, dforce[3],
                             // dforcedot[3]

template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
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

// acc[r][c] = sum_k A[(w*TJ + r)*lda + k] * B(k, l + 32c), k < K, for the
// calling thread's warp w and lane l. B(k, n) = W[k*F + n] (W is K x F), or
// with TRANS B(k, n) = W[n*K + k] (W is F x K). With BF both operands are
// rounded to bf16. A holds the warp's own slots only, so a warp may write
// its A rows just before the call and any other buffer's rows just after;
// the leading __syncthreads of each chunk orders everything else. Every lane
// reads all of a row, so overwriting A itself after the call needs a
// __syncwarp first. All threads of the block must call it.
template <int F, bool TRANS, bool BF>
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
    if (!TRANS) {
      for (int idx = threadIdx.x; idx < kc * F; idx += kThreads) {
        const int kk = idx / F, n = idx - kk * F;
        w_s[kk * WLD + n] = rnd<BF>(W[(size_t)(k0 + kk) * F + n]);
      }
    } else {
      for (int idx = threadIdx.x; idx < kc * F; idx += kThreads) {
        const int n = idx / kc, kk = idx - n * kc;
        w_s[kk * WLD + n] = rnd<BF>(W[(size_t)n * K + k0 + kk]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float bv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) bv[c] = w_s[kk * WLD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const float a = rnd<BF>(arow[r * lda + k0 + kk]);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
      }
    }
  }
}

// part[k*F + n] (+)= sum_p A1[p*lda + k] * B1[p*(F+1) + n]
//                      + A2[p*lda + k] * B2[p*(F+1) + n]
// over the M slots of the tile, for k < krows, operands rounded with BF.
// Each element has one owning thread and each block its own part, so no
// two threads ever write one address. `init` (the block's first tile)
// overwrites instead of adding.
template <int F, bool BF>
__device__ void wgrad2(const float* __restrict__ A1,
                       const float* __restrict__ B1,
                       const float* __restrict__ A2,
                       const float* __restrict__ B2, int lda, int krows,
                       float* __restrict__ part, bool init) {
  constexpr int C = F / 32;
  constexpr int LD = F + 1;
  constexpr int QC = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  for (int q0 = 0; warp + kWarps * q0 < krows; q0 += QC) {
    float acc[QC][C];
#pragma unroll
    for (int q = 0; q < QC; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[q][c] = 0.0f;
    for (int p = 0; p < M; ++p) {
      float b1[C], b2[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        b1[c] = rnd<BF>(B1[p * LD + lane + 32 * c]);
        b2[c] = rnd<BF>(B2[p * LD + lane + 32 * c]);
      }
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int k = warp + kWarps * (q0 + q);
        const float a1 = k < krows ? rnd<BF>(A1[p * lda + k]) : 0.0f;
        const float a2 = k < krows ? rnd<BF>(A2[p * lda + k]) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[q][c] = fmaf(a2, b2[c], fmaf(a1, b1[c], acc[q][c]));
      }
    }
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const int k = warp + kWarps * (q0 + q);
      if (k < krows) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float* dst = part + (size_t)k * F + lane + 32 * c;
          *dst = init ? acc[q][c] : *dst + acc[q][c];
        }
      }
    }
  }
}

// Row-side inputs of the block's TI rows (zero past N): TI x F each.
__device__ void load_rows(const float* __restrict__ src, int b, int i0,
                          int N, int F, float* dst) {
  for (int idx = threadIdx.x; idx < TI * F; idx += kThreads) {
    const int il = idx / F, f = idx - il * F;
    dst[idx] = i0 + il < N ? src[((size_t)b * N + i0 + il) * F + f] : 0.0f;
  }
}

// Row-side Cartesian inputs (dq, dqdot) of the TI rows: 3 x TI x F.
__device__ void load_rows3(const float* __restrict__ src, int b, int i0,
                           int N, int F, float* dst) {
  for (int idx = threadIdx.x; idx < 3 * TI * F; idx += kThreads) {
    const int d = idx / (TI * F), rem = idx - d * (TI * F);
    const int il = rem / F, f = rem - il * F;
    dst[idx] = i0 + il < N
                   ? src[(((size_t)b * 3 + d) * N + i0 + il) * F + f] : 0.0f;
  }
}

// The tile's column-side inputs: np_j and, unless FIRST, npdot_j, force_j
// and forcedot_j; the per-slot adj, dir, dirdot, rbf and rbfdot. Slots
// outside the molecule read as zero, so they contribute nothing and stay
// finite (silu(0) = 0).
template <bool FIRST>
__device__ void load_tile(const float* __restrict__ np_,
                          const float* __restrict__ npdot,
                          const float* __restrict__ rbf,
                          const float* __restrict__ rbfdot,
                          const float* __restrict__ dir,
                          const float* __restrict__ dirdot,
                          const float* __restrict__ adj,
                          const float* __restrict__ force,
                          const float* __restrict__ forcedot, int b, int i0,
                          int j0, int N, int F, int R, float* npj_s,
                          float* npdotj_s, float* fj_s, float* fjdot_s,
                          float* adj_s, float* dir_s, float* dirdot_s,
                          float* rbf_s, float* rbfdot_s) {
  for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
    const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
    const size_t at = ((size_t)b * N + j) * F + f;
    npj_s[idx] = j < N ? np_[at] : 0.0f;
    if (!FIRST) npdotj_s[idx] = j < N ? npdot[at] : 0.0f;
  }
  if (!FIRST) {
    for (int idx = threadIdx.x; idx < 3 * TJ * F; idx += kThreads) {
      const int d = idx / (TJ * F), rem = idx - d * (TJ * F);
      const int jl = rem / F, f = rem - jl * F, j = j0 + jl;
      const size_t at = (((size_t)b * 3 + d) * N + j) * F + f;
      fj_s[idx] = j < N ? force[at] : 0.0f;
      fjdot_s[idx] = j < N ? forcedot[at] : 0.0f;
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
  for (int idx = threadIdx.x; idx < M * R; idx += kThreads) {
    const int p = idx / R, r = idx - p * R;
    const int i = i0 + p / TJ, j = j0 + p % TJ;
    const bool ok = i < N && j < N;
    const size_t at = (((size_t)b * N + i) * N + j) * R + r;
    rbf_s[idx] = ok ? rbf[at] : 0.0f;
    rbfdot_s[idx] = ok ? rbfdot[at] : 0.0f;
  }
}

// msg and msgdot of the warp's own slots into msg_s / msgdot_s (M x LD),
// from me (computed first, parked in msgdot_s) and medot. Uses `acc` as
// scratch. All threads of the block must call it.
template <int F, bool FIRST, bool BF>
__device__ void dual_messages(const float* rbf_s, const float* rbfdot_s,
                              int R, const float* __restrict__ We,
                              float* w_s, const float* npi_s,
                              const float* npdoti_s, const float* npj_s,
                              const float* npdotj_s, const float* adj_s,
                              float* msg_s, float* msgdot_s,
                              float (&acc)[TJ][F / 32]) {
  constexpr int C = F / 32;
  constexpr int LD = F + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  gemm_rows<F, false, BF>(rbf_s, R, R, We, w_s, acc);  // me
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      msg_s[p * LD + f] = acc[r][c] * npi_s[warp * F + f] * npj_s[r * F + f] * a;
      msgdot_s[p * LD + f] = acc[r][c];
    }
  }
  gemm_rows<F, false, BF>(rbfdot_s, R, R, We, w_s, acc);  // medot
#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int p = warp * TJ + r;
    const float a = adj_s[p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      const float ai = npi_s[warp * F + f], aj = npj_s[r * F + f];
      const float me = msgdot_s[p * LD + f];
      float v = acc[r][c] * ai * aj;
      if (!FIRST)
        v = v + me * npdoti_s[warp * F + f] * aj + me * ai * npdotj_s[r * F + f];
      msgdot_s[p * LD + f] = v * a;
    }
  }
}

// ------------------------------------------------------------------ K3 --
template <int F>
constexpr size_t fwd_smem_floats(int R) {
  return (size_t)4 * M * (F + 1) + (size_t)KC * (F + 1) + (size_t)2 * TI * F +
         (size_t)8 * TJ * F + (size_t)7 * M + (size_t)2 * M * R;
}

template <int F, bool FIRST, bool BF>
__global__ void __launch_bounds__(kThreads, 2)
dual_fwd_kernel(const float* __restrict__ np_, const float* __restrict__ npdot,
                const float* __restrict__ rbf,
                const float* __restrict__ rbfdot,
                const float* __restrict__ dir,
                const float* __restrict__ dirdot,
                const float* __restrict__ adj, const float* __restrict__ force,
                const float* __restrict__ forcedot,
                const float* __restrict__ We, const float* __restrict__ W1a,
                const float* __restrict__ W1b, const float* __restrict__ W2a,
                const float* __restrict__ W2b, float* __restrict__ inv1,
                float* __restrict__ eq, float* __restrict__ inv1dot,
                float* __restrict__ eqdot, int N, int R, int n_itiles) {
  constexpr int C = F / 32;
  constexpr int LD = F + 1;
  extern __shared__ float smem[];
  float* msg_s = smem;                 // M x LD
  float* msgdot_s = msg_s + M * LD;    // M x LD
  float* h_s = msgdot_s + M * LD;      // M x LD
  float* hdot_s = h_s + M * LD;        // M x LD
  float* w_s = hdot_s + M * LD;        // KC x LD
  float* npi_s = w_s + KC * LD;        // TI x F
  float* npdoti_s = npi_s + TI * F;    // TI x F
  float* npj_s = npdoti_s + TI * F;    // TJ x F
  float* npdotj_s = npj_s + TJ * F;    // TJ x F
  float* fj_s = npdotj_s + TJ * F;     // 3 x TJ x F
  float* fjdot_s = fj_s + 3 * TJ * F;  // 3 x TJ x F
  float* adj_s = fjdot_s + 3 * TJ * F; // M
  float* dir_s = adj_s + M;            // 3 x M
  float* dirdot_s = dir_s + 3 * M;     // 3 x M
  float* rbf_s = dirdot_s + 3 * M;     // M x R
  float* rbfdot_s = rbf_s + M * R;     // M x R

  const int b = blockIdx.x / n_itiles;
  const int i0 = (blockIdx.x - b * n_itiles) * TI;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  load_rows(np_, b, i0, N, F, npi_s);
  if (!FIRST) load_rows(npdot, b, i0, N, F, npdoti_s);

  float inv_acc[C], invdot_acc[C], eq_acc[3][C], eqdot_acc[3][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    inv_acc[c] = invdot_acc[c] = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) eq_acc[d][c] = eqdot_acc[d][c] = 0.0f;
  }
  float acc[TJ][C];

  for (int j0 = 0; j0 < N; j0 += TJ) {
    __syncthreads();
    load_tile<FIRST>(np_, npdot, rbf, rbfdot, dir, dirdot, adj, force,
                     forcedot, b, i0, j0, N, F, R, npj_s, npdotj_s, fj_s,
                     fjdot_s, adj_s, dir_s, dirdot_s, rbf_s, rbfdot_s);
    dual_messages<F, FIRST, BF>(rbf_s, rbfdot_s, R, We, w_s, npi_s, npdoti_s,
                                npj_s, npdotj_s, adj_s, msg_s, msgdot_s, acc);
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o = (warp * TJ + r) * LD + lane + 32 * c;
        inv_acc[c] += msg_s[o];
        invdot_acc[c] += msgdot_s[o];
      }

#pragma unroll
    for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
      const float* Wa = br == 0 ? W1a : W2a;
      const float* Wb = br == 0 ? W1b : W2b;
      gemm_rows<F, false, BF>(msg_s, LD, F, Wa, w_s, acc);  // p
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          h_s[o] = silu_f(acc[r][c]);
          hdot_s[o] = dsilu_f(acc[r][c]);
        }
      gemm_rows<F, false, BF>(msgdot_s, LD, F, Wa, w_s, acc);  // pdot
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          hdot_s[o] = hdot_s[o] * acc[r][c];
        }
      // phi: eq += phi * x, eqdot += phi * xdot, where (x, xdot) is
      // (dir, dirdot) in branch 1 and (force_j, forcedot_j) in branch 2
      gemm_rows<F, false, BF>(h_s, LD, F, Wb, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r;
        const float a = adj_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const float phi = acc[r][c] * a;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float x = br == 0 ? dir_s[d * M + p] : fj_s[(d * TJ + r) * F + f];
            const float xdot =
                br == 0 ? dirdot_s[d * M + p] : fjdot_s[(d * TJ + r) * F + f];
            eq_acc[d][c] += phi * x;
            eqdot_acc[d][c] += phi * xdot;
          }
        }
      }
      // phidot: eqdot += phidot * x
      gemm_rows<F, false, BF>(hdot_s, LD, F, Wb, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r) {
        const int p = warp * TJ + r;
        const float a = adj_s[p];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int f = lane + 32 * c;
          const float phidot = acc[r][c] * a;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float x = br == 0 ? dir_s[d * M + p] : fj_s[(d * TJ + r) * F + f];
            eqdot_acc[d][c] += phidot * x;
          }
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
      inv1dot[((size_t)b * N + i) * F + f] = invdot_acc[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        eq[(((size_t)b * 3 + d) * N + i) * F + f] = eq_acc[d][c];
        eqdot[(((size_t)b * 3 + d) * N + i) * F + f] = eqdot_acc[d][c];
      }
    }
  }
}

// ------------------------------------------------------------------ K4 --
template <int F>
constexpr size_t bwd_smem_floats(int R) {
  return (size_t)8 * M * (F + 1) + (size_t)KC * (F + 1) + (size_t)4 * TI * F +
         (size_t)6 * TI * F + (size_t)8 * TJ * F + (size_t)7 * M +
         (size_t)2 * M * R;
}

// Offsets of the five weight cotangents inside one block's partial slot
// (and inside the reduced output): We, W1a, W1b, W2a, W2b.
__host__ __device__ inline size_t wgrad_size(int F, int R) {
  return (size_t)R * F + (size_t)4 * F * F;
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
                const float* __restrict__ We, const float* __restrict__ W1a,
                const float* __restrict__ W1b, const float* __restrict__ W2a,
                const float* __restrict__ W2b, const float* __restrict__ di,
                const float* __restrict__ dq, const float* __restrict__ didot,
                const float* __restrict__ dqdot, float* __restrict__ dnp,
                float* __restrict__ dnpdot, float* __restrict__ col,
                float* __restrict__ wpart, int N, int R, int n_itiles) {
  constexpr int C = F / 32;
  constexpr int LD = F + 1;
  extern __shared__ float smem[];
  float* msg_s = smem;                 // M x LD: msg
  float* msgdot_s = msg_s + M * LD;    // M x LD: msgdot
  float* p_s = msgdot_s + M * LD;      // M x LD: p; tail: me, then t me
  float* pdot_s = p_s + M * LD;        // M x LD: pdot, then s'' pdot dhdot
  float* h_s = pdot_s + M * LD;        // M x LD: h; tail: tdot me
  float* hdot_s = h_s + M * LD;        // M x LD: hdot; tail: dme
  float* g_s = hdot_s + M * LD;        // M x LD: phi2, g, dp; tail: dmedot
  float* gdot_s = g_s + M * LD;        // M x LD: phi2dot, gdot, dpdot
  float* w_s = gdot_s + M * LD;        // KC x LD
  float* npi_s = w_s + KC * LD;        // TI x F
  float* npdoti_s = npi_s + TI * F;    // TI x F
  float* di_s = npdoti_s + TI * F;     // TI x F
  float* didot_s = di_s + TI * F;      // TI x F
  float* dq_s = didot_s + TI * F;      // 3 x TI x F
  float* dqdot_s = dq_s + 3 * TI * F;  // 3 x TI x F
  float* npj_s = dqdot_s + 3 * TI * F; // TJ x F
  float* npdotj_s = npj_s + TJ * F;    // TJ x F
  float* fj_s = npdotj_s + TJ * F;     // 3 x TJ x F
  float* fjdot_s = fj_s + 3 * TJ * F;  // 3 x TJ x F
  float* adj_s = fjdot_s + 3 * TJ * F; // M
  float* dir_s = adj_s + M;            // 3 x M
  float* dirdot_s = dir_s + 3 * M;     // 3 x M
  float* rbf_s = dirdot_s + 3 * M;     // M x R
  float* rbfdot_s = rbf_s + M * R;     // M x R

  const int b = blockIdx.x / n_itiles;
  const int it = blockIdx.x - b * n_itiles;
  const int i0 = it * TI;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = i0 + warp;

  load_rows(np_, b, i0, N, F, npi_s);
  if (!FIRST) load_rows(npdot, b, i0, N, F, npdoti_s);
  load_rows(di, b, i0, N, F, di_s);
  load_rows(didot, b, i0, N, F, didot_s);
  load_rows3(dq, b, i0, N, F, dq_s);
  load_rows3(dqdot, b, i0, N, F, dqdot_s);

  float* wp = wpart + (size_t)blockIdx.x * wgrad_size(F, R);
  float* colb = col + ((size_t)b * n_itiles + it) * kColSlots * N * F;
  float dnp_acc[C], dnpdot_acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dnp_acc[c] = dnpdot_acc[c] = 0.0f;
  float acc[TJ][C], dmsg[TJ][C], dmsgdot[TJ][C];

  for (int j0 = 0; j0 < N; j0 += TJ) {
    const bool init = j0 == 0;
    __syncthreads();
    load_tile<FIRST>(np_, npdot, rbf, rbfdot, dir, dirdot, adj, force,
                     forcedot, b, i0, j0, N, F, R, npj_s, npdotj_s, fj_s,
                     fjdot_s, adj_s, dir_s, dirdot_s, rbf_s, rbfdot_s);
    dual_messages<F, FIRST, BF>(rbf_s, rbfdot_s, R, We, w_s, npi_s, npdoti_s,
                                npj_s, npdotj_s, adj_s, msg_s, msgdot_s, acc);

#pragma unroll
    for (int br = 0; br < (FIRST ? 1 : 2); ++br) {
      const float* Wa = br == 0 ? W1a : W2a;
      const float* Wb = br == 0 ? W1b : W2b;
      float* wpa = wp + (size_t)R * F + (size_t)(2 * br) * F * F;
      float* wpb = wpa + (size_t)F * F;
      gemm_rows<F, false, BF>(msg_s, LD, F, Wa, w_s, acc);  // p
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          p_s[o] = acc[r][c];
          h_s[o] = silu_f(acc[r][c]);
        }
      gemm_rows<F, false, BF>(msgdot_s, LD, F, Wa, w_s, acc);  // pdot
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          pdot_s[o] = acc[r][c];
          hdot_s[o] = dsilu_f(p_s[o]) * acc[r][c];
        }
      if (br == 1) {
        // phi2, phi2dot for the column sums over i:
        // dforce[d,j] = sum_i phi2 dq[d,i] + phi2dot dqdot[d,i],
        // dforcedot[d,j] = sum_i phi2 dqdot[d,i]
        gemm_rows<F, false, BF>(h_s, LD, F, Wb, w_s, acc);
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            g_s[(warp * TJ + r) * LD + lane + 32 * c] =
                acc[r][c] * adj_s[warp * TJ + r];
        gemm_rows<F, false, BF>(hdot_s, LD, F, Wb, w_s, acc);
#pragma unroll
        for (int r = 0; r < TJ; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            gdot_s[(warp * TJ + r) * LD + lane + 32 * c] =
                acc[r][c] * adj_s[warp * TJ + r];
        __syncthreads();
        for (int idx = threadIdx.x; idx < TJ * F; idx += kThreads) {
          const int jl = idx / F, f = idx - jl * F, j = j0 + jl;
          if (j >= N) continue;
          float sf[3] = {0.0f, 0.0f, 0.0f}, sfd[3] = {0.0f, 0.0f, 0.0f};
          for (int il = 0; il < TI; ++il) {
            const float phi = g_s[(il * TJ + jl) * LD + f];
            const float phid = gdot_s[(il * TJ + jl) * LD + f];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float q = dq_s[(d * TI + il) * F + f];
              const float qd = dqdot_s[(d * TI + il) * F + f];
              sf[d] += phi * q + phid * qd;
              sfd[d] += phi * qd;
            }
          }
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            colb[((size_t)(2 + d) * N + j) * F + f] = sf[d];
            colb[((size_t)(5 + d) * N + j) * F + f] = sfd[d];
          }
        }
        __syncthreads();
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
            const float q = dq_s[(d * TI + warp) * F + f];
            const float qd = dqdot_s[(d * TI + warp) * F + f];
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
      wgrad2<F, BF>(h_s, g_s, hdot_s, gdot_s, LD, F, wpb, init);  // dWb
      gemm_rows<F, true, BF>(gdot_s, LD, F, Wb, w_s, acc);       // dhdot
      __syncwarp();  // the warp's lanes have read gdot before it is replaced
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          const float pv = p_s[o];
          pdot_s[o] = d2silu_f(pv) * pdot_s[o] * acc[r][c];
          gdot_s[o] = dsilu_f(pv) * acc[r][c];  // dpdot
        }
      gemm_rows<F, true, BF>(g_s, LD, F, Wb, w_s, acc);  // dh
      __syncwarp();  // as above, for g
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = (warp * TJ + r) * LD + lane + 32 * c;
          g_s[o] = dsilu_f(p_s[o]) * acc[r][c] + pdot_s[o];  // dp
        }
      wgrad2<F, BF>(msg_s, g_s, msgdot_s, gdot_s, LD, F, wpa, init);  // dWa
      gemm_rows<F, true, BF>(g_s, LD, F, Wa, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          dmsg[r][c] = br == 0 ? acc[r][c] : dmsg[r][c] + acc[r][c];
      gemm_rows<F, true, BF>(gdot_s, LD, F, Wa, w_s, acc);
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c)
          dmsgdot[r][c] = br == 0 ? acc[r][c] : dmsgdot[r][c] + acc[r][c];
    }

    // ---- t = (dmsg + di_i) adj, tdot = (dmsgdot + didot_i) adj; dnp,
    // dnpdot, dme, dmedot, dWe. me and medot are recomputed.
    gemm_rows<F, false, BF>(rbf_s, R, R, We, w_s, acc);  // me
#pragma unroll
    for (int r = 0; r < TJ; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        p_s[(warp * TJ + r) * LD + lane + 32 * c] = acc[r][c];
    gemm_rows<F, false, BF>(rbfdot_s, R, R, We, w_s, acc);  // medot
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
        const float me = p_s[o], medot = acc[r][c];
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
      colb[((size_t)N + j) * F + f] = sd;
    }
    wgrad2<F, BF>(rbf_s, hdot_s, rbfdot_s, g_s, R, R, wp, init);  // dWe
  }

  if (i < N) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int f = lane + 32 * c;
      dnp[((size_t)b * N + i) * F + f] = dnp_acc[c];
      dnpdot[((size_t)b * N + i) * F + f] = dnpdot_acc[c];
    }
  }
}

// dnp += sum_it col[.,it,0]; dnpdot += sum_it col[.,it,1]; dforce[d] =
// sum_it col[.,it,2+d]; dforcedot[d] = sum_it col[.,it,5+d]. The first
// layer's dnpdot, dforce and dforcedot are zero. Fixed summation order.
__global__ void dual_bwd_colsum_kernel(float* __restrict__ dnp,
                                       float* __restrict__ dnpdot,
                                       float* __restrict__ dforce,
                                       float* __restrict__ dforcedot,
                                       const float* __restrict__ col, int B,
                                       int N, int F, int n_itiles, int first) {
  const size_t nf = (size_t)N * F;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nf) return;
  const size_t b = idx / nf, rem = idx - b * nf;
  float s[kColSlots];
  for (int k = 0; k < kColSlots; ++k) s[k] = 0.0f;
  for (int it = 0; it < n_itiles; ++it) {
    const float* c = col + (b * n_itiles + it) * kColSlots * nf + rem;
    s[0] += c[0];
    if (!first)
      for (int k = 1; k < kColSlots; ++k) s[k] += c[k * nf];
  }
  dnp[idx] += s[0];
  dnpdot[idx] = first ? 0.0f : dnpdot[idx] + s[1];
  for (int d = 0; d < 3; ++d) {
    dforce[(b * 3 + d) * nf + rem] = s[2 + d];
    dforcedot[(b * 3 + d) * nf + rem] = s[5 + d];
  }
}

// out[e] = sum_blk part[blk, e] for e < n_valid; 0 for the rest (the
// first layer's W2a/W2b). Fixed summation order.
__global__ void dual_bwd_wsum_kernel(float* __restrict__ out,
                                     const float* __restrict__ part,
                                     int n_blocks, size_t n, size_t n_valid) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  if (e < n_valid)
    for (int k = 0; k < n_blocks; ++k) s += part[(size_t)k * n + e];
  out[e] = s;
}

template <int F, bool FIRST, bool BF>
cudaError_t launch_fwd(const float* const* in, float* const* out, int B,
                       int N, int R, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<F>(R) * sizeof(float);
  auto kern = dual_fwd_kernel<F, FIRST, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (N + TI - 1) / TI;
  kern<<<B * n_itiles, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], in[13], out[0], out[1], out[2], out[3], N, R,
      n_itiles);
  return cudaGetLastError();
}

// in: the 14 inputs of K3 then di, dq, didot, dqdot; out: dnp, dnpdot,
// dforce, dforcedot, col, wpart, dw.
template <int F, bool FIRST, bool BF>
cudaError_t launch_bwd(const float* const* in, float* const* out, int B,
                       int N, int R, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<F>(R) * sizeof(float);
  auto kern = dual_bwd_kernel<F, FIRST, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_itiles = (N + TI - 1) / TI;
  const int n_blocks = B * n_itiles;
  kern<<<n_blocks, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], in[13], in[14], in[15], in[16], in[17], out[0],
      out[1], out[4], out[5], N, R, n_itiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * N * F;
  dual_bwd_colsum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      out[0], out[1], out[2], out[3], out[4], B, N, F, n_itiles, FIRST ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = wgrad_size(F, R);
  const size_t n_valid = FIRST ? (size_t)R * F + 2 * (size_t)F * F : n;
  dual_bwd_wsum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      out[6], out[5], n_blocks, n, n_valid);
  return cudaGetLastError();
}

typedef cudaError_t (*launch_fn)(const float* const*, float* const*, int, int,
                                 int, cudaStream_t);

// The instantiation for (F, first, bf16), or nullptr for an F the kernels
// are not built for.
template <template <int, bool, bool> class L>
launch_fn pick(int F, bool first, bool bf) {
#define NN_PICK(FF)                                                  \
  return first ? (bf ? L<FF, true, true>::fn : L<FF, true, false>::fn) \
               : (bf ? L<FF, false, true>::fn : L<FF, false, false>::fn)
  switch (F) {
    case 32: NN_PICK(32);
    case 64: NN_PICK(64);
    case 128: NN_PICK(128);
    default: return nullptr;
  }
#undef NN_PICK
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
// -> inv1, inv1dot (B,N,F); eq, eqdot (B,3,N,F). All fp32, contiguous, on
// the device of `stream`. F must be 32, 64 or 128; bf16 != 0 rounds the
// product operands to bf16.
int nn_dual_fwd(const float* np_, const float* npdot, const float* rbf,
                const float* rbfdot, const float* dir, const float* dirdot,
                const float* adj, const float* force, const float* forcedot,
                const float* We, const float* W1a, const float* W1b,
                const float* W2a, const float* W2b, float* inv1, float* eq,
                float* inv1dot, float* eqdot, int B, int N, int F, int R,
                int first_layer, int bf16, void* stream) {
  const launch_fn fn = pick<FwdLaunch>(F, first_layer != 0, bf16 != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* in[14] = {np_, npdot, rbf, rbfdot, dir, dirdot, adj,
                         force, forcedot, We, W1a, W1b, W2a, W2b};
  float* out[4] = {inv1, eq, inv1dot, eqdot};
  return (int)fn(in, out, B, N, R, static_cast<cudaStream_t>(stream));
}

// K4. Inputs of K3 plus di, didot (B,N,F) and dq, dqdot (B,3,N,F).
// Outputs dnp, dnpdot (B,N,F), dforce, dforcedot (B,3,N,F) and dw
// (R*F+4F^2: dWe, dW1a, dW1b, dW2a, dW2b one after the other). Scratch col
// (B, ceil(N/8), 8, N, F) and wpart (B*ceil(N/8), R*F+4F^2).
int nn_dual_bwd(const float* np_, const float* npdot, const float* rbf,
                const float* rbfdot, const float* dir, const float* dirdot,
                const float* adj, const float* force, const float* forcedot,
                const float* We, const float* W1a, const float* W1b,
                const float* W2a, const float* W2b, const float* di,
                const float* dq, const float* didot, const float* dqdot,
                float* dnp, float* dnpdot, float* dforce, float* dforcedot,
                float* col, float* wpart, float* dw, int B, int N, int F,
                int R, int first_layer, int bf16, void* stream) {
  const launch_fn fn = pick<BwdLaunch>(F, first_layer != 0, bf16 != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* in[18] = {np_, npdot, rbf, rbfdot, dir, dirdot,
                         adj, force, forcedot, We, W1a, W1b,
                         W2a, W2b, di, dq, didot, dqdot};
  float* out[7] = {dnp, dnpdot, dforce, dforcedot, col, wpart, dw};
  return (int)fn(in, out, B, N, R, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block of K3 (kind 0) or K4 (kind 1), in
// bytes; 0 for an F the kernels are not built for.
size_t nn_dual_smem_bytes(int F, int R, int kind) {
#define NN_SMEM(FF) \
  return (kind ? bwd_smem_floats<FF>(R) : fwd_smem_floats<FF>(R)) * sizeof(float)
  switch (F) {
    case 32: NN_SMEM(32);
    case 64: NN_SMEM(64);
    case 128: NN_SMEM(128);
    default: return 0;
  }
#undef NN_SMEM
}

}  // extern "C"
