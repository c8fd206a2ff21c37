// Row gather for Hopper (sm_90a): out[b, r, :] = x[b, idx[b, r], :].
//
// Replaces the TPU kernel newtonnet_tpu/ops/pallas_gather.py:_kernel (K9),
// the neighbour gather of the inverse-list layout (inv_gather) and of each
// chunk of its transpose (inv_scatter_sum), and its 2-D form
// tools/exp_pallas_gather.py:_kernel (K12), which is the same function at
// B = 1: both are this one kernel.
//
// x is (B, N, row_bytes) with rows contiguous and a batch stride of
// x_bstride rows (so a slot chunk of a (B, K, N, F) tensor gathers as a
// view, without a copy); idx (B, R) int32 or int64, contiguous; out
// (B, R, row_bytes) contiguous. The rows are moved as bytes, so any dtype
// and any width work: 16-byte vectors where the row length and the
// pointers allow it, else 4-, 2- or 1-byte words. An index outside [0, N)
// gives a zero row (the kernel never reads outside x).
//
// What bounds it on this card: bytes. It does no arithmetic; it writes
// B*R rows and reads as many, from a source that is small next to the
// output (at the box shape a 4 MB source, 369 MB written), so the source
// stays in the 50 MB L2 and the floor is the output's write plus the
// indices over 3.35 TB/s.
//
// Design: one thread per output vector, consecutive threads on consecutive
// vectors of a row, then of the next row, so both the stores and the loads
// of a row are coalesced for any width; a grid-stride loop over at most
// kMaxBlocks blocks; 32-bit index arithmetic (the host refuses more than
// 2^31 vectors), 64-bit addresses. The TPU kernel's VMEM budget, width
// floor and opt-in have no counterpart: any F and any R are taken.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <class V, class I>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ x, const I* __restrict__ idx,
                      V* __restrict__ out, unsigned n_vec, unsigned vpr,
                      unsigned R, long long N, long long x_bstride) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += gridDim.x * blockDim.x) {
    const unsigned row = v / vpr;  // b * R + r
    const unsigned c = v - row * vpr;
    const long long b = row / R;
    const long long src = (long long)idx[row];
    V val{};
    if (src >= 0 && src < N) val = x[(b * x_bstride + src) * vpr + c];
    out[v] = val;
  }
}

template <class V, class I>
cudaError_t launch(const void* x, const void* idx, void* out, int B, int N,
                   int R, int row_bytes, long long x_bstride,
                   cudaStream_t stream) {
  const unsigned vpr = (unsigned)(row_bytes / sizeof(V));
  const unsigned long long n_vec = (unsigned long long)B * R * vpr;
  if (n_vec >= (1ull << 31)) return cudaErrorInvalidValue;
  const unsigned long long want = (n_vec + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(want < kMaxBlocks ? (want ? want : 1) : kMaxBlocks);
  row_gather_kernel<V, I><<<blocks, kThreads, 0, stream>>>(
      (const V*)x, (const I*)idx, (V*)out, (unsigned)n_vec, vpr,
      (unsigned)R, (long long)N, x_bstride);
  return cudaGetLastError();
}

template <class I>
cudaError_t dispatch(const void* x, const void* idx, void* out, int B, int N,
                     int R, int row_bytes, long long x_bstride,
                     cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4, I>(x, idx, out, B, N, R, row_bytes, x_bstride,
                            stream);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<unsigned, I>(x, idx, out, B, N, R, row_bytes, x_bstride,
                               stream);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch<unsigned short, I>(x, idx, out, B, N, R, row_bytes,
                                     x_bstride, stream);
  return launch<unsigned char, I>(x, idx, out, B, N, R, row_bytes, x_bstride,
                                  stream);
}

}  // namespace

extern "C" {

// K9 / K12. x (B, N, row_bytes) with a batch stride of x_bstride rows; idx
// (B, R) int64 when idx64 != 0, else int32; out (B, R, row_bytes). Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an empty or
// too large problem).
int nn_row_gather(const void* x, const void* idx, void* out, int B, int N,
                  int R, int row_bytes, long long x_bstride, int idx64,
                  void* stream) {
  if (B <= 0 || N <= 0 || R <= 0 || row_bytes <= 0 || x_bstride < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(idx64 ? dispatch<long long>(x, idx, out, B, N, R, row_bytes,
                                           x_bstride, s)
                     : dispatch<int>(x, idx, out, B, N, R, row_bytes,
                                     x_bstride, s));
}

}  // extern "C"
