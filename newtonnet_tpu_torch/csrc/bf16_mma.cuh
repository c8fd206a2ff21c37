// bf16 tensor-core products, shared by csrc/fused_dual.cu (K3/K4),
// csrc/fused_dense.cu (K1/K2) and csrc/fused_klist.cu (K5/K6): the
// mma.sync m16n8k16 bf16 wrapper with fp32 accumulation and the packing of
// its operand fragments. A fragment register holds two bf16 values of
// consecutive depth (k, k + 1), the lower in the low half, each rounded
// from fp32 to nearest even (cvt.rn.bf16x2.f32): a product of two bf16
// values is exact in fp32, so the mma's only rounding is that of its fp32
// sums. csrc/emu/cuda_emu.h replaces mma_bf16 on the CPU (the PTX
// fragment layout) and provides the bf16 conversions.
#pragma once

#ifndef NN_CUDA_EMU
#include <cuda_bf16.h>
#endif

namespace {

#ifndef NN_CUDA_EMU
// d += a b for the warp's 16 x 8 tile of a 16 x 16 (bf16) by 16 x 8
// (bf16) product, fp32 accumulators (the PTX ISA's fragment layouts).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// (lo, hi) rounded to bf16 (nearest even) and packed, lo in the low half:
// one register of an mma bf16 fragment.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (unsigned)__bfloat16_as_ushort(v.x) |
         ((unsigned)__bfloat16_as_ushort(v.y) << 16);
}

// The fragment register of p[0], p[1] (fp32, 8-byte aligned), as one
// 8-byte load.
__device__ __forceinline__ unsigned pack_bf16_at(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// x rounded to bf16 (nearest even), in its 16 bits: an element of a
// prepared bf16 weight.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

}  // namespace
