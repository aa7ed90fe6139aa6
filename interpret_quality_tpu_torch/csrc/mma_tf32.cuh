// The tensor-core product at each matmul precision, shared by the kernels
// that multiply on the tensor cores (groups.cu: iq_ball_mlp3 and
// iq_pointconv_sa; dense.cu: iq_dense_pool; knn_group.cu:
// iq_knn_group_max; group_mlp.cu: iq_group_res_mlp).
//
// The instruction is mma.sync.m16n8k8 (row.col, tf32 in, f32 out).  At
// kPrecHighest f32 accuracy is kept by a three-product split: every f32
// operand is x = hi + lo (hi: the low 13 mantissa bits cleared, lo: x - hi
// rounded to TF32) and a product is lo*w_hi + hi*w_lo + hi*w_hi, accumulated
// in f32; only lo*w_lo (2^-22 relative) is dropped.  At kPrecHigh one
// product of operands rounded to TF32, at kPrecDefault one product of
// operands rounded to bf16 (exact in TF32: one bf16 pass).
// ops/cuda/emulation.py repeats each in plain PyTorch.
#pragma once

#include <cuda_runtime.h>

namespace {

// The matmul precisions (ops/cuda/launch.py PRECISION_CODES).
constexpr int kPrecHighest = 0;             // three TF32 products: f32 accuracy
constexpr int kPrecHigh = 1;                // one product of TF32-rounded operands
constexpr int kPrecDefault = 2;             // one product of bf16-rounded operands

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// x - hi (exact) rounded to TF32, to nearest with ties away from zero as
// cvt.rna.tf32.f32 rounds it, in two integer operations (the cvt is the
// slower: 7% of the whole kernel on an H100)
__device__ __forceinline__ float tf32_lo(float x, float hi) {
  return __uint_as_float((__float_as_uint(__fsub_rn(x, hi)) + 0x1000u) & 0xffffe000u);
}
// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
// x rounded to bf16, to nearest even, as an f32 (torch's and XLA's rounding)
__device__ __forceinline__ float bf16_rne(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}
// an operand of a one-pass product at precision prec (kPrecHighest: x)
__host__ __device__ __forceinline__ constexpr bool one_pass(int prec) {
  return prec != kPrecHighest;
}
__device__ __forceinline__ float round_operand(int prec, float x) {
  return prec == kPrecHigh ? tf32_rna(x) : prec == kPrecDefault ? bf16_rne(x) : x;
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

}  // namespace
