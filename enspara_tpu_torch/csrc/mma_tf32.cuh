// Warp-level tensor-core pieces for Hopper (sm_90a) in inline PTX: the
// 3xTF32 split of an fp32 operand, the m16n8k8 TF32 product, and the
// cp.async copies that stage operands in shared memory.
//
// 3xTF32: x = hi + lo with hi = rna_tf32(x) (the top 11 significant
// bits, rounded to nearest, ties away from zero) and lo = rna_tf32(x -
// hi) (the next 11; x - hi is exact in fp32). A product x * y is then
// taken as lo_x*hi_y + hi_x*lo_y + hi_x*hi_y, three tensor-core passes
// accumulating in fp32 in that order; the dropped lo_x*lo_y and the
// split leave a relative error of about 2^-21 per product, against 2^-24
// of an fp32 FMA. One TF32 pass alone keeps about 2^-11, which is not
// enough for QCP (docs/performance.md:42: one bf16 pass was off by
// 8.6e-2).
//
// Fragment layout of mma.m16n8k8 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                     a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C, D (16 x 8):    c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                     c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>

// cvt.rna.tf32.f32 in integer arithmetic (the same bits for finite x):
// half an ulp of the 11-bit significand added to the magnitude, then the
// low 13 bits cleared. Measured faster than the cvt instruction inside
// the QCP kernel on an H100 (chip_ablate_qcp.py, PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo) TF32 operands
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b, one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, bypassing L1; zeros instead when `read` is
// false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool read = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(read ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
