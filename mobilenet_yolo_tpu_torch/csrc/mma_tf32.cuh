// Warp-level TF32 tensor-core primitives for sm_90a, with the
// error-compensated three-pass split that gives float32 products float32's
// accuracy: mma.sync m16n8k8 (tf32 in, float32 sums) and cvt.rna.tf32.f32's
// rounding.
// The cp.async and ldmatrix wrappers are mma_bf16.cuh's: ldmatrix moves
// 16-byte rows whatever they hold, and .x4 over a 16x8 float32 tile gives
// exactly the tf32 A fragment (below).
//
// The fragment maps are plain __host__ __device__ functions, so a host
// build can check the index math; only the asm statements need the card.

#ifndef MYT_MMA_TF32_CUH
#define MYT_MMA_TF32_CUH

#include <cstdint>

#include "mma_bf16.cuh"

namespace myt_mma {

// m16n8k8 .tf32 fragments of lane l (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), g = l / 4, t = l % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      acc_row / acc_col of mma_bf16.cuh (the same layout)
__host__ __device__ constexpr int tf32_a_row(int lane, int i) { return (lane >> 2) + ((i & 1) << 3); }
__host__ __device__ constexpr int tf32_a_col(int lane, int i) { return (lane & 3) + ((i >> 1) << 2); }
__host__ __device__ constexpr int tf32_b_k(int lane, int i) { return (lane & 3) + (i << 2); }
__host__ __device__ constexpr int tf32_b_n(int lane) { return lane >> 2; }

// ldmatrix .x4 over a 16x8 float32 tile of a row-major array (rows of 16
// bytes per 8x8-b16 matrix): lane l gives the address of row l % 16, float
// column 4 * (l / 16); register i then holds A element (tf32_a_row(l, i),
// tf32_a_col(l, i)). The byte offsets are those of ldsm_row / ldsm_col.
__host__ __device__ constexpr int ldsm_f32_row(int lane) { return lane & 15; }
__host__ __device__ constexpr int ldsm_f32_col(int lane) { return (lane >> 4) << 2; }

// cvt.rna.tf32.f32's rounding: to nearest, ties away from zero, at tf32's
// 10 mantissa bits; the 13 low bits of the result are zero, so it is also
// an exact float32. Adding half a unit of the dropped bits to the bit
// pattern and clearing them rounds the magnitude and leaves the sign: the
// same result for every finite input and the infinities (a NaN may come
// out infinite; its lo below is then NaN). Two integer operations at full
// rate, where sm_90 converts 16 values a clock per SM: on an H100 the
// float32 blocks took 10.58 ms per b128 predict with cvt.rna and 9.46 ms
// with this (PERF.md).
__host__ __device__ __forceinline__ uint32_t tf32_round_bits(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + (v's bits below tf32's 21): hi = tf32(v), lo = tf32(v - hi)
// (v - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round_bits(__float_as_uint(v));
  lo = tf32_round_bits(__float_as_uint(v - __uint_as_float(hi)));
}

// d += a * b: a 16x8 (row), b 8x8 (col), tf32; d 16x8 float32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in three TF32 passes, the small products first: a_lo b_hi,
// a_hi b_lo, a_hi b_hi (a_lo b_lo is below float32's rounding), summed in
// a fresh accumulator that is then added to d by float32 adds (round to
// nearest). The tensor cores' own additions do not round to nearest: a
// chain of 360 mma into one sum (K = 960) drifted 7.6e-6 of the largest
// output from float64 on an H100, against 2.7e-7 for float32 FMAs; one
// rounded add per k-step keeps the chain at float32's error.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(t, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(t, a_hi, b_hi[0], b_hi[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

}  // namespace myt_mma

#endif  // MYT_MMA_TF32_CUH
