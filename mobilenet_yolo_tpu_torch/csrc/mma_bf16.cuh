// Warp-level bf16 tensor-core primitives for sm_90a as inline PTX:
// cp.async (16 bytes, zero-filled past the source bytes), ldmatrix and
// mma.sync m16n8k16 with float32 accumulators.
//
// The fragment maps (which shared-memory row and column each lane addresses
// for ldmatrix, which output element each accumulator register holds) are
// plain __host__ __device__ functions, so a host build can check the index
// math; only the asm statements need the card.

#ifndef MYT_MMA_BF16_CUH
#define MYT_MMA_BF16_CUH

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace myt_mma {

// ldmatrix .x4 over a 16x16 tile of a row-major array: lane l gives the
// address of row (l % 16), column 8 * (l / 16). Without .trans that loads
// an mma A fragment (16 rows x 16 k); with .trans over a [k][n] array it
// loads the B fragments of two n8 tiles (registers 0-1: columns 0-7,
// registers 2-3: columns 8-15). .x2 .trans reads lanes 0-15 only.
__host__ __device__ constexpr int ldsm_row(int lane) { return lane & 15; }
__host__ __device__ constexpr int ldsm_col(int lane) { return (lane >> 4) << 3; }

// A register i (0-3) of an m16n8k16 bf16 tile in lane l (PTX ISA, "Matrix
// Fragments for mma.m16n8k16"): row l / 4 (+ 8 for registers 1 and 3),
// columns c and c + 1 (c in the low half) with c = 2 * (l % 4) (+ 8 for
// registers 2 and 3). ldmatrix .x4 over a row-major tile loads exactly
// this; the maps are for fragments gathered element by element.
__host__ __device__ constexpr int bf16_a_row(int lane, int i) { return (lane >> 2) + ((i & 1) << 3); }
__host__ __device__ constexpr int bf16_a_col(int lane, int i) { return ((lane & 3) << 1) + ((i >> 1) << 3); }

// accumulator register i (0-3) of an m16n8 tile in lane l: row l / 4
// (+ 8 for registers 2 and 3), column 2 * (l % 4) + i % 2
__host__ __device__ constexpr int acc_row(int lane, int i) { return (lane >> 2) + ((i >> 1) << 3); }
__host__ __device__ constexpr int acc_col(int lane, int i) { return ((lane & 3) << 1) + (i & 1); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes is 16 or 0 (zero fill)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a * b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace myt_mma

#endif  // MYT_MMA_BF16_CUH
