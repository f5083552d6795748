// What the fused kernels of the BatchNorm-folded forward share: ReLU6 and
// the dynamic shared memory. The stem kernel (fused_stem.cu) and the block
// kernels (fused_block.cu in float32, fused_block_bf16.cu in bf16) each
// carve that memory for their own staging.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace myt_fused {

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 myt_smem[];
  return reinterpret_cast<float*>(myt_smem);
}

}  // namespace myt_fused
