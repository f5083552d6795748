// Per-slot pixel augmentation for Hopper (sm_90a): additive gaussian noise,
// then the 5-step host-planned photometric program, one staged slot at a
// time.
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_aug.py:fused_slot_aug (body
// _aug_kernel). Same contract, without the TPU layout: slots arrive as the
// loader stages them, (N, S, S, 3) uint8 channels last (the TPU kernel
// needed a planar copy to keep the 3-wide channel axis off its 128 lanes),
// and leave channel-planar (N, 3, S, S) in f32 or bf16, the layout the
// split path's compose (ops/device_augment.py:geometric_compose planar)
// reads. Noise is keyed by (seed, slot, element) (aug_common.cuh), or read
// from injected bits.
//
// What bounds it: arithmetic, not bytes. At the training shape (N = 128
// slots of 352^2) it reads 47.6 MB and writes 95 MB (bf16), ~45 us of HBM,
// while each pixel pays up to three Box-Muller draws (log, sqrt, sin/cos)
// and the HSV round trip. And one dependency: a contrast step needs the
// mean luma of the whole slot as the earlier steps left it.
//
// What the design does about it:
//  * a pre-pass (launch_slot_stats, aug_common.cuh: each slot's contrast
//    steps in levels, a level's pixel chunks spread over all SMs, float64
//    partial sums added in a fixed order) recomputes the pointwise prefix
//    up to each contrast step and reduces it to one scalar; the slot's
//    pixels are never staged in between;
//  * then one thread per pixel applies noise and the whole program with
//    those scalars known, all three channels in registers, so the u8 slot
//    is read once and the output written once;
//  * the program is real branching per pixel: an identity step costs a
//    compare, and hue's round trip runs only where the plan selected it.

#include "aug_common.cuh"

namespace {

using myt_aug::SlotArgs;

__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
slot_apply_kernel(SlotArgs a, const float* stats, T* out) {
  const int s = a.size;
  const size_t plane = static_cast<size_t>(s) * s;
  const size_t total = static_cast<size_t>(a.n_slots) * plane;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = static_cast<int>(i / plane);
  const int p = static_cast<int>(i % plane);
  float v[3];
  myt_aug::pixel_state(a, myt_aug::slot_key(a.seed, n), n, p / s, p % s, myt_aug::kSteps,
                       stats + static_cast<size_t>(n) * myt_aug::kStats, v);
  T* o = out + static_cast<size_t>(n) * 3 * plane + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) store(o, c * plane, v[c]);
}

}  // namespace

// Launches the pre-pass and the pixel pass on `stream`; returns
// cudaGetLastError() (0 on success). `stats` is (N, 8) f32 scratch,
// `partial` (N, 6, stats_chunks(S), 4) float64 and `work` (6, N + 1) int32
// scratch.
extern "C" int myt_slot_aug(const uint8_t* slots, int n, int size, int seed,
                            const int32_t* gate, const float* scale, const int32_t* pc,
                            const int32_t* ops, const float* facs, const uint32_t* bits,
                            float* stats, double* partial, int32_t* work, void* out,
                            int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SlotArgs a{slots, n, size, seed, gate, scale, pc, ops, facs, bits};
  const myt_aug::StatsArgs sa{nullptr, nullptr, nullptr, nullptr, partial, work,
                              myt_aug::stats_chunks(size)};
  myt_aug::launch_slot_stats(a, sa, stats, st);
  const size_t total = static_cast<size_t>(n) * size * size;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (out_bf16) {
    slot_apply_kernel<<<blocks, 256, 0, st>>>(a, stats, static_cast<__nv_bfloat16*>(out));
  } else {
    slot_apply_kernel<<<blocks, 256, 0, st>>>(a, stats, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
