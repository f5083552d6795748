// Full device augmentation for Hopper (sm_90a): per staged tile, noise and
// the photometric program, then the geometric compose of up to 4 tiles
// (mean or constant fill, bilinear paste of a source window, flip) into
// one output image.
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_aug.py:fused_aug_compose_kernel
// (bodies _aug_compose_kernel, _taps_2d, _two_hot). Same contract: slots
// (B, T, S, S, 3) uint8 channels last with per-tile plans (B, T, .) ->
// images (B, H, W, 3) bf16 channels last, which the model reads as NCHW in
// channels_last memory with no copy. Numbers follow the plain compose,
// ops/device_augment.py:_compose_one (rounded once, to nearest even):
//  * tile by tile in order 0..T-1, inactive tiles skipped: paint the fill
//    rect (constant, or the mean of the programmed slot over the source
//    window, mirrored for a flipped tile), then paste the source rect into
//    the destination rect;
//  * the paste is the direct two-tap gather and lerp of _axis_taps in f32,
//    rows first then columns, edge-clamped like cv2.INTER_LINEAR, flip
//    folded into the column taps. The TPU kernel resampled by bf16 two-hot
//    matmuls because its MXU wanted matrices; a gather is what Hopper does
//    natively, and it keeps f32 until the one final rounding.
//
// What bounds it: arithmetic. Each output pixel reads 4 source taps per
// covering tile; the programmed value of a tap costs up to three
// Box-Muller draws and an HSV round trip. Bytes are small: the u8 slots
// (47.6 MB at B = 32, T = 4, S = 352) stay largely in the 50 MB L2, and
// the output is 23.8 MB.
//
// What the design does about it, and the choice it makes:
//  * the taps RECOMPUTE the noise and the program from the u8 slot instead
//    of reading a staging buffer written by a slot pass. A staging buffer
//    is (B, T, 3, S, S): 190 MB written and read back in f32 (95 MB in
//    bf16, which would round the taps before the lerp and double the
//    error against the f32 twin). The recompute costs ALU time on a
//    kernel that has nothing else to do with it, is bit-identical to the
//    slot pass (the generator is counter-based), and never stages a
//    pixel; only the per-slot scalars come from the pre-pass;
//  * the pre-pass (slot_stats_kernel, aug_common.cuh) computes those
//    scalars, the contrast means and the fill window mean, one block per
//    active slot;
//  * one thread per output pixel, all three channels in registers;
//    neighbouring threads read neighbouring source taps, so a warp's 4 x
//    32 tap reads fall in a few L1 lines.

#include "aug_common.cuh"

namespace {

using myt_aug::SlotArgs;

struct Taps {
  int i0, i1;
  float frac;
};

// ops/device_augment.py:_axis_taps for output index o, in the same f32
// order of operations.
__device__ __forceinline__ Taps axis_taps(int o, int in_size, float src0, float src1,
                                          float dst0, float dst1) {
  const float denom = fmaxf(dst1 - dst0, 1e-6f);
  float u = src0 + ((static_cast<float>(o) + 0.5f - dst0) * (src1 - src0)) / denom;
  u = fminf(fmaxf(u - 0.5f, 0.0f), static_cast<float>(in_size) - 1.0f);
  const float i0f = floorf(u);
  Taps t;
  t.i0 = static_cast<int>(i0f);
  t.i1 = min(t.i0 + 1, in_size - 1);
  t.frac = u - i0f;
  return t;
}

__device__ __forceinline__ bool in_rect(const float* r, float xc, float yc) {
  return yc >= r[1] && yc < r[3] && xc >= r[0] && xc < r[2];
}

struct TilePlans {
  int tiles;                   // T
  const float* src_rect;       // (B, T, 4) normalized x1, y1, x2, y2
  const float* dst_rect;       // (B, T, 4)
  const float* fill_rect;      // (B, T, 4)
  const float* fill_color;     // (B, T, 3) raw [0, 255]
  const int32_t* fill_from_mean;  // (B, T)
  const int32_t* flip;         // (B, T)
  const int32_t* active;       // (B, T)
};

__global__ void __launch_bounds__(256)
compose_kernel(SlotArgs a, TilePlans g, const float* stats, int batch, int out_h, int out_w,
               __nv_bfloat16* out) {
  const size_t per_image = static_cast<size_t>(out_h) * out_w;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= per_image * batch) return;
  const int b = static_cast<int>(i / per_image);
  const int p = static_cast<int>(i % per_image);
  const int oy = p / out_w, ox = p % out_w;
  // pixel centres, as device_augment.py:_rect_mask compares them
  const float yc = (static_cast<float>(oy) + 0.5f) / out_h;
  const float xc = (static_cast<float>(ox) + 0.5f) / out_w;
  const int s = a.size;
  const float sf = static_cast<float>(s);

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < g.tiles; ++k) {
    const int n = b * g.tiles + k;
    if (g.active[n] == 0) continue;
    const float* st = stats + static_cast<size_t>(n) * myt_aug::kStats;
    if (in_rect(g.fill_rect + n * 4, xc, yc)) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = g.fill_from_mean[n] != 0 ? st[myt_aug::kSteps + c] : g.fill_color[n * 3 + c];
    }
    const float* dr = g.dst_rect + n * 4;
    if (!in_rect(dr, xc, yc)) continue;
    const float* sr = g.src_rect + n * 4;
    const Taps ty = axis_taps(oy, s, sr[1] * sf, sr[3] * sf, dr[1] * out_h, dr[3] * out_h);
    Taps tx = axis_taps(ox, s, sr[0] * sf, sr[2] * sf, dr[0] * out_w, dr[2] * out_w);
    if (g.flip[n] != 0) {
      tx.i0 = s - 1 - tx.i0;
      tx.i1 = s - 1 - tx.i1;
    }
    const uint32_t key = myt_aug::slot_key(a.seed, n);
    float v00[3], v01[3], v10[3], v11[3];
    myt_aug::pixel_state(a, key, n, ty.i0, tx.i0, myt_aug::kSteps, st, v00);
    myt_aug::pixel_state(a, key, n, ty.i0, tx.i1, myt_aug::kSteps, st, v01);
    myt_aug::pixel_state(a, key, n, ty.i1, tx.i0, myt_aug::kSteps, st, v10);
    myt_aug::pixel_state(a, key, n, ty.i1, tx.i1, myt_aug::kSteps, st, v11);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float row0 = v00[c] * (1.0f - ty.frac) + v10[c] * ty.frac;
      const float row1 = v01[c] * (1.0f - ty.frac) + v11[c] * ty.frac;
      acc[c] = row0 * (1.0f - tx.frac) + row1 * tx.frac;
    }
  }
  __nv_bfloat16* o = out + i * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = __float2bfloat16_rn(acc[c]);
}

}  // namespace

// Launches the pre-pass and the compose pass on `stream`; returns
// cudaGetLastError() (0 on success). `stats` is (B*T, 8) f32 scratch.
extern "C" int myt_aug_compose(const uint8_t* slots, int batch, int tiles, int size, int seed,
                               const int32_t* gate, const float* scale, const int32_t* pc,
                               const int32_t* ops, const float* facs, const uint32_t* bits,
                               const float* src_rect, const float* dst_rect,
                               const float* fill_rect, const float* fill_color,
                               const int32_t* fill_from_mean, const int32_t* flip,
                               const int32_t* active, float* stats, int out_h, int out_w,
                               void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = batch * tiles;
  const SlotArgs a{slots, n, size, seed, gate, scale, pc, ops, facs, bits};
  const TilePlans g{tiles, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip,
                    active};
  myt_aug::slot_stats_kernel<<<n, myt_aug::kStatsThreads, 0, st>>>(
      a, active, src_rect, fill_from_mean, flip, stats);
  const size_t total = static_cast<size_t>(batch) * out_h * out_w;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  compose_kernel<<<blocks, 256, 0, st>>>(a, g, stats, batch, out_h, out_w,
                                         static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
