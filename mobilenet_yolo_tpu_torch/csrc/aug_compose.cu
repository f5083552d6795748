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
//  * the pre-pass (launch_slot_stats, aug_common.cuh) computes those
//    scalars, the contrast means and the fill window mean, spread over the
//    card: a plan orders each slot's passes (its contrast steps, then the
//    window) into levels, and one launch a level spreads its passes' pixel
//    chunks over all SMs, each leaving float64 partial sums that the next
//    level and a finishing pass add in a fixed order (no atomics, so runs
//    are bit-identical);
//  * one block per 16 x 16 output pixels, one thread per pixel, all three
//    channels in registers. For each tile that covers some of them, the
//    block reduces its pixels' taps to the source window they read and,
//    where that window has fewer pixels than the 4 taps of each covered
//    output pixel (a paste at a scale up to ~2) and fits kWindowCap,
//    computes each source pixel's noise and program once into shared
//    memory; the taps then read it there. Else (a strong downscale) each
//    tap computes its pixel itself. Either way the values are
//    pixel_state's, so the two are bit-identical.

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

constexpr int kSide = 16;              // output pixels a block's side
constexpr int kWindowCap = 56 * 56;    // source pixels a block stages, at most

__global__ void __launch_bounds__(kSide * kSide)
compose_kernel(SlotArgs a, TilePlans g, const float* stats, int out_h, int out_w, int blocks_w,
               __nv_bfloat16* out) {
  __shared__ float win[3][kWindowCap];
  __shared__ int bounds[4];  // the block's taps: first and last source row, column
  const int b = blockIdx.y;
  const int oy = (blockIdx.x / blocks_w) * kSide + threadIdx.x / kSide;
  const int ox = (blockIdx.x % blocks_w) * kSide + threadIdx.x % kSide;
  const bool live = oy < out_h && ox < out_w;
  // pixel centres, as device_augment.py:_rect_mask compares them
  const float yc = (static_cast<float>(oy) + 0.5f) / out_h;
  const float xc = (static_cast<float>(ox) + 0.5f) / out_w;
  const int s = a.size;
  const float sf = static_cast<float>(s);

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < g.tiles; ++k) {
    const int n = b * g.tiles + k;
    if (g.active[n] == 0) continue;  // the same for the whole block
    const float* st = stats + static_cast<size_t>(n) * myt_aug::kStats;
    if (live && in_rect(g.fill_rect + n * 4, xc, yc)) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = g.fill_from_mean[n] != 0 ? st[myt_aug::kSteps + c] : g.fill_color[n * 3 + c];
    }
    const float* dr = g.dst_rect + n * 4;
    const bool inside = live && in_rect(dr, xc, yc);
    const float* sr = g.src_rect + n * 4;
    const Taps ty = axis_taps(oy, s, sr[1] * sf, sr[3] * sf, dr[1] * out_h, dr[3] * out_h);
    Taps tx = axis_taps(ox, s, sr[0] * sf, sr[2] * sf, dr[0] * out_w, dr[2] * out_w);
    if (g.flip[n] != 0) {
      tx.i0 = s - 1 - tx.i0;
      tx.i1 = s - 1 - tx.i1;
    }
    if (threadIdx.x == 0) {
      bounds[0] = bounds[2] = s;
      bounds[1] = bounds[3] = -1;
    }
    __syncthreads();
    if (inside) {
      atomicMin(&bounds[0], ty.i0);
      atomicMax(&bounds[1], ty.i1);
      atomicMin(&bounds[2], min(tx.i0, tx.i1));
      atomicMax(&bounds[3], max(tx.i0, tx.i1));
    }
    const int covered = __syncthreads_count(inside);
    const int r0 = bounds[0], c0 = bounds[2];
    const int wc = bounds[3] - c0 + 1, cells = (bounds[1] - r0 + 1) * wc;
    const uint32_t key = myt_aug::slot_key(a.seed, n);
    // the same for the whole block: stage the window where that is less
    // work than the covered pixels' own taps
    const bool staged = covered > 0 && cells <= kWindowCap && cells < 4 * covered;
    if (staged) {
      for (int i = threadIdx.x; i < cells; i += kSide * kSide) {
        float v[3];
        myt_aug::pixel_state(a, key, n, r0 + i / wc, c0 + i % wc, myt_aug::kSteps, st, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) win[c][i] = v[c];
      }
      __syncthreads();
    }
    if (inside) {
      float v00[3], v01[3], v10[3], v11[3];
      if (staged) {
        const int y0 = (ty.i0 - r0) * wc, y1 = (ty.i1 - r0) * wc;
        const int x0 = tx.i0 - c0, x1 = tx.i1 - c0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v00[c] = win[c][y0 + x0];
          v01[c] = win[c][y0 + x1];
          v10[c] = win[c][y1 + x0];
          v11[c] = win[c][y1 + x1];
        }
      } else {
        myt_aug::pixel_state(a, key, n, ty.i0, tx.i0, myt_aug::kSteps, st, v00);
        myt_aug::pixel_state(a, key, n, ty.i0, tx.i1, myt_aug::kSteps, st, v01);
        myt_aug::pixel_state(a, key, n, ty.i1, tx.i0, myt_aug::kSteps, st, v10);
        myt_aug::pixel_state(a, key, n, ty.i1, tx.i1, myt_aug::kSteps, st, v11);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float row0 = v00[c] * (1.0f - ty.frac) + v10[c] * ty.frac;
        const float row1 = v01[c] * (1.0f - ty.frac) + v11[c] * ty.frac;
        acc[c] = row0 * (1.0f - tx.frac) + row1 * tx.frac;
      }
    }
    __syncthreads();  // the next tile rewrites bounds and the window
  }
  if (!live) return;
  __nv_bfloat16* o = out + ((static_cast<size_t>(b) * out_h + oy) * out_w + ox) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = __float2bfloat16_rn(acc[c]);
}

}  // namespace

// Launches the pre-pass and the compose pass on `stream`; returns
// cudaGetLastError() (0 on success). `stats` is (B*T, 8) f32 scratch,
// `partial` (B*T, 6, stats_chunks(S), 4) float64 and `work` (6, B*T + 1)
// int32 scratch.
extern "C" int myt_aug_compose(const uint8_t* slots, int batch, int tiles, int size, int seed,
                               const int32_t* gate, const float* scale, const int32_t* pc,
                               const int32_t* ops, const float* facs, const uint32_t* bits,
                               const float* src_rect, const float* dst_rect,
                               const float* fill_rect, const float* fill_color,
                               const int32_t* fill_from_mean, const int32_t* flip,
                               const int32_t* active, float* stats, double* partial,
                               int32_t* work, int out_h, int out_w, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = batch * tiles;
  const SlotArgs a{slots, n, size, seed, gate, scale, pc, ops, facs, bits};
  const TilePlans g{tiles, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip,
                    active};
  const myt_aug::StatsArgs sa{active, src_rect, fill_from_mean, flip, partial, work,
                              myt_aug::stats_chunks(size)};
  myt_aug::launch_slot_stats(a, sa, stats, st);
  const int blocks_w = (out_w + kSide - 1) / kSide, blocks_h = (out_h + kSide - 1) / kSide;
  compose_kernel<<<dim3(blocks_h * blocks_w, batch), kSide * kSide, 0, st>>>(
      a, g, stats, out_h, out_w, blocks_w, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
