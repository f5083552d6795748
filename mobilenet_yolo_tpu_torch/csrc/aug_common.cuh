// Device functions shared by the two augmentation kernels (slot_aug.cu,
// aug_compose.cu): the counter-based noise generator, Box-Muller, the five
// photometric ops of the host-planned program, and the per-slot statistics
// pre-pass. Included by both .cu files; everything here sits in an
// anonymous namespace, so each translation unit holds its own copy.
//
// Arithmetic follows mobilenet_yolo_tpu/kernels/pallas_aug.py (the TPU
// kernels) and ops/device_augment.py, in f32, op for op. The plain-torch
// twins in kernels/slot_aug.py reproduce the generator's bits exactly with
// integer ops, so a kernel and its twin draw the same noise.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace myt_aug {
namespace {

constexpr int kSteps = 5;           // photometric program length
constexpr int kStats = 8;           // per slot: 5 contrast means, 3 window means
constexpr int kStatsThreads = 512;  // one block per slot in the pre-pass
constexpr float kTwoPi = 6.283185307179586f;

// Everything a kernel needs to recompute one staged slot's pixels after
// noise and any prefix of its photometric program.
struct SlotArgs {
  const uint8_t* slots;   // (N, S, S, 3) uint8, channels last
  int n_slots;            // N
  int size;               // S (even)
  int32_t seed;
  const int32_t* gate;    // (N,) add noise?
  const float* scale;     // (N,) noise std, [0, 255] units
  const int32_t* pc;      // (N,) one draw per channel? else channel 0's plane
  const int32_t* ops;     // (N, 5) op id per step, -1 identity
  const float* facs;      // (N, 5) factor per step (hue: delta in turns)
  const uint32_t* bits;   // (2, N, 3, S/2, S) injected uniform bits, or null
};

// lowbias32 (Chris Wellons' integer hash): a bijection on 32 bits with
// good avalanche. kernels/slot_aug.py:_mix32 is its integer twin.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// The generator: word j of slot n under `seed` is
//   mix32(key ^ mix32(j)),  key = mix32(seed ^ n * 0x9E3779B9).
// j indexes the (2, 3, S/2, S) bit field of the JAX seam: stream, channel,
// row, column. Counter-based, so any thread draws any word, and a tap of
// the compose kernel recomputes exactly the noise the slot pass drew.
__device__ __forceinline__ uint32_t slot_key(int32_t seed, int n) {
  return mix32(static_cast<uint32_t>(seed) ^ (static_cast<uint32_t>(n) * 0x9E3779B9U));
}

// pallas_aug.py:_bits_to_unit: 24 bits, uniform in (0, 1], never 0.
__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return static_cast<float>(static_cast<int32_t>(bits >> 8)) * (1.0f / 16777216.0f) +
         (1.0f / 33554432.0f);
}

// floor-mod as torch.remainder and jnp.remainder compute it (fmod, then
// shift a result whose sign differs from the divisor's). Plain fmodf
// truncates toward zero, which is wrong for the negative hue deltas.
__device__ __forceinline__ float floor_mod(float x, float d) {
  float m = fmodf(x, d);
  if (m != 0.0f && ((m < 0.0f) != (d < 0.0f))) m += d;
  return m;
}

__device__ __forceinline__ float clamp255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

__device__ __forceinline__ float luma(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// Standard normal for channel c at (y, x) of slot n (pallas_aug.py:_noised):
// Box-Muller on the bit pair at row y mod S/2; rows [0, S/2) take r*cos,
// rows [S/2, S) take r*sin.
__device__ __forceinline__ float normal_at(const SlotArgs& a, uint32_t key, int n, int c,
                                           int y, int x) {
  const int half = a.size / 2;
  const bool upper = y < half;
  const int yy = upper ? y : y - half;
  const uint32_t j0 = static_cast<uint32_t>((c * half + yy) * a.size + x);
  const uint32_t plane = static_cast<uint32_t>(3 * half * a.size);
  uint32_t b1, b2;
  if (a.bits != nullptr) {
    const size_t per_stream = static_cast<size_t>(a.n_slots) * plane;
    const size_t at = static_cast<size_t>(n) * plane + j0;
    b1 = a.bits[at];
    b2 = a.bits[per_stream + at];
  } else {
    b1 = mix32(key ^ mix32(j0));
    b2 = mix32(key ^ mix32(j0 + plane));
  }
  const float u1 = bits_to_unit(b1);
  const float u2 = bits_to_unit(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  const float phase = kTwoPi * u2;
  return upper ? r * cosf(phase) : r * sinf(phase);
}

// pallas_aug.py:_hue, the HSV round trip in f32.
__device__ __forceinline__ void hue_shift(float& R, float& G, float& B, float f) {
  const float r = R / 255.0f, g = G / 255.0f, b = B / 255.0f;
  const float mx = fmaxf(r, fmaxf(g, b));
  const float mn = fminf(r, fminf(g, b));
  const float diff = mx - mn;
  const float safe = diff == 0.0f ? 1.0f : diff;
  float h = mx == r ? floor_mod((g - b) / safe, 6.0f)
                    : (mx == g ? (b - r) / safe + 2.0f : (r - g) / safe + 4.0f);
  h = (diff == 0.0f ? 0.0f : h) / 6.0f;
  const float s = mx == 0.0f ? 0.0f : diff / (mx == 0.0f ? 1.0f : mx);
  h = floor_mod(h + f, 1.0f);
  float out[3];
  const float sector[3] = {5.0f, 3.0f, 1.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float k = floor_mod(sector[c] + h * 6.0f, 6.0f);
    const float w = fminf(fmaxf(fminf(k, 4.0f - k), 0.0f), 1.0f);
    out[c] = clamp255((mx - mx * s * w) * 255.0f);
  }
  R = out[0];
  G = out[1];
  B = out[2];
}

// One program step (pallas_aug.py:_brightness.._gamma); `mean` is the
// slot's mean luma before this step, used by contrast only.
__device__ __forceinline__ void apply_op(int op, float f, float mean, float v[3]) {
  switch (op) {
    case 0:  // brightness
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(v[c] * f);
      break;
    case 1:  // contrast
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(mean + f * (v[c] - mean));
      break;
    case 2: {  // saturation
      const float gray = luma(v[0], v[1], v[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(gray + f * (v[c] - gray));
      break;
    }
    case 3:  // hue
      hue_shift(v[0], v[1], v[2], f);
      break;
    case 4:  // gamma
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(powf(v[c] / 255.0f, f) * 255.0f);
      break;
    default:  // identity (-1) and anything outside the op set
      break;
  }
}

// Pixel (y, x) of slot n after the noise and the first `stop` program
// steps. `means[t]` must hold the contrast mean of every contrast step
// t < stop.
__device__ __forceinline__ void pixel_state(const SlotArgs& a, uint32_t key, int n, int y,
                                            int x, int stop, const float* means,
                                            float v[3]) {
  const uint8_t* px = a.slots + ((static_cast<size_t>(n) * a.size + y) * a.size + x) * 3;
  v[0] = px[0];
  v[1] = px[1];
  v[2] = px[2];
  if (a.gate[n] != 0) {
    const float scale = a.scale[n];
    if (a.pc[n] != 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(v[c] + normal_at(a, key, n, c, y, x) * scale);
    } else {
      const float z = normal_at(a, key, n, 0, y, x) * scale;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clamp255(v[c] + z);
    }
  }
  const int32_t* ops = a.ops + n * kSteps;
  const float* facs = a.facs + n * kSteps;
  for (int t = 0; t < stop; ++t) apply_op(ops[t], facs[t], means[t], v);
}

// Sum of `val` over the block, in double, in a fixed order (deterministic).
template <int N>
__device__ __forceinline__ void block_sum(double (&val)[N], double (*scratch)[kStatsThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int off = 16; off > 0; off >>= 1) val[i] += __shfl_down_sync(0xffffffffU, val[i], off);
    if (lane == 0) scratch[i][warp] = val[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      double s = 0.0;
      for (int w = 0; w < kStatsThreads / 32; ++w) s += scratch[i][w];
      val[i] = s;
    }
  }
  __syncthreads();
}

// Per-slot statistics pre-pass, one block per slot. The contrast step
// needs the mean luma of the whole slot as the earlier steps left it, a
// reduction in the middle of a pointwise program (the TPU kernel held the
// slot in VMEM; a 3 x 416^2 f32 slot is ten times an SM's shared memory).
// So the block walks the program: at each contrast step it recomputes the
// noise and the steps before it for every pixel and reduces their luma,
// then carries the mean on. stats[n] = (mean before step 0..4, window
// mean r, g, b); a mean slot of a step that is not contrast is left 0.
//
// With `win_rect` set and fill_from_mean[n], it also reduces the fully
// programmed slot over the source window mask (device_augment.py:330-341:
// the rect mirrored for a flipped tile, pixel centres against the edges),
// the colour the compose kernel fills the tile with.
//
// active (may be null: every slot) skips a slot outright.
__global__ void __launch_bounds__(kStatsThreads)
slot_stats_kernel(SlotArgs a, const int32_t* active, const float* win_rect,
                  const int32_t* fill_from_mean, const int32_t* flip, float* stats) {
  __shared__ double scratch[4][kStatsThreads / 32];
  __shared__ float means[kSteps];
  const int n = blockIdx.x;
  if (active != nullptr && active[n] == 0) return;
  const uint32_t key = slot_key(a.seed, n);
  const int s = a.size;
  const int npix = s * s;
  if (threadIdx.x < kSteps) means[threadIdx.x] = 0.0f;
  __syncthreads();

  for (int t = 0; t < kSteps; ++t) {
    if (a.ops[n * kSteps + t] != 1) continue;  // same t in every thread
    double acc[1] = {0.0};
    for (int p = threadIdx.x; p < npix; p += kStatsThreads) {
      float v[3];
      pixel_state(a, key, n, p / s, p % s, t, means, v);
      acc[0] += luma(v[0], v[1], v[2]);
    }
    block_sum(acc, scratch);
    if (threadIdx.x == 0) means[t] = static_cast<float>(acc[0] / npix);
    __syncthreads();
  }

  float* out = stats + static_cast<size_t>(n) * kStats;
  if (threadIdx.x < kSteps) out[threadIdx.x] = means[threadIdx.x];
  if (win_rect == nullptr || fill_from_mean[n] == 0) return;

  const float* sr = win_rect + n * 4;
  const bool flipped = flip[n] != 0;
  const float x0 = flipped ? 1.0f - sr[2] : sr[0];
  const float x1 = flipped ? 1.0f - sr[0] : sr[2];
  double acc[4] = {0.0, 0.0, 0.0, 0.0};  // r, g, b sums and the pixel count
  for (int p = threadIdx.x; p < npix; p += kStatsThreads) {
    const int y = p / s, x = p % s;
    const float yc = (static_cast<float>(y) + 0.5f) / s;
    const float xc = (static_cast<float>(x) + 0.5f) / s;
    if (!(yc >= sr[1] && yc < sr[3] && xc >= x0 && xc < x1)) continue;
    float v[3];
    pixel_state(a, key, n, y, x, kSteps, means, v);
    acc[0] += v[0];
    acc[1] += v[1];
    acc[2] += v[2];
    acc[3] += 1.0;
  }
  block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    const double c = acc[3] < 1.0 ? 1.0 : acc[3];
    for (int ch = 0; ch < 3; ++ch) out[kSteps + ch] = static_cast<float>(acc[ch] / c);
  }
}

}  // namespace
}  // namespace myt_aug
