// Device functions shared by the two augmentation kernels (slot_aug.cu,
// aug_compose.cu): the counter-based noise generator, Box-Muller, the five
// photometric ops of the host-planned program, and the per-slot statistics
// pre-pass with its launches. Included by both .cu files; everything here
// sits in an anonymous namespace, so each translation unit holds its own
// copy.
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

constexpr int kSteps = 5;            // photometric program length
constexpr int kStats = 8;            // per slot: 5 contrast means, 3 window means
constexpr int kStatsThreads = 256;   // threads of a pre-pass block
constexpr int kStatsPixels = 2048;   // pixels of a slot one pre-pass item reduces
constexpr int kStatsBlocks = 1056;   // pre-pass blocks: 8 on each of an H100's 132 SMs
constexpr int kPartials = 4;         // doubles an item leaves: a luma sum, or r, g, b and a count
constexpr int kPasses = kSteps + 1;  // passes of a slot at most: 5 contrast steps, the window
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

// Sum of `val` over the block, in double, in a fixed order: each warp's
// lanes by shuffles, then the warps in order by thread 0 (deterministic).
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
}

// What the pre-pass reads besides the slots: which slots are active (null:
// every slot) and, for the fill-window pass, each slot's source rect,
// fill-from-mean flag and flip (win_rect null: no such pass); and its
// scratch.
struct StatsArgs {
  const int32_t* active;
  const float* win_rect;
  const int32_t* fill_from_mean;
  const int32_t* flip;
  double* partial;  // (N, kPasses, chunks, kPartials): each item's sums
  int32_t* work;    // (kPasses, N + 1): per level its count, then (slot << 3 | step) of each pass
  int chunks;       // pixel chunks of a slot: ceil(S * S / kStatsPixels)
};

__device__ __forceinline__ double* partial_at(const StatsArgs& st, int n, int step, int c) {
  return st.partial + ((static_cast<size_t>(n) * kPasses + step) * st.chunks + c) * kPartials;
}

// Value i of pass `step`'s partial sums of slot n over its chunks, by one
// warp: lane l adds chunks l, l + 32, ... in order, then a butterfly of
// shuffles adds the lanes (IEEE addition commutes, so every lane ends with
// the same bits). Every reader of a sum (the later passes, the finishing
// pass) adds it this way, so all of them see the same value.
__device__ __forceinline__ double warp_partial_sum(const StatsArgs& st, int n, int step, int i) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int c = lane; c < st.chunks; c += 32) s += partial_at(st, n, step, c)[i];
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffU, s, m);
  return s;
}

// The pre-pass's plan, one block: the passes of every active slot, each
// contrast step of its program in order, then the fill-window pass where
// the slot fills from the mean. A pass's level is its place in its slot's
// list, so a pass needs only the passes of lower levels: work[level] lists
// the passes of that level, slot by slot (a block-wide scan of ballots).
__global__ void __launch_bounds__(1024) slot_plan_kernel(SlotArgs a, StatsArgs st) {
  __shared__ int warp_counts[32];
  __shared__ int filled[kPasses];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (threadIdx.x < kPasses) filled[threadIdx.x] = 0;
  __syncthreads();
  for (int base = 0; base < a.n_slots; base += blockDim.x) {
    const int n = base + threadIdx.x;
    int steps[kPasses];
    int count = 0;
    if (n < a.n_slots && (st.active == nullptr || st.active[n] != 0)) {
      for (int t = 0; t < kSteps; ++t) {
        if (a.ops[n * kSteps + t] == 1) steps[count++] = t;
      }
      if (st.win_rect != nullptr && st.fill_from_mean[n] != 0) steps[count++] = kSteps;
    }
    for (int level = 0; level < kPasses; ++level) {
      const unsigned ballot = __ballot_sync(0xffffffffU, count > level);
      if (lane == 0) warp_counts[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < warps; ++w) {
        before += w < warp ? warp_counts[w] : 0;
        total += warp_counts[w];
      }
      if (count > level) {
        const int at = filled[level] + before + __popc(ballot & ((1U << lane) - 1U));
        st.work[level * (a.n_slots + 1) + 1 + at] = (n << 3) | steps[level];
      }
      __syncthreads();
      if (threadIdx.x == 0) filled[level] += total;
      __syncthreads();
    }
  }
  if (threadIdx.x < kPasses) st.work[threadIdx.x * (a.n_slots + 1)] = filled[threadIdx.x];
}

// One level of the per-slot statistics pre-pass, its items (a pass of a
// slot x a chunk of kStatsPixels pixels) spread over the blocks. The
// contrast step needs the mean luma of the whole slot as the earlier steps
// left it, a reduction in the middle of a pointwise program (the TPU kernel
// held the slot in VMEM; a 3 x 416^2 float32 slot is ten times an SM's
// shared memory). So a contrast pass at step t recomputes the noise and
// the steps before t for its chunk, with the means of the slot's earlier
// contrast steps (lower levels) formed from their partials, and leaves the
// chunk's float64 luma sum. The window pass reduces the fully programmed
// slot over the source window mask (device_augment.py:330-341: the rect
// mirrored for a flipped tile, pixel centres against the edges) to r, g,
// b sums and a pixel count. No atomics: two runs give the same bits.
__global__ void __launch_bounds__(kStatsThreads)
slot_partial_kernel(SlotArgs a, StatsArgs st, int level) {
  __shared__ double scratch[kPartials][kStatsThreads / 32];
  __shared__ float means[kSteps];
  const int32_t* list = st.work + level * (a.n_slots + 1);
  const int items = list[0] * st.chunks;
  const int s = a.size, npix = s * s;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int entry = list[1 + item / st.chunks], c = item % st.chunks;
    const int n = entry >> 3, step = entry & 7;
    const int32_t* ops = a.ops + n * kSteps;
    const int t = threadIdx.x >> 5;  // warp t forms the mean of step t
    if (t < kSteps) {
      const float m =
          t < step && ops[t] == 1 ? static_cast<float>(warp_partial_sum(st, n, t, 0) / npix) : 0.0f;
      if ((threadIdx.x & 31) == 0) means[t] = m;
    }
    __syncthreads();

    const uint32_t key = slot_key(a.seed, n);
    const int p0 = c * kStatsPixels, p1 = min(npix, p0 + kStatsPixels);
    double acc[kPartials] = {0.0, 0.0, 0.0, 0.0};
    if (step < kSteps) {
      for (int p = p0 + threadIdx.x; p < p1; p += kStatsThreads) {
        float v[3];
        pixel_state(a, key, n, p / s, p % s, step, means, v);
        acc[0] += luma(v[0], v[1], v[2]);
      }
    } else {
      const float* sr = st.win_rect + n * 4;
      const bool flipped = st.flip[n] != 0;
      const float x0 = flipped ? 1.0f - sr[2] : sr[0];
      const float x1 = flipped ? 1.0f - sr[0] : sr[2];
      for (int p = p0 + threadIdx.x; p < p1; p += kStatsThreads) {
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
    }
    block_sum(acc, scratch);
    if (threadIdx.x == 0) {
      double* out = partial_at(st, n, step, c);
#pragma unroll
      for (int i = 0; i < kPartials; ++i) out[i] = acc[i];
    }
    __syncthreads();  // the next item rewrites means and scratch
  }
}

// stats[n] = (mean before step 0..4, window mean r, g, b) of every active
// slot, one warp a slot, from the passes' partials; a mean of a step that
// is not contrast is 0, and the window means are written only for a slot
// that fills from the mean.
__global__ void slot_stats_finish_kernel(SlotArgs a, StatsArgs st, float* stats) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (n >= a.n_slots || (st.active != nullptr && st.active[n] == 0)) return;
  const int npix = a.size * a.size;
  float* out = stats + static_cast<size_t>(n) * kStats;
  for (int t = 0; t < kSteps; ++t) {
    const float m = a.ops[n * kSteps + t] == 1
                        ? static_cast<float>(warp_partial_sum(st, n, t, 0) / npix)
                        : 0.0f;
    if (lane == 0) out[t] = m;
  }
  if (st.win_rect == nullptr || st.fill_from_mean[n] == 0) return;
  double sum[kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) sum[i] = warp_partial_sum(st, n, kSteps, i);
  const double count = sum[3] < 1.0 ? 1.0 : sum[3];
  if (lane == 0) {
    for (int ch = 0; ch < 3; ++ch) out[kSteps + ch] = static_cast<float>(sum[ch] / count);
  }
}

// The pixel chunks of an S x S slot, and so the partials' third extent
// (kernels/slot_aug.py:stats_scratch).
__host__ __device__ constexpr int stats_chunks(int size) {
  return (size * size + kStatsPixels - 1) / kStatsPixels;
}

// The pre-pass on `stream`: the plan, one launch per level (each reads the
// partials of the levels before it; a level no slot reaches finds no
// items), then the per-slot statistics.
inline void launch_slot_stats(const SlotArgs& a, const StatsArgs& st, float* stats,
                              cudaStream_t stream) {
  slot_plan_kernel<<<1, 1024, 0, stream>>>(a, st);
  const int levels = st.win_rect != nullptr ? kPasses : kSteps;
  for (int level = 0; level < levels; ++level) {
    slot_partial_kernel<<<kStatsBlocks, kStatsThreads, 0, stream>>>(a, st, level);
  }
  slot_stats_finish_kernel<<<(a.n_slots + 3) / 4, 128, 0, stream>>>(a, st, stats);
}

}  // namespace
}  // namespace myt_aug
