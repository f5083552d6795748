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
// What bounds it: bytes for most slots, arithmetic for some. At the
// training shape (N = 128 slots of 352^2) it reads 47.6 MB and writes 95 MB
// (bf16), ~43 us of HBM; most of the loader's slots are inactive or carry
// no noise, but a noised slot pays a Box-Muller draw per pixel and channel
// (log, sqrt, sin/cos), a hue step the HSV round trip and a gamma step
// three powf. And one dependency: a contrast step needs the mean luma of
// the whole slot as the earlier steps left it.
//
// What the design does about it:
//  * a pre-pass (launch_slot_stats, aug_common.cuh: each slot's contrast
//    steps in levels, a level's pixel chunks spread over all SMs, float64
//    partial sums added in a fixed order) recomputes the pointwise prefix
//    up to each contrast step and reduces it to one scalar; the slot's
//    pixels are never staged in between;
//  * then the pixel pass: a grid of (slot, band of row pairs), so a block
//    reads its slot's plan and contrast means once into shared memory and
//    its program's branches are uniform; a slot with no noise and an
//    identity program only converts and stores;
//  * a thread owns pixels (y, x..x+3) and (y + S/2, x..x+3): the uint8
//    reads are three aligned 32-bit words a row, the stores 8 bytes (bf16)
//    or 16 (f32) per plane and row. Rows y and y + S/2 draw their normals
//    from one bit pair (r cos and r sin of one Box-Muller draw), so one
//    hash pair, logf, sqrtf and sincosf serve both (the compose kernel's taps,
//    through aug_common.cuh:normal_at, draw each row's half apart);
//  * a ragged instance (one column a thread, byte loads, scalar stores)
//    takes S % 4 != 0 and misaligned slots;
//  * the accurate logf, sqrtf, sincosf and powf, no fast-math intrinsics:
//    u1 reaches 1 - 2^-25, where __logf's error exceeds -log(u1) and the
//    radius would turn NaN. sincosf gives the bits of cosf and sinf apart
//    (myt_aug_trig_table, checked on every phase by the card tests), and
//    the program is aug_common.cuh's apply_op, so every output has the
//    bits of pixel_state's value for its pixel, the value aug_compose.cu's taps
//    compute. (A short floor-mod, equal to the fmodf form on every float
//    alone, moved outputs once inlined, for 4% of the hue slots' time:
//    not taken.)

#include "aug_common.cuh"

namespace {

using myt_aug::kSteps;
using myt_aug::SlotArgs;

constexpr int kThreads = 256;

__device__ __forceinline__ void store_row(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* out, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}
__device__ __forceinline__ void store_row(float* out, const float (&v)[1]) { *out = v[0]; }
__device__ __forceinline__ void store_row(__nv_bfloat16* out, const float (&v)[1]) {
  *out = __float2bfloat16_rn(v[0]);
}

// W pixels of one row, channels last: three aligned 32-bit words for W = 4
// (12 bytes, aligned when S % 4 == 0 and the slots are), else bytes.
template <int W>
__device__ __forceinline__ void load_row(const uint8_t* px, float (&v)[W][3]) {
  if constexpr (W == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(px);
    const uint32_t words[3] = {w[0], w[1], w[2]};
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      v[i / 3][i % 3] = static_cast<float>((words[i / 4] >> (8 * (i % 4))) & 0xffU);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[0][c] = px[c];
  }
}

// Program step `op` on every pixel the thread holds; the op is uniform over
// the block, so the switch does not diverge.
template <int kOp, int P>
__device__ __forceinline__ void each_pixel(float f, float mean, float (&v)[P][3]) {
#pragma unroll
  for (int p = 0; p < P; ++p) myt_aug::apply_op(kOp, f, mean, v[p]);
}

template <int P>
__device__ __forceinline__ void apply_step(int op, float f, float mean, float (&v)[P][3]) {
  switch (op) {
    case 0: each_pixel<0>(f, mean, v); break;
    case 1: each_pixel<1>(f, mean, v); break;
    case 2: each_pixel<2>(f, mean, v); break;
    case 3: each_pixel<3>(f, mean, v); break;
    case 4: each_pixel<4>(f, mean, v); break;
    default: break;  // identity (-1) and anything outside the op set
  }
}

// Noise of the pixel pair (y, x + k) and (y + S/2, x + k) for k < W: one
// Box-Muller draw per column and drawn channel; rows [0, S/2) take r*cos,
// rows [S/2, S) r*sin, the layout normal_at (aug_common.cuh) reads.
template <int W>
__device__ __forceinline__ void add_noise(const SlotArgs& a, uint32_t key, int n, int y, int x,
                                          bool per_channel, float scale,
                                          float (&top)[W][3], float (&bottom)[W][3]) {
  const int half = a.size / 2;
  const uint32_t plane = static_cast<uint32_t>(3 * half * a.size);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c > 0 && !per_channel) break;  // one shared plane: channel 0's draws
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t j0 = static_cast<uint32_t>((c * half + y) * a.size + x + k);
      uint32_t b1, b2;
      if (a.bits != nullptr) {
        const size_t at = static_cast<size_t>(n) * plane + j0;
        b1 = a.bits[at];
        b2 = a.bits[static_cast<size_t>(a.n_slots) * plane + at];
      } else {
        b1 = myt_aug::mix32(key ^ myt_aug::mix32(j0));
        b2 = myt_aug::mix32(key ^ myt_aug::mix32(j0 + plane));
      }
      const float r = sqrtf(-2.0f * logf(myt_aug::bits_to_unit(b1)));
      float sn, cs;
      sincosf(myt_aug::kTwoPi * myt_aug::bits_to_unit(b2), &sn, &cs);
      // v + z * scale as one fused multiply-add, as pixel_state's
      // v + normal_at(...) * scale compiles: the compose's taps then
      // recompute exactly these values (unfused, some moved by one ulp)
      const float zt = r * cs, zb = r * sn;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (per_channel && ch != c) continue;
        top[k][ch] = myt_aug::clamp255(__fmaf_rn(zt, scale, top[k][ch]));
        bottom[k][ch] = myt_aug::clamp255(__fmaf_rn(zb, scale, bottom[k][ch]));
      }
    }
  }
}

// One block: kThreads (row pair, W-column group) items of slot blockIdx.x,
// band blockIdx.y.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
slot_apply_kernel(SlotArgs a, const float* stats, T* out) {
  __shared__ int s_ops[kSteps];
  __shared__ float s_facs[kSteps], s_means[kSteps];
  __shared__ int s_noise, s_per_channel;
  __shared__ float s_scale;
  const int n = blockIdx.x;
  if (threadIdx.x < kSteps) {
    s_ops[threadIdx.x] = a.ops[n * kSteps + threadIdx.x];
    s_facs[threadIdx.x] = a.facs[n * kSteps + threadIdx.x];
    s_means[threadIdx.x] = stats[static_cast<size_t>(n) * myt_aug::kStats + threadIdx.x];
  } else if (threadIdx.x == 32) {
    s_noise = a.gate[n];
    s_per_channel = a.pc[n];
    s_scale = a.scale[n];
  }
  __syncthreads();

  const int s = a.size, half = s / 2, groups = s / W;
  const int item = blockIdx.y * kThreads + threadIdx.x;
  if (item >= half * groups) return;
  const int y = item / groups, x = (item - y * groups) * W;
  const uint8_t* slot = a.slots + static_cast<size_t>(n) * s * s * 3;
  float top[W][3], bottom[W][3];
  load_row<W>(slot + (y * s + x) * 3, top);
  load_row<W>(slot + ((y + half) * s + x) * 3, bottom);

  if (s_noise != 0) {
    add_noise<W>(a, myt_aug::slot_key(a.seed, n), n, y, x, s_per_channel != 0, s_scale, top,
                 bottom);
  }
  // the program, one row at a time: a pass over the top row, then the
  // rows swap places (register moves) and the same code takes the bottom
  // row; the two swaps leave both in place. One inlined copy of the
  // program for W pixels, not 2W: with the hue and gamma code of 2W
  // pixels inlined, hue-and-gamma slots ran 5% slower (PERF.md).
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
#pragma unroll 1
    for (int t = 0; t < kSteps; ++t) {
      const int op = s_ops[t];
      if (op >= 0 && op <= 4) apply_step<W>(op, s_facs[t], s_means[t], top);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float held = top[k][c];
        top[k][c] = bottom[k][c];
        bottom[k][c] = held;
      }
    }
  }

  const size_t plane = static_cast<size_t>(s) * s;
  T* o = out + static_cast<size_t>(n) * 3 * plane + y * s + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float row[W], row2[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      row[k] = top[k][c];
      row2[k] = bottom[k][c];
    }
    store_row(o + c * plane, row);
    store_row(o + c * plane + static_cast<size_t>(half) * s, row2);
  }
}

template <typename T>
void launch_apply(const SlotArgs& a, const float* stats, T* out, bool vec, cudaStream_t st) {
  const int w = vec ? 4 : 1;
  const int items = a.size / 2 * (a.size / w);
  const dim3 grid(a.n_slots, (items + kThreads - 1) / kThreads);
  if (vec) {
    slot_apply_kernel<T, 4><<<grid, kThreads, 0, st>>>(a, stats, out);
  } else {
    slot_apply_kernel<T, 1><<<grid, kThreads, 0, st>>>(a, stats, out);
  }
}

// The card tests' view of the two libm paths the noise relies on: every
// phase 2*pi*u2 that bits_to_unit can give (2^24 of them).
constexpr int kPhases = 1 << 24;

__device__ __forceinline__ float phase_of(int i) {
  return myt_aug::kTwoPi * myt_aug::bits_to_unit(static_cast<uint32_t>(i) << 8);
}
__global__ void cos_table_kernel(float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kPhases) out[i] = cosf(phase_of(i));
}
__global__ void sin_table_kernel(float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kPhases) out[i] = sinf(phase_of(i));
}
__global__ void sincos_table_kernel(float* cos_out, float* sin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kPhases) sincosf(phase_of(i), &sin_out[i], &cos_out[i]);
}

}  // namespace

// Launches the pre-pass and the pixel pass on `stream`; returns
// cudaGetLastError() (0 on success). `stats` is (N, 8) f32 scratch,
// `partial` (N, 6, stats_chunks(S), 4) float64 and `work` (6, N + 1) int32
// scratch. `vec` (S % 4 == 0 and 4-byte aligned slots) takes the 4-column
// instance.
extern "C" int myt_slot_aug(const uint8_t* slots, int n, int size, int seed,
                            const int32_t* gate, const float* scale, const int32_t* pc,
                            const int32_t* ops, const float* facs, const uint32_t* bits,
                            float* stats, double* partial, int32_t* work, void* out,
                            int out_bf16, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SlotArgs a{slots, n, size, seed, gate, scale, pc, ops, facs, bits};
  const myt_aug::StatsArgs sa{nullptr, nullptr, nullptr, nullptr, partial, work,
                              myt_aug::stats_chunks(size)};
  myt_aug::launch_slot_stats(a, sa, stats, st);
  if (out_bf16) {
    launch_apply(a, stats, static_cast<__nv_bfloat16*>(out), vec != 0, st);
  } else {
    launch_apply(a, stats, static_cast<float*>(out), vec != 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Test hook: out (4, 2^24) f32 gets cosf and sinf of every noise phase,
// each from a kernel of its own, then sincosf's cos and sin.
extern "C" int myt_aug_trig_table(float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = kPhases / kThreads;
  cos_table_kernel<<<blocks, kThreads, 0, st>>>(out);
  sin_table_kernel<<<blocks, kThreads, 0, st>>>(out + kPhases);
  sincos_table_kernel<<<blocks, kThreads, 0, st>>>(out + 2 * kPhases, out + 3 * kPhases);
  return static_cast<int>(cudaGetLastError());
}
