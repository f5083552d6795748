// Fused MobileNetV2 inverted-residual block (BatchNorm folded) in float32 on
// Hopper's tensor cores (sm_90a): 1x1 expand + bias, ReLU6, depthwise 3x3
// (stride 1 or 2) + bias, ReLU6, 1x1 project + bias, optional residual,
// with the hidden tensor never written to device memory.
//
// Replaces, for float32 activations, mobilenet_yolo_tpu/kernels/
// pallas_fused.py:131 (fused_inverted_residual, body _fused_block_kernel)
// and :228 (fused_inverted_residual_s2, body _fused_block_s2_kernel); bf16
// runs on fused_block_bf16.cu. Same contract: x (B, H, W, Cin) NHWC, w1
// (Cin, Ch), wdw (3, 3, Ch), w2 (Ch, Cout), biases, all float32; out (B,
// H/S, W/S, Cout) float32.
//
// Float32 accuracy on TF32 tensor cores: both 1x1 products split every
// operand v into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna's rounding, by
// integer operations, 10 mantissa bits each) and sum a_lo b_hi + a_hi b_lo + a_hi b_hi in float32 (three
// mma.sync per fragment pair, the small products first, into a fresh
// accumulator per k-step that one rounded float32 add joins to the running
// sum: mma_tf32.cuh:mma_3xtf32). One pass (hi only) keeps 11 bits of each
// operand. Modelled in plain torch (kernels/fused_block.py:matmul_tf32x3,
// tests/test_torch_fused.py) at 121 output pixels against float64, error
// relative to the largest output:
//
//   widths (Cin->Ch->Cout)   1xTF32    3xTF32    float32 twin
//   block 16 (160->960->320) 3.7e-4    4.0e-7    7.2e-7
//   block 13 (96->576->160)  4.1e-4    3.3e-7    6.1e-7
//   block 2 (24->144->24)    2.2e-4    8.2e-8    1.9e-7
//
// One pass would miss the 1e-4 the card tests hold the kernel to against
// its twin; three passes are as accurate as float32 FMAs. The kernel never
// reads torch.backends.cuda.matmul.allow_tf32: its results are float32
// accurate whatever that flag says.
//
// What bounds it. Three TF32 passes at 494.7 TFLOP/s dense do a block's
// operations in 41% of the time float32 FMAs (67 TFLOP/s) would; that is
// still more than HBM's bytes take at every served shape, so the bound is
// the operations (PERF.md). As in the bf16 kernel, each block walks its
// hidden chunks in a dependent chain of loads, products and barriers, and
// each tile pulls all of w1 and w2 through L2: latency and occupancy bind
// first (PERF.md).
//
// What the design does about it (the bf16 kernel's shape, float32 sizes):
//  * both 1x1 products are mma.sync.m16n8k8 tf32 with the split above,
//    made in registers after each fragment load: shared memory holds plain
//    float32, staged once. Expand: M = window pixels padded to 16, K = Cin
//    padded to 8 (zero rows and columns, written on every load), N = the
//    hidden chunk. Project: M = tile pixels padded to 16, K = the chunk, N
//    = Cout padded to 8. A fragments come by ldmatrix .x4 (16-byte rows of
//    floats), B fragments by 32-bit loads from the [k][n] weight rows;
//  * chunks of 24 hidden channels (24 divides every MobileNetV2 hidden
//    width): float32 doubles the window and the weights against bf16, and
//    with two weight stages a 48- or 32-channel chunk leaves no 11x11 tile
//    at Cin 160 room. At 24, one 11x11 tile of blocks 14-15 (Cin 160, Cout
//    160) takes 211,776 bytes: window 176 x 164 floats (115,456), hidden
//    chunk 176 x 24 (16,896), depthwise output 128 x 28 (14,336), two
//    stages of w1 160 x 24, w2 24 x 168, taps and biases (65,088). Block 16
//    (Cout 320: stages of 95,808) would take 242,496, over the 232,448 a
//    block may have, so its 11x11 image is two 6x11 tiles (188,992);
//  * the input window and every weight chunk go global -> shared by 16-byte
//    cp.async, zero-filled outside the image and past Cin, Ch and Cout;
//    element loads where a base or a row is not 16-byte aligned (vec). The
//    next chunk's weights load while this one computes (two stages);
//  * row strides put one fragment load's 32 lanes on distinct banks: the
//    window and the depthwise output (ldmatrix A) an odd number of 16-byte
//    units, the weights (32-bit B loads by k = lane % 4, n = lane / 4) an
//    odd multiple of 8 floats, the hidden chunk 24 floats;
//  * the expand's time is its items' chain of k-steps (Cin / 8 of them,
//    each a load, split and three mma deep): where a block has at least
//    twice as many warps as expand items (block 16's 6x11 tile: 7 items,
//    16 warps), two warps share an item, each summing half its k-steps;
//  * the hidden chunk and the depthwise stay float32 on CUDA cores, the
//    depthwise summing bias and its 9 taps in (dy, dx) order;
//  * tiles of up to 256 pixels and a warp tiling per shape, picked by
//    kernels/fused_block.py:plan_f32 (the bf16 kernel's cost model with
//    float32 sizes and three mma per product, refitted on the card); the
//    small tilings keep two blocks on an SM (kMinBlocks).

#include "fused_common.cuh"
#include "mma_tf32.cuh"

namespace {

using myt_fused::relu6;
using namespace myt_mma;

constexpr int kKc = 24;        // hidden channels per chunk (kernels/fused_block.py:F32_CHUNK)
constexpr int kHs = kKc;       // hidden row stride, floats (24: float2 writes conflict-free)
constexpr int kDs = kKc + 4;   // depthwise-output row stride, floats (7 x 16 bytes)
constexpr int kW1s = kKc;      // expand-weight row stride, floats (3 x 8)
constexpr int kMaxTile = 256;  // output pixels per block (F32_MAX_TILE)

// p / d for 0 <= p < 2^12 and 0 < d < 1024 from a reciprocal: (p + 0.5) / d
// sits at least 0.5 / d from an integer, far beyond float32's error
__device__ __forceinline__ int div_small(int p, float inv_d) {
  return __float2int_rz((static_cast<float>(p) + 0.5f) * inv_d);
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// window rows: Cin padded to 8, plus 4 floats (an odd number of 16-byte units)
__host__ __device__ constexpr int x_stride(int cin) { return round8(cin) + 4; }
// project-weight rows: an odd multiple of 8 floats holding round8(cout)
__host__ __device__ constexpr int w2_stride(int cout) { return ((round8(cout) >> 3) | 1) << 3; }

__host__ __device__ constexpr int window_rows(int stride, int th, int tw) {
  return round16((stride * (th - 1) + 3) * (stride * (tw - 1) + 3));
}

// one stage of chunk weights, floats: w1 [Cin8][kW1s], w2 [kKc][w2_stride],
// wdw [9][kKc], b1 and bdw [kKc]
__host__ __device__ constexpr int stage_floats(int cin, int cout) {
  return round8(cin) * kW1s + kKc * w2_stride(cout) + 9 * kKc + 2 * kKc;
}

// kernels/fused_block.py:_f32_smem_bytes computes the same
__host__ __device__ constexpr int f32_smem_bytes(int stride, int th, int tw, int cin, int cout) {
  const int wpp = window_rows(stride, th, tw);
  return 4 * (wpp * x_stride(cin) + wpp * kHs + round16(th * tw) * kDs +
              2 * stage_floats(cin, cout));
}

struct F32Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* wdw;
  const float* bdw;
  const float* w2;
  const float* b2;
  float* out;
  int h, w, cin, ch, cout, ho, wo, th, tw, tiles_w, residual, vec;
};

struct Stage {
  float* w1;
  float* w2;
  float* wdw;
  float* b1;
  float* bdw;
};

__device__ __forceinline__ Stage carve_stage(float* p, int cin, int cout) {
  Stage s;
  s.w1 = p;
  s.w2 = s.w1 + round8(cin) * kW1s;
  s.wdw = s.w2 + kKc * w2_stride(cout);
  s.b1 = s.wdw + 9 * kKc;
  s.bdw = s.b1 + kKc;
  return s;
}

// Stage the chunk of hidden channels [c0, c0 + kKc): w1's columns, w2's
// rows, wdw's columns, b1 and bdw. Everything past Cin, Ch or Cout is zero,
// rewritten on every load, so padded K adds nothing and a ragged last
// chunk leaves nothing stale.
template <int kThreads>
__device__ void load_stage(const Stage& s, const F32Args& a, int c0) {
  const int tid = threadIdx.x;
  const int cin8 = round8(a.cin), cout8 = round8(a.cout), w2ld = w2_stride(a.cout);
  if (a.vec) {  // Cin, Ch, Cout multiples of 4 and every pointer 16-byte aligned
    constexpr int g = kKc / 4;
    for (int i = tid; i < cin8 * g; i += kThreads) {
      const int k = i / g, q = i % g;
      const bool in = k < a.cin && c0 + q * 4 < a.ch;
      cp_async16(s.w1 + k * kW1s + q * 4, in ? a.w1 + static_cast<size_t>(k) * a.ch + c0 + q * 4 : a.w1,
                 in ? 16 : 0);
    }
    // row r, 16-byte column q of w2's chunk, stepped without a division
    const int gn = cout8 / 4, dr = kThreads / gn, dq = kThreads % gn;
    for (int r = tid / gn, q = tid % gn; r < kKc; r += dr, q += dq) {
      if (q >= gn) {
        q -= gn;
        if (++r >= kKc) break;
      }
      const bool in = c0 + r < a.ch && q * 4 < a.cout;
      cp_async16(s.w2 + r * w2ld + q * 4,
                 in ? a.w2 + static_cast<size_t>(c0 + r) * a.cout + q * 4 : a.w2, in ? 16 : 0);
    }
    for (int i = tid; i < 9 * g; i += kThreads) {
      const int t = i / g, q = i % g;
      const bool in = c0 + q * 4 < a.ch;
      cp_async16(s.wdw + t * kKc + q * 4, in ? a.wdw + t * a.ch + c0 + q * 4 : a.wdw, in ? 16 : 0);
    }
    for (int i = tid; i < 2 * g; i += kThreads) {
      const int which = i / g, q = i % g;
      const bool in = c0 + q * 4 < a.ch;
      const float* src = which ? a.bdw : a.b1;
      cp_async16((which ? s.bdw : s.b1) + q * 4, in ? src + c0 + q * 4 : src, in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < cin8 * kKc; i += kThreads) {
    const int k = i / kKc, c = i % kKc;
    s.w1[k * kW1s + c] = k < a.cin && c0 + c < a.ch ? a.w1[static_cast<size_t>(k) * a.ch + c0 + c] : 0.f;
  }
  for (int i = tid; i < kKc * cout8; i += kThreads) {
    const int r = i / cout8, co = i % cout8;
    s.w2[r * w2ld + co] =
        c0 + r < a.ch && co < a.cout ? a.w2[static_cast<size_t>(c0 + r) * a.cout + co] : 0.f;
  }
  for (int i = tid; i < 9 * kKc; i += kThreads) {
    const int t = i / kKc, c = i % kKc;
    s.wdw[i] = c0 + c < a.ch ? a.wdw[t * a.ch + c0 + c] : 0.f;
  }
  for (int i = tid; i < kKc; i += kThreads) {
    s.b1[i] = c0 + i < a.ch ? a.b1[c0 + i] : 0.f;
    s.bdw[i] = c0 + i < a.ch ? a.bdw[c0 + i] : 0.f;
  }
}

// The input window (the tile plus its 3x3 halo, S * (th - 1) + 3 rows and
// columns) as rows of Cin floats, zero outside the image, past Cin and on
// the padding rows.
template <int kThreads>
__device__ void load_window(float* xs, const float* x, const F32Args& a, int row0, int col0,
                            int win_w, int wp, int wpp) {
  const int tid = threadIdx.x, ld = x_stride(a.cin), cin8 = round8(a.cin);
  if (a.vec) {
    const int g = cin8 / 4;
    const float inv_w = 1.f / static_cast<float>(win_w);
    for (int i = tid; i < wpp * g; i += kThreads) {
      const int p = i / g, q = i % g;
      const int wy = div_small(p, inv_w);
      const int y = row0 + wy, xx = col0 + p - wy * win_w;
      const bool in = p < wp && y >= 0 && y < a.h && xx >= 0 && xx < a.w && q * 4 < a.cin;
      cp_async16(xs + p * ld + q * 4, in ? x + (static_cast<size_t>(y) * a.w + xx) * a.cin + q * 4 : x,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < wpp * cin8; i += kThreads) {
    const int p = i / cin8, c = i % cin8;
    const int y = row0 + p / win_w, xx = col0 + p % win_w;
    const bool in = p < wp && y >= 0 && y < a.h && xx >= 0 && xx < a.w && c < a.cin;
    xs[p * ld + c] = in ? x[(static_cast<size_t>(y) * a.w + xx) * a.cin + c] : 0.f;
  }
}

// the A fragment of the 16x8 tile at `p` (row-major, `ld` floats a row),
// split into tf32 hi and lo
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* p, int ld,
                                       int lane) {
  uint32_t r[4];
  ldsm_x4(r, p + ldsm_f32_row(lane) * ld + ldsm_f32_col(lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}

// the B fragment of the 8x8 tile at `p` of a [k][n] array (`ld` floats a
// row), split into tf32 hi and lo
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* p, int ld,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(p[tf32_b_k(lane, i) * ld + tf32_b_n(lane)], hi[i], lo[i]);
}

// Expand: hs[p][c] = relu6(xs[p] . w1[:, c] + b1[c]) over the window rows,
// zero where (row0 + p / win_w, col0 + p % win_w) is outside the image (the
// depthwise's zero padding belongs to the hidden tensor). A warp item is EM
// m16 tiles of rows by the chunk's three n8 tiles: each split B fragment
// serves EM products and each split A fragment three.
constexpr int kN8 = kKc / 8;

template <int EM>
__device__ __forceinline__ void expand_kstep(float (&e)[EM][kN8][4], const float* xs, int ld,
                                             const Stage& s, int m0, int mvalid, int ks, int lane) {
  uint32_t bh[kN8][2], bl[kN8][2];
#pragma unroll
  for (int j = 0; j < kN8; ++j) load_b(bh[j], bl[j], s.w1 + ks * 8 * kW1s + j * 8, kW1s, lane);
#pragma unroll
  for (int i = 0; i < EM; ++i) {
    if (i >= mvalid) break;  // uniform across the warp
    uint32_t ah[4], al[4];
    load_a(ah, al, xs + (m0 + i * 16) * ld + ks * 8, ld, lane);
#pragma unroll
    for (int j = 0; j < kN8; ++j) mma_3xtf32(e[i][j], ah, al, bh[j], bl[j]);
  }
}

// The item's sums over k-steps [k0, k1)
template <int kWarps, int EM>
__device__ __forceinline__ void expand_sums(float (&e)[EM][kN8][4], const float* xs, int ld,
                                            const Stage& s, int m0, int mvalid, int k0, int k1,
                                            int lane) {
  if constexpr (kWarps > 8) {
    // 16 warps cap a thread at 128 registers and 60 hold the project's
    // sums: no second k-step in flight
#pragma unroll 1
    for (int ks = k0; ks < k1; ++ks) expand_kstep(e, xs, ld, s, m0, mvalid, ks, lane);
  } else {
    for (int ks = k0; ks < k1; ++ks) expand_kstep(e, xs, ld, s, m0, mvalid, ks, lane);
  }
}

// The item's epilogue: bias, ReLU6 and the hidden tensor's zero padding,
// one float2 per accumulator pair
template <int EM>
__device__ __forceinline__ void expand_store(const float (&e)[EM][kN8][4], const Stage& s,
                                             float* hs, const F32Args& a, int m0, int mvalid,
                                             int row0, int col0, int win_w, int wp, int lane) {
  const float inv_w = 1.f / static_cast<float>(win_w);
  float2 bias[kN8];
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
    bias[j] = *reinterpret_cast<const float2*>(s.b1 + j * 8 + acc_col(lane, 0));
  }
#pragma unroll
  for (int i = 0; i < EM; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + i * 16 + acc_row(lane, 2 * half);
      if (i >= mvalid || p >= wp) continue;
      const int wy = div_small(p, inv_w);
      const int y = row0 + wy, xx = col0 + p - wy * win_w;
      const bool inside = y >= 0 && y < a.h && xx >= 0 && xx < a.w;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        float2 v = make_float2(0.f, 0.f);
        if (inside) {
          v.x = relu6(e[i][j][2 * half] + bias[j].x);
          v.y = relu6(e[i][j][2 * half + 1] + bias[j].y);
        }
        *reinterpret_cast<float2*>(hs + p * kHs + j * 8 + acc_col(lane, 0)) = v;
      }
    }
  }
}

template <int kWarps, int EM>
__device__ void expand(const float* xs, const Stage& s, float* hs, const F32Args& a, int row0,
                       int col0, int win_w, int wp, int wpp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = x_stride(a.cin), ksteps = round8(a.cin) / 8, mtiles = wpp / 16;
  const int items = (mtiles + EM - 1) / EM;
  if (2 * items <= kWarps && ksteps > 1) {
    // at most half the warps would have an item: two warps an item, each
    // summing half its k-steps (the chain of k-steps is what the expand's
    // time is); the second leaves its sums in the item's hidden rows, where
    // the first, whose lanes hold the same elements, adds them
    const int item = warp % items, second = warp / items, kh = ksteps / 2;
    const int m0 = item * EM * 16, mvalid = mtiles - item * EM;
    float e[EM][kN8][4] = {};
    if (warp < 2 * items) {
      expand_sums<kWarps>(e, xs, ld, s, m0, mvalid, second ? kh : 0, second ? ksteps : kh, lane);
    }
    if (second == 1) {
#pragma unroll
      for (int i = 0; i < EM; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (i >= mvalid) continue;
          const int p = m0 + i * 16 + acc_row(lane, 2 * half);
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            *reinterpret_cast<float2*>(hs + p * kHs + j * 8 + acc_col(lane, 0)) =
                make_float2(e[i][j][2 * half], e[i][j][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();
    if (second == 0) {
#pragma unroll
      for (int i = 0; i < EM; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (i >= mvalid) continue;
          const int p = m0 + i * 16 + acc_row(lane, 2 * half);
#pragma unroll
          for (int j = 0; j < kN8; ++j) {
            const float2 v = *reinterpret_cast<const float2*>(hs + p * kHs + j * 8 + acc_col(lane, 0));
            e[i][j][2 * half] += v.x;
            e[i][j][2 * half + 1] += v.y;
          }
        }
      }
      expand_store(e, s, hs, a, m0, mvalid, row0, col0, win_w, wp, lane);
    }
    return;
  }
  for (int item = warp; item < items; item += kWarps) {
    const int m0 = item * EM * 16, mvalid = mtiles - item * EM;
    float e[EM][kN8][4] = {};
    expand_sums<kWarps>(e, xs, ld, s, m0, mvalid, 0, ksteps, lane);
    expand_store(e, s, hs, a, m0, mvalid, row0, col0, win_w, wp, lane);
  }
}

__device__ __forceinline__ void fma4(float4& acc, const float4& v, const float4& w) {
  acc.x = fmaf(v.x, w.x, acc.x);
  acc.y = fmaf(v.y, w.y, acc.y);
  acc.z = fmaf(v.z, w.z, acc.z);
  acc.w = fmaf(v.w, w.w, acc.w);
}

// Depthwise 3x3 at stride S from the hidden chunk: ds[p][c] = relu6(bdw[c]
// + the 9 taps in (dy, dx) order) for every tile pixel p = (p / tw, p %
// tw), zero on the padding rows. A thread item is 4 channels of a column of
// kDwRows output pixels: it reads their (kDwRows - 1) * S + 3 input rows
// and the 9 taps once for all of them. With one row (where the project's
// sums leave no registers) each tap and its input are read where they are
// used.
template <int S, int kThreads, int kDwRows>
__device__ void depthwise(const float* hs, const Stage& s, float* ds, int win_w, int th, int tw) {
  constexpr int q4 = kKc / 4, kIn = (kDwRows - 1) * S + 3;
  const int tp = th * tw, tpp = round16(tp), strips = (th + kDwRows - 1) / kDwRows;
  for (int i = threadIdx.x; i < (tpp - tp) * q4; i += kThreads) {
    *reinterpret_cast<float4*>(ds + (tp + i / q4) * kDs + (i % q4) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int item = threadIdx.x; item < strips * tw * q4; item += kThreads) {
    const int c = (item % q4) * 4, col = (item / q4) % tw, oy0 = (item / q4 / tw) * kDwRows;
    const int rows = th - oy0 < kDwRows ? th - oy0 : kDwRows;
    const float4 bias = *reinterpret_cast<const float4*>(s.bdw + c);
    float4 acc[kDwRows];
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) acc[i] = bias;
    const float* h = hs + (oy0 * S * win_w + col * S) * kHs + c;
    if constexpr (kDwRows == 1) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        fma4(acc[0], *reinterpret_cast<const float4*>(h + ((t / 3) * win_w + t % 3) * kHs),
             *reinterpret_cast<const float4*>(s.wdw + t * kKc + c));
      }
    } else {
      float4 wq[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wq[t] = *reinterpret_cast<const float4*>(s.wdw + t * kKc + c);
      // input row r feeds output row i at dy = r - i * S; each output still
      // sums its taps in (dy, dx) order, as r rises
#pragma unroll
      for (int r = 0; r < kIn; ++r) {
        if (r > (rows - 1) * S + 2) break;
        float4 v[3];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[dx] = *reinterpret_cast<const float4*>(h + (r * win_w + dx) * kHs);
#pragma unroll
        for (int i = 0; i < kDwRows; ++i) {
          const int dy = r - i * S;
          if (dy < 0 || dy > 2 || i >= rows) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) fma4(acc[i], v[dx], wq[dy * 3 + dx]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) {
      if (i >= rows) continue;
      *reinterpret_cast<float4*>(ds + ((oy0 + i) * tw + col) * kDs + c) =
          make_float4(relu6(acc[i].x), relu6(acc[i].y), relu6(acc[i].z), relu6(acc[i].w));
    }
  }
}

// The chunk's share of the project: acc[i][j] (m16 tile mt0 + i, n8 tile
// nt0 + j) += ds . w2s over the chunk's 24 channels. Tiles past the tile's
// rows or Cout are skipped (the test is uniform across the warp).
template <int MW, int NW>
__device__ __forceinline__ void project(const float* ds, const Stage& s, int w2ld, int mt0, int nt0,
                                        int mtiles, int ntiles, float (&acc)[MW][NW][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKc / 8; ++ks) {
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (nt0 + j < ntiles) load_b(bh[j], bl[j], s.w2 + ks * 8 * w2ld + (nt0 + j) * 8, w2ld, lane);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= mtiles) continue;
      uint32_t ah[4], al[4];
      load_a(ah, al, ds + (mt0 + i) * 16 * kDs + ks * 8, kDs, lane);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (nt0 + j < ntiles) mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
  }
}

// Per instance, as in fused_block_bf16.cu: the small project tilings keep a
// thread at 128 registers so two blocks share an SM; 16 warps are capped at
// 128 registers by their size, 60 of them the project's sums. The expand
// takes 32x24 items on 8 warps and 16x24 on 16; the depthwise takes 4-row
// columns at stride 1 with the fewest sums, else 2, and single rows on 16
// warps.
template <int MW, int NW, int kWarps>
constexpr int kMinBlocks = kWarps == 8 && MW * NW <= 8 ? 2 : 1;

template <int S, int MW, int NW, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, (kMinBlocks<MW, NW, kWarps>))
    fused_block_f32_kernel(F32Args a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kExpandM = kWarps == 8 ? 2 : 1;
  constexpr int kDwRows = kWarps > 8 ? 1 : S == 1 && MW * NW <= 6 ? 4 : 2;
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int oy0 = (blockIdx.x / a.tiles_w) * a.th, ox0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int win_w = S * (a.tw - 1) + 3;
  const int wp = (S * (a.th - 1) + 3) * win_w, wpp = round16(wp);
  const int tp = a.th * a.tw;
  const int row0 = oy0 * S - 1, col0 = ox0 * S - 1;  // window origin in the input

  float* xs = myt_fused::dynamic_smem();  // [wpp][x_stride]
  float* hs = xs + wpp * x_stride(a.cin);  // [wpp][kHs]
  float* ds = hs + wpp * kHs;              // [tpp][kDs]
  float* stages = ds + round16(tp) * kDs;
  const int sfloats = stage_floats(a.cin, a.cout);  // two stages follow

  const float* x = a.x + static_cast<size_t>(b) * a.h * a.w * a.cin;
  load_window<kThreads>(xs, x, a, row0, col0, win_w, wp, wpp);
  load_stage<kThreads>(carve_stage(stages, a.cin, a.cout), a, 0);
  cp_async_commit();

  // the project's warp grid: wn_count warps along Cout, NW n8 tiles each;
  // MW m16 tiles of pixels each along the rows (the host checks it covers)
  const int mtiles = round16(tp) / 16, ntiles = round8(a.cout) / 8;
  const int wn_count = (ntiles + NW - 1) / NW;
  const int wm = warp / wn_count, wn = warp % wn_count;
  const bool projects = wm < kWarps / wn_count;
  const int w2ld = w2_stride(a.cout);

  float acc[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
  }

  // three barriers a chunk: after the first, chunk c has landed for every
  // thread and every warp has left the project of chunk c - 1, so the
  // other stage takes chunk c + 1 while this one computes; the expand's
  // writes to hs wait for the depthwise of c - 1 behind it, and the
  // depthwise's writes to ds for the project of c - 1
  const int chunks = (a.ch + kKc - 1) / kKc;
  for (int c = 0; c < chunks; ++c) {
    const Stage s = carve_stage(stages + (c & 1) * sfloats, a.cin, a.cout);
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < chunks) {
      load_stage<kThreads>(carve_stage(stages + ((c + 1) & 1) * sfloats, a.cin, a.cout), a,
                           (c + 1) * kKc);
      cp_async_commit();
    }
    expand<kWarps, kExpandM>(xs, s, hs, a, row0, col0, win_w, wp, wpp);
    __syncthreads();
    depthwise<S, kThreads, kDwRows>(hs, s, ds, win_w, a.th, a.tw);
    __syncthreads();
    if (projects) project<MW, NW>(ds, s, w2ld, wm * MW, wn * NW, mtiles, ntiles, acc);
  }
  if (!projects) return;

  // bias, residual (read from the staged window: Cin == Cout), one write
  const int xld = x_stride(a.cin);
  float* out = a.out + static_cast<size_t>(b) * a.ho * a.wo * a.cout;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int mt = wm * MW + i, nt = wn * NW + j;
      if (mt >= mtiles || nt >= ntiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + acc_row(lane, 2 * half);
        const int co = nt * 8 + acc_col(lane, 2 * half);
        if (p >= tp || co >= a.cout) continue;
        const int ly = p / a.tw, lx = p % a.tw;
        const int oy = oy0 + ly, ox = ox0 + lx;
        if (oy >= a.ho || ox >= a.wo) continue;
        const bool pair = co + 1 < a.cout;
        float v0 = acc[i][j][2 * half] + a.b2[co];
        float v1 = pair ? acc[i][j][2 * half + 1] + a.b2[co + 1] : 0.f;
        if (a.residual) {
          const float* r = xs + ((ly + 1) * win_w + lx + 1) * xld + co;
          v0 += r[0];
          if (pair) v1 += r[1];
        }
        float* o = out + (static_cast<size_t>(oy) * a.wo + ox) * a.cout + co;
        if (pair && (a.cout & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (pair) o[1] = v1;
        }
      }
    }
  }
}

// Host side.

template <int S, int MW, int NW, int W>
int launch(const F32Args& a, dim3 grid, int smem, cudaStream_t stream) {
  const int ntiles = round8(a.cout) / 8, mtiles = round16(a.th * a.tw) / 16;
  const int wn_count = (ntiles + NW - 1) / NW;
  if (wn_count > W || (W / wn_count) * MW < mtiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_block_f32_kernel<S, MW, NW, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_f32_kernel<S, MW, NW, W><<<grid, W * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated (MW, NW, warps): kernels/fused_block.py:F32_CONFIGS
template <int S>
int launch_config(const F32Args& a, dim3 grid, int smem, cudaStream_t stream, int mw, int nw,
                  int warps) {
#define MYT_CONFIG(M, N, W) \
  if (mw == M && nw == N && warps == W) return launch<S, M, N, W>(a, grid, smem, stream);
  MYT_CONFIG(1, 3, 8)
  MYT_CONFIG(2, 3, 8)
  MYT_CONFIG(1, 4, 8)
  MYT_CONFIG(2, 4, 8)
  MYT_CONFIG(4, 3, 8)
  MYT_CONFIG(3, 5, 8)
  MYT_CONFIG(3, 5, 16)
#undef MYT_CONFIG
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success). The
// caller checks shapes and picks the plan: th x tw is the output tile (at
// most 256 pixels), (mw, nw, warps) an instantiated project warp tiling
// that covers it; vec says Cin, Ch and Cout are multiples of 4 and every
// pointer is 16-byte aligned (16-byte cp.async; else element loads).
// Float32 tensors only.
extern "C" int myt_fused_block(const void* x, const void* w1, const float* b1, const void* wdw,
                               const float* bdw, const void* w2, const float* b2, void* out,
                               int batch, int h, int w, int cin, int ch, int cout, int stride,
                               int residual, int th, int tw, int mw, int nw, int warps, int vec,
                               void* stream) {
  if ((stride != 1 && stride != 2) || th < 1 || tw < 1 || th * tw > kMaxTile ||
      (residual && (stride != 1 || cin != cout))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = h / stride, wo = w / stride;
  const int tiles_h = (ho + th - 1) / th, tiles_w = (wo + tw - 1) / tw;
  const F32Args a{static_cast<const float*>(x), static_cast<const float*>(w1), b1,
                  static_cast<const float*>(wdw), bdw, static_cast<const float*>(w2), b2,
                  static_cast<float*>(out), h, w, cin, ch, cout, ho, wo, th, tw, tiles_w,
                  residual, vec};
  const dim3 grid(tiles_h * tiles_w, batch);
  const int smem = f32_smem_bytes(stride, th, tw, cin, cout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_config<1>(a, grid, smem, st, mw, nw, warps)
                     : launch_config<2>(a, grid, smem, st, mw, nw, warps);
}
