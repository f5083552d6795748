// Fused MobileNetV2 inverted-residual block (BatchNorm folded) in bf16 on
// Hopper's tensor cores (sm_90a): 1x1 expand + bias, ReLU6, depthwise 3x3
// (stride 1 or 2) + bias, ReLU6, 1x1 project + bias, optional residual,
// with the hidden tensor never written to device memory.
//
// Replaces, for bf16 activations, mobilenet_yolo_tpu/kernels/pallas_fused.py
// :131 (fused_inverted_residual, body _fused_block_kernel) and :228
// (fused_inverted_residual_s2, body _fused_block_s2_kernel); float32 stays
// on fused_block.cu. Same contract: x (B, H, W, Cin) NHWC, w1 (Cin, Ch), wdw
// (3, 3, Ch), w2 (Ch, Cout) in bf16, float32 biases; out (B, H/S, W/S, Cout)
// in bf16. The rounding points are the Pallas kernel's: bf16 operands into
// the expand with float32 sums, a float32 hidden tensor and depthwise, the
// depthwise output rounded to bf16 as the project's operand, float32 sums of
// the project, bias and residual, one rounding of the output.
//
// What bounds it. In bf16 a block does 106-920 FLOP per byte of its input
// and output (PERF.md), against the tensor cores' balance of 295: the
// bound is HBM's bytes at the 88x88 and 44x44 blocks and the operations at
// 22x22 and 11x11. At 11x11 (and 22x22) an image is one to four tiles, a
// batch of 128 gives a few hundred blocks for 132 SMs, each walks 8-20
// hidden chunks in a dependent chain of loads, products and barriers, and
// each tile pulls the whole w1 and w2 through L2: bound by latency and
// occupancy. Measured, latency binds at every shape (the time falls with
// the blocks resident on an SM, not with the operations).
//
// What the design does about it:
//  * both 1x1 products are mma.sync.m16n8k16 (bf16 in, float32 sums) fed by
//    ldmatrix from shared memory. Expand: M = window pixels padded to 16, K =
//    Cin padded to 16 (zero rows and columns, written on every load), N = a
//    chunk of 48 hidden channels (48 = 3 x 16 divides every MobileNetV2
//    hidden width). Project: M = tile pixels padded to 16, K = the chunk, N =
//    Cout padded to 8. mma.sync and not wgmma: wgmma wants 64-row operands
//    in its own swizzled layouts, while M here is 48-576 window or tile
//    pixels and the project's warp grid changes shape with Cout (24-320).
//    The kernel is far from the tensor-core rate (PERF.md), so the simpler
//    instruction costs nothing measurable yet;
//  * the input window and every weight chunk are staged as bf16 with 16-byte
//    cp.async (zero fill outside the image and past Cin, Ch and Cout): no
//    float32 copies. The next chunk's weights load while this one computes
//    (two stages);
//  * row strides are an odd number of 16-byte units, so the 8 rows of an
//    ldmatrix fall on distinct banks;
//  * the hidden chunk stays float32 in shared memory, as the Pallas kernel
//    keeps it; the depthwise runs on CUDA cores in float32 from it and
//    rounds its output to bf16 as the project's A operand;
//  * tiles of up to 256 pixels and a warp tiling per shape, picked by
//    kernels/fused_block.py:plan_bf16, whose cost model (fitted to the
//    card) counts the weights restaged per tile, shared memory, accumulator
//    registers, resident blocks and waves: an 11x11 image is one or two
//    tiles, and the small tilings keep two blocks on an SM (kMinBlocks);
//    16 warps where a wide Cout needs them at 60 accumulators a thread.

#include "fused_common.cuh"
#include "mma_bf16.cuh"

namespace {

using myt_fused::relu6;
using namespace myt_mma;
using bf16 = __nv_bfloat16;

constexpr int kKc = 48;          // hidden channels per chunk (kernels/fused_block.py:BF16_CHUNK)
constexpr int kHs = kKc + 8;     // hidden row stride, floats
constexpr int kDs = kKc + 8;     // depthwise-output row stride, bf16 (7 x 16 bytes)
constexpr int kW1s = kKc + 8;    // expand-weight row stride, bf16 (7 x 16 bytes)
constexpr int kMaxTile = 256;    // output pixels per block (BF16_MAX_TILE)

// p / d for 0 <= p < 2^12 and 0 < d < 1024 from a reciprocal: (p + 0.5) / d
// sits at least 0.5 / d from an integer, far beyond float32's error
__device__ __forceinline__ int div_small(int p, float inv_d) {
  return __float2int_rz((static_cast<float>(p) + 0.5f) * inv_d);
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// a bf16 row stride of an odd number of 16-byte units, at least n values
__host__ __device__ constexpr int odd_stride(int n) { return ((round8(n) >> 3) | 1) << 3; }

__host__ __device__ constexpr int x_stride(int cin) { return odd_stride(round16(cin)); }
__host__ __device__ constexpr int w2_stride(int cout) { return odd_stride(cout); }

__host__ __device__ constexpr int window_rows(int stride, int th, int tw) {
  return round16((stride * (th - 1) + 3) * (stride * (tw - 1) + 3));
}

// one stage of chunk weights: w1 [Cin16][kW1s], w2 [kKc][w2_stride],
// wdw [9][kKc] bf16; b1, bdw [kKc] float32
__host__ __device__ constexpr int stage_bytes(int cin, int cout) {
  return 2 * (round16(cin) * kW1s + kKc * w2_stride(cout) + 9 * kKc) + 4 * 2 * kKc;
}

// kernels/fused_block.py:_bf16_smem_bytes computes the same
__host__ __device__ constexpr int bf16_smem_bytes(int stride, int th, int tw, int cin, int cout) {
  const int wpp = window_rows(stride, th, tw);
  return 2 * wpp * x_stride(cin) + 4 * wpp * kHs + 2 * round16(th * tw) * kDs +
         2 * stage_bytes(cin, cout);
}

struct Bf16Args {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* wdw;
  const float* bdw;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int h, w, cin, ch, cout, ho, wo, th, tw, tiles_w, residual, vec;
};

struct Stage {
  bf16* w1;
  bf16* w2;
  bf16* wdw;
  float* b1;
  float* bdw;
};

__device__ __forceinline__ Stage carve_stage(unsigned char* p, int cin, int cout) {
  Stage s;
  s.w1 = reinterpret_cast<bf16*>(p);
  s.w2 = s.w1 + round16(cin) * kW1s;
  s.wdw = s.w2 + kKc * w2_stride(cout);
  s.b1 = reinterpret_cast<float*>(s.wdw + 9 * kKc);
  s.bdw = s.b1 + kKc;
  return s;
}

// Stage the chunk of hidden channels [c0, c0 + kKc): w1's columns, w2's
// rows, wdw's columns, b1 and bdw. Everything past Cin, Ch or Cout is zero,
// rewritten on every load, so padded K adds nothing and a ragged last
// chunk leaves nothing stale.
template <int kThreads>
__device__ void load_stage(const Stage& s, const Bf16Args& a, int c0) {
  const int tid = threadIdx.x;
  const int cin16 = round16(a.cin), cout8 = round8(a.cout);
  if (a.vec) {  // Cin, Ch, Cout multiples of 8 and every pointer 16-byte aligned
    constexpr int g = kKc / 8;
    for (int i = tid; i < cin16 * g; i += kThreads) {
      const int k = i / g, q = i % g;
      const bool in = k < a.cin && c0 + q * 8 < a.ch;
      cp_async16(s.w1 + k * kW1s + q * 8, in ? a.w1 + static_cast<size_t>(k) * a.ch + c0 + q * 8 : a.w1,
                 in ? 16 : 0);
    }
    // row r, 16-byte column q of w2's chunk, stepped without a division
    const int gn = cout8 / 8, dr = kThreads / gn, dq = kThreads % gn;
    for (int r = tid / gn, q = tid % gn; r < kKc; r += dr, q += dq) {
      if (q >= gn) {
        q -= gn;
        if (++r >= kKc) break;
      }
      const bool in = c0 + r < a.ch;
      cp_async16(s.w2 + r * w2_stride(a.cout) + q * 8,
                 in ? a.w2 + static_cast<size_t>(c0 + r) * a.cout + q * 8 : a.w2, in ? 16 : 0);
    }
    for (int i = tid; i < 9 * g; i += kThreads) {
      const int t = i / g, q = i % g;
      const bool in = c0 + q * 8 < a.ch;
      cp_async16(s.wdw + t * kKc + q * 8, in ? a.wdw + t * a.ch + c0 + q * 8 : a.wdw, in ? 16 : 0);
    }
    for (int i = tid; i < 2 * (kKc / 4); i += kThreads) {
      const int which = i / (kKc / 4), q = i % (kKc / 4);
      const bool in = c0 + q * 4 < a.ch;
      const float* src = which ? a.bdw : a.b1;
      cp_async16((which ? s.bdw : s.b1) + q * 4, in ? src + c0 + q * 4 : src, in ? 16 : 0);
    }
    return;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < cin16 * kKc; i += kThreads) {
    const int k = i / kKc, c = i % kKc;
    s.w1[k * kW1s + c] = k < a.cin && c0 + c < a.ch ? a.w1[static_cast<size_t>(k) * a.ch + c0 + c] : zero;
  }
  for (int i = tid; i < kKc * cout8; i += kThreads) {
    const int r = i / cout8, co = i % cout8;
    s.w2[r * w2_stride(a.cout) + co] =
        c0 + r < a.ch && co < a.cout ? a.w2[static_cast<size_t>(c0 + r) * a.cout + co] : zero;
  }
  for (int i = tid; i < 9 * kKc; i += kThreads) {
    const int t = i / kKc, c = i % kKc;
    s.wdw[i] = c0 + c < a.ch ? a.wdw[t * a.ch + c0 + c] : zero;
  }
  for (int i = tid; i < kKc; i += kThreads) {
    s.b1[i] = c0 + i < a.ch ? a.b1[c0 + i] : 0.f;
    s.bdw[i] = c0 + i < a.ch ? a.bdw[c0 + i] : 0.f;
  }
}

// The input window (the tile plus its 3x3 halo, S * (th - 1) + 3 rows and
// columns) as rows of Cin bf16, zero outside the image, past Cin and on the
// padding rows.
template <int kThreads>
__device__ void load_window(bf16* xs, const bf16* x, const Bf16Args& a, int row0, int col0,
                            int win_w, int wp, int wpp) {
  const int tid = threadIdx.x, ld = x_stride(a.cin), cin16 = round16(a.cin);
  if (a.vec) {
    const int g = cin16 / 8;
    const float inv_w = 1.f / static_cast<float>(win_w);
    for (int i = tid; i < wpp * g; i += kThreads) {
      const int p = i / g, q = i % g;
      const int wy = div_small(p, inv_w);
      const int y = row0 + wy, xx = col0 + p - wy * win_w;
      const bool in = p < wp && y >= 0 && y < a.h && xx >= 0 && xx < a.w && q * 8 < a.cin;
      cp_async16(xs + p * ld + q * 8, in ? x + (static_cast<size_t>(y) * a.w + xx) * a.cin + q * 8 : x,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < wpp * cin16; i += kThreads) {
    const int p = i / cin16, c = i % cin16;
    const int y = row0 + p / win_w, xx = col0 + p % win_w;
    const bool in = p < wp && y >= 0 && y < a.h && xx >= 0 && xx < a.w && c < a.cin;
    xs[p * ld + c] = in ? x[(static_cast<size_t>(y) * a.w + xx) * a.cin + c] : __float2bfloat16_rn(0.f);
  }
}

// Expand: hs[p][c] = relu6(xs[p] . w1[:, c] + b1[c]) over the window rows,
// zero where (row0 + p / win_w, col0 + p % win_w) is outside the image (the
// depthwise's zero padding belongs to the hidden tensor). A warp item is EM
// m16 tiles of rows by EN n8 tiles of the chunk: each B fragment serves EM
// products and each A fragment EN, which is what the expand's ldmatrix
// traffic through shared memory costs.
template <int EM, int EN>
__device__ __forceinline__ void expand_kstep(float (&e)[EM][EN][4], const bf16* xs, int ld,
                                             const Stage& s, int m0, int mvalid, int n0, int ks,
                                             int lane) {
  uint32_t bq[EN][2];
  const bf16* wb = s.w1 + (ks * 16 + ldsm_row(lane)) * kW1s + n0;
#pragma unroll
  for (int j = 0; j + 1 < EN; j += 2) {
    uint32_t r[4];
    ldsm_x4_trans(r, wb + j * 8 + ldsm_col(lane));
    bq[j][0] = r[0];
    bq[j][1] = r[1];
    bq[j + 1][0] = r[2];
    bq[j + 1][1] = r[3];
  }
  if (EN & 1) ldsm_x2_trans(bq[EN - 1], wb + (EN - 1) * 8);
#pragma unroll
  for (int i = 0; i < EM; ++i) {
    if (i >= mvalid) break;  // uniform across the warp
    uint32_t af[4];
    ldsm_x4(af, xs + (m0 + i * 16 + ldsm_row(lane)) * ld + ks * 16 + ldsm_col(lane));
#pragma unroll
    for (int j = 0; j < EN; ++j) mma_bf16(e[i][j], af, bq[j][0], bq[j][1]);
  }
}

template <int kWarps, int EM, int EN>
__device__ void expand(const bf16* xs, const Stage& s, float* hs, const Bf16Args& a, int row0,
                       int col0, int win_w, int wp, int wpp) {
  constexpr int n_items = kKc / (8 * EN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = x_stride(a.cin), ksteps = round16(a.cin) / 16, mtiles = wpp / 16;
  const float inv_w = 1.f / static_cast<float>(win_w);
  for (int item = warp; item < (mtiles + EM - 1) / EM * n_items; item += kWarps) {
    const int m0 = (item / n_items) * EM * 16, n0 = (item % n_items) * EN * 8;
    const int mvalid = mtiles - m0 / 16;
    float e[EM][EN][4] = {};
    float2 bias[EN];
#pragma unroll
    for (int j = 0; j < EN; ++j) {
      bias[j] = *reinterpret_cast<const float2*>(s.b1 + n0 + j * 8 + acc_col(lane, 0));
    }
    if constexpr (kWarps > 8) {
      // 16 warps cap a thread at 128 registers and 60 hold the project's
      // sums: no second k-step in flight
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) expand_kstep(e, xs, ld, s, m0, mvalid, n0, ks, lane);
    } else {
      for (int ks = 0; ks < ksteps; ++ks) expand_kstep(e, xs, ld, s, m0, mvalid, n0, ks, lane);
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
        for (int j = 0; j < EN; ++j) {
          float2 v = make_float2(0.f, 0.f);
          if (inside) {
            v.x = relu6(e[i][j][2 * half] + bias[j].x);
            v.y = relu6(e[i][j][2 * half + 1] + bias[j].y);
          }
          *reinterpret_cast<float2*>(hs + p * kHs + n0 + j * 8 + acc_col(lane, 0)) = v;
        }
      }
    }
  }
}

// Depthwise 3x3 at stride S in float32 from the hidden chunk, + bias, ReLU6,
// rounded to bf16: ds[p][c] for every tile pixel p = (p / tw, p % tw),
// zero on the padding rows. A thread item is 4 channels of a column of
// kDwRows output pixels: it reads their (kDwRows - 1) * S + 3 input rows
// and the 9 taps once for all of them (shared-memory reads are what the
// depthwise costs), and sums each output's taps in (dy, dx) order. With
// one row (where the project's sums leave no registers) each tap and its
// input are read where they are used.
template <int S, int kThreads, int kDwRows>
__device__ void depthwise(const float* hs, const Stage& s, bf16* ds, int win_w, int th, int tw) {
  constexpr int q4 = kKc / 4, kIn = (kDwRows - 1) * S + 3;
  const int tp = th * tw, tpp = round16(tp), strips = (th + kDwRows - 1) / kDwRows;
  for (int i = threadIdx.x; i < (tpp - tp) * q4; i += kThreads) {
    *reinterpret_cast<uint2*>(ds + (tp + i / q4) * kDs + (i % q4) * 4) = make_uint2(0u, 0u);
  }
  for (int item = threadIdx.x; item < strips * tw * q4; item += kThreads) {
    const int c = (item % q4) * 4, col = (item / q4) % tw, oy0 = (item / q4 / tw) * kDwRows;
    const int rows = th - oy0 < kDwRows ? th - oy0 : kDwRows;
    uint2 wq[9];
    if constexpr (kDwRows > 1) {
#pragma unroll
      for (int t = 0; t < 9; ++t) wq[t] = *reinterpret_cast<const uint2*>(s.wdw + t * kKc + c);
    }
    float4 acc[kDwRows];
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* h = hs + (oy0 * S * win_w + col * S) * kHs + c;
    if constexpr (kDwRows == 1) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(h + ((t / 3) * win_w + t % 3) * kHs);
        const uint2 w = *reinterpret_cast<const uint2*>(s.wdw + t * kKc + c);
        const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
        const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
        acc[0].x = fmaf(v.x, w01.x, acc[0].x);
        acc[0].y = fmaf(v.y, w01.y, acc[0].y);
        acc[0].z = fmaf(v.z, w23.x, acc[0].z);
        acc[0].w = fmaf(v.w, w23.y, acc[0].w);
      }
    }
#pragma unroll
    for (int r = 0; r < (kDwRows == 1 ? 0 : kIn); ++r) {
      if (r > (rows - 1) * S + 2) break;
      float4 v[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) v[dx] = *reinterpret_cast<const float4*>(h + (r * win_w + dx) * kHs);
#pragma unroll
      for (int i = 0; i < kDwRows; ++i) {
        const int dy = r - i * S;
        if (dy < 0 || dy > 2 || i >= rows) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint2 w = wq[dy * 3 + dx];
          const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          acc[i].x = fmaf(v[dx].x, w01.x, acc[i].x);
          acc[i].y = fmaf(v[dx].y, w01.y, acc[i].y);
          acc[i].z = fmaf(v[dx].z, w23.x, acc[i].z);
          acc[i].w = fmaf(v[dx].w, w23.y, acc[i].w);
        }
      }
    }
    const float4 bias = *reinterpret_cast<const float4*>(s.bdw + c);
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) {
      if (i >= rows) continue;
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(relu6(acc[i].x + bias.x), relu6(acc[i].y + bias.y));
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(relu6(acc[i].z + bias.z), relu6(acc[i].w + bias.w));
      *reinterpret_cast<uint2*>(ds + ((oy0 + i) * tw + col) * kDs + c) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// The chunk's share of the project: acc[i][j] (m16 tile mt0 + i, n8 tile
// nt0 + j) += ds . w2s over the chunk's 48 channels. Tiles past the tile's
// rows or Cout are skipped (the test is uniform across the warp).
template <int MW, int NW>
__device__ __forceinline__ void project(const bf16* ds, const Stage& s, int w2ld, int mt0, int nt0,
                                        int mtiles, int ntiles, float (&acc)[MW][NW][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKc / 16; ++ks) {
    uint32_t bf[NW][2];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (nt0 + j < ntiles) {
        ldsm_x2_trans(bf[j], s.w2 + (ks * 16 + ldsm_row(lane)) * w2ld + (nt0 + j) * 8);
      }
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= mtiles) continue;
      uint32_t af[4];
      ldsm_x4(af, ds + ((mt0 + i) * 16 + ldsm_row(lane)) * kDs + ks * 16 + ldsm_col(lane));
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (nt0 + j < ntiles) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
}

// Per instance: the small project tilings keep a thread at 128 registers
// so two blocks share an SM, and take 32x24 expand items; (4, 3) and
// (3, 5) on 8 warps run one block an SM and take 32x48 items (half the
// operand traffic per product); 16 warps are capped at 128 registers by
// their size, 60 of them the project's sums, and take 16x24 items. The
// depthwise takes 4-row columns at stride 1 with the fewest sums, else 2,
// and single rows on 16 warps.
template <int MW, int NW, int kWarps>
constexpr int kMinBlocks = kWarps == 8 && MW * NW <= 8 ? 2 : 1;

template <int S, int MW, int NW, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, (kMinBlocks<MW, NW, kWarps>))
    fused_block_bf16_kernel(Bf16Args a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kExpandM = kWarps == 8 ? 2 : 1, kExpandN = kWarps == 8 && MW * NW > 8 ? 6 : 3;
  constexpr int kDwRows = kWarps > 8 ? 1 : S == 1 && MW * NW <= 6 ? 4 : 2;
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int oy0 = (blockIdx.x / a.tiles_w) * a.th, ox0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int win_w = S * (a.tw - 1) + 3;
  const int wp = (S * (a.th - 1) + 3) * win_w, wpp = round16(wp);
  const int tp = a.th * a.tw;
  const int row0 = oy0 * S - 1, col0 = ox0 * S - 1;  // window origin in the input

  unsigned char* smem = reinterpret_cast<unsigned char*>(myt_fused::dynamic_smem());
  bf16* xs = reinterpret_cast<bf16*>(smem);                         // [wpp][x_stride]
  float* hs = reinterpret_cast<float*>(xs + wpp * x_stride(a.cin));  // [wpp][kHs]
  bf16* ds = reinterpret_cast<bf16*>(hs + wpp * kHs);                // [tpp][kDs]
  unsigned char* stages = reinterpret_cast<unsigned char*>(ds + round16(tp) * kDs);
  const int sbytes = stage_bytes(a.cin, a.cout);  // two stages follow

  const bf16* x = a.x + static_cast<size_t>(b) * a.h * a.w * a.cin;
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
    const Stage s = carve_stage(stages + (c & 1) * sbytes, a.cin, a.cout);
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < chunks) {
      load_stage<kThreads>(carve_stage(stages + ((c + 1) & 1) * sbytes, a.cin, a.cout), a,
                           (c + 1) * kKc);
      cp_async_commit();
    }
    expand<kWarps, kExpandM, kExpandN>(xs, s, hs, a, row0, col0, win_w, wp, wpp);
    __syncthreads();
    depthwise<S, kThreads, kDwRows>(hs, s, ds, win_w, a.th, a.tw);
    __syncthreads();
    if (projects) project<MW, NW>(ds, s, w2ld, wm * MW, wn * NW, mtiles, ntiles, acc);
  }
  if (!projects) return;

  // bias, residual (read from the staged window: Cin == Cout), one rounding
  const int xld = x_stride(a.cin);
  bf16* out = a.out + static_cast<size_t>(b) * a.ho * a.wo * a.cout;
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
          const bf16* r = xs + ((ly + 1) * win_w + lx + 1) * xld + co;
          v0 += __bfloat162float(r[0]);
          if (pair) v1 += __bfloat162float(r[1]);
        }
        bf16* o = out + (static_cast<size_t>(oy) * a.wo + ox) * a.cout + co;
        if (pair && (a.cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (pair) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Host side.

template <int S, int MW, int NW, int W>
int launch(const Bf16Args& a, dim3 grid, int smem, cudaStream_t stream) {
  const int ntiles = round8(a.cout) / 8, mtiles = round16(a.th * a.tw) / 16;
  const int wn_count = (ntiles + NW - 1) / NW;
  if (wn_count > W || (W / wn_count) * MW < mtiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_block_bf16_kernel<S, MW, NW, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_bf16_kernel<S, MW, NW, W><<<grid, W * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated (MW, NW, warps): kernels/fused_block.py:BF16_CONFIGS
template <int S>
int launch_config(const Bf16Args& a, dim3 grid, int smem, cudaStream_t stream, int mw, int nw,
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
// that covers it; vec says Cin, Ch and Cout are multiples of 8 and every
// pointer is 16-byte aligned (16-byte cp.async; else element loads).
extern "C" int myt_fused_block_bf16(const void* x, const void* w1, const float* b1, const void* wdw,
                                    const float* bdw, const void* w2, const float* b2, void* out,
                                    int batch, int h, int w, int cin, int ch, int cout, int stride,
                                    int residual, int th, int tw, int mw, int nw, int warps,
                                    int vec, void* stream) {
  if ((stride != 1 && stride != 2) || th < 1 || tw < 1 || th * tw > kMaxTile ||
      (residual && (stride != 1 || cin != cout))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = h / stride, wo = w / stride;
  const int tiles_h = (ho + th - 1) / th, tiles_w = (wo + tw - 1) / tw;
  const Bf16Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                   static_cast<const bf16*>(wdw), bdw, static_cast<const bf16*>(w2), b2,
                   static_cast<bf16*>(out), h, w, cin, ch, cout, ho, wo, th, tw, tiles_w,
                   residual, vec};
  const dim3 grid(tiles_h * tiles_w, batch);
  const int smem = bf16_smem_bytes(stride, th, tw, cin, cout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_config<1>(a, grid, smem, st, mw, nw, warps)
                     : launch_config<2>(a, grid, smem, st, mw, nw, warps);
}
