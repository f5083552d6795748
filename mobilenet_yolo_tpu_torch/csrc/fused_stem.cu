// Fused MobileNetV2 stem and block 0 (BatchNorm folded) on Hopper's tensor
// cores (sm_90a): 3x3/s2 RGB conv (pad 1) + bias, ReLU6, block 0's
// depthwise 3x3 stride 1 + bias, ReLU6, 1x1 project + bias. Block 0 has
// expand ratio 1, so the stem's output is its hidden tensor, and it never
// reaches device memory.
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_fused.py:fused_stem_block0
// (bodies _fused_stem_kernel and _stem_w4). Same contract: x (B, H, W, 3)
// NHWC with H and W even, k_stem (3, 3, 3, Ch) HWIO, wdw (3, 3, Ch), w2
// (Ch, Cout), float32 biases; out (B, H/2, W/2, Cout) in x's type. The
// rounding points are the Pallas kernel's (:284-330): the stem from x and
// k_stem with float32 sums (in bf16 the products are exact), a float32
// hidden tensor and depthwise, the depthwise output rounded to x's type as
// the project's operand, float32 project sums and bias, one rounding of the
// output. In float32 both products run as three TF32 passes
// (mma_tf32.cuh:mma_3xtf32), float32-accurate whatever
// torch.backends.cuda.matmul.allow_tf32 says: the kernel never reads it.
//
// The TPU kernel folded the stride into a space-to-depth relayout and four
// shifted K=12 matmuls (K padded to 48 here); this kernel computes the stem
// as one implicit GEMM over the tile's hidden window instead: M = window
// pixels padded to 16, K = the 27 taps in (ky, kx, c) order padded to 32,
// N = a chunk of 32 hidden channels. In NHWC with 3 channels the 9 taps
// (kx, c) of one kernel row are 9 consecutive values of the input row
// (3 * (2 * hx + kx) + c = 6 * hx + j), so an A element is
// xs[2 * hy + ky][6 * hx + j]: the fragments are loaded element by element
// through the fragment maps from the staged input window (ldmatrix cannot
// read a stride-2 window), with no im2col copy.
//
// What bounds it. At batch 128, 352x352 the launch moves 444 MB (float32;
// 222 MB in bf16) and does 13.2 GFLOP of useful work: bytes bind in bf16
// (0.066 ms at 3.35 TB/s against 0.013 ms of bf16 tensor-core time) and in
// float32 (0.133 ms, against 0.074 ms for the three TF32 passes and 0.034
// ms for the depthwise's FMAs on CUDA cores). As in the block kernels, a
// block walks a dependent chain of loads, products and barriers, so latency
// and occupancy bind first.
//
// What the design does about it:
//  * tiles of up to 256 output pixels (kernels/fused_block.py:plan_stem), so
//    the stem recomputed on the halo falls from 1.56x (8x8) to 1.27x (16x16)
//    of the output's pixels, and two blocks share an SM (kMinBlocks);
//  * the input window is staged once per block by 16-byte cp.async with
//    zero fill: its first column 2 * ox0 - 3 is odd, so the staged rows are
//    the aligned superset [f0, f0 + ld) of each input row's values, and the
//    window starts off0 values in. Element loads where a row or the base is
//    not 16-byte aligned (vec);
//  * the stem's products and the project run on mma.sync: bf16 m16n8k16
//    with float32 sums, float32 m16n8k8 tf32 in three passes; padded K rows
//    and N columns of the weights are zero, rewritten on every load;
//  * the hidden chunk stays float32 in shared memory with the depthwise's
//    zero ring (positions outside the hidden tensor); the depthwise runs on
//    CUDA cores in float32, four output rows per item.

#include <type_traits>

#include "fused_common.cuh"
#include "mma_tf32.cuh"

namespace {

using myt_fused::relu6;
using namespace myt_mma;
using bf16 = __nv_bfloat16;

constexpr int kKc = 32;         // hidden channels per chunk (kernels/fused_block.py:STEM_CHUNK)
constexpr int kTaps = 27;       // 3 x 3 x RGB
constexpr int kK = 32;          // the stem's K: the taps zero-padded
constexpr int kN8 = kKc / 8;    // n8 tiles of a chunk
constexpr int kHs = kKc + 4;    // hidden row stride, floats (9 x 16 bytes)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 256;   // output pixels per block (STEM_MAX_TILE)
constexpr int kDwRows = 4;      // output rows of a depthwise item

// p / d for 0 <= p < 2^12 and 0 < d < 1024 from a reciprocal: (p + 0.5) / d
// sits at least 0.5 / d from an integer, far beyond float32's error
__device__ __forceinline__ int div_small(int p, float inv_d) {
  return __float2int_rz((static_cast<float>(p) + 0.5f) * inv_d);
}

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// project-weight rows: an odd multiple of 8 values holding round8(cout)
__host__ __device__ constexpr int w2_stride(int cout) { return ((round8(cout) >> 3) | 1) << 3; }

// Per type: values per 16 bytes; the depthwise output's row stride (an
// odd number of 16-byte units: the project's ldmatrix rows fall on
// distinct banks); the staged stem weights' element and row stride. In
// float32 each stem weight is staged split, (tf32 hi, tf32 lo) in a uint2
// (rows of 36: a half-warp's 64-bit B loads fall on distinct banks); in
// bf16 it is staged as it is (rows of 40: odd 16-byte units for ldmatrix).
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static constexpr int kDs = kKc + 4;
  using Ws = uint2;
  static constexpr int kWs = kKc + 4;
};
template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;
  static constexpr int kDs = kKc + 8;
  using Ws = bf16;
  static constexpr int kWs = kKc + 8;
};

// staged input row: the window's 6 * tw + 15 values, up to kVec - 1 before
// them (the aligned start), rounded up to whole 16-byte units
template <typename T>
__host__ __device__ constexpr int x_stride(int tw) {
  return (6 * tw + 14 + Elem<T>::kVec + Elem<T>::kVec - 1) / Elem<T>::kVec * Elem<T>::kVec;
}

// kernels/fused_block.py:_stem_smem_bytes computes the same: the input
// window (2 * th + 5 rows), the float32 hidden chunk over the hidden window,
// the depthwise output of the tile, the chunk's stem weights (Elem::Ws),
// its project weights and taps in x's type, its biases in float32
template <typename T>
__host__ __device__ constexpr int stem_smem_bytes(int th, int tw, int cout) {
  return static_cast<int>(sizeof(T)) * ((2 * th + 5) * x_stride<T>(tw) +
                                        round16(th * tw) * Elem<T>::kDs +
                                        kKc * w2_stride(cout) + 9 * kKc) +
         static_cast<int>(sizeof(typename Elem<T>::Ws)) * kK * Elem<T>::kWs +
         4 * ((th + 2) * (tw + 2) * kHs + 2 * kKc);
}

struct StemArgs {
  const void* x;
  const void* k_stem;
  const float* b_stem;
  const void* wdw;
  const float* bdw;
  const void* w2;
  const float* b2;
  void* out;
  int batch, h, w, ch, cout, ho, wo, th, tw, tiles_h, tiles_w;
  int vec;  // bit 0: the window's rows by 16-byte copies; bit 1: the weights'
};

constexpr int kVecWindow = 1, kVecWeights = 2;

template <typename T>
struct Smem {
  T* xs;       // [2 * th + 5][x_stride]  input window
  float* hs;   // [wp][kHs]               hidden chunk over the hidden window
  T* ds;       // [tpp][kDs]              depthwise output of the tile
  typename Elem<T>::Ws* ws;  // [kK][kWs] stem weights of the chunk
  T* w2s;      // [kKc][w2_stride]        project weights of the chunk
  T* wdw;      // [9][kKc]                depthwise taps
  float* b1;   // [kKc]                   stem bias
  float* bdw;  // [kKc]                   depthwise bias
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(const StemArgs& a) {
  Smem<T> s;
  s.xs = reinterpret_cast<T*>(myt_fused::dynamic_smem());
  s.hs = reinterpret_cast<float*>(s.xs + (2 * a.th + 5) * x_stride<T>(a.tw));
  s.ds = reinterpret_cast<T*>(s.hs + (a.th + 2) * (a.tw + 2) * kHs);
  s.ws = reinterpret_cast<typename Elem<T>::Ws*>(s.ds + round16(a.th * a.tw) * Elem<T>::kDs);
  s.w2s = reinterpret_cast<T*>(s.ws + kK * Elem<T>::kWs);
  s.wdw = s.w2s + kKc * w2_stride(a.cout);
  s.b1 = reinterpret_cast<float*>(s.wdw + 9 * kKc);
  s.bdw = s.b1 + kKc;
  return s;
}

template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (std::is_same_v<T, float>) {
    return 0.f;
  } else {
    return __float2bfloat16_rn(0.f);
  }
}

// The input window: rows row0 .. row0 + 2 * th + 4 of the image, each the
// values [f0, f0 + ld) of the NHWC row (3 * W values), zero outside the
// image. With vec, 3 * W * sizeof(T) and the base are 16-byte aligned and
// f0 is a whole number of 16-byte units, so a unit lies wholly inside a row
// or wholly outside it.
template <typename T>
__device__ void load_window(T* xs, const T* x, const StemArgs& a, int row0, int f0, int ld) {
  constexpr int V = Elem<T>::kVec;
  const int rows = 2 * a.th + 5, row_len = 3 * a.w;
  if (a.vec & kVecWindow) {
    const int units = ld / V;
    for (int i = threadIdx.x; i < rows * units; i += kThreads) {
      const int r = i / units, q = i - r * units;
      const int y = row0 + r, f = f0 + q * V;
      const bool in = y >= 0 && y < a.h && f >= 0 && f < row_len;
      cp_async16(xs + r * ld + q * V, in ? x + static_cast<size_t>(y) * row_len + f : x,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * ld; i += kThreads) {
    const int r = i / ld, e = i - r * ld;
    const int y = row0 + r, f = f0 + e;
    const bool in = y >= 0 && y < a.h && f >= 0 && f < row_len;
    xs[i] = in ? x[static_cast<size_t>(y) * row_len + f] : zero<T>();
  }
}

// Stage the chunk of hidden channels [c0, c0 + kKc): the stem weights as
// the [k][n] B operand (k_stem is (27, Ch) row-major: row k = (ky * 3 + kx)
// * 3 + c; in float32 split into tf32 hi and lo once here, not per
// fragment), w2's rows, the taps and the biases. Everything past the 27
// taps, Ch or Cout is zero. With kVecWeights (Ch and Cout whole 16-byte
// units, every weight 16-byte aligned) by cp.async, which the window's
// copies and these overlap; else by element.
template <typename T>
__device__ void load_weights(const Smem<T>& s, const StemArgs& a, int c0) {
  constexpr int V = Elem<T>::kVec, g = kKc / V, kWs = Elem<T>::kWs;
  const T* k_stem = static_cast<const T*>(a.k_stem);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* wdw = static_cast<const T*>(a.wdw);
  if constexpr (std::is_same_v<T, float>) {
    for (int i = threadIdx.x; i < kK * kKc; i += kThreads) {
      const int k = i / kKc, n = i % kKc;
      uint32_t hi, lo;
      split_tf32(k < kTaps && c0 + n < a.ch ? k_stem[k * a.ch + c0 + n] : 0.f, hi, lo);
      s.ws[k * kWs + n] = make_uint2(hi, lo);
    }
  } else if (a.vec & kVecWeights) {
    for (int i = threadIdx.x; i < kK * g; i += kThreads) {
      const int k = i / g, q = i % g;
      const bool in = k < kTaps && c0 + q * V < a.ch;
      cp_async16(s.ws + k * kWs + q * V, in ? k_stem + k * a.ch + c0 + q * V : k_stem, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kK * kKc; i += kThreads) {
      const int k = i / kKc, n = i % kKc;
      s.ws[k * kWs + n] = k < kTaps && c0 + n < a.ch ? k_stem[k * a.ch + c0 + n] : zero<T>();
    }
  }
  if (a.vec & kVecWeights) {
    const int gn = round8(a.cout) / V, w2ld = w2_stride(a.cout);
    for (int i = threadIdx.x; i < kKc * gn; i += kThreads) {
      const int r = i / gn, q = i % gn;
      const bool in = c0 + r < a.ch && q * V < a.cout;
      cp_async16(s.w2s + r * w2ld + q * V,
                 in ? w2 + static_cast<size_t>(c0 + r) * a.cout + q * V : w2, in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 9 * g; i += kThreads) {
      const int t = i / g, q = i % g;
      const bool in = c0 + q * V < a.ch;
      cp_async16(s.wdw + t * kKc + q * V, in ? wdw + t * a.ch + c0 + q * V : wdw, in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 2 * (kKc / 4); i += kThreads) {
      const int which = i / (kKc / 4), q = i % (kKc / 4);
      const bool in = c0 + q * 4 < a.ch;
      const float* src = which ? a.bdw : a.b_stem;
      cp_async16((which ? s.bdw : s.b1) + q * 4, in ? src + c0 + q * 4 : src, in ? 16 : 0);
    }
    return;
  }
  const int cout8 = round8(a.cout), w2ld = w2_stride(a.cout);
  for (int i = threadIdx.x; i < kKc * cout8; i += kThreads) {
    const int r = i / cout8, co = i - r * cout8;
    s.w2s[r * w2ld + co] = c0 + r < a.ch && co < a.cout
                               ? w2[static_cast<size_t>(c0 + r) * a.cout + co]
                               : zero<T>();
  }
  for (int i = threadIdx.x; i < 9 * kKc; i += kThreads) {
    const int t = i / kKc, c = c0 + i % kKc;
    s.wdw[i] = c < a.ch ? wdw[t * a.ch + c] : zero<T>();
  }
  for (int i = threadIdx.x; i < kKc; i += kThreads) {
    s.b1[i] = c0 + i < a.ch ? a.b_stem[c0 + i] : 0.f;
    s.bdw[i] = c0 + i < a.ch ? a.bdw[c0 + i] : 0.f;
  }
}

// The staged-row offset of tap k (ky = k / 9, j = k % 9: kx * 3 + c) from
// its hidden pixel's first tap; a padded tap (k >= 27) reads the first tap,
// a finite value that the zero weight row cancels.
__device__ __forceinline__ int tap_off(int k, int ld) {
  return k < kTaps ? (k / 9) * ld + k % 9 : 0;
}

// The staged-window offset of the first tap of hidden-window pixel m (row
// m / win_w, column m % win_w); a padding row (m >= wp) reads offset 0.
__device__ __forceinline__ int row_off(int m, int wp, int win_w, float inv_w, int ld, int off0) {
  if (m >= wp) return 0;
  const int hy = div_small(m, inv_w);
  return 2 * hy * ld + 6 * (m - hy * win_w) + off0;
}

// This lane's stem biases: channels j * 8 + acc_col(lane, 0) and the next.
__device__ __forceinline__ void load_bias(float2 (&bias)[kN8], const float* b1, int lane) {
#pragma unroll
  for (int j = 0; j < kN8; ++j) bias[j] = *reinterpret_cast<const float2*>(b1 + j * 8 + acc_col(lane, 0));
}

// The stem's epilogue for one m16 tile: bias, ReLU6, and zero where the
// hidden pixel (oy0 - 1 + hy, ox0 - 1 + hx) lies outside the hidden tensor
// (the depthwise's zero padding), one float2 per accumulator pair.
__device__ __forceinline__ void store_hidden(const float (&e)[kN8][4], const float2 (&bias)[kN8],
                                             float* hs, int mt, int wp, int win_w, float inv_w,
                                             int oy0, int ox0, int ho, int wo, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = mt * 16 + acc_row(lane, 2 * half);
    if (p >= wp) continue;
    const int hy = div_small(p, inv_w);
    const int y = oy0 - 1 + hy, xx = ox0 - 1 + p - hy * win_w;
    const bool inside = y >= 0 && y < ho && xx >= 0 && xx < wo;
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      const int c = j * 8 + acc_col(lane, 0);
      float2 v = make_float2(0.f, 0.f);
      if (inside) {
        v.x = relu6(e[j][2 * half] + bias[j].x);
        v.y = relu6(e[j][2 * half + 1] + bias[j].y);
      }
      *reinterpret_cast<float2*>(hs + p * kHs + c) = v;
    }
  }
}

// the B fragment of the 8x8 tile at `p` of a float32 [k][n] array (`ld`
// floats a row), split into tf32 hi and lo
__device__ __forceinline__ void load_b(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* p, int ld,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(p[tf32_b_k(lane, i) * ld + tf32_b_n(lane)], hi[i], lo[i]);
}

// Stem, float32: hs = relu6(im2col(xs) . ws + b1) over the hidden window, a
// warp item an m16 tile of window pixels by the chunk's four n8 tiles, K in
// four tf32 k-steps of three passes each, the B fragments read split. A
// register i of lane l holds row tf32_a_row(l, i), column tf32_a_col(l,
// i). With K = 32 the twelve products of an output chain into its
// accumulator: the drift that mma_3xtf32's fresh accumulator per k-step
// stops grows with the chain (7.6e-6 of the largest output at 360 mma, an
// H100, PERF.md); at twelve it stays at float32's rounding, and each step
// saves the four adds.
__device__ void stem_f32(const Smem<float>& s, int ld, int off0, int win_w, int wp, int wpp,
                         int oy0, int ox0, int ho, int wo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_w = 1.f / static_cast<float>(win_w);
  int koff[kK / 8][2];  // tap offsets of this lane's two A columns per k-step
#pragma unroll
  for (int ks = 0; ks < kK / 8; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) koff[ks][h] = tap_off(ks * 8 + tf32_a_col(lane, 2 * h), ld);
  }
  float2 bias[kN8];
  load_bias(bias, s.b1, lane);
  for (int mt = warp; mt < wpp / 16; mt += kWarps) {
    const int r[2] = {row_off(mt * 16 + tf32_a_row(lane, 0), wp, win_w, inv_w, ld, off0),
                      row_off(mt * 16 + tf32_a_row(lane, 1), wp, win_w, inv_w, ld, off0)};
    float e[kN8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(s.xs[r[i & 1] + koff[ks][i >> 1]], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        constexpr int kWs = Elem<float>::kWs;
        const uint2* b = s.ws + ks * 8 * kWs + j * 8 + tf32_b_n(lane);
        const uint2 b0 = b[tf32_b_k(lane, 0) * kWs], b1 = b[tf32_b_k(lane, 1) * kWs];
        mma_tf32(e[j], al, b0.x, b1.x);
        mma_tf32(e[j], ah, b0.y, b1.y);
        mma_tf32(e[j], ah, b0.x, b1.x);
      }
    }
    store_hidden(e, bias, s.hs, mt, wp, win_w, inv_w, oy0, ox0, ho, wo, lane);
  }
}

// Stem, bf16: as stem_f32 with bf16 operands (products exact) and float32
// sums, K in two k16 steps. A register i of lane l holds row bf16_a_row(l,
// i) and columns bf16_a_col(l, i) and the next (low half first); the pair
// may straddle two kernel rows, so each value is loaded on its own. B comes
// by ldmatrix .trans, two n8 tiles a load.
__device__ void stem_bf16(const Smem<bf16>& s, int ld, int off0, int win_w, int wp, int wpp,
                          int oy0, int ox0, int ho, int wo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_w = 1.f / static_cast<float>(win_w);
  int koff[kK / 16][2][2];  // per k-step, column group (i >> 1) and value of the pair
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int v = 0; v < 2; ++v) koff[ks][h][v] = tap_off(ks * 16 + bf16_a_col(lane, 2 * h) + v, ld);
    }
  }
  float2 bias[kN8];
  load_bias(bias, s.b1, lane);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(s.xs);
  for (int mt = warp; mt < wpp / 16; mt += kWarps) {
    const int r[2] = {row_off(mt * 16 + bf16_a_row(lane, 0), wp, win_w, inv_w, ld, off0),
                      row_off(mt * 16 + bf16_a_row(lane, 1), wp, win_w, inv_w, ld, off0)};
    float e[kN8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      uint32_t af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int base = r[i & 1];
        af[i] = static_cast<uint32_t>(xs[base + koff[ks][i >> 1][0]]) |
                (static_cast<uint32_t>(xs[base + koff[ks][i >> 1][1]]) << 16);
      }
#pragma unroll
      for (int jj = 0; jj < kN8 / 2; ++jj) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, s.ws + (ks * 16 + ldsm_row(lane)) * Elem<bf16>::kWs + jj * 16 +
                              ldsm_col(lane));
        mma_bf16(e[2 * jj], af, bq[0], bq[1]);
        mma_bf16(e[2 * jj + 1], af, bq[2], bq[3]);
      }
    }
    store_hidden(e, bias, s.hs, mt, wp, win_w, inv_w, oy0, ox0, ho, wo, lane);
  }
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// Depthwise 3x3 stride 1 in float32 from the hidden chunk: ds[p][c] =
// relu6(the 9 taps in (dy, dx) order + bdw[c]), rounded to T, for every
// tile pixel p = (p / tw, p % tw); zero on the padding rows. A thread item
// is 4 channels of a column of kDwRows output pixels: it reads their
// kDwRows + 2 input rows once for all of them. A thread's items share
// their 4 channels (kThreads is a multiple of kKc / 4), so it reads the
// 9 taps once.
template <typename T>
__device__ void depthwise(const Smem<T>& s, int win_w, int th, int tw) {
  constexpr int q4 = kKc / 4, kIn = kDwRows + 2, kDs = Elem<T>::kDs;
  static_assert(kThreads % q4 == 0, "a thread's items share their channels");
  const int tp = th * tw, tpp = round16(tp), strips = (th + kDwRows - 1) / kDwRows;
  for (int i = threadIdx.x; i < (tpp - tp) * q4; i += kThreads) {
    store4(s.ds + (tp + i / q4) * kDs + (i % q4) * 4, 0.f, 0.f, 0.f, 0.f);
  }
  const int c = (threadIdx.x % q4) * 4;
  float4 wq[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wq[t] = load4(s.wdw + t * kKc + c);
  const float4 bias = *reinterpret_cast<const float4*>(s.bdw + c);
  for (int item = threadIdx.x; item < strips * tw * q4; item += kThreads) {
    const int col = (item / q4) % tw, oy0 = (item / q4 / tw) * kDwRows;
    const int rows = th - oy0 < kDwRows ? th - oy0 : kDwRows;
    float4 acc[kDwRows];
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* h = s.hs + (oy0 * win_w + col) * kHs + c;
    // input row r feeds output row i at dy = r - i; each output sums its
    // taps in (dy, dx) order as r rises
#pragma unroll
    for (int r = 0; r < kIn; ++r) {
      if (r > rows + 1) break;
      float4 v[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) v[dx] = *reinterpret_cast<const float4*>(h + (r * win_w + dx) * kHs);
#pragma unroll
      for (int i = 0; i < kDwRows; ++i) {
        const int dy = r - i;
        if (dy < 0 || dy > 2 || i >= rows) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w = wq[dy * 3 + dx];
          acc[i].x = fmaf(v[dx].x, w.x, acc[i].x);
          acc[i].y = fmaf(v[dx].y, w.y, acc[i].y);
          acc[i].z = fmaf(v[dx].z, w.z, acc[i].z);
          acc[i].w = fmaf(v[dx].w, w.w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) {
      if (i >= rows) continue;
      store4(s.ds + ((oy0 + i) * tw + col) * kDs + c, relu6(acc[i].x + bias.x),
             relu6(acc[i].y + bias.y), relu6(acc[i].z + bias.z), relu6(acc[i].w + bias.w));
    }
  }
}

// the A fragment of the 16x8 float32 tile at `p` (row-major, `ld` floats a
// row), split into tf32 hi and lo
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* p, int ld,
                                       int lane) {
  uint32_t r[4];
  ldsm_x4(r, p + ldsm_f32_row(lane) * ld + ldsm_f32_col(lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}

// The chunk's share of the project: acc[i][j] (m16 tile mt0 + i, n8 tile
// nt0 + j) += ds . w2s over the chunk's 32 channels. Tiles past the tile's
// rows or Cout are skipped (the test is uniform across the warp).
template <int MW, int NW>
__device__ __forceinline__ void project(const Smem<float>& s, int w2ld, int mt0, int nt0,
                                        int mtiles, int ntiles, float (&acc)[MW][NW][4]) {
  constexpr int kDs = Elem<float>::kDs;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKc / 8; ++ks) {
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (nt0 + j < ntiles) load_b(bh[j], bl[j], s.w2s + ks * 8 * w2ld + (nt0 + j) * 8, w2ld, lane);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= mtiles) continue;
      uint32_t ah[4], al[4];
      load_a(ah, al, s.ds + (mt0 + i) * 16 * kDs + ks * 8, kDs, lane);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (nt0 + j < ntiles) mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
  }
}

template <int MW, int NW>
__device__ __forceinline__ void project(const Smem<bf16>& s, int w2ld, int mt0, int nt0,
                                        int mtiles, int ntiles, float (&acc)[MW][NW][4]) {
  constexpr int kDs = Elem<bf16>::kDs;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKc / 16; ++ks) {
    uint32_t bf[NW][2];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (nt0 + j < ntiles) {
        ldsm_x2_trans(bf[j], s.w2s + (ks * 16 + ldsm_row(lane)) * w2ld + (nt0 + j) * 8);
      }
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= mtiles) continue;
      uint32_t af[4];
      ldsm_x4(af, s.ds + ((mt0 + i) * 16 + ldsm_row(lane)) * kDs + ks * 16 + ldsm_col(lane));
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (nt0 + j < ntiles) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(bf16* o, float v) { *o = __float2bfloat16_rn(v); }

// The small project tilings keep a thread at 128 registers, so two blocks
// share an SM (the plan's shared memory allows it at every served tile).
template <int MW, int NW>
constexpr int kMinBlocks = MW * NW <= 8 ? 2 : 1;

// Tile t of the launch: image t / (tiles_h * tiles_w), output rows from
// oy0, columns from ox0; f0 is the aligned start of its input window's
// rows (whose first value, column 2 * ox0 - 3, lies off0 values in).
struct Tile {
  int b, oy0, ox0, f0, off0;
};

template <typename T>
__device__ __forceinline__ Tile tile_at(const StemArgs& a, int t) {
  const int per_image = a.tiles_h * a.tiles_w, r = t % per_image;
  Tile tl;
  tl.b = t / per_image;
  tl.oy0 = (r / a.tiles_w) * a.th;
  tl.ox0 = (r % a.tiles_w) * a.tw;
  const int fs = 3 * (2 * tl.ox0 - 3);
  tl.f0 = fs & ~(Elem<T>::kVec - 1);
  tl.off0 = fs - tl.f0;
  return tl;
}

template <typename T>
__device__ __forceinline__ void stage_window(T* xs, const StemArgs& a, int t, int ld) {
  const Tile tl = tile_at<T>(a, t);
  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(tl.b) * a.h * a.w * 3;
  load_window<T>(xs, x, a, 2 * tl.oy0 - 3, tl.f0, ld);
}

// One block an SM slot, walking the tiles t = blockIdx.x, + gridDim.x, ...
// With one chunk (Ch <= 32, the served width) the weights are staged once
// for every tile; the next tile's input window is staged as soon as this
// tile's stem is done with it, while its depthwise and project run.
template <typename T, int MW, int NW>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<MW, NW>)) fused_stem_kernel(StemArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int win_w = a.tw + 2, wp = (a.th + 2) * win_w, wpp = round16(wp);
  const int tp = a.th * a.tw, ld = x_stride<T>(a.tw);
  const int total = a.batch * a.tiles_h * a.tiles_w;
  const int chunks = (a.ch + kKc - 1) / kKc;
  if (static_cast<int>(blockIdx.x) >= total) return;

  const Smem<T> s = carve<T>(a);
  if (chunks == 1) load_weights<T>(s, a, 0);
  stage_window<T>(s.xs, a, blockIdx.x, ld);
  cp_async_commit();

  // the project's warp grid: wn_count warps along Cout, NW n8 tiles each;
  // MW m16 tiles of pixels each along the rows (the host checks it covers)
  const int mtiles = round16(tp) / 16, ntiles = round8(a.cout) / 8;
  const int wn_count = (ntiles + NW - 1) / NW;
  const int wm = warp / wn_count, wn = warp % wn_count;
  const bool projects = wm < kWarps / wn_count;
  const int w2ld = w2_stride(a.cout);

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at<T>(a, t);
    float acc[MW][NW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
      }
    }

    // per chunk: (with several) its weights once every warp has left the
    // last project; the stem once they and the window have landed; the
    // depthwise once the hidden chunk is whole; the project once the
    // depthwise is. The first barrier also keeps the last tile's project
    // off this tile's depthwise output.
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) {
        __syncthreads();
        load_weights<T>(s, a, c * kKc);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (std::is_same_v<T, float>) {
        stem_f32(s, ld, tl.off0, win_w, wp, wpp, tl.oy0, tl.ox0, a.ho, a.wo);
      } else {
        stem_bf16(s, ld, tl.off0, win_w, wp, wpp, tl.oy0, tl.ox0, a.ho, a.wo);
      }
      __syncthreads();
      if (c == chunks - 1 && t + static_cast<int>(gridDim.x) < total) {
        stage_window<T>(s.xs, a, t + gridDim.x, ld);
        cp_async_commit();
      }
      depthwise<T>(s, win_w, a.th, a.tw);
      __syncthreads();
      if (projects) project<MW, NW>(s, w2ld, wm * MW, wn * NW, mtiles, ntiles, acc);
    }
    if (!projects) continue;

    // bias, one rounding, one write
    T* out = static_cast<T*>(a.out) + static_cast<size_t>(tl.b) * a.ho * a.wo * a.cout;
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
          const int oy = tl.oy0 + p / a.tw, ox = tl.ox0 + p % a.tw;
          if (oy >= a.ho || ox >= a.wo) continue;
          const bool pair = co + 1 < a.cout;
          const float v0 = acc[i][j][2 * half] + a.b2[co];
          const float v1 = pair ? acc[i][j][2 * half + 1] + a.b2[co + 1] : 0.f;
          T* o = out + (static_cast<size_t>(oy) * a.wo + ox) * a.cout + co;
          if (pair && (a.cout & 1) == 0) {
            store2(o, v0, v1);
          } else {
            store1(o, v0);
            if (pair) store1(o + 1, v1);
          }
        }
      }
    }
  }
}

// Host side.

template <typename T, int MW, int NW>
int launch(const StemArgs& a, cudaStream_t stream) {
  const int ntiles = round8(a.cout) / 8, mtiles = round16(a.th * a.tw) / 16;
  const int wn_count = (ntiles + NW - 1) / NW;
  if (wn_count > kWarps || (kWarps / wn_count) * MW < mtiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = stem_smem_bytes<T>(a.th, a.tw, a.cout);
  cudaError_t err = cudaFuncSetAttribute(fused_stem_kernel<T, MW, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stem_kernel<T, MW, NW>,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = a.batch * a.tiles_h * a.tiles_w;
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  fused_stem_kernel<T, MW, NW><<<grid > 0 ? grid : 1, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated (MW, NW) on 8 warps: kernels/fused_block.py:STEM_CONFIGS
template <typename T>
int launch_config(const StemArgs& a, cudaStream_t stream, int mw, int nw) {
#define MYT_CONFIG(M, N) \
  if (mw == M && nw == N) return launch<T, M, N>(a, stream);
  MYT_CONFIG(2, 2)
  MYT_CONFIG(2, 3)
  MYT_CONFIG(2, 4)
  MYT_CONFIG(4, 3)
  MYT_CONFIG(3, 5)
#undef MYT_CONFIG
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success). The
// caller checks shapes and picks the plan: th x tw is the output tile (at
// most 256 pixels), (mw, nw, warps) an instantiated project warp tiling
// that covers it; vec bit 0 says 3 * W values of x's type are whole 16-byte
// units and x is 16-byte aligned (16-byte cp.async of the window; else
// element loads), bit 1 the same of Ch, Cout and every weight. The grid is
// as many blocks as the SMs hold at once (or the tiles, if fewer).
extern "C" int myt_fused_stem(const void* x, const void* k_stem, const float* b_stem,
                              const void* wdw, const float* bdw, const void* w2, const float* b2,
                              void* out, int batch, int h, int w, int ch, int cout, int th, int tw,
                              int mw, int nw, int warps, int vec, int bf16_io, void* stream) {
  if (th < 1 || tw < 1 || th * tw > kMaxTile || warps != kWarps || ch < 1 || cout < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = h / 2, wo = w / 2;
  const int tiles_h = (ho + th - 1) / th, tiles_w = (wo + tw - 1) / tw;
  const StemArgs a{x, k_stem, b_stem, wdw, bdw, w2, b2, out, batch, h, w, ch, cout, ho, wo,
                   th, tw, tiles_h, tiles_w, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_config<bf16>(a, st, mw, nw) : launch_config<float>(a, st, mw, nw);
}
