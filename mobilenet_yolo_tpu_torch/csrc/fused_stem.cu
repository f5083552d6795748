// Fused MobileNetV2 stem and block 0 (BatchNorm folded) for Hopper
// (sm_90a): 3x3/s2 RGB conv (pad 1) + bias, ReLU6, block 0's depthwise 3x3
// stride 1 + bias, ReLU6, 1x1 project + bias. Block 0 has expand ratio 1,
// so the stem's output is its hidden tensor, and it never reaches device
// memory.
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_fused.py:fused_stem_block0
// (bodies _fused_stem_kernel and _stem_w4). Same contract: x (B, H, W, 3)
// NHWC with H and W even, k_stem (3, 3, 3, Ch) HWIO, wdw (3, 3, Ch), w2
// (Ch, Cout), float32 biases; out (B, H/2, W/2, Cout) in x's type. The
// space-to-depth relayout and its four shifted K=12 matmuls were the TPU's
// answer to a K=27 contraction on a 128-lane matrix unit; here the 3x3/s2
// conv is computed directly from the input window: hidden position (sy,
// sx) reads input (2*sy - 1 + ky, 2*sx - 1 + kx), zero outside the image.
//
// What bounds it: operations, barely. At batch 128, 352x352 it does 13.2
// GFLOP on 444 MB of input and output (30 FLOP per byte, against 20 for
// float32 FMAs outside the tensor cores), and the unfused chain writes
// and reads the 32-channel stem output three more times.
//
// What the design does about it (fused_common.cuh has the shared parts):
// one block per (image, output tile of <= 64 pixels); the tile's input
// window ((2*th+5) x (2*tw+5) x 3) is staged once; each thread computes
// 4 hidden pixels x 4 channels of the stem over the 27 taps, and the
// depthwise and project are fused_common.cuh's.

#include "fused_common.cuh"

namespace {

using namespace myt_fused;

struct StemArgs {
  const void* x;
  const void* k_stem;
  const float* b_stem;
  const void* wdw;
  const float* bdw;
  const void* w2;
  const float* b2;
  void* out;
  int h, w, ch, cout, ho, wo, th, tw, tiles_w;
};

constexpr int kTaps = 27;  // 3 x 3 x RGB

// kernels/fused_block.py:_stem_smem_bytes computes the same
__host__ __device__ constexpr int stem_smem_floats(int th, int tw, int cout) {
  return round4(3 * (2 * th + 5) * (2 * tw + 5)) + kTaps * kChunk +
         chunk_floats(round4((th + 2) * (tw + 2)), round4(cout));
}

template <int NJ, typename T>
__global__ void __launch_bounds__(kThreads) fused_stem_kernel(StemArgs a) {
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / a.tiles_w) * a.th, ox0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int win_w = a.tw + 2;                       // hidden window: the tile and its ring
  const int wp = (a.th + 2) * win_w, wpp = round4(wp);
  const int xw = 2 * win_w + 1, xn = (2 * (a.th + 2) + 1) * xw;  // input window
  const int xrow0 = 2 * oy0 - 3, xcol0 = 2 * ox0 - 3;
  const int coutp = round4(a.cout);

  float* xs = dynamic_smem();     // [3][xn]
  float* ks = xs + round4(3 * xn);  // [27][kChunk], tap t = (ky * 3 + kx) * 3 + c
  const Chunk s = carve_chunk(ks + kTaps * kChunk, wpp, coutp);

  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.h * a.w * 3;
  const T* k_stem = static_cast<const T*>(a.k_stem);
  for (int i = threadIdx.x; i < 3 * xn; i += kThreads) {
    const int p = i / 3, c = i % 3;
    const int y = xrow0 + p / xw, xx = xcol0 + p % xw;
    float v = 0.f;
    if (y >= 0 && y < a.h && xx >= 0 && xx < a.w) {
      v = to_f(x[(static_cast<size_t>(y) * a.w + xx) * 3 + c]);
    }
    xs[c * xn + p] = v;
  }

  float acc[NJ][4][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[j][i][l] = 0.f;
    }
  }

  const int expand_items = (wpp / 4) * (kChunk / 4);
  for (int c0 = 0; c0 < a.ch; c0 += kChunk) {
    for (int i = threadIdx.x; i < kTaps * kChunk; i += kThreads) {
      const int c = c0 + i % kChunk;
      ks[i] = c < a.ch ? to_f(k_stem[(i / kChunk) * a.ch + c]) : 0.f;
    }
    load_chunk(s, a.b_stem, static_cast<const T*>(a.wdw), a.bdw, static_cast<const T*>(a.w2),
               a.ch, a.cout, coutp, c0);
    __syncthreads();

    for (int item = threadIdx.x; item < expand_items; item += kThreads) {
      const int cg = item % (kChunk / 4), pg = item / (kChunk / 4);
      int off[4];  // input-window offset of each pixel's top-left tap
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pg * 4 + i;
        off[i] = p < wp ? 2 * (p / win_w) * xw + 2 * (p % win_w) : 0;
      }
      float e[4][4] = {};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* xc = xs + c * xn + ky * xw + kx;
            const float4 av = make_float4(xc[off[0]], xc[off[1]], xc[off[2]], xc[off[3]]);
            const float4 bv = *reinterpret_cast<const float4*>(
                ks + ((ky * 3 + kx) * 3 + c) * kChunk + cg * 4);
            fma4x4(e, av, bv);
          }
        }
      }
      store_hidden(s, e, pg, cg, wp, wpp, win_w, oy0 - 1, ox0 - 1, a.ho, a.wo);
    }
    __syncthreads();
    depthwise<1>(s, wpp, win_w, a.th, a.tw);
    __syncthreads();
    project<NJ>(s, coutp, acc);
    __syncthreads();
  }

  const size_t out_image = static_cast<size_t>(b) * a.ho * a.wo * a.cout;
  store_out<NJ, T>(acc, coutp, a.cout, a.b2, a.th, a.tw, oy0, ox0, a.ho, a.wo,
                   static_cast<const T*>(nullptr), static_cast<T*>(a.out) + out_image);
}

// Host side.

template <int NJ, typename T>
int launch(const StemArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<NJ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_stem_kernel<NJ, T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nj(const StemArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  switch (items_per_thread(round4(a.cout))) {
    case 1: return launch<1, T>(a, grid, smem, stream);
    case 2: return launch<2, T>(a, grid, smem, stream);
    case 3: return launch<3, T>(a, grid, smem, stream);
    case 5: return launch<5, T>(a, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// The caller checks shapes; th x tw is the output tile (th * tw <= 64).
extern "C" int myt_fused_stem(const void* x, const void* k_stem, const float* b_stem,
                              const void* wdw, const float* bdw, const void* w2, const float* b2,
                              void* out, int batch, int h, int w, int ch, int cout, int th, int tw,
                              int bf16, void* stream) {
  if (th < 1 || tw < 1 || th * tw > kTilePix) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h / 2, wo = w / 2;
  const int tiles_h = (ho + th - 1) / th, tiles_w = (wo + tw - 1) / tw;
  const StemArgs a{x, k_stem, b_stem, wdw, bdw, w2, b2, out, h, w, ch, cout, ho, wo,
                   th, tw, tiles_w};
  const dim3 grid(tiles_h * tiles_w, batch);
  const int smem = stem_smem_floats(th, tw, cout) * static_cast<int>(sizeof(float));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_nj<__nv_bfloat16>(a, grid, smem, st) : launch_nj<float>(a, grid, smem, st);
}
