// Fused MobileNetV2 inverted-residual block (BatchNorm folded) for Hopper
// (sm_90a): 1x1 expand + bias, ReLU6, depthwise 3x3 (stride 1 or 2) +
// bias, ReLU6, 1x1 project + bias, optional residual, with the hidden
// tensor never written to device memory.
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_fused.py:fused_inverted_residual
// (body _fused_block_kernel, stride 1) and fused_inverted_residual_s2 (body
// _fused_block_s2_kernel, stride 2, H and W even). Same contract: x (B, H,
// W, Cin) NHWC, w1 (Cin, Ch), wdw (3, 3, Ch), w2 (Ch, Cout), float32
// biases; out (B, H/S, W/S, Cout). This file serves float32 tensors; bf16
// ones run on the tensor cores in fused_block_bf16.cu. The TPU layout
// (width padded to the sublane tile, rolls for the column shifts, a second
// BlockSpec for the halo rows) is not carried over.
//
// What bounds it: operations. At the serving shapes (batch 128, 352x352,
// PERF.md) a block does 5-19 GFLOP on 20-350 MB of input and output, 50 to
// 370 FLOP per byte, while float32 FMAs outside the tensor cores balance
// HBM at 20 FLOP per byte. The unfused chain also moves the 6x hidden
// tensor through HBM three times, which is what the fusion removes.
//
// What the design does about it (fused_common.cuh has the shared parts):
//  * one block per (image, output tile of <= 64 pixels); the input window
//    (the tile's rows and columns plus the 3x3 halo, (S*(th-1)+3) x
//    (S*(tw-1)+3) pixels) is staged once in shared memory, channel-major,
//    so the expand reads 4 neighbouring pixels in one 16-byte load;
//  * the hidden channels go by in chunks of 32: the 227 KB of shared
//    memory hold no whole (TH+2) x W x Ch float32 tile, as the TPU's VMEM
//    did. The project is summed over the chunks in registers, which sums
//    in another order than one long dot product;
//  * the expand is recomputed on the halo (1.56x at an 8x8 stride-1 tile,
//    1.13x at stride 2), which costs less than a round trip through HBM;
//  * the stride is a template parameter, so the stride-2 window walk
//    compiles to fixed offsets.
// Later work: TMA for the window, and more than one block per SM at the
// widest shapes.

#include "fused_common.cuh"

namespace {

using namespace myt_fused;

struct BlockArgs {
  const void* x;
  const void* w1;
  const float* b1;
  const void* wdw;
  const float* bdw;
  const void* w2;
  const float* b2;
  void* out;
  int h, w, cin, ch, cout, ho, wo, th, tw, tiles_w, residual;
};

__host__ __device__ constexpr int window_pixels(int stride, int th, int tw) {
  return round4((stride * (th - 1) + 3) * (stride * (tw - 1) + 3));
}

// kernels/fused_block.py:_block_smem_bytes computes the same
__host__ __device__ constexpr int block_smem_floats(int stride, int th, int tw, int cin,
                                                    int cout) {
  return cin * window_pixels(stride, th, tw) + cin * kChunk +
         chunk_floats(window_pixels(stride, th, tw), round4(cout));
}

template <int S, int NJ, typename T>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(BlockArgs a) {
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / a.tiles_w) * a.th, ox0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int win_w = S * (a.tw - 1) + 3;
  const int wp = (S * (a.th - 1) + 3) * win_w, wpp = round4(wp);
  const int coutp = round4(a.cout);
  const int row0 = oy0 * S - 1, col0 = ox0 * S - 1;  // window origin in the input

  float* xs = dynamic_smem();        // [cin][wpp]
  float* w1s = xs + a.cin * wpp;     // [cin][kChunk]
  const Chunk s = carve_chunk(w1s + a.cin * kChunk, wpp, coutp);

  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.h * a.w * a.cin;
  const T* w1 = static_cast<const T*>(a.w1);
  for (int i = threadIdx.x; i < wpp * a.cin; i += kThreads) {
    const int p = i / a.cin, ci = i % a.cin;
    const int y = row0 + p / win_w, xx = col0 + p % win_w;
    float v = 0.f;
    if (p < wp && y >= 0 && y < a.h && xx >= 0 && xx < a.w) {
      v = to_f(x[(static_cast<size_t>(y) * a.w + xx) * a.cin + ci]);
    }
    xs[ci * wpp + p] = v;
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
    for (int i = threadIdx.x; i < a.cin * kChunk; i += kThreads) {
      const int c = c0 + i % kChunk;
      w1s[i] = c < a.ch ? to_f(w1[static_cast<size_t>(i / kChunk) * a.ch + c]) : 0.f;
    }
    load_chunk(s, a.b1, static_cast<const T*>(a.wdw), a.bdw, static_cast<const T*>(a.w2), a.ch,
               a.cout, coutp, c0);
    __syncthreads();

    for (int item = threadIdx.x; item < expand_items; item += kThreads) {
      const int cg = item % (kChunk / 4), pg = item / (kChunk / 4);
      float e[4][4] = {};
      const float* xa = xs + pg * 4;
      const float* wb = w1s + cg * 4;
      for (int ci = 0; ci < a.cin; ++ci) {
        fma4x4(e, *reinterpret_cast<const float4*>(xa + ci * wpp),
               *reinterpret_cast<const float4*>(wb + ci * kChunk));
      }
      store_hidden(s, e, pg, cg, wp, wpp, win_w, row0, col0, a.h, a.w);
    }
    __syncthreads();
    depthwise<S>(s, wpp, win_w, a.th, a.tw);
    __syncthreads();
    project<NJ>(s, coutp, acc);
    __syncthreads();
  }

  const size_t out_image = static_cast<size_t>(b) * a.ho * a.wo * a.cout;
  store_out<NJ, T>(acc, coutp, a.cout, a.b2, a.th, a.tw, oy0, ox0, a.ho, a.wo,
                   a.residual ? x : nullptr, static_cast<T*>(a.out) + out_image);
}

// Host side.

template <int S, int NJ, typename T>
int launch(const BlockArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<S, NJ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_block_kernel<S, NJ, T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int S, typename T>
int launch_nj(const BlockArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  switch (items_per_thread(round4(a.cout))) {
    case 1: return launch<S, 1, T>(a, grid, smem, stream);
    case 2: return launch<S, 2, T>(a, grid, smem, stream);
    case 3: return launch<S, 3, T>(a, grid, smem, stream);
    case 5: return launch<S, 5, T>(a, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// The caller checks shapes; th x tw is the output tile (th * tw <= 64).
// Float32 tensors only.
extern "C" int myt_fused_block(const void* x, const void* w1, const float* b1, const void* wdw,
                               const float* bdw, const void* w2, const float* b2, void* out,
                               int batch, int h, int w, int cin, int ch, int cout, int stride,
                               int residual, int th, int tw, void* stream) {
  if ((stride != 1 && stride != 2) || th < 1 || tw < 1 || th * tw > kTilePix) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = stride == 1 ? h : h / 2, wo = stride == 1 ? w : w / 2;
  const int tiles_h = (ho + th - 1) / th, tiles_w = (wo + tw - 1) / tw;
  const BlockArgs a{x, w1, b1, wdw, bdw, w2, b2, out, h, w, cin, ch, cout, ho, wo,
                    th, tw, tiles_w, residual};
  const dim3 grid(tiles_h * tiles_w, batch);
  const int smem = block_smem_floats(stride, th, tw, cin, cout) * static_cast<int>(sizeof(float));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_nj<1, float>(a, grid, smem, st) : launch_nj<2, float>(a, grid, smem, st);
}
