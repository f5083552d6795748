// The fused stem kernel's pieces (fused_stem.cu), which run the BatchNorm-
// folded stem and block 0 with the hidden tensor kept on the SM; the block
// kernels (fused_block.cu, fused_block_bf16.cu) take relu6 and
// dynamic_smem from here.
//
// One thread block computes one output tile of at most kTilePix pixels
// (th x tw) of one image. It walks the hidden channels in chunks of
// kChunk, and for each chunk:
//   1. expand: the hidden chunk over the tile's input window (the 1x1
//      expand, or the 3x3/s2 stem), plus bias and ReLU6; positions outside
//      the hidden tensor are set to zero, which is the depthwise conv's
//      zero padding (the padding ring belongs to the hidden tensor, not to
//      the input: an expand over a zero-padded input would give relu6(b1));
//   2. depthwise 3x3 (stride 1 or 2) over that window, plus bias and ReLU6;
//   3. the chunk's share of the 1x1 project, summed into registers.
// Then the bias and the residual are added and the tile is written once.
// Everything inside is float32; only the input and output are bf16 when
// the tensors are.
//
// Both 1x1 products are register-tiled outer products read from shared
// memory: a thread owns 4 pixels x 4 channels and pays two 16-byte loads
// for 16 FMAs. The project accumulators (kTilePix x Cout) stay in
// registers across all chunks: NJ items of 4x4 per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace myt_fused {

constexpr int kThreads = 256;  // threads per block
constexpr int kChunk = 32;     // hidden channels per pass (kernels/fused_block.py:CHUNK)
constexpr int kTilePix = 64;   // output pixels per block, at most (TILE_PIX)
constexpr int kMaxCout = 320;  // output channels one block holds (MAX_COUT)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// project items of 4 pixels x 4 output channels, over kThreads threads
__host__ __device__ constexpr int project_items(int coutp) { return (kTilePix / 4) * (coutp / 4); }

__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 myt_smem[];
  return reinterpret_cast<float*>(myt_smem);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The per-chunk buffers, after each kernel's own input window and expand
// weights. Every offset is a multiple of 4 floats (wpp and coutp are), so
// float4 loads stay aligned.
struct Chunk {
  float* hs;    // [kChunk][wpp]       hidden chunk over the window
  float* ds;    // [kChunk][kTilePix]  depthwise output of the tile
  float* w2s;   // [kChunk][coutp]     project weights
  float* wdws;  // [9][kChunk]         depthwise taps
  float* b1s;   // [kChunk]            expand (or stem) bias
  float* bdws;  // [kChunk]            depthwise bias
};

__host__ __device__ constexpr int chunk_floats(int wpp, int coutp) {
  return kChunk * wpp + kChunk * kTilePix + kChunk * coutp + 9 * kChunk + 2 * kChunk;
}

__device__ __forceinline__ Chunk carve_chunk(float* p, int wpp, int coutp) {
  Chunk s;
  s.hs = p;
  s.ds = s.hs + kChunk * wpp;
  s.w2s = s.ds + kChunk * kTilePix;
  s.wdws = s.w2s + kChunk * coutp;
  s.b1s = s.wdws + 9 * kChunk;
  s.bdws = s.b1s + kChunk;
  return s;
}

// Stage chunk c0 of the biases, depthwise taps (9, ch) and project weights
// (ch, cout); channels past ch and columns past cout are zero, so they add
// nothing.
template <typename T>
__device__ void load_chunk(const Chunk& s, const float* b1, const T* wdw, const float* bdw,
                           const T* w2, int ch, int cout, int coutp, int c0) {
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    const bool in = c0 + i < ch;
    s.b1s[i] = in ? b1[c0 + i] : 0.f;
    s.bdws[i] = in ? bdw[c0 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < 9 * kChunk; i += kThreads) {
    const int c = c0 + i % kChunk;
    s.wdws[i] = c < ch ? to_f(wdw[(i / kChunk) * ch + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < kChunk * coutp; i += kThreads) {
    const int c = c0 + i / coutp, co = i % coutp;
    s.w2s[i] = (c < ch && co < cout) ? to_f(w2[static_cast<size_t>(c) * cout + co]) : 0.f;
  }
}

// Expand epilogue: acc holds window pixels pg*4 + i and chunk channels
// cg*4 + l. Window pixel p sits at hidden position (row0 + p / win_w,
// col0 + p % win_w); outside the (hh, hw) hidden tensor it is zero.
__device__ __forceinline__ void store_hidden(const Chunk& s, const float (&acc)[4][4], int pg,
                                             int cg, int wp, int wpp, int win_w, int row0,
                                             int col0, int hh, int hw) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = pg * 4 + i;
    if (p >= wp) continue;
    const int y = row0 + p / win_w, x = col0 + p % win_w;
    const bool inside = y >= 0 && y < hh && x >= 0 && x < hw;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int k = cg * 4 + l;
      s.hs[k * wpp + p] = inside ? relu6(acc[i][l] + s.b1s[k]) : 0.f;
    }
  }
}

// Depthwise 3x3 at stride S over the hidden window, plus bias and ReLU6,
// for every tile pixel (oy, ox) = (p / tw, p % tw); slots past th*tw are 0.
template <int S>
__device__ void depthwise(const Chunk& s, int wpp, int win_w, int th, int tw) {
  const int tp = th * tw;
  for (int item = threadIdx.x; item < kChunk * kTilePix; item += kThreads) {
    const int k = item / kTilePix, p = item % kTilePix;
    float v = 0.f;
    if (p < tp) {
      const int oy = p / tw, ox = p % tw;
      const float* h = s.hs + k * wpp + (oy * S) * win_w + ox * S;
      float acc = s.bdws[k];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          acc = fmaf(h[dy * win_w + dx], s.wdws[(dy * 3 + dx) * kChunk + k], acc);
        }
      }
      v = relu6(acc);
    }
    s.ds[k * kTilePix + p] = v;
  }
}

// The chunk's share of the 1x1 project: acc[j] (item threadIdx.x + j *
// kThreads: pixels pq*4.., output channels cq*4..) += ds^T w2s.
template <int NJ>
__device__ __forceinline__ void project(const Chunk& s, int coutp, float (&acc)[NJ][4][4]) {
  const int items = project_items(coutp);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int item = threadIdx.x + j * kThreads;
    if (item < items) {
      const int pq = item % (kTilePix / 4), cq = item / (kTilePix / 4);
      const float* a = s.ds + pq * 4;
      const float* b = s.w2s + cq * 4;
#pragma unroll 4
      for (int k = 0; k < kChunk; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * kTilePix);
        const float4 bv = *reinterpret_cast<const float4*>(b + k * coutp);
        fma4x4(acc[j], av, bv);
      }
    }
  }
}

// Bias, optional residual (an NHWC image of the output's shape), one
// write per output element. `out` and `resid` point at this image.
template <int NJ, typename T>
__device__ void store_out(const float (&acc)[NJ][4][4], int coutp, int cout, const float* b2,
                          int th, int tw, int oy0, int ox0, int ho, int wo, const T* resid,
                          T* out) {
  const int items = project_items(coutp);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int item = threadIdx.x + j * kThreads;
    if (item >= items) continue;
    const int pq = item % (kTilePix / 4), cq = item / (kTilePix / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pq * 4 + i;
      if (p >= th * tw) continue;
      const int oy = oy0 + p / tw, ox = ox0 + p % tw;
      if (oy >= ho || ox >= wo) continue;
      const size_t base = (static_cast<size_t>(oy) * wo + ox) * cout;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int co = cq * 4 + l;
        if (co >= cout) continue;
        float v = acc[j][i][l] + b2[co];
        if (resid != nullptr) v += to_f(resid[base + co]);
        put(out + base + co, v);
      }
    }
  }
}

// NJ, the project items per thread, for a padded output width: the
// smallest instantiated count that covers it, or 0 past kMaxCout.
__host__ __device__ constexpr int items_per_thread(int coutp) {
  return coutp <= 64 ? 1 : coutp <= 128 ? 2 : coutp <= 192 ? 3 : coutp <= kMaxCout ? 5 : 0;
}

}  // namespace myt_fused
