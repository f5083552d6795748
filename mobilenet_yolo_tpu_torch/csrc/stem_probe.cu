// Staged stem roofline probe for Hopper (sm_90a).
//
// Replaces tools/probe_stem_pallas.py:126, the pallas_call in main.build
// (bodies _kernel_a :32, _kernel_b :43, _kernel_c :61). Same contract: x
// (B, S, S*3) float32, the NHWC image with each row's pixels flattened, S
// even; out (B, S/2, S/2*32) bf16. With h = S/2 and rows taken whole:
//   stage a (0): out[b, i, :] = rowsum(x[b, i]) + rowsum(x[b, i + h]), i < h;
//   stage b (1): acc = x[b, 2i] + x[b, 2i+1] + x[b, 2i-1] (row S-1 at i = 0:
//                pltpu.roll(p1, 1, 0) wraps), then out[b, i, :] = sum over
//                lanes l of acc[l] + acc[l-3] + acc[l+3], lanes modulo 3S;
//   stage c (2): relu6(conv 3x3/s2, zero pad 1 (x as NHWC, w (9, 3, 32))
//                + bias), summed in float32, stored NHWC-flat.
// Stages a and b broadcast their one value over the output row: they
// stream the stem's bytes (a) and add its stencil access (b) without its
// arithmetic, so the three stages bound what any stem kernel can reach.
//
// What bounds it: bytes. At B = 128, S = 352 the input is 190.3 MB and the
// output 253.8 MB, 0.1326 ms at 3.35 TB/s, while stage c's 6.85 GFLOP of
// float32 FMAs take 0.102 ms at 67 TFLOP/s.
//
// What the design does about it: one block per (image, band of kBand output
// rows). For each output row the block stages the input rows it needs (two
// for a, three for b and c) in shared memory with 16-byte loads where the
// row allows them (3S a multiple of 4: S = 352 gives 4,224-byte rows), then
// computes from shared memory and writes the bf16 row with 16-byte stores
// of 8 packed values. Stage c keeps the 27x32 weights and the bias in
// shared memory; one thread computes one output pixel's group of 8
// channels over the 27 taps, so a warp writes 512 contiguous bytes. The
// TPU body's lane rolls and (h, h, 6) reshape were Mosaic's way to reach
// the stride-2 taps; here a thread reads its taps from the staged rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 32;
constexpr int kGroup = 8;                   // channels per thread and 16-byte store
constexpr int kGroups = kCout / kGroup;
constexpr int kTaps = 27;                   // 3 x 3 x RGB
constexpr int kThreads = 256;
constexpr int kBand = 4;                    // output rows per block
constexpr int kMaxRows = 3;                 // staged input rows per output row

__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ src, int n,
                                          bool vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) d4[k] = __ldg(s4 + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
  }
}

__device__ __forceinline__ void zero_row(float* dst, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = 0.f;
}

// sum over the block; every thread gets the result
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();  // scratch is rewritten by the next row
  return total;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int Stage>
__global__ void __launch_bounds__(kThreads)
stem_probe_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, uint4* __restrict__ out, int s) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // kMaxRows x 3S
  __shared__ float4 sw4[kTaps * kCout / 4];
  __shared__ float sbias[kCout];
  __shared__ float scratch[kThreads / 32];
  float* sw = reinterpret_cast<float*>(sw4);

  const int b = blockIdx.y;
  const int h = s / 2, n3 = 3 * s;
  const int row_chunks = h * kGroups;            // 16-byte chunks per output row
  const float* xb = x + static_cast<size_t>(b) * s * n3;
  const bool vec = (n3 % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  if (Stage == 2) {
    for (int k = threadIdx.x; k < kTaps * kCout; k += blockDim.x) sw[k] = w[k];
    for (int k = threadIdx.x; k < kCout; k += blockDim.x) sbias[k] = bias[k];
  }

  const int i0 = static_cast<int>(blockIdx.x) * kBand;
  const int i_end = min(h, i0 + kBand);
  for (int i = i0; i < i_end; ++i) {
    // stage the input rows of output row i
    if (Stage == 0) {
      stage_row(rows, xb + static_cast<size_t>(i) * n3, n3, vec);
      stage_row(rows + n3, xb + static_cast<size_t>(i + h) * n3, n3, vec);
    } else {
      const int above = 2 * i - 1;
      if (above >= 0) {
        stage_row(rows, xb + static_cast<size_t>(above) * n3, n3, vec);
      } else if (Stage == 1) {
        stage_row(rows, xb + static_cast<size_t>(s - 1) * n3, n3, vec);  // the roll wraps
      } else {
        zero_row(rows, n3);                                                 // the conv's padding
      }
      stage_row(rows + n3, xb + static_cast<size_t>(2 * i) * n3, n3, vec);
      stage_row(rows + 2 * n3, xb + static_cast<size_t>(2 * i + 1) * n3, n3, vec);
    }
    __syncthreads();

    uint4* orow = out + (static_cast<size_t>(b) * h + i) * row_chunks;
    if (Stage == 2) {
      const float* r[3] = {rows, rows + n3, rows + 2 * n3};
      for (int item = threadIdx.x; item < row_chunks; item += blockDim.x) {
        const int j = item / kGroups, g = item % kGroups;
        float acc[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[c] = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int col = 2 * j + kx - 1;
            if (col < 0) continue;  // the zero padding at the left edge
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
              const float v = r[ky][col * 3 + ci];
              const float* wt = sw + ((ky * 3 + kx) * 3 + ci) * kCout + g * kGroup;
              // a rounded product, then a rounded sum, tap by tap: the twin's
              // order, so the two agree bit for bit
#pragma unroll
              for (int c = 0; c < kGroup; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(v, wt[c]));
            }
          }
        }
        float y[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          y[c] = fminf(fmaxf(__fadd_rn(acc[c], sbias[g * kGroup + c]), 0.f), 6.f);
        orow[item] = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
                                pack2(y[6], y[7]));
      }
    } else {
      float part = 0.f;
      if (Stage == 0) {
        for (int l = threadIdx.x; l < n3; l += blockDim.x) part += rows[l] + rows[n3 + l];
      } else {
        const float* p1m = rows;
        const float* p0 = rows + n3;
        const float* p1 = rows + 2 * n3;
        for (int l = threadIdx.x; l < n3; l += blockDim.x) {
          const int lm = l >= 3 ? l - 3 : l - 3 + n3;
          const int lp = l + 3 < n3 ? l + 3 : l + 3 - n3;
          const float a = p0[l] + p1[l] + p1m[l];
          const float am = p0[lm] + p1[lm] + p1m[lm];
          const float ap = p0[lp] + p1[lp] + p1m[lp];
          part += a + am + ap;
        }
      }
      const float v = block_sum(part, scratch);
      const uint32_t p = pack2(v, v);
      const uint4 chunk = make_uint4(p, p, p, p);
      for (int k = threadIdx.x; k < row_chunks; k += blockDim.x) orow[k] = chunk;
    }
    __syncthreads();  // the staged rows are rewritten for the next output row
  }
}

}  // namespace

// x (B, S, S*3) float32, w (9, 3, 32) and bias (32,) float32 (read by stage
// c only), out (B, S/2, S/2*32) bf16; stage 0, 1 or 2 for a, b or c.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int myt_stem_probe(const float* x, const float* w, const float* bias, void* out,
                              int batch, int s, int stage, void* stream) {
  const int h = s / 2;
  const dim3 grid((h + kBand - 1) / kBand, batch);
  const size_t smem = sizeof(float) * kMaxRows * 3 * s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint4* o = static_cast<uint4*>(out);
  switch (stage) {
    case 0: stem_probe_kernel<0><<<grid, kThreads, smem, st>>>(x, w, bias, o, s); break;
    case 1: stem_probe_kernel<1><<<grid, kThreads, smem, st>>>(x, w, bias, o, s); break;
    case 2: stem_probe_kernel<2><<<grid, kThreads, smem, st>>>(x, w, bias, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
