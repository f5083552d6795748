// Greedy hard-NMS suppression scan for Hopper (sm_90a).
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_nms.py:pallas_suppress (body
// _suppress_kernel). Same contract: over (B, K, K) float32 in {0, 1}, where
// over[b, i, j] = 1 means candidate i suppresses candidate j if i survives;
// valid (B, K) float32 in {0, 1}; keep (B, K) bool. Per image, K dependent
// steps: alive_i = valid_i && !suppressed_i, keep_i = alive_i, then
// suppressed |= alive_i && over[b, i, :].
//
// What bounds it: the K dependent steps, not bytes. At the serving shape
// (B = 128, K = 256) `over` is B*K*K*4 = 33.5 MB, about 10 us of HBM
// bandwidth, while the scan is 256 steps, each waiting for the previous
// one's decision.
//
// What the design does about it:
//  * one thread block per image, so the B scans run side by side on the
//    SMs; one thread per column j (K <= 1024), which keeps its own
//    `suppressed` bit in a register;
//  * each step costs one shared-memory flag and one __syncthreads():
//    thread i publishes alive_i, every thread j ORs alive_i && over[i][j]
//    into its register. The flag is double-buffered by step parity, so a
//    step needs no second barrier before the flag is rewritten;
//  * `over` is read ahead of the scan in chunks of ROWS rows: each thread
//    starts its ROWS column loads (coalesced across the warp) together,
//    so one memory latency is paid per chunk instead of one per step.
// Later work: rows as bitmasks, and building `over` (the IoU test) inside
// the kernel instead of reading it from memory.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;
constexpr int MAX_K = 1024;  // kernels/nms_suppress.py:MAX_K

// the bound caps registers so that a 1024-thread block can launch
__global__ void __launch_bounds__(MAX_K)
nms_suppress_kernel(const float* __restrict__ over, const float* __restrict__ valid,
                    bool* __restrict__ keep, int k) {
  __shared__ int alive_flag[2];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool in_range = j < k;
  const float* over_b = over + static_cast<size_t>(b) * k * k;
  const bool valid_j = in_range && valid[static_cast<size_t>(b) * k + j] > 0.5f;
  bool suppressed = false;
  bool kept = false;

  for (int i0 = 0; i0 < k; i0 += ROWS) {
    float rows[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r;
      rows[r] = (in_range && i < k) ? over_b[static_cast<size_t>(i) * k + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r;
      if (i >= k) break;  // same i in every thread: the barrier stays uniform
      if (j == i) {
        kept = valid_j && !suppressed;
        alive_flag[i & 1] = kept;
      }
      __syncthreads();
      if (alive_flag[i & 1] && rows[r] > 0.f) suppressed = true;
    }
  }
  if (in_range) keep[static_cast<size_t>(b) * k + j] = kept;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int myt_nms_suppress(const float* over, const float* valid,
                                bool* keep, int batch, int k, void* stream) {
  const int threads = (k + 31) / 32 * 32;
  nms_suppress_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      over, valid, keep, k);
  return static_cast<int>(cudaGetLastError());
}
