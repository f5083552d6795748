// Greedy hard-NMS suppression scan for Hopper (sm_90a).
//
// Replaces mobilenet_yolo_tpu/kernels/pallas_nms.py:pallas_suppress (body
// _suppress_kernel). Same contract: over (B, K, K) float32 in {0, 1}, where
// over[b, i, j] = 1 means candidate i suppresses candidate j if i survives;
// valid (B, K) float32 in {0, 1}; keep (B, K) bool. Per image, K dependent
// steps: alive_i = valid_i && !suppressed_i, keep_i = alive_i, then
// suppressed |= alive_i && over[b, i, :].
//
// What bounds it: bytes, if the K dependent steps stay off their path.
// keep never depends on over[b, i, j] for j <= i (at step i, keep[j] for
// j <= i is already written and never read again), so only the strict
// upper triangle need be read: at the serving shape (B = 128, K = 256)
// 16.7 MB, ~5 us of HBM, half of the whole matrix.
//
// What the design does about it:
//  * one block of 16 warps per image. Fifteen warps stream the triangle's
//    32-column words (a row's words from its own word on) with 16-byte
//    loads, eight a warp in flight (~60 KB a block), and pack each word
//    into a bitmask in shared memory with three shuffles; K / 32 words a
//    row, 8 KB an image at K = 256, 128 KB at K = 1024. Words are taken
//    in the scan's order, 32 rows (a chunk) at a time, and each chunk's
//    words arrive on an mbarrier of its own (release on arrival, acquire
//    on the wait);
//  * the other warp scans, without a block barrier, 32 candidates a step,
//    as soon as their chunk's mbarrier completes: it resolves the chunk's
//    diagonal word serially in registers (every lane runs the same 32
//    dependent ORs on broadcast reads, branch-free so the reads go out
//    ahead), then each lane ORs the kept rows' words into the `removed`
//    word of one later column block. So the scan overlaps the loads, and
//    keep is written once at the end;
//  * the warp index comes from a shuffle, which tells the compiler it is
//    uniform across the warp: derived from threadIdx.x alone, every
//    shuffle under the role branch compiled to a divergence-safe sequence
//    (WARPSYNC.COLLECTIVE ... ENDCOLLECTIVE), which took the first version
//    to 2x this one's time.
// Later work: building `over` (the IoU test) inside the kernel instead of
// reading it from memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_K = 1024;  // kernels/nms_suppress.py:MAX_K
constexpr int kWarps = 16;   // warp 0 scans, the others load
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;    // loads a loading warp keeps in flight
constexpr unsigned kFull = 0xffffffffU;

// Dynamic shared memory: one 8-byte mbarrier a chunk (nw of them, each
// completing when its 32 rows' words are packed), mask[32 * nw][nw] words
// (row i's word w at i * nw + w), removed[nw] (the scan's state: word w's
// candidates invalid, out of range, or suppressed by a kept candidate of
// an earlier chunk), then the work table (chunk << 8 | word) of the
// nw (nw + 1) / 2 (chunk, word >= chunk) pairs.
__host__ __device__ constexpr int smem_words(int nw) {
  return 2 * nw + 32 * nw * nw + nw + nw * (nw + 1) / 2;
}
static_assert(sizeof(uint32_t) * smem_words(MAX_K / 32) <= 232448,
              "the bitmasks of K = MAX_K fit a block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// an mbarrier whose phase 0 completes after `count` arrivals
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
// `count` arrivals, with release semantics: this thread's earlier writes
// (and those ordered before them) are visible to a thread whose wait
// sees the phase complete
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, int count) {
  uint64_t state;
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(count) : "memory");
}
// wait for phase 0 to complete, with acquire semantics
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile("{\n .reg .pred p_done;\n WAIT:\n"
               " mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p_done, [%0], 0;\n"
               " @!p_done bra WAIT;\n}" ::"r"(smem_addr(bar)) : "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float* __restrict__ over, const float* __restrict__ valid,
                    bool* __restrict__ keep, int k) {
  extern __shared__ uint32_t smem[];
  const int nw = (k + 31) / 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* mask = smem + 2 * nw;
  uint32_t* removed = mask + 32 * nw * nw;
  int* table = reinterpret_cast<int*>(removed + nw);
  // the warp index broadcast from lane 0, so the compiler sees it is the
  // same across the warp: its shuffles then need no divergence handling
  const int warp = __shfl_sync(kFull, static_cast<int>(threadIdx.x >> 5), 0);
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  if (threadIdx.x < nw) {
    const int c = threadIdx.x, start = c * nw - c * (c - 1) / 2;
    mbar_init(&bars[c], min(32, k - 32 * c) * (nw - c));
    for (int w = c; w < nw; ++w) table[start + w - c] = (c << 8) | w;
  }
  __syncthreads();

  const float* over_b = over + static_cast<size_t>(b) * k * k;
  if (warp > 0) {
    // load L covers chunk word (c, w) of table[L / 8], rows 32c + 4 (L % 8)
    // + 0..3, one row per 8 lanes, each lane 4 columns of the word
    const int total = 4 * nw * (nw + 1);
    const int group = lane >> 3, quarter = lane & 7;
    for (int base = warp - 1; base < total; base += (kWarps - 1) * kLoads) {
      float4 v[kLoads];
      int row[kLoads], cw[kLoads];
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const int load = base + m * (kWarps - 1);
        cw[m] = load < total ? table[load >> 3] : 0;
        row[m] = 32 * (cw[m] >> 8) + 4 * (load & 7) + group;
        const int col = 32 * (cw[m] & 255) + 4 * quarter;
        const float* src = over_b + static_cast<size_t>(row[m]) * k + col;
        v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (load < total && row[m] < k) {
          if constexpr (kVec) {
            if (col < k) v[m] = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            if (col < k) v[m].x = __ldg(src);
            if (col + 1 < k) v[m].y = __ldg(src + 1);
            if (col + 2 < k) v[m].z = __ldg(src + 2);
            if (col + 3 < k) v[m].w = __ldg(src + 3);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        uint32_t bits = ((v[m].x > 0.f) | (v[m].y > 0.f) << 1 | (v[m].z > 0.f) << 2 |
                         (v[m].w > 0.f) << 3) << (4 * quarter);
        bits |= __shfl_xor_sync(kFull, bits, 1);
        bits |= __shfl_xor_sync(kFull, bits, 2);
        bits |= __shfl_xor_sync(kFull, bits, 4);
        if (quarter == 0 && base + m * (kWarps - 1) < total && row[m] < k) {
          mask[row[m] * nw + (cw[m] & 255)] = bits;
        }
      }
      __syncwarp();  // the warp's words before lane 0's arrivals release them
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kLoads; ++m) {
          const int load = base + m * (kWarps - 1);
          // rows of this load inside the image: 4 but at the last chunk
          const int rows = min(4, max(0, k - (row[m] - group)));
          if (load < total && rows > 0) mbar_arrive(&bars[cw[m] >> 8], rows);
        }
      }
    }
    return;
  }

  // warp 0, the scan: lane l keeps removed[l]; once chunk c is scanned,
  // removed[c] holds its final word, clear exactly at the kept candidates
  const float* valid_b = valid + static_cast<size_t>(b) * k;
  bool* keep_b = keep + static_cast<size_t>(b) * k;
  if (lane < nw) {
    // 32 reads from in-range addresses, none behind a branch, so all are
    // in flight at once (a guarded read each waited for the one before)
    uint32_t word = kFull;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = 32 * lane + e;
      const float v = valid_b[min(j, k - 1)];
      word &= ~(static_cast<uint32_t>(j < k && v > 0.5f) << e);
    }
    removed[lane] = word;
  }
  __syncwarp();  // every lane reads the words the lanes below nw wrote
  for (int c = 0; c < nw; ++c) {
    mbar_wait(&bars[c]);
    // the chunk's diagonal word, every lane the same 32 steps: row 32c + t,
    // only its columns after t, ORed in where candidate t is alive (kept).
    // Branch-free, so the 32 broadcast reads go out ahead of the chain; a
    // row past K is never ORed in (its candidate is out of range, so
    // removed), whatever its words hold
    uint32_t cur = removed[c];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t row_t = mask[(32 * c + t) * nw + c] & (0xfffffffeU << t);
      cur |= row_t & (((cur >> t) & 1U) - 1U);
    }
    // a bit is set only above the step that sets it, so bit t of the final
    // word is clear exactly where candidate t was kept
    const uint32_t kept = ~cur;
    if (lane > c && lane < nw) {
      uint32_t hit = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        hit |= mask[(32 * c + t) * nw + lane] & (0U - ((kept >> t) & 1U));
      }
      removed[lane] |= hit;
    }
    __syncwarp();  // every lane has read removed[c] and written its word
    if (lane == 0) removed[c] = cur;
    __syncwarp();  // removed[c + 1] and removed[c] before the next reads
  }
  for (int j = lane; j < k; j += 32) keep_b[j] = !((removed[j >> 5] >> (j & 31)) & 1U);
}

template <bool kVec>
int launch(const float* over, const float* valid, bool* keep, int batch, int k,
           cudaStream_t stream) {
  const int nw = (k + 31) / 32;
  const size_t bytes = sizeof(uint32_t) * smem_words(nw);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_suppress_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_suppress_kernel<kVec><<<batch, kThreads, bytes, stream>>>(over, valid, keep, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success). `vec`
// (K % 4 == 0 and `over` 16-byte aligned) takes the 16-byte loads.
extern "C" int myt_nms_suppress(const float* over, const float* valid, bool* keep, int batch,
                                int k, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(over, valid, keep, batch, k, st)
             : launch<false>(over, valid, keep, batch, k, st);
}
