// Staged stem roofline probe for Hopper (sm_90a).
//
// Replaces tools/probe_stem_pallas.py:126, the pallas_call in main.build
// (bodies _kernel_a :32, _kernel_b :43, _kernel_c :61): a grid of one image
// a step, the whole (S, 3S) image in VMEM, the stride-2 taps reached by
// lane rolls and an (h, h, 6) reshape, stage c as 9 dots of K = 3. Same
// contract: x (B, S, S*3) float32, the NHWC image with each row's pixels
// flattened, S even; out (B, S/2, S/2*32) bf16. With h = S/2 and rows
// taken whole:
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
// output 253.8 MB, 0.1326 ms at 3.35 TB/s. Stage c's 6.85 GFLOP would take
// 0.102 ms as float32 FMAs on the CUDA cores (67 TFLOP/s); as three TF32
// passes on the tensor cores (24.4 GFLOP of mma.sync m16n8k8, K padded to
// 32) 0.049 ms at the published 495 TFLOP/s, which mma.sync does not reach,
// so the products can hide under the stream, but only if the block keeps
// rows in flight while it computes and spends few instructions a product.
//
// What the design does about it:
//  * stage a, a plain stream of the stem's bytes, keeps the first port's
//    design: a block per (image, band of 4 output rows), 256 threads
//    staging the two input rows with 16-byte loads, a block sum, 16-byte
//    stores; many small blocks stream these bytes faster than the ring
//    below (by 1.5-3% on an H100);
//  * stages b and c: persistent blocks, one an SM, walking work items of 16
//    consecutive output rows of the B h in (image, row) order by a grid
//    stride, so the blocks work on neighbouring rows of a few images at a
//    time; an item that spans two images is walked as two segments. Each
//    segment stages its input rows once (row 2i + 1 stays as row i + 1's
//    top row); the one row two segments share is read twice, the second
//    time from the L2. (Items of 4 rows, and one contiguous run of rows a
//    block, were 3-4% slower on an H100);
//  * a loader warp streams the segments' input rows in the order they are
//    used into a ring of shared-memory slots, one bulk copy (12S bytes) a
//    row completing on the slot's full mbarrier (bulk_ring.cuh), and
//    refills a slot when every compute warp has arrived on its empty
//    mbarrier: rows are in flight while the block computes. Rows that
//    cannot take bulk copies (S % 4 == 2, or x not 16-byte aligned) are
//    copied element by element by the whole loader warp (3.5x slower at
//    S = 352, where they are not needed);
//  * each slot keeps four zero floats left of its row, so the padding
//    column 2j - 1 = -1 needs no branch; a zero row stands above row 0;
//  * 11 compute warps (12 warps a block leave 168 registers a thread, so
//    the weights stay in registers) take the units of the rows round
//    robin: stage c's 16-pixel m-tiles (11 a row at S = 352), stage b's
//    whole rows, one warp summing a row;
//  * stage c is an implicit GEMM a unit: M = 16 pixels, N = 32, K = the 27
//    taps zero-padded to 32, in an order (StemTile) that gives each lane
//    its two A columns of a k-step as adjacent floats of a staged row: one
//    8-byte load a pixel and k-step (ldmatrix cannot read the stride-2
//    window). mma.sync m16n8k8 in three TF32 passes (small products first,
//    chained in one accumulator that starts at the bias): float32-accurate
//    whatever allow_tf32 says, and 18% faster than a fresh accumulator a
//    k-step, which the 12 products of K = 8 an output do not need; the
//    weights split into hi and lo once. (Register-blocked float32 FMAs on
//    the CUDA cores instead, 4 pixels x 4 channels a thread, were 38%
//    slower);
//  * epilogue: clamp to [0, 6], one bf16 rounding, the unit's 16 x 32 tile
//    staged in a per-warp 1 KB buffer (16-byte chunks XOR-swizzled, so
//    neither side conflicts) and written as 1 KB of contiguous 16-byte
//    streaming stores (9% faster than 4-byte stores from the fragments).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_ring.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace myt_mma;
using namespace myt_ring;

constexpr int kCout = 32;
constexpr int kTaps = 27;                    // 3 x 3 x RGB
constexpr int kWarps = 11;                   // compute warps (12 warps: up to 168 registers)
constexpr int kThreads = (kWarps + 1) * 32;  // and the loader warp
constexpr int kPad = 4;                      // zero floats left of each staged row
constexpr int kMaxSlots = 16;                // ring slots, one input row each
constexpr int kTile = 16;                    // output pixels of a stage-c unit
constexpr int kTileWords = kTile * kCout / 2;  // a unit's bf16 output, 32-bit words
constexpr int kBand = 16;                    // output rows of a work item
constexpr int kSmemLimit = 232448;           // a block's shared memory on sm_90
constexpr int kStreamThreads = 256;          // stage a: threads of a block
constexpr int kStreamBand = 4;               // stage a: output rows of a block

// floats per slot: the zero pad and the row, 16-byte aligned
__host__ __device__ constexpr int row_ld(int s) { return (kPad + 3 * s + 3) & ~3; }
// dynamic shared memory besides the ring: the full and empty mbarriers, the
// per-warp output tiles, the zero row
__host__ __device__ constexpr int fixed_bytes(int s) {
  return 2 * kMaxSlots * 8 + kWarps * kTileWords * 4 + 4 * row_ld(s);
}
static_assert(fixed_bytes(1024) + 3 * 4 * row_ld(1024) <= kSmemLimit,
              "a ring of three rows fits at S = 1024 (stem_probe.py:MAX_SIZE)");

struct Probe {
  const float* x;
  const float* w;
  const float* bias;
  uint4* out;
  int batch, s, slots;
  bool vec;  // 16-byte bulk copies of whole rows
};

// Work item j is the output rows [j kBand, (j + 1) kBand) of the B h in
// (image, row) order, cut at image boundaries into segments. A segment is
// output rows i0 .. i0 + n - 1 of image b. Its staged input rows, in order
// (positions 0 .. count - 1), are 2 i0 - 1, 2 i0, ..., 2 (i0 + n) - 1;
// output row k reads positions 2k - skip, 2k + 1 - skip and 2k + 2 - skip,
// where stage c skips row -1 at i0 = 0 (skip = 1; position -1 is then the
// zero row) and stage b stages row S-1 in its place.
template <int Stage>
struct Segment {
  int b, i0, n, skip;

  // the segment of rows [r, r_end) that starts at row r
  __device__ Segment(int r, int r_end, int h) {
    b = r / h;
    i0 = r - b * h;
    n = min(h - i0, r_end - r);
    skip = Stage == 2 && i0 == 0;
  }
  __device__ int count() const { return 2 * n + 1 - skip; }
  __device__ int source_row(int pos, int s) const {
    const int r = 2 * i0 - 1 + pos + skip;
    return r < 0 ? s - 1 : r;
  }
  // the first position output row k reads
  __device__ int first(int k) const { return max(2 * k - skip, 0); }
  // one past the last
  __device__ int end(int k) const { return 2 * k + 3 - skip; }
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// the 16-byte chunk q of pixel p of a staged output tile sits at chunk
// q ^ swz(p): a fragment store (pixels g, 4 words apart) and a chunk load
// (8 consecutive chunks) then touch 32 distinct banks
__device__ __forceinline__ int swz(int p) { return (p >> 1) & 3; }

// The loader: every staged row of the block's segments, in order, into
// slot (position mod slots).
template <int Stage>
__device__ void load_rows(const Probe& p, float* ring, uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31, h = p.s / 2, n3 = 3 * p.s, ld = row_ld(p.s);
  const int total = p.batch * h;
  if (p.vec && lane != 0) return;  // one thread starts the bulk copies
  int slot = 0;
  uint32_t lap = 0;
  for (int r0 = blockIdx.x * kBand; r0 < total; r0 += gridDim.x * kBand) {
    const int r_end = min(r0 + kBand, total);
    for (int r = r0; r < r_end;) {
      const Segment<Stage> g(r, r_end, h);
      const float* xb = p.x + static_cast<size_t>(g.b) * p.s * n3;
      for (int pos = 0; pos < g.count(); ++pos) {
        if (lap > 0) mbar_wait(&empty[slot], (lap - 1) & 1);
        const float* src = xb + static_cast<size_t>(g.source_row(pos, p.s)) * n3;
        float* dst = ring + slot * ld + kPad;
        if (p.vec) {
          mbar_arrive_expect_tx(&full[slot], 4 * n3);
          bulk_load(dst, src, 4 * n3, &full[slot]);
        } else {
          for (int l = lane; l < n3; l += 32) dst[l] = __ldg(src + l);
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[slot]);
        }
        if (++slot == p.slots) {
          slot = 0;
          ++lap;
        }
      }
      r += g.n;
    }
  }
}

// A compute warp's view of the ring: the positions it has waited for and
// released so far (both in order).
struct RingCursor {
  uint64_t* full;
  uint64_t* empty;
  int slots;
  int ready = 0, ready_slot = 0, freed = 0, freed_slot = 0;
  uint32_t ready_lap = 0;

  __device__ RingCursor(uint64_t* f, uint64_t* e, int n) : full(f), empty(e), slots(n) {}
  // positions [0, pos) have landed
  __device__ void wait_until(int pos) {
    for (; ready < pos; ++ready) {
      mbar_wait(&full[ready_slot], ready_lap & 1);
      if (++ready_slot == slots) {
        ready_slot = 0;
        ++ready_lap;
      }
    }
  }
  // the warp is done with positions [0, pos). A slot is released only once
  // its row has landed, so each arrival counts toward the phase of its own
  // use of the slot.
  __device__ void release_until(int pos) {
    wait_until(pos);
    __syncwarp();
    for (; freed < pos; ++freed) {
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[freed_slot]);
      if (++freed_slot == slots) freed_slot = 0;
    }
  }
};

// Stage c's unit: output pixels m0 .. m0 + 15 of one row, all 32 channels.
//
// K order: k-step ks of lane t (t = lane % 4) holds A columns 8 ks + t and
// 8 ks + t + 4, which mma_tf32.cuh's fragment maps put in registers (a0,
// a2) for pixel g and (a1, a3) for pixel g + 8. Call s = 4 ks + t the
// lane's slot; slot s < 15 reads tap row ky = s / 5 and i = s % 5, and
// its two columns are the taps jj = 2i - 1 and 2i of that row, adjacent
// floats at row_ky[6 j + 2i - 4] (8-byte aligned): one 8-byte load per
// pixel and k-step. Slots with i = 0 have only tap 0 (their first float is
// the previous pixel's, zeroed, with zero weights); slot 15 is padding.
// The weights' rows are permuted the same way.
struct StemTile {
  uint32_t b_hi[4][4][2], b_lo[4][4][2];  // [k-step][n-tile]: the weights split once
  float bias[4][2];

  // the tap (9 ky + jj) of column half `second` of slot s, or -1
  __device__ static int tap(int s, int second) {
    const int ky = s / 5, i = s % 5;
    return s >= 15 || (i == 0 && !second) ? -1 : 9 * ky + 2 * i - 1 + second;
  }

  __device__ void load(const float* __restrict__ w, const float* __restrict__ bias_g) {
    const int lane = threadIdx.x & 31, g = tf32_b_n(lane), t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // b_i is k = 8 ks + tf32_b_k(lane, i) = column half i of slot 4 ks + t
          const int k = tap(4 * ks + t, i);
          const float v = k >= 0 ? __ldg(w + k * kCout + 8 * nt + g) : 0.f;
          split_tf32(v, b_hi[ks][nt][i], b_lo[ks][nt][i]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // accumulator columns 8 nt + 2t and the next (mma_bf16.cuh:acc_col)
      bias[nt][0] = __ldg(bias_g + 8 * nt + 2 * t);
      bias[nt][1] = __ldg(bias_g + 8 * nt + 2 * t + 1);
    }
  }

  // The float offsets, from sm, of this lane's 4 slots at pixel 0, given
  // the offsets rows[ky] of the staged input rows (their column 0).
  __device__ static void columns(const int (&rows)[3], int (&col)[4]) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int s = min(4 * ks + t, 14), ky = s / 5;
      col[ks] = (ky == 0 ? rows[0] : ky == 1 ? rows[1] : rows[2]) + 2 * (s % 5) - 4;
    }
  }

  __device__ void run(const float* sm, const int (&col)[4], uint32_t* tile,
                      uint4* __restrict__ orow, int m0, int h) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // the pixels of rows g and g + 8 (clamped: a ragged tile's extra rows
    // are computed from a valid pixel and never stored)
    const int xa = 6 * min(m0 + g, h - 1), xb = 6 * min(m0 + g + 8, h - 1);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][0] = acc[nt][2] = bias[nt][0];
      acc[nt][1] = acc[nt][3] = bias[nt][1];
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float2 va = *reinterpret_cast<const float2*>(sm + col[ks] + xa);
      const float2 vb = *reinterpret_cast<const float2*>(sm + col[ks] + xb);
      const int s = 4 * ks + t;
      const bool first = s % 5 != 0 && s < 15, second = s < 15;
      const float a[4] = {first ? va.x : 0.f, first ? vb.x : 0.f, second ? va.y : 0.f,
                          second ? vb.y : 0.f};
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], a_hi[i], a_lo[i]);
      // three TF32 passes, the small products first, chained in one
      // accumulator: 12 products of K = 8 per output keep float32's
      // accuracy (a long chain does not: mma_tf32.cuh:mma_3xtf32)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[nt], a_lo, b_hi[ks][nt][0], b_hi[ks][nt][1]);
        mma_tf32(acc[nt], a_hi, b_lo[ks][nt][0], b_lo[ks][nt][1]);
        mma_tf32(acc[nt], a_hi, b_hi[ks][nt][0], b_hi[ks][nt][1]);
      }
    }
    // C fragment: (g, 2t .. 2t+1) and (g + 8, 2t .. 2t+1) of each n-tile,
    // i.e. word t of chunk nt of pixels g and g + 8
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      tile[g * 16 + (nt ^ swz(g)) * 4 + t] = pack2(relu6(acc[nt][0]), relu6(acc[nt][1]));
      tile[(g + 8) * 16 + (nt ^ swz(g + 8)) * 4 + t] =
          pack2(relu6(acc[nt][2]), relu6(acc[nt][3]));
    }
    __syncwarp();
    const uint4* tile4 = reinterpret_cast<const uint4*>(tile);
#pragma unroll
    for (int c = lane; c < kTile * 4; c += 32) {
      const int px = c >> 2, q = c & 3;
      if (m0 + px < h) __stcs(orow + (m0 + px) * 4 + q, tile4[px * 4 + (q ^ swz(px))]);
    }
    __syncwarp();  // the tile is rewritten by the warp's next unit
  }
};

// Stage b: one warp sums the stencil over the row's staged inputs (rows[0
// .. 2] = 2i - 1, 2i, 2i + 1) and broadcasts the bf16 value over the
// output row.
__device__ void stencil_row(const float* sm, const int (&rows)[3], uint4* __restrict__ orow,
                            int n3, int h) {
  const int lane = threadIdx.x & 31;
  const float* p1m = sm + rows[0];
  const float* p0 = sm + rows[1];
  const float* p1 = sm + rows[2];
  float part = 0.f;
  for (int l = lane; l < n3; l += 32) {
    const int lm = l >= 3 ? l - 3 : l - 3 + n3;
    const int lp = l + 3 < n3 ? l + 3 : l + 3 - n3;
    const float a = p0[l] + p1[l] + p1m[l];
    const float am = p0[lm] + p1[lm] + p1m[lm];
    const float ap = p0[lp] + p1[lp] + p1m[lp];
    part += a + am + ap;
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  const uint32_t pk = pack2(part, part);
  const uint4 chunk = make_uint4(pk, pk, pk, pk);
  for (int c = lane; c < h * 4; c += 32) __stcs(orow + c, chunk);
}

// A compute warp: for every output row of the block's segments, its units
// (round robin over the warps, continuing across rows), then the release
// of the positions no later row reads. Rows are addressed as float offsets
// from sm, the zero row, which the ring follows.
template <int Stage>
__device__ void compute_rows(const Probe& p, const float* sm, uint32_t* tile, RingCursor& cur,
                             int warp) {
  const int h = p.s / 2, n3 = 3 * p.s, ld = row_ld(p.s);
  const int total = p.batch * h;
  const int units = Stage == 2 ? (h + kTile - 1) / kTile : 1;  // b: one a row
  StemTile stem;
  if (Stage == 2) stem.load(p.w, p.bias);
  int pos0 = 0;  // ring position of the segment's first staged row
  int turn = 0;  // the warp that takes the row's first unit
  for (int r0 = blockIdx.x * kBand; r0 < total; r0 += gridDim.x * kBand) {
    const int r_end = min(r0 + kBand, total);
    for (int r = r0; r < r_end;) {
      const Segment<Stage> g(r, r_end, h);
      for (int k = 0; k < g.n; ++k) {
        int u = warp - turn;
        if (u < 0) u += kWarps;
        if (u < units) {
          cur.wait_until(pos0 + g.end(k));
          // the row's staged inputs, the last of them in the slot before
          // cur.ready_slot
          int rows[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int back = 3 - q;
            int slot = cur.ready_slot - back;
            if (slot < 0) slot += p.slots;
            rows[q] = kPad + (g.end(k) < back ? 0 : (1 + slot) * ld);
          }
          uint4* orow = p.out + (static_cast<size_t>(g.b) * h + g.i0 + k) * h * (kCout / 8);
          if (Stage == 2) {
            int col[4];
            StemTile::columns(rows, col);
            for (; u < units; u += kWarps) stem.run(sm, col, tile, orow, u * kTile, h);
          } else {
            stencil_row(sm, rows, orow, n3, h);
          }
        }
        turn += units % kWarps;
        if (turn >= kWarps) turn -= kWarps;
        cur.release_until(pos0 + (k + 1 < g.n ? g.first(k + 1) : g.count()));
      }
      pos0 += g.count();
      r += g.n;
    }
  }
}

template <int Stage>
__global__ void __launch_bounds__(kThreads, 1) stem_probe_kernel(const Probe p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxSlots;
  uint32_t* tiles = reinterpret_cast<uint32_t*>(empty + kMaxSlots);
  float* zero = reinterpret_cast<float*>(tiles + kWarps * kTileWords);
  const int ld = row_ld(p.s);
  float* ring = zero + ld;
  // the warp index broadcast from lane 0, so the compiler sees it is the
  // same across the warp
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);

  for (int k = threadIdx.x; k < ld; k += blockDim.x) zero[k] = 0.f;
  for (int k = threadIdx.x; k < p.slots * kPad; k += blockDim.x) {
    ring[(k / kPad) * ld + k % kPad] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    load_rows<Stage>(p, ring, full, empty);
  } else {
    RingCursor cur(full, empty, p.slots);
    compute_rows<Stage>(p, zero, tiles + warp * kTileWords, cur, warp);
  }
}

// Stage a: the block stages input rows i and i + h of each of its output
// rows, sums them, and writes the row.
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

// sum over the block; every thread gets the result
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kStreamThreads / 32; ++w) total += scratch[w];
  __syncthreads();  // scratch is rewritten by the next row
  return total;
}

__global__ void __launch_bounds__(kStreamThreads)
stream_rows_kernel(const float* __restrict__ x, uint4* __restrict__ out, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);  // 2 x 3S
  __shared__ float scratch[kStreamThreads / 32];
  const int b = blockIdx.y, h = s / 2, n3 = 3 * s;
  const float* xb = x + static_cast<size_t>(b) * s * n3;
  const bool vec = (n3 % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int i0 = static_cast<int>(blockIdx.x) * kStreamBand;
  const int i_end = min(h, i0 + kStreamBand);
  for (int i = i0; i < i_end; ++i) {
    stage_row(rows, xb + static_cast<size_t>(i) * n3, n3, vec);
    stage_row(rows + n3, xb + static_cast<size_t>(i + h) * n3, n3, vec);
    __syncthreads();
    float part = 0.f;
    for (int l = threadIdx.x; l < n3; l += blockDim.x) part += rows[l] + rows[n3 + l];
    const float v = block_sum(part, scratch);
    const uint32_t pk = pack2(v, v);
    const uint4 chunk = make_uint4(pk, pk, pk, pk);
    uint4* orow = out + (static_cast<size_t>(b) * h + i) * h * (kCout / 8);
    for (int k = threadIdx.x; k < h * 4; k += blockDim.x) orow[k] = chunk;
    __syncthreads();  // the staged rows are rewritten for the next output row
  }
}

// Host side.

template <int Stage>
int launch(const Probe& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_probe_kernel<Stage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (p.batch * (p.s / 2) + kBand - 1) / kBand;
  const int grid = items < sms ? items : sms;
  stem_probe_kernel<Stage><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, S*3) float32, w (9, 3, 32) and bias (32,) float32 (read by stage
// c only), out (B, S/2, S/2*32) bf16; stage 0, 1 or 2 for a, b or c.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Stages b and c: the ring holds as many rows as fit in a block's shared
// memory, at most 16; the grid is one block an SM (or one a work item, if
// fewer).
extern "C" int myt_stem_probe(const float* x, const float* w, const float* bias, void* out,
                              int batch, int s, int stage, void* stream) {
  if (batch < 1 || s < 2 || s % 2 != 0 || stage < 0 || stage > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    const int h = s / 2;
    const dim3 grid((h + kStreamBand - 1) / kStreamBand, batch);
    stream_rows_kernel<<<grid, kStreamThreads, sizeof(float) * 2 * 3 * s, st>>>(
        x, static_cast<uint4*>(out), s);
    return static_cast<int>(cudaGetLastError());
  }
  const int slot_bytes = 4 * row_ld(s);
  const int fit = (kSmemLimit - fixed_bytes(s)) / slot_bytes;
  const int slots = fit < kMaxSlots ? fit : kMaxSlots;
  if (slots < 3) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (3 * s) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Probe p{x, w, bias, static_cast<uint4*>(out), batch, s, slots, vec};
  const int smem = fixed_bytes(s) + slots * slot_bytes;
  return stage == 1 ? launch<1>(p, smem, st) : launch<2>(p, smem, st);
}
