// Sorted segment sum: out[s] = sum of the rows data[i] with seg[i] == s,
// f32 [NS, D] from f32 or f16 data [E, D] and nondecreasing int32 seg [E];
// empty segments are 0 and rows whose id is >= NS (the padding sentinel)
// or negative are dropped.
//
// Replaces the TPU kernel src/repro/kernels/segment_ops/segment_ops.py
// (segment_sum_kernel / _segment_sum_call, reached through
// ops.segment_sum).  The TPU design (one-hot MXU matmuls per 256-row
// block, then an XLA scatter of the partials) exists because the TPU has
// no atomics and a matrix unit that wants 128-wide tiles; none of that
// carries over.
//
// Bound on the H100: bytes.  Each input row is read once and each output
// row written once (E*D*elem + E*4 + NS*D*4 bytes); a sum is one add per
// element, far below the card's arithmetic rate.  What threatens that
// bound is skew: a segment of many rows (a hub vertex, or the padding
// edges of a union graph, which all point at node 0) walked by one warp
// alone is a serial chain of dependent adds.  Design, two launches and no
// atomics, so the result does not depend on scheduling:
//   1. segsum_tiles: one warp per tile of 32 consecutive rows; its lanes
//      stride over the D columns (neighbouring lanes, neighbouring
//      addresses) and add the tile's rows in order, in f32, writing one
//      partial row per run of equal ids (a run ends at an id change or at
//      the tile's end) into the scratch `part`, at the run's first row;
//   2. segsum_gather: one warp per output segment bisects `seg` for the
//      segment's [start, end) (every lane runs the same bisection, so each
//      probe is one broadcast load) and adds its runs' partials in row
//      order: the one at `start` and one at each tile boundary inside
//      (start, end).  A segment of R rows costs ~R/32 partial rows, and
//      every output row is written, zeros included (no memset).
#include <cuda_fp16.h>

#include "common.cuh"

#define SEGSUM_TILE 32
#define SEGSUM_WARPS 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// First index i in [0, E) with seg[i] >= s (E when none).
__device__ __forceinline__ int lower_bound(const int* seg, int E, int s) {
  int lo = 0, hi = E;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void segsum_tiles(const T* data, const int* seg, int E, int D,
                             float* part) {
  int t = blockIdx.x * SEGSUM_WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  int r0 = t * SEGSUM_TILE;
  if (r0 >= E) return;
  int r1 = imin(r0 + SEGSUM_TILE, E);
  for (int c = lane; c < D; c += 32) {
    float acc = 0.0f;
    int run = r0;
    int cur = seg[r0];
    for (int r = r0; r < r1; ++r) {
      int s = seg[r];
      if (s != cur) {
        part[(i64)run * D + c] = acc;
        acc = 0.0f;
        run = r;
        cur = s;
      }
      acc += to_f32(data[(i64)r * D + c]);
    }
    part[(i64)run * D + c] = acc;
  }
}

__global__ void segsum_gather(const float* part, const int* seg, int E,
                              int D, int NS, float* out) {
  int s = blockIdx.x * SEGSUM_WARPS + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (s >= NS) return;
  int start = lower_bound(seg, E, s);
  int end = lower_bound(seg, E, s + 1);
  int first_edge = (start / SEGSUM_TILE + 1) * SEGSUM_TILE;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.0f;
    if (start < end) {
      acc = part[(i64)start * D + c];
      for (int b = first_edge; b < end; b += SEGSUM_TILE)
        acc += part[(i64)b * D + c];
    }
    out[(i64)s * D + c] = acc;
  }
}

// `half_in`: data is f16 (else f32).  `part`: f32 scratch [E, D] the
// caller allocates.  Launches on `stream`; NS == 0 or D == 0 is a no-op.
extern "C" int repro_segment_sum(const void* data, int half_in,
                                 const int* seg, int E, int D, int NS,
                                 float* part, float* out, void* stream) {
  if (E < 0 || D < 0 || NS < 0) return (int)cudaErrorInvalidValue;
  if (NS == 0 || D == 0) return (int)cudaGetLastError();
  int block = 32 * SEGSUM_WARPS;
  if (E > 0) {
    int tiles = grid_for(E, SEGSUM_TILE);
    int grid = grid_for(tiles, SEGSUM_WARPS);
    if (half_in)
      REPRO_LAUNCH(segsum_tiles<__half>, grid, block, stream,
                   (const __half*)data, seg, E, D, part);
    else
      REPRO_LAUNCH(segsum_tiles<float>, grid, block, stream,
                   (const float*)data, seg, E, D, part);
  }
  REPRO_LAUNCH(segsum_gather, grid_for(NS, SEGSUM_WARPS), block, stream,
               part, seg, E, D, NS, out);
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
