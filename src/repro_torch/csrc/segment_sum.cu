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
// edges of a union graph, which all point at node 0: 85,081 of 163,840
// rows in the GNN trainer) added by one warp is a serial chain of
// dependent adds, ~2,660 tile partials long.  Design, no atomics, so the
// sums' order depends only on `seg` and two calls give the same bits:
//   * a group of threads, one per vector of W columns (float4 / float2 /
//     f16 pairs where D allows; D = 70 is 35 pairs, so a block of 7 groups
//     runs 245 of 256 lanes), adds each tile of SEGSUM_ROWS consecutive
//     rows in row order.  A run of equal ids that starts and ends inside
//     the tile is a whole segment and goes straight to `out`; the run that
//     continues into the tile before and the one that continues into the
//     tile after (at most two a tile) go to a partial slot with their id
//     and which sides continue;
//   * the same step over the slots, SEGSUM_FAN slots a group in slot
//     order, level after level (one launch each, ~log_FAN(E / ROWS)
//     levels): a run whose first slot continues nowhere to the left and
//     whose last slot nowhere to the right is whole and goes to `out`,
//     the others to the next level's slots.  A hub's partials spread over
//     many groups at every level; its chain is ROWS + FAN * levels adds;
//   * the launch's last blocks write zeros to the segments no row names
//     (one bisection of `seg` a segment), so every output row is written
//     once, zeros included, with no memset.
// Scratch: two slot levels (ping-pong), ~2 rows a tile, not [E, D].
// A/B on an NVIDIA H100 80GB HBM3 at 700 W, the GNN trainer's f32
// [163,840, 70] (device ms, tiles + levels): rows 32, fan 16, each level's
// slots loaded before any add, 0.047 + 0.017; a level walking its slots
// one load at a time, fan 32, 0.047 + 0.044; fan 8 0.047 + 0.017 over two
// more launches; rows 16 0.047 + 0.020; zero blocks first 0.052 + 0.016.
#include <cuda_fp16.h>

#include "common.cuh"

#define SEGSUM_ROWS 32
#define SEGSUM_FAN 16
#define SEGSUM_THREADS 256

// a partial slot's flags: its segment has rows before / after it
#define SEGSUM_LEFT 1
#define SEGSUM_RIGHT 2

template <int W>
struct Vec {
  float a[W];
};

template <int W>
__device__ __forceinline__ void vload(Vec<W>& v, const float* p) {
  if (W == 4) {
    float4 x = *(const float4*)p;
    v.a[0] = x.x; v.a[1] = x.y; v.a[2 % W] = x.z; v.a[3 % W] = x.w;
  } else if (W == 2) {
    float2 x = *(const float2*)p;
    v.a[0] = x.x; v.a[1 % W] = x.y;
  } else {
    v.a[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void vload(Vec<W>& v, const __half* p) {
  if (W == 4) {
    uint2 raw = *(const uint2*)p;
    float2 x = __half22float2(*(const __half2*)&raw.x);
    float2 y = __half22float2(*(const __half2*)&raw.y);
    v.a[0] = x.x; v.a[1] = x.y; v.a[2 % W] = y.x; v.a[3 % W] = y.y;
  } else if (W == 2) {
    float2 x = __half22float2(*(const __half2*)p);
    v.a[0] = x.x; v.a[1 % W] = x.y;
  } else {
    v.a[0] = __half2float(*p);
  }
}

template <int W>
__device__ __forceinline__ void vstore(float* p, const Vec<W>& v) {
  if (W == 4) {
    *(float4*)p = make_float4(v.a[0], v.a[1], v.a[2 % W], v.a[3 % W]);
  } else if (W == 2) {
    *(float2*)p = make_float2(v.a[0], v.a[1 % W]);
  } else {
    *p = v.a[0];
  }
}

template <int W>
__device__ __forceinline__ void vzero(Vec<W>& v) {
#pragma unroll
  for (int k = 0; k < W; ++k) v.a[k] = 0.0f;
}

template <int W>
__device__ __forceinline__ void vadd(Vec<W>& acc, const Vec<W>& x) {
#pragma unroll
  for (int k = 0; k < W; ++k) acc.a[k] += x.a[k];
}

// One finished run of group g (a tile or a group of slots): a whole
// segment goes to `out`; one that continues to the left takes slot 2g,
// one that continues only to the right slot 2g + 1.  Returns the slot
// taken (or -1).
template <int W>
__device__ __forceinline__ int segsum_emit(int id, int flags,
                                           const Vec<W>& acc, int g, int D,
                                           int col, float* out,
                                           float* slots) {
  if (!flags) {
    vstore<W>(out + (i64)id * D + col, acc);
    return -1;
  }
  int slot = 2 * g + ((flags & SEGSUM_LEFT) ? 0 : 1);
  vstore<W>(slots + (i64)slot * D + col, acc);
  return slot;
}

// First index i in [0, E) with seg[i] >= s (E when none).
__device__ __forceinline__ int lower_bound(const int* seg, int E, int s) {
  int lo = 0, hi = E;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Level 0.  Blocks [0, tile_blocks) add tiles of rows, one group of `gw`
// threads per tile; the rest write the zero rows of the segments no row
// names, blockDim.x segment ids each.  Slot metadata: int2 (id, flags), id
// -1 for a slot left unused.
template <typename T, int W>
__global__ void segsum_rows(const T* __restrict__ data,
                            const int* __restrict__ seg, int E, int D,
                            int NS, int ntiles, int gw, int tile_blocks,
                            float* __restrict__ out,
                            float* __restrict__ slots,
                            int2* __restrict__ meta) {
  const int V = D / W;
  const int t = threadIdx.x;
  const bool zero_role = (int)blockIdx.x >= tile_blocks;
  const int bid = zero_role ? blockIdx.x - tile_blocks : blockIdx.x;
  if (zero_role) {
    __shared__ unsigned char absent[SEGSUM_THREADS];
    int s0 = bid * blockDim.x;
    int s = s0 + t;
    int pos = s < NS ? lower_bound(seg, E, s) : 0;
    absent[t] = s < NS && (pos >= E || seg[pos] != s);
    __syncthreads();
    Vec<W> z;
    vzero<W>(z);
    for (int i = t; i < (int)blockDim.x * V; i += blockDim.x) {
      int k = i / V;
      if (absent[k]) vstore<W>(out + (i64)(s0 + k) * D + (i - k * V) * W, z);
    }
    return;
  }
  const int per_block = blockDim.x / gw;
  const int gi = t / gw;
  const int tile = bid * per_block + gi;
  if (gi >= per_block || tile >= ntiles) return;
  const int r0 = tile * SEGSUM_ROWS;
  const int r1 = imin(r0 + SEGSUM_ROWS, E);
  const int before = r0 > 0 ? seg[r0 - 1] : -1;
  const int after = r1 < E ? seg[r1] : -1;
  const int first = seg[r0];
  for (int v = t - gi * gw; v < V; v += gw) {
    const int col = v * W;
    int2 head = make_int2(-1, 0), tail = make_int2(-1, 0);
    int cur = first, flags = (first == before) ? SEGSUM_LEFT : 0;
    Vec<W> acc;
    vzero<W>(acc);
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      int s = seg[r];
      if (s != cur) {  // a run ends inside the tile
        if (cur >= 0 && cur < NS &&
            segsum_emit<W>(cur, flags, acc, tile, D, col, out, slots) >= 0)
          head = make_int2(cur, flags);
        vzero<W>(acc);
        cur = s;
        flags = 0;
      }
      Vec<W> x;
      vload<W>(x, data + (i64)r * D + col);
      vadd<W>(acc, x);
    }
    if (cur == after) flags |= SEGSUM_RIGHT;
    if (cur >= 0 && cur < NS) {
      int slot = segsum_emit<W>(cur, flags, acc, tile, D, col, out, slots);
      if (slot == 2 * tile) head = make_int2(cur, flags);
      else if (slot >= 0) tail = make_int2(cur, flags);
    }
    if (v == t - gi * gw) {  // the group's first column writes the metadata
      meta[2 * tile] = head;
      meta[2 * tile + 1] = tail;
    }
  }
}

// Levels >= 1: groups of SEGSUM_FAN slots of `in` (M slots), one group of
// `gw` threads each; whole runs to `out`, the rest to `nxt`.  A thread
// loads its group's slots (ids, then its columns) before it adds any, so
// a level costs one round trip to memory, not one a slot.
template <int W>
__global__ void segsum_level(const float* __restrict__ in,
                             const int2* __restrict__ in_meta, int M, int D,
                             int ngroups, int gw, float* __restrict__ out,
                             float* __restrict__ nxt,
                             int2* __restrict__ nxt_meta) {
  const int V = D / W;
  const int t = threadIdx.x;
  const int per_block = blockDim.x / gw;
  const int gi = t / gw;
  const int g = blockIdx.x * per_block + gi;
  if (gi >= per_block || g >= ngroups) return;
  const int s0 = g * SEGSUM_FAN;
  int2 m[SEGSUM_FAN];
#pragma unroll
  for (int j = 0; j < SEGSUM_FAN; ++j)
    m[j] = s0 + j < M ? in_meta[s0 + j] : make_int2(-1, 0);
  for (int v = t - gi * gw; v < V; v += gw) {
    const int col = v * W;
    Vec<W> x[SEGSUM_FAN];
#pragma unroll
    for (int j = 0; j < SEGSUM_FAN; ++j)
      if (m[j].x >= 0) vload<W>(x[j], in + (i64)(s0 + j) * D + col);
    int2 head = make_int2(-1, 0), tail = make_int2(-1, 0);
    int cur = -1, flags = 0;
    Vec<W> acc;
    vzero<W>(acc);
#pragma unroll
    for (int j = 0; j < SEGSUM_FAN; ++j) {
      if (m[j].x < 0) continue;
      if (m[j].x != cur) {
        if (cur >= 0 &&
            segsum_emit<W>(cur, flags, acc, g, D, col, out, nxt) >= 0)
          head = make_int2(cur, flags);
        vzero<W>(acc);
        cur = m[j].x;
        flags = m[j].y & SEGSUM_LEFT;
      }
      flags = (flags & SEGSUM_LEFT) | (m[j].y & SEGSUM_RIGHT);
      vadd<W>(acc, x[j]);
    }
    if (cur >= 0) {
      int slot = segsum_emit<W>(cur, flags, acc, g, D, col, out, nxt);
      if (slot == 2 * g) head = make_int2(cur, flags);
      else if (slot >= 0) tail = make_int2(cur, flags);
    }
    if (v == t - gi * gw) {
      nxt_meta[2 * g] = head;
      nxt_meta[2 * g + 1] = tail;
    }
  }
}

static int segsum_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Slots of the first two levels (the ping-pong pair); later levels fit in
// them.
static void segsum_slots(int E, int* m0, int* m1) {
  int tiles = segsum_div(E, SEGSUM_ROWS);
  *m0 = 2 * imax(tiles, 1);
  *m1 = 2 * segsum_div(*m0, SEGSUM_FAN);
}

// 4-byte words of scratch repro_segment_sum needs for E rows of width D:
// D floats and an int2 of metadata a slot.
extern "C" int repro_segment_sum_scratch(int E, int D) {
  int m0, m1;
  segsum_slots(E, &m0, &m1);
  return (m0 + m1) * (D + 2);
}

// Groups of the tree's next level over M slots: the last level has one.
static int segsum_groups(int M) { return segsum_div(M, SEGSUM_FAN); }

// CUDA launches of one call over E rows (E alone decides them): the
// tiles, then a level while more than one tile or group is left.
extern "C" int repro_segment_sum_launches(int E) {
  int n = 1, M = 2 * segsum_div(E, SEGSUM_ROWS);
  for (int g = M / 2; g > 1; M = 2 * g) {
    g = segsum_groups(M);
    ++n;
  }
  return n;
}

template <typename T, int W>
static void segsum_launch(const T* data, const int* seg, int E, int D,
                          int NS, char* scratch, float* out,
                          cudaStream_t stream) {
  const int V = D / W;
  const int gw = imin(V, SEGSUM_THREADS);
  const int per_block = SEGSUM_THREADS / gw;
  const int block = per_block * gw;
  int m0, m1;
  segsum_slots(E, &m0, &m1);
  float* slot[2] = {(float*)scratch, (float*)scratch + (i64)m0 * D};
  int2* meta[2] = {(int2*)(slot[1] + (i64)m1 * D), nullptr};
  meta[1] = meta[0] + m0;
  const int ntiles = segsum_div(E, SEGSUM_ROWS);
  const int tile_blocks = segsum_div(ntiles, per_block);
  auto rows = segsum_rows<T, W>;
  REPRO_LAUNCH(rows, tile_blocks + segsum_div(NS, block), block, stream,
               data, seg, E, D, NS, ntiles, gw, tile_blocks, out, slot[0],
               meta[0]);
  // a single tile's runs are all whole; else level after level until one
  // group holds every slot left (levels read slot[i], write slot[1 - i])
  int M = 2 * ntiles, i = 0;
  for (int g = ntiles; g > 1; M = 2 * g, i = 1 - i) {
    g = segsum_groups(M);
    REPRO_LAUNCH(segsum_level<W>, segsum_div(g, per_block), block, stream,
                 slot[i], meta[i], M, D, g, gw, out, slot[1 - i],
                 meta[1 - i]);
  }
}

// Columns a thread loads at once: 4 or 2 where D and every pointer allow.
static int segsum_width(int D, const void* data, int elem,
                        const void* out) {
  for (int w = 4; w > 1; w >>= 1)
    if (D % w == 0 && (uintptr_t)data % (w * elem) == 0 &&
        (uintptr_t)out % (w * 4) == 0)
      return w;
  return 1;
}

// `half_in`: data is f16 (else f32).  `scratch`: repro_segment_sum_scratch
// words the caller allocates (16-byte aligned).  Launches on `stream`;
// NS == 0 or D == 0 is a no-op.
extern "C" int repro_segment_sum(const void* data, int half_in,
                                 const int* seg, int E, int D, int NS,
                                 void* scratch, float* out, void* stream) {
  if (E < 0 || D < 0 || NS < 0) return (int)cudaErrorInvalidValue;
  if (NS == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  char* sc = (char*)scratch;
  int w = segsum_width(D, data, half_in ? 2 : 4, out);
  if (half_in) {
    const __half* d = (const __half*)data;
    if (w == 4) segsum_launch<__half, 4>(d, seg, E, D, NS, sc, out, st);
    else if (w == 2) segsum_launch<__half, 2>(d, seg, E, D, NS, sc, out, st);
    else segsum_launch<__half, 1>(d, seg, E, D, NS, sc, out, st);
  } else {
    const float* d = (const float*)data;
    if (w == 4) segsum_launch<float, 4>(d, seg, E, D, NS, sc, out, st);
    else if (w == 2) segsum_launch<float, 2>(d, seg, E, D, NS, sc, out, st);
    else segsum_launch<float, 1>(d, seg, E, D, NS, sc, out, st);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
