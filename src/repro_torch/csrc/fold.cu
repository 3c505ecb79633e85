// The per-relation epoch commit fold, both outputs in ONE launch:
//     cins' = (cins \ udel) ∪ (uins \ cdel)
//     cdel' = cdel ∪ (udel ∩ base)
// sentinel-padded exactly like csr._empty_like_caps (key sentinel by
// dtype, val 0, lo int64-max), from the four committed/staged regions and
// either the precomputed `in_ba` bits of udel's rows in base (the TPU
// kernel's own function) or base itself, probed inside the launch.
//
// Replaces the TPU kernel src/repro/kernels/merge/fold.py
// (make_fold_kernel(composite) / _fold_call): the 1-word form and, as the
// LO instantiation, the composite form that carries the int64 lo word
// through every probe (3-word compares) and every scatter (lo padded with
// int64-max).  The TPU kernel left base out only because it would not fit
// in VMEM (the caller probed it with a separate rank search); on the H100
// base is read from device memory like every other region, so the probe
// joins the launch.
//
// Bound on the H100: the bytes bound (the four regions' live entries
// read, both outputs written whole) is below a microsecond at the
// sessions' sizes; what the card waits on is the launch itself and the
// chains of dependent loads of the probes.  A first port ran five kernels
// a call (keep bits, three passes of a multi-block scan, the scatter),
// three of them only to carry the scan across blocks, and the caller two
// more launches and two PyTorch ops for the base probe.  Design:
//   * one cooperative launch (cudaLaunchCooperativeKernel) of a grid no
//     larger than the blocks that can be resident at once (the occupancy
//     query times the SMs; a grid that cannot be co-resident is refused
//     with an error, never run smaller), its phases met at one grid-wide
//     barrier (cooperative_groups::this_grid().sync()), as extend.cu;
//   * phase 1: every probe and every merge rank, once.  The keep bits of
//     cins | uins | udel, a word of 32 entries per warp-iteration, a lane
//     per entry, packed by __ballot_sync; block k owns words
//     [k C, (k + 1) C) and writes each word's bits and popcount prefix
//     within its chunk, and the chunk's sum.  The same searches give the
//     entry's merge rank in the other operand (a cins entry searches udel
//     for membership and uins for its rank, in lockstep; a uins entry
//     cins, udel and cdel; a udel entry cdel, and in the base form base
//     too), and a thread per live cdel entry ranks it in udel; the ranks
//     go to scratch.  Lockstep bisections keep one dependent chain an
//     entry, not two or three;
//   * the base form: base is the one large region (a 2^24-entry edge set
//     at the main path's size, beyond the L2 cache, though its upper
//     levels, which every probe reads, stay there), probed by the udel
//     entry's own lane in lockstep with its cdel rank.  Timed in turns on
//     the H100 (chip_ab.py --fold), this beat group searches of 16, 8 or 4
//     lanes a probe spread over the grid (fewer dependent steps, but a
//     second grid barrier and a pass to fold their hits into the bits) at
//     every delta capacity from 2,048 to 32,768;
//   * one grid barrier, then phase 2: every block scans the G chunk sums
//     in shared memory (G is at most the resident blocks, FOLD_MAX_GRID,
//     so one block scans them cheaply: no second pass);
//   * phase 3, grid-stride over the entries and both outputs' slots, no
//     search left: a kept entry goes to its merge position i + |{kept
//     entries of the other operand below it}|, read off its rank, where
//     the exclusive count of keep bits before position x is
//         chunk_off[x / 32 / C] + word_prefix[x / 32]
//           + popc(bits[x / 32] & below(x)),
//     in place of a materialised scan; slots past an output's live count
//     get the padding, and out-of-range positions drop (csr._scatter_drop);
//     block 0 writes both counts.
// The grid is sized by phase 1 (a warp a word, a thread a cdel rank) and
// by phase 3 at four slots a thread, so at the main path's sizes its
// phase-1 warps all run at once; a first form with a second search chain
// in phase 3 and a grid sized by its slots was slower on the H100.
//
// The worker axis (the sharded store of the mesh, the TPU kernel's
// sharded=True, grid=(w,)): every region, output and count carries a
// leading [w] axis, contiguous ([w, cap], n [w]), and one launch folds
// every worker's shard.  The descriptors name worker 0's shard; worker g's
// is the same region g capacities further on (n: g words).  The grid is w
// groups of GW blocks; block b serves worker b / GW as block b % GW of a
// one-region fold over that worker's regions, its own scratch and its own
// outputs, so a worker's outputs depend on its inputs only.  The one grid
// barrier is shared, and each group scans only its own GW chunk sums.
// The w groups share the resident blocks: GW is at most resident / w (a
// grid of w groups that cannot be co-resident is refused, never run
// smaller).  With w = 1 the one-region instantiation runs, unchanged.
#include <cooperative_groups.h>

#include "search.cuh"

#define FOLD_THREADS 256
#define FOLD_WARPS (FOLD_THREADS / 32)
#define FOLD_MAX_GRID 2048  // blocks at most (the chunk sums in shared)

// One output region: key (int32 or int64), val, the composite lo word,
// its capacity and its live count.
struct Out {
  void* key;
  int* val;
  i64* lo;
  int* n;
  int cap;
};

struct FoldArgs {
  Region ci, cd, ui, ud;
  Region ba;           // base (the base form)
  const int* in_ba;    // udel's bits in base (the in_ba form)
  int w;               // workers: regions [w, cap], counts [w]
  int gw;              // blocks a worker
};

struct FoldBufs {
  Out oci, ocd;
  uint2* winfo;         // [NW] (keep bits, popcount prefix in the chunk)
  int* part;            // [FOLD_MAX_GRID] chunk sums
  int* rank;            // [L + cap_cd] merge ranks in the other operand
  int k64;
  long long stride;     // scratch int32 words a worker (even)
};

// scratch (int32 words): winfo (8-byte aligned) first, then the chunk
// sums and the ranks; NW = L / 32 + 1 words cover positions 0..L
__host__ __device__ inline long long fold_words(long long L) {
  return L / 32 + 1;
}

__host__ __device__ inline long long fold_scratch_words(int cap_ci,
                                                        int cap_cd,
                                                        int cap_ui,
                                                        int cap_ud) {
  long long L = (long long)cap_ci + cap_ui + cap_ud;
  long long s = 2 * fold_words(L) + FOLD_MAX_GRID + L + cap_cd;
  return s + (s & 1);  // even: the next worker's winfo stays 8-byte aligned
}

// Worker g's shard of a [w, cap] region, and of an output.
__device__ __forceinline__ Region shard_region(const Region& r, int g) {
  Region s = r;
  const long long off = (long long)g * r.cap;
  s.key = (const char*)r.key + off * (r.k64 ? 8 : 4);
  s.val = r.val + off;
  s.n = r.n + g;
  s.lo = r.lo ? r.lo + off : nullptr;
  return s;
}

__device__ __forceinline__ Out shard_out(const Out& o, int k64, int g) {
  Out s = o;
  const long long off = (long long)g * o.cap;
  s.key = (char*)o.key + off * (k64 ? 8 : 4);
  s.val = o.val + off;
  s.lo = o.lo ? o.lo + off : nullptr;
  s.n = o.n + g;
  return s;
}

// Exclusive scan of one value per thread across the block, the block
// total in *total: warp shuffles, then the warp totals in `sh`
// (FOLD_WARPS words).  Every thread of the block must call it.
__device__ __forceinline__ unsigned block_scan32(unsigned v, unsigned* sh,
                                                 unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int off = 1; off < 32; off <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int w = 0; w < FOLD_WARPS; ++w) {
    unsigned s = sh[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Entry m of r against the query: (entry < q, entry == q).
template <bool LO>
__device__ __forceinline__ void entry_cmp(const Region& r, int m, i64 qk,
                                          i64 ql, int qv, bool* lt,
                                          bool* eq) {
  member_cmp<LO>(load_key(r.key, r.k64, m), load_lo<LO>(r, m), r.val[m], qk,
                 ql, qv, lt, eq);
}

// The query's rank among the live entries of each of NR regions (the
// count of entries below it, csr.lex_searchsorted_cols "left") and
// whether it is one of them.  The NR bisections step in lockstep, so
// their loads are in flight together; a step that meets an entry equal to
// the query records the hit (the first entry >= q lies at or before it),
// so no load follows the search.
template <bool LO, int NR>
__device__ __forceinline__ void members(const Region* const (&r)[NR],
                                        const int (&n)[NR], i64 qk, i64 ql,
                                        int qv, int (&lo)[NR],
                                        bool (&hit)[NR]) {
  int hi[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) {
    lo[s] = 0;
    hi[s] = n[s];
    hit[s] = false;
  }
  bool open = true;
  while (open) {
    open = false;
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      if (lo[s] < hi[s]) {
        const int mid = (lo[s] + hi[s]) >> 1;
        bool lt, eq;
        entry_cmp<LO>(*r[s], mid, qk, ql, qv, &lt, &eq);
        if (lt) lo[s] = mid + 1; else hi[s] = mid;
        hit[s] = hit[s] || eq;
        open = open || lo[s] < hi[s];
      }
    }
  }
}

template <typename K>
__device__ __forceinline__ void put(void* key, int* val, int pos, i64 k,
                                    int v) {
  ((K*)key)[pos] = (K)k;
  val[pos] = v;
}

// Write (k[, l], v) at pos of o; out-of-range positions drop.
template <bool LO>
__device__ __forceinline__ void put_any(int k64, const Out& o, int pos,
                                        i64 k, i64 l, int v) {
  if (pos < 0 || pos >= o.cap) return;
  if (k64) put<i64>(o.key, o.val, pos, k, v);
  else put<int>(o.key, o.val, pos, k, v);
  if (LO) o.lo[pos] = l;
}

// Keep bits before position x (0 <= x <= L): the chunk's offset, the
// word's prefix within the chunk, the word's bits below x.
__device__ __forceinline__ int excl_at(const uint2* winfo, const int* off,
                                       int C, int x) {
  const int w = x >> 5;
  const uint2 wi = winfo[w];
  return off[w / C] + (int)wi.y + __popc(wi.x & ((1u << (x & 31)) - 1u));
}

__device__ __forceinline__ bool kept_at(const uint2* winfo, int x) {
  return (winfo[x >> 5].x >> (x & 31)) & 1u;
}

// One worker's fold: block k of the G blocks of its group, over its
// regions `a`, its scratch and outputs `p`.  BASE: the base form (base
// probed in phase 1), else the in_ba form.
template <bool LO, bool BASE>
__device__ __forceinline__ void fold_body(const FoldArgs& a,
                                          const FoldBufs& p, int k, int G,
                                          int* s_off, unsigned* s_red) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  const int cap_ci = a.ci.cap, cap_ui = a.ui.cap, cap_ud = a.ud.cap;
  const int s_ui = cap_ci, s_ud = cap_ci + cap_ui, L = s_ud + cap_ud;
  const int n_ci = live_of(a.ci), n_cd = live_of(a.cd);
  const int n_ui = live_of(a.ui), n_ud = live_of(a.ud);
  const int NW = L / 32 + 1;
  const int C = (NW + G - 1) / G;
  const int w0 = imin(k * C, NW), w1 = imin(w0 + C, NW);
  const Region* const r_ci2[2] = {&a.ud, &a.ui};
  const Region* const r_ui3[3] = {&a.ci, &a.ud, &a.cd};
  const Region* const r_ud1[1] = {&a.cd};
  const Region* const r_ud2[2] = {&a.cd, &a.ba};
  const Region* const r_cd1[1] = {&a.ud};
  const int n_ci2[2] = {n_ud, n_ui}, n_ui3[3] = {n_ci, n_ud, n_cd};
  const int n_ud1[1] = {n_cd}, n_ud2[2] = {n_cd, live_of(a.ba)};
  const int n_cd1[1] = {n_ud};

  // ---- phase 1: probes and ranks; keep bits of this block's words ------
  for (int w = w0 + warp; w < w1; w += nwarps) {  // warp-uniform
    const int x = w * 32 + lane;
    bool keep = false;
    if (x < s_ui) {  // kept = cins \ udel; its rank in uins
      if (x < n_ci) {
        int q[2];
        bool h[2];
        members<LO, 2>(r_ci2, n_ci2, load_key(a.ci.key, a.ci.k64, x),
                       load_lo<LO>(a.ci, x), a.ci.val[x], q, h);
        keep = !h[0];
        p.rank[x] = q[1];
      }
    } else if (x < s_ud) {  // fresh = uins \ cdel \ kept; rank in cins
      const int j = x - s_ui;
      if (j < n_ui) {
        int q[3];
        bool h[3];
        members<LO, 3>(r_ui3, n_ui3, load_key(a.ui.key, a.ui.k64, j),
                       load_lo<LO>(a.ui, j), a.ui.val[j], q, h);
        keep = !h[2] && !(h[0] && !h[1]);
        p.rank[x] = q[0];
      }
    } else if (x < L) {  // dead = (udel ∩ base) \ cdel; rank in cdel
      const int j = x - s_ud;
      if (j < n_ud && (BASE || a.in_ba[j] != 0)) {
        const i64 qk = load_key(a.ud.key, a.ud.k64, j);
        const i64 ql = load_lo<LO>(a.ud, j);
        const int qv = a.ud.val[j];
        if constexpr (BASE) {  // cdel and base in lockstep
          int q[2];
          bool h[2];
          members<LO, 2>(r_ud2, n_ud2, qk, ql, qv, q, h);
          keep = !h[0] && h[1];
          p.rank[x] = q[0];
        } else {
          int q[1];
          bool h[1];
          members<LO, 1>(r_ud1, n_ud1, qk, ql, qv, q, h);
          keep = !h[0];
          p.rank[x] = q[0];
        }
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) p.winfo[w].x = bits;
  }
  // cdel's live entries: their ranks in udel
  for (int j = k * T + t; j < n_cd; j += G * T) {
    int q[1];
    bool h[1];
    members<LO, 1>(r_cd1, n_cd1, load_key(a.cd.key, a.cd.k64, j),
                   load_lo<LO>(a.cd, j), a.cd.val[j], q, h);
    p.rank[L + j] = q[0];
  }

  __syncthreads();

  // popcount prefixes of this block's words; a thread owns a run of them
  {
    const int nc = w1 - w0, per = (nc + T - 1) / T;
    const int a0 = w0 + imin(t * per, nc), a1 = w0 + imin((t + 1) * per, nc);
    unsigned s = 0;
    for (int w = a0; w < a1; ++w) s += __popc(p.winfo[w].x);
    unsigned blk;
    unsigned run = block_scan32(s, s_red, &blk);
    for (int w = a0; w < a1; ++w) {
      p.winfo[w].y = run;
      run += __popc(p.winfo[w].x);
    }
    if (t == 0) p.part[k] = (int)blk;
  }
  grid.sync();

  // ---- phase 2: the chunks' offsets, every block its own copy -----------
  {
    const int per = (G + T - 1) / T;
    const int a0 = imin(t * per, G), a1 = imin((t + 1) * per, G);
    unsigned s = 0;
    for (int i = a0; i < a1; ++i) s += (unsigned)p.part[i];
    unsigned all;
    unsigned run = block_scan32(s, s_red, &all);
    for (int i = a0; i < a1; ++i) {
      s_off[i] = (int)run;
      run += (unsigned)p.part[i];
    }
  }
  __syncthreads();

  // ---- phase 3: merge positions, padding, counts --------------------------
  const int n_oci = excl_at(p.winfo, s_off, C, s_ud);
  const int ex_ud = n_oci;
  const int n_ocd = n_cd + (excl_at(p.winfo, s_off, C, L) - ex_ud);
  const int k64 = p.k64;
  const Out& oci = p.oci;
  const Out& ocd = p.ocd;
  const i64 sent = k64 ? (i64)0x7fffffffffffffffLL : (i64)0x7fffffff;
  const i64 sent_lo = (i64)0x7fffffffffffffffLL;
  const int ex_ui = excl_at(p.winfo, s_off, C, s_ui);
  const long long total = (long long)L + a.cd.cap + oci.cap + ocd.cap;
  for (long long i = (long long)k * T + t; i < total;
       i += (long long)G * T) {
    if (i < s_ud) {  // kept cins entry -> a + |{fresh < it}|, or
      const int x = (int)i;  // fresh uins entry -> f + |{kept < it}|
      if (kept_at(p.winfo, x)) {
        const bool c = x < s_ui;
        const Region& r = c ? a.ci : a.ui;
        const int j = c ? x : x - s_ui;
        const int q = p.rank[x];
        const int pos = c ? excl_at(p.winfo, s_off, C, x) +
                                (excl_at(p.winfo, s_off, C, s_ui + q) - ex_ui)
                          : (excl_at(p.winfo, s_off, C, x) - ex_ui) +
                                excl_at(p.winfo, s_off, C, q);
        put_any<LO>(k64, oci, pos, load_key(r.key, r.k64, j),
                    load_lo<LO>(r, j), r.val[j]);
      }
    } else if (i < L) {  // dead udel entry -> d + |{cdel < it}|
      const int x = (int)i, j = x - s_ud;
      if (kept_at(p.winfo, x)) {
        const int pos = (excl_at(p.winfo, s_off, C, x) - ex_ud) + p.rank[x];
        put_any<LO>(k64, ocd, pos, load_key(a.ud.key, a.ud.k64, j),
                    load_lo<LO>(a.ud, j), a.ud.val[j]);
      }
    } else if (i < (long long)L + a.cd.cap) {  // cdel -> i + |{dead < it}|
      const int j = (int)(i - L);
      if (j < n_cd) {
        const int pos =
            j + (excl_at(p.winfo, s_off, C, s_ud + p.rank[i]) - ex_ud);
        put_any<LO>(k64, ocd, pos, load_key(a.cd.key, a.cd.k64, j),
                    load_lo<LO>(a.cd, j), a.cd.val[j]);
      }
    } else if (i < (long long)L + a.cd.cap + oci.cap) {  // cins' padding
      const int s = (int)(i - L - a.cd.cap);
      if (s >= n_oci) put_any<LO>(k64, oci, s, sent, sent_lo, 0);
    } else {  // cdel' padding
      const int s = (int)(i - L - a.cd.cap - oci.cap);
      if (s >= n_ocd) put_any<LO>(k64, ocd, s, sent, sent_lo, 0);
    }
  }
  if (k == 0 && t == 0) {
    *oci.n = n_oci;
    *ocd.n = n_ocd;
  }
}

// SHARDED: the worker axis (w > 1), an instantiation of its own, so the
// one-region kernel keeps its registers: the shards' copies of the
// arguments take a stack frame and about twice the registers.
template <bool LO, bool BASE, bool SHARDED>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const __grid_constant__ FoldArgs a,
                const __grid_constant__ FoldBufs p) {
  __shared__ int s_off[FOLD_MAX_GRID];
  __shared__ unsigned s_red[FOLD_WARPS];
  if constexpr (!SHARDED) {
    fold_body<LO, BASE>(a, p, blockIdx.x, gridDim.x, s_off, s_red);
  } else {
    const int g = blockIdx.x / a.gw;  // this block's worker
    FoldArgs sa = a;
    sa.ci = shard_region(a.ci, g);
    sa.cd = shard_region(a.cd, g);
    sa.ui = shard_region(a.ui, g);
    sa.ud = shard_region(a.ud, g);
    sa.ba = shard_region(a.ba, g);
    FoldBufs sp = p;
    sp.oci = shard_out(p.oci, p.k64, g);
    sp.ocd = shard_out(p.ocd, p.k64, g);
    int* base = (int*)p.winfo + g * p.stride;
    const long long L = (long long)a.ci.cap + a.ui.cap + a.ud.cap;
    sp.winfo = (uint2*)base;
    sp.part = base + 2 * fold_words(L);
    sp.rank = sp.part + FOLD_MAX_GRID;
    fold_body<LO, BASE>(sa, sp, blockIdx.x % a.gw, a.gw, s_off, s_red);
  }
}

// Blocks of one instantiation that the card holds at once (occupancy for
// its registers and shared memory, times the SMs; asked once), or a
// negative CUDA error.
template <bool LO, bool BASE, bool SHARDED>
static int fold_resident() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fold_kernel<LO, BASE, SHARDED>, FOLD_THREADS, 0);
    if (e != cudaSuccess) return -(int)e;
    resident = per_sm * sms;
  }
  return resident;
}

// Blocks a worker: every block of the w groups resident at once, no more
// than the largest phase of one worker's fold fills (a warp a word of keep
// bits, a thread a cdel rank, four entries or output slots of phase 3 a
// thread); 0 when w groups of one block cannot be co-resident, or a
// negative CUDA error.
template <bool LO, bool BASE, bool SHARDED>
static int fold_grid(const FoldArgs& a, const FoldBufs& p) {
  int resident = fold_resident<LO, BASE, SHARDED>();
  if (resident < 0) return resident;
  const int per = resident / imax(a.w, 1);  // resident blocks a worker
  if (per < 1) return 0;
  long long L = (long long)a.ci.cap + a.ui.cap + a.ud.cap;
  long long units = fold_words(L) * 32;
  long long items = (L + a.cd.cap + p.oci.cap + p.ocd.cap + 3) / 4;
  if (a.cd.cap > units) units = a.cd.cap;
  if (items > units) units = items;
  long long want = (units + FOLD_THREADS - 1) / FOLD_THREADS;
  int G = (int)(want < per ? want : per);
  return imax(1, imin(G, FOLD_MAX_GRID));
}

template <bool LO, bool BASE, bool SHARDED>
static int fold_launch(FoldArgs a, const FoldBufs& p, void* stream) {
  int resident = fold_resident<LO, BASE, SHARDED>();
  if (resident < 0) return -resident;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  auto kernel = fold_kernel<LO, BASE, SHARDED>;
  const int gw = fold_grid<LO, BASE, SHARDED>(a, p);
  if (gw < 0) return -gw;
  if (gw == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  a.gw = gw;
  return REPRO_LAUNCH_COOP(kernel, gw * a.w, FOLD_THREADS, stream, a, p);
}

extern "C" int repro_commit_fold_scratch(int cap_ci, int cap_cd, int cap_ui,
                                         int cap_ud) {
  return (int)fold_scratch_words(cap_ci, cap_cd, cap_ui, cap_ud);
}

// The scratch of the worker axis: `w` workers' scratch, each of
// repro_commit_fold_scratch's words, one after another.
extern "C" int repro_commit_fold_scratch_w(int cap_ci, int cap_cd,
                                           int cap_ui, int cap_ud, int w) {
  return (int)(imax(w, 1) *
               fold_scratch_words(cap_ci, cap_cd, cap_ui, cap_ud));
}

static FoldArgs fold_args(const int64_t* desc, int nreg, int w) {
  FoldArgs a;
  a.ci = region_from(desc);
  a.cd = region_from(desc + REPRO_DESC_WORDS);
  a.ui = region_from(desc + 2 * REPRO_DESC_WORDS);
  a.ud = region_from(desc + 3 * REPRO_DESC_WORDS);
  a.ba = nreg == 5 ? region_from(desc + 4 * REPRO_DESC_WORDS) : a.ud;
  a.in_ba = nullptr;
  a.w = imax(w, 1);
  a.gw = 0;
  return a;
}

// The grid a call would take, every worker's blocks together (for the
// card's checks, which must reach a one-block and a multi-block grid), 0
// when it cannot be co-resident, or a negative CUDA error.  Regions as
// repro_commit_fold_w's; `nreg` 5 is the base form.
extern "C" int repro_commit_fold_grid_w(const int64_t* desc, int nreg,
                                        int lo, int cap_oci, int cap_ocd,
                                        int w) {
  FoldArgs a = fold_args(desc, nreg, w);
  FoldBufs p;
  p.oci.cap = cap_oci;
  p.ocd.cap = cap_ocd;
  const bool base = nreg == 5;
  int gw;
  if (a.w > 1)  // the worker axis: the base form only
    gw = !base ? (int)-cudaErrorInvalidValue
               : lo ? fold_grid<true, true, true>(a, p)
                    : fold_grid<false, true, true>(a, p);
  else
    gw = lo ? (base ? fold_grid<true, true, false>(a, p)
                    : fold_grid<true, false, false>(a, p))
            : (base ? fold_grid<false, true, false>(a, p)
                    : fold_grid<false, false, false>(a, p));
  return gw > 0 ? gw * a.w : gw;
}

extern "C" int repro_commit_fold_grid(const int64_t* desc, int nreg, int lo,
                                      int cap_oci, int cap_ocd) {
  return repro_commit_fold_grid_w(desc, nreg, lo, cap_oci, cap_ocd, 1);
}

static int fold_call(const int64_t* desc, int nreg, int w, const int* in_ba,
                     int* scratch, void* oci_key, int* oci_val, i64* oci_lo,
                     int* oci_n, int cap_oci, void* ocd_key, int* ocd_val,
                     i64* ocd_lo, int* ocd_n, int cap_ocd, void* stream) {
  const int base = nreg == 5;
  int lo = 0;
  if ((nreg != 4 && nreg != 5) || (base != (in_ba == nullptr)) || w < 1 ||
      (w > 1 && !base) || !lo_uniform(desc, nreg, &lo) ||
      (lo != 0) != (oci_lo != nullptr) || (lo != 0) != (ocd_lo != nullptr) ||
      cap_oci < 0 || cap_ocd < 0)
    return (int)cudaErrorInvalidValue;
  FoldArgs a = fold_args(desc, nreg, w);
  a.in_ba = in_ba;
  const int k64 = a.ci.k64;
  if (a.cd.k64 != k64 || a.ui.k64 != k64 || a.ud.k64 != k64 ||
      a.ba.k64 != k64)
    return (int)cudaErrorInvalidValue;
  long long L = (long long)a.ci.cap + a.ui.cap + a.ud.cap;
  if (L + a.cd.cap + cap_oci + cap_ocd > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  FoldBufs p;
  p.oci = {oci_key, oci_val, oci_lo, oci_n, cap_oci};
  p.ocd = {ocd_key, ocd_val, ocd_lo, ocd_n, cap_ocd};
  p.winfo = (uint2*)scratch;
  p.part = scratch + 2 * fold_words(L);
  p.rank = p.part + FOLD_MAX_GRID;
  p.k64 = k64;
  p.stride = fold_scratch_words(a.ci.cap, a.cd.cap, a.ui.cap, a.ud.cap);
  int rc;
  if (w > 1)  // checked above: the base form
    rc = lo ? fold_launch<true, true, true>(a, p, stream)
            : fold_launch<false, true, true>(a, p, stream);
  else
    rc = lo ? (base ? fold_launch<true, true, false>(a, p, stream)
                    : fold_launch<true, false, false>(a, p, stream))
            : (base ? fold_launch<false, true, false>(a, p, stream)
                    : fold_launch<false, false, false>(a, p, stream));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// `desc`: the regions cins, cdel, uins, udel, and base in the base form
// (nreg 5; `in_ba` null), or the four with `in_ba` (nreg 4).  All share
// one key width and one layout (all composite or none): a base of another
// layout is refused, never cast.  `oci_lo` / `ocd_lo` are the outputs' lo
// words for composite regions, null otherwise.
extern "C" int repro_commit_fold(const int64_t* desc, int nreg,
                                 const int* in_ba, int* scratch,
                                 void* oci_key, int* oci_val, i64* oci_lo,
                                 int* oci_n, int cap_oci, void* ocd_key,
                                 int* ocd_val, i64* ocd_lo, int* ocd_n,
                                 int cap_ocd, void* stream) {
  return fold_call(desc, nreg, 1, in_ba, scratch, oci_key, oci_val, oci_lo,
                   oci_n, cap_oci, ocd_key, ocd_val, ocd_lo, ocd_n, cap_ocd,
                   stream);
}

// The worker axis: the base form (nreg 5) over `w` workers in one launch.
// Every region is [w, cap] contiguous with n [w], and `desc` names worker
// 0's shard of each; the outputs are [w, cap_oci] / [w, cap_ocd] with
// counts [w]; `scratch` holds repro_commit_fold_scratch_w's words.
extern "C" int repro_commit_fold_w(const int64_t* desc, int nreg, int w,
                                   int* scratch, void* oci_key, int* oci_val,
                                   i64* oci_lo, int* oci_n, int cap_oci,
                                   void* ocd_key, int* ocd_val, i64* ocd_lo,
                                   int* ocd_n, int cap_ocd, void* stream) {
  if (nreg != 5) return (int)cudaErrorInvalidValue;
  return fold_call(desc, nreg, w, nullptr, scratch, oci_key, oci_val, oci_lo,
                   oci_n, cap_oci, ocd_key, ocd_val, ocd_lo, ocd_n, cap_ocd,
                   stream);
}

REPRO_ERROR_STRING
