// The fused BiGJoin level step: count-minimization, rem-ext budget
// allocation, ragged expansion, k-th extension gather and signed
// intersection of one popped prefix window, in ONE launch.
//
// Replaces the TPU kernel src/repro/kernels/extend/extend.py
// (make_extend_kernel(has_lo) / _extend_call): 1-word bindings and, in the
// LO instantiation, levels where some binding keys on 3-4 columns — its
// range is a key-only search over the (hi, lo) prefix (_lex_range2) and its
// membership a 3-word search (_lex_member3); its regions carry the lo word.
//
// Bound on the H100: the bytes bound is below a microsecond; what the card
// waits on is the chains of dependent loads of the searches and the
// step's two global dependencies (the budget scans over the window, the
// expansion of rows into proposal slots).  The TPU ran the step as one
// grid-less program holding the window and the batch in VMEM.  A first
// port ran three kernels with a thread per row or slot, each walking
// two bisections per positive region and one per region of every binding
// one after another (~25 dependent loads each at R-MAT scale 20), on 3 %
// of the card's threads, and six launches a call counting the wrapper's
// conversions.  Design (numbers in PERF.md):
//   * one cooperative launch (cudaLaunchCooperativeKernel) of a persistent
//     grid no larger than the blocks that can be resident at once (the
//     occupancy query for this kernel's registers and shared memory, times
//     the SMs), phases separated by grid-wide barriers
//     (cooperative_groups::this_grid().sync(), about a microsecond each).
//     Chosen over a barrier hand-written on a counter: the CUDA runtime
//     refuses a grid that cannot be co-resident with an error instead of
//     letting it hang, the barrier keeps no state in memory that a launch
//     would have to zero first, and the launch is captured in a CUDA graph
//     like any other;
//   * phase 1, a block's own rows (the window cut in G chunks): the key
//     range [start, end) of every row in EVERY region, negatives too.  With
//     more searches than the card holds threads (the main path), a thread
//     per (row, region) bisects until it meets an entry equal to the key,
//     then walks to both ends of its run at once; with fewer, a pair of
//     lanes per (row, region, side) takes ternary steps by __ballot_sync
//     (search.cuh), the first-level pivots staged in shared memory
//     (extend_lanes).  Then per row the
//     binding totals, the first-wins argmin and `remaining`, and the
//     block's sum.  The counters are zeroed here, before the first barrier;
//   * phase 2, after barrier 1: each block adds the sums of the blocks
//     before it, scans its rows (allowed, consumed, aacum) and expands
//     them by scatter: row r writes r into slots [aacum[r] - allowed[r],
//     aacum[r]), slots from aacum[W-1] on get W - 1.  Where the int32
//     cumsum of `remaining` cannot wrap (its exact total fits in int32),
//     aacum is min(B', acum) and this is exactly the reference's
//     clip(searchsorted(aacum, t, "right"), 0, W - 1); where it could wrap,
//     a third barrier scans `allowed` as the reference does, and each slot
//     finds its row by bisection of aacum (exact either way, but 3-5 us
//     slower a call at W = B' of 1024 to 8192 on the H100, so the scatter
//     stays where it is exact);
//   * phase 3, after barrier 2: passes of slots spread over the blocks: a
//     thread per slot gathers its candidate (the k-th extension across the
//     min binding's positives); then a thread per (slot, region) decides
//     membership of (key, candidate): the live entries with that key are
//     [start, min(end, n)) of phase 1's range (the full array is sorted,
//     its padding above every live key), sorted by val, so a bisection of
//     the vals there answers it in log2(degree) steps instead of a search
//     of the whole region.  Hits meet in shared memory and a thread per
//     slot adds them per binding in region order (signed membership, the
//     deletion-only rule on the min binding); (proposed, intersections)
//     are summed per block and added by one integer atomic each, exact in
//     any order;
//   * `valid` is read as bytes, `alive` and `consumed` written as bytes (the
//     wrapper views them as bool), so a call is this one launch.
// Key-only range searches keep their semantics: over the full capacity,
// the sentinel padding sorting above every live key.
#include <cooperative_groups.h>

#include "search.cuh"

#define REPRO_MAX_BINDINGS 8
#define REPRO_BIND_WORDS 5  // npos, nneg, key-is-int64, qk, ql (or 0)
#define EXTEND_THREADS 256
#define EXTEND_WARPS (EXTEND_THREADS / 32)
#define EXTEND_MAX_REGIONS (REPRO_MAX_BINDINGS * REPRO_MAX_REGIONS)
#define EXTEND_MAX_GRID 2048  // blocks at most (the scratch's block sums)
#define EXTEND_HITS 2048      // (slot, region) hits a pass keeps in shared

struct Binding {
  Region r[REPRO_MAX_REGIONS];  // positives first, then negatives
  const void* qk;               // [W] lookup keys of this binding
  const i64* ql;                // [W] lo words of a composite binding
  int npos;
  int nneg;
  int q64;
};

struct ExtendArgs {
  Binding b[REPRO_MAX_BINDINGS];
  // regions flattened over the bindings (positives then negatives of each
  // binding, bindings in order): region x -> (rb[x], rr[x]); reg0[b] is
  // binding b's first
  unsigned char rb[EXTEND_MAX_REGIONS], rr[EXTEND_MAX_REGIONS];
  unsigned char reg0[REPRO_MAX_BINDINGS];
  int nb;
  int nreg;  // R: all regions
};

struct ExtendBufs {
  const int* wk;               // [W] rem-ext cursors
  const unsigned char* valid;  // [W] bool
  unsigned long long* part;    // [2][EXTEND_MAX_GRID] block sums
  int* starts;                 // [R][W] key range starts
  int* ends;                   // [R][W] key range ends
  int* min_i;                  // [W] argmin binding
  int* remaining;              // [W]
  int* aacum;                  // [W] inclusive cumsum of allowed
  int* cand;                   // [B]
  int* row;                    // [B]
  unsigned char* alive;        // [B] bool
  int* allowed;                // [W]
  unsigned char* consumed;     // [W] bool
  int* counters;               // [2] (proposed, intersections)
  int W;
  int B;
};

// scratch (int32 words): the block sums first (8-byte aligned), then
// starts, ends, min_i, remaining, aacum
__host__ __device__ inline long long extend_scratch_words(int R, int W) {
  return 4LL * EXTEND_MAX_GRID + 2LL * R * W + 3LL * W;
}

// Exclusive scan of one exact 64-bit value per thread across the block,
// the block total in *total: warp shuffles, then the warp totals in
// `sh` (EXTEND_WARPS words).  Every thread of the block must call it.
__device__ __forceinline__ unsigned long long block_scan64(
    unsigned long long v, unsigned long long* sh, unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
  for (int off = 1; off < 32; off <<= 1) {
    unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  unsigned long long before = 0, all = 0;
  for (int w = 0; w < EXTEND_WARPS; ++w) {
    unsigned long long s = sh[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

template <bool LO, int L>
__global__ void __launch_bounds__(EXTEND_THREADS, 4)
    extend_kernel(const __grid_constant__ ExtendArgs a,
                  const __grid_constant__ ExtendBufs p) {
  __shared__ i64 sk[EXTEND_MAX_REGIONS * L];
  __shared__ i64 sl[LO ? EXTEND_MAX_REGIONS * L : 1];
  __shared__ int sn[EXTEND_MAX_REGIONS];
  __shared__ unsigned long long sred[EXTEND_WARPS];
  __shared__ int s_row[EXTEND_THREADS];
  __shared__ int s_cand[EXTEND_THREADS];
  __shared__ int s_mi[EXTEND_THREADS];
  __shared__ int s_pv[EXTEND_THREADS];
  __shared__ unsigned char s_hit[EXTEND_HITS];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int t = threadIdx.x, T = blockDim.x;
  const int k = blockIdx.x, G = gridDim.x;
  const int W = p.W, B = p.B, R = a.nreg;
  const Group<L> g(t);
  const int gpw = 32 / L;                  // groups a warp
  const int warp = t >> 5, nwarps = T >> 5;
  const int gw = (t & 31) / L;             // this group in its warp
  if (k == 0 && t == 0) {
    p.counters[0] = 0;
    p.counters[1] = 0;
  }

  // ---- phase 1: this block's rows -------------------------------------
  const int C = (W + G - 1) / G;
  const int r0 = imin(k * C, W), r1 = imin(r0 + C, W), nr = r1 - r0;
  // each region's first-level pivots over its full capacity (groups only)
  for (int i = t; L > 1 && i < R * L; i += T) {
    const int x = i / L;
    const Region& Rg = a.b[a.rb[x]].r[a.rr[x]];
    if (Rg.cap > 0) {
      int pv = member_pivot<L>(0, Rg.cap, i - x * L);
      sk[i] = load_key(Rg.key, Rg.k64, pv);
      if (LO && Rg.lo) sl[i] = Rg.lo[pv];
    }
  }
  if (t < R) sn[t] = live_of(a.b[a.rb[t]].r[a.rr[t]]);
  __syncthreads();
  if (L == 1) {
    // units (region x, row), rows fastest: a thread bisects until an entry
    // equals q, then walks to both ends of q's run at once (two
    // independent bisections, one step of each a round)
    const int U1 = nr * R;
    for (int u = t; u < U1; u += T) {
      const int w = r0 + u % nr, x = u / nr;
      const Binding& bd = a.b[a.rb[x]];
      const Region& Rg = bd.r[a.rr[x]];
      const bool comp = LO && bd.ql != nullptr;
      const i64 q = load_key(bd.qk, bd.q64, w);
      const i64 ql = comp ? bd.ql[w] : 0;
      int lo = 0, hi = Rg.cap, mid = -1;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        const i64 ek = load_key(Rg.key, Rg.k64, m);
        const i64 el = comp ? Rg.lo[m] : 0;
        if (ek < q || (ek == q && el < ql)) {
          lo = m + 1;
        } else if (ek == q && el == ql) {
          mid = m;
          break;
        } else {
          hi = m;
        }
      }
      int s = lo, e = lo;
      if (mid >= 0) {  // the start in [lo, mid], the end in [mid + 1, hi]
        int b = mid;
        e = mid + 1;
        int d = hi;
        while (s < b || e < d) {
          if (s < b) {
            const int m = (s + b) >> 1;
            const i64 ek = load_key(Rg.key, Rg.k64, m);
            if (ek < q || (comp && ek == q && Rg.lo[m] < ql)) s = m + 1;
            else b = m;
          }
          if (e < d) {
            const int m = (e + d) >> 1;
            const i64 ek = load_key(Rg.key, Rg.k64, m);
            if (ek < q || (ek == q && (!comp || Rg.lo[m] <= ql))) e = m + 1;
            else d = m;
          }
        }
      }
      p.starts[(long long)x * W + w] = s;
      p.ends[(long long)x * W + w] = e;
    }
  } else {
    // units (region x, side, row): rows fastest, so neighbouring groups
    // search one region; the loop is uniform over each warp (ballots)
    const int U1 = nr * 2 * R;
    for (int ub = warp * gpw; ub < U1; ub += nwarps * gpw) {
      const int u = ub + gw;
      const bool active = u < U1;
      int w = 0, side = 0, x = 0;
      if (active) {
        w = r0 + u % nr;
        side = (u / nr) & 1;
        x = u / nr >> 1;
      }
      const Binding& bd = a.b[a.rb[x]];
      const Region& Rg = bd.r[a.rr[x]];
      const bool comp = LO && bd.ql != nullptr;
      i64 q = 0, ql = 0;
      int lo = 0, hi = 0, unused = 0;
      if (active) {
        q = load_key(bd.qk, bd.q64, w);
        if (comp) ql = bd.ql[w];
        hi = Rg.cap;
      }
      for (int step = 0; __any_sync(0xffffffffu, lo < hi); ++step) {
        const bool live = lo < hi;
        bool before = false;
        if (live) {
          i64 ek, el = 0;
          if (step == 0) {
            ek = sk[x * L + g.gl];
            if (comp) el = sl[x * L + g.gl];
          } else {
            int pv = member_pivot<L>(lo, hi - lo, g.gl);
            ek = load_key(Rg.key, Rg.k64, pv);
            if (comp) el = Rg.lo[pv];
          }
          // left: (key[, lo]) < q; right: <= q
          before = ek < q ||
                   (ek == q && (comp ? (side ? el <= ql : el < ql) : side));
        }
        group_step<L, false>(g, live, before, false, &lo, &hi, &unused);
      }
      if (active && g.gl == 0)
        (side ? p.ends : p.starts)[(long long)x * W + w] = lo;
    }
  }
  __syncthreads();
  // per row: binding totals, first-wins argmin, remaining; a thread owns
  // a contiguous run of the block's rows
  const int rpt = (nr + T - 1) / T;
  const int a0 = r0 + imin(t * rpt, nr), a1 = r0 + imin((t + 1) * rpt, nr);
  unsigned long long my_rem = 0;
  for (int w = a0; w < a1; ++w) {
    int best = 0, best_c = 0;
    for (int b = 0; b < a.nb; ++b) {
      unsigned tot = 0;
      for (int i = 0; i < a.b[b].npos; ++i) {
        long long at = (long long)(a.reg0[b] + i) * W + w;
        tot += (unsigned)(p.ends[at] - p.starts[at]);
      }
      if (b == 0 || (int)tot < best_c) {  // strict: argmin keeps the first
        best = b;
        best_c = (int)tot;
      }
    }
    int rem = p.valid[w]
                  ? imax((int)((unsigned)best_c - (unsigned)p.wk[w]), 0)
                  : 0;
    p.min_i[w] = best;
    p.remaining[w] = rem;
    my_rem += (unsigned)rem;
  }
  unsigned long long blk;
  const unsigned long long my_excl = block_scan64(my_rem, sred, &blk);
  if (t == 0) p.part[k] = blk;
  grid.sync();

  // ---- phase 2: budget scans and the expansion into slots --------------
  unsigned long long before_me = 0, all = 0;
  for (int i = t; i < G; i += T) {
    unsigned long long x = p.part[i];
    all += x;
    if (i < k) before_me += x;
  }
  block_scan64(before_me, sred, &before_me);
  block_scan64(all, sred, &all);
  const bool wraps = all > 0x7fffffffULL;  // the int32 cumsum could wrap
  unsigned long long run = before_me + my_excl;
  unsigned long long my_al = 0;
  for (int w = a0; w < a1; ++w) {
    unsigned rem = (unsigned)p.remaining[w];
    run += rem;
    // allowed = clip(B - (acum - remaining), 0, remaining), int32
    int x = (int)((unsigned)B - ((unsigned)run - rem));
    int al = imin(imax(x, 0), (int)rem);
    p.allowed[w] = al;
    p.consumed[w] = p.valid[w] && al == (int)rem;
    if (!wraps) p.aacum[w] = (int)(run < (unsigned long long)B ? run : B);
    my_al += (unsigned)al;
  }
  int total;  // aacum[W - 1]: the slots holding proposals
  if (!wraps) {
    total = (int)(all < (unsigned long long)B ? all : B);
    __syncthreads();
    for (int w = r0; w < r1; ++w) {  // scatter this block's rows
      int e = p.aacum[w], s = e - p.allowed[w];
      for (int x = s + t; x < e; x += T) p.row[x] = w;
    }
    for (int x = total + k * T + t; x < B; x += G * T) p.row[x] = W - 1;
  } else {
    const unsigned long long al_excl = block_scan64(my_al, sred, &blk);
    if (t == 0) p.part[EXTEND_MAX_GRID + k] = blk;
    grid.sync();
    unsigned long long b2 = 0, all2 = 0;
    for (int i = t; i < G; i += T) {
      unsigned long long x = p.part[EXTEND_MAX_GRID + i];
      all2 += x;
      if (i < k) b2 += x;
    }
    block_scan64(b2, sred, &b2);
    block_scan64(all2, sred, &all2);
    unsigned long long run2 = b2 + al_excl;
    for (int w = a0; w < a1; ++w) {
      run2 += (unsigned)p.allowed[w];
      p.aacum[w] = (int)(unsigned)run2;  // wrapping, as jnp.cumsum
    }
    total = (int)(unsigned)all2;
  }
  grid.sync();

  // ---- phase 3: gather and signed intersection, passes of S slots ------
  // slots a pass: the batch spread over every block, within the shared
  // hit cells and a thread a slot
  const int S = imax(1, imin(imin(T, EXTEND_HITS / R), (B + G - 1) / G));
  unsigned my_prop = 0, my_nis = 0;
  for (int c0 = k * S; c0 < B; c0 += G * S) {
    __syncthreads();  // the last pass's reads of the slot cells are done
    if (t < S) {
      const int x = c0 + t;
      int pv = 0;
      if (x < B) {
        int r;
        if (!wraps) {
          r = p.row[x];
        } else {  // row = clip(searchsorted(aacum, x, "right"), 0, W - 1)
          int lo = 0, hi = W;
          while (lo < hi) {
            int mid = (lo + hi) >> 1;
            if (p.aacum[mid] <= x) lo = mid + 1; else hi = mid;
          }
          r = imin(lo, W - 1);
          p.row[x] = r;
        }
        pv = x < total;
        int off = (int)((unsigned)x - ((unsigned)p.aacum[r] -
                                       (unsigned)p.allowed[r]) +
                        (unsigned)p.wk[r]);
        const int mi = p.min_i[r];
        // candidate: the k-th extension across the min binding's positives
        const Binding& bd = a.b[mi];
        int v = 0;
        for (int i = 0; i < bd.npos; ++i) {
          long long at = (long long)(a.reg0[mi] + i) * W + r;
          int s = p.starts[at], cr = p.ends[at] - s;
          if (off >= 0 && off < cr) {
            int pos = imin(imax((int)((unsigned)s + (unsigned)off), 0),
                           bd.r[i].cap - 1);
            v = bd.r[i].val[pos];
          }
          off = (int)((unsigned)off - (unsigned)cr);
        }
        p.cand[x] = v;
        s_row[t] = r;
        s_cand[t] = v;
        s_mi[t] = mi;
        my_prop += pv;
      }
      s_pv[t] = pv;
    }
    __syncthreads();
    // membership of (q, c) in region x: its live entries with key q are
    // [start, min(end, n)) of phase 1's range (the full array is sorted,
    // the padding above every live key), sorted by val: bisect c there.
    // A unit a (slot, region), regions fastest: hits in region order
    for (int u = t; u < S * R; u += T) {
      const int sl_ = u / R, x = u % R;
      int hit = 0;
      if (s_pv[sl_]) {
        const long long at = (long long)x * W + s_row[sl_];
        const int* val = a.b[a.rb[x]].r[a.rr[x]].val;
        const int c = s_cand[sl_];
        int lo = p.starts[at], e = imin(p.ends[at], sn[x]), hi = e;
        while (lo < hi) {
          int mid = (lo + hi) >> 1;
          if (val[mid] < c) lo = mid + 1; else hi = mid;
        }
        hit = lo < e && val[lo] == c;
      }
      s_hit[u] = hit;
    }
    __syncthreads();
    if (t < S && c0 + t < B) {
      const int x = c0 + t, mi = s_mi[t];
      bool live = s_pv[t];
      unsigned nis = 0;
      for (int b = 0; b < a.nb; ++b) {
        const Binding& bd = a.b[b];
        const unsigned char* h = s_hit + t * R + a.reg0[b];
        int wp = 0, wn = 0;
        for (int i = 0; i < bd.npos; ++i) wp += h[i];
        for (int i = bd.npos; i < bd.npos + bd.nneg; ++i) wn += h[i];
        const bool is_min = mi == b;
        const bool ok = is_min ? wn == 0 : wp - wn > 0;
        if (live && !is_min) ++nis;
        live = live && ok;
      }
      p.alive[x] = live;
      my_nis += nis;
    }
  }
  unsigned long long prop_blk, nis_blk;
  block_scan64(my_prop, sred, &prop_blk);
  block_scan64(my_nis, sred, &nis_blk);
  if (t == 0) {
    if (prop_blk) atomicAdd(&p.counters[0], (int)prop_blk);
    if (nis_blk) atomicAdd(&p.counters[1], (int)nis_blk);
  }
}

// Blocks of one instantiation that the card holds at once (occupancy for
// its registers and shared memory, times the SMs; asked once), or a
// negative CUDA error.
template <bool LO, int L>
static int extend_resident() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, extend_kernel<LO, L>, EXTEND_THREADS, 0);
    if (e != cudaSuccess) return -(int)e;
    resident = per_sm * sms;
  }
  return resident;
}

// The grid: every block resident at once, no more than the larger phase
// fills (phase 1's search lanes, phase 3's (slot, region) units).
template <bool LO, int L>
static int extend_launch(const ExtendArgs& a, const ExtendBufs& p,
                         long long searches, void* stream) {
  auto kernel = extend_kernel<LO, L>;
  int resident = extend_resident<LO, L>();
  if (resident < 0) return -resident;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long units = searches * L, units3 = (long long)a.nreg * p.B;
  if (units3 > units) units = units3;
  long long want = (units + EXTEND_THREADS - 1) / EXTEND_THREADS;
  int G = (int)(want < resident ? want : resident);
  G = imax(1, imin(G, EXTEND_MAX_GRID));
  return REPRO_LAUNCH_COOP(kernel, G, EXTEND_THREADS, stream, a, p);
}

// Lanes a search: 2 where every search of phase 1 keeps its pair of lanes
// on the card's resident threads at once, else 1.  A/B on an NVIDIA H100
// 80GB HBM3 (chip_ab.py over copies of this file with the lane count
// fixed; 5 + 3 regions, W = B' of 1024 to 8192): a pair takes 15-22 % less
// device time than one lane up to W = 4096, where its searches still fit;
// 4 and 8 lanes were at most 5 % faster than 2 at W = 1024 and slower from
// 2048 on; one lane wins at W = 8192, where the searches outnumber the
// threads and wider groups only add pivot loads.
static int extend_lanes(long long searches, long long threads) {
  return searches * 2 <= threads ? 2 : 1;
}

// The lane count a call of R regions over a window of W rows takes.
template <bool LO>
static int extend_lanes_of(int nreg, int W) {
  int resident = extend_resident<LO, 1>();
  if (resident < 0) return resident;
  return extend_lanes(2LL * nreg * W, (long long)resident * EXTEND_THREADS);
}

template <bool LO>
static int extend_dispatch(const ExtendArgs& a, const ExtendBufs& p,
                           void* stream) {
  long long searches = 2LL * a.nreg * p.W;
  int lanes = extend_lanes_of<LO>(a.nreg, p.W);
  if (lanes < 0) return -lanes;
  return lanes == 2 ? extend_launch<LO, 2>(a, p, searches, stream)
                    : extend_launch<LO, 1>(a, p, searches, stream);
}

// Lanes a search of a call with nreg regions over a window of W rows, with
// composite (lo) regions or not; a negative CUDA error if the occupancy
// query fails.  For the card's checks, which cover both variants.
extern "C" int repro_extend_lanes(int nreg, int W, int lo) {
  return lo ? extend_lanes_of<true>(nreg, W) : extend_lanes_of<false>(nreg, W);
}

extern "C" int repro_extend_scratch(int nreg, int W) {
  return (int)extend_scratch_words(nreg, W);
}

extern "C" int repro_extend(const int64_t* desc, const int64_t* bind, int nb,
                            int W, int B, const int* wk,
                            const unsigned char* valid, int* scratch,
                            int* cand, int* row, unsigned char* alive,
                            int* allowed, unsigned char* consumed,
                            int* counters, void* stream) {
  if (nb < 1 || nb > REPRO_MAX_BINDINGS || W < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  ExtendArgs a;
  a.nb = nb;
  int reg = 0;
  int any_lo = 0;
  for (int b = 0; b < nb; ++b) {
    Binding& bd = a.b[b];
    bd.npos = (int)bind[REPRO_BIND_WORDS * b + 0];
    bd.nneg = (int)bind[REPRO_BIND_WORDS * b + 1];
    bd.q64 = (int)bind[REPRO_BIND_WORDS * b + 2];
    bd.qk = (const void*)bind[REPRO_BIND_WORDS * b + 3];
    bd.ql = (const i64*)bind[REPRO_BIND_WORDS * b + 4];
    int nr = bd.npos + bd.nneg;
    int lo = 0;
    // a binding's regions are all composite or none, as its key is
    if (bd.npos < 1 || bd.nneg < 0 || nr > REPRO_MAX_REGIONS ||
        !lo_uniform(desc + REPRO_DESC_WORDS * reg, nr, &lo) ||
        (lo != 0) != (bd.ql != nullptr))
      return (int)cudaErrorInvalidValue;
    any_lo |= lo;
    a.reg0[b] = (unsigned char)reg;
    for (int x = 0; x < nr; ++x) {
      bd.r[x] = region_from(desc + REPRO_DESC_WORDS * reg);
      a.rb[reg] = (unsigned char)b;
      a.rr[reg] = (unsigned char)x;
      ++reg;
    }
  }
  a.nreg = reg;
  ExtendBufs p;
  p.wk = wk;
  p.valid = valid;
  p.part = (unsigned long long*)scratch;
  p.starts = scratch + 4LL * EXTEND_MAX_GRID;
  p.ends = p.starts + (long long)reg * W;
  p.min_i = p.ends + (long long)reg * W;
  p.remaining = p.min_i + W;
  p.aacum = p.remaining + W;
  p.cand = cand;
  p.row = row;
  p.alive = alive;
  p.allowed = allowed;
  p.consumed = consumed;
  p.counters = counters;
  p.W = W;
  p.B = B;
  return any_lo ? extend_dispatch<true>(a, p, stream)
                : extend_dispatch<false>(a, p, stream);
}

REPRO_ERROR_STRING
