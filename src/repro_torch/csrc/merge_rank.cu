// Merge ranks: for each query (qk, qv), (lt, le) = the number of live
// entries of a sorted region lexicographically < / <= it, int32 [B].
//
// Replaces the TPU kernel src/repro/kernels/merge/merge.py
// (rank_kernel / rank_kernel_lex / _rank_call / rank_counts): the 1-word
// form and, as the LO instantiation, the composite (qk, ql, qv) form with
// 3-word compares.  A narrow (int32) hi word is loaded promoted to int64,
// never truncated, and the searches never leave the live prefix, so
// sentinel-padded queries get lt = le = n (the jnp reference's answer) and
// the reference's re-sentineling of promoted padding has nothing to do.
//
// Bound on the H100: bytes.  Compaction ranks every entry of one region
// against another (16.7M queries against a few thousand entries at the
// chip run's shapes): the queries' reads and the ranks' writes are the
// bytes bound (0.080 ms there).  Two full bisections a query, ~25
// dependent loads each, took 0.4151 device ms (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  Every caller passes a whole sorted region as the
// queries, so a block's queries rank into a narrow slice of the region.
// Design:
//   * a block takes RANK_CHUNK consecutive queries, loaded coalesced
//     (query j * 256 + t to thread t), and checks that they are
//     nondecreasing (neighbours by shuffle, warp edges through shared
//     memory, __syncthreads_and);
//   * if they are, two groups of 16 lanes rank the block's first query
//     (lt) and last (le) over the live prefix; every query's ranks lie in
//     that slice, [lt_first, le_last].  A slice of at most RANK_SLICE
//     entries is staged in shared memory with coalesced loads and each
//     query bisects it there (log2 of the slice's length steps, most often
//     one or two);
//   * otherwise (unsorted queries, or a slice too long) groups of L lanes
//     (search.cuh; L by member_lanes over the queries) search the live
//     prefix, bounded to the slice when the queries are sorted;
//   * le = lt + (entry at lt == query): one compare, no second search.
//     Only where the entry after it equals the query too (a region holding
//     an entry twice, which no store builds) does an upper-bound search
//     run, so the ranks stay exact for any region.
#include "search.cuh"

#define RANK_THREADS 256
#define RANK_PER_THREAD 8
#define RANK_CHUNK (RANK_THREADS * RANK_PER_THREAD)
#define RANK_SLICE 1024
#define RANK_WARPS (RANK_THREADS / 32)

template <bool LO>
__device__ __forceinline__ bool q_le(i64 ak, i64 al, int av, i64 bk, i64 bl,
                                     int bv) {
  return ak < bk ||
         (ak == bk && (LO ? (al < bl || (al == bl && av <= bv)) : av <= bv));
}

template <bool LO>
__device__ __forceinline__ bool q_eq(i64 ak, i64 al, int av, i64 bk, i64 bl,
                                     int bv) {
  return ak == bk && av == bv && (!LO || al == bl);
}

// Entry i of the region, promoted: (key, lo, val).
template <bool LO>
__device__ __forceinline__ void entry(const Region& r, int i, i64* k, i64* l,
                                      int* v) {
  *k = load_key(r.key, r.k64, i);
  *l = LO ? r.lo[i] : 0;
  *v = r.val[i];
}

// Plain bisection over [lo, hi) of the region for the first entry > q
// (upper bound), after a lower bound found q at lo - 1 and again at lo.
template <bool LO>
__device__ int upper_from(const Region& r, int lo, int hi, i64 qk, i64 ql,
                          int qv) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    i64 k, l;
    int v;
    entry<LO>(r, mid, &k, &l, &v);
    if (q_le<LO>(k, l, v, qk, ql, qv)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool LO, int L>
__global__ void __launch_bounds__(RANK_THREADS)
    rank_kernel(const __grid_constant__ Region r, const void* qk, int q64,
                const i64* ql, const int* qv, int B, int* lt, int* le) {
  __shared__ i64 ek[RANK_SLICE];
  __shared__ i64 el[LO ? RANK_SLICE : 1];
  __shared__ int ev[RANK_SLICE];
  __shared__ i64 fk[RANK_PER_THREAD * RANK_WARPS];  // lane 0's queries
  __shared__ i64 fl[LO ? RANK_PER_THREAD * RANK_WARPS : 1];
  __shared__ int fv[RANK_PER_THREAD * RANK_WARPS];
  __shared__ int s_bound[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * RANK_CHUNK;
  const int cnt = (int)(B - base < RANK_CHUNK ? B - base : RANK_CHUNK);
  const int n = live_of(r);
  i64 k[RANK_PER_THREAD], l[RANK_PER_THREAD];
  int v[RANK_PER_THREAD];
#pragma unroll
  for (int j = 0; j < RANK_PER_THREAD; ++j) {
    const int i = j * RANK_THREADS + t;
    k[j] = 0;
    l[j] = 0;
    v[j] = 0;
    if (i < cnt) {
      k[j] = load_key(qk, q64, base + i);
      if (LO) l[j] = ql[base + i];
      v[j] = qv[base + i];
    }
    if (lane == 0) {
      fk[j * RANK_WARPS + warp] = k[j];
      if (LO) fl[j * RANK_WARPS + warp] = l[j];
      fv[j * RANK_WARPS + warp] = v[j];
    }
  }
  __syncthreads();
  // sorted: every query <= the next (query i + 1 is thread t + 1's, or
  // after the block's last thread, thread 0's next one)
  bool ok = true;
#pragma unroll
  for (int j = 0; j < RANK_PER_THREAD; ++j) {
    i64 nk = __shfl_down_sync(0xffffffffu, k[j], 1);
    i64 nl = LO ? __shfl_down_sync(0xffffffffu, l[j], 1) : 0;
    int nv = __shfl_down_sync(0xffffffffu, v[j], 1);
    if (lane == 31) {
      int jj = warp + 1 < RANK_WARPS ? j : j + 1;
      int ww = warp + 1 < RANK_WARPS ? warp + 1 : 0;
      if (jj < RANK_PER_THREAD) {
        nk = fk[jj * RANK_WARPS + ww];
        if (LO) nl = fl[jj * RANK_WARPS + ww];
        nv = fv[jj * RANK_WARPS + ww];
      }
    }
    const int i = j * RANK_THREADS + t;
    if (i + 1 < cnt) ok = ok && q_le<LO>(k[j], l[j], v[j], nk, nl, nv);
  }
  const bool sorted = __syncthreads_and(ok);
  int lo0 = 0, hi0 = n;
  if (sorted) {
    // lanes 0-15 of warp 0: lt of the first query; 16-31: le of the last
    if (warp == 0) {
      const Group<16> g(t);
      const int last = cnt - 1;
      const int jl = last / RANK_THREADS, tl = last % RANK_THREADS;
      const bool upper = t >= 16;
      i64 sk = upper ? 0 : fk[0], sl = upper ? 0 : (LO ? fl[0] : 0);
      int sv = upper ? 0 : fv[0];
      if (upper) {  // the last query, re-read (its owner is another thread)
        sk = load_key(qk, q64, base + jl * RANK_THREADS + tl);
        if (LO) sl = ql[base + jl * RANK_THREADS + tl];
        sv = qv[base + jl * RANK_THREADS + tl];
      }
      int lo = 0, hi = n, unused = 0;
      while (__any_sync(0xffffffffu, lo < hi)) {
        const bool live = lo < hi;
        bool before = false;
        if (live) {
          i64 a, b;
          int c;
          entry<LO>(r, member_pivot<16>(lo, hi - lo, g.gl), &a, &b, &c);
          before = upper ? q_le<LO>(a, b, c, sk, sl, sv)
                         : !q_le<LO>(sk, sl, sv, a, b, c);
        }
        group_step<16, false>(g, live, before, false, &lo, &hi, &unused);
      }
      if (g.gl == 0) s_bound[upper] = lo;
    }
    __syncthreads();
    lo0 = s_bound[0];
    hi0 = s_bound[1];
  }
  const int S = hi0 - lo0;
  if (sorted && S <= RANK_SLICE) {
    for (int i = t; i < S; i += RANK_THREADS) {
      i64 a, b;
      int c;
      entry<LO>(r, lo0 + i, &a, &b, &c);
      ek[i] = a;
      if (LO) el[i] = b;
      ev[i] = c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RANK_PER_THREAD; ++j) {
      const int i = j * RANK_THREADS + t;
      if (i >= cnt) continue;
      int a = 0, b = S;
      while (a < b) {  // first slice entry >= q
        int mid = (a + b) >> 1;
        if (!q_le<LO>(k[j], l[j], v[j], ek[mid], LO ? el[mid] : 0, ev[mid]))
          a = mid + 1;
        else
          b = mid;
      }
      int e = a;
      if (e < S && q_eq<LO>(ek[e], LO ? el[e] : 0, ev[e], k[j], l[j], v[j])) {
        ++e;
        if (e < S &&
            q_eq<LO>(ek[e], LO ? el[e] : 0, ev[e], k[j], l[j], v[j])) {
          int c = S;  // an entry held twice: upper bound in the slice
          while (e < c) {
            int mid = (e + c) >> 1;
            if (q_le<LO>(ek[mid], LO ? el[mid] : 0, ev[mid], k[j], l[j],
                         v[j]))
              e = mid + 1;
            else
              c = mid;
          }
        }
      }
      lt[base + i] = lo0 + a;
      le[base + i] = lo0 + e;
    }
    return;
  }
  // groups of L lanes over [lo0, hi0), one query after another
  const Group<L> g(t);
  const int gpw = 32 / L, gw = lane / L;
  for (int ub = warp * gpw; ub < cnt; ub += RANK_WARPS * gpw) {
    const int i = ub + gw;
    const bool active = i < cnt;
    i64 a = 0, b = 0;
    int c = 0;
    int lo = 0, hi = 0, hit = 0;
    if (active) {
      a = load_key(qk, q64, base + i);
      if (LO) b = ql[base + i];
      c = qv[base + i];
      lo = lo0;
      hi = hi0;
    }
    while (__any_sync(0xffffffffu, lo < hi)) {
      const bool live = lo < hi;
      bool before = false, eq = false;
      if (live) {
        i64 x, y;
        int z;
        entry<LO>(r, member_pivot<L>(lo, hi - lo, g.gl), &x, &y, &z);
        member_cmp<LO>(x, y, z, a, b, c, &before, &eq);
      }
      group_step<L, true>(g, live, before, eq, &lo, &hi, &hit);
    }
    if (active && g.gl == 0) {
      int e = lo + hit;
      if (hit && e < hi0) {
        i64 x, y;
        int z;
        entry<LO>(r, e, &x, &y, &z);
        if (q_eq<LO>(x, y, z, a, b, c))
          e = upper_from<LO>(r, e + 1, hi0, a, b, c);
      }
      lt[base + i] = lo;
      le[base + i] = e;
    }
  }
}

template <bool LO, int L>
static void rank_launch(const Region& r, const void* qk, int q64,
                        const i64* ql, const int* qv, int B, int* lt,
                        int* le, void* stream) {
  auto kernel = rank_kernel<LO, L>;
  REPRO_LAUNCH(kernel, grid_for(B, RANK_CHUNK), RANK_THREADS, stream, r, qk,
               q64, ql, qv, B, lt, le);
}

template <bool LO>
static void rank_dispatch(const Region& r, const void* qk, int q64,
                          const i64* ql, const int* qv, int B, int* lt,
                          int* le, void* stream) {
  switch (member_lanes(B)) {
    case 16: rank_launch<LO, 16>(r, qk, q64, ql, qv, B, lt, le, stream); break;
    case 8: rank_launch<LO, 8>(r, qk, q64, ql, qv, B, lt, le, stream); break;
    default: rank_launch<LO, 4>(r, qk, q64, ql, qv, B, lt, le, stream);
  }
}

// `ql` is the queries' lo word for a composite region, null otherwise.
extern "C" int repro_rank(const int64_t* desc, const void* qk, int q64,
                          const i64* ql, const int* qv, int B, int* lt,
                          int* le, void* stream) {
  Region r = region_from(desc);
  if ((r.lo != nullptr) != (ql != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    if (r.lo)
      rank_dispatch<true>(r, qk, q64, ql, qv, B, lt, le, stream);
    else
      rank_dispatch<false>(r, qk, q64, ql, qv, B, lt, le, stream);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
