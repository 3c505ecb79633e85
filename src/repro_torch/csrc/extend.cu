// The fused BiGJoin level step: count-minimization, rem-ext budget
// allocation, ragged expansion, k-th extension gather and signed
// intersection of one popped prefix window, in three launches.
//
// Replaces the TPU kernel src/repro/kernels/extend/extend.py
// (make_extend_kernel(has_lo) / _extend_call): 1-word bindings and, in the
// LO instantiation, levels where some binding keys on 3-4 columns — its
// range is a key-only search over the (hi, lo) prefix (_lex_range2) and its
// membership a 3-word search (_lex_member3); its regions carry the lo word.
//
// Bound on the H100: bytes, as scattered dependent reads.  Every window
// row binary-searches each positive region of each binding twice, and
// every proposal binary-searches every region of every binding once; the
// arithmetic around the searches is a handful of integer ops.  The TPU
// ran the whole step as ONE grid-less program holding the W window and
// the B' batch in VMEM.  Blocks on Hopper do not share memory, so the step
// splits at its two global dependencies:
//   (a) extend_count: one thread per window row -> per-region range
//       (start, count), per-binding totals, first-wins argmin,
//       `remaining`;
//   (b) extend_budget: ONE block, int32 inclusive scans of `remaining`
//       and `allowed` over W (any W; each thread owns a contiguous chunk),
//       writing allowed / consumed / aacum, and zeroing the counters;
//   (c) extend_propose: one thread per proposal slot t < B' -> row by
//       upper-bound search in aacum (clipped to [0, W-1] exactly as the
//       reference does, so slots past the budget match too), k_off, the
//       k-th gather across positive regions, then signed membership in
//       every binding with the deletion-only rule on the min binding;
//       (n_proposed, n_intersections) by integer atomics, exact in any
//       order.
// Intermediates live in one int32 scratch buffer the wrapper allocates.
#include "common.cuh"

#define REPRO_MAX_BINDINGS 8
#define REPRO_SCAN_THREADS 1024
#define REPRO_BIND_WORDS 5  // npos, nneg, key-is-int64, qk, ql (or 0)

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
  int nb;
};

// scratch layout (int32): starts [nb][MAXR][W], counts [nb][MAXR][W],
// min_i [W], remaining [W], aacum [W]
__host__ __device__ inline long long sc_counts(int nb, int W) {
  return (long long)nb * REPRO_MAX_REGIONS * W;
}

// LO: some binding of the level is composite (its `ql` is non-null);
// the 1-word instantiation compiles the composite branches out.
template <bool LO>
__global__ void extend_count(const __grid_constant__ ExtendArgs a, int W,
                             const int* wk, const int* valid, int* starts,
                             int* counts, int* min_i, int* remaining) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int best = 0;
  int best_c = 0;
  for (int b = 0; b < a.nb; ++b) {
    const Binding& bd = a.b[b];
    i64 q = load_key(bd.qk, bd.q64, w);
    bool comp = LO && bd.ql != nullptr;
    i64 ql = comp ? bd.ql[w] : 0;
    unsigned tot = 0;
    for (int r = 0; r < bd.npos; ++r) {
      int s = comp ? key_bound2(bd.r[r], q, ql, false)
                   : key_bound(bd.r[r], q, false);
      int e = comp ? key_bound2(bd.r[r], q, ql, true)
                   : key_bound(bd.r[r], q, true);
      long long at = ((long long)b * REPRO_MAX_REGIONS + r) * W + w;
      starts[at] = s;
      counts[at] = e - s;
      tot += (unsigned)(e - s);
    }
    int t = (int)tot;
    if (b == 0 || t < best_c) {  // strict: argmin keeps the first
      best = b;
      best_c = t;
    }
  }
  min_i[w] = best;
  remaining[w] = valid[w] ? imax((int)((unsigned)best_c - (unsigned)wk[w]),
                                 0)
                          : 0;
}

__global__ void extend_budget(int W, int B, const int* remaining,
                              const int* valid, int* allowed, int* consumed,
                              int* aacum, int* counters) {
  __shared__ unsigned sh[REPRO_SCAN_THREADS];
  int t = threadIdx.x;
  int chunk = (W + blockDim.x - 1) / blockDim.x;
  int lo = imin(t * chunk, W);
  int hi = imin(lo + chunk, W);
  unsigned total;
  // acum = inclusive int32 cumsum of remaining (wrapping, as jnp.cumsum)
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += (unsigned)remaining[i];
  unsigned run = block_excl_scan(s, sh, &total);
  unsigned s2 = 0;
  for (int i = lo; i < hi; ++i) {
    unsigned rem = (unsigned)remaining[i];
    run += rem;
    // allowed = clip(B - (acum - remaining), 0, remaining)
    int x = (int)((unsigned)B - (run - rem));
    int al = imin(imax(x, 0), (int)rem);
    allowed[i] = al;
    consumed[i] = (valid[i] != 0) && al == (int)rem;
    s2 += (unsigned)al;
  }
  unsigned run2 = block_excl_scan(s2, sh, &total);
  for (int i = lo; i < hi; ++i) {
    run2 += (unsigned)allowed[i];
    aacum[i] = (int)run2;
  }
  if (t == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

template <bool LO>
__global__ void extend_propose(const __grid_constant__ ExtendArgs a, int W,
                               int B, const int* wk, const int* starts,
                               const int* counts,
                               const int* min_i, const int* allowed,
                               const int* aacum, int* cand, int* row,
                               int* alive, int* counters) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  bool pvalid = t < aacum[W - 1];
  // row = clip(searchsorted(aacum, t, side="right"), 0, W - 1)
  int lo = 0, hi = W;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (aacum[mid] <= t) lo = mid + 1; else hi = mid;
  }
  int r = imin(lo, W - 1);
  int k_off = (int)((unsigned)t - ((unsigned)aacum[r] - (unsigned)allowed[r])
                    + (unsigned)wk[r]);
  int mi = min_i[r];
  // ---- candidate: k-th extension across the min binding's positives ----
  int c = 0;
  {
    const Binding& bd = a.b[mi];
    int off = k_off;
    int v = 0;
    for (int p = 0; p < bd.npos; ++p) {
      long long at = ((long long)mi * REPRO_MAX_REGIONS + p) * W + r;
      int cr = counts[at];
      if (off >= 0 && off < cr) {
        int pos = imin(imax(starts[at] + off, 0), bd.r[p].cap - 1);
        v = bd.r[p].val[pos];
      }
      off -= cr;
    }
    c = v;
  }
  // ---- intersection: signed membership in every binding ----------------
  bool live = pvalid;
  int nis = 0;
  for (int b = 0; b < a.nb; ++b) {
    const Binding& bd = a.b[b];
    i64 q = load_key(bd.qk, bd.q64, r);
    bool comp = LO && bd.ql != nullptr;
    i64 ql = comp ? bd.ql[r] : 0;
    int wp = 0, wn = 0;
    for (int x = 0; x < bd.npos + bd.nneg; ++x) {
      int h = comp ? member3_of(bd.r[x], q, ql, c) : member_of(bd.r[x], q, c);
      if (x < bd.npos) wp += h; else wn += h;
    }
    bool is_min = mi == b;
    bool ok = is_min ? (wn == 0) : (wp - wn > 0);
    if (live && !is_min) ++nis;
    live = live && ok;
  }
  cand[t] = c;
  row[t] = r;
  alive[t] = live ? 1 : 0;
  if (pvalid) atomicAdd(&counters[0], 1);
  if (nis) atomicAdd(&counters[1], nis);
}

extern "C" int repro_extend_scratch(int nb, int W) {
  return (int)(2 * sc_counts(nb, W) + 3LL * W);
}

extern "C" int repro_extend(const int64_t* desc, const int64_t* bind, int nb,
                            int W, int B, const int* wk, const int* valid,
                            int* scratch, int* cand, int* row, int* alive,
                            int* allowed, int* consumed, int* counters,
                            void* stream) {
  if (nb < 1 || nb > REPRO_MAX_BINDINGS || W < 1)
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
    if (bd.npos < 1 || nr > REPRO_MAX_REGIONS ||
        !lo_uniform(desc + REPRO_DESC_WORDS * reg, nr, &lo) ||
        (lo != 0) != (bd.ql != nullptr))
      return (int)cudaErrorInvalidValue;
    any_lo |= lo;
    for (int x = 0; x < nr; ++x)
      bd.r[x] = region_from(desc + REPRO_DESC_WORDS * (reg++));
  }
  long long nc = sc_counts(nb, W);
  int* starts = scratch;
  int* counts = scratch + nc;
  int* min_i = scratch + 2 * nc;
  int* remaining = min_i + W;
  int* aacum = remaining + W;
  if (any_lo)
    REPRO_LAUNCH(extend_count<true>, grid_for(W, REPRO_THREADS),
                 REPRO_THREADS, stream, a, W, wk, valid, starts, counts,
                 min_i, remaining);
  else
    REPRO_LAUNCH(extend_count<false>, grid_for(W, REPRO_THREADS),
                 REPRO_THREADS, stream, a, W, wk, valid, starts, counts,
                 min_i, remaining);
  REPRO_LAUNCH(extend_budget, 1, REPRO_SCAN_THREADS, stream, W, B,
               remaining, valid, allowed, consumed, aacum, counters);
  if (B > 0 && any_lo) {
    REPRO_LAUNCH(extend_propose<true>, grid_for(B, REPRO_THREADS),
                 REPRO_THREADS, stream, a, W, B, wk, starts, counts, min_i,
                 allowed, aacum, cand, row, alive, counters);
  } else if (B > 0) {
    REPRO_LAUNCH(extend_propose<false>, grid_for(B, REPRO_THREADS),
                 REPRO_THREADS, stream, a, W, B, wk, starts, counts, min_i,
                 allowed, aacum, cand, row, alive, counters);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
