// Group searches over sorted regions, shared by the membership, fused
// extend and merge-rank kernels.
//
// A group of L lanes (L a power of two, at most 32, groups aligned inside
// their warp) searches one sorted range for one query: each step its lanes
// compare L pivots of the live range at once and a __ballot_sync count
// picks one of L + 1 sub-ranges, so a search of m entries takes about
// log_{L+1}(m) dependent steps instead of log_2(m).  Each step can also
// ballot equality, so a membership hit is known when the range closes,
// without a further load.  L = 1 is a plain bisection.
#pragma once

#include "common.cuh"

// lanes of all searches of a launch at most, where the searches allow
#define MEMBER_LANES_IN_FLIGHT 98304

// Pivot j (0..L-1) of the range [lo, lo + m), m >= 1, for an (L+1)-ary
// step: nondecreasing in j, inside the range, and every position of a
// range of m <= L entries is a pivot.
template <int L>
__device__ __forceinline__ int member_pivot(int lo, int m, int j) {
  return lo + (int)(((unsigned long long)(j + 1) * (unsigned)m) /
                    (unsigned)(L + 1));
}

// One (L+1)-ary search step's compare of entry (ek[, el], ev) with the
// query: (entry < q, entry == q).
template <bool LO>
__device__ __forceinline__ void member_cmp(i64 ek, i64 el, int ev, i64 qk,
                                           i64 ql, int qv, bool* lt,
                                           bool* eq) {
  *lt = ek < qk ||
        (ek == qk && (LO ? (el < ql || (el == ql && ev < qv)) : ev < qv));
  *eq = ek == qk && ev == qv && (!LO || el == ql);
}

// A thread's place in its group of L lanes: its lane in the group, the
// group's first lane in the warp, and the group's lanes as a ballot mask.
template <int L>
struct Group {
  int gl;
  int shift;
  unsigned mask;
  __device__ __forceinline__ explicit Group(int t)
      : gl(t % L),
        shift((t & 31) - t % L),
        mask(L == 32 ? 0xffffffffu : ((1u << L) - 1) << ((t & 31) - t % L)) {}
};

// One step of a group's search of [lo, hi) for the partition point of a
// monotone predicate: this lane compared pivot g.gl of the range (`before`:
// the pivot sorts before the partition point; `eq`: it equals the query,
// read only when EQ).  Every lane of the warp calls it, in every step; a
// group whose range has closed (`live` false) keeps its result.  The
// group's pivots before the point are a prefix (sorted entries): entries
// before pivot c - 1 sort before, entries from pivot c on do not.  When
// the range closes, lo is the partition point and `hit` says whether the
// entry there equals the query (0 if it lies at the range's end).
template <int L, bool EQ>
__device__ __forceinline__ void group_step(const Group<L>& g, bool live,
                                           bool before, bool eq, int* lo,
                                           int* hi, int* hit) {
  unsigned lm = (__ballot_sync(0xffffffffu, before) & g.mask) >> g.shift;
  unsigned em = EQ ? (__ballot_sync(0xffffffffu, eq) & g.mask) >> g.shift
                   : 0u;
  if (live) {
    int m = *hi - *lo;
    int c = __popc(lm);
    int nlo = c > 0 ? member_pivot<L>(*lo, m, c - 1) + 1 : *lo;
    if (c < L) {
      *hi = member_pivot<L>(*lo, m, c);
      if (EQ) *hit = (em >> c) & 1;  // the first entry >= q: is it q?
    }
    *lo = nlo;
  }
}

// Lanes a search: 16, 8 or 4, the most that keep every search's lanes
// together within MEMBER_LANES_IN_FLIGHT (4 beyond).  Wider groups take
// fewer steps but load more pivots a search; past that many lanes the
// loads, not the steps, set the time (A/B on the H100 in intersect.cu).
static inline int member_lanes(long long searches) {
  for (int L = 16; L > 4; L >>= 1)
    if (searches * L <= MEMBER_LANES_IN_FLIGHT) return L;
  return 4;
}
