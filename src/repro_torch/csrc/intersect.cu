// Multi-region signed membership: for each query (qk, qv), the hit counts
// over every positive and every negative region of a versioned index in
// one launch -> (wpos, wneg) int32 [2, B], or the membership bits
// wpos > 0 as bool [B] (`bits`, the single-region `member`).
//
// Replaces the TPU kernel src/repro/kernels/intersect/intersect.py
// (_make_multi_member_kernel / _multi_member_call), 1-word keys and, as
// the LO instantiation, composite (qk, ql, qv) queries over (key, lo, val)
// regions with 3-word compares (normalize of an n-ary relation, seed
// filters keyed on 3-4 columns).  The same kernel serves single-region
// membership, replacing member_kernel / member_kernel_lex / _member_call
// (intersect.py:139-155): the `member` wrapper launches it with one
// positive region and no negative one and reads the bits.
//
// Bound on the H100: the bytes bound (each query's key and value read,
// two counts written, the searched entries read once) is a fraction of a
// microsecond; what bounds the kernel is the chain of dependent loads of
// each search.  A thread bisecting a 2^24-entry region waits on ~24 loads
// one after another, ~50 over the three regions of a normalize probe, and
// at B = 2048 a thread per query filled 8 of 132 SMs (0.0226 ms).  Design:
//   * a group of L lanes (16, 8 or 4) searches one region for one query:
//     each step its lanes load L pivots of the live range at once and a
//     __ballot_sync count picks one of L + 1 sub-ranges (a 17-ary search
//     takes 6 dependent steps for 2^24 entries, a 5-ary one 11).  Each
//     step also ballots equality, so the hit is known when the range
//     closes, without a further load;
//   * L follows the launch's searches (queries x regions): wide groups
//     take fewer steps but load more pivots, and past ~10^5 lanes the
//     loads set the time (member_lanes).  A/B on an NVIDIA H100 80GB
//     HBM3 at 700 W, device ms, L = 32 / 16 / 8 / 4: 3 regions x 2048
//     queries 0.0070 / 0.0058 / 0.0058 / 0.0065; composite, 3 x 16384
//     0.0524 / 0.0372 / 0.0276 / 0.0215;
//   * each region's first-level pivots are the same for every query: a
//     block stages them once in shared memory.  A second staged level
//     lost (L = 32, 3 regions x 2048 queries, same card: 0.0128 device ms
//     with two levels, 0.0072 with one, 0.0068 with none; 5 regions
//     0.0144 / 0.0093 / 0.0108): its loads cost what the step saves;
//   * a block puts a group on each (query, region) pair of its queries,
//     all in flight together; the hits meet in shared memory and one
//     thread per query adds them in region order, so wpos and wneg are
//     exact integer counts.  At B = 2048 the grid fills the card.
// The group search (pivots, compares, the ballot step, the lane choice)
// lives in search.cuh, shared with fused extend and merge ranks.  The live
// count n is read from device memory (live_of): a launch never waits on
// the host.  The TPU's two-level router + [BQ,128] row tile was a
// VMEM device; the searches here give the same bits.
#include "search.cuh"

// threads a block (one search group of L lanes per query and region)
#define MEMBER_THREADS 256

struct MemberArgs {
  Region r[REPRO_MAX_REGIONS];
  int npos;
  int nreg;
};

// The block: `qpb` queries x nreg regions, a group of L lanes on each
// (query, region) pair, the groups of a warp side by side.  Each region's
// first-level pivots (L entries at fixed fractions of its live count) are
// the same for every query: staged once per block in shared memory.
template <bool LO, int L>
__global__ void signed_member_kernel(const __grid_constant__ MemberArgs a,
                                     const void* qk, int q64, const i64* ql,
                                     const int* qv, int B, int qpb, int bits,
                                     int* out) {
  __shared__ i64 sk[REPRO_MAX_REGIONS * L];
  __shared__ i64 sl[LO ? REPRO_MAX_REGIONS * L : 1];
  __shared__ int sv[REPRO_MAX_REGIONS * L];
  __shared__ int sn[REPRO_MAX_REGIONS];
  __shared__ int hits[MEMBER_THREADS];
  const int nreg = a.nreg;
  const int t = threadIdx.x;
  if (t < nreg) sn[t] = live_of(a.r[t]);
  __syncthreads();
  if (t < nreg * L) {
    int r = t / L, n = sn[r];
    if (n > 0) {
      const Region& R = a.r[r];
      int p = member_pivot<L>(0, n, t - r * L);
      sk[t] = load_key(R.key, R.k64, p);
      sv[t] = R.val[p];
      if (LO) sl[t] = R.lo[p];
    }
  }
  __syncthreads();
  // this group's task: query q, region r
  const Group<L> g(t);
  const int task = t / L, gl = g.gl;
  const int r = task % nreg;
  const int q = blockIdx.x * qpb + task / nreg;
  const bool active = task < qpb * nreg && q < B;
  const Region& R = a.r[r];
  i64 k = 0, l = 0;
  int v = 0, lo = 0, hi = 0, hit = 0;
  if (active) {
    k = load_key(qk, q64, q);
    l = LO ? ql[q] : 0;
    v = qv[q];
    hi = sn[r];
  }
  // every lane of the warp joins every ballot; a group whose range has
  // closed compares nothing and keeps its result
  for (int step = 0; __any_sync(0xffffffffu, lo < hi); ++step) {
    const bool live = lo < hi;
    const int m = hi - lo;
    bool lt = false, eq = false;
    if (live) {
      i64 ek, el = 0;
      int ev;
      if (step == 0) {
        ek = sk[r * L + gl];
        ev = sv[r * L + gl];
        if (LO) el = sl[r * L + gl];
      } else {
        int p = member_pivot<L>(lo, m, gl);
        ek = load_key(R.key, R.k64, p);
        ev = R.val[p];
        if (LO) el = R.lo[p];
      }
      member_cmp<LO>(ek, el, ev, k, l, v, &lt, &eq);
    }
    group_step<L, true>(g, live, lt, eq, &lo, &hi, &hit);
  }
  if (gl == 0) hits[task] = active ? hit : 0;
  __syncthreads();
  const int qq = blockIdx.x * qpb + t;
  if (t < qpb && qq < B) {
    int p = 0, ng = 0;
    for (int j = 0; j < nreg; ++j) {  // region order
      if (j < a.npos) p += hits[t * nreg + j];
      else ng += hits[t * nreg + j];
    }
    if (bits) {
      ((bool*)out)[qq] = p > 0;
    } else {
      out[qq] = p;
      out[B + qq] = ng;
    }
  }
}

template <bool LO, int L>
static void member_launch(const MemberArgs& a, const void* qk, int q64,
                          const i64* ql, const int* qv, int B, int bits,
                          int* out, void* stream) {
  int qpb = imax(1, MEMBER_THREADS / L / a.nreg);
  int threads = (qpb * a.nreg * L + 31) / 32 * 32;
  auto kernel = signed_member_kernel<LO, L>;
  REPRO_LAUNCH(kernel, grid_for(B, qpb), threads, stream, a, qk, q64, ql, qv,
               B, qpb, bits, out);
}

template <bool LO>
static void member_dispatch(const MemberArgs& a, const void* qk, int q64,
                            const i64* ql, const int* qv, int B, int bits,
                            int* out, void* stream) {
  switch (member_lanes((long long)B * a.nreg)) {
    case 16:
      member_launch<LO, 16>(a, qk, q64, ql, qv, B, bits, out, stream);
      break;
    case 8:
      member_launch<LO, 8>(a, qk, q64, ql, qv, B, bits, out, stream);
      break;
    default:
      member_launch<LO, 4>(a, qk, q64, ql, qv, B, bits, out, stream);
  }
}

// `ql` is the queries' lo word for composite regions, null otherwise.
// `out`: int32 [2, B] (wpos, wneg), or bool [B] (wpos > 0) when `bits`.
extern "C" int repro_signed_member(const int64_t* desc, int npos, int nreg,
                                   const void* qk, int q64, const i64* ql,
                                   const int* qv, int B, int bits, int* out,
                                   void* stream) {
  int lo = 0;
  if (nreg < 1 || nreg > REPRO_MAX_REGIONS || npos < 0 || npos > nreg ||
      !lo_uniform(desc, nreg, &lo) || (lo != 0) != (ql != nullptr))
    return (int)cudaErrorInvalidValue;
  MemberArgs a;
  for (int r = 0; r < nreg; ++r)
    a.r[r] = region_from(desc + REPRO_DESC_WORDS * r);
  a.npos = npos;
  a.nreg = nreg;
  if (B > 0) {
    if (lo)
      member_dispatch<true>(a, qk, q64, ql, qv, B, bits, out, stream);
    else
      member_dispatch<false>(a, qk, q64, ql, qv, B, bits, out, stream);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
