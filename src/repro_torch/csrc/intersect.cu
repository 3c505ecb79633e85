// Multi-region signed membership: for each query (qk, qv), the hit counts
// over every positive and every negative region of a versioned index in
// one launch -> (wpos, wneg) int32 [B].
//
// Replaces the TPU kernel src/repro/kernels/intersect/intersect.py
// (_make_multi_member_kernel / _multi_member_call), 1-word keys and, as
// the LO instantiation, composite (qk, ql, qv) queries over (key, lo, val)
// regions with 3-word bisections (normalize of an n-ary relation, seed
// filters keyed on 3-4 columns).  The same kernel serves single-region
// membership, replacing member_kernel / member_kernel_lex / _member_call
// (intersect.py:139-155): the `member` wrapper launches it with one
// positive region and no negative one and reads wpos > 0.
//
// Bound on the H100: bytes.  Each query reads its key and value and
// writes two counts; each region costs one binary search of ~log2(cap)
// dependent loads, so the kernel is latency-bound on scattered HBM/L2
// reads, not on arithmetic.  Design: one thread per query, a loop over the
// region descriptors held in the parameter space (no descriptor copy, no
// host sync); the upper levels of every search tree are shared by all
// queries and stay in L2.  The TPU's two-level router + [BQ,128] row tile
// was a VMEM device; the bisection over HBM gives the same bits.
#include "common.cuh"

struct MemberArgs {
  Region r[REPRO_MAX_REGIONS];
  int npos;
  int nreg;
};

template <bool LO>
__global__ void signed_member_kernel(const __grid_constant__ MemberArgs a,
                                     const void* qk, int q64, const i64* ql,
                                     const int* qv, int B, int* wpos,
                                     int* wneg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  i64 k = load_key(qk, q64, i);
  i64 l = LO ? ql[i] : 0;
  int v = qv[i];
  int p = 0, ng = 0;
  for (int r = 0; r < a.nreg; ++r) {
    int h = member_w<LO>(a.r[r], k, l, v);
    if (r < a.npos) p += h; else ng += h;
  }
  wpos[i] = p;
  wneg[i] = ng;
}

// `ql` is the queries' lo word for composite regions, null otherwise.
extern "C" int repro_signed_member(const int64_t* desc, int npos, int nreg,
                                   const void* qk, int q64, const i64* ql,
                                   const int* qv, int B, int* wpos,
                                   int* wneg, void* stream) {
  int lo = 0;
  if (nreg > REPRO_MAX_REGIONS || !lo_uniform(desc, nreg, &lo) ||
      (lo != 0) != (ql != nullptr))
    return (int)cudaErrorInvalidValue;
  MemberArgs a;
  for (int r = 0; r < nreg; ++r)
    a.r[r] = region_from(desc + REPRO_DESC_WORDS * r);
  a.npos = npos;
  a.nreg = nreg;
  if (B > 0) {
    if (lo)
      REPRO_LAUNCH(signed_member_kernel<true>, grid_for(B, REPRO_THREADS),
                   REPRO_THREADS, stream, a, qk, q64, ql, qv, B, wpos, wneg);
    else
      REPRO_LAUNCH(signed_member_kernel<false>, grid_for(B, REPRO_THREADS),
                   REPRO_THREADS, stream, a, qk, q64, ql, qv, B, wpos, wneg);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
