// Merge ranks: for each query (qk, qv), (lt, le) = the number of live
// entries of a sorted region lexicographically < / <= it, int32 [B].
//
// Replaces the TPU kernel src/repro/kernels/merge/merge.py
// (rank_kernel / rank_kernel_lex / _rank_call / rank_counts): the 1-word
// form and, as the LO instantiation, the composite (qk, ql, qv) form with
// two 3-word bisections.  A narrow (int32) hi word is loaded promoted to
// int64, never truncated, and the search never leaves the live prefix, so
// the reference's re-sentineling of promoted padding has nothing to do.
//
// Bound on the H100: bytes.  Compaction ranks every entry of one region
// against another (millions of queries against millions of entries), so
// the reads of the queries and the scattered search probes dominate;
// there is no arithmetic to speak of.  Design: one thread per query, two
// bisections over the first min(cap, n) entries (exactly
// csr.lex_searchsorted_cols), so sentinel-padded queries get
// lt = le = n.  Neighbouring threads hold neighbouring (sorted) queries,
// so their probe paths coincide and most probes hit L2.
#include "common.cuh"

template <bool LO>
__global__ void rank_kernel(const __grid_constant__ Region r, const void* qk,
                            int q64, const i64* ql, const int* qv, int B,
                            int* lt, int* le) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  i64 k = load_key(qk, q64, i);
  i64 l = LO ? ql[i] : 0;
  int v = qv[i];
  int n = live_of(r);
  lt[i] = lex_bound_w<LO>(r, n, k, l, v, false);
  le[i] = lex_bound_w<LO>(r, n, k, l, v, true);
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
      REPRO_LAUNCH(rank_kernel<true>, grid_for(B, REPRO_THREADS),
                   REPRO_THREADS, stream, r, qk, q64, ql, qv, B, lt, le);
    else
      REPRO_LAUNCH(rank_kernel<false>, grid_for(B, REPRO_THREADS),
                   REPRO_THREADS, stream, r, qk, q64, ql, qv, B, lt, le);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
