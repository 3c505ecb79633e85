// Merge ranks: for each query (qk, qv), (lt, le) = the number of live
// entries of a sorted region lexicographically < / <= it, int32 [B].
//
// Replaces the TPU kernel src/repro/kernels/merge/merge.py
// (rank_kernel / _rank_call / _rank_counts, 1-word keys).
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

__global__ void rank_kernel(const __grid_constant__ Region r, const void* qk,
                            int q64, const int* qv, int B, int* lt,
                            int* le) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  i64 k = load_key(qk, q64, i);
  int v = qv[i];
  int n = live_of(r);
  lt[i] = lex_bound(r, n, k, v, false);
  le[i] = lex_bound(r, n, k, v, true);
}

extern "C" int repro_rank(const int64_t* desc, const void* qk, int q64,
                          const int* qv, int B, int* lt, int* le,
                          void* stream) {
  Region r = region_from(desc);
  if (B > 0) {
    REPRO_LAUNCH(rank_kernel, grid_for(B, REPRO_THREADS), REPRO_THREADS,
                 stream, r, qk, q64, qv, B, lt, le);
  }
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
