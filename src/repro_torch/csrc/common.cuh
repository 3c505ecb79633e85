// Shared device helpers of the streaming-session kernels.
//
// A sorted region is the torch IndexData layout: key [cap] int32 or int64
// (nondecreasing, sentinel-padded), val [cap] int32, n: a device int32
// scalar of live entries, and for a composite (hi, lo) key the int64 lo
// word [cap] (int64-max padded); entries sort by (key[, lo], val).  Kernels
// read n from device memory, so a launch never waits on the host.  Region
// descriptors travel by value in the kernel's parameter space (six int64
// words each on the host side: key pointer, val pointer, n pointer,
// capacity, key-is-int64, lo pointer or 0).
//
// Every search comes in a 1-word form (key, val) and a composite form
// (key, lo, val); kernels template on `bool LO` and call `*_w<LO>`, so the
// 1-word instantiation compiles to the 2-word compares alone.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

// Launch on the caller's stream.
#ifndef REPRO_LAUNCH
#define REPRO_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// Cooperative launch of a kernel of two parameters on the caller's stream:
// every block of the grid resident at once, so the kernel may wait at
// grid-wide barriers (cooperative_groups::this_grid().sync()).  Returns the
// launch's error: a grid too large to be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge), never run.
#ifndef REPRO_LAUNCH_COOP
#define REPRO_LAUNCH_COOP(kernel, grid, block, stream, a0, a1)            \
  repro_launch_coop((const void*)(kernel), (grid), (block), (stream),     \
                    (void*)&(a0), (void*)&(a1))
inline int repro_launch_coop(const void* kernel, int grid, int block,
                             void* stream, void* a0, void* a1) {
  void* args[2] = {a0, a1};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(block),
                                          args, 0, (cudaStream_t)stream);
}
#endif

// Launch with `smem` bytes of dynamic shared memory.
#ifndef REPRO_LAUNCH_SMEM
#define REPRO_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

#define REPRO_MAX_REGIONS 8
#define REPRO_THREADS 256
#define REPRO_DESC_WORDS 6

struct Region {
  const void* key;
  const int* val;
  const int* n;
  const i64* lo;  // composite lo word, or null
  int cap;
  int k64;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

inline Region region_from(const int64_t* d) {
  Region r;
  r.key = (const void*)d[0];
  r.val = (const int*)d[1];
  r.n = (const int*)d[2];
  r.cap = (int)d[3];
  r.k64 = (int)d[4];
  r.lo = (const i64*)d[5];
  return r;
}

// Do the first `nreg` descriptors agree on the key layout (all composite
// or none)?  A launch that mixes the two is refused, as in the reference.
inline int lo_uniform(const int64_t* desc, int nreg, int* has_lo) {
  int lo = nreg > 0 && desc[5] != 0;
  for (int r = 0; r < nreg; ++r)
    if ((desc[REPRO_DESC_WORDS * r + 5] != 0) != lo) return 0;
  *has_lo = lo;
  return 1;
}

inline int grid_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Key load, promoted to int64 (mixed widths promote, never truncate).
__device__ __forceinline__ i64 load_key(const void* p, int k64, int i) {
  return k64 ? ((const i64*)p)[i] : (i64)((const int*)p)[i];
}

// Live entries: min(cap, n).
__device__ __forceinline__ int live_of(const Region& r) {
  return imin(r.cap, *r.n);
}

// Lexicographic (key, val) bound over the first `hi` entries: the count of
// entries < (qk, qv) (right == false) or <= it (right == true).  This is
// csr.lex_searchsorted_cols: on sorted entries the plain bisection and the
// reference's fixed-depth loop stop at the same partition point.
template <typename K>
__device__ __forceinline__ int lex_bound_t(const K* key, const int* val,
                                           int hi, i64 qk, int qv,
                                           bool right) {
  int lo = 0;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    i64 mk = (i64)key[mid];
    int mv = val[mid];
    bool less = mk < qk || (mk == qk && (mv < qv || (right && mv == qv)));
    if (less) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int lex_bound(const Region& r, int hi, i64 qk,
                                         int qv, bool right) {
  return r.k64 ? lex_bound_t<i64>((const i64*)r.key, r.val, hi, qk, qv,
                                  right)
               : lex_bound_t<int>((const int*)r.key, r.val, hi, qk, qv,
                                  right);
}

// Is (qk, qv) among the live entries of r?  (csr.index_member)
__device__ __forceinline__ int member_of(const Region& r, i64 qk, int qv) {
  int n = live_of(r);
  int pos = lex_bound(r, n, qk, qv, false);
  if (pos >= n) return 0;
  return load_key(r.key, r.k64, pos) == qk && r.val[pos] == qv;
}

// ---- composite (key, lo, val) forms ----------------------------------------

// 3-word lexicographic bound over the first `hi` entries
// (csr.lex_searchsorted_cols over (key, lo, val)).
template <typename K>
__device__ __forceinline__ int lex_bound3_t(const K* key, const i64* lo,
                                            const int* val, int hi, i64 qk,
                                            i64 ql, int qv, bool right) {
  int a = 0;
  while (a < hi) {
    int mid = (a + hi) >> 1;
    i64 mk = (i64)key[mid];
    i64 ml = lo[mid];
    int mv = val[mid];
    bool less = mk < qk ||
                (mk == qk && (ml < ql ||
                              (ml == ql && (mv < qv || (right && mv == qv)))));
    if (less) a = mid + 1; else hi = mid;
  }
  return a;
}

__device__ __forceinline__ int lex_bound3(const Region& r, int hi, i64 qk,
                                          i64 ql, int qv, bool right) {
  return r.k64 ? lex_bound3_t<i64>((const i64*)r.key, r.lo, r.val, hi, qk,
                                   ql, qv, right)
               : lex_bound3_t<int>((const int*)r.key, r.lo, r.val, hi, qk,
                                   ql, qv, right);
}

__device__ __forceinline__ int member3_of(const Region& r, i64 qk, i64 ql,
                                          int qv) {
  int n = live_of(r);
  int pos = lex_bound3(r, n, qk, ql, qv, false);
  if (pos >= n) return 0;
  return load_key(r.key, r.k64, pos) == qk && r.lo[pos] == ql &&
         r.val[pos] == qv;
}

// The two layouts behind one name: `ql` is ignored when LO is false.
template <bool LO>
__device__ __forceinline__ int lex_bound_w(const Region& r, int hi, i64 qk,
                                           i64 ql, int qv, bool right) {
  if (LO) return lex_bound3(r, hi, qk, ql, qv, right);
  return lex_bound(r, hi, qk, qv, right);
}

template <bool LO>
__device__ __forceinline__ int member_w(const Region& r, i64 qk, i64 ql,
                                        int qv) {
  if (LO) return member3_of(r, qk, ql, qv);
  return member_of(r, qk, qv);
}

template <bool LO>
__device__ __forceinline__ i64 load_lo(const Region& r, int i) {
  return LO ? r.lo[i] : 0;
}

// Exclusive scan of one unsigned value per thread across the block, with
// the block total in *total.  Every thread of the block must call it.
// Shared memory `sh` holds blockDim.x words.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v, unsigned* sh,
                                                    unsigned* total) {
  int t = threadIdx.x;
  int nt = blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    unsigned x = t >= off ? sh[t - off] : 0u;
    __syncthreads();
    sh[t] += x;
    __syncthreads();
  }
  unsigned incl = sh[t];
  *total = sh[nt - 1];
  __syncthreads();
  return incl - v;
}

#define REPRO_ERROR_STRING                                   \
  extern "C" const char* repro_error_string(int code) {      \
    return cudaGetErrorString((cudaError_t)code);            \
  }
