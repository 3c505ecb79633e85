// The per-relation epoch commit fold:
//     cins' = (cins \ udel) ∪ (uins \ cdel)
//     cdel' = cdel ∪ (udel ∩ base)
// both outputs, sentinel-padded exactly like csr._empty_like_caps (key
// sentinel by dtype, val 0), from the four committed/staged regions and
// the precomputed `in_ba` bits of udel's rows in base.
//
// Replaces the TPU kernel src/repro/kernels/merge/fold.py
// (make_fold_kernel(composite) / _fold_call): the 1-word form and, as the
// LO instantiation, the composite form that carries the int64 lo word
// through every probe (3-word compares) and every scatter (lo padded with
// int64-max).
//
// Bound on the H100: bytes.  Every entry of the four regions is read and
// both outputs are written; the probes between the (delta-sized and
// committed-sized) regions are binary searches.  The TPU kernel was
// gather-only because Pallas on a TPU scatters badly; Hopper scatters
// well, so this keeps the outputs and drops that method:
//   1. fold_masks: one thread per entry of cins | uins | udel -> keep bits
//      (membership probes; uins also drops entries that survive in the
//      kept cins, so both merges are of disjoint sets);
//   2. a multi-block exclusive scan of the concatenated keep bits
//      (per-tile sums, one block scanning the tile sums, per-tile scans);
//   3. fold_scatter: every kept entry goes to its merge position
//      i + |{entries of the other operand below it}|, read off the scan;
//      slots past the output's live count get the padding; one thread
//      writes both counts.
#include "common.cuh"

#define REPRO_SCAN_TILE 2048  // keep bits per scan tile (256 threads x 8)
#define REPRO_SCAN_THREADS 1024

struct FoldArgs {
  Region ci, cd, ui, ud;
  const int* in_ba;
};

template <bool LO>
__global__ void fold_masks(const __grid_constant__ FoldArgs a, int* flags) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cap_ci = a.ci.cap, cap_ui = a.ui.cap, cap_ud = a.ud.cap;
  if (i >= cap_ci + cap_ui + cap_ud) return;
  int keep = 0;
  if (i < cap_ci) {  // kept = cins \ udel
    if (i < live_of(a.ci)) {
      i64 k = load_key(a.ci.key, a.ci.k64, i);
      keep = !member_w<LO>(a.ud, k, load_lo<LO>(a.ci, i), a.ci.val[i]);
    }
  } else if (i < cap_ci + cap_ui) {  // fresh = uins \ cdel \ kept
    int j = i - cap_ci;
    if (j < live_of(a.ui)) {
      i64 k = load_key(a.ui.key, a.ui.k64, j);
      i64 l = load_lo<LO>(a.ui, j);
      int v = a.ui.val[j];
      bool in_kept = member_w<LO>(a.ci, k, l, v) &&
                     !member_w<LO>(a.ud, k, l, v);
      keep = !member_w<LO>(a.cd, k, l, v) && !in_kept;
    }
  } else {  // dead = (udel ∩ base) \ cdel
    int j = i - cap_ci - cap_ui;
    if (j < live_of(a.ud) && a.in_ba[j] != 0) {
      i64 k = load_key(a.ud.key, a.ud.k64, j);
      keep = !member_w<LO>(a.cd, k, load_lo<LO>(a.ud, j), a.ud.val[j]);
    }
  }
  flags[i] = keep;
}

// ---- multi-block exclusive scan: excl[0..L] with excl[L] = total --------
__global__ void scan_tiles(const int* flags, int L, unsigned* tile_sum) {
  __shared__ unsigned sh[REPRO_THREADS];
  int per = REPRO_SCAN_TILE / REPRO_THREADS;
  int base = blockIdx.x * REPRO_SCAN_TILE + threadIdx.x * per;
  unsigned s = 0;
  for (int k = 0; k < per; ++k)
    if (base + k < L) s += (unsigned)flags[base + k];
  unsigned total;
  block_excl_scan(s, sh, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

__global__ void scan_tile_sums(unsigned* tile_sum, int ntiles) {
  __shared__ unsigned sh[REPRO_SCAN_THREADS];
  int chunk = (ntiles + blockDim.x - 1) / blockDim.x;
  int lo = imin(threadIdx.x * chunk, ntiles);
  int hi = imin(lo + chunk, ntiles);
  unsigned s = 0;
  for (int i = lo; i < hi; ++i) s += tile_sum[i];
  unsigned total;
  unsigned run = block_excl_scan(s, sh, &total);
  for (int i = lo; i < hi; ++i) {  // in place: exclusive tile offsets
    unsigned x = tile_sum[i];
    tile_sum[i] = run;
    run += x;
  }
}

__global__ void scan_apply(const int* flags, int L, const unsigned* tile_off,
                           int* excl) {
  __shared__ unsigned sh[REPRO_THREADS];
  int per = REPRO_SCAN_TILE / REPRO_THREADS;
  int base = blockIdx.x * REPRO_SCAN_TILE + threadIdx.x * per;
  unsigned s = 0;
  for (int k = 0; k < per; ++k)
    if (base + k < L) s += (unsigned)flags[base + k];
  unsigned total;
  unsigned run = tile_off[blockIdx.x] + block_excl_scan(s, sh, &total);
  for (int k = 0; k < per; ++k) {
    if (base + k < L) {
      excl[base + k] = (int)run;
      run += (unsigned)flags[base + k];
    }
    if (base + k == L - 1) excl[L] = (int)run;
  }
}

// ---- merge positions + padding ------------------------------------------
template <typename K>
__device__ __forceinline__ void put(void* key, int* val, int cap, int pos,
                                    i64 k, int v) {
  if (pos >= 0 && pos < cap) {  // out-of-range writes drop
    ((K*)key)[pos] = (K)k;
    val[pos] = v;
  }
}

// One output region: key (int32 or int64), val, and the composite lo word.
struct Out {
  void* key;
  int* val;
  i64* lo;
  int cap;
};

template <bool LO>
__device__ __forceinline__ void put_any(int k64, const Out& o, int pos,
                                        i64 k, i64 l, int v) {
  if (k64) put<i64>(o.key, o.val, o.cap, pos, k, v);
  else put<int>(o.key, o.val, o.cap, pos, k, v);
  if (LO && pos >= 0 && pos < o.cap) o.lo[pos] = l;
}

template <bool LO>
__global__ void fold_scatter(const __grid_constant__ FoldArgs a,
                             const int* excl, int k64, Out oci, int* oci_n,
                             Out ocd, int* ocd_n) {
  const int cap_oci = oci.cap, cap_ocd = ocd.cap;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cap_ci = a.ci.cap, cap_ui = a.ui.cap, cap_ud = a.ud.cap;
  int s_ui = cap_ci, s_ud = cap_ci + cap_ui, L = s_ud + cap_ud;
  int cap_cd = a.cd.cap;
  int n_kept = excl[s_ui] - excl[0];
  int n_fresh = excl[s_ud] - excl[s_ui];
  int n_dead = excl[L] - excl[s_ud];
  int n_cd = live_of(a.cd);
  int n_oci = n_kept + n_fresh;
  int n_ocd = n_cd + n_dead;
  const i64 sent = k64 ? (i64)0x7fffffffffffffffLL : (i64)0x7fffffff;
  const i64 sent_lo = (i64)0x7fffffffffffffffLL;
  if (i < cap_ci) {  // kept cins entry -> a + |{fresh < it}|
    int j = (int)i;
    if (excl[j + 1] != excl[j]) {
      i64 k = load_key(a.ci.key, a.ci.k64, j);
      i64 l = load_lo<LO>(a.ci, j);
      int v = a.ci.val[j];
      int p = lex_bound_w<LO>(a.ui, live_of(a.ui), k, l, v, false);
      int pos = (excl[j] - excl[0]) + (excl[s_ui + p] - excl[s_ui]);
      put_any<LO>(k64, oci, pos, k, l, v);
    }
  } else if (i < s_ud) {  // fresh uins entry -> f + |{kept < it}|
    int j = (int)i - s_ui;
    if (excl[s_ui + j + 1] != excl[s_ui + j]) {
      i64 k = load_key(a.ui.key, a.ui.k64, j);
      i64 l = load_lo<LO>(a.ui, j);
      int v = a.ui.val[j];
      int q = lex_bound_w<LO>(a.ci, live_of(a.ci), k, l, v, false);
      int pos = (excl[s_ui + j] - excl[s_ui]) + (excl[q] - excl[0]);
      put_any<LO>(k64, oci, pos, k, l, v);
    }
  } else if (i < L) {  // dead udel entry -> d + |{cdel < it}|
    int j = (int)i - s_ud;
    if (excl[s_ud + j + 1] != excl[s_ud + j]) {
      i64 k = load_key(a.ud.key, a.ud.k64, j);
      i64 l = load_lo<LO>(a.ud, j);
      int v = a.ud.val[j];
      int q = lex_bound_w<LO>(a.cd, n_cd, k, l, v, false);
      int pos = (excl[s_ud + j] - excl[s_ud]) + q;
      put_any<LO>(k64, ocd, pos, k, l, v);
    }
  } else if (i < (long long)L + cap_cd) {  // cdel entry -> i + |{dead < it}|
    int j = (int)(i - L);
    if (j < n_cd) {
      i64 k = load_key(a.cd.key, a.cd.k64, j);
      i64 l = load_lo<LO>(a.cd, j);
      int v = a.cd.val[j];
      int p = lex_bound_w<LO>(a.ud, live_of(a.ud), k, l, v, false);
      int pos = j + (excl[s_ud + p] - excl[s_ud]);
      put_any<LO>(k64, ocd, pos, k, l, v);
    }
  } else if (i < (long long)L + cap_cd + cap_oci) {  // cins' padding
    int t = (int)(i - L - cap_cd);
    if (t >= n_oci) put_any<LO>(k64, oci, t, sent, sent_lo, 0);
  } else if (i < (long long)L + cap_cd + cap_oci + cap_ocd) {  // cdel' pad
    int t = (int)(i - L - cap_cd - cap_oci);
    if (t >= n_ocd) put_any<LO>(k64, ocd, t, sent, sent_lo, 0);
  }
  if (i == 0) {
    *oci_n = n_oci;
    *ocd_n = n_ocd;
  }
}

static int ntiles_of(long long L) {
  return (int)((L + REPRO_SCAN_TILE - 1) / REPRO_SCAN_TILE);
}

// scratch layout (int32 words): flags [L], excl [L + 1], tile sums [T]
extern "C" int repro_commit_fold_scratch(int cap_ci, int cap_ui, int cap_ud) {
  long long L = (long long)cap_ci + cap_ui + cap_ud;
  return (int)(2 * L + 1 + ntiles_of(L));
}

// `oci_lo` / `ocd_lo` are the outputs' lo words for composite regions,
// null otherwise.
extern "C" int repro_commit_fold(const int64_t* desc, const int* in_ba,
                                 int* scratch, void* oci_key, int* oci_val,
                                 i64* oci_lo, int* oci_n, int cap_oci,
                                 void* ocd_key, int* ocd_val, i64* ocd_lo,
                                 int* ocd_n, int cap_ocd, void* stream) {
  FoldArgs a;
  a.ci = region_from(desc);
  a.cd = region_from(desc + REPRO_DESC_WORDS);
  a.ui = region_from(desc + 2 * REPRO_DESC_WORDS);
  a.ud = region_from(desc + 3 * REPRO_DESC_WORDS);
  a.in_ba = in_ba;
  int k64 = a.ci.k64;
  int lo = 0;
  if (a.cd.k64 != k64 || a.ui.k64 != k64 || a.ud.k64 != k64 ||
      !lo_uniform(desc, 4, &lo) || (lo != 0) != (oci_lo != nullptr) ||
      (lo != 0) != (ocd_lo != nullptr))
    return (int)cudaErrorInvalidValue;
  Out oci = {oci_key, oci_val, oci_lo, cap_oci};
  Out ocd = {ocd_key, ocd_val, ocd_lo, cap_ocd};
  long long L = (long long)a.ci.cap + a.ui.cap + a.ud.cap;
  int T = ntiles_of(L);
  int* flags = scratch;
  int* excl = scratch + L;
  unsigned* tiles = (unsigned*)(scratch + 2 * L + 1);
  if (lo)
    REPRO_LAUNCH(fold_masks<true>, grid_for(L, REPRO_THREADS), REPRO_THREADS,
                 stream, a, flags);
  else
    REPRO_LAUNCH(fold_masks<false>, grid_for(L, REPRO_THREADS),
                 REPRO_THREADS, stream, a, flags);
  REPRO_LAUNCH(scan_tiles, T, REPRO_THREADS, stream, flags, (int)L, tiles);
  REPRO_LAUNCH(scan_tile_sums, 1, REPRO_SCAN_THREADS, stream, tiles, T);
  REPRO_LAUNCH(scan_apply, T, REPRO_THREADS, stream, flags, (int)L, tiles,
               excl);
  long long total = L + a.cd.cap + cap_oci + cap_ocd;
  if (lo)
    REPRO_LAUNCH(fold_scatter<true>, grid_for(total, REPRO_THREADS),
                 REPRO_THREADS, stream, a, excl, k64, oci, oci_n, ocd,
                 ocd_n);
  else
    REPRO_LAUNCH(fold_scatter<false>, grid_for(total, REPRO_THREADS),
                 REPRO_THREADS, stream, a, excl, k64, oci, oci_n, ocd,
                 ocd_n);
  return (int)cudaGetLastError();
}

REPRO_ERROR_STRING
