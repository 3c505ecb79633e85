// Blocked online-softmax attention with causal masking, a sliding window,
// a tanh logit softcap, a query offset (decode against a cache) and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_kernel :32 / _flash_call :73, reached through ops.mha).  For each
// query row at position p = q_offset + i and each of its keys j < Sk the
// score is s = (q . k) * scale, capped to softcap * tanh(s / softcap) when
// softcap > 0; a key is live when (not causal or j <= p) and (window == 0
// or j > p - window), and a masked score is -1e30 (not -inf), so a row
// without any live key averages v over all Sk keys, as the plain version
// (kernels/flash_attention/ref.py) does.  Softmax and both contractions
// accumulate in f32; the output is rounded once to the input type, and the
// denominator is floored at 1e-30.
//
// Layout: q, o [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D], contiguous (the
// transformer's own layout).  Query head h reads KV head h / G (G = Hq /
// Hkv) by index: the JAX wrapper's jnp.repeat of k and v is never
// materialised.  A block's rows interleave the G heads of one KV group
// (row r is position r / G of head kvh * G + r % G), so every K/V row a
// block reads serves all G heads.
//
// Bounds on the H100 (gemma2-2b: 4 requests, 8 / 4 heads, D 256).  Prefill
// (Sq = Sk = 8192) is bound by operations: 4 * D flops per live (row, key)
// pair, 1.1 TFLOP for a causal layer, 1.11 ms at the tensor cores' 989
// TFLOP/s.  Decode (one row per head over an 8,224-row cache) is bound by
// the bytes of the live cache rows, read once for both heads of a group:
// 135 MB, 0.040 ms at 3.35 TB/s.
//
// Three routes, chosen by the wrapper (kernels/flash_attention/ops.py):
//
// 1. bf16 prefill (G * Sq > 8; D in {32, 64, 128, 256}): flash_prefill<D>,
//    the tensor cores through wgmma.  A block owns 128 rows of one
//    (request, KV head) and walks its keys in tiles of 64: 256 threads,
//    two warpgroups of 64 rows each.  K and V tiles arrive by TMA (D / 64
//    boxes of 64 keys x 64 columns each, 128-byte swizzle, keys past Sk
//    zero-filled) into a ring of 2 stages guarded by mbarriers (full: 1
//    arrival + the bytes; empty: lane 0 of each of the 8 warps); thread 0
//    starts them one tile ahead, loading tile i + 1 into the other stage
//    once both warpgroups have released tile i - 1.  Each warpgroup stores
//    its Q rows once, swizzled, then per tile: S = Q K^T as D / 16 wgmma
//    m64n64k16 (both operands K-major in shared memory), the scale, cap
//    and masks in f32 on the accumulators, the online softmax (row max
//    over the quad of threads that share a row), and O += P V as wgmma
//    m64nDk16 with P from registers and V read MN-major (transposed) from
//    the stage.  Shared memory at D = 256: Q 2 x 64 x 256 x 2 = 64 KB, K
//    and V 2 stages x 2 x 32 KB = 128 KB, 192 KB and the barriers of 227
//    KB, one block per SM.  Registers: a thread holds 128 f32 of O, 32 of
//    S and 32 of P, 253 in all at D = 256, no spills (ptxas -v in the
//    build log).  A dedicated producer does not fit: a ninth warp puts
//    three warps on one of the SM's four register files and caps every
//    thread at 168 registers, and a producer warpgroup with setmaxnreg
//    240 / 24 spilled the same 1.5 KB (ptxas kept the consumers at the
//    entry's 168).  D = 32 is stored padded to 64 columns (TMA fills the
//    pad with zeros).
//
//    Numerics.  bf16 products of q and k are exact in f32 and the sum is
//    f32; the scale multiplies S in f32 (exact at D = 256, one rounding
//    otherwise).  Scores are kept in base 2 (times log2 e) for ex2; the
//    cap is c - 2c / (1 + 2^(2 s / c * log2 e)) with ex2 and rcp, about
//    2e-5 (base 2) off near 0, so about 1e-5 of each p, which moves an
//    output by about 1e-5 of its own size.  P must not be a single bf16
//    copy: its 2^-8 relative error per term moves an output by about
//    0.002 of its own size, and the serving check allows one bf16 step of
//    the output (2^-7) plus 1e-5, which near-zero outputs then miss
//    (tests/test_torch_flash_split.py pins both).  So P = p_hi + p_lo with
//    p_hi = bf16(p), p_lo = bf16(p - p_hi) (the subtraction is exact), two
//    wgmma against the same V tile, 2^-16 relative per term; the
//    denominator sums the f32 p.  This costs 1.5x the bound's operations.
//
// 2. f32 prefill (G * Sq > 8): flash_kernel, f32 FMAs on the CUDA cores.
//    Only the card-against-host checks (lm verify at 1e-4 / 1e-3) and the
//    f32 sweep (3e-4) use it; TF32 on the tensor cores keeps about three
//    decimal digits and could not meet them.  32 rows x 32-key tiles, 256
//    threads: the tile's K and V in f32 shared memory (rows padded to D +
//    4 words so float4 loads hit distinct banks), a warp's score rows
//    with lane j against key j and shuffle reductions, each thread an
//    8-row x 4-column chunk of O in registers; 103,680 bytes of shared
//    memory at D 256, two blocks per SM.
//
// 3. decode, both types (G * Sq <= 8): flash_decode_split then
//    flash_decode_combine.  The wrapper cuts the live key range into
//    `splits` chunks (ref.split_plan: B * Hkv * splits near 512 blocks,
//    at least 64 keys a chunk; 32 chunks of 257 keys for gemma2-2b's 4
//    requests x 4 KV heads); block (chunk, request x KV head), 128
//    threads.  A key's row is split over a group of up to 32 lanes, 16
//    bytes a lane, and read once for the G * Sq rows of the group; each
//    lane copies its own pieces of the next keys into its own slots of a
//    3-deep shared-memory ring with cp.async, so three trips of loads
//    stay in flight without holding registers, and each lane group keeps
//    its own online softmax over 4 keys a trip.  The block merges its
//    groups and writes the chunk's (m, l, acc[G * Sq][D]) in f32 to
//    scratch; the combine (a block per row and 64 columns) rescales each
//    chunk by exp(m_s - max m) and divides once.  A chunk with no key (at
//    or past Sk) has m = -inf and weight 0 (never exp(-inf - -inf)); a
//    wholly masked chunk has m = -1e30, weight 0 beside a live chunk and
//    1 when every chunk is masked, so such a row averages v over all
//    keys.  bf16 keeps the prefill's base-2 arithmetic; f32 (lm verify)
//    uses expf and tanhf.  Decode is bound by bytes.
//
// Skipped tiles and skipped keys.  A block (and each consumer warpgroup,
// and the decode plan) visits only the keys live for some of its rows: up
// to its last row's position when causal, and from its first row's p -
// window + 1 when windowed.  A key outside that range is masked for every
// row, and skipping it gives the same result: in the blocked recurrence a
// wholly masked tile met before the first live one leaves m = -1e30, and
// the first live score s > -1e30 wipes what it added with alpha =
// exp(-1e30 - m') = 0 (f32 underflow); one met after a live one adds p =
// exp(-1e30 - m) = 0.  A decode chunk of such keys would add weight
// exp(-1e30 - max m) = 0 in the combine.  When some row has no live key at
// all, the visit covers every key instead, so that row averages v over
// all of them as the plain version does.  Keys at or past Sk are excluded
// outright (score -inf, p = 0).  Prefill blocks start longest rows first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define FA_NEG (-1e30f)
#define FA_L2E 1.4426950408889634f
#define FA_MAX_D 256

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, Hq, Hkv, D, G;
  int causal, window, q_offset;
  float softcap, scale;
};

// The keys live for some of rows r_lo..r_hi (see the source note): [kb,
// ke), or every key when one of the rows has none.
__host__ __device__ inline void live_keys(const FaArgs& a, int r_lo,
                                          int r_hi, int* kb, int* ke) {
  const i64 p_lo = (i64)a.q_offset + r_lo / a.G;
  const i64 p_hi = (i64)a.q_offset + r_hi / a.G;
  *kb = 0;
  *ke = a.Sk;
  if (a.window > 0 && p_hi - a.window + 1 > (i64)a.Sk - 1) return;
  if (a.causal && p_hi + 1 < (i64)a.Sk) *ke = (int)(p_hi + 1);
  if (a.window > 0 && p_lo - a.window + 1 > 0)
    *kb = (int)(p_lo - a.window + 1);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// 2. f32 prefill on the CUDA cores
// ---------------------------------------------------------------------------

#define FA_THREADS 256
#define FA_WARPS 8
#define FA_BK 32
#define FA_M 32

__host__ __device__ inline int fa_smem_floats(int D) {
  return FA_M * (D + 4) + FA_BK * (D + 4) + FA_BK * D + FA_M * FA_BK +
         2 * FA_M;
}

__global__ void __launch_bounds__(FA_THREADS, 2) flash_kernel(FaArgs a) {
  constexpr int RPT = FA_M / FA_WARPS;  // score rows per warp
  extern __shared__ float4 fa_smem4[];
  const int D = a.D, DP = D + 4, G = a.G;
  float* Qs = (float*)fa_smem4;  // [M][DP] scaled queries
  float* Ks = Qs + FA_M * DP;    // [BK][DP]
  float* Vs = Ks + FA_BK * DP;   // [BK][D]
  float* Ps = Vs + FA_BK * D;    // [M][BK] probabilities of the tile
  float* As = Ps + FA_M * FA_BK;  // [M] rescale of the tile
  float* Ls = As + FA_M;          // [M] final denominators
  const float* q = (const float*)a.q;
  const float* k = (const float*)a.k;
  const float* v = (const float*)a.v;
  float* o = (float*)a.o;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rows = G * a.Sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * FA_M;  // longest rows first

  for (int e = t * 4; e < FA_M * D; e += FA_THREADS * 4) {
    int r = e / D, d = e % D, gr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows) {
      int i = gr / G, h = kvh * G + gr % G;
      x = *(const float4*)(q + (((i64)b * a.Sq + i) * a.Hq + h) * D + d);
      x.x *= a.scale;
      x.y *= a.scale;
      x.z *= a.scale;
      x.w *= a.scale;
    }
    *(float4*)(Qs + r * DP + d) = x;
  }

  int k_begin, k_end;
  live_keys(a, r0, imin(r0 + FA_M - 1, rows - 1), &k_begin, &k_end);

  // the positions of this warp's score rows (padding rows repeat the last)
  i64 pos[RPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    int gr = imin(r0 + warp * RPT + j, rows - 1);
    pos[j] = (i64)a.q_offset + gr / G;
    m[j] = FA_NEG;
    l[j] = 0.f;
  }

  const int ncg = D / 4;                  // column groups of 4
  const int rc = t / ncg, cg = t % ncg;   // this thread's output chunk
  const bool has_chunk = rc < FA_M / 8;
  float acc[8][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[jj][c] = 0.f;

  for (int k0 = (k_begin / FA_BK) * FA_BK; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // Q is stored / the previous tile's readers are done
    for (int e = t * 4; e < FA_BK * D; e += FA_THREADS * 4) {
      int j = e / D, d = e % D, kk = k0 + j;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (kk < a.Sk) {
        i64 off = (((i64)b * a.Sk + kk) * a.Hkv + kvh) * D + d;
        x = *(const float4*)(k + off);
        y = *(const float4*)(v + off);
      }
      *(float4*)(Ks + j * DP + d) = x;
      *(float4*)(Vs + j * D + d) = y;
    }
    __syncthreads();

    float s[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) s[j] = 0.f;
    const float* kr = Ks + lane * DP;
    for (int d = 0; d < D; d += 4) {
      float4 kv = *(const float4*)(kr + d);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float4 qv = *(const float4*)(Qs + (warp * RPT + j) * DP + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    const int kk = k0 + lane;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float x = s[j];
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
      if (kk >= a.Sk)
        x = -INFINITY;
      else if ((a.causal && kk > pos[j]) ||
               (a.window > 0 && kk <= pos[j] - a.window))
        x = FA_NEG;
      float mn = fmaxf(m[j], warp_max(x));
      float p = expf(x - mn);
      float alpha = expf(m[j] - mn);
      l[j] = l[j] * alpha + warp_sum(p);
      m[j] = mn;
      int r = warp * RPT + j;
      Ps[r * FA_BK + lane] = p;
      if (lane == 0) As[r] = alpha;
    }
    __syncthreads();

    if (has_chunk) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float al = As[rc * 8 + jj];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[jj][c] *= al;
      }
      for (int j = 0; j < FA_BK; ++j) {
        float4 vv = *(const float4*)(Vs + j * D + cg * 4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float p = Ps[(rc * 8 + jj) * FA_BK + j];
          acc[jj][0] = fmaf(p, vv.x, acc[jj][0]);
          acc[jj][1] = fmaf(p, vv.y, acc[jj][1]);
          acc[jj][2] = fmaf(p, vv.z, acc[jj][2]);
          acc[jj][3] = fmaf(p, vv.w, acc[jj][3]);
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) Ls[warp * RPT + j] = l[j];
  }
  __syncthreads();
  if (!has_chunk) return;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    int r = rc * 8 + jj, gr = r0 + r;
    if (gr >= rows) continue;
    int i = gr / G, h = kvh * G + gr % G;
    float den = fmaxf(Ls[r], 1e-30f);
    *(float4*)(o + (((i64)b * a.Sq + i) * a.Hq + h) * D + cg * 4) =
        make_float4(acc[jj][0] / den, acc[jj][1] / den, acc[jj][2] / den,
                    acc[jj][3] / den);
  }
}

static int launch_f32(const FaArgs& a, int B, void* stream) {
  static bool attr_set = false;  // the largest D's shared memory, once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fa_smem_floats(FA_MAX_D) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  long long rows = (long long)a.G * a.Sq;
  dim3 grid((unsigned)((rows + FA_M - 1) / FA_M), (unsigned)(B * a.Hkv));
  REPRO_LAUNCH_SMEM(flash_kernel, grid, FA_THREADS,
                    fa_smem_floats(a.D) * sizeof(float), stream, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 1. bf16 prefill on the tensor cores (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

#define PF_THREADS 256  // two consumer warpgroups
#define PF_BM 64        // rows of a consumer warpgroup
#define PF_BN 64        // keys of a tile
#define PF_STAGES 2
#define PF_CHUNK (64 * 128)  // bytes of 64 rows x 64 bf16 columns

template <int D>
struct Pf {
  static constexpr int DP = D < 64 ? 64 : D;  // stored columns
  static constexpr int NC = DP / 64;          // 128-byte column chunks
  static constexpr int TILE = NC * PF_CHUNK;  // bytes of 64 rows
  static constexpr int K_OFF = 2 * TILE;      // after both Q tiles
  static constexpr int V_OFF = K_OFF + PF_STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + PF_STAGES * TILE;
  static constexpr int SMEM = BAR_OFF + 16 * PF_STAGES + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile (Q as A, K as B): rows of 128 bytes, 8-row groups 1024
// bytes apart (SBO); the leading offset is unused with the swizzle.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major tile (V as B, transposed): 64-column atoms PF_CHUNK bytes apart
// along N (LBO), 8-key groups 1024 bytes apart along K (SBO).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, PF_CHUNK, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (+)= Q K^T over one k16 slice: m64n64k16, A and B K-major in shared
// memory; `acc` 0 overwrites the 32 accumulators.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// O += P V over one k16 slice: m64n64k16, P from registers (bf16 pairs
// in the accumulator layout), V MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O += P V over one k16 slice: m64n128k16, P from registers (bf16 pairs
// in the accumulator layout), V MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O += P V over one k16 slice: m64n256k16, P from registers (bf16 pairs
// in the accumulator layout), V MN-major in shared memory (transposed B).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a0, a1, a2, a3, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a0, a1, a2, a3, db);
  else
    wgmma_rs_n256(d, a0, a1, a2, a3, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *(uint32_t*)&h;
}

// Tile t of K and V into stage s: both arrive on one full barrier.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t base, int s, int t,
                                          uint32_t full,
                                          const CUtensorMap* tmk,
                                          const CUtensorMap* tmv, int kvh,
                                          int b) {
  using P = Pf<D>;
  mbar_expect_tx(full, 2 * P::TILE);
#pragma unroll
  for (int c = 0; c < P::NC; ++c) {
    tma_load_4d(base + P::K_OFF + s * P::TILE + c * PF_CHUNK, tmk, full,
                c * 64, kvh, t * PF_BN, b);
    tma_load_4d(base + P::V_OFF + s * P::TILE + c * PF_CHUNK, tmv, full,
                c * 64, kvh, t * PF_BN, b);
  }
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS, 1)
    flash_prefill(const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, FaArgs a) {
  using P = Pf<D>;
  extern __shared__ uint8_t pf_raw[];
  const uint32_t raw = smem_u32(pf_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's atom
  uint8_t* sbase = pf_raw + (base - raw);
  const uint32_t full0 = base + P::BAR_OFF, empty0 = full0 + 8 * PF_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int G = a.G, rows = G * a.Sq;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * (2 * PF_BM);  // longest first
  int kb, ke;
  live_keys(a, r0, imin(r0 + 2 * PF_BM - 1, rows - 1), &kb, &ke);
  const int t0 = kb / PF_BN, t1 = (ke + PF_BN - 1) / PF_BN;

  if (tid == 0) {
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid == 0 && t0 < t1)
    load_tile<D>(base, 0, t0, full0, &tmk, &tmv, kvh, b);
  {
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int rw0 = r0 + wg * PF_BM;  // this warpgroup's first row
    const uint32_t qs = base + wg * P::TILE;

    // Q rows, swizzled: 16-byte unit u of row r at r * 128 + (u ^ r % 8)
    // * 16 in its 128-byte column chunk; zeros past the rows and past D
    const __nv_bfloat16* q = (const __nv_bfloat16*)a.q;
    for (int u = t; u < PF_BM * (P::DP / 8); u += 128) {
      const int rr = u / (P::DP / 8), cu = u % (P::DP / 8), gr = rw0 + rr;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && cu * 8 < D) {
        const int i = gr / G, h = kvh * G + gr % G;
        x = *(const uint4*)(q + (((i64)b * a.Sq + i) * a.Hq + h) * D +
                            cu * 8);
      }
      *(uint4*)(sbase + wg * P::TILE + (cu / 8) * PF_CHUNK + rr * 128 +
                (((cu % 8) ^ (rr % 8)) * 16)) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    // this thread's two rows (ra, ra + 8 of the warpgroup) and their
    // positions; padding rows repeat the last row
    const int ra = 16 * warp + lane / 4, cq = 2 * (lane % 4);
    int pos[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      pos[j] = a.q_offset + imin(rw0 + ra + 8 * j, rows - 1) / G;
    const bool live_wg = rw0 < rows;
    const int rw1 = imin(rw0 + PF_BM - 1, rows - 1);
    int wkb, wke;
    live_keys(a, rw0, rw1, &wkb, &wke);
    const int wp_lo = a.q_offset + rw0 / G, wp_hi = a.q_offset + rw1 / G;

    const bool cap = a.softcap > 0.f;
    const float s_l2 = a.scale * FA_L2E;                 // no cap
    const float c_k = cap ? 2.f * a.scale / a.softcap * FA_L2E : 0.f;
    const float c_l2 = a.softcap * FA_L2E;               // cap, base 2
    float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
    float o[P::DP / 2];
#pragma unroll
    for (int i = 0; i < P::DP / 2; ++i) o[i] = 0.f;

    for (int tt = t0; tt < t1; ++tt) {
      const int i = tt - t0, s = i % PF_STAGES, k0 = tt * PF_BN;
      mbar_wait(full0 + 8 * s, (i / PF_STAGES) & 1);
      // thread 0 loads the next tile into the other stage once both
      // warpgroups have released the tile before this one
      if (tid == 0 && tt + 1 < t1) {
        const int s1 = (i + 1) % PF_STAGES;
        if (i >= 1) mbar_wait(empty0 + 8 * s1, ((i - 1) / PF_STAGES) & 1);
        load_tile<D>(base, s1, tt + 1, full0 + 8 * s1, &tmk, &tmv, kvh, b);
      }
      __syncwarp();
      if (live_wg && k0 < wke && k0 + PF_BN > wkb) {
        const uint32_t ks = base + P::K_OFF + s * P::TILE;
        const uint32_t vs = base + P::V_OFF + s * P::TILE;
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * PF_CHUNK + (kk % 4) * 32;
          wgmma_ss_n64(sc, desc_kmajor(qs + off), desc_kmajor(ks + off),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        pin(sc);

        // accumulator i: row ra + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2)
        // + cq + (i & 1); scores in base 2
        const bool whole = k0 + PF_BN <= a.Sk &&
                           (!a.causal || k0 + PF_BN - 1 <= wp_lo) &&
                           (a.window == 0 || k0 > wp_hi - a.window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float x = cap ? c_l2 - 2.f * c_l2 * rcp(1.f + ex2(sc[e] * c_k))
                        : sc[e] * s_l2;
          if (!whole) {
            const int kk = k0 + 8 * (e >> 2) + cq + (e & 1);
            const int p = pos[(e >> 1) & 1];
            if (kk >= a.Sk)
              x = -INFINITY;
            else if ((a.causal && kk > p) ||
                     (a.window > 0 && kk <= p - a.window))
              x = FA_NEG;
          }
          sc[e] = x;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          alpha[j] = ex2(m[j] - mx[j]);
          m[j] = mx[j];
        }
        // P = p_hi + p_lo, each a bf16 A fragment per 16 keys: register e
        // of slice j packs accumulators 8j + 2e and 8j + 2e + 1
        uint32_t ph[16], pl[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int j = e & 1;  // accumulators 2e, 2e + 1: one row
          const float p0 = ex2(sc[2 * e] - mx[j]);
          const float p1 = ex2(sc[2 * e + 1] - mx[j]);
          rs[j] += p0 + p1;
          const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
          ph[e] = *(const uint32_t*)&h;
          pl[e] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
        for (int e = 0; e < P::DP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t dv = desc_mnmajor(vs + j * 16 * 128);
          wgmma_rs<P::DP>(o, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                          ph[4 * j + 3], dv);
          wgmma_rs<P::DP>(o, pl[4 * j], pl[4 * j + 1], pl[4 * j + 2],
                          pl[4 * j + 3], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        pin(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: the quad's partial denominators, one division, bf16 pairs
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    }
    __nv_bfloat16* out = (__nv_bfloat16*)a.o;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gr = rw0 + ra + 8 * j;
      if (gr >= rows) continue;
      const int i = gr / G, h = kvh * G + gr % G;
      const float den = fmaxf(l[j], 1e-30f);
      __nv_bfloat16* orow = out + (((i64)b * a.Sq + i) * a.Hq + h) * D;
#pragma unroll
      for (int g = 0; g < P::DP / 8; ++g) {
        if (8 * g >= D) break;
        *(__nv_bfloat162*)(orow + 8 * g + cq) = __floats2bfloat162_rn(
            o[4 * g + 2 * j] / den, o[4 * g + 2 * j + 1] / den);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query (no -lcuda at build time).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// TMA map of k or v [B, S, H, D] bf16: boxes of 64 columns x 1 head x 64
// keys, 128-byte swizzle; columns past D and keys past S read as zeros.
static int kv_map(CUtensorMap* map, const void* ptr, int D, int H, int S,
                  int B) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                           (cuuint64_t)S * H * D * 2};
  cuuint32_t box[4] = {64, 1, PF_BN, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)ptr,
                   dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_prefill(const FaArgs& a, int B, void* stream) {
  void (*kernel)(const CUtensorMap, const CUtensorMap, FaArgs) =
      flash_prefill<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Pf<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tk, tv;
  int e = kv_map(&tk, a.k, D, a.Hkv, a.Sk, B);
  if (e == 0) e = kv_map(&tv, a.v, D, a.Hkv, a.Sk, B);
  if (e != 0) return e;
  long long rows = (long long)a.G * a.Sq;
  dim3 grid((unsigned)(B * a.Hkv),
            (unsigned)((rows + 2 * PF_BM - 1) / (2 * PF_BM)));
  REPRO_LAUNCH_SMEM(kernel, grid, PF_THREADS, Pf<D>::SMEM, stream, tk, tv,
                    a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. decode: split over the cache, then combine
// ---------------------------------------------------------------------------

#define DS_THREADS 128
#define DS_WARPS 4
#define DS_UNROLL 4  // keys a lane group takes a trip (2 when it holds 8
                     // rows, for registers)
#define DS_STAGES 3  // trips in flight in a lane's staging ring
#define DS_MAX_ROWS 8
#define DS_MAX_SPLITS 1024

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16 bytes of T as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack16(uint4 v, float* x, float) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack16(uint4 v, float* x, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// exp in the unit the decode kernels keep scores in: base 2 for bf16
// (the prefill's arithmetic, see the note), natural for f32
template <bool BASE2>
__device__ __forceinline__ float dexp(float x) {
  return BASE2 ? ex2(x) : expf(x);
}

// dynamic shared memory of the split kernel: the staging ring (stages x
// keys a trip x 16-byte vectors a lane x K and V x threads), reused for
// the merge of the lane groups' accumulators (rm x 1024 floats)
template <typename T>
__host__ __device__ constexpr int ds_smem(int rm) {
  return DS_STAGES * (rm > 2 ? 2 : DS_UNROLL) *
                     (FA_MAX_D / (16 / (int)sizeof(T)) / 32) * 2 *
                     DS_THREADS * 16 >
                 rm * 1024 * 4
             ? DS_STAGES * (rm > 2 ? 2 : DS_UNROLL) *
                   (FA_MAX_D / (16 / (int)sizeof(T)) / 32) * 2 * DS_THREADS *
                   16
             : rm * 1024 * 4;
}

// One block per (chunk of the plan, request x KV head).  Lane group g (of
// `lpk` lanes, a power of two covering D / VEC vectors) takes keys k_lo +
// (n * NG + g) * U + u on trip n; each lane copies its own 16-byte pieces
// of those K and V rows into its own slots of a DS_STAGES-deep ring with
// cp.async (so loads stay in flight without holding registers) and reads
// them back when the trip comes.  RM >= G * Sq rows.
template <typename T, int RM>
__global__ void __launch_bounds__(DS_THREADS)
    flash_decode_split(FaArgs a, int kb, int ke, int chunk, int splits,
                       float* ws_m, float* ws_l, float* ws_acc) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = FA_MAX_D / VEC / 32;  // vectors a lane holds: 1 or 2
  constexpr int E = NV * VEC;              // columns a lane holds
  constexpr int U = RM > 2 ? 2 : DS_UNROLL;
  constexpr bool B2 = sizeof(T) == 2;
  extern __shared__ uint4 ds_smem4[];  // the ring, then the merge
  __shared__ float sm_m[DS_THREADS][RM], sm_l[DS_THREADS][RM];

  const int R = a.G * a.Sq, D = a.D, nvec = D / VEC;
  const int bh = blockIdx.y, b = bh / a.Hkv, kvh = bh % a.Hkv;
  const int sp = blockIdx.x;
  int lpk = 1;
  while (lpk < nvec && lpk < 32) lpk <<= 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NG = DS_WARPS * (32 / lpk);
  const int grp = warp * (32 / lpk) + lane / lpk, sub = lane % lpk;
  const i64 ks = (i64)kb + (i64)sp * chunk;
  const int k_lo = (int)(ks < a.Sk ? ks : a.Sk);
  const i64 kh = ks + chunk < ke ? ks + chunk : ke;
  const int k_hi = (int)(kh < a.Sk ? kh : a.Sk);
  const T* kp = (const T*)a.k;
  const T* vp = (const T*)a.v;
  const i64 head = (i64)b * a.Sk * a.Hkv + kvh;  // key j: head + j * Hkv

  // scores in base 2 for bf16: cap c - 2c / (1 + 2^(2 s / c log2 e))
  const bool cap = a.softcap > 0.f;
  const float c_k = cap ? 2.f / a.softcap * FA_L2E : 0.f;
  const float c_l2 = a.softcap * FA_L2E;

  // the group's rows, scaled, and their positions
  float qv[RM][E];
  int pos[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int rr = r < R ? r : R - 1;
    const int i = rr / a.G, h = kvh * a.G + rr % a.G;
    pos[r] = a.q_offset + i;
    const T* qr = (const T*)a.q + (((i64)b * a.Sq + i) * a.Hq + h) * D;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int vi = sub + n * lpk;
      if (vi < nvec) {
        unpack16(*(const uint4*)(qr + vi * VEC), &qv[r][n * VEC], T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[r][n * VEC + e] *= a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[r][n * VEC + e] = 0.f;
      }
    }
  }

  float m[RM], l[RM], acc[RM][E];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // every lane of a warp takes the same trips (the shuffles span the
  // warp); a group past k_hi copies nothing (zero fill) and keeps its state
  const int step = NG * U, first = k_lo + warp * (32 / lpk) * U;
  const int trips = k_hi > first ? (k_hi - first + step - 1) / step : 0;
  const uint32_t ring = smem_u32(ds_smem4);
  auto slot = [&](int st, int u, int n, int kv) {
    return ring + ((((st * U + u) * NV + n) * 2 + kv) * DS_THREADS +
                   threadIdx.x) * 16;
  };
  auto fetch = [&](int n) {
    if (n < trips) {
      const int k0 = first + n * step + (lane / lpk) * U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k0 + u;
        const bool ok = kk < k_hi;
        const i64 row = (head + (i64)(ok ? kk : k_lo) * a.Hkv) * D;
#pragma unroll
        for (int nn = 0; nn < NV; ++nn) {
          const int vi = sub + nn * lpk;
          if (vi < nvec) {
            cp_async16(slot(n % DS_STAGES, u, nn, 0), kp + row + vi * VEC,
                       ok ? 16 : 0);
            cp_async16(slot(n % DS_STAGES, u, nn, 1), vp + row + vi * VEC,
                       ok ? 16 : 0);
          }
        }
      }
    }
    cp_async_commit();  // one group a trip, empty or not
  };
#pragma unroll
  for (int n = 0; n < DS_STAGES - 1; ++n) fetch(n);

  for (int n = 0; n < trips; ++n) {
    fetch(n + DS_STAGES - 1);
    cp_async_wait<DS_STAGES - 1>();  // trip n's group has landed
    const int k0 = first + n * step + (lane / lpk) * U;
    const uint4* st = ds_smem4 + (size_t)(n % DS_STAGES) * U * NV * 2 *
                                     DS_THREADS;
    // a lane's pieces past D were never copied: they read as zeros
    float kx[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int nn = 0; nn < NV; ++nn) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        unpack16(sub + nn * lpk < nvec
                     ? st[((u * NV + nn) * 2) * DS_THREADS + threadIdx.x]
                     : z,
                 &kx[u][nn * VEC], T());
      }
    float p[RM][U];  // 0 past k_hi and for rows >= R
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int u = 0; u < U; ++u) p[r][u] = 0.f;
      if (r >= R) continue;
      float sc[U], mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qv[r][e], kx[u][e], x);
        for (int o = lpk / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (B2)
          x = cap ? c_l2 - 2.f * c_l2 * rcp(1.f + ex2(x * c_k))
                  : x * FA_L2E;
        else if (cap)
          x = tanhf(x / a.softcap) * a.softcap;
        const int kk = k0 + u;
        if ((a.causal && kk > pos[r]) ||
            (a.window > 0 && kk <= pos[r] - a.window))
          x = FA_NEG;
        sc[u] = x;
        if (kk < k_hi) mx = fmaxf(mx, x);
      }
      if (k0 >= k_hi) continue;  // key k0 in range: mx is finite
      const float alpha = dexp<B2>(m[r] - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < k_hi) p[r][u] = dexp<B2>(sc[u] - mx);
        ps += p[r][u];
      }
      l[r] = l[r] * alpha + ps;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
    // P V, one V row at a time (zero-filled past k_hi, where p = 0)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[E];
#pragma unroll
      for (int nn = 0; nn < NV; ++nn) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        unpack16(sub + nn * lpk < nvec
                     ? st[((u * NV + nn) * 2 + 1) * DS_THREADS + threadIdx.x]
                     : z,
                 &vx[nn * VEC], T());
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p[r][u], vx[e], acc[r][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the merge now

  // merge the block's lane groups: weight exp(m_g - max m), 0 for a group
  // that saw no key (m = -inf)
  float* sm_acc = (float*)ds_smem4;  // [group][row][D]: NG * D <= 1024
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r >= R) break;
    if (sub == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int vi = sub + n * lpk;
      if (vi < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[(grp * RM + r) * D + vi * VEC + e] = acc[r][n * VEC + e];
    }
  }
  __syncthreads();
  const i64 out = (i64)bh * splits + sp;
  for (int x = threadIdx.x; x < R * D; x += DS_THREADS) {
    const int r = x / D, d = x % D;
    float mm = -INFINITY;
    for (int g = 0; g < NG; ++g) mm = fmaxf(mm, sm_m[g][r]);
    float ls = 0.f, as = 0.f;
    for (int g = 0; g < NG; ++g) {
      const float mg = sm_m[g][r];
      const float w = mg == -INFINITY ? 0.f : dexp<B2>(mg - mm);
      ls += w * sm_l[g][r];
      as += w * sm_acc[(g * RM + r) * D + d];
    }
    ws_acc[(out * R + r) * D + d] = as;
    if (d == 0) {
      ws_m[out * R + r] = mm;
      ws_l[out * R + r] = ls;
    }
  }
}

// One block per (request x KV head x row, 64 columns): o = sum_s w_s
// acc_s / sum_s w_s l_s, w_s = exp(m_s - max m), 0 for a chunk without
// keys (m = -inf).
template <typename T>
__global__ void __launch_bounds__(64)
    flash_decode_combine(FaArgs a, int splits, const float* ws_m,
                         const float* ws_l, const float* ws_acc) {
  constexpr bool B2 = sizeof(T) == 2;
  __shared__ float w[DS_MAX_SPLITS], red[2];
  const int R = a.G * a.Sq, D = a.D;
  const int bh = blockIdx.x / R, r = blockIdx.x % R;
  const int b = bh / a.Hkv, kvh = bh % a.Hkv;
  const int t = threadIdx.x, d = blockIdx.y * 64 + t;
  const i64 c0 = (i64)bh * splits;
  float mm = -INFINITY;
  for (int s = t; s < splits; s += 64)
    mm = fmaxf(mm, ws_m[(c0 + s) * R + r]);
  mm = warp_max(mm);
  if (t % 32 == 0) red[t / 32] = mm;
  __syncthreads();
  mm = fmaxf(red[0], red[1]);
  __syncthreads();
  float ls = 0.f;
  for (int s = t; s < splits; s += 64) {
    const float ms = ws_m[(c0 + s) * R + r];
    w[s] = ms == -INFINITY ? 0.f : dexp<B2>(ms - mm);
    ls += w[s] * ws_l[(c0 + s) * R + r];
  }
  ls = warp_sum(ls);
  if (t % 32 == 0) red[t / 32] = ls;
  __syncthreads();
  ls = red[0] + red[1];
  if (d >= D) return;
  const float* ap = ws_acc + (c0 * R + r) * D + d;
  float as = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) as = fmaf(w[s], ap[(i64)s * R * D], as);
  const int i = r / a.G, h = kvh * a.G + r % a.G;
  store1((T*)a.o + (((i64)b * a.Sq + i) * a.Hq + h) * D + d,
         as / fmaxf(ls, 1e-30f));
}

template <typename T, int RM>
static int launch_split(const FaArgs& a, int B, int kb, int ke, int chunk,
                        int splits, float* ws_m, float* ws_l, float* ws_acc,
                        void* stream) {
  void (*kernel)(FaArgs, int, int, int, int, float*, float*, float*) =
      flash_decode_split<T, RM>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ds_smem<T>(RM));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((unsigned)splits, (unsigned)(B * a.Hkv));
  REPRO_LAUNCH_SMEM(kernel, grid, DS_THREADS, ds_smem<T>(RM), stream, a, kb,
                    ke, chunk, splits, ws_m, ws_l, ws_acc);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_decode(const FaArgs& a, int B, int kb, int ke, int chunk,
                         int splits, float* ws_m, float* ws_l, float* ws_acc,
                         void* stream) {
  int e = a.G * a.Sq <= 2 ? launch_split<T, 2>(a, B, kb, ke, chunk, splits,
                                               ws_m, ws_l, ws_acc, stream)
                          : launch_split<T, DS_MAX_ROWS>(a, B, kb, ke, chunk,
                                                         splits, ws_m, ws_l,
                                                         ws_acc, stream);
  if (e != 0) return e;
  dim3 grid((unsigned)(B * a.Hkv * a.G * a.Sq), (unsigned)((a.D + 63) / 64));
  REPRO_LAUNCH(flash_decode_combine<T>, grid, 64, stream, a, splits, ws_m,
               ws_l, ws_acc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static int fa_args(FaArgs* a, const void* q, const void* k, const void* v,
                   void* o, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                   int causal, int window, float softcap, float scale,
                   int q_offset) {
  if (B < 0 || Sq < 0 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv ||
      D < 4 || D > FA_MAX_D || D % 4 || q_offset < 0 || window < 0 ||
      softcap < 0.f || (long long)B * Hkv > 65535 ||
      (long long)q_offset + Sq >= (1ll << 30))
    return (int)cudaErrorInvalidValue;
  a->q = q;
  a->k = k;
  a->v = v;
  a->o = o;
  a->Sq = Sq;
  a->Sk = Sk;
  a->Hq = Hq;
  a->Hkv = Hkv;
  a->D = D;
  a->G = Hq / Hkv;
  a->causal = causal;
  a->window = window;
  a->q_offset = q_offset;
  a->softcap = softcap;
  a->scale = scale;
  return 0;
}

// Prefill (G * Sq > 8).  q, o [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D]; all
// contiguous and 16-byte aligned, of one type: bf16 (`bf16` = 1, D in
// {32, 64, 128, 256}, the tensor-core kernel) or f32 (D a multiple of 4 up
// to 256).  Hq a multiple of Hkv, Sk >= 1, q_offset >= 0, window >= 0 (0:
// no window), softcap >= 0 (0: none).  Launches on `stream`; B == 0 is a
// no-op.
extern "C" int repro_flash_prefill(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int B,
                                   int Sq, int Sk, int Hq, int Hkv, int D,
                                   int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  FaArgs a;
  int e = fa_args(&a, q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window,
                  softcap, scale, q_offset);
  if (e != 0) return e;
  if ((long long)a.G * Sq <= DS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if (!bf16) return launch_f32(a, B, stream);
  switch (D) {
    case 32:
      return launch_prefill<32>(a, B, stream);
    case 64:
      return launch_prefill<64>(a, B, stream);
    case 128:
      return launch_prefill<128>(a, B, stream);
    case 256:
      return launch_prefill<256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Decode (1 <= G * Sq <= 8), same layout and options, either type; D a
// multiple of the 16-byte vector (8 bf16, 4 f32).  The keys [kb, ke) are
// cut into `splits` chunks of `chunk` (keys at or past Sk are skipped);
// ws_m, ws_l [B * Hkv * splits * G * Sq] and ws_acc [... * D] f32 scratch.
extern "C" int repro_flash_decode(const void* q, const void* k,
                                  const void* v, void* o, int bf16, int B,
                                  int Sq, int Sk, int Hq, int Hkv, int D,
                                  int causal, int window, float softcap,
                                  float scale, int q_offset, int kb, int ke,
                                  int chunk, int splits, float* ws_m,
                                  float* ws_l, float* ws_acc, void* stream) {
  FaArgs a;
  int e = fa_args(&a, q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window,
                  softcap, scale, q_offset);
  if (e != 0) return e;
  if (Sq < 1 || (long long)a.G * Sq > DS_MAX_ROWS || D % (bf16 ? 8 : 4) ||
      kb < 0 || ke < kb || chunk < 1 || splits < 1 ||
      splits > DS_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  return bf16 ? launch_decode<__nv_bfloat16>(a, B, kb, ke, chunk, splits,
                                             ws_m, ws_l, ws_acc, stream)
              : launch_decode<float>(a, B, kb, ke, chunk, splits, ws_m,
                                     ws_l, ws_acc, stream);
}

REPRO_ERROR_STRING
