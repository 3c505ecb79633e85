// Blocked online-softmax attention with causal masking, a sliding window,
// a tanh logit softcap, a query offset (decode against a cache) and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_kernel / _flash_call, reached through ops.mha).  For each query
// row at position p = q_offset + i and each of its keys j < Sk the score is
// s = (q * scale) . k, capped to softcap * tanh(s / softcap) when
// softcap > 0; a key is live when (not causal or j <= p) and (window == 0
// or j > p - window), and a masked score is -1e30 (not -inf), so a row
// without any live key averages v over all Sk keys, as the plain version
// (kernels/flash_attention/ref.py) does.  Softmax and both contractions
// run in f32 from f32 or bf16 inputs; the output is rounded once to the
// input type, and the denominator is floored at 1e-30.
//
// Layout: q, o [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D], contiguous (the
// transformer's own layout).  Query head h reads KV head h / (Hq / Hkv)
// by index: the JAX wrapper's jnp.repeat of k and v is never materialised.
//
// Bound on the H100.  Prefill (Sq = Sk = 8192, D = 256) is bound by
// operations: 4 * D flops per live (row, key) pair, about 1.1 TFLOP for a
// causal layer of 4 requests x 8 heads, 1.1 ms at the tensor cores' 989
// TFLOP/s.  Decode (Sq = 1 over an 8,224-row cache) is bound by the bytes
// of the live cache rows, read once for the two query heads that share
// them: 135 MB, 0.040 ms at 3.35 TB/s.  This first kernel does its
// arithmetic in f32 on the CUDA cores (67 TFLOP/s peak), so prefill sits
// at least 15x above its bound; wgmma on bf16 tiles, TMA and a split over
// the cache for decode are later work.
//
// Design.  A block owns M rows of one (request, KV head): row r is query
// position r / G of head kvh * G + r % G (G = Hq / Hkv), so the G heads of
// a group share every K/V tile the block loads.  M = 32 rows (16
// positions of a pair of heads) in general, M = 8 when G * Sq <= 8
// (decode).  256 threads (8 warps) per block walk the keys in tiles of
// BK = 32:
//   1. the tile's K and V rows go to shared memory as f32 (zeros past Sk);
//   2. warp w computes the scores of its M / 8 rows, lane j against key j
//      (float4 loads: the q row is a broadcast, K rows are padded to
//      D + 4 words so eight lanes' float4 loads hit distinct banks), then
//      the online-softmax update of each row with warp shuffles (tile max,
//      new max m', p = exp(s - m'), alpha = exp(m - m'), l = l * alpha +
//      sum p), writing p and alpha to shared memory;
//   3. each thread owns an 8-row x 4-column chunk of the output and keeps
//      it in registers across tiles: acc = acc * alpha + P V.
// Shared memory at D = 256, M = 32: Q 32 x 260 + K 32 x 260 + V 32 x 256
// + P 32 x 32 words + 2 x 32 = 103,680 bytes, so two blocks fit one SM's
// 227 KB; a 128 x 128 Q x K block with f32 tiles as on the TPU would need
// 128 x 256 x 4 x 3 = 384 KB and does not fit.  Registers: 32
// accumulators + 4 scores + 8 row statistics a thread, within the 128 that
// two resident blocks of 256 threads allow.
//
// Skipped tiles.  A block visits only the keys live for some of its rows:
// up to its last row's position when causal, and from its first row's
// p - window + 1 when windowed.  A tile outside that range is masked for
// every row of the block, and skipping it gives the same result: in the
// blocked recurrence a wholly masked tile met before the first live one
// leaves m = -1e30, and the first live score s > -1e30 wipes what it added
// with alpha = exp(-1e30 - m') = 0 (f32 underflow); one met after a live
// one adds p = exp(-1e30 - m) = 0.  When some row of the block has no live
// key at all, the block visits every key instead, so that row averages v
// over all of them as the plain version does.  Keys at or past Sk are
// excluded outright (score -inf, p = 0).  Blocks start longest rows first.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

#define FA_THREADS 256
#define FA_WARPS 8
#define FA_BK 32
#define FA_MAX_D 256
#define FA_NEG (-1e30f)

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, Hq, Hkv, D, G;
  int causal, window, q_offset;
  float softcap, scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *(const float4*)p;
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = (const __nv_bfloat162*)p;
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *(float4*)p = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* h = (__nv_bfloat162*)p;
  h[0] = __floats2bfloat162_rn(x.x, x.y);
  h[1] = __floats2bfloat162_rn(x.z, x.w);
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

__host__ __device__ inline int fa_smem_floats(int M, int D) {
  return M * (D + 4) + FA_BK * (D + 4) + FA_BK * D + M * FA_BK + 2 * M;
}

template <typename T, int M>
__global__ void __launch_bounds__(FA_THREADS, 2) flash_kernel(FaArgs a) {
  constexpr int RPT = M / FA_WARPS;  // score rows per warp
  extern __shared__ float4 fa_smem4[];
  const int D = a.D, DP = D + 4, G = a.G;
  float* Qs = (float*)fa_smem4;  // [M][DP] scaled queries
  float* Ks = Qs + M * DP;       // [BK][DP]
  float* Vs = Ks + FA_BK * DP;   // [BK][D]
  float* Ps = Vs + FA_BK * D;    // [M][BK] probabilities of the tile
  float* As = Ps + M * FA_BK;    // [M] rescale of the tile
  float* Ls = As + M;            // [M] final denominators
  const T* q = (const T*)a.q;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  T* o = (T*)a.o;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rows = G * a.Sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * M;  // longest rows first

  for (int e = t * 4; e < M * D; e += FA_THREADS * 4) {
    int r = e / D, d = e % D, gr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows) {
      int i = gr / G, h = kvh * G + gr % G;
      x = load4(q + (((i64)b * a.Sq + i) * a.Hq + h) * D + d);
      x.x *= a.scale;
      x.y *= a.scale;
      x.z *= a.scale;
      x.w *= a.scale;
    }
    *(float4*)(Qs + r * DP + d) = x;
  }

  // the keys live for some row of the block (see the source note)
  const i64 p_lo = (i64)a.q_offset + r0 / G;
  const i64 p_hi = (i64)a.q_offset + imin(r0 + M - 1, rows - 1) / G;
  int k_begin = 0, k_end = a.Sk;
  bool empty_row = a.window > 0 && p_hi - a.window + 1 > (i64)a.Sk - 1;
  if (!empty_row) {
    if (a.causal) k_end = (int)(p_hi + 1 < (i64)a.Sk ? p_hi + 1 : a.Sk);
    if (a.window > 0 && p_lo - a.window + 1 > 0)
      k_begin = (int)(p_lo - a.window + 1);
  }

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
  const bool has_chunk = rc < M / 8;
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
        x = load4(k + off);
        y = load4(v + off);
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
    float4 y = make_float4(acc[jj][0] / den, acc[jj][1] / den,
                           acc[jj][2] / den, acc[jj][3] / den);
    store4(o + (((i64)b * a.Sq + i) * a.Hq + h) * D + cg * 4, y);
  }
}

template <typename T, int M>
static int fa_launch(const FaArgs& a, int B, void* stream) {
  void (*kernel)(FaArgs) = flash_kernel<T, M>;  // no template comma in
                                                 // the launch macro
  static bool attr_set = false;  // the largest D's shared memory, once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fa_smem_floats(M, FA_MAX_D) * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  long long rows = (long long)a.G * a.Sq;
  dim3 grid((unsigned)((rows + M - 1) / M), (unsigned)(B * a.Hkv));
  REPRO_LAUNCH_SMEM(kernel, grid, FA_THREADS,
                    fa_smem_floats(M, a.D) * sizeof(float), stream, a);
  return (int)cudaGetLastError();
}

// q, o [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D]; all contiguous, of one type:
// bf16 (`bf16` = 1) or f32.  D a multiple of 4 up to 256, Hq a multiple of
// Hkv, Sk >= 1, q_offset >= 0, window >= 0 (0: no window), softcap >= 0
// (0: none).  Launches on `stream`; B == 0 or Sq == 0 is a no-op.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16, int B,
                                     int Sq, int Sk, int Hq, int Hkv, int D,
                                     int causal, int window, float softcap,
                                     float scale, int q_offset,
                                     void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv ||
      D < 4 || D > FA_MAX_D || D % 4 || q_offset < 0 || window < 0 ||
      softcap < 0.f || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  FaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.D = D;
  a.G = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.softcap = softcap;
  a.scale = scale;
  bool small = (long long)a.G * Sq <= 8;
  if (bf16)
    return small ? fa_launch<__nv_bfloat16, 8>(a, B, stream)
                 : fa_launch<__nv_bfloat16, 32>(a, B, stream);
  return small ? fa_launch<float, 8>(a, B, stream)
               : fa_launch<float, 32>(a, B, stream);
}

REPRO_ERROR_STRING
