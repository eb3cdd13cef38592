// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel pair repro/kernels/flash_attn.py
// `flash_attn_bwd` (pallas_calls at :236 and :249: `_bwd_kv_kernel` :153 and
// `_bwd_q_kernel` :183).  Same function: from q, o, do (BH, T, hd), k/v
// (BH/rep, S, hd) with query row b reading kv row b / rep, the forward's
// row logsumexp lse (BH, T) and delta = Σ_d do∘o (BH, T, computed outside),
// recompute each (64 x 64) tile of
//     p  = exp(s - lse),  s = q·kᵀ/sqrt(hd), masked logits -1e30
//     ds = p ∘ (do·vᵀ - delta) / sqrt(hd)
// and accumulate dv = pᵀ·do, dk = dsᵀ·q, dq = ds·k, all in float32.  As on
// the TPU, keys past S and (when causal) past the query are masked in s,
// query rows past T are zeroed on p, key tiles the causal mask covers
// completely are skipped (ki·64 <= qi·64 + 63 runs), dk/dv are written per
// query head and the GQA rep-sum is left to the caller.  An all-zero do
// row gives exactly zero gradients.
//
// Design.  The TPU grid carries the dk/dv (or dq) accumulators across its
// sequential innermost axis in VMEM.  Hopper blocks run in no order, so, as
// the TPU pair does, the work is split into two launches that need no
// atomics and are deterministic (repeats are bit-identical):
//   * k-stationary: one block per (bh, 64-key tile) loops over the query
//     tiles and keeps dk, dv in registers;
//   * q-stationary: one block per (bh, 64-query tile) loops over the key
//     tiles, longest causal rows first, and keeps dq in registers.
// Each recomputes its p and ds tiles; T x S is never materialised.  hd is
// padded to a template width (16, 32, 64, 80, 96, 128) with zero lanes
// that are never stored.
//
// bf16 (namespace mma, the tensor cores): four warps, each owning 16 keys
// (k-stationary) or 16 queries (q-stationary), every product an
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) from ldmatrix fragments.
//   * k-stationary: K and V stay in shared memory; Q and dO tiles (64
//     queries, row-major) and the tile's lse and delta arrive through a
//     double-buffered cp.async ring.  Each warp computes the transposed
//     tiles Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that its rows are its keys;
//     Pᵀ = exp(Sᵀ·scale - lse_col) and dSᵀ = Pᵀ∘(dPᵀ - delta_col) stay in
//     registers, where two m16n8 accumulators rounded to bf16 are the A
//     fragment of dV += Pᵀ·dO and dK += dSᵀ·Q, whose B operand is the
//     row-major Q/dO tile read by ldmatrix.trans.
//   * q-stationary: Q and dO are A fragments in registers for the whole
//     block; K and V tiles arrive through the ring; S = Q·Kᵀ and
//     dP = dO·Vᵀ read K and V with plain ldmatrix, dQ += dS·K with
//     ldmatrix.trans.
// The mask is applied only where a warp's tile crosses the diagonal or a
// ragged edge; fully masked tiles are skipped.  The softmax scale of ds is
// applied once to dk and dq at the end.  P and dS are rounded to bf16 as
// tensor-core operands (every tensor-core attention backward does; the TPU
// kernel keeps them in f32), so bf16 grads agree with the float32 plain
// version to a few 1e-3 of their largest entry, not 1e-4.  Where hd·2
// bytes or a base is not 16-byte aligned, element loads with zero fill
// take the place of cp.async (bwd_path says which).
//
// float32 (bwd_kv_kernel / bwd_q_kernel outside namespace mma, the CUDA
// cores): K and V (or Q and dO) staged once as f32 in shared memory, the
// p and ds tiles passed through shared memory, 4 x 4 and 4 x (hd/16)
// register micro-tiles; all arithmetic f32.
//
// Bound.  At the training path's shape (BH = 256, T = S = 512, hd 96, bf16,
// causal) the five products are 10·BH·T·S·hd/2 = 32 GFLOP on about 0.28 GB
// of inputs and f32 outputs: bound by bytes, about 0.08 ms at 3.35 TB/s.
// The two launches recompute S and dP, seven products in all, on
// mma.sync; wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr int PS = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

// rows [row0, row0 + 64) of a row-major (rows, hd) matrix -> f32 tile with
// row stride HDP + 1; rows past `rows` and lanes past hd are zero
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int hd) {
  for (int i = threadIdx.x; i < 64 * HDP; i += NT) {
    const int r = i / HDP, d = i - r * HDP, gr = row0 + r;
    dst[r * (HDP + 1) + d] = (gr < rows && d < hd) ? to_f32(src[(size_t)gr * hd + d]) : 0.f;
  }
}

// 64 floats of a (rows,) vector starting at row0, zero past `rows`
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int rows) {
  if (threadIdx.x < 64) {
    const int g = row0 + threadIdx.x;
    dst[threadIdx.x] = g < rows ? src[g] : 0.f;
  }
}

// p and ds of the (q tile at q0) x (key tile at k0) for rows ty + 16i and
// keys tx + 16j, into sP / sD (either may be null)
template <int HDP>
__device__ __forceinline__ void p_ds(const float* sQ, const float* sK, const float* sV,
                                     const float* sO, const float* sL, const float* sDel,
                                     float* sP, float* sD, int q0, int k0, int T_, int S,
                                     int causal, float scale) {
  constexpr int QS = HDP + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sQ[(ty + 16 * i) * QS + d];
      g[i] = sO[(ty + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = sK[(tx + 16 * j) * QS + d];
      vv[j] = sV[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      const bool keep = kpos < S && (!causal || kpos <= qpos);
      const float sc = keep ? s[i][j] * scale : NEG;
      const float p = qpos < T_ ? expf(sc - sL[r]) : 0.f;
      if (sP) sP[r * PS + c] = p;
      sD[r * PS + c] = p * (dp[i][j] - sDel[r]) * scale;
    }
  }
}

template <int HDP>
constexpr size_t smem_kv() {
  return sizeof(float) * (4 * (size_t)64 * (HDP + 1) + 2 * (size_t)64 * PS + 2 * 64);
}
template <int HDP>
constexpr size_t smem_q() {
  return sizeof(float) * (4 * (size_t)64 * (HDP + 1) + (size_t)64 * PS + 2 * 64);
}

// k-stationary: dk_h, dv_h (BH, S, hd) for the keys of one tile
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
              int T_, int S, int hd, int rep, int causal, int n_k, float scale) {
  constexpr int QS = HDP + 1, NJ = HDP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * QS;
  float* sQ = sV + 64 * QS;
  float* sO = sQ + 64 * QS;
  float* sP = sO + 64 * QS;
  float* sD = sP + 64 * PS;
  float* sL = sD + 64 * PS;
  float* sDel = sL + 64;

  const int bh = blockIdx.x / n_k, k0 = (blockIdx.x % n_k) * BK, kvh = bh / rep;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, HDP>(sK, k + (size_t)kvh * S * hd, k0, S, hd);
  load_rows<T, HDP>(sV, v + (size_t)kvh * S * hd, k0, S, hd);
  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_q = (T_ + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // the previous tile's reads of sQ, sO, sP, sD are done
    load_rows<T, HDP>(sQ, q + (size_t)bh * T_ * hd, q0, T_, hd);
    load_rows<T, HDP>(sO, dout + (size_t)bh * T_ * hd, q0, T_, hd);
    load_vec(sL, lse + (size_t)bh * T_, q0, T_);
    load_vec(sDel, delta + (size_t)bh * T_, q0, T_);
    __syncthreads();
    p_ds<HDP>(sQ, sK, sV, sO, sL, sDel, sP, sD, q0, k0, T_, S, causal, scale);
    __syncthreads();
    // dv[key][d] += Σ_q p[q][key]·do[q][d];  dk[key][d] += Σ_q ds[q][key]·q[q][d]
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pp[4], dd[4], oo[NJ], qq[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = sP[r * PS + ty + 16 * i];
        dd[i] = sD[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        oo[j] = sO[r * QS + tx + 16 * j];
        qq[j] = sQ[r * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          adv[i][j] = fmaf(pp[i], oo[j], adv[i][j]);
          adk[i][j] = fmaf(dd[i], qq[j], adk[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= S) continue;
    const size_t row = ((size_t)bh * S + key) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[row + d] = adk[i][j];
        dv[row + d] = adv[i][j];
      }
    }
  }
}

// q-stationary: dq (BH, T, hd) for the queries of one tile
template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq, int T_, int S, int hd,
             int rep, int causal, int n_q, float scale) {
  constexpr int QS = HDP + 1, NJ = HDP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + 64 * QS;
  float* sK = sO + 64 * QS;
  float* sV = sK + 64 * QS;
  float* sD = sV + 64 * QS;
  float* sL = sD + 64 * PS;
  float* sDel = sL + 64;

  const int bh = blockIdx.x / n_q;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * BQ;   // longest causal rows first
  const int kvh = bh / rep;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, HDP>(sQ, q + (size_t)bh * T_ * hd, q0, T_, hd);
  load_rows<T, HDP>(sO, dout + (size_t)bh * T_ * hd, q0, T_, hd);
  load_vec(sL, lse + (size_t)bh * T_, q0, T_);
  load_vec(sDel, delta + (size_t)bh * T_, q0, T_);
  float adq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

  int n_k = (S + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);   // skip fully masked tiles
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's reads of sK, sV, sD are done
    load_rows<T, HDP>(sK, k + (size_t)kvh * S * hd, k0, S, hd);
    load_rows<T, HDP>(sV, v + (size_t)kvh * S * hd, k0, S, hd);
    __syncthreads();
    p_ds<HDP>(sQ, sK, sV, sO, sL, sDel, nullptr, sD, q0, k0, T_, S, causal, scale);
    __syncthreads();
    // dq[q][d] += Σ_key ds[q][key]·k[key][d]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dd[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dd[i] = sD[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = sK[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = fmaf(dd[i], kk[j], adq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= T_) continue;
    const size_t row = ((size_t)bh * T_ + qpos) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[row + d] = adq[i][j];
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, float* dq, float* dk, float* dv,
                   int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)hd);
  const int n_q = (T_ + BQ - 1) / BQ, n_k = (S + BK - 1) / BK;
  // above 48 KB of dynamic shared memory a launch is refused unless allowed
  const size_t skv = smem_kv<HDP>(), sq = smem_q<HDP>();
  cudaError_t err = cudaFuncSetAttribute(bwd_kv_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)skv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_q_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sq);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  bwd_kv_kernel<T, HDP><<<(unsigned)(BH * n_k), NT, skv, st>>>(
      qt, kt, vt, ot, lse, delta, dk, dv, T_, S, hd, rep, causal, n_k, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_q_kernel<T, HDP><<<(unsigned)(BH * n_q), NT, sq, st>>>(
      qt, kt, vt, ot, lse, delta, dq, T_, S, hd, rep, causal, n_q, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, tiles through cp.async rings.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int NTM = 128;   // four warps, 16 keys or 16 queries each
constexpr float LOG2E = 1.4426950408889634f;

// k-stationary: K, V (64 rows), Q and dO (2 buffers x 64 rows each), row
// stride HDP + 8 elements (the 8 rows of an ldmatrix hit 8 bank groups);
// lse and delta (2 buffers x 64 floats each)
template <int HDP>
constexpr size_t smem_kv() {
  return sizeof(__nv_bfloat16) * (size_t)6 * 64 * (HDP + 8) + sizeof(float) * 4 * 64;
}
// q-stationary: Q, dO (64 rows), K and V (2 buffers x 64 rows each)
template <int HDP>
constexpr size_t smem_q() {
  return sizeof(__nv_bfloat16) * (size_t)6 * 64 * (HDP + 8);
}

// 64 floats of a (rows,) vector from row0 into shared memory, zero past rows
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int rows) {
  if (threadIdx.x < 64) {
    const int gr = row0 + threadIdx.x;
    cp_async4(smem_u32(dst + threadIdx.x), gr < rows ? src + gr : src, gr < rows);
  }
}

// f32 rows of a warp's (16 x HDP) accumulator, times `mul`, into a
// row-major (rows, hd) output; rows >= `rows` and lanes >= hd not stored
template <int NO>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&acc)[NO][4],
                                           int row0, int rows, int hd, float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= rows) continue;
    float* orow = out + (size_t)r * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * n + 2 * t4;
      const float o0 = acc[n][2 * h] * mul, o1 = acc[n][2 * h + 1] * mul;
      if (d + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(o0, o1);
      } else {
        if (d < hd) orow[d] = o0;
        if (d + 1 < hd) orow[d + 1] = o1;
      }
    }
  }
}

// acc (16 x HDP) += a (16 x 8·NJ, NJ/2 k-steps of 16 from the f32
// accumulators s, rounded to bf16) · tile rows row0 .. row0 + 8·NJ (x HDP,
// row-major, through ldmatrix.trans)
template <int HDP, int NJ = 8>
__device__ __forceinline__ void acc_times_tile(float (&acc)[HDP / 8][4], const float (&s)[NJ][4],
                                               const __nv_bfloat16* tile, int row0 = 0) {
  constexpr int LDS = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < HDP / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_b_t(b0, b1, b2, b3, tile, LDS, row0 + 16 * kk, 16 * np);
      mma16816(acc[2 * np], a, b0, b1);
      mma16816(acc[2 * np + 1], a, b2, b3);
    }
  }
}

// k-stationary: dk_h, dv_h (BH, S, hd) for the keys of one tile
template <int HDP>
__global__ void __launch_bounds__(NTM)
bwd_kv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int T_, int S, int hd, int rep,
              int causal, int n_k, float scale, int vec) {
  constexpr int LDS = HDP + 8, KS = HDP / 16, NO = HDP / 8;
  // query parts a tile: at hd 128 the dK and dV accumulators take 128 f32
  // registers a lane, and Sᵀ and dPᵀ of all 64 queries 64 more, which
  // spilled; two parts of 32 queries, in a loop the compiler keeps rolled
  // (unrolled, it holds both parts' values at once and spills again), fit
  // in 248 registers.  Each accumulator still sums the same products in the
  // same order, so the bits do not change.
  constexpr int NH = HDP > 96 ? 2 : 1, NJ = 8 / NH;
  extern __shared__ __align__(16) __nv_bfloat16 ksm[];
  __nv_bfloat16* sK = ksm;
  __nv_bfloat16* sV = sK + 64 * LDS;
  __nv_bfloat16* sQ = sV + 64 * LDS;       // 2 buffers of 64 rows
  __nv_bfloat16* sO = sQ + 2 * 64 * LDS;   // 2 buffers of 64 rows
  float* sL = reinterpret_cast<float*>(sO + 2 * 64 * LDS);   // 2 x 64
  float* sD = sL + 2 * 64;                                     // 2 x 64

  const int bh = blockIdx.x / n_k, k0 = (blockIdx.x % n_k) * BK, kvh = bh / rep;
  const __nv_bfloat16* qb = q + (size_t)bh * T_ * hd;
  const __nv_bfloat16* ob = dout + (size_t)bh * T_ * hd;
  const float* lb = lse + (size_t)bh * T_;
  const float* db = delta + (size_t)bh * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;

  const int n_q = (T_ + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;   // earlier query tiles see none of these keys
  load_rows<HDP>(sK, k + (size_t)kvh * S * hd, k0, S, hd, vec);
  load_rows<HDP>(sV, v + (size_t)kvh * S * hd, k0, S, hd, vec);
  if (qt0 < n_q) {
    load_rows<HDP>(sQ, qb, qt0 * BQ, T_, hd, vec);
    load_rows<HDP>(sO, ob, qt0 * BQ, T_, hd, vec);
    load_vec(sL, lb, qt0 * BQ, T_);
    load_vec(sD, db, qt0 * BQ, T_);
  }
  cp_async_commit();

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  const int key_lo = k0 + 16 * warp;   // this warp's 16 keys
#pragma unroll 1
  for (int qt = qt0; qt < n_q; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BQ;
    cp_async_wait<0>();   // tile qt landed
    __syncthreads();      // ... for every thread; buffer buf ^ 1 is free
    if (qt + 1 < n_q) {
      const int nb = buf ^ 1;
      load_rows<HDP>(sQ + nb * 64 * LDS, qb, q0 + BQ, T_, hd, vec);
      load_rows<HDP>(sO + nb * 64 * LDS, ob, q0 + BQ, T_, hd, vec);
      load_vec(sL + nb * 64, lb, q0 + BQ, T_);
      load_vec(sD + nb * 64, db, q0 + BQ, T_);
    }
    cp_async_commit();
    const __nv_bfloat16* tQ = sQ + buf * 64 * LDS;
    const __nv_bfloat16* tO = sO + buf * 64 * LDS;
    const float* tL = sL + buf * 64;
    const float* tD = sD + buf * 64;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x 64 queries per warp, in NH
    // parts of 64 / NH queries (see NH)
    const bool masked = q0 + BQ > T_ || (causal && key_lo + 15 > q0);
#pragma unroll 1
    for (int hq = 0; hq < NH; ++hq) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_a(ka, sK, LDS, 16 * warp, 16 * ks);
        ldsm_a(va, sV, LDS, 16 * warp, 16 * ks);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          const int qr = 8 * NJ * hq + 16 * jp;
          uint32_t b0, b1, b2, b3;
          ldsm_b(b0, b1, b2, b3, tQ, LDS, qr, 16 * ks);
          mma16816(s[2 * jp], ka, b0, b1);
          mma16816(s[2 * jp + 1], ka, b2, b3);
          ldsm_b(b0, b1, b2, b3, tO, LDS, qr, 16 * ks);
          mma16816(dp[2 * jp], va, b0, b1);
          mma16816(dp[2 * jp + 1], va, b2, b3);
        }
      }

      // Pᵀ and dSᵀ (without the scale) in place; zero where the query is
      // past T or (causal) before the key (keys past S are never stored)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = 8 * (NJ * hq + j) + 2 * t4;   // this lane's query column
        const float2 L = *reinterpret_cast<const float2*>(tL + qc);
        const float2 D = *reinterpret_cast<const float2*>(tD + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], scale_log2, -((e & 1) ? L.y : L.x) * LOG2E));
          if (masked) {
            const int key = key_lo + g + 8 * (e >> 1), qpos = q0 + qc + (e & 1);
            if (qpos >= T_ || (causal && key > qpos)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? D.y : D.x));
        }
      }

      // dV += Pᵀ dO, dK += dSᵀ Q over this part's queries
      acc_times_tile<HDP, NJ>(adv, s, tO, 8 * NJ * hq);
      acc_times_tile<HDP, NJ>(adk, dp, tQ, 8 * NJ * hq);
    }
  }
  cp_async_wait<0>();   // nothing in flight at exit (no query tile when qt0 >= n_q)

  const size_t base = (size_t)bh * S * hd;
  store_rows<NO>(dk + base, adk, key_lo, S, hd, scale);
  store_rows<NO>(dv + base, adv, key_lo, S, hd, 1.f);
}

// q-stationary: dq (BH, T, hd) for the queries of one tile
template <int HDP>
__global__ void __launch_bounds__(NTM)
bwd_q_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int T_, int S, int hd, int rep, int causal, int n_q,
             float scale, int vec) {
  constexpr int LDS = HDP + 8, KS = HDP / 16, NO = HDP / 8;
  extern __shared__ __align__(16) __nv_bfloat16 qsm[];
  __nv_bfloat16* sQ = qsm;
  __nv_bfloat16* sO = sQ + 64 * LDS;
  __nv_bfloat16* sK = sO + 64 * LDS;       // 2 buffers of 64 rows
  __nv_bfloat16* sV = sK + 2 * 64 * LDS;   // 2 buffers of 64 rows

  const int bh = blockIdx.x / n_q;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * BQ;   // longest causal rows first
  const int kvh = bh / rep;
  const __nv_bfloat16* kb = k + (size_t)kvh * S * hd;
  const __nv_bfloat16* vb = v + (size_t)kvh * S * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale_log2 = scale * LOG2E;

  int n_k = (S + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, T_) - 1) / BK + 1);   // skip fully masked tiles

  // groups in flight: Q and dO, then K/V tile 0; each iteration commits the next tile
  load_rows<HDP>(sQ, q + (size_t)bh * T_ * hd, q0, T_, hd, vec);
  load_rows<HDP>(sO, dout + (size_t)bh * T_ * hd, q0, T_, hd, vec);
  cp_async_commit();
  load_rows<HDP>(sK, kb, 0, S, hd, vec);
  load_rows<HDP>(sV, vb, 0, S, hd, vec);
  cp_async_commit();

  // this warp's rows g and g + 8: lse in base 2, delta
  const int row_lo = q0 + 16 * warp;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_lo + g + 8 * h;
    l2[h] = r < T_ ? lse[(size_t)bh * T_ + r] * LOG2E : 0.f;
    dl[h] = r < T_ ? delta[(size_t)bh * T_ + r] : 0.f;
  }

  cp_async_wait<1>();   // Q and dO landed
  __syncthreads();
  uint32_t qf[KS][4], of[KS][4];   // this warp's 16 rows of Q and dO, for the whole block
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldsm_a(qf[ks], sQ, LDS, 16 * warp, 16 * ks);
    ldsm_a(of[ks], sO, LDS, 16 * warp, 16 * ks);
  }
  float adq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    cp_async_wait<0>();   // tile kt landed
    __syncthreads();      // ... for every thread; buffer buf ^ 1 is free
    if (kt + 1 < n_k) {
      load_rows<HDP>(sK + (buf ^ 1) * 64 * LDS, kb, k0 + BK, S, hd, vec);
      load_rows<HDP>(sV + (buf ^ 1) * 64 * LDS, vb, k0 + BK, S, hd, vec);
    }
    cp_async_commit();
    const __nv_bfloat16* tK = sK + buf * 64 * LDS;
    const __nv_bfloat16* tV = sV + buf * 64 * LDS;

    // S = Q Kᵀ and dP = dO Vᵀ: 16 queries x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_b(b0, b1, b2, b3, tK, LDS, 16 * jp, 16 * ks);
        mma16816(s[2 * jp], qf[ks], b0, b1);
        mma16816(s[2 * jp + 1], qf[ks], b2, b3);
        ldsm_b(b0, b1, b2, b3, tV, LDS, 16 * jp, 16 * ks);
        mma16816(dp[2 * jp], of[ks], b0, b1);
        mma16816(dp[2 * jp + 1], of[ks], b2, b3);
      }

    // dS (without the scale) in place of S; zero where the key is past S or
    // (causal) after the query (rows past T are never stored)
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > row_lo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -l2[e >> 1]));
        if (masked) {
          const int qpos = row_lo + g + 8 * (e >> 1), kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kpos >= S || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ += dS K
    acc_times_tile<HDP>(adq, s, tK);
  }

  store_rows<NO>(dq + (size_t)bh * T_ * hd, adq, row_lo, T_, hd, scale);
}

// 16-byte cp.async needs hd % 8 == 0 and 16-byte-aligned bases
inline bool vec_ok(const void* q, const void* k, const void* v, const void* dout, int hd) {
  return hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, float* dq, float* dk, float* dv,
                   int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)hd);
  const int n_q = (T_ + BQ - 1) / BQ, n_k = (S + BK - 1) / BK;
  const int vec = (int)vec_ok(q, k, v, dout, hd);
  const size_t skv = smem_kv<HDP>(), sq = smem_q<HDP>();
  cudaError_t err = cudaFuncSetAttribute(bwd_kv_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)skv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_q_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sq);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* qt = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kt = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vt = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* ot = static_cast<const __nv_bfloat16*>(dout);
  bwd_kv_kernel<HDP><<<(unsigned)(BH * n_k), NTM, skv, st>>>(
      qt, kt, vt, ot, lse, delta, dk, dv, T_, S, hd, rep, causal, n_k, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_q_kernel<HDP><<<(unsigned)(BH * n_q), NTM, sq, st>>>(
      qt, kt, vt, ot, lse, delta, dq, T_, S, hd, rep, causal, n_q, scale, vec);
  return cudaGetLastError();
}

}  // namespace mma

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, float* dk, float* dv,
                        int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
#define REPRO_ARGS q, k, v, dout, lse, delta, dq, dk, dv, BH, T_, S, hd, rep, causal, st
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (hd <= 16) return mma::launch<16>(REPRO_ARGS);
    if (hd <= 32) return mma::launch<32>(REPRO_ARGS);
    if (hd <= 64) return mma::launch<64>(REPRO_ARGS);
    if (hd <= 80) return mma::launch<80>(REPRO_ARGS);
    if (hd <= 96) return mma::launch<96>(REPRO_ARGS);
    if (hd <= 128) return mma::launch<128>(REPRO_ARGS);
  } else {
    if (hd <= 16) return launch<T, 16>(REPRO_ARGS);
    if (hd <= 32) return launch<T, 32>(REPRO_ARGS);
    if (hd <= 64) return launch<T, 64>(REPRO_ARGS);
    if (hd <= 80) return launch<T, 80>(REPRO_ARGS);
    if (hd <= 96) return launch<T, 96>(REPRO_ARGS);
    if (hd <= 128) return launch<T, 128>(REPRO_ARGS);
  }
#undef REPRO_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launches' cudaError_t (0 = success).  dtype: 0 float32,
// 1 bfloat16 (q, k, v, do alike).  dq (BH, T, hd), dk and dv (BH, S, hd),
// per query head, are float32.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    float* dq, float* dk, float* dv, int BH, int T_, int S,
                                    int hd, int rep, int causal, int dtype, void* stream) {
  if (BH < 1 || T_ < 1 || S < 1 || hd < 1 || rep < 1 || BH % rep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T_, S, hd, rep,
                                   causal, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T_, S,
                                           hd, rep, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Which path the launches take for these operands: 0 CUDA cores (float32),
// 1 tensor cores fed by 16-byte cp.async, 2 tensor cores fed by element
// loads (hd % 8 != 0 or a base not 16-byte aligned).  -1 for an unknown
// dtype.
extern "C" int repro_flash_attn_bwd_path(const void* q, const void* k, const void* v,
                                         const void* dout, int hd, int dtype) {
  if (dtype == 0) return mma::CUDA_CORES;
  if (dtype == 1) return mma::vec_ok(q, k, v, dout, hd) ? mma::CP_ASYNC : mma::LOADS;
  return -1;
}
