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
// atomics and are deterministic:
//   * k-stationary: one block per (bh, 64-key tile) stages K and V once,
//     loops over the query tiles and keeps dk, dv in registers;
//   * q-stationary: one block per (bh, 64-query tile) stages Q and dO once,
//     loops over the key tiles and keeps dq in registers.
// Each recomputes its p and ds tiles in registers and passes them through
// shared memory for the second product; T x S is never materialised.  hd is
// padded to a template width (16, 32, 64, 80, 96, 128) with zero lanes.
//
// Bound.  At the training path's shape (BH = 256, T = S = 512, hd 96, bf16,
// causal) the work is about 10·BH·T·S·hd/2 = 32 GFLOP on about 0.28 GB of
// inputs and f32 outputs: bound by bytes, about 0.08 ms at 3.35 TB/s.  This
// first version computes on CUDA cores with 4 x 4 and 4 x (hd/16) register
// micro-tiles and recomputes the scores in both launches, so it is one to
// two orders of magnitude above that; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr int PS = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, float* dq, float* dk, float* dv,
                        int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
#define REPRO_BWD(W) \
  return launch<T, W>(q, k, v, dout, lse, delta, dq, dk, dv, BH, T_, S, hd, rep, causal, st)
  if (hd <= 16) REPRO_BWD(16);
  if (hd <= 32) REPRO_BWD(32);
  if (hd <= 64) REPRO_BWD(64);
  if (hd <= 80) REPRO_BWD(80);
  if (hd <= 96) REPRO_BWD(96);
  if (hd <= 128) REPRO_BWD(128);
#undef REPRO_BWD
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
