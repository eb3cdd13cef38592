// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py `flash_attn_fwd`
// (`_kernel`, pallas_call at :96).  Same function: online-softmax attention
// of q (BH, T, hd) against k/v (BH/rep, S, hd), query row b reading kv row
// b / rep (GQA by index, never materialized); scale 1/sqrt(hd) with the true
// hd; masked logits -1e30 (kpos >= S, and kpos > qpos when causal, aligned at
// position 0); key tiles the causal mask covers completely are skipped; at
// drain l is floored at 1e-30, o = acc / l in q's type, lse = m + log(l) f32.
//
// Design.  The TPU grid walks (bh, q tile, k tile) in order and carries
// (m, l, acc) across the k axis in VMEM scratch.  Hopper blocks run in no
// order, so one block owns one (bh, 64-row query tile) and loops over the
// key tiles itself; nothing carries over between blocks.  The Q tile is
// staged once in shared memory, each K/V tile in turn; the 64x64 score tile
// goes through shared memory for the row softmax.  All arithmetic is f32
// (inputs f32 or bf16, converted on load with the intrinsics); as in the
// TPU kernel, p is rounded to v's type before P·V while l sums the
// unrounded p.  hd is padded to a template width HDP (16, 32, 64, 80, 96,
// 128) with the pad lanes zero on load and never stored.
//
// Bound.  At the phi3 prefill shape (hd 96, T = S = 1024, bf16) the work is
// about 256 FLOP per byte of q/k/v/o, close to the card's balance point, so
// the bound is the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s (the
// tensor-core rate).  This first version uses CUDA-core FMAs on
// register-blocked 4x4 (scores) and 4x(HDP/16) (output) micro-tiles, so it
// is far from that bound; tensor cores (mma.sync, then wgmma with TMA) are
// later work.  Queries past T and keys past S are padded with zeros and
// masked, so any T, S >= 1 runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HDP>
constexpr size_t smem_bytes() {
  // sQ, sK (stride HDP+1), sV (stride HDP), sP (stride BK+1), m, l, corr
  return sizeof(float) * ((size_t)BQ * (HDP + 1) + (size_t)BK * (HDP + 1) +
                          (size_t)BK * HDP + (size_t)BQ * (BK + 1) + 3 * BQ);
}

// rows [row0, row0 + nrows) of a row-major (rows, hd) matrix -> f32 tile with
// row stride `stride`; rows past `rows` and lanes past hd are zero
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* __restrict__ src,
                                          int row0, int nrows, int rows, int hd) {
  for (int i = threadIdx.x; i < nrows * HDP; i += NT) {
    const int r = i / HDP, d = i - r * HDP, gr = row0 + r;
    dst[r * stride + d] = (gr < rows && d < hd) ? to_f32(src[(size_t)gr * hd + d]) : 0.f;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_, int S, int hd, int rep,
                 int causal, int n_q, float scale) {
  constexpr int QS = HDP + 1, PS = BK + 1, NJ = HDP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * HDP;
  float* sM = sP + BQ * PS;
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int bh = blockIdx.x / n_q;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * BQ;   // longest causal rows first
  const int kvh = bh / rep;
  const T* qb = q + (size_t)bh * T_ * hd;
  const T* kb = k + (size_t)kvh * S * hd;
  const T* vb = v + (size_t)kvh * S * hd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HDP>(sQ, QS, qb, q0, BQ, T_, hd);
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = NEG;
    sL[threadIdx.x] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int n_k = (S + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);   // skip fully masked tiles

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's reads of sK, sV, sP are done
    load_tile<T, HDP>(sK, QS, kb, k0, BK, S, hd);
    load_tile<T, HDP>(sV, HDP, vb, k0, BK, S, hd);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + ty + 16 * i, kpos = k0 + tx + 16 * j;
        const bool keep = kpos < S && (!causal || kpos <= qpos);
        sP[(ty + 16 * i) * PS + tx + 16 * j] = keep ? s[i][j] * scale : NEG;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      float* row = sP + r * PS + part * 16;
      const float m_prev = sM[r];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = to_f32(from_f32<T>(p));   // p in v's type for P·V
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();   // every lane of the row has read sM[r]
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty + 16i, lanes tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * HDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  // drain (sM, sL were last written before the final __syncthreads)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= T_) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((size_t)bh * T_ + qpos) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] / l);
    }
    if (tx == 0) lse[(size_t)bh * T_ + qpos] = sM[r] + logf(l);
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int T_, int S, int hd, int rep, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  // above 48 KB of dynamic shared memory a launch is refused unless allowed
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (T_ + BQ - 1) / BQ;
  const float scale = 1.0f / sqrtf((float)hd);
  flash_fwd_kernel<T, HDP><<<(unsigned)(BH * n_q), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, T_, S, hd, rep, causal, n_q, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
  if (hd <= 16) return launch<T, 16>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (hd <= 32) return launch<T, 32>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (hd <= 80) return launch<T, 80>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (hd <= 96) return launch<T, 96>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (hd <= 128) return launch<T, 128>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 = success).  dtype: 0 float32, 1 bfloat16.
extern "C" int repro_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int BH, int T_, int S, int hd, int rep,
                                    int causal, int dtype, void* stream) {
  if (BH < 1 || T_ < 1 || S < 1 || hd < 1 || rep < 1 || BH % rep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  return (int)cudaErrorInvalidValue;
}
