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
// key tiles itself; nothing carries over between blocks.
//
// bf16 (mma::flash_fwd_kernel, FlashAttention-2 style): four warps of 16
// query rows each.  Q stays in registers as mma.sync A fragments for the
// whole block; 64-key K/V tiles arrive through a double-buffered cp.async
// ring (16-byte loads; element loads with zero fill where hd·2 bytes is
// not 16-byte aligned or a base is not, fwd_path says which); S = QKᵀ is
// mma.sync.m16n8k16 (bf16 in, f32 out) from ldmatrix fragments of K; the
// online softmax runs in registers with quad shuffles, in base 2 (exp2 of
// logits pre-scaled by log2 e, converted back for lse); p is rounded to
// bf16 in registers and fed as the A operand of P·V, V read with
// ldmatrix.trans, while l sums the unrounded p, as the TPU kernel does.
// The score tile never reaches shared memory.  hd is padded to HDP (a
// multiple of 16) with zero lanes that are never stored.
//
// f32 (flash_fwd_kernel, the CUDA cores): the Q tile is staged once in
// shared memory, each K/V tile in turn; the 64x64 score tile goes through
// shared memory for the row softmax; all arithmetic f32, as the plain
// version's tolerances (rtol 2e-4 / atol 2e-5) ask.
//
// Bound.  At the phi3 prefill shape (hd 96, T = S = 1024, bf16) the work is
// about 256 FLOP per byte of q/k/v/o, close to the card's balance point, so
// the bound is the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s (the
// tensor-core rate).  mma.sync reaches a part of that rate; wgmma with TMA
// and warp specialisation (FlashAttention-3) is later work.  Queries past T
// and keys past S are padded with zeros and masked, so any T, S >= 1 runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, K/V through a cp.async ring.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int NTM = 128;            // four warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory: Q (64 rows), K and V (2 buffers x 64 rows each), row
// stride HDP + 8 elements so the 8 rows of an ldmatrix hit 8 bank groups
template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (HDP + 8);
}

template <int HDP>
__global__ void __launch_bounds__(NTM)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T_, int S, int hd, int rep, int causal, int n_q,
                 float scale_log2, int vec) {
  constexpr int LDS = HDP + 8, KS = HDP / 16, NO = HDP / 8;
  extern __shared__ __align__(16) __nv_bfloat16 fsm[];
  __nv_bfloat16* sQ = fsm;
  __nv_bfloat16* sK = sQ + BQ * LDS;        // 2 buffers of BK rows
  __nv_bfloat16* sV = sK + 2 * BK * LDS;    // 2 buffers of BK rows

  const int bh = blockIdx.x / n_q;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * BQ;   // longest causal rows first
  const int kvh = bh / rep;
  const __nv_bfloat16* qb = q + (size_t)bh * T_ * hd;
  const __nv_bfloat16* kb = k + (size_t)kvh * S * hd;
  const __nv_bfloat16* vb = v + (size_t)kvh * S * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;          // fragment row group, column pair
  const int lr = lane % 8, lm = lane / 8;         // ldmatrix row, matrix

  int n_k = (S + BK - 1) / BK;
  if (causal) n_k = min(n_k, (q0 + BQ - 1) / BK + 1);   // skip fully masked tiles

  // groups in flight: Q, then K/V tile 0; each iteration commits the next tile
  load_rows<HDP>(sQ, qb, q0, T_, hd, vec);
  cp_async_commit();
  load_rows<HDP>(sK, kb, 0, S, hd, vec);
  load_rows<HDP>(sV, vb, 0, S, hd, vec);
  cp_async_commit();
  cp_async_wait<1>();   // Q landed
  __syncthreads();
  uint32_t qf[KS][4];   // this warp's 16 rows of Q as A fragments, for the whole block
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(smem_u32(sQ + (16 * warp + lr + 8 * (lm & 1)) * LDS + 16 * ks + 8 * (lm >> 1)),
            qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // rows g and g + 8, base-2 units

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_k) {   // the other buffer was released by the last iteration's sync
      load_rows<HDP>(sK + (buf ^ 1) * BK * LDS, kb, k0 + BK, S, hd, vec);
      load_rows<HDP>(sV + (buf ^ 1) * BK * LDS, vb, k0 + BK, S, hd, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile kt landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * BK * LDS;
    const __nv_bfloat16* tV = sV + buf * BK * LDS;

    // S = Q Kᵀ: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(tK + (16 * jp + lr + 8 * (lm >> 1)) * LDS + 16 * ks + 8 * (lm & 1)),
                b0, b1, b2, b3);
        mma16816(s[2 * jp], qf[ks], b0, b1);
        mma16816(s[2 * jp + 1], qf[ks], b2, b3);
      }

    // scale to base 2 and mask: keys past S, and keys after the query when causal
    const int qmin = q0 + 16 * warp;
    const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > qmin);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int qpos = qmin + g + 8 * (e >> 1), kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kpos >= S || (causal && kpos > qpos)) x = NEG;
        }
        s[j][e] = x;
      }

    // online softmax in registers: a row's 64 scores sit in the 4 lanes of a quad
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += p;
        s[j][e] = p;
      }
    // l is this lane's share of the row sum (summed over the quad at drain)
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P V: P's accumulator fragments, rounded to bf16, are its A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(tV + (16 * kk + lr + 8 * (lm & 1)) * LDS + 16 * np + 8 * (lm >> 1)),
                  b0, b1, b2, b3);
        mma16816(acc[2 * np], a, b0, b1);
        mma16816(acc[2 * np + 1], a, b2, b3);
      }
    }
    __syncthreads();   // every warp is done with buffer buf before it is refilled
  }

  // drain: rows g and g + 8 of this warp, column pairs 8n + 2·t4
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lf = fmaxf(lt, 1e-30f);
    const int qpos = q0 + 16 * warp + g + 8 * h;
    if (qpos >= T_) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * T_ + qpos) * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * n + 2 * t4;
      const float o0 = acc[n][2 * h] / lf, o1 = acc[n][2 * h + 1] / lf;
      if (d + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(o0, o1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16(o0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(o1);
      }
    }
    if (t4 == 0) lse[(size_t)bh * T_ + qpos] = m[h] * LN2 + logf(lf);
  }
}

// 16-byte cp.async needs hd % 8 == 0 and 16-byte-aligned bases
inline bool vec_ok(const void* q, const void* k, const void* v, int hd) {
  return hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int T_, int S, int hd, int rep, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (T_ + BQ - 1) / BQ;
  const float scale_log2 = LOG2E / sqrtf((float)hd);
  flash_fwd_kernel<HDP><<<(unsigned)(BH * n_q), NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, T_, S, hd, rep,
      causal, n_q, scale_log2, (int)vec_ok(q, k, v, hd));
  return cudaGetLastError();
}

}  // namespace mma

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int T_, int S, int hd, int rep, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (hd <= 16) return mma::launch<16>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 32) return mma::launch<32>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 64) return mma::launch<64>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 80) return mma::launch<80>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 96) return mma::launch<96>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 128) return mma::launch<128>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  } else {
    if (hd <= 16) return launch<T, 16>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 32) return launch<T, 32>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 64) return launch<T, 64>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 80) return launch<T, 80>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 96) return launch<T, 96>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
    if (hd <= 128) return launch<T, 128>(q, k, v, o, lse, BH, T_, S, hd, rep, causal, st);
  }
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

// Which path the launch takes for these operands: 0 CUDA cores (float32),
// 1 tensor cores fed by 16-byte cp.async, 2 tensor cores fed by element
// loads (hd % 8 != 0 or a base not 16-byte aligned).  -1 for an unknown
// dtype.
extern "C" int repro_flash_attn_fwd_path(const void* q, const void* k, const void* v, int hd,
                                         int dtype) {
  if (dtype == 0) return mma::CUDA_CORES;
  if (dtype == 1) return mma::vec_ok(q, k, v, hd) ? mma::CP_ASYNC : mma::LOADS;
  return -1;
}
