// Tiles shared by the dense backward kernels for Hopper (sm_90a):
// dense_bwd_norm.cu (both launches), pegrad_norm.cu (the norm launch) and
// dense_dgrad.cu (the gx launch) include this header, so the three compute
// bit-identical results from the same inputs.
//
// For row b of x (BG, T, di) and gy (BG, T, do) with grouped weights
// w (E, di, do), row b using w[b % E]:
//   * dgrad_kernel: gx_b = gy_b · w[b % E]ᵀ; one block per (b, 128-row t
//     tile, 128-col i tile) loops over do;
//   * norm_kernel: one block per (b, 128-row i tile, 128-col j tile) loops
//     over T, building its tile of G_b = x_bᵀ gy_b in registers, and writes
//     Σ tile² to part[b, tile] (i tile fastest).  G_b never reaches device
//     memory; the caller sums part over tiles in a fixed order (no atomics).
// Both share one tile product: operands staged through shared memory as f32
// (bf16 converted on load), 8 x 8 register micro-tiles per thread, f32 FMAs
// on the CUDA cores.  Rows, columns and depth past the shapes are
// zero-filled on load and never stored, so any shape runs; an all-zero gy
// row gives an exactly zero gx row and an exactly zero norm².

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;   // tile rows
constexpr int BN = 128;   // tile cols
constexpr int BK = 8;     // depth per shared-memory stage
constexpr int NT = 256;   // threads, a 16 x 16 grid of 8 x 8 micro-tiles
constexpr int LD = BM + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [r0, r0 + 128) x depth [k0, k0 + 8) of an operand whose element
// (r, k) is p[r * sr + k * sk] into S[k][r] as f32, zero outside R x K.
// KC: depth is contiguous (sk == 1), a thread reads 4 neighbouring k of one
// row; otherwise rows are contiguous (sr == 1), 4 neighbouring r of one k.
template <typename T, bool KC>
__device__ __forceinline__ void stage(float (*S)[LD], const T* __restrict__ p, size_t sr,
                                      size_t sk, int r0, int R, int k0, int K) {
  const int tid = threadIdx.x;
  if (KC) {
    const int r = tid >> 1, kk = (tid & 1) * 4, gr = r0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gk = k0 + kk + c;
      S[kk + c][r] = (gr < R && gk < K) ? to_f32(p[(size_t)gr * sr + gk]) : 0.f;
    }
  } else {
    const int kk = tid >> 5, r = (tid & 31) * 4, gk = k0 + kk;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gr = r0 + r + c;
      S[kk][r + c] = (gr < R && gk < K) ? to_f32(p[gr + (size_t)gk * sk]) : 0.f;
    }
  }
}

// acc[i][j] = Σ_k A(m0 + row(i), k) · B(n0 + col(j), k) over k < K, where
// row(i) = 4·ty + i for i < 4 and 64 + 4·ty + i - 4 after, col(j) alike in tx.
template <typename T, bool KC>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const T* __restrict__ A,
                                             size_t sam, size_t sak, int M,
                                             const T* __restrict__ B, size_t sbn, size_t sbk,
                                             int N, int K, int m0, int n0) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // the previous stage's reads are done
    stage<T, KC>(As, A, sam, sak, m0, M, k0, K);
    stage<T, KC>(Bs, B, sbn, sbk, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : 64) + 4 * (threadIdx.x / 16) + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : 64) + 4 * (threadIdx.x % 16) + (j & 3);
}

// gx[b] (T, di) = gy[b] (T, do) · w[b % E]ᵀ; block = (t tile, i tile), b.
template <typename T>
__global__ void __launch_bounds__(NT)
dgrad_kernel(const T* __restrict__ gy, const T* __restrict__ w, T* __restrict__ gx, int T_,
             int di, int dout, int E, int n_m) {
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x % n_m) * BM, n0 = (blockIdx.x / n_m) * BN;
  const T* A = gy + (size_t)b * T_ * dout;                // (t, j) at t·do + j
  const T* W = w + (size_t)(b % E) * di * dout;           // (i, j) at i·do + j
  float acc[8][8];
  tile_product<T, true>(acc, A, (size_t)dout, 1, T_, W, (size_t)dout, 1, di, dout, m0, n0);
  T* out = gx + (size_t)b * T_ * di;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = m0 + tile_row(i);
    if (t >= T_) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(j);
      if (c < di) out[(size_t)t * di + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// part[b, tile] = Σ over one (i tile, j tile) of (x[b]ᵀ gy[b])².
template <typename T>
__global__ void __launch_bounds__(NT)
norm_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ part, int T_,
            int di, int dout, int n_m) {
  __shared__ float warp_sums[NT / 32];
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x % n_m) * BM, n0 = (blockIdx.x / n_m) * BN;
  const T* X = x + (size_t)b * T_ * di;                   // (i, t) at t·di + i
  const T* G = gy + (size_t)b * T_ * dout;                // (j, t) at t·do + j
  float acc[8][8];
  tile_product<T, false>(acc, X, 1, (size_t)di, di, G, 1, (size_t)dout, dout, T_, m0, n0);
  float s = 0.f;   // entries outside di x do are exact zeros
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], acc[i][j], s);
  // fixed-order block sum: xor tree in each warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) tot += warp_sums[wi];
    part[(size_t)b * gridDim.x + blockIdx.x] = tot;
  }
}

template <typename T>
cudaError_t launch_dgrad(const void* gy, const void* w, void* gx, int BG, int T_, int di,
                         int dout, int E, cudaStream_t st) {
  const int n_t = (T_ + BM - 1) / BM;
  dgrad_kernel<T><<<dim3((unsigned)(n_t * ((di + BN - 1) / BN)), (unsigned)BG), NT, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(w), static_cast<T*>(gx), T_, di, dout,
      E, n_t);
  return cudaGetLastError();
}

// part: (BG, ceil(di/128)·ceil(do/128)) float32.
template <typename T>
cudaError_t launch_norm(const void* x, const void* gy, float* part, int BG, int T_, int di,
                        int dout, cudaStream_t st) {
  const int n_i = (di + BM - 1) / BM, n_j = (dout + BN - 1) / BN;
  norm_kernel<T><<<dim3((unsigned)(n_i * n_j), (unsigned)BG), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), part, T_, di, dout, n_i);
  return cudaGetLastError();
}

}  // namespace
