// Ghost-norm (Gram) reduction for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/gram_norm.py `gram_norm`
// (`_kernel`, pallas_call at :99).  Same function: for row b of
// x (BG, T, di) and gy (BG, T, do),
//     out_b = Σ_{t,s} [ids_t == ids_s] · (x_t·x_s) · (gy_t·gy_s)
// where the x Gram is dropped when square == 0 (the embedding rule,
// Σ gy_t·gy_s) and the id mask is dropped when use_mask == 0.  The (T, T)
// Gram matrices never reach device memory: one (64 x 64) tile of each lives
// in registers, is multiplied elementwise, masked and reduced on the spot.
// As on the TPU the sum uses symmetry: only tiles with s <= t run, and the
// tiles off the diagonal count twice.
//
// Design.  The TPU grid accumulates every tile into out[b] in order.  Here
// one block owns one (b, t tile, s tile <= t tile): it stages the two row
// tiles of gy (then of x) through shared memory in 32-wide depth chunks,
// keeps its 4 x 4 micro-tiles of both Grams in registers, and writes one
// weighted partial to part[b, pair].  The wrapper sums the partials of a row
// in a fixed order (as the JAX shim sums groups outside pallas_call): no
// atomics, so two launches give bit-identical norms.  Rows past T are
// excluded; an all-zero gy row contributes an exact zero.
//
// Bound.  On the training path (the embedding rule: gy (8, 512, 3072) bf16,
// square == 0, masked) the work is BG·T²·do ≈ 6.4 GFLOP with symmetry on
// 25 MB of input, about 0.01 ms at either roof; CUDA-core FMAs keep this
// kernel far above it.  Tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BT = 64;    // rows per tile
constexpr int DC = 32;    // depth per shared-memory stage
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr int RS = DC + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows [r0, r0 + 64) x depth [d0, d0 + 32) of a row-major (T, D) matrix ->
// f32 tile with row stride 33, zero outside
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int T_,
                                      int d0, int D) {
  const int r = threadIdx.x / 4, dd = (threadIdx.x % 4) * 8, gr = r0 + r;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int gd = d0 + dd + c;
    dst[r * RS + dd + c] = (gr < T_ && gd < D) ? to_f32(src[(size_t)gr * D + gd]) : 0.f;
  }
}

// g[i][j] = Σ_d M(t0 + ty + 16i, d) · M(s0 + tx + 16j, d) over d < D
template <typename T>
__device__ __forceinline__ void gram_tile(float (&g)[4][4], const T* __restrict__ m, int T_,
                                          int D, int t0, int s0, float* sA, float* sB) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();   // the previous chunk's reads are done
    stage<T>(sA, m, t0, T_, d0, D);
    stage<T>(sB, m, s0, T_, d0, D);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < DC; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(ty + 16 * i) * RS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, const T* __restrict__ gy, const int* __restrict__ ids,
            float* __restrict__ part, int T_, int di, int dout, int use_mask, int square) {
  __shared__ float sA[BT * RS];
  __shared__ float sB[BT * RS];
  __shared__ float warp_sums[NT / 32];
  const int b = blockIdx.y, pair = blockIdx.x;
  // pair = t (t + 1) / 2 + s with s <= t
  int t = (int)((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > pair) --t;
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  const int s = pair - t * (t + 1) / 2;
  const int t0 = t * BT, s0 = s * BT;

  float c[4][4], a[4][4];
  gram_tile<T>(c, gy + (size_t)b * T_ * dout, T_, dout, t0, s0, sA, sB);
  if (square) gram_tile<T>(a, x + (size_t)b * T_ * di, T_, di, t0, s0, sA, sB);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int* idb = ids + (size_t)b * T_;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = s0 + tx + 16 * j;
      bool keep = r < T_ && q < T_;
      if (keep && use_mask) keep = idb[r] == idb[q];
      if (keep) sum += square ? a[i][j] * c[i][j] : c[i][j];
    }
  }
  // fixed-order block sum: xor tree in each warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) tot += warp_sums[w];
    part[(size_t)b * gridDim.x + pair] = (s == t ? 1.f : 2.f) * tot;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gy, const int* ids, float* part, int BG, int T_,
                   int di, int dout, int use_mask, int square, cudaStream_t st) {
  const int n_t = (T_ + BT - 1) / BT;
  gram_kernel<T><<<dim3((unsigned)(n_t * (n_t + 1) / 2), (unsigned)BG), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), ids, part, T_, di, dout, use_mask,
      square);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = success).  dtype: 0 float32,
// 1 bfloat16 (x and gy alike).  ids: (BG, T) int32, read only when use_mask.
// part: (BG, n_t (n_t + 1) / 2) float32 with n_t = ceil(T / 64), one weighted
// partial per tile pair.
extern "C" int repro_gram_norm(const void* x, const void* gy, const int* ids, float* part,
                               int BG, int T_, int di, int dout, int use_mask, int square,
                               int dtype, void* stream) {
  if (BG < 1 || BG > 65535 || T_ < 1 || di < 1 || dout < 1 || (use_mask && !ids))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, gy, ids, part, BG, T_, di, dout, use_mask, square, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gy, ids, part, BG, T_, di, dout, use_mask, square,
                                      st);
  return (int)cudaErrorInvalidValue;
}
