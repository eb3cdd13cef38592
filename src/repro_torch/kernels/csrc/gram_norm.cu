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
// one block owns one (b, t tile, s tile <= t tile), keeps its 64 x 64 tile
// of both Grams in registers, and writes one weighted partial to
// part[b, pair].  The wrapper sums the partials of a row in a fixed order
// (as the JAX shim sums groups outside pallas_call): no atomics, so two
// launches give bit-identical norms.  Rows past T are excluded; an
// all-zero gy row contributes an exact zero.
//
// bf16 (mma::gram_kernel, the tensor cores): a Gram tile is a K-major x
// K-major product, both operands row tiles of a row-major (T, D) matrix,
// which is mma.sync.m16n8k16's row.col layout: plain ldmatrix, no
// transpose.  Four warps as 2 x 2, each a 32 x 32 quarter of the tile;
// depth arrives in 64-wide chunks through a 3-stage cp.async ring (row
// stride 72 elements, so the 8 rows of an ldmatrix hit 8 bank groups; on a
// diagonal tile the s rows are the t rows and are loaded once).  Each
// chunk's product is summed on the tensor cores and added to the running
// sum in f32 on the CUDA cores (gram_mma says why).
// C over gy is summed in registers (32 f32 a lane), and when square waits
// in shared memory while A over x takes the same registers; the epilogue
// multiplies them, applies the id mask from ids staged in shared memory
// and reduces in a fixed order.  bf16 x bf16 products are exact in
// f32, so the plain version's rtol 1e-4 holds at every depth.  Where a row of
// D bf16 is not a multiple of 16 bytes or a base is not 16-byte aligned,
// element loads with zero fill take the place of cp.async (gram_path says
// which).
//
// float32 (gram_kernel outside namespace mma, the CUDA cores): 64 x 32
// f32 depth chunks staged through shared memory, 4 x 4 register
// micro-tiles of both Grams.
//
// Bound.  On the training path (the embedding rule: gy (8, 512, 3072) bf16,
// square == 0, masked) the work is BG·T²·do ≈ 6.4 GFLOP with symmetry on
// 25 MB of input, about 0.01 ms at either roof.  Under the auto rules at
// B 2 x T 2048 the square rule's products (2, 2048, 3072 -> 8192 and the
// head's 32256) are bound by operations.  Each block reads its two row
// tiles over the whole depth, so most of the traffic is served by L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_tiles.cuh"

namespace {

constexpr int BT = 64;    // rows per tile
constexpr int DC = 32;    // depth per shared-memory stage
constexpr int NT = 256;   // threads per block, as a 16 x 16 grid
constexpr int RS = DC + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }

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

// pair = t (t + 1) / 2 + s with s <= t
__device__ __forceinline__ void decode_pair(int pair, int& t, int& s) {
  t = (int)((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > pair) --t;
  while ((t + 1) * (t + 2) / 2 <= pair) ++t;
  s = pair - t * (t + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, const T* __restrict__ gy, const int* __restrict__ ids,
            float* __restrict__ part, int T_, int di, int dout, int use_mask, int square) {
  __shared__ float sA[BT * RS];
  __shared__ float sB[BT * RS];
  __shared__ float warp_sums[NT / 32];
  const int b = blockIdx.y, pair = blockIdx.x;
  int t, s;
  decode_pair(pair, t, s);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync.m16n8k16, depth through a cp.async ring.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int NTM = 128;      // four warps as 2 x 2, 32 x 32 of the tile each
constexpr int DCH = 64;       // depth per stage
constexpr int LDS = DCH + 8;  // row stride of a staged tile (elements)
constexpr int STAGES = 3;
// the ring, then (square only) the C tile, 64 x 64 f32, while A is computed
constexpr size_t SMEM_RING = sizeof(__nv_bfloat16) * STAGES * 2 * BT * LDS;
constexpr size_t SMEM_STASH = sizeof(float) * BT * BT;

// acc = rows [t0, t0 + 64) times rows [s0, s0 + 64) of the row-major
// (T, D) matrix m, over its whole depth; this warp's 32 x 32 quarter.
// mma.sync's f32 accumulation does not round to nearest: summed on the
// tensor cores alone over a long depth of positive terms (a row's own
// norm² on the diagonal), the norm² came out low by 1.4e-4 of the plain
// version's at the head's depth of 32256 (2016 k-steps, about 2^-24 a
// step).  So each 64-deep chunk is summed on the tensor cores from zero
// (four k-steps) and added to acc with a rounded f32 add.
__device__ __forceinline__ void gram_mma(float (&acc)[2][4][4], const __nv_bfloat16* __restrict__ m,
                                         int T_, int D, int t0, int s0, bool vec,
                                         __nv_bfloat16* ring) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const bool diag = t0 == s0;   // the s rows are the t rows: stage them once
  const int n_c = (D + DCH - 1) / DCH;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  auto stage = [&](int c) {
    __nv_bfloat16* st = ring + (c % STAGES) * 2 * BT * LDS;
    load_tile<BT, DCH, NTM>(st, LDS, m, t0, T_, c * DCH, D, vec);
    if (!diag) load_tile<BT, DCH, NTM>(st + BT * LDS, LDS, m, s0, T_, c * DCH, D, vec);
  };
  stage(0);
  cp_async_commit();
  if (n_c > 1) stage(1);
  cp_async_commit();
  for (int c = 0; c < n_c; ++c) {
    cp_async_wait<1>();   // chunk c landed
    __syncthreads();      // ... for every thread; chunk c - 1's stage is free
    if (c + 2 < n_c) stage(c + 2);
    cp_async_commit();
    const __nv_bfloat16* A = ring + (c % STAGES) * 2 * BT * LDS;
    const __nv_bfloat16* B = diag ? A : A + BT * LDS;
    float csum[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) csum[mi][ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DCH / 16; ++kk) {
      uint32_t af[2][4];
      ldsm_a(af[0], A, LDS, 32 * wm, 16 * kk);
      ldsm_a(af[1], A, LDS, 32 * wm + 16, 16 * kk);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_b(b0, b1, b2, b3, B, LDS, 32 * wn + 16 * jp, 16 * kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(csum[mi][2 * jp], af[mi], b0, b1);
          mma16816(csum[mi][2 * jp + 1], af[mi], b2, b3);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += csum[mi][ni][e];
  }
  __syncthreads();   // every warp is done with the ring before it is reused
}

__global__ void __launch_bounds__(NTM)
gram_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
            const int* __restrict__ ids, float* __restrict__ part, int T_, int di, int dout,
            int use_mask, int square, int vec_x, int vec_gy) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __shared__ int sid[2][BT];
  __shared__ float warp_sums[NTM / 32];
  const int b = blockIdx.y, pair = blockIdx.x;
  int t, s;
  decode_pair(pair, t, s);
  const int t0 = t * BT, s0 = s * BT;
  if (use_mask && threadIdx.x < BT) {   // read after gram_mma's barriers
    const int* idb = ids + (size_t)b * T_;
    const int r = t0 + threadIdx.x, q = s0 + threadIdx.x;
    sid[0][threadIdx.x] = r < T_ ? idb[r] : 0;
    sid[1][threadIdx.x] = q < T_ ? idb[q] : 0;
  }

  // C over gy; when square, C waits in shared memory (each thread's own
  // slots) while A over x takes its registers
  float acc[2][4][4];
  float* stash = reinterpret_cast<float*>(ring + SMEM_RING / sizeof(__nv_bfloat16));
  gram_mma(acc, gy + (size_t)b * T_ * dout, T_, dout, t0, s0, vec_gy, ring);
  if (square) {
#pragma unroll
    for (int i = 0; i < 32; ++i) stash[i * NTM + threadIdx.x] = acc[i / 16][(i / 4) % 4][i % 4];
    gram_mma(acc, x + (size_t)b * T_ * di, T_, di, t0, s0, vec_x, ring);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t4 = lane % 4;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int mi = i / 16, ni = (i / 4) % 4, e = i % 4;
    const int r = 32 * wm + 16 * mi + g + 8 * (e >> 1), q = 32 * wn + 8 * ni + 2 * t4 + (e & 1);
    bool keep = t0 + r < T_ && s0 + q < T_;
    if (keep && use_mask) keep = sid[0][r] == sid[1][q];
    if (keep) sum += square ? acc[mi][ni][e] * stash[i * NTM + threadIdx.x] : acc[mi][ni][e];
  }
  // fixed-order block sum: xor tree in each warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NTM / 32; ++w) tot += warp_sums[w];
    part[(size_t)b * gridDim.x + pair] = (s == t ? 1.f : 2.f) * tot;
  }
}

// 16-byte cp.async needs rows of a multiple of 8 bf16 and 16-byte-aligned bases
inline bool vec_ok(const void* m, int D) { return D % 8 == 0 && aligned16(m); }

cudaError_t launch(const void* x, const void* gy, const int* ids, float* part, int BG, int T_,
                   int di, int dout, int use_mask, int square, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a launch is refused unless allowed
  cudaError_t err = cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(SMEM_RING + SMEM_STASH));
  if (err != cudaSuccess) return err;
  const int n_t = (T_ + BT - 1) / BT;
  const size_t smem = SMEM_RING + (square ? SMEM_STASH : 0);
  gram_kernel<<<dim3((unsigned)(n_t * (n_t + 1) / 2), (unsigned)BG), NTM, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gy), ids, part, T_,
      di, dout, use_mask, square, (int)vec_ok(x, di), (int)vec_ok(gy, dout));
  return cudaGetLastError();
}

}  // namespace mma

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
    return (int)mma::launch(x, gy, ids, part, BG, T_, di, dout, use_mask, square, st);
  return (int)cudaErrorInvalidValue;
}

// Which path the launch takes for these operands: 0 CUDA cores (float32),
// 1 tensor cores fed by 16-byte cp.async, 2 tensor cores fed by element
// loads (a row of gy, or of x when square, not a multiple of 8 elements, or
// a base not 16-byte aligned).  -1 for an unknown dtype.
extern "C" int repro_gram_norm_path(const void* x, const void* gy, int di, int dout, int square,
                                    int dtype) {
  if (dtype == 0) return mma::CUDA_CORES;
  if (dtype == 1)
    return mma::vec_ok(gy, dout) && (!square || mma::vec_ok(x, di)) ? mma::CP_ASYNC : mma::LOADS;
  return -1;
}
