// Tiles shared by the dense backward kernels for Hopper (sm_90a):
// dense_bwd_norm.cu (both launches), pegrad_norm.cu (the norm launch) and
// dense_dgrad.cu (the gx launch) include this header, so the three compute
// bit-identical results from the same inputs.
//
// For row b of x (BG, T, di) and gy (BG, T, do) with grouped weights
// w (E, di, do), row b using w[b % E]:
//   * the gx launch: gx_b = gy_b · w[b % E]ᵀ, one block per (b, t tile,
//     i tile), looping over do with the sum in registers;
//   * norm_kernel: one block per (b, 128-row i tile, 128-col j tile) loops
//     over T, building its tile of G_b = x_bᵀ gy_b in registers, and writes
//     Σ tile² to part[b, tile] (i tile fastest).  G_b never reaches device
//     memory; the caller sums part over tiles in a fixed order (no atomics).
//
// The gx launch in bf16 runs on the tensor cores (tc::dgrad_kernel below):
// both operands of gx_b = gy_b · w_eᵀ are K-major (do contiguous), the
// layout wgmma reads from shared memory without a transpose.  A 128 x 256
// output tile per block; a ring of 4 shared-memory stages of 64-deep bf16
// tiles in the 128-byte swizzle, filled by TMA from one producer thread
// (3-D tensor maps (do, T, BG) and (do, di, E): the ragged edges of T and
// di zero-fill inside row b and expert e) with mbarrier completion; two
// consumer warpgroups, 64 rows each, issue wgmma.m64n128k16 with f32
// accumulators in registers, and round once to bf16 on the way out.  Where
// do % 8 != 0 (or a pointer is not 16-byte aligned) TMA cannot address the
// rows, and the producer warpgroup fills the same swizzled stages with
// element loads instead (dgrad_path says which).  No split of do and no
// atomics: each output sums its depth in one fixed order, so repeats are
// bit-identical and an all-zero gy row gives an exactly zero gx row.
//
// The f32 gx launch and the norm launch share the CUDA-core tile product:
// operands staged through shared memory as f32 (bf16 converted on load),
// 8 x 8 register micro-tiles per thread, f32 FMAs.  Rows, columns and
// depth past the shapes are zero-filled on load and never stored, so any
// shape runs; an all-zero gy row gives an exactly zero norm².  The norm
// launch on tensor cores is later work.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

// gx[b] (T, di) = gy[b] (T, do) · w[b % E]ᵀ on the CUDA cores (the f32 path);
// block = (t tile, i tile), b.
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


// ---------------------------------------------------------------------------
// The bf16 gx launch on the tensor cores: TMA -> 4-stage ring -> wgmma.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;                  // output rows (t) per block, 64 per consumer
constexpr int BN = 256;                  // output cols (i) per block, two n128 halves
constexpr int BK = 64;                   // depth per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int NT = 384;                  // warpgroup 0 loads, warpgroups 1-2 compute
constexpr int A_BYTES = BM * BK * 2;     // 16 KB
constexpr int B_BYTES = BN * BK * 2;     // 32 KB
constexpr size_t SMEM = 1024 + (size_t)STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;

enum Path { CUDA_CORES = 0, TMA = 1, LOADS = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that lasts
// beyond ~2^34 clocks (seconds) is a broken pipeline: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), tile 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 128, f32, this warpgroup's fragment) += A (64 x 16) · B (128 x 16)ᵀ
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of element (r, k) of a (rows, 64) bf16 tile in the 128-byte
// swizzle TMA writes: 16-byte chunk k/8 of row r goes to chunk (k/8) ^ (r%8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int k) {
  return (uint32_t)(r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2);
}

// rows [r0, r0 + R) x depth [k0, k0 + 64) of a (rows, K) bf16 matrix into
// a swizzled stage, element loads by the 128 producer threads, zero outside
__device__ __forceinline__ void load_stage(uint8_t* dst, const __nv_bfloat16* __restrict__ p,
                                           int R, int r0, int rows, int k0, int K) {
  const int tid = threadIdx.x;   // producer warpgroup: 0..127
  for (int idx = tid; idx < R * BK; idx += 128) {
    const int r = idx / BK, k = idx % BK, gr = r0 + r, gk = k0 + k;
    const __nv_bfloat16 v =
        (gr < rows && gk < K) ? p[(size_t)gr * K + gk] : __float2bfloat16(0.f);
    *reinterpret_cast<__nv_bfloat16*>(dst + sw128_offset(r, k)) = v;
  }
}

// gx[b] (T, di) = gy[b] (T, do) · w[b % E]ᵀ; block = (t tile, i tile), b.
__global__ void __launch_bounds__(NT, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap map_gy, const __grid_constant__ CUtensorMap map_w,
             const __nv_bfloat16* __restrict__ gy, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ gx, int T_, int di, int dout, int E, int n_m,
             int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sA = smem;                               // STAGES x (BM, 64)
  uint8_t* sB = smem + STAGES * A_BYTES;            // STAGES x (BN, 64)
  const uint32_t full = smem_u32(sB + STAGES * B_BYTES);   // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;                 // STAGES mbarriers

  const int b = blockIdx.y, e = b % E;
  const int m0 = (blockIdx.x % n_m) * BM, n0 = (blockIdx.x / n_m) * BN;
  const int n_k = (dout + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, use_tma ? 1 : 128);   // one expect_tx, or every loader
      mbar_init(empty + 8 * s, 2);                  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: stage s takes depth tile kt once the consumers released kt - STAGES
    if (use_tma) {
      if (threadIdx.x == 0) {
        for (int kt = 0; kt < n_k; ++kt) {
          const int s = kt % STAGES;
          if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
          mbar_expect_tx(full + 8 * s, A_BYTES + B_BYTES);
          tma_load_3d(smem_u32(sA + s * A_BYTES), &map_gy, full + 8 * s, kt * BK, m0, b);
          tma_load_3d(smem_u32(sB + s * B_BYTES), &map_w, full + 8 * s, kt * BK, n0, e);
        }
      }
    } else {
      const __nv_bfloat16* A = gy + (size_t)b * T_ * dout;
      const __nv_bfloat16* W = w + (size_t)e * di * dout;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
        load_stage(sA + s * A_BYTES, A, BM, m0, T_, kt * BK, dout);
        load_stage(sB + s * B_BYTES, W, BN, n0, di, kt * BK, dout);
        // the generic-proxy stores must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup 1 owns rows m0 + [0, 64), warpgroup 2 [64, 128)
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    const uint32_t a_rows = (uint32_t)(wg - 1) * 64 * 128;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint32_t a = smem_u32(sA + s * A_BYTES) + a_rows;
      const uint32_t bb = smem_u32(sB + s * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t da = sw128_desc(a + 32 * k);
        wgmma_128(acc[0], da, sw128_desc(bb + 32 * k));
        wgmma_128(acc[1], da, sw128_desc(bb + 128 * 128 + 32 * k));
      }
      wgmma_commit_and_wait();
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
    }
    // epilogue: thread holds rows r, r + 8 and column pairs 8j + 2(lane % 4)
    const int wt = threadIdx.x % 128, lane = wt % 32;
    const int r = m0 + (wg - 1) * 64 + 16 * (wt / 32) + lane / 4;
    __nv_bfloat16* out = gx + (size_t)b * T_ * di;
    const bool pairs = (di % 2) == 0;   // bf16x2 stores are 4-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = r + 8 * half, c = n0 + 128 * h + 8 * j + 2 * (lane % 4);
          if (t >= T_ || c >= di) continue;
          const float v0 = acc[h][4 * j + 2 * half], v1 = acc[h][4 * j + 2 * half + 1];
          __nv_bfloat16* dst = out + (size_t)t * di + c;
          if (pairs && c + 1 < di) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16(v0);
            if (c + 1 < di) dst[1] = __float2bfloat16(v1);
          }
        }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 (n2, n1, n0) array, n0 contiguous; box (64, rows, 1), 128-byte
// swizzle, zero fill out of bounds
inline bool make_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1, uint64_t n2,
                     uint32_t rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// TMA needs 16-byte-aligned bases and row strides (do % 8 == 0)
inline bool tma_ok(const void* gy, const void* w, int dout) {
  return dout % 8 == 0 && reinterpret_cast<uintptr_t>(gy) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && encode_tiled() != nullptr;
}

inline cudaError_t launch_dgrad(const void* gy, const void* w, void* gx, int BG, int T_, int di,
                                int dout, int E, cudaStream_t st) {
  // the path is the one dgrad_path reports: a map TMA should take but
  // cannot be encoded is an error, not a silent switch to element loads
  CUtensorMap map_gy = {}, map_w = {};
  const int use_tma = tma_ok(gy, w, dout);
  if (use_tma && !(make_map(&map_gy, gy, (uint64_t)dout, (uint64_t)T_, (uint64_t)BG, BM) &&
                   make_map(&map_w, w, (uint64_t)dout, (uint64_t)di, (uint64_t)E, BN)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const int n_m = (T_ + BM - 1) / BM, n_n = (di + BN - 1) / BN;
  dgrad_kernel<<<dim3((unsigned)(n_m * n_n), (unsigned)BG), NT, SMEM, st>>>(
      map_gy, map_w, static_cast<const __nv_bfloat16*>(gy), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(gx), T_, di, dout, E, n_m, use_tma);
  return cudaGetLastError();
}

}  // namespace tc

// Which path the gx launch takes for these operands (tc::Path).
template <typename T>
int dgrad_path(const void* gy, const void* w, int dout) {
  if (!std::is_same<T, __nv_bfloat16>::value) return tc::CUDA_CORES;
  return tc::tma_ok(gy, w, dout) ? tc::TMA : tc::LOADS;
}

template <typename T>
cudaError_t launch_dgrad(const void* gy, const void* w, void* gx, int BG, int T_, int di,
                         int dout, int E, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::launch_dgrad(gy, w, gx, BG, T_, di, dout, E, st);
  } else {
    const int n_t = (T_ + BM - 1) / BM;
    dgrad_kernel<T><<<dim3((unsigned)(n_t * ((di + BN - 1) / BN)), (unsigned)BG), NT, 0, st>>>(
        static_cast<const T*>(gy), static_cast<const T*>(w), static_cast<T*>(gx), T_, di, dout,
        E, n_t);
    return cudaGetLastError();
  }
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
