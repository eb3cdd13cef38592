// Tiles shared by the dense backward kernels for Hopper (sm_90a):
// dense_bwd_norm.cu (both launches), pegrad_norm.cu (the norm launch) and
// dense_dgrad.cu (the gx launch) include this header, so the three compute
// bit-identical results from the same inputs.
//
// For row b of x (BG, T, di) and gy (BG, T, do) with grouped weights
// w (E, di, do), row b using w[b % E]:
//   * the gx launch: gx_b = gy_b · w[b % E]ᵀ, one block per (b, t tile,
//     i tile), looping over do with the sum in registers;
//   * the norm launch: G_b = x_bᵀ gy_b built tile by tile over T in
//     registers, and Σ tile² written to part[b, tile], one partial per
//     128 x 128 (i, j) tile, i tile fastest.  G_b never reaches device
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
// The norm launch in bf16 runs on the tensor cores too (tc::norm_kernel).
// Its depth is T, the outer (strided) dimension of both x and gy, so both
// operands are MN-major (i and j contiguous): TMA brings (64 i or j, 64 t)
// boxes of the 3-D maps (di, T, BG) and (do, T, BG) in the 128-byte
// swizzle, and wgmma.m64n256k16 reads them transposed (trans-a = trans-b =
// 1, MN-major descriptors; k advances by rows of the stage).  A block tile
// is 128 i x 256 j, two consumer warpgroups of 64 i each, f32 accumulators
// in registers.  Each tile sums only T (8 stages of 64 at T 512), so the
// grid is persistent: one block per SM walks the (b, j pair, i tile) work
// in a fixed order, and the producer runs ahead into the next tile's
// stages while the consumers square and reduce the last one; one wgmma
// group stays in flight across stages.  The epilogue squares the fragment
// in f32 on the CUDA cores and reduces it in a fixed order (xor tree per
// warp, then the 8 consumer warps in order), one partial per 128 x 128
// half of the block tile.  Its bound is the tensor cores' rate; what holds
// it below that is the L2 traffic of the tiles (48 KB a 64-deep stage,
// 85 FLOPs a byte).  Element loads take operands TMA cannot address (di or
// do % 8 != 0, unaligned bases; norm_path says which).
//
// The f32 launches keep the CUDA-core tile product (dgrad_kernel and
// norm_kernel outside namespace tc): operands staged through shared
// memory, 8 x 8 register micro-tiles per thread, f32 FMAs (TF32 would not
// meet their 1e-4 tolerance).  Rows, columns and depth past the shapes are
// zero-filled on load and never stored, so any shape runs; an all-zero gy
// row gives an exactly zero norm², on every path.

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

// Stage rows [r0, r0 + 128) x depth [k0, k0 + 8) of an operand whose element
// (r, k) is p[r * sr + k * sk] into S[k][r], zero outside R x K.
// KC: depth is contiguous (sk == 1), a thread reads 4 neighbouring k of one
// row; otherwise rows are contiguous (sr == 1), 4 neighbouring r of one k.
template <bool KC>
__device__ __forceinline__ void stage(float (*S)[LD], const float* __restrict__ p, size_t sr,
                                      size_t sk, int r0, int R, int k0, int K) {
  const int tid = threadIdx.x;
  if (KC) {
    const int r = tid >> 1, kk = (tid & 1) * 4, gr = r0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gk = k0 + kk + c;
      S[kk + c][r] = (gr < R && gk < K) ? p[(size_t)gr * sr + gk] : 0.f;
    }
  } else {
    const int kk = tid >> 5, r = (tid & 31) * 4, gk = k0 + kk;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gr = r0 + r + c;
      S[kk][r + c] = (gr < R && gk < K) ? p[gr + (size_t)gk * sk] : 0.f;
    }
  }
}

// acc[i][j] = Σ_k A(m0 + row(i), k) · B(n0 + col(j), k) over k < K, where
// row(i) = 4·ty + i for i < 4 and 64 + 4·ty + i - 4 after, col(j) alike in tx.
template <bool KC>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const float* __restrict__ A,
                                             size_t sam, size_t sak, int M,
                                             const float* __restrict__ B, size_t sbn,
                                             size_t sbk, int N, int K, int m0, int n0) {
  __shared__ __align__(16) float As[BK][LD];
  __shared__ __align__(16) float Bs[BK][LD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // the previous stage's reads are done
    stage<KC>(As, A, sam, sak, m0, M, k0, K);
    stage<KC>(Bs, B, sbn, sbk, n0, N, k0, K);
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
__global__ void __launch_bounds__(NT)
dgrad_kernel(const float* __restrict__ gy, const float* __restrict__ w, float* __restrict__ gx,
             int T_, int di, int dout, int E, int n_m) {
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x % n_m) * BM, n0 = (blockIdx.x / n_m) * BN;
  const float* A = gy + (size_t)b * T_ * dout;            // (t, j) at t·do + j
  const float* W = w + (size_t)(b % E) * di * dout;       // (i, j) at i·do + j
  float acc[8][8];
  tile_product<true>(acc, A, (size_t)dout, 1, T_, W, (size_t)dout, 1, di, dout, m0, n0);
  float* out = gx + (size_t)b * T_ * di;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = m0 + tile_row(i);
    if (t >= T_) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(j);
      if (c < di) out[(size_t)t * di + c] = acc[i][j];
    }
  }
}

// part[b, tile] = Σ over one (i tile, j tile) of (x[b]ᵀ gy[b])² on the CUDA
// cores (the f32 path).
__global__ void __launch_bounds__(NT)
norm_kernel(const float* __restrict__ x, const float* __restrict__ gy, float* __restrict__ part,
            int T_, int di, int dout, int n_m) {
  __shared__ float warp_sums[NT / 32];
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x % n_m) * BM, n0 = (blockIdx.x / n_m) * BN;
  const float* X = x + (size_t)b * T_ * di;               // (i, t) at t·di + i
  const float* G = gy + (size_t)b * T_ * dout;            // (j, t) at t·do + j
  float acc[8][8];
  tile_product<false>(acc, X, 1, (size_t)di, di, G, 1, (size_t)dout, dout, T_, m0, n0);
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
// The bf16 gx and norm launches on the tensor cores: TMA -> 4-stage ring ->
// wgmma.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;                  // block rows (gx: t, norm: i), 64 per consumer
constexpr int BN = 256;                  // block cols (gx: i, norm: j)
constexpr int BK = 64;                   // depth per stage: 128 bytes of bf16
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

// wgmma shared-memory descriptor of an MN-major tile in the 128-byte
// swizzle: rows of 64 M (or N) elements, one row per k, 8-row groups 1024
// bytes apart along k (SBO), 64-wide M (or N) chunks CHUNK bytes apart
// (LBO); tile 1024-aligned
constexpr uint32_t CHUNK = 64 * BK * 2;   // one (64 mn, 64 k) box: 8 KB
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(CHUNK >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 256, f32, this warpgroup's fragment) += A (64 x 16) · B (16 x 256),
// both MN-major in shared memory (trans-a = trans-b = 1)
__device__ __forceinline__ void wgmma_256_mn(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of element (r, k) of a (rows, 64) bf16 tile in the 128-byte
// swizzle TMA writes: 16-byte chunk k/8 of row r goes to chunk (k/8) ^ (r%8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int k) {
  return (uint32_t)(r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2);
}

// rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major (rows, cols)
// bf16 matrix into a swizzled stage of C / 64 boxes of (R rows, 64
// columns), R·128 bytes apart, as TMA writes them: element loads by the 128
// producer threads, zero outside the matrix.  The gx launch stages (R rows,
// 64 deep); the norm launch (64 deep, R = 64 rows of t) by 128 or 256 i/j.
template <int R, int C>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* __restrict__ p,
                                          int r0, int rows, int c0, int cols) {
  const int tid = threadIdx.x;   // producer warpgroup: 0..127
  for (int idx = tid; idx < R * C; idx += 128) {
    const int r = idx / C, c = idx % C, gr = r0 + r, gc = c0 + c;
    const __nv_bfloat16 v =
        (gr < rows && gc < cols) ? p[(size_t)gr * cols + gc] : __float2bfloat16(0.f);
    *reinterpret_cast<__nv_bfloat16*>(dst + (c / 64) * (R * 128) + sw128_offset(r, c % 64)) = v;
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
        load_tile<BM, BK>(sA + s * A_BYTES, A, m0, T_, kt * BK, dout);
        load_tile<BN, BK>(sB + s * B_BYTES, W, n0, di, kt * BK, dout);
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
      wgmma_commit();
      wgmma_wait<0>();
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

// part[b, tile] = Σ over one 128 x 128 (i, j) tile of (x[b]ᵀ gy[b])², i
// tile fastest.  Persistent: block p takes work items p, p + grid, ...; an
// item is a 128 i x 256 j block tile of row b, i tile fastest, then the j
// pair, then b.  Stage s holds x rows [t0, t0 + 64) x i [i0, i0 + 128) as
// two (64 i, 64 t) boxes and gy's as four (64 j, 64 t) boxes.
__global__ void __launch_bounds__(NT, 1)
norm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_gy,
            const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gy,
            float* __restrict__ part, int T_, int di, int dout, int n_i, int n_jj,
            long long work, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[2][2][8];   // [item parity][128-col half][consumer warp]
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* sA = smem;                               // STAGES x 2 boxes of x
  uint8_t* sB = smem + STAGES * A_BYTES;            // STAGES x 4 boxes of gy
  const uint32_t full = smem_u32(sB + STAGES * B_BYTES);   // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;                 // STAGES mbarriers

  const int n_k = (T_ + BK - 1) / BK;
  const int n_j = (dout + BM - 1) / BM;             // 128-wide j tiles of part
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, use_tma ? 1 : 128);   // one expect_tx, or every loader
      mbar_init(empty + 8 * s, 2);                  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // g counts stages over all of this block's items, in the same order on
  // both sides: stage g % STAGES, its (g / STAGES)-th use
  if (wg == 0) {
    if (use_tma && threadIdx.x != 0) return;
    uint32_t g = 0;
    for (long long item = blockIdx.x; item < work; item += gridDim.x) {
      const int i0 = (int)(item % n_i) * BM;
      const long long rest = item / n_i;
      const int j0 = (int)(rest % n_jj) * BN, b = (int)(rest / n_jj);
      const __nv_bfloat16* X = x + (size_t)b * T_ * di;
      const __nv_bfloat16* G = gy + (size_t)b * T_ * dout;
      for (int kt = 0; kt < n_k; ++kt, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) - 1) & 1);
        if (use_tma) {
          mbar_expect_tx(full + 8 * s, A_BYTES + B_BYTES);
#pragma unroll
          for (int c = 0; c < BM / 64; ++c)
            tma_load_3d(smem_u32(sA + s * A_BYTES + c * CHUNK), &map_x, full + 8 * s,
                        i0 + 64 * c, kt * BK, b);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(smem_u32(sB + s * B_BYTES + c * CHUNK), &map_gy, full + 8 * s,
                        j0 + 64 * c, kt * BK, b);
        } else {
          load_tile<BK, BM>(sA + s * A_BYTES, X, kt * BK, T_, i0, di);
          load_tile<BK, BN>(sB + s * B_BYTES, G, kt * BK, T_, j0, dout);
          // the generic-proxy stores must be visible to wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // consumers: warpgroup 1 owns i0 + [0, 64), warpgroup 2 i0 + [64, 128),
    // each all 256 j of the item
    const int cw = (threadIdx.x - 128) / 32, lane = threadIdx.x % 32;
    const uint32_t a_box = (uint32_t)(wg - 1) * CHUNK;
    float acc[128];
    uint32_t g = 0;
    int par = 0;
    for (long long item = blockIdx.x; item < work; item += gridDim.x, par ^= 1) {
      const int it = (int)(item % n_i);
      const long long rest = item / n_i;
      const int jj = (int)(rest % n_jj), b = (int)(rest / n_jj);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt, ++g) {
        const int s = g % STAGES;
        mbar_wait(full + 8 * s, (g / STAGES) & 1);
        const uint32_t a = smem_u32(sA + s * A_BYTES) + a_box;
        const uint32_t bb = smem_u32(sB + s * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)   // k advances by 16 rows of 128 bytes
          wgmma_256_mn(acc, sw128_mn_desc(a + 2048 * k), sw128_mn_desc(bb + 2048 * k));
        wgmma_commit();
        wgmma_wait<1>();   // the previous stage's products are done: release it
        fence_operands(acc);
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
      // epilogue: fragment entry 4q + e is column 8q + 2(lane % 4) + (e & 1),
      // so entries [0, 64) are the item's first 128 j and [64, 128) its second
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) s0 = fmaf(acc[i], acc[i], s0);
#pragma unroll
      for (int i = 64; i < 128; ++i) s1 = fmaf(acc[i], acc[i], s1);
      // fixed-order block sum: xor tree in each warp, then warps in order
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane == 0) {
        red[par][0][cw] = s0;
        red[par][1][cw] = s1;
      }
      // the 256 consumer threads; red alternates by item, so a warp may
      // write the next item's sums before this one's are read
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (threadIdx.x == 128) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jt = 2 * jj + h;
          if (jt >= n_j) continue;
          float tot = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) tot += red[par][h][w];
          part[(size_t)b * n_i * n_j + it + (size_t)n_i * jt] = tot;
        }
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

// the norm launch also needs di % 8 == 0 (x's rows)
inline bool norm_tma_ok(const void* x, const void* gy, int di, int dout) {
  return di % 8 == 0 && tma_ok(x, gy, dout);
}

inline cudaError_t launch_norm(const void* x, const void* gy, float* part, int BG, int T_, int di,
                               int dout, cudaStream_t st) {
  // the path is the one norm_path reports (as for the gx launch)
  CUtensorMap map_x = {}, map_gy = {};
  const int use_tma = norm_tma_ok(x, gy, di, dout);
  if (use_tma && !(make_map(&map_x, x, (uint64_t)di, (uint64_t)T_, (uint64_t)BG, BK) &&
                   make_map(&map_gy, gy, (uint64_t)dout, (uint64_t)T_, (uint64_t)BG, BK)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int n_i = (di + BM - 1) / BM, n_jj = (dout + BN - 1) / BN;
  const long long work = (long long)BG * n_i * n_jj;
  const unsigned grid = (unsigned)(work < n_sm ? work : n_sm);   // one block per SM
  norm_kernel<<<grid, NT, SMEM, st>>>(
      map_x, map_gy, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gy),
      part, T_, di, dout, n_i, n_jj, work, use_tma);
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
    dgrad_kernel<<<dim3((unsigned)(n_t * ((di + BN - 1) / BN)), (unsigned)BG), NT, 0, st>>>(
        static_cast<const float*>(gy), static_cast<const float*>(w), static_cast<float*>(gx),
        T_, di, dout, E, n_t);
    return cudaGetLastError();
  }
}

// Which path the norm launch takes for these operands (tc::Path).
template <typename T>
int norm_path(const void* x, const void* gy, int di, int dout) {
  if (!std::is_same<T, __nv_bfloat16>::value) return tc::CUDA_CORES;
  return tc::norm_tma_ok(x, gy, di, dout) ? tc::TMA : tc::LOADS;
}

// part: (BG, ceil(di/128)·ceil(do/128)) float32.
template <typename T>
cudaError_t launch_norm(const void* x, const void* gy, float* part, int BG, int T_, int di,
                        int dout, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::launch_norm(x, gy, part, BG, T_, di, dout, st);
  } else {
    const int n_i = (di + BM - 1) / BM, n_j = (dout + BN - 1) / BN;
    norm_kernel<<<dim3((unsigned)(n_i * n_j), (unsigned)BG), NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(gy), part, T_, di, dout, n_i);
    return cudaGetLastError();
  }
}

}  // namespace
