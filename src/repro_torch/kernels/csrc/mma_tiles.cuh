// Tensor-core building blocks shared by the bf16 kernels that run on
// mma.sync (flash_attn_fwd.cu, flash_attn_bwd.cu, gram_norm.cu): cp.async
// copies into shared memory, ldmatrix fragment loads, the m16n8k16 product
// (bf16 in, f32 accumulate) and the bf16 packing of f32 accumulators.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4·g + t4):
//   A (16 x 16, row): a0 = A[g][2t4, 2t4+1], a1 = A[g+8][...],
//                     a2 = A[g][2t4+8, +9], a3 = A[g+8][2t4+8, +9]
//   B (16 x 8, col):  b0 = B[2t4, 2t4+1][g], b1 = B[2t4+8, +9][g]
//   C (16 x 8, f32):  c0, c1 = C[g][2t4, 2t4+1], c2, c3 = C[g+8][...]
// so two adjacent n-tiles of C, rounded to bf16, are lane for lane the A
// fragment of the next product over those 16 columns.
//
// Every source that includes this is its own shared library, so the
// anonymous namespace gives each one its own copy.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace mma {

// which path a bf16 launch takes: 0 CUDA cores (float32), 1 tensor cores
// fed by 16-byte cp.async, 2 tensor cores fed by element loads (a row not a
// multiple of 16 bytes, or a base not 16-byte aligned)
enum Path { CUDA_CORES = 0, CP_ASYNC = 1, LOADS = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) · b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of rows [m0, m0 + 16) x columns [k0, k0 + 16) of a
// row-major shared tile with row stride lds (elements)
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int lds,
                                       int m0, int k0) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  ldsm_x4(smem_u32(tile + (m0 + lr + 8 * (lm & 1)) * lds + k0 + 8 * (lm >> 1)), a[0], a[1],
          a[2], a[3]);
}

// B fragments of two n-tiles, B[k][n] = tile[n][k] with the tile's rows
// [n0, n0 + 16) as n and columns [k0, k0 + 16) as k (a row-major tile read
// as its transpose, K-major): (b0, b1) for n-tile n0, (b2, b3) for n0 + 8
__device__ __forceinline__ void ldsm_b(uint32_t& b0, uint32_t& b1, uint32_t& b2, uint32_t& b3,
                                       const __nv_bfloat16* tile, int lds, int n0, int k0) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  ldsm_x4(smem_u32(tile + (n0 + lr + 8 * (lm >> 1)) * lds + k0 + 8 * (lm & 1)), b0, b1, b2, b3);
}

// B fragments of two n-tiles, B[k][n] = tile[k][n] with the tile's rows
// [k0, k0 + 16) as k and columns [n0, n0 + 16) as n (a row-major tile read
// as it is, through ldmatrix.trans): (b0, b1) for n0, (b2, b3) for n0 + 8
__device__ __forceinline__ void ldsm_b_t(uint32_t& b0, uint32_t& b1, uint32_t& b2,
                                         uint32_t& b3, const __nv_bfloat16* tile, int lds,
                                         int k0, int n0) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  ldsm_x4_t(smem_u32(tile + (k0 + lr + 8 * (lm & 1)) * lds + n0 + 8 * (lm >> 1)), b0, b1, b2,
            b3);
}

// 16-byte copies need a row of a multiple of 8 bf16 and 16-byte-aligned bases
__device__ __host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// rows [row0, row0 + NR) x columns [col0, col0 + W) of a row-major
// (rows, cols) bf16 matrix into a shared tile of row stride lds, zero past
// `rows` and past `cols`, by NTH threads: 16-byte cp.async where `vec`
// (cols % 8 == 0 and an aligned base; a chunk is then all in or all out),
// else element loads
template <int NR, int W, int NTH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int lds,
                                          const __nv_bfloat16* __restrict__ src, int row0,
                                          int rows, int col0, int cols, bool vec) {
  constexpr int CH = W / 8;
  if (vec) {
    for (int i = threadIdx.x; i < NR * CH; i += NTH) {
      const int r = i / CH, c = (i % CH) * 8, gr = row0 + r, gc = col0 + c;
      const bool valid = gr < rows && gc < cols;
      cp_async16(smem_u32(dst + r * lds + c), valid ? src + (size_t)gr * cols + gc : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < NR * W; i += NTH) {
      const int r = i / W, c = i % W, gr = row0 + r, gc = col0 + c;
      dst[r * lds + c] =
          (gr < rows && gc < cols) ? src[(size_t)gr * cols + gc] : __float2bfloat16(0.f);
    }
  }
}

// rows [row0, row0 + 64) of a row-major (rows, hd) bf16 matrix into a
// shared tile of row stride HDP + 8, zero past `rows` and past hd, by a
// block of 128 threads
template <int HDP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int rows, int hd, bool vec) {
  load_tile<64, HDP, 128>(dst, HDP + 8, src, row0, rows, 0, hd, vec);
}

}  // namespace mma
}  // namespace
