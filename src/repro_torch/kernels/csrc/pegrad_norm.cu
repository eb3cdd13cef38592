// Per-example weight-gradient norm for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/pegrad_norm.py `pegrad_norm`
// (`_kernel`, pallas_call at :68): for row b of x (BG, T, di) and
// gy (BG, T, do),
//     nsq_b = ‖x_bᵀ gy_b‖²_F              (BG,) float32
// with G_b = x_bᵀ gy_b formed tile by tile and never written to device
// memory.  This is the `materialize` norm rule of the dense sites.
//
// Design.  The TPU kernel accumulates one (bi, bj) tile of G_b in VMEM over
// its innermost (sequential) t grid axis and adds the tile's Σ² into the
// row's output on the last t step; that carry across grid steps does not
// exist here.  So a block owns whole tiles of G_b, loops over T inside the
// block with the tile in registers, and writes one partial per 128 x 128
// (i, j) tile to part[b, tile]; the wrapper sums a row's partials in a
// fixed order (no atomics: repeats are bit-identical).  This is the norm
// launch of dense_bwd_norm.cu, from the same header (dense_tiles.cuh), so
// its output equals that kernel's norms² bit for bit.
//
// Bound.  2·BG·T·di·do FLOPs on BG·T·(di + do) input elements: at the
// training path's shapes (BG·T = 4096, di, do >= 3072) bound by operations,
// the bf16 tensor-core rate (989 TFLOP/s).  bf16 runs on the tensor cores
// (dense_tiles.cuh, tc::norm_kernel): the contraction runs over T, the
// strided dimension of both x and gy, so TMA brings both in as MN-major
// (i or j contiguous) swizzled boxes and wgmma.m64n256k16 reads them
// transposed; a persistent grid (one block per SM) lets the loads of the
// next 128 x 256 tile overlap the short T loop's epilogue.  What bounds it
// then is the L2 traffic of those tiles (48 KB a 64-deep stage).  f32 stays
// on CUDA-core FMAs, whose 1e-4 tolerance TF32 would not meet.

#include "dense_tiles.cuh"

// Returns the launch's cudaError_t (0 = success).  dtype: 0 float32,
// 1 bfloat16 (x and gy alike).  part: (BG, ceil(di/128)·ceil(do/128))
// float32, one partial per (i tile, j tile), i tile fastest.
extern "C" int repro_pegrad_norm(const void* x, const void* gy, float* part, int BG, int T_,
                                 int di, int dout, int dtype, void* stream) {
  if (BG < 1 || BG > 65535 || T_ < 1 || di < 1 || dout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_norm<float>(x, gy, part, BG, T_, di, dout, st);
  if (dtype == 1) return (int)launch_norm<__nv_bfloat16>(x, gy, part, BG, T_, di, dout, st);
  return (int)cudaErrorInvalidValue;
}

// Which path the launch takes for these operands: 0 CUDA cores (float32),
// 1 tensor cores fed by TMA, 2 tensor cores fed by element loads (di or
// do % 8 != 0, or a base not 16-byte aligned).  -1 for an unknown dtype.
extern "C" int repro_pegrad_norm_path(const void* x, const void* gy, int di, int dout, int dtype) {
  if (dtype == 0) return norm_path<float>(x, gy, di, dout);
  if (dtype == 1) return norm_path<__nv_bfloat16>(x, gy, di, dout);
  return -1;
}
