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
// exist here.  So each block owns one (b, 128-row i tile, 128-col j tile),
// loops over T inside the block with the tile in registers, and writes one
// partial to part[b, tile]; the wrapper sums a row's partials in a fixed
// order (no atomics: repeats are bit-identical).  This is the norm launch
// of dense_bwd_norm.cu, from the same header (dense_tiles.cuh), so its
// output equals that kernel's norms² bit for bit.
//
// Bound.  2·BG·T·di·do FLOPs on BG·T·(di + do) input elements: at the
// training path's shapes (BG·T = 4096, di, do >= 3072) bound by operations,
// the bf16 tensor-core rate.  This version runs f32 FMAs on CUDA cores;
// tensor cores are later work.

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
