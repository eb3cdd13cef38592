// Dense input gradient for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_bwd.py `dense_dgrad`
// (`_dgrad_kernel`, pallas_call at :172): for row b of gy (BG, T, do) with
// grouped weights w (E, di, do), row b using w[b % E],
//     gx_b = gy_b · w[b % E]ᵀ             (BG, T, di), in gy's type.
// It is the dgrad half of the fused dense backward alone: paired with
// pegrad_norm it is the two-launch, separate-pass baseline that the fusion
// is measured against.
//
// Design.  The TPU kernel carries a (bt, bi) f32 accumulator in VMEM over
// its innermost j grid axis.  Here one block owns one (b, t tile, i tile)
// and loops over do inside the block, the sum in registers, then writes its
// tile once.  This is the gx launch of dense_bwd_norm.cu, from the same
// header (dense_tiles.cuh), so its output equals that kernel's gx bit for
// bit.
//
// Bound.  2·BG·T·di·do FLOPs on BG·T·do + E·di·do input elements: at the
// training path's shapes bound by operations, the bf16 tensor-core rate
// (989 TFLOP/s).  bf16 runs on the tensor cores: TMA fills a 4-stage ring of
// swizzled 64-deep tiles, two warpgroups run wgmma into f32 registers
// (dense_tiles.cuh, tc::dgrad_kernel).  f32 stays on CUDA-core FMAs, whose
// 1e-4 tolerance TF32 would not meet.

#include "dense_tiles.cuh"

// Returns the launch's cudaError_t (0 = success).  dtype: 0 float32,
// 1 bfloat16 (gy, w and gx alike).
extern "C" int repro_dense_dgrad(const void* gy, const void* w, void* gx, int BG, int T_, int di,
                                 int dout, int E, int dtype, void* stream) {
  if (BG < 1 || BG > 65535 || T_ < 1 || di < 1 || dout < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dgrad<float>(gy, w, gx, BG, T_, di, dout, E, st);
  if (dtype == 1) return (int)launch_dgrad<__nv_bfloat16>(gy, w, gx, BG, T_, di, dout, E, st);
  return (int)cudaErrorInvalidValue;
}

// Which path the launch takes for these operands: 0 CUDA cores (float32),
// 1 tensor cores fed by TMA, 2 tensor cores fed by element loads (do % 8 != 0
// or a base not 16-byte aligned).  -1 for an unknown dtype.
extern "C" int repro_dense_dgrad_path(const void* gy, const void* w, int dout, int dtype) {
  if (dtype == 0) return dgrad_path<float>(gy, w, dout);
  if (dtype == 1) return dgrad_path<__nv_bfloat16>(gy, w, dout);
  return -1;
}
