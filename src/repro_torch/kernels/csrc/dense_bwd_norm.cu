// Fused dense backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_bwd.py `dense_bwd_norm`
// (`_fused_kernel`, pallas_call at :135).  Same function: for row b of
// x (BG, T, di) and gy (BG, T, do) with grouped weights w (E, di, do), row b
// using w[b % E],
//     gx_b  = gy_b · w[b % E]ᵀ            (BG, T, di), in x's type
//     nsq_b = ‖x_bᵀ gy_b‖²_F              (BG,) float32
// without the per-example weight gradient G_b = x_bᵀ gy_b ever reaching
// device memory: each (128 x 128) tile of G_b lives in registers, is squared
// and summed on the spot, and only one float per tile is written.
//
// Design.  The TPU kernel keeps a (bi, do) f32 row strip of G_b in VMEM
// (4 MB at do = 8192, 16.5 MB at the LM head) and relies on its grid running
// in order to carry gx and nsq sums across grid steps.  Neither holds here:
// a block has at most 227 KB of shared memory and blocks run in no order.
// So the work is split by output, in two launches on the same stream, the
// gx launch and the norm launch of dense_tiles.cuh.  The wrapper sums the
// norm launch's partials over tiles in a fixed order (torch's row sum, as
// the JAX shim sums over groups outside pallas_call): no atomics, so two
// launches give bit-identical norms.  pegrad_norm.cu and dense_dgrad.cu run
// each launch alone, from the same header, and give the same bits.
//
// Bound.  The function costs 4·BG·T·di·do FLOPs (dgrad plus per-example
// wgrad) on BG·T·(di + do) + E·di·do input elements, so at the training
// path's shapes (BG·T = 4096, di, do >= 3072) it is bound by operations: the
// bf16 tensor-core rate, 989 TFLOP/s.  In bf16 both launches run on the
// tensor cores (wgmma fed by TMA, dense_tiles.cuh): the gx launch reads its
// operands K-major, the norm launch reads x and gy MN-major (its depth T is
// their strided dimension) on a persistent grid; f32 runs both on CUDA-core
// FMAs.  Reading x and gy once for both outputs is later work: the two
// launches read different operand pairs in different tile orders.

#include "dense_tiles.cuh"

namespace {

template <typename T>
cudaError_t launch(const void* x, const void* gy, const void* w, void* gx, float* part, int BG,
                   int T_, int di, int dout, int E, cudaStream_t st) {
  cudaError_t err = launch_dgrad<T>(gy, w, gx, BG, T_, di, dout, E, st);
  if (err != cudaSuccess) return err;
  return launch_norm<T>(x, gy, part, BG, T_, di, dout, st);
}

}  // namespace

// Returns the launches' cudaError_t (0 = success).  dtype: 0 float32,
// 1 bfloat16 (x, gy, w and gx alike).  part: (BG, ceil(di/128)·ceil(do/128))
// float32, one partial per (i tile, j tile), i tile fastest.
extern "C" int repro_dense_bwd_norm(const void* x, const void* gy, const void* w, void* gx,
                                    float* part, int BG, int T_, int di, int dout, int E,
                                    int dtype, void* stream) {
  if (BG < 1 || BG > 65535 || T_ < 1 || di < 1 || dout < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, gy, w, gx, part, BG, T_, di, dout, E, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gy, w, gx, part, BG, T_, di, dout, E, st);
  return (int)cudaErrorInvalidValue;
}
