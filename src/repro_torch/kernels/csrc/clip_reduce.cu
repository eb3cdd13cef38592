// Clip-scale and batch reduce for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/clip_reduce.py `clip_reduce`
// (`_kernel`, pallas_call at :43): over per-example gradients g (B, N) and
// clip factors c (B,),
//     out = Σ_b c_b · g_b                 (N,) float32
// without the clipped copies c_b · g_b ever reaching device memory.
//
// Design.  The TPU kernel walks a (bn column block, bb row block) grid with
// the row blocks innermost, carrying the column block's sum in its output
// tile across grid steps.  Here nothing carries across blocks, and nothing
// needs to: each thread owns a strip of columns, loops over b in order
// inside itself and keeps the strip's sums in registers, so the output is
// written once, with no atomics and no second pass.  Each thread reads 16
// bytes of a row at a time (4 f32 or 8 bf16 columns; the fast path, taken
// when N is a multiple of that width and the pointers are 16-byte aligned;
// otherwise one column per thread), eight rows' loads in flight before it
// accumulates them.  Sums are f32 FMAs in the order b = 0, 1, ..., so the
// result is deterministic and the same on both paths, and a row with
// c_b = 0 adds exactly 0: the result equals the reduction over the rows
// with c_b != 0 bit for bit.
//
// Bound.  2·B·N FLOPs on B·N·sizeof(g) + 4·(B + N) bytes: bound by bytes
// (3.35 TB/s on the H100) at any B.  Every byte is read once and every
// thread's loads are 16 bytes wide and coalesced across the warp, so the
// kernel should run near that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int ROWS = 8;     // rows loaded before they are accumulated

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One thread: the V = 16 / sizeof(T) columns [col0, col0 + V).
template <typename T>
__global__ void __launch_bounds__(NT)
clip_reduce_vec(const T* __restrict__ g, const float* __restrict__ c, float* __restrict__ out,
                int B, long long N) {
  constexpr int V = 16 / sizeof(T);
  const long long col0 = ((long long)blockIdx.x * NT + threadIdx.x) * V;
  if (col0 >= N) return;   // N % V == 0 on this path
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int b0 = 0; b0 < B; b0 += ROWS) {
    uint4 raw[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      if (b0 + u < B)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(g + (size_t)(b0 + u) * N + col0));
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (b0 + u < B) {
        const float cb = __ldg(c + b0 + u);
        const T* v = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(cb, to_f32(v[k]), acc[k]);
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + col0);
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// One thread: column col, for a ragged N or unaligned pointers.
template <typename T>
__global__ void __launch_bounds__(NT)
clip_reduce_col(const T* __restrict__ g, const float* __restrict__ c, float* __restrict__ out,
                int B, long long N) {
  const long long col = (long long)blockIdx.x * NT + threadIdx.x;
  if (col >= N) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc = fmaf(__ldg(c + b), to_f32(g[(size_t)b * N + col]), acc);
  out[col] = acc;
}

template <typename T>
cudaError_t launch(const void* g, const float* c, float* out, int B, long long N,
                   cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = (long long)NT * (vec ? V : 1);
  const unsigned blocks = (unsigned)((N + per_block - 1) / per_block);
  if (vec)
    clip_reduce_vec<T><<<blocks, NT, 0, st>>>(static_cast<const T*>(g), c, out, B, N);
  else
    clip_reduce_col<T><<<blocks, NT, 0, st>>>(static_cast<const T*>(g), c, out, B, N);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = success).  dtype of g: 0 float32,
// 1 bfloat16; c and out are float32.
extern "C" int repro_clip_reduce(const void* g, const float* c, float* out, int B, long long N,
                                 int dtype, void* stream) {
  if (B < 1 || N < 1 || N > (long long)0x7fffffff * NT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(g, c, out, B, N, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(g, c, out, B, N, st);
  return (int)cudaErrorInvalidValue;
}
