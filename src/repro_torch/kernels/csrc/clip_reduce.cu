// Clip-scale and batch reduce for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/clip_reduce.py `clip_reduce`
// (`_kernel`, pallas_call at :43): over per-example gradients g (B, N) and
// clip factors c (B,),
//     out  = Σ_b c_b · g_b                (N,) float32, or, accumulating,
//     out += Σ_b c_b · g_b                into a running float32 sum,
// without the clipped copies c_b · g_b ever reaching device memory.
//
// Contract.  Each output column is summed in float32 by one thread, in the
// order b = 0, 1, ..., B - 1 (fmaf), and then written, or added to out once.
// So the result is deterministic and the same on both paths, and a row with
// c_b = 0 adds exactly 0: the result equals the reduction over the rows with
// c_b != 0 bit for bit (the Poisson-padded batches rely on it).  B is never
// split across threads, blocks or cluster ranks: that would regroup the sum.
//
// Bound.  2·B·N FLOPs on B·N·sizeof(g) + 4·B + 4·N (8·N accumulating)
// bytes: bound by bytes (3.35 TB/s on the H100) at any B.  With B unsplit,
// the parallelism has to come from the columns and from the bytes in flight:
// a narrow N (a bias, a small conv) has few columns and many rows, a wide N
// (the flat buffer of a model's gradients, a stacked decoder leaf) many
// columns.
//
// Design.  The TPU kernel walks a (bn column block, bb row block) grid with
// the row blocks innermost, carrying the column block's sum in its output
// tile.  Here a thread owns its columns and sums their rows in order, and
// each block first stages up to C_SMEM clip factors in shared memory (read
// from global memory, a factor's latency sat in every row's sum).  Two paths:
// - the ring (wide rows, 16-byte aligned): a thread owns chunks of 16 bytes
//   of a row (8 bf16 or 4 f32 columns) and streams each chunk's rows through
//   a ring of its own in shared memory with cp.async: R rows a group, one
//   commit group per ring slot, D - 1 groups in flight while it sums the
//   oldest.  A thread reads only what it copied itself, so the ring needs no
//   block barrier.  The grid is persistent (as many blocks as fit on the
//   card); a thread walks chunks chunk, chunk + threads, ..., and its ring
//   runs on across the chunk boundaries, so the pipeline drains only at the
//   end.  Taken where the chunks give every SM at least RING_MIN_THREADS.
// - the column loads (narrow or ragged rows, unaligned pointers): a thread
//   owns one column, so a narrow N still spreads over the most threads it
//   can, and loads K_LOADS of its rows at a time, all in flight at once,
//   before it sums them.
// (Measured on the H100: a ring of 4-byte chunks, two columns a thread,
// lost to the column loads at every narrow width; the column loads lose to
// the ring where the columns fill the card.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT_RING = 128;   // threads a block on the ring
constexpr int NT_LOADS = 256;  // and on the column loads
constexpr int CB = 16;         // bytes of a row a ring chunk
constexpr int R = 4, D = 4;    // the ring: rows a group, groups (256 bytes a thread)
constexpr int K_LOADS = 32;    // rows in flight a thread on the column loads
constexpr int C_SMEM = 1024;   // clip factors staged in shared memory by each block
// the ring where its chunks give every SM at least this many threads
constexpr int RING_MIN_THREADS = 128;

enum Path { RING = 0, LOADS = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// bf16 is the high half of a float32: element 2k of a 32-bit word is its
// low half (little-endian), element 2k + 1 its high half
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the four 32-bit words of a chunk at shared address s
__device__ __forceinline__ void ld_chunk(uint32_t (&w)[4], uint32_t s) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(s));
}

// acc[k] += cb · (the chunk's column k), column by column
template <typename T>
__device__ __forceinline__ void fma_chunk(float (&acc)[CB / sizeof(T)], float cb,
                                          const uint32_t (&w)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<T, float>::value) {
      acc[k] = fmaf(cb, __uint_as_float(w[k]), acc[k]);
    } else {
      acc[2 * k] = fmaf(cb, bf16_lo(w[k]), acc[2 * k]);
      acc[2 * k + 1] = fmaf(cb, bf16_hi(w[k]), acc[2 * k + 1]);
    }
  }
}

// the first min(B, C_SMEM) clip factors into shared memory (all threads of
// the block take part); clip(b) reads factor b from there or, past it, from
// global memory
__device__ __forceinline__ void stage_clip(float* cs, const float* c, int B) {
  const int n = B < C_SMEM ? B : C_SMEM;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
}

__device__ __forceinline__ float clip(const float* cs, const float* c, int b) {
  return b < C_SMEM ? cs[b] : __ldg(c + b);
}

// out[col0, col0 + V) = acc, or += acc (one float add a column)
template <int V>
__device__ __forceinline__ void store(float* o, const float (&acc)[V], int accumulate) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    float4 v = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    if (accumulate) {
      const float4 old = reinterpret_cast<const float4*>(o)[q];
      v = make_float4(old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w);
    }
    reinterpret_cast<float4*>(o)[q] = v;
  }
}

// One thread: the chunks of V = CB / sizeof(T) columns at chunk, chunk +
// stride, ...; for each, its B rows in order through its own ring of D groups
// of R rows in shared memory.  Ring slot (d, r) of thread t lies at
// ((d·R + r)·nt + t)·CB: a warp's 32 chunks of one row are contiguous, so its
// copies and its reads are conflict-free.
template <typename T>
__global__ void __launch_bounds__(NT_RING)
clip_reduce_ring(const T* __restrict__ g, const float* __restrict__ c, float* __restrict__ out,
                 int B, long long N, int accumulate) {
  constexpr int V = CB / sizeof(T);
  __shared__ float cs[C_SMEM];
  extern __shared__ __align__(16) uint8_t ring[];
  stage_clip(cs, c, B);
  const int nt = blockDim.x;
  const long long n_chunks = N / V;                      // N % V == 0 on this path
  const long long stride = (long long)gridDim.x * nt;
  long long chunk = (long long)blockIdx.x * nt + threadIdx.x;
  if (chunk >= n_chunks) return;
  const uint32_t base = smem_u32(ring) + threadIdx.x * CB;
  const uint32_t row_step = nt * CB, slot_step = R * nt * CB;
  const size_t pitch = (size_t)N * sizeof(T);            // bytes from row to row
  const int groups = (B + R - 1) / R;
  const char* gb = reinterpret_cast<const char*>(g);

  // the producer: the next group to copy (of chunk ic, rows ig·R, ...)
  long long ic = chunk;
  int ig = 0;
  auto issue = [&](int d) {
    if (ic < n_chunks) {
      const char* src = gb + (size_t)ig * R * pitch + (size_t)ic * CB;
      const int rows = B - ig * R;
      uint32_t dst = base + d * slot_step;
#pragma unroll
      for (int r = 0; r < R; ++r, dst += row_step, src += pitch)
        if (r < rows) cp_async16(dst, src);
      if (++ig == groups) {
        ig = 0;
        ic += stride;
      }
    }
    cp_commit();   // empty past the last group: the count of groups stays exact
  };
#pragma unroll
  for (int d = 0; d < D - 1; ++d) issue(d);

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  int cg = 0;   // the consumer's group within its chunk
  for (unsigned k = 0;; ++k) {
    // refill the slot summed one step ago (its reads are done: their sums
    // were issued before this copy); read the group's clip factors while it
    // waits for the oldest group; then all R rows' words, then their sums
    issue((k + D - 1) % D);
    const int b0 = cg * R;
    float cr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cr[r] = b0 + r < B ? clip(cs, c, b0 + r) : 0.f;
    cp_wait<D - 1>();
    const uint32_t slot = base + (k % D) * slot_step;
    uint32_t w[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (b0 + r < B) ld_chunk(w[r], slot + r * row_step);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (b0 + r < B) fma_chunk<T>(acc, cr[r], w[r]);
    if (++cg == groups) {
      store<V>(out + chunk * V, acc, accumulate);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
      cg = 0;
      chunk += stride;
      if (chunk >= n_chunks) break;
    }
  }
  cp_wait<0>();
}

// One thread: column col, its B rows in order, K_LOADS rows' loads issued
// together (a pointer stepped row by row) and then summed.
template <typename T>
__global__ void __launch_bounds__(NT_LOADS)
clip_reduce_loads(const T* __restrict__ g, const float* __restrict__ c, float* __restrict__ out,
                  int B, long long N, int accumulate) {
  using Raw = typename std::conditional<std::is_same<T, float>::value, float,
                                        unsigned short>::type;
  constexpr int K = K_LOADS;
  __shared__ float cs[C_SMEM];
  stage_clip(cs, c, B);
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  auto to_f32 = [](Raw x) {
    if constexpr (std::is_same<Raw, float>::value) return x;
    else return __uint_as_float((uint32_t)x << 16);
  };
  const Raw* p = reinterpret_cast<const Raw*>(g) + col;
  float acc = 0.f;
  int b = 0;
  for (; b + K <= B; b += K, p += (size_t)K * N) {
    Raw v[K];
#pragma unroll
    for (int u = 0; u < K; ++u) v[u] = __ldg(p + (size_t)u * N);
    if (b + K <= C_SMEM) {   // all K factors staged: plain shared loads
#pragma unroll
      for (int u = 0; u < K; ++u) acc = fmaf(cs[b + u], to_f32(v[u]), acc);
    } else {
#pragma unroll
      for (int u = 0; u < K; ++u) acc = fmaf(clip(cs, c, b + u), to_f32(v[u]), acc);
    }
  }
  for (; b < B; ++b, p += N) acc = fmaf(clip(cs, c, b), to_f32(__ldg(p)), acc);
  out[col] = accumulate ? out[col] + acc : acc;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// the ring's 16-byte chunks: the row's width and g 16-byte aligned, out
// aligned to its float4 stores
template <typename T>
bool ring_fits(const void* g, const float* out, long long N) {
  return (size_t)N * sizeof(T) % CB == 0 && reinterpret_cast<uintptr_t>(g) % CB == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <typename T>
int pick(const void* g, const float* out, long long N, int sms) {
  return ring_fits<T>(g, out, N) &&
                 (long long)N * (long long)sizeof(T) / CB >= (long long)RING_MIN_THREADS * sms
             ? RING
             : LOADS;
}

template <typename T>
cudaError_t launch_ring(const void* g, const float* c, float* out, int B, long long N,
                        int accumulate, int sms, cudaStream_t st) {
  // as many blocks as fit on the card (the occupancy asked once and kept: it
  // depends on the kernel, not on the call), no more than the chunks
  static int per_sm = 0;
  const size_t smem = (size_t)NT_RING * R * D * CB;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clip_reduce_ring<T>, NT_RING, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const long long chunks = N / (CB / (long long)sizeof(T));
  const long long want = (chunks + NT_RING - 1) / NT_RING, fit = (long long)per_sm * sms;
  clip_reduce_ring<T><<<(unsigned)(want < fit ? want : fit), NT_RING, smem, st>>>(
      static_cast<const T*>(g), c, out, B, N, accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* g, const float* c, float* out, int B, long long N, int accumulate,
                   cudaStream_t st) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorNoDevice;
  if (pick<T>(g, out, N, sms) == RING) return launch_ring<T>(g, c, out, B, N, accumulate, sms, st);
  const long long blocks = (N + NT_LOADS - 1) / NT_LOADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  clip_reduce_loads<T><<<(unsigned)blocks, NT_LOADS, 0, st>>>(static_cast<const T*>(g), c, out,
                                                              B, N, accumulate);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 = success).  dtype of g: 0 float32,
// 1 bfloat16; c and out are float32.  accumulate: 0 writes out, 1 adds the
// sum into it.  The path is repro_clip_reduce_path's.
extern "C" int repro_clip_reduce(const void* g, const float* c, float* out, int B, long long N,
                                 int dtype, int accumulate, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(g, c, out, B, N, accumulate, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(g, c, out, B, N, accumulate, st);
  return (int)cudaErrorInvalidValue;
}

// The path repro_clip_reduce takes for these pointers and this width: 0 the
// ring, 1 the column loads; -1 for a bad dtype or no device.
extern "C" int repro_clip_reduce_path(const void* g, const float* out, long long N, int dtype) {
  const int sms = sm_count();
  if (sms < 1 || N < 1) return -1;
  if (dtype == 0) return pick<float>(g, out, N, sms);
  if (dtype == 1) return pick<__nv_bfloat16>(g, out, N, sms);
  return -1;
}
