// RMSNorm over the rows of x (N, D): y = x * rsqrt(mean(x^2) + eps) * scale,
// statistics in f32, y in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py:rmsnorm_rows (the Pallas
// _rmsnorm_kernel).  That kernel keeps a (256, D) tile in VMEM, pads N to a
// multiple of 256 and writes the tile once.  Here nothing is padded: a block
// (or, in the loop kernel, a warp) takes whole rows and stops at row N.
//
// Design (one pass): a block of 128 threads normalises one row at a time and
// walks rows blockIdx.x, + gridDim.x, ... (the grid is capped at 32 blocks an
// SM).  Each thread holds its part of the row in registers: C 16-byte chunks
// (8 bf16 or 4 f32 values), chunk threadIdx.x + 128 i for i < C, with C a
// template parameter chosen from D at launch (3 at D 3,072 bf16, 5 at 5,120,
// 8 at 8,192), so the row is read from device memory once and a thread's C
// loads are in flight together; the next row's chunks are loaded into a
// second set of registers before the current row is reduced, so they arrive
// while it is written.  The f32 sums of x^2 go through __shfl_xor_sync within
// each warp and through shared memory across the four warps, added in warp
// order by every thread, and y goes out in 16-byte stores.  The block stages
// scale in shared memory as f32 once, read in 16-byte chunks after its first
// row's loads are issued, and each thread re-reads it as 16-byte vectors.  A
// first design held a row in one warp's registers (12 chunks a lane at D
// 3,072): up to 128 data registers a thread at D 8,192 cut the warps an SM
// holds, and it measured slower than F.rms_norm.  Rows that are not 16-byte
// aligned (D not a multiple of the chunk, or a row slice such as x[1:] of an
// odd D), and rows of more than 8 chunks a thread (f32 beyond D 4,096, bf16
// beyond 8,192), take the loop kernel below: one warp a row, chunks (or single
// values) in a loop with a runtime trip count, the second pass re-reading the
// row from L1 / L2.
//
// Arithmetic: as the Pallas kernel (kernel.py:26-30), ms = sum(x*x) / D,
// r = rsqrtf(ms + eps), y = (x * r) * scale, with round-to-nearest intrinsics
// so nvcc contracts nothing into an FMA.  The sums run in another order than
// XLA's (and than each other's), and rsqrtf is within 2 ulp, both far below a
// bf16 ulp.
//
// Bound on this card: bytes.  At the LM prefill shape (8,192 rows of 3,072
// bf16) x is read once and y written once, 100.7 MB, 0.030 ms at 3.35 TB/s,
// against ~3 f32 operations a value.  At decode (4 rows) the launch latency
// (a few microseconds) is the bound, not the 49 KB the rows hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

constexpr int kThreads = 256;  // loop kernel: 8 rows per block

// The loop kernel: rows that are not 16-byte aligned, or longer than
// kMaxChunks chunks a thread of the one-pass kernel.
template <typename T, typename S, int V>
__global__ void rmsnorm_loop_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                                    T* __restrict__ out, int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps exit together
  const Chunk<T, V>* xr = reinterpret_cast<const Chunk<T, V>*>(x + row * d);
  Chunk<T, V>* orow = reinterpret_cast<Chunk<T, V>*>(out + row * d);
  const int chunks = d / V;

  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const Chunk<T, V> a = xr[c];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f(a.v[i]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));

  for (int c = lane; c < chunks; c += 32) {
    const Chunk<T, V> a = xr[c];
    Chunk<T, V> y;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float s = to_f(scale[c * V + i]);
      y.v[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a.v[i]), r), s));
    }
    orow[c] = y;
  }
}

constexpr int kRowThreads = 128;       // one row at a time per block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxChunks = 8;          // chunks a thread: D <= 8,192 bf16, 4,096 f32
constexpr int kBlocksPerSm = 32;       // grid cap; blocks beyond it take further rows

template <typename T, int V, int C>
__device__ __forceinline__ void load_row(Chunk<T, V> (&a)[C], const T* __restrict__ x,
                                         long long row, int d, int chunks) {
  const Chunk<T, V>* xr = reinterpret_cast<const Chunk<T, V>*>(x + row * d);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = threadIdx.x + kRowThreads * i;
    if (c < chunks) a[i] = xr[c];
  }
}

template <typename T, typename S, int C>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ out, int n, int d, float eps, int scale_vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int SV = 16 / static_cast<int>(sizeof(S));
  extern __shared__ float4 s_scale4[];
  float* s_scale = reinterpret_cast<float*>(s_scale4);
  __shared__ float partial[2][kRowWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d / V;

  long long row = blockIdx.x;
  Chunk<T, V> a[C], next[C];
  if (row < n) load_row<T, V, C>(a, x, row, d, chunks);

  if (scale_vec) {
    const Chunk<S, SV>* sc = reinterpret_cast<const Chunk<S, SV>*>(scale);
    for (int c = threadIdx.x; c < d / SV; c += kRowThreads) {
      const Chunk<S, SV> v = sc[c];
#pragma unroll
      for (int i = 0; i < SV; ++i) s_scale[c * SV + i] = to_f(v.v[i]);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kRowThreads) s_scale[i] = to_f(scale[i]);
  }
  __syncthreads();

  for (int parity = 0; row < n; parity ^= 1) {  // block-uniform
    const long long row_next = row + gridDim.x;
    if (row_next < n) load_row<T, V, C>(next, x, row_next, d, chunks);

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (threadIdx.x + kRowThreads * i < chunks) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float f = to_f(a[i].v[e]);
          ss = __fadd_rn(ss, __fmul_rn(f, f));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    }
    if (lane == 0) partial[parity][warp] = ss;
    __syncthreads();  // partial[parity] is complete; partial[parity ^ 1] is free
    float total = partial[parity][0];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) total = __fadd_rn(total, partial[parity][w]);
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));

    Chunk<T, V>* orow = reinterpret_cast<Chunk<T, V>*>(out + row * d);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = threadIdx.x + kRowThreads * i;
      if (c < chunks) {
        float s[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 s4 = s_scale4[(c * V + e) / 4];
          s[e] = s4.x;
          s[e + 1] = s4.y;
          s[e + 2] = s4.z;
          s[e + 3] = s4.w;
        }
        Chunk<T, V> y;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          y.v[e] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a[i].v[e]), r), s[e]));
        }
        orow[c] = y;
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) a[i] = next[i];
    row = row_next;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

template <typename T, typename S, int C>
void launch_rows(const void* x, const void* scale, void* out, int n, int d, float eps,
                 int scale_vec, cudaStream_t stream) {
  const long long cap = static_cast<long long>(kBlocksPerSm) * sm_count();
  const unsigned blocks = static_cast<unsigned>(n < cap ? n : cap);
  rmsnorm_rows_kernel<T, S, C><<<blocks, kRowThreads, sizeof(float) * d, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n, d, eps,
      scale_vec);
}

template <typename T, typename S>
cudaError_t launch_typed(const void* x, const void* scale, void* out, int n, int d,
                         float eps, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int SV = 16 / static_cast<int>(sizeof(S));
  const bool aligned = (d % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int per_thread = (d / V + kRowThreads - 1) / kRowThreads;
  if (aligned && per_thread <= kMaxChunks) {
    const int scale_vec = (d % SV == 0) && (reinterpret_cast<uintptr_t>(scale) % 16 == 0);
    switch (per_thread) {
      case 0:
      case 1: launch_rows<T, S, 1>(x, scale, out, n, d, eps, scale_vec, stream); break;
      case 2: launch_rows<T, S, 2>(x, scale, out, n, d, eps, scale_vec, stream); break;
      case 3: launch_rows<T, S, 3>(x, scale, out, n, d, eps, scale_vec, stream); break;
      case 4: launch_rows<T, S, 4>(x, scale, out, n, d, eps, scale_vec, stream); break;
      case 5: launch_rows<T, S, 5>(x, scale, out, n, d, eps, scale_vec, stream); break;
      case 6: launch_rows<T, S, 6>(x, scale, out, n, d, eps, scale_vec, stream); break;
      default: launch_rows<T, S, 8>(x, scale, out, n, d, eps, scale_vec, stream); break;
    }
    return cudaGetLastError();
  }
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + 7) / 8);
  if (aligned) {
    rmsnorm_loop_kernel<T, S, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n, d,
        eps);
  } else {
    rmsnorm_loop_kernel<T, S, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n, d,
        eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scale(int scale_dtype, const void* x, const void* scale, void* out, int n,
                         int d, float eps, cudaStream_t stream) {
  switch (scale_dtype) {
    case 0: return launch_typed<T, float>(x, scale, out, n, d, eps, stream);
    case 1: return launch_typed<T, __nv_bfloat16>(x, scale, out, n, d, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (kernel.py DTYPES).
extern "C" int rmsnorm_launch(int device, const void* x, int x_dtype, const void* scale,
                              int scale_dtype, void* out, int n, int d, float eps,
                              void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = launch_scale<float>(scale_dtype, x, scale, out, n, d, eps, s); break;
    case 1: err = launch_scale<__nv_bfloat16>(scale_dtype, x, scale, out, n, d, eps, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
