// RMSNorm over the rows of x (N, D): y = x * rsqrt(mean(x^2) + eps) * scale,
// statistics in f32, y in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py:rmsnorm_rows (the Pallas
// _rmsnorm_kernel).  That kernel keeps a (256, D) tile in VMEM, pads N to a
// multiple of 256 and writes the tile once.  Here nothing is padded: one warp
// owns one row, and the ragged end is the warps whose row index is past N.
//
// Design: 8 warps (8 rows) per block.  Each lane walks its row in 16-byte
// chunks (8 bf16 or 4 f32 values) when D is a multiple of the chunk and
// the pointers are aligned, else one value at a time; neighbouring lanes read
// neighbouring chunks, so a warp's loads are coalesced.  Pass 1 sums x^2 in
// f32 per lane and reduces the lanes with __shfl_xor_sync (every lane ends
// with the row's sum); pass 2 reads the row again (from L1 / L2: a block's 8
// rows of D = 3072 bf16 are 48 KB) and writes y.  No shared memory, no
// atomics.
//
// Arithmetic: as the Pallas kernel (kernel.py:26-30), ms = sum(x*x) / D,
// r = rsqrtf(ms + eps), y = (x * r) * scale, with round-to-nearest intrinsics
// so nvcc contracts nothing into an FMA; the sum runs in another order than
// XLA's, and rsqrtf is within 2 ulp, both far below a bf16 ulp.
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

constexpr int kThreads = 256;  // 8 rows per block

template <typename T, typename S, int V>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
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

template <typename T, typename S>
cudaError_t launch_typed(const void* x, const void* scale, void* out, int n, int d,
                         float eps, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool aligned = (d % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + 7) / 8);
  if (aligned) {
    rmsnorm_kernel<T, S, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n, d,
        eps);
  } else {
    rmsnorm_kernel<T, S, 1><<<blocks, kThreads, 0, stream>>>(
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
