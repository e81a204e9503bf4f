// One explicit step of Eq 4.3 on a 3-D grid, zero concentration outside:
//   out = u*(1 - mu*dt) + nu*dt/dx^2 * (xm + xp + ym + yp + zm + zp - 6u)
//
// Replaces: src/repro/kernels/diffusion3d/kernel.py:diffusion_step_pallas (the
// Pallas _stencil_kernel).  That kernel is fed six shifted copies of a
// zero-padded array, because TPU blocks cannot overlap to give a stencil its
// halo.  Here each thread reads its own six neighbours from the one input
// array, with a zero for every neighbour outside the grid.
//
// Design: one thread per voxel, z fastest, so a warp reads 32 consecutive
// floats of each of its seven operands; the x- and y-neighbours of a warp are
// again contiguous runs one row or one plane away, and the L2 serves the
// repeats.  The output is a separate buffer (no in-place update).  The sum
// order and the final combine are the Pallas kernel's (kernel.py:30-34), with
// round-to-nearest intrinsics so that nvcc contracts nothing into an FMA.
//
// Bound on this card: bytes.  Each voxel is read once from DRAM and written
// once: 8 bytes per voxel, 64 MB at 200^3, ~19 us at 3.35 TB/s.  The eight
// flops per voxel are far below the f32 rate.
#include <cuda_runtime.h>

namespace {

__global__ void diffusion3d_kernel(const float* __restrict__ u, float* __restrict__ out,
                                   int nx, int ny, int nz, float nu, float keep) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long plane = static_cast<long long>(ny) * nz;
  if (i >= plane * nx) return;
  int z = static_cast<int>(i % nz);
  int y = static_cast<int>((i / nz) % ny);
  int x = static_cast<int>(i / plane);
  float c = u[i];
  float xm = x > 0 ? u[i - plane] : 0.f;
  float xp = x < nx - 1 ? u[i + plane] : 0.f;
  float ym = y > 0 ? u[i - nz] : 0.f;
  float yp = y < ny - 1 ? u[i + nz] : 0.f;
  float zm = z > 0 ? u[i - 1] : 0.f;
  float zp = z < nz - 1 ? u[i + 1] : 0.f;
  float lap = __fadd_rn(xm, xp);
  lap = __fadd_rn(lap, ym);
  lap = __fadd_rn(lap, yp);
  lap = __fadd_rn(lap, zm);
  lap = __fadd_rn(lap, zp);
  lap = __fsub_rn(lap, __fmul_rn(6.0f, c));
  out[i] = __fadd_rn(__fmul_rn(c, keep), __fmul_rn(nu, lap));
}

}  // namespace

extern "C" int diffusion3d_launch(int device, const void* u, void* out, int nx, int ny,
                                  int nz, float nu, float keep, void* stream) {
  cudaSetDevice(device);
  long long n = static_cast<long long>(nx) * ny * nz;
  const int threads = 256;
  unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  if (blocks > 0) {
    diffusion3d_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<float*>(out), nx, ny, nz, nu, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
