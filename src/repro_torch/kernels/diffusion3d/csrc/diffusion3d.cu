// One explicit step of Eq 4.3 on a 3-D grid, zero concentration outside:
//   out = u*(1 - mu*dt) + nu*dt/dx^2 * (xm + xp + ym + yp + zm + zp - 6u)
//
// Replaces: src/repro/kernels/diffusion3d/kernel.py:diffusion_step_pallas (the
// Pallas _stencil_kernel).  That kernel is fed six shifted copies of a
// zero-padded array, because TPU blocks cannot overlap to give a stencil its
// halo.  Here the one input array is read once, with a zero for every
// neighbour outside the grid.
//
// Bound on this card: bytes.  Each voxel is read once from DRAM and written
// once: 8 bytes a voxel, 64 MB at 200^3, 19.1 us at 3.35 TB/s.  The eight
// flops a voxel are far below the f32 rate.
//
// Design: a 2.5-D blocked stencil.  A block owns a kTy x kTz tile of (y, z)
// output columns over a run of x (the grid's x is cut into runs only so that
// enough blocks fill the card), and marches along x.  Each thread owns four
// consecutive z of one row and keeps their x - 1, x and x + 1 values in
// registers (a register queue), so a plane's centre values are read from
// shared memory once.  Plane x's tile with its one-voxel y and z halo sits in
// shared memory for the y and z neighbours; the planes ahead are copied in
// with cp.async into a ring of kStages buffers, kStages - 3 of them in flight
// while the block computes, so DRAM reads overlap the arithmetic.  A copy
// from outside the grid (x, y or z) is a zero-fill, which gives the zero
// boundary with no branch in the arithmetic.  Where nz % 4 == 0 (and the
// pointers are 16-byte aligned) the copies and the stores move 16 bytes a
// thread; otherwise 4-byte copies and scalar stores.  The block's position is
// decoded once, by one division chain a block, not a voxel.
//
// Arithmetic: the Pallas kernel's sum order (kernel.py:30-34) and the plain
// version's, with round-to-nearest intrinsics so that nvcc contracts nothing
// into an FMA: the output equals the plain version bit for bit.
//
// Slots: a batch of B sessions steps its B fields, (B, nx, ny, nz), in one
// launch: blockIdx.y is the field, and each block reads and writes only its
// own field, with zeros outside it, so no halo crosses from one field to the
// next and each field's output is what a launch of that field alone gives,
// bit for bit (the x runs are cut for the B fields together, which moves no
// voxel's arithmetic).
#include <cuda_runtime.h>

namespace {

constexpr int kTy = 16;                    // output rows (y) of a block
constexpr int kTz = 64;                    // output columns (z) of a block
constexpr int kThreads = kTy * kTz / 4;    // four consecutive z a thread
constexpr int kRow = kTz + 8;              // a staged row holds z0 - 4 .. z0 + kTz + 3
constexpr int kRows = kTy + 2;             // y0 - 1 .. y0 + kTy
constexpr int kPlane = kRows * kRow;       // floats of one staged plane
constexpr int kStages = 6;                 // ring of staged planes
constexpr int kBlocksPerSm = 16;           // x is cut into runs to give about this many

__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most kStages - 3 copy groups are pending, then syncs.
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3));
  __syncthreads();
}

// Issue the copies of plane p (zeros where p, y or z is outside the grid).
template <bool kVec>
__device__ __forceinline__ void stage_plane(float* buf, const float* u, int p, int nx, int ny,
                                            int nz, int y0, int z0) {
  const bool px = p >= 0 && p < nx;
  const float* plane = u + (px ? static_cast<long long>(p) * ny * nz : 0LL);
  if (kVec) {
    constexpr int kChunks = kRow / 4;
    for (int t = threadIdx.x; t < kRows * kChunks; t += kThreads) {
      const int r = t / kChunks, q = t - r * kChunks;
      const int y = y0 - 1 + r, z = z0 - 4 + 4 * q;
      const bool ok = px && y >= 0 && y < ny && z >= 0 && z < nz;
      copy16(buf + r * kRow + 4 * q, ok ? plane + static_cast<long long>(y) * nz + z : u, ok);
    }
  } else {
    constexpr int kCols = kTz + 2;
    for (int t = threadIdx.x; t < kRows * kCols; t += kThreads) {
      const int r = t / kCols, q = t - r * kCols;
      const int y = y0 - 1 + r, z = z0 - 1 + q;
      const bool ok = px && y >= 0 && y < ny && z >= 0 && z < nz;
      copy4(buf + r * kRow + 3 + q, ok ? plane + static_cast<long long>(y) * nz + z : u, ok);
    }
  }
}

__device__ __forceinline__ float4 load4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

__device__ __forceinline__ float stencil(float c, float xm, float xp, float ym, float yp,
                                         float zm, float zp, float nu, float keep) {
  float lap = __fadd_rn(xm, xp);
  lap = __fadd_rn(lap, ym);
  lap = __fadd_rn(lap, yp);
  lap = __fadd_rn(lap, zm);
  lap = __fadd_rn(lap, zp);
  lap = __fsub_rn(lap, __fmul_rn(6.0f, c));
  return __fadd_rn(__fmul_rn(c, keep), __fmul_rn(nu, lap));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    diffusion3d_kernel(const float* __restrict__ u, float* __restrict__ out, int nx, int ny,
                       int nz, int tiles_y, int tiles_z, int run, float nu, float keep) {
  __shared__ __align__(16) float ring[kStages * kPlane];
  const long long field = static_cast<long long>(blockIdx.y) * nx * ny * nz;
  u += field;
  out += field;
  int b = blockIdx.x;
  const int tz = b % tiles_z;
  b /= tiles_z;
  const int ty = b % tiles_y;
  const int x0 = (b / tiles_y) * run;
  const int x1 = min(nx, x0 + run);
  const int y0 = ty * kTy, z0 = tz * kTz;
  const int planes = x1 - x0 + 2;  // x0 - 1 .. x1, the ring's sequence
  const int ly = threadIdx.x / (kTz / 4), lz = 4 * (threadIdx.x % (kTz / 4));
  const int y = y0 + ly, z = z0 + lz;
  const int at = (ly + 1) * kRow + 4 + lz;  // (y, z) in a staged plane

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < planes) stage_plane<kVec>(ring + k * kPlane, u, x0 - 1 + k, nx, ny, nz, y0, z0);
    commit();
  }
  wait_ring();  // planes x0 - 1 and x0 have landed
  float4 xm = load4(ring + at);
  float4 c = load4(ring + kPlane + at);
  const long long plane = static_cast<long long>(ny) * nz;
  for (int j = 0, x = x0; x < x1; ++j, ++x) {
    // Plane x + kStages - 2 into the buffer plane x - 1 left.
    const int ahead = j + kStages - 1;
    if (ahead < planes)
      stage_plane<kVec>(ring + (ahead % kStages) * kPlane, u, x0 - 1 + ahead, nx, ny, nz, y0, z0);
    commit();
    wait_ring();  // planes x and x + 1 have landed
    const float* cur = ring + ((j + 1) % kStages) * kPlane;
    const float4 xp = load4(ring + ((j + 2) % kStages) * kPlane + at);
    const float4 ym = load4(cur + at - kRow);
    const float4 yp = load4(cur + at + kRow);
    const float zm = cur[at - 1], zp = cur[at + 4];
    float4 o;
    o.x = stencil(c.x, xm.x, xp.x, ym.x, yp.x, zm, c.y, nu, keep);
    o.y = stencil(c.y, xm.y, xp.y, ym.y, yp.y, c.x, c.z, nu, keep);
    o.z = stencil(c.z, xm.z, xp.z, ym.z, yp.z, c.y, c.w, nu, keep);
    o.w = stencil(c.w, xm.w, xp.w, ym.w, yp.w, c.z, zp, nu, keep);
    if (y < ny && z < nz) {
      float* dst = out + x * plane + static_cast<long long>(y) * nz + z;
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        dst[0] = o.x;
        if (z + 1 < nz) dst[1] = o.y;
        if (z + 2 < nz) dst[2] = o.z;
        if (z + 3 < nz) dst[3] = o.w;
      }
    }
    xm = c;
    c = xp;
  }
}

}  // namespace

extern "C" int diffusion3d_launch(int device, const void* u, void* out, int slots, int nx,
                                  int ny, int nz, float nu, float keep, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots <= 0 || nx <= 0 || ny <= 0 || nz <= 0) return static_cast<int>(cudaSuccess);
  if (slots > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_y = (ny + kTy - 1) / kTy, tiles_z = (nz + kTz - 1) / kTz;
  const long long want = static_cast<long long>(sms) * kBlocksPerSm;
  const long long tiles = tiles_y * tiles_z * slots;
  long long runs = (want + tiles - 1) / tiles;
  runs = runs < 1 ? 1 : (runs > nx ? nx : runs);
  const int run = static_cast<int>((nx + runs - 1) / runs);
  runs = (nx + run - 1) / run;
  const long long blocks = runs * tiles_y * tiles_z;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slots));
  const bool vec = nz % 4 == 0 && (reinterpret_cast<size_t>(u) & 15) == 0 &&
                   (reinterpret_cast<size_t>(out) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(u);
  float* dst = static_cast<float*>(out);
  if (vec) {
    diffusion3d_kernel<true><<<grid, kThreads, 0, st>>>(
        src, dst, nx, ny, nz, static_cast<int>(tiles_y), static_cast<int>(tiles_z), run, nu,
        keep);
  } else {
    diffusion3d_kernel<false><<<grid, kThreads, 0, st>>>(
        src, dst, nx, ny, nz, static_cast<int>(tiles_y), static_cast<int>(tiles_z), run, nu,
        keep);
  }
  return static_cast<int>(cudaGetLastError());
}
