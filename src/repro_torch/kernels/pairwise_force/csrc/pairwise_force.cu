// Eq 4.1 contact force on every query agent, summed over its dense candidate
// set: cand (N, K) ids into the source arrays, cand_mask (N, K).
//
// Replaces: src/repro/kernels/pairwise_force/kernel.py:pairwise_force_planar
// (the Pallas _force_kernel).  That kernel takes candidate positions already
// gathered by XLA into (3, N, K) and padded to (128, 128) tiles, because TPU
// BlockSpecs can only fetch rectangular tiles; the gather alone writes and
// reads 12 bytes per candidate slot.  Here the kernel reads the ids and the
// mask and gathers each masked-in source's position and radius itself, so no
// (N, K, 3) tensor and no planar copy exist.
//
// Design: one warp per query row.  The lanes stride over the row's K slots
// (coalesced reads of the ids and the mask), skip masked-out slots before any
// load of the source, and evaluate the pair.  The three partial sums are
// reduced with __shfl_down_sync and lane 0 stores the row: no atomics, a
// fixed sum order.  Sources may be longer than the queries (the distributed
// engine's ghost-extended arrays).
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:65-74),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
//
// Bound on this card: bytes.  Every slot's id (4 B) and mask (1 B) is read
// once: at the dense path's shape (131,072 queries, K = 27 * 96 = 2,592) that
// is 1.7 GB, about 0.5 ms at 3.35 TB/s, against about 8.5e6 pair evaluations
// of ~20 f32 operations.  The kernel streams the two arrays once with
// coalesced warp reads; the gathers of the few masked-in sources hit L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pairwise_force_kernel(const float* __restrict__ pos,
                                      const float* __restrict__ rad,
                                      const int* __restrict__ cand,
                                      const uint8_t* __restrict__ cand_mask,
                                      const float* __restrict__ src_pos,
                                      const float* __restrict__ src_rad, int n, int kdim,
                                      float k, float gamma, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;  // whole warps exit together
  const float qx = pos[3 * row], qy = pos[3 * row + 1], qz = pos[3 * row + 2];
  const float qr = rad[row];
  const int* ids = cand + row * kdim;
  const uint8_t* mask = cand_mask + row * kdim;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int t = lane; t < kdim; t += 32) {
    if (!mask[t]) continue;
    const int j = ids[t];
    const float sr = src_rad[j];
    const float dxc = __fsub_rn(qx, src_pos[3 * j]);
    const float dyc = __fsub_rn(qy, src_pos[3 * j + 1]);
    const float dzc = __fsub_rn(qz, src_pos[3 * j + 2]);
    const float d2 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc)), __fmul_rn(dzc, dzc)),
        1e-20f);
    const float dist = __fsqrt_rn(d2);
    const float delta = __fsub_rn(__fadd_rn(qr, sr), dist);
    if (!(delta > 0.f)) continue;
    const float rbar = __fdiv_rn(__fmul_rn(qr, sr), fmaxf(__fadd_rn(qr, sr), 1e-20f));
    const float mag = __fsub_rn(
        __fmul_rn(k, delta), __fmul_rn(gamma, __fsqrt_rn(fmaxf(__fmul_rn(rbar, delta), 0.f))));
    const float scale = __fdiv_rn(mag, dist);
    fx = __fadd_rn(fx, __fmul_rn(scale, dxc));
    fy = __fadd_rn(fy, __fmul_rn(scale, dyc));
    fz = __fadd_rn(fz, __fmul_rn(scale, dzc));
  }
  for (int off = 16; off > 0; off >>= 1) {
    fx = __fadd_rn(fx, __shfl_down_sync(0xffffffffu, fx, off));
    fy = __fadd_rn(fy, __shfl_down_sync(0xffffffffu, fy, off));
    fz = __fadd_rn(fz, __shfl_down_sync(0xffffffffu, fz, off));
  }
  if (lane == 0) {
    out[3 * row] = fx;
    out[3 * row + 1] = fy;
    out[3 * row + 2] = fz;
  }
}

}  // namespace

extern "C" int pairwise_force_launch(int device, const void* pos, const void* rad,
                                     const void* cand, const void* cand_mask,
                                     const void* src_pos, const void* src_rad, int n,
                                     int kdim, float k, float gamma, void* out,
                                     void* stream) {
  cudaSetDevice(device);
  const int threads = 256;  // 8 query rows per block
  const long long warps = static_cast<long long>(n);
  const unsigned blocks = static_cast<unsigned>((warps * 32 + threads - 1) / threads);
  if (blocks > 0) {
    pairwise_force_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(rad),
        static_cast<const int*>(cand), static_cast<const uint8_t*>(cand_mask),
        static_cast<const float*>(src_pos), static_cast<const float*>(src_rad), n, kdim, k,
        gamma, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
