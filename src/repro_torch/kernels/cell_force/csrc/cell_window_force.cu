// Eq 4.1 contact force by Morton windows: each query tile of `block` rows of
// the layout-sorted pool against the rows of the window blocks
// tile - half_window .. tile + half_window that exist, pairs masked by 27-box
// adjacency decoded from the cell ids, by liveness (cell id >= n_cells is dead)
// and by row identity (no self-pair).
//
// Replaces: src/repro/kernels/cell_force/kernel.py:cell_window_force_planar (the
// Pallas _window_force_kernel).  That kernel wants a padded (4, C) planar copy
// of x, y, z, radius and a (1, C) cell-id row, so that TPU BlockSpecs can DMA
// contiguous (4, block) tiles, and its grid walks (tiles, 2 * half_window + 1)
// in order, accumulating into the output tile and masking window blocks that
// fall off either end.  Here the inputs and the output stay in agent order, as
// ops.cell_window_force has them; no planar copy is built, and the rows past C
// (the reference's padding) are simply dead.
//
// Design: two passes in one launch call.
//  1. block_bbox: one CUDA block per storage block of `block` rows computes the
//     bounding box of the live rows' decoded cell coordinates (empty: min >
//     max).
//  2. window_force: one CUDA block per query tile, one thread per query row.
//     The block walks the window blocks jv = tile + w - half_window in order,
//     skipping those outside [0, nbw) (the reference masks them) and those
//     whose bounding box, widened by one box, misses the query tile's: no pair
//     between the two can be 27-box adjacent, so the skip changes no result.
//     A kept block's x, y, z, radius and decoded cell coordinates are staged in
//     shared memory once, so the integer divisions happen once per agent, not
//     once per pair.  Each thread then tests adjacency, liveness and row
//     identity before any float work, and sums its pairs sequentially.  Each
//     row is written once by its own thread: no atomics, a fixed sum order.
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:259-269),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
// The reference sums each window block with jnp.sum and then across blocks;
// parity is to float tolerance.
//
// Bound on this card: the work the inputs need is the true 27-box pairs (about
// 8.5e6 at the spheroid's 100,000 cells, ~20 f32 operations each) and one read
// of 20 bytes per row plus 12 bytes of output: microseconds either way.  The
// reference's sweep is (2 * half_window + 1) * block^2 pair tests per tile,
// which at the covering window of a Z-sorted pool (about half the pool) is
// ~1e10 adjacency tests; the bounding-box skip removes the window blocks that
// are spatially far from the tile, which is most of them, and leaves the pair
// tests of the blocks that straddle the curve's seams.
#include <climits>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool decode_live(int cid, int ny, int nz, int n_cells, int* x,
                                            int* y, int* z) {
  if (cid < 0 || cid >= n_cells) return false;
  *x = cid / (ny * nz);
  *y = (cid / nz) % ny;
  *z = cid % nz;
  return true;
}

__global__ void block_bbox_kernel(const int* __restrict__ cell, int c, int ny, int nz,
                                  int n_cells, int* __restrict__ bbox) {
  __shared__ int box[6];
  for (int i = threadIdx.x; i < 6; i += blockDim.x) box[i] = i < 3 ? INT_MAX : INT_MIN;
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int x, y, z;
  if (row < c && decode_live(cell[row], ny, nz, n_cells, &x, &y, &z)) {
    atomicMin(&box[0], x);
    atomicMin(&box[1], y);
    atomicMin(&box[2], z);
    atomicMax(&box[3], x);
    atomicMax(&box[4], y);
    atomicMax(&box[5], z);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6; i += blockDim.x) bbox[6 * blockIdx.x + i] = box[i];
}

__device__ __forceinline__ bool boxes_touch(const int* a, const int* b) {
  // Empty boxes (min > max) touch nothing; otherwise the widened boxes overlap.
  if (a[0] > a[3] || b[0] > b[3]) return false;
  for (int d = 0; d < 3; ++d) {
    if (b[d] > a[3 + d] + 1 || b[3 + d] < a[d] - 1) return false;
  }
  return true;
}

__global__ void window_force_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ rad,
                                    const int* __restrict__ cell, int ny, int nz,
                                    int n_cells, int c, int bw, int nbw, int h, float k,
                                    float gamma, const int* __restrict__ bbox,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* wx = smem;
  float* wy = wx + bw;
  float* wz = wy + bw;
  float* wr = wz + bw;
  int* wcx = reinterpret_cast<int*>(wr + bw);
  int* wcy = wcx + bw;
  int* wcz = wcy + bw;  // dead rows: wcx = INT_MIN / 2, never adjacent

  const int tile = blockIdx.x;
  const long long q = static_cast<long long>(tile) * bw + threadIdx.x;
  int qcx = 0, qcy = 0, qcz = 0;
  const bool qlive = q < c && decode_live(cell[q], ny, nz, n_cells, &qcx, &qcy, &qcz);
  float qx = 0.f, qy = 0.f, qz = 0.f, qr = 0.f;
  if (qlive) {
    qx = pos[3 * q];
    qy = pos[3 * q + 1];
    qz = pos[3 * q + 2];
    qr = rad[q];
  }
  const int* qbox = bbox + 6 * tile;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int w = 0; w <= 2 * h; ++w) {
    const long long jv = static_cast<long long>(tile) + w - h;
    if (jv < 0 || jv >= nbw) continue;           // the reference's ok_w mask
    if (!boxes_touch(qbox, bbox + 6 * jv)) continue;  // uniform across the block
    __syncthreads();                             // the previous block is consumed
    const long long r = jv * bw + threadIdx.x;
    int x = INT_MIN / 2, y = 0, z = 0;
    if (r < c && decode_live(cell[r], ny, nz, n_cells, &x, &y, &z)) {
      wx[threadIdx.x] = pos[3 * r];
      wy[threadIdx.x] = pos[3 * r + 1];
      wz[threadIdx.x] = pos[3 * r + 2];
      wr[threadIdx.x] = rad[r];
    } else {
      x = INT_MIN / 2;
    }
    wcx[threadIdx.x] = x;
    wcy[threadIdx.x] = y;
    wcz[threadIdx.x] = z;
    __syncthreads();
    if (!qlive) continue;
    const long long base = jv * bw;
    for (int t = 0; t < bw; ++t) {
      if (abs(wcx[t] - qcx) > 1 || abs(wcy[t] - qcy) > 1 || abs(wcz[t] - qcz) > 1) continue;
      if (base + t == q) continue;
      const float sr = wr[t];
      const float dxc = __fsub_rn(qx, wx[t]);
      const float dyc = __fsub_rn(qy, wy[t]);
      const float dzc = __fsub_rn(qz, wz[t]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc)), __fmul_rn(dzc, dzc)),
          1e-20f);
      const float dist = __fsqrt_rn(d2);
      const float delta = __fsub_rn(__fadd_rn(qr, sr), dist);
      if (!(delta > 0.f)) continue;
      const float rbar = __fdiv_rn(__fmul_rn(qr, sr), fmaxf(__fadd_rn(qr, sr), 1e-20f));
      const float mag = __fsub_rn(
          __fmul_rn(k, delta),
          __fmul_rn(gamma, __fsqrt_rn(fmaxf(__fmul_rn(rbar, delta), 0.f))));
      const float scale = __fdiv_rn(mag, dist);
      fx = __fadd_rn(fx, __fmul_rn(scale, dxc));
      fy = __fadd_rn(fy, __fmul_rn(scale, dyc));
      fz = __fadd_rn(fz, __fmul_rn(scale, dzc));
    }
  }
  if (qlive) {
    out[3 * q] = fx;
    out[3 * q + 1] = fy;
    out[3 * q + 2] = fz;
  }
}

}  // namespace

extern "C" int cell_window_force_launch(int device, const void* pos, const void* rad,
                                        const void* cell, int nx, int ny, int nz, int c,
                                        int bw, int h, float k, float gamma, void* bbox,
                                        void* out, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_cells = nx * ny * nz;
  const int nbw = (c + bw - 1) / bw;
  if (nbw == 0) return static_cast<int>(cudaGetLastError());
  block_bbox_kernel<<<nbw, bw, 0, st>>>(static_cast<const int*>(cell), c, ny, nz, n_cells,
                                        static_cast<int*>(bbox));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shared = static_cast<size_t>(bw) * (4 * sizeof(float) + 3 * sizeof(int));
  window_force_kernel<<<nbw, bw, shared, st>>>(
      static_cast<const float*>(pos), static_cast<const float*>(rad),
      static_cast<const int*>(cell), ny, nz, n_cells, c, bw, nbw, h, k, gamma,
      static_cast<const int*>(bbox), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
