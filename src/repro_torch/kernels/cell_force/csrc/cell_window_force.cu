// Eq 4.1 contact force by Morton windows: each query row q of tile q / block
// against the rows of window blocks tile - half_window .. tile + half_window
// that exist, pairs masked by 27-box adjacency decoded from the cell ids, by
// liveness (a cell id outside [0, n_cells) is dead) and by row identity (no
// self-pair).  The function holds for any row order and any half-window.
//
// Replaces: src/repro/kernels/cell_force/kernel.py:cell_window_force_planar (the
// Pallas _window_force_kernel).  That kernel wants a padded (4, C) planar copy
// of x, y, z, radius and a (1, C) cell-id row, so that TPU BlockSpecs can DMA
// contiguous (4, block) tiles, and its grid sweeps all block x block row pairs
// of the (tiles, 2 * half_window + 1) window blocks, masking the pairs that are
// not 27-box neighbours.  Here the inputs and the output stay in agent order,
// as ops.cell_window_force has them; no planar copy is built, and the rows past
// C (the reference's padding) are simply dead.
//
// What bounds a sweep: its pair tests, not the memory.  A Z-sorted pool needs
// a covering half-window of about half the pool (neighbours across the curve's
// octant seams sit half a pool apart), so sweeping window blocks tests ~10^10
// pairs on the 100,000-cell spheroid to find ~8.3e6 true pairs.  The rows a query can
// pair with are only those of its 27 neighbour cells, and a cell's rows lie
// inside [first row, last row] of that cell, whatever the order.
//
// Design: two kernels in one launch call, after a fill of the span table.
//  1. cell_span: one thread per row; each live row takes an atomicMin into its
//     cell's (first, ~last) entry (~last = -last - 1, so that the last row is
//     a minimum too; the fill's 0x7F bytes are an empty span).
//  2. window_force: one thread per query row.  It clips each in-grid
//     neighbour cell's [first, last] to its window's rows
//     [max(0, (tile - h) * block), min(C, (tile + h + 1) * block)), then walks
//     the union of the clipped intervals in ascending row order: it picks the
//     interval with the lowest start above the rows already walked (a
//     selection over the 27 intervals, held in registers), walks it, and
//     repeats, so overlapping intervals are walked once.  A visited row whose
//     cell id is the interval's own cell is adjacent and live by
//     construction; any other row (an unsorted pool interleaves cells) is
//     decoded and tested.  Then row identity and the pair arithmetic, in
//     ascending row order: the order in which the sweep meets the same pairs.
//     Every row of a neighbour cell inside the window lies in its clipped
//     interval, so the walk meets every pair the sweep keeps, and the tests
//     drop the rest: the result is the sweep's, bit for bit.  Each row is
//     written once by its own thread (dead rows get zero): no atomics in the
//     sums, a fixed order.
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:259-269),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
// The reference sums each window block with jnp.sum and then across blocks;
// parity is to float tolerance.
//
// Slots: a batch of B pools, each with its own grid, runs in one launch.
// blockIdx.y is the pool: its c rows of position, radius and cell id, its
// output rows and its n_cells entries of the span table sit at offsets of
// b * c and b * n_cells in the stacked arrays, and its cell ids count within
// its own grid.  Rows, tiles and windows count within the pool, so a walk
// never leaves it, and each pool's output is what a launch over that pool
// alone gives, bit for bit.  A solo launch is the same kernel with one pool
// (zero offsets): unlike cell_list_force's, the offsets cost this kernel no
// register (93 in ptxas's report, one fewer than without them).
//
// Bound on this card: the function needs one read of 20 bytes per row and 12
// bytes of output, and ~20 f32 operations for each true 27-box pair: about a
// microsecond at the spheroid's shape.  What remains: the span table (8 bytes
// a cell, filled, set by the atomics and read back), the selection over the
// 27 intervals, each candidate row's cell id re-read from L1 / L2 (where the
// neighbouring queries of a sorted pool find it), and, for about half of the
// time, the round-to-nearest square roots and divisions of the pairs
// (scripts/ablate_force_kernels.py times the parts).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    cell_span_kernel(const int* __restrict__ cell, int c, int n_cells,
                     int2* __restrict__ span) {
  const long long b = blockIdx.y;
  cell += b * c;
  span += b * n_cells;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= c) return;
  const int cid = __ldg(&cell[r]);
  if (cid < 0 || cid >= n_cells) return;
  atomicMin(&span[cid].x, r);
  atomicMin(&span[cid].y, ~r);
}

__global__ void __launch_bounds__(kThreads)
    window_force_kernel(const float* __restrict__ pos, const float* __restrict__ rad,
                        const int* __restrict__ cell, const int2* __restrict__ span,
                        int nx, int ny, int nz, int c, int bw, int h, float k, float gamma,
                        float* __restrict__ out) {
  const int n_cells = nx * ny * nz;
  const long long b = blockIdx.y;
  pos += b * c * 3;
  rad += b * c;
  cell += b * c;
  span += b * n_cells;
  out += b * c * 3;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= c) return;
  const int nyz = ny * nz;
  const int qcid = __ldg(&cell[q]);
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (qcid >= 0 && qcid < n_cells) {
    const int qcx = qcid / nyz, qcy = (qcid / nz) % ny, qcz = qcid % nz;
    const float qx = __ldg(&pos[3 * q]), qy = __ldg(&pos[3 * q + 1]),
                qz = __ldg(&pos[3 * q + 2]), qr = __ldg(&rad[q]);
    const long long tile = q / bw;
    const int wlo = static_cast<int>(tile > h ? (tile - h) * bw : 0LL);
    const int whi = static_cast<int>(min(static_cast<long long>(c), (tile + h + 1) * bw));

    // The 27 neighbour cells' rows clipped to the window: [lo, hi), empty
    // when lo >= hi (no such cell in the grid, no live row, or all outside).
    int lo[27], hi[27];
#pragma unroll
    for (int n = 0; n < 27; ++n) {
      const int x = qcx + n / 9 - 1, y = qcy + (n / 3) % 3 - 1, z = qcz + n % 3 - 1;
      lo[n] = INT_MAX;
      hi[n] = 0;
      if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz) {
        const int2 s = __ldg(&span[(x * ny + y) * nz + z]);
        lo[n] = max(s.x, wlo);
        hi[n] = min(~s.y + 1, whi);
      }
    }

    int done = wlo;  // every row below it has been walked
    while (true) {
      int start = INT_MAX, end = 0, owner = 0;
#pragma unroll
      for (int n = 0; n < 27; ++n) {
        const int s = max(lo[n], done);
        if (s < hi[n] && s < start) {
          start = s;
          end = hi[n];
          owner = n;
        }
      }
      if (start == INT_MAX) break;
      const int own = qcid + ((owner / 9 - 1) * ny + (owner / 3) % 3 - 1) * nz + owner % 3 - 1;
      for (int r = start; r < end; ++r) {
        const int rc = __ldg(&cell[r]);
        if (rc != own) {  // a row of another cell inside the interval
          if (rc < 0 || rc >= n_cells) continue;
          if (abs(rc / nyz - qcx) > 1 || abs((rc / nz) % ny - qcy) > 1 ||
              abs(rc % nz - qcz) > 1)
            continue;
        }
        if (r == q) continue;
        const float sr = __ldg(&rad[r]);
        const float dxc = __fsub_rn(qx, __ldg(&pos[3 * r]));
        const float dyc = __fsub_rn(qy, __ldg(&pos[3 * r + 1]));
        const float dzc = __fsub_rn(qz, __ldg(&pos[3 * r + 2]));
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
      done = end;
    }
  }
  out[3 * q] = fx;
  out[3 * q + 1] = fy;
  out[3 * q + 2] = fz;
}

}  // namespace

// slots pools of c rows each (pos, rad, cell and out stacked); span: scratch
// of slots * n_cells int2, filled here.  Rows of a pool must number
// < 0x7F7F7F7F; slots at most 65,535 (the grid's y dimension).
extern "C" int cell_window_force_launch(int device, int slots, const void* pos,
                                        const void* rad, const void* cell, int nx, int ny,
                                        int nz, int c, int bw, int h, float k, float gamma,
                                        void* span, void* out, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_cells = nx * ny * nz;
  if (c == 0 || slots <= 0) return static_cast<int>(cudaGetLastError());
  if (slots > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((c + kThreads - 1) / kThreads),
                  static_cast<unsigned>(slots));
  cudaError_t err = cudaSuccess;
  if (n_cells > 0) {
    err = cudaMemsetAsync(span, 0x7F, static_cast<size_t>(slots) * n_cells * sizeof(int2), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    cell_span_kernel<<<grid, kThreads, 0, st>>>(static_cast<const int*>(cell), c, n_cells,
                                                static_cast<int2*>(span));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_force_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(pos), static_cast<const float*>(rad),
      static_cast<const int*>(cell), static_cast<const int2*>(span), nx, ny, nz, c, bw, h, k,
      gamma, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
