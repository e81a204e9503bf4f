// Eq 4.1 contact force on every agent listed in the cell list, summed over the
// other listed agents of its 27-box neighbourhood.
//
// Replaces: src/repro/kernels/cell_force/kernel.py:cell_list_force_planar (the
// Pallas _cell_force_kernel).  That kernel needs a cell-major, component-planar
// copy of the pool, (3, n_cols + 2(ny+1), nz, M), so that TPU BlockSpecs can
// fetch one (x, y) column per grid step, and it evaluates all M x M slot pairs
// of every box, empty or not.  Here the inputs and the output stay in agent
// order, as ops.cell_list_force has them; no planar layout is built.
//
// Design: one thread per box of the grid.  The thread walks its own row of the
// cell list; for each agent q listed there it loops over the 27 neighbour boxes
// (boxes outside the grid are skipped; no wrap-around) and over each
// neighbour row, skipping q itself by agent id.  It relies on the build's
// layout of a row: slots 0..count-1 are filled and the rest hold the sentinel
// S (grid.build_index_arrays scatters agent ids to cell * M + rank with rank
// 0, 1, 2, ...).  So every row walk stops at the first sentinel.  Every agent
// sits in at most one slot, so the result is a plain store to out[q]: no
// atomics, and the order of every sum is fixed.  Rows not listed stay zero (the
// wrapper zero-fills the output); sources q >= num_out are read but not written.
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:137-149),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
//
// Bound on this card: bytes.  At the main path's shape (10^6 boxes, M = 64,
// 600,000 agents, ~16 pair evaluations per agent) a thread touches the first
// 32-byte sector of 27 rows (mostly L1/L2 hits, ~32 MB of the 256 MB cell list
// from DRAM), 16 bytes of position/radius per listed neighbour and 12 bytes of
// output: about 49 MB, ~15 us at 3.35 TB/s.  A kernel that read all 64 slots of
// every row would move 256 MB.  The pair arithmetic (~10^7 evaluations) is far
// below the card's f32 rate.  Scattered 4-byte reads of positions are the next
// cost; staging a column of boxes in shared memory is later work.
#include <cuda_runtime.h>

namespace {

__global__ void cell_list_force_kernel(const float* __restrict__ pos,
                                       const float* __restrict__ rad,
                                       const int* __restrict__ cell_list,
                                       int nx, int ny, int nz, int m, int s_rows,
                                       int num_out, float k, float gamma,
                                       float* __restrict__ out) {
  long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long n_cells = static_cast<long long>(nx) * ny * nz;
  if (c >= n_cells) return;
  int cz = static_cast<int>(c % nz);
  int cy = static_cast<int>((c / nz) % ny);
  int cx = static_cast<int>(c / (static_cast<long long>(nz) * ny));
  const int* row = cell_list + c * m;
  for (int s = 0; s < m; ++s) {
    int q = row[s];
    if (q < 0 || q >= s_rows) break;  // first sentinel: the rest of the row is empty
    float qx = pos[3 * q], qy = pos[3 * q + 1], qz = pos[3 * q + 2];
    float qr = rad[q];
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int ox = -1; ox <= 1; ++ox) {
      int x = cx + ox;
      if (x < 0 || x >= nx) continue;
      for (int oy = -1; oy <= 1; ++oy) {
        int y = cy + oy;
        if (y < 0 || y >= ny) continue;
        for (int oz = -1; oz <= 1; ++oz) {
          int z = cz + oz;
          if (z < 0 || z >= nz) continue;
          const int* nrow =
              cell_list + ((static_cast<long long>(x) * ny + y) * nz + z) * m;
          for (int t = 0; t < m; ++t) {
            int j = nrow[t];
            if (j < 0 || j >= s_rows) break;
            if (j == q) continue;
            float sr = rad[j];
            float dxc = __fsub_rn(qx, pos[3 * j]);
            float dyc = __fsub_rn(qy, pos[3 * j + 1]);
            float dzc = __fsub_rn(qz, pos[3 * j + 2]);
            float d2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dxc, dxc),
                                                     __fmul_rn(dyc, dyc)),
                                           __fmul_rn(dzc, dzc)),
                                 1e-20f);
            float dist = __fsqrt_rn(d2);
            float delta = __fsub_rn(__fadd_rn(qr, sr), dist);
            if (!(delta > 0.f)) continue;
            float rbar = __fdiv_rn(__fmul_rn(qr, sr), fmaxf(__fadd_rn(qr, sr), 1e-20f));
            float mag = __fsub_rn(
                __fmul_rn(k, delta),
                __fmul_rn(gamma, __fsqrt_rn(fmaxf(__fmul_rn(rbar, delta), 0.f))));
            float scale = __fdiv_rn(mag, dist);
            fx = __fadd_rn(fx, __fmul_rn(scale, dxc));
            fy = __fadd_rn(fy, __fmul_rn(scale, dyc));
            fz = __fadd_rn(fz, __fmul_rn(scale, dzc));
          }
        }
      }
    }
    if (q < num_out) {
      out[3 * q] = fx;
      out[3 * q + 1] = fy;
      out[3 * q + 2] = fz;
    }
  }
}

}  // namespace

extern "C" int cell_list_force_launch(int device, const void* pos, const void* rad,
                                      const void* cell_list, int nx, int ny, int nz,
                                      int m, int s_rows, int num_out, float k,
                                      float gamma, void* out, void* stream) {
  cudaSetDevice(device);
  long long n_cells = static_cast<long long>(nx) * ny * nz;
  const int threads = 256;
  unsigned blocks = static_cast<unsigned>((n_cells + threads - 1) / threads);
  if (blocks > 0) {
    cell_list_force_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(rad),
        static_cast<const int*>(cell_list), nx, ny, nz, m, s_rows, num_out, k, gamma,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
