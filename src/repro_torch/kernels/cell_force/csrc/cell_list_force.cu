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
// What bounds it: bytes.  The function needs the first 32-byte sector of each
// row (the occupied slots and the first sentinel: ~32 MB of the 256 MB), 16
// bytes of position and radius per listed agent and 12 bytes of output: ~49 MB
// at the main path's shape (10^6 boxes, M = 64, 600,000 agents, 0.6 a box),
// ~15 us at 3.35 TB/s; the pair arithmetic (~10^7 evaluations) is far below
// the card's f32 rate.  A thread per box falls far short of that on latency:
// most threads idle in empty boxes, and every agent walks 27 neighbour rows,
// each a chain of two dependent global loads (the slot, then that agent's
// position), while its neighbours re-read the same rows and positions.
//
// Design: one CUDA block per tile of tx x ty x tz boxes (z fastest, as in the
// linear cell id; dims need not be multiples of the tile).
//  1. Count: the block reads the cell-list rows of the tile and of a one-box
//     halo, each up to its first sentinel (the build fills slots 0..count-1 of
//     a row, grid.build_index_arrays), into shared counts; boxes outside the
//     grid count 0, so they are skipped with no wrap-around.
//  2. Scan the halo's counts (offsets into the staging area) and the interior
//     boxes' counts (a thread -> query map), in shared memory.
//  3. Stage: when the halo holds at most `budget` agents, one thread per listed
//     agent copies its id, x, y, z and radius into shared memory, compactly.
//     The values are gathered by agent id, 4 bytes at a time, so there is no
//     contiguous tile for cp.async or TMA to copy; the other resident blocks
//     hide the gather's latency.
//  4. Compute: one thread per listed agent of the interior boxes,
//     block-strided.  Each walks its 27 neighbour boxes in (ox, oy, oz) order
//     and their slots in order, skipping itself by agent id, all from shared
//     memory, and stores out[q] for q < num_out.  A crowded tile (more than
//     `budget` agents in its halo) takes the same walk from global memory in
//     this kernel, with the same counts: an exact path, counted in `crowded`.
// Every agent sits in at most one slot, so the result is a plain store: no
// atomics, and the order of every sum is fixed: the thread-per-box walk's, bit
// for bit.  Rows not listed stay zero (the wrapper zero-fills the output);
// sources q >= num_out are read but not written.
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:137-149),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
//
// Slots: a batch of B sessions, each with its own grid, runs in one launch.
// blockIdx.y is the session: its cell list (n_cells rows of M within-session
// ids, sentinel s_rows), its s_rows agents and its num_out output rows sit
// at offsets of b * n_cells * M, b * s_rows and b * num_out in the stacked
// arrays.  A block reads only its own session's rows and agents, so the
// neighbour walk never leaves the session, and each session's output is what
// a launch over that session alone gives, bit for bit.  A solo launch takes
// an instantiation without the offsets: holding the four offset pointers
// costs the kernel 13 registers, which would cost a solo launch a block per
// multiprocessor.
//
// What remains: each halo row and agent is read once per tile that sees it
// (about 2.5x the function's bytes for a 4 x 4 x 16 tile, mostly from L2), and
// about half of the time is the round-to-nearest square roots and divisions of
// the pairs, with lanes idle where a warp's agents have unequal pair counts
// (scripts/ablate_force_kernels.py times the parts).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive prefix sum of a[0..n) in shared memory, in place; returns the
// total.  `red` is 33 ints of shared scratch.  Every thread of the block
// calls it (it synchronises); blockDim.x is a multiple of 32.
__device__ int block_exclusive_scan(int* a, int n, int* red) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int b = min(n, static_cast<int>(threadIdx.x) * per);
  const int e = min(n, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    const int w = lane < n_warps ? red[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += v;
    }
    if (lane < n_warps) red[lane] = wi - w;
    if (lane == 31) red[32] = wi;
  }
  __syncthreads();
  int run = red[warp] + incl - sum;
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = red[32];
  __syncthreads();
  return total;
}

// The largest i in [0, n) with a[i] <= v (a ascending, a[0] = 0 <= v).
__device__ __forceinline__ int last_at_most(const int* a, int n, int v) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void add_pair(float qx, float qy, float qz, float qr, float4 s,
                                         float k, float gamma, float& fx, float& fy,
                                         float& fz) {
  const float dxc = __fsub_rn(qx, s.x);
  const float dyc = __fsub_rn(qy, s.y);
  const float dzc = __fsub_rn(qz, s.z);
  const float d2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc)), __fmul_rn(dzc, dzc)),
      1e-20f);
  const float dist = __fsqrt_rn(d2);
  const float delta = __fsub_rn(__fadd_rn(qr, s.w), dist);
  if (!(delta > 0.f)) return;
  const float rbar = __fdiv_rn(__fmul_rn(qr, s.w), fmaxf(__fadd_rn(qr, s.w), 1e-20f));
  const float mag = __fsub_rn(
      __fmul_rn(k, delta), __fmul_rn(gamma, __fsqrt_rn(fmaxf(__fmul_rn(rbar, delta), 0.f))));
  const float scale = __fdiv_rn(mag, dist);
  fx = __fadd_rn(fx, __fmul_rn(scale, dxc));
  fy = __fadd_rn(fy, __fmul_rn(scale, dyc));
  fz = __fadd_rn(fz, __fmul_rn(scale, dzc));
}

__device__ __forceinline__ float4 agent(const float* __restrict__ pos,
                                        const float* __restrict__ rad, int j) {
  return make_float4(__ldg(&pos[3 * j]), __ldg(&pos[3 * j + 1]), __ldg(&pos[3 * j + 2]),
                     __ldg(&rad[j]));
}

template <bool kSlots>
__global__ void __launch_bounds__(kThreads)
    cell_list_force_kernel(const float* __restrict__ pos, const float* __restrict__ rad,
                           const int* __restrict__ cell_list, int nx, int ny, int nz, int m,
                           int s_rows, int num_out, float k, float gamma, int tx, int ty,
                           int tz, int budget, int* __restrict__ crowded,
                           float* __restrict__ out) {
  extern __shared__ float4 smem[];
  if (kSlots) {
    const long long b = blockIdx.y;
    pos += b * s_rows * 3;
    rad += b * s_rows;
    cell_list += b * nx * ny * static_cast<long long>(nz) * m;
    out += b * num_out * 3;
  }
  const int hy = ty + 2, hz = tz + 2;
  const int nh = (tx + 2) * hy * hz;  // halo boxes
  const int ni = tx * ty * tz;        // interior boxes
  float4* s_agent = smem;                              // [budget] x, y, z, radius
  int* s_id = reinterpret_cast<int*>(smem + budget);   // [budget] agent ids
  int* cnt = s_id + budget;                            // [nh] listed agents a box
  int* off = cnt + nh;                                 // [nh] staging offsets
  int* ipre = off + nh;                                // [ni] interior prefix
  int* red = ipre + ni;                                // [33] scan scratch

  // The halo's origin in grid coordinates (one box before the tile).
  const int ntz = (nz + tz - 1) / tz, nty = (ny + ty - 1) / ty;
  const int bz = blockIdx.x % ntz, by = (blockIdx.x / ntz) % nty, bx = blockIdx.x / (ntz * nty);
  const int x0 = bx * tx - 1, y0 = by * ty - 1, z0 = bz * tz - 1;
  // Linear cell id of halo box i (in the grid whenever its count is > 0).
  auto cell_of = [&](int i) {
    return (static_cast<long long>(x0 + i / (hy * hz)) * ny + (y0 + (i / hz) % hy)) * nz +
           (z0 + i % hz);
  };

  // 1. Count each halo row up to its first sentinel.
  for (int i = threadIdx.x; i < nh; i += blockDim.x) {
    const int x = x0 + i / (hy * hz), y = y0 + (i / hz) % hy, z = z0 + i % hz;
    int n = 0;
    if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz) {
      const int* row = cell_list + cell_of(i) * m;
      while (n < m) {
        const int j = __ldg(&row[n]);
        if (j < 0 || j >= s_rows) break;
        ++n;
      }
    }
    cnt[i] = n;
    off[i] = n;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ni; i += blockDim.x) {
    const int ix = i / (ty * tz), iy = (i / tz) % ty, iz = i % tz;
    ipre[i] = cnt[((ix + 1) * hy + iy + 1) * hz + iz + 1];
  }
  __syncthreads();

  // 2. Offsets of the halo's agents, and the interior's thread -> query map.
  const int total = block_exclusive_scan(off, nh, red);
  const int n_query = block_exclusive_scan(ipre, ni, red);
  const bool staged = total <= budget;

  // 3. Stage the halo's agents.
  if (staged) {
    for (int a = threadIdx.x; a < total; a += blockDim.x) {
      const int i = last_at_most(off, nh, a);
      const int j = __ldg(&cell_list[cell_of(i) * m + (a - off[i])]);
      s_id[a] = j;
      s_agent[a] = agent(pos, rad, j);
    }
  } else if (threadIdx.x == 0) {
    atomicAdd(crowded, 1);
  }
  __syncthreads();

  // 4. One thread per listed agent of the interior.
  for (int t = threadIdx.x; t < n_query; t += blockDim.x) {
    const int ib = last_at_most(ipre, ni, t);
    const int slot = t - ipre[ib];
    const int ix = ib / (ty * tz), iy = (ib / tz) % ty, iz = ib % tz;
    const int hb = ((ix + 1) * hy + iy + 1) * hz + iz + 1;
    int q;
    float4 qa;
    if (staged) {
      q = s_id[off[hb] + slot];
      qa = s_agent[off[hb] + slot];
    } else {
      q = __ldg(&cell_list[cell_of(hb) * m + slot]);
      qa = agent(pos, rad, q);
    }
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int ox = -1; ox <= 1; ++ox) {
      for (int oy = -1; oy <= 1; ++oy) {
        for (int oz = -1; oz <= 1; ++oz) {
          const int nb = hb + (ox * hy + oy) * hz + oz;
          const int n = cnt[nb];
          if (n == 0) continue;
          if (staged) {
            const int base = off[nb];
            for (int u = 0; u < n; ++u) {
              if (s_id[base + u] == q) continue;
              add_pair(qa.x, qa.y, qa.z, qa.w, s_agent[base + u], k, gamma, fx, fy, fz);
            }
          } else {
            const int* row = cell_list + cell_of(nb) * m;
            for (int u = 0; u < n; ++u) {
              const int j = __ldg(&row[u]);
              if (j == q) continue;
              add_pair(qa.x, qa.y, qa.z, qa.w, agent(pos, rad, j), k, gamma, fx, fy, fz);
            }
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

// Dynamic shared memory of one block for a tile and a staging budget.
long long shared_bytes(int tx, int ty, int tz, int budget) {
  const long long nh = static_cast<long long>(tx + 2) * (ty + 2) * (tz + 2);
  return static_cast<long long>(budget) * (sizeof(float4) + sizeof(int)) +
         (2 * nh + static_cast<long long>(tx) * ty * tz + 33) * sizeof(int);
}

}  // namespace

extern "C" int cell_list_force_launch(int device, int slots, const void* pos,
                                      const void* rad, const void* cell_list, int nx, int ny,
                                      int nz, int m, int s_rows, int num_out, float k,
                                      float gamma, int tx, int ty, int tz, int budget,
                                      void* crowded, void* out, void* stream) {
  cudaSetDevice(device);
  if (slots <= 0) return static_cast<int>(cudaGetLastError());
  if (slots > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = static_cast<long long>((nx + tx - 1) / tx) * ((ny + ty - 1) / ty) *
                           ((nz + tz - 1) / tz);
  const long long shared = shared_bytes(tx, ty, tz, budget);
  if (blocks > 0) {
    auto kernel = slots > 1 ? cell_list_force_kernel<true> : cell_list_force_kernel<false>;
    if (shared > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slots));
    kernel<<<grid, kThreads, static_cast<size_t>(shared),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(rad),
        static_cast<const int*>(cell_list), nx, ny, nz, m, s_rows, num_out, k, gamma, tx, ty,
        tz, budget, static_cast<int*>(crowded), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
