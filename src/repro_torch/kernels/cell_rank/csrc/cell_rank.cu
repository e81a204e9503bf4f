// Within-cell rank of every agent, index-ordered: rank[i] = #{j < i : cid[j] == cid[i]}.
//
// Replaces: src/repro/kernels/cell_rank/kernel.py:cell_rank_tiled (the Pallas
// _rank_kernel).  That kernel walks the agents in tiles on a *sequential* TPU
// grid and carries a running per-cell histogram of n_cells + 1 ints in VMEM
// from one tile to the next.  On Hopper neither half of that carries over:
// blocks run in no order, and at 100^3 boxes the histogram is 4 MB, far beyond
// the 227 KB of shared memory a block can use.
//
// Design (four passes, all O(C) but the last, which is O(sum of count^2)):
//   1. count_live:   per-cell live counts by atomicAdd (cid == n_cells is the
//                    dead-agent bin and is not counted);
//   2. (glue)        exclusive scan of the counts -> bucket offsets, and the
//                    exclusive prefix count of the dead mask, both torch.cumsum
//                    in the wrapper (the reference also scans outside Pallas);
//   3. fill_buckets: agent ids into per-cell buckets through atomic cursors.
//                    Atomics leave each bucket in arbitrary order, so...
//   4. rank_kernel:  one thread per agent counts the ids in its own bucket that
//                    are smaller than its own.  That is exact and independent
//                    of the bucket order.  Dead agents take their rank from the
//                    dead-mask prefix count: the dead bin can hold most of the
//                    pool and would cost O(dead^2) through a bucket.
//
// Bound on this card: bytes.  At the main path's shape (C = 600,000 agents,
// 10^6 boxes, <= 8 agents per box) the passes move cid (2.4 MB) a few times,
// the 4 MB counts/offsets/cursor tables, and rank (2.4 MB); the compute is a
// handful of compares per agent.  The kernels are launch-bound in practice.
// Cost of a huge live cell: pass 4 reads the whole bucket per agent, so one box
// holding K agents costs K^2 compares (K = 65,536 -> 4.3e9, tens of ms); the
// dense-sort-free alternative for such inputs is a later PR's work.
#include <cuda_runtime.h>

namespace {

__global__ void count_live(const int* __restrict__ cid, int n, int n_cells,
                           int* __restrict__ counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c = cid[i];
  if (c >= 0 && c < n_cells) atomicAdd(&counts[c], 1);
}

__global__ void fill_buckets(const int* __restrict__ cid, int n, int n_cells,
                             int* __restrict__ cursor, int* __restrict__ bucket) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c = cid[i];
  if (c >= 0 && c < n_cells) bucket[atomicAdd(&cursor[c], 1)] = i;
}

__global__ void rank_kernel(const int* __restrict__ cid, int n, int n_cells,
                            const int* __restrict__ offsets,
                            const int* __restrict__ counts,
                            const int* __restrict__ bucket,
                            const int* __restrict__ dead_prefix,
                            int* __restrict__ rank) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int c = cid[i];
  if (c == n_cells) {
    rank[i] = dead_prefix[i];
    return;
  }
  if (c < 0 || c > n_cells) {  // outside the documented domain [0, n_cells]
    rank[i] = -1;
    return;
  }
  const int* b = bucket + offsets[c];
  int cnt = counts[c];
  int r = 0;
  for (int t = 0; t < cnt; ++t) r += (b[t] < i);
  rank[i] = r;
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

extern "C" int cell_rank_count(int device, const void* cid, int n, int n_cells,
                               void* counts, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    count_live<<<blocks_for(n, 256), 256, 0, s>>>(
        static_cast<const int*>(cid), n, n_cells, static_cast<int*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cell_rank_finish(int device, const void* cid, int n, int n_cells,
                                const void* offsets, const void* counts,
                                void* cursor, void* bucket,
                                const void* dead_prefix, void* rank, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    fill_buckets<<<blocks_for(n, 256), 256, 0, s>>>(
        static_cast<const int*>(cid), n, n_cells, static_cast<int*>(cursor),
        static_cast<int*>(bucket));
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    rank_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
        static_cast<const int*>(cid), n, n_cells,
        static_cast<const int*>(offsets), static_cast<const int*>(counts),
        static_cast<const int*>(bucket), static_cast<const int*>(dead_prefix),
        static_cast<int*>(rank));
  }
  return static_cast<int>(cudaGetLastError());
}
