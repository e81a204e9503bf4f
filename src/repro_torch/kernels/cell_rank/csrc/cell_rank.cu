// Within-cell rank of every agent, index-ordered: rank[i] = #{j < i : cid[j] == cid[i]}.
//
// Replaces: src/repro/kernels/cell_rank/kernel.py:cell_rank_tiled (the Pallas
// _rank_kernel).  That kernel walks the agents in tiles on a *sequential* TPU
// grid and carries a running per-cell histogram of n_cells + 1 ints in VMEM
// from one tile to the next.  On Hopper neither half of that carries over:
// blocks run in no order, and at 100^3 boxes the histogram is 4 MB, far beyond
// the 227 KB of shared memory a block can use.
//
// What bounds it on this card: the function's bytes (ids read, ranks
// written) are a few MB at the main path's shapes (600,000 agents over 10^6
// boxes; 131,072 over 175,616), a microsecond or two at 3.35 TB/s.  An
// unsorted pool's ids are random over the cells, so each agent's visits to its
// cell's records are random 4- or 16-byte accesses, each a 32-byte sector in
// L2: at the soma shape about 600,000 of them cost some 10 us a kind
// (scripts/ablate_cell_rank.py).  The design keeps them few, keeps the passes
// and launches few, and leaves the host one call.  One call of
// cell_rank_launch enqueues one memset and three kernels on the caller's
// stream, and nothing else: no PyTorch op runs between the passes, every scan
// runs on the card, and all scratch lives in one workspace whose size depends
// on n and n_cells only (cell_rank_workspace_bytes; kernel.py computes the
// same size).
//
//  0. memset: per-cell counts, the counters, the crowded chunks' flags.
//  1. cell_rank_count (agent tiles of kAgentTile): each live agent takes
//     slot = atomicAdd(&count[cid], 1), its place among its cell's agents in
//     arrival order (the lanes of a warp in one cell share one atomic), and
//     writes its id into its cell's table row if slot < kRow; each tile
//     writes its number of dead agents (cid == n_cells).
//  2. cell_rank_alloc_fill, by ticket: the first block scans the tiles' dead
//     counts into each tile's exclusive prefix; the next blocks give each
//     cell of more than kRow agents a bucket (a block scan of a tile of
//     counts plus one atomicAdd on a bump cursor a tile: a bucket's place is
//     free, the ranks do not depend on it), copy its table row into it, and
//     queue the chunks of every crowded cell (more than kSmallCell agents);
//     the last blocks put each agent past its cell's table row into
//     bucket[offset[cid] + slot], once every bucket is placed.
//  3. cell_rank_rank: an agent alone in its cell has rank 0; an agent of a
//     cell of at most kRow counts the smaller ids in its 16-byte table row; of
//     a larger small cell, in its bucket.  A dead agent's rank is its tile's
//     dead prefix plus a block scan within the tile; an id outside
//     [0, n_cells] gets -1.  The first blocks take the crowded cells' chunks
//     of up to kChunk agents from the queue: each sorts its chunk in shared
//     memory and gives each agent its place in the sorted chunk (a rank is
//     the position in the sorted bucket, ids being distinct).  A cell of more
//     than one chunk writes its sorted chunks back and, in a second round
//     shared by kSplit blocks a chunk, adds for each agent the count of
//     smaller ids in every other sorted chunk, by binary search in shared
//     memory.  One box of 65,536 agents thus costs 32 sorts of 2,048 and
//     32 x 31 searched chunks in place of 4.3e9 compares through global
//     memory.
//
// The dead agents' prefix is a reduce-then-scan split over the three passes
// that exist anyway, and the buckets need no ordered scan at all.  Both
// scans by single-pass decoupled look-back were the first design: with every
// tile of the grid resident at once, each tile walked back to tile 0 in rounds
// of 32 predecessors (the count pass took 16.4 us at the soma shape, 12.7 us
// without).  A bucket for every cell (no table rows) then cost two random
// accesses an agent more: 34 us in pass 2 and 14 us in pass 3, against 7 and
// 13 us with the rows.  A cooperative kernel with grid.sync() was not chosen:
// it needs the whole grid co-resident.  Within pass 2 a block takes its role from an atomic
// ticket, not from blockIdx, so a fill block waits only on bucket blocks that
// are already running, and the crowded cells' second round starts only once
// the queue has handed out every chunk of the first, which waits on nothing:
// no wait can deadlock.  Data one block reads after another block of the same
// kernel wrote it goes through L2 (__ldcg) after a flag or counter and a
// fence.
//
// A rank is "the number of smaller ids in my cell": it does not depend on
// the order in which the atomics hand out the slots and the buckets, so the
// result is exact and the same on every run.
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAgentsPerThread = 4;
constexpr int kAgentTile = kThreads * kAgentsPerThread;  // agents a tile
constexpr int kCellsPerThread = 8;
constexpr int kCellTile = kThreads * kCellsPerThread;    // cells a bucket tile
constexpr int kRow = 4;            // agents a cell keeps in its table row (16 bytes)
constexpr int kSmallCell = 64;     // a cell with more agents is ranked by blocks
constexpr int kChunk = 2048;       // agents of a crowded cell one block sorts
constexpr int kSplit = 8;          // blocks that share one chunk's second round
constexpr int kCrowdBlocksPerSm = 2;
// Counters, each on a 128-byte line of its own (blocks poll some of them):
// pass 2's ticket, the bucket cursor, bucket tiles done, the queue length and
// its two cursors.
enum { kTicket = 0, kBump = 32, kPlaced = 64, kItems = 96, kRound1 = 128, kRound2 = 160 };
constexpr int kCounters = 192;

struct Layout {
  long long tiles_a, tiles_c, max_items;
  size_t count, counters, sorted, zero_end, table, offsets, tile_dead, item_cell, item_base,
      slot, bucket, total;
};

// The workspace, int32 arrays; everything before zero_end starts at zero.
Layout layout(long long n, long long n_cells) {
  Layout l{};
  l.tiles_a = (n + kAgentTile - 1) / kAgentTile;
  l.tiles_c = (n_cells + kCellTile - 1) / kCellTile;
  // Sum over cells of more than kSmallCell agents of ceil(count / kChunk).
  l.max_items = n / (kSmallCell + 1) + n / kChunk + 1;
  size_t at = 0;
  l.count = at; at += 4 * n_cells;
  l.counters = at; at += 4 * kCounters;
  l.sorted = at; at += 4 * l.max_items;
  l.zero_end = at;
  at = (at + 15) & ~static_cast<size_t>(15);
  l.table = at; at += 4 * kRow * n_cells;
  l.offsets = at; at += 4 * n_cells;
  l.tile_dead = at; at += 4 * l.tiles_a;
  l.item_cell = at; at += 4 * l.max_items;
  l.item_base = at; at += 4 * l.max_items;
  l.slot = at; at += 4 * n;
  l.bucket = at; at += 4 * n;
  l.total = at;
  return l;
}

// A wait past this many polls (seconds) means a broken invariant: trap, which
// fails the launch with an error, rather than hang the card.
constexpr long long kMaxPolls = 1LL << 24;

// Sleeps 32 ns doubling to 1 us a poll, so that waiting blocks do not crowd
// the line they poll.
__device__ __forceinline__ void pause(long long& polls) {
  __nanosleep(32u << (polls < 5 ? polls : 5));
  if (++polls > kMaxPolls) __trap();
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// Thread 0 waits until *flag >= target; then the block may read what was
// written before the flag was raised (through L2).
__device__ __forceinline__ void block_wait(const int* flag, int target = 1) {
  if (threadIdx.x == 0) {
    for (long long polls = 0; load_volatile(flag) < target;) pause(polls);
    __threadfence();
  }
  __syncthreads();
}

// Thread 0 adds one to *flag once every thread's writes before the call are
// done.
__device__ __forceinline__ void block_publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

// Exclusive scan of one value a thread over the block; *total gets the sum.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kThreads / 32 ? warp_sum[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kThreads / 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  const unsigned before = warp ? warp_sum[warp - 1] : 0u;
  *total = warp_sum[kThreads / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// This thread's kAgentsPerThread consecutive agents of an agent tile.
__device__ __forceinline__ void load_ids(const int* cid, long long first, int n,
                                         int (&c)[kAgentsPerThread]) {
  if (first + kAgentsPerThread <= n &&
      (reinterpret_cast<size_t>(cid + first) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(cid + first);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kAgentsPerThread; ++k) c[k] = first + k < n ? cid[first + k] : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
    cell_rank_count(const int* __restrict__ cid, int n, int n_cells, int* __restrict__ count,
                    int* __restrict__ table, int* __restrict__ slot, int* __restrict__ tile_dead) {
  const long long first = static_cast<long long>(blockIdx.x) * kAgentTile +
                          threadIdx.x * kAgentsPerThread;
  const int lane = threadIdx.x & 31;
  int c[kAgentsPerThread];
  load_ids(cid, first, n, c);
  // The lanes of a warp whose agents share a cell take their slots with one
  // atomicAdd (a crowded cell would serialise on one address); the four
  // agents' atomics are in flight together.
  bool live[kAgentsPerThread];
  unsigned group[kAgentsPerThread];
  int base[kAgentsPerThread];
  unsigned dead = 0u;
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    live[k] = first + k < n && c[k] >= 0 && c[k] < n_cells;
    group[k] = __match_any_sync(0xffffffffu, live[k] ? c[k] : -1 - lane);
    dead += first + k < n && c[k] == n_cells;
  }
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k)
    base[k] = live[k] && lane == __ffs(group[k]) - 1 ? atomicAdd(&count[c[k]], __popc(group[k]))
                                                     : 0;
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    base[k] = __shfl_sync(0xffffffffu, base[k], __ffs(group[k]) - 1);
    if (live[k]) {
      const int s = base[k] + __popc(group[k] & ((1u << lane) - 1u));
      slot[first + k] = s;
      if (s < kRow) table[static_cast<long long>(c[k]) * kRow + s] = static_cast<int>(first + k);
    }
  }
  unsigned total;
  block_exclusive_scan(dead, &total);
  if (threadIdx.x == 0) tile_dead[blockIdx.x] = static_cast<int>(total);
}

__global__ void __launch_bounds__(kThreads)
    cell_rank_alloc_fill(const int* __restrict__ cid, int n, int n_cells, long long tiles_a,
                         long long tiles_c, const int* __restrict__ count,
                         const int* __restrict__ table, int* offsets,
                         int* __restrict__ tile_dead, const int* __restrict__ slot,
                         int* __restrict__ bucket, int* counters, int* __restrict__ item_cell,
                         int* __restrict__ item_base) {
  __shared__ int ticket;
  __shared__ unsigned carry;
  if (threadIdx.x == 0) ticket = atomicAdd(&counters[kTicket], 1);
  __syncthreads();
  const long long tile = ticket;
  if (tile == 0) {
    // The tiles' dead counts, in place, into their exclusive prefixes.
    if (threadIdx.x == 0) carry = 0u;
    __syncthreads();
    for (long long t0 = 0; t0 < tiles_a; t0 += kThreads) {
      const long long t = t0 + threadIdx.x;
      const unsigned v = t < tiles_a ? static_cast<unsigned>(tile_dead[t]) : 0u;
      unsigned total;
      const unsigned before = block_exclusive_scan(v, &total);
      if (t < tiles_a) tile_dead[t] = static_cast<int>(carry + before);
      __syncthreads();
      if (threadIdx.x == 0) carry += total;
      __syncthreads();
    }
    return;
  }
  if (tile <= tiles_c) {
    // A tile of cells: each cell of more than kRow agents its bucket, at one
    // cursor bump for the tile, its first kRow agents copied from the table.
    const long long first = (tile - 1) * kCellTile + threadIdx.x * kCellsPerThread;
    int v[kCellsPerThread];
    unsigned sum = 0u;
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      v[k] = first + k < n_cells ? count[first + k] : 0;
      if (v[k] <= kRow) v[k] = 0;
      sum += static_cast<unsigned>(v[k]);
    }
    unsigned total;
    unsigned run = block_exclusive_scan(sum, &total);
    if (threadIdx.x == 0) carry = static_cast<unsigned>(atomicAdd(&counters[kBump], static_cast<int>(total)));
    __syncthreads();
    run += carry;
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      const long long cell = first + k;
      if (v[k] == 0) continue;
      if (v[k] > kSmallCell) {
        const int items = (v[k] + kChunk - 1) / kChunk;
        const int base = atomicAdd(&counters[kItems], items);
        for (int a = 0; a < items; ++a) {
          item_cell[base + a] = static_cast<int>(cell);
          item_base[base + a] = base;
        }
      }
      offsets[cell] = static_cast<int>(run);
      const int4 row = *reinterpret_cast<const int4*>(table + cell * kRow);
      bucket[run] = row.x;
      bucket[run + 1] = row.y;
      bucket[run + 2] = row.z;
      bucket[run + 3] = row.w;
      run += static_cast<unsigned>(v[k]);
    }
    block_publish(&counters[kPlaced]);
    return;
  }
  // Fill: each live agent past its cell's table row into the cell's bucket
  // at its slot, once every bucket is placed (a block with no such agent
  // does not wait).
  const long long first = (tile - 1 - tiles_c) * kAgentTile + threadIdx.x * kAgentsPerThread;
  int c[kAgentsPerThread], at[kAgentsPerThread];
  load_ids(cid, first, n, c);
  bool any = false;
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    at[k] = first + k < n && c[k] >= 0 && c[k] < n_cells ? slot[first + k] : 0;
    any |= at[k] >= kRow;
  }
  if (!__syncthreads_or(any)) return;
  block_wait(&counters[kPlaced], static_cast<int>(tiles_c));
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k)
    if (at[k] >= kRow) bucket[__ldcg(&offsets[c[k]]) + at[k]] = static_cast<int>(first + k);
}

// Ascending bitonic sort of s[0, p), p a power of two, by the whole block.
__device__ void block_sort(int* s, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int i = 2 * t - (t & (j - 1));  // bit j of i clear; partner i + j
        const int a = s[i], b = s[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int count_below(const int* s, int m, int x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The next queue entry for the whole block, or -1 once the queue is empty.
__device__ __forceinline__ int next_item(int* cursor, int items) {
  __shared__ int item;
  __syncthreads();
  if (threadIdx.x == 0) item = atomicAdd(cursor, 1);
  __syncthreads();
  return item < items ? item : -1;
}

// Crowded cells, by the first blocks of cell_rank_rank.  Round 1 sorts each
// chunk and writes each agent's place in it as its rank.  Round 2 (cells of
// more than one chunk) splits each chunk's work kSplit ways: part p of chunk
// a adds, for each agent of a, the count of smaller ids in the other sorted
// chunks b = p, p + kSplit, ..., with one atomicAdd an agent.
__device__ void rank_crowded(const int* count_of, const int* offsets, int* bucket, int* rank,
                             int items,
                             const int* item_cell, const int* item_base, int* round1,
                             int* round2, int* sorted) {
  __shared__ int mine[kChunk];
  __shared__ int other[kChunk];
  for (int item; (item = next_item(round1, items)) >= 0;) {
    const int cell = item_cell[item], lo = (item - item_base[item]) * kChunk;
    const int o = offsets[cell], count = count_of[cell];
    const int m = min(kChunk, count - lo);
    int p = 2;
    while (p < m) p <<= 1;
    for (int t = threadIdx.x; t < p; t += kThreads) mine[t] = t < m ? bucket[o + lo + t] : INT_MAX;
    __syncthreads();
    block_sort(mine, p);
    for (int t = threadIdx.x; t < m; t += kThreads) rank[mine[t]] = t;
    if (count > kChunk) {
      for (int t = threadIdx.x; t < m; t += kThreads) bucket[o + lo + t] = mine[t];
      block_publish(&sorted[item]);
    }
  }
  constexpr int kPer = kChunk / kThreads;
  for (int unit; (unit = next_item(round2, items * kSplit)) >= 0;) {
    const int item = unit / kSplit, part = unit % kSplit;
    const int cell = item_cell[item], base = item_base[item];
    const int o = offsets[cell], count = count_of[cell];
    const int a = item - base, chunks = (count + kChunk - 1) / kChunk;
    if (count <= kChunk || (part == a && part + kSplit >= chunks) || part >= chunks) continue;
    const int m = min(kChunk, count - a * kChunk);
    block_wait(&sorted[item]);
    for (int t = threadIdx.x; t < m; t += kThreads) mine[t] = __ldcg(&bucket[o + a * kChunk + t]);
    int r[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) r[j] = 0;
    for (int b = part; b < chunks; b += kSplit) {
      if (b == a) continue;
      const int mb = min(kChunk, count - b * kChunk);
      block_wait(&sorted[base + b]);
      for (int t = threadIdx.x; t < mb; t += kThreads) other[t] = __ldcg(&bucket[o + b * kChunk + t]);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = threadIdx.x + j * kThreads;
        if (t < m) r[j] += count_below(other, mb, mine[t]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = threadIdx.x + j * kThreads;
      if (t < m && r[j]) atomicAdd(&rank[mine[t]], r[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    cell_rank_rank(const int* __restrict__ cid, int n, int n_cells, int crowd_blocks,
                   const int* count, const int* table, const int* offsets,
                   const int* tile_dead, int* bucket,
                   int* rank, int* counters, const int* item_cell, const int* item_base,
                   int* sorted) {
  if (static_cast<int>(blockIdx.x) < crowd_blocks) {
    const int items = counters[kItems];
    if (items > 0)
      rank_crowded(count, offsets, bucket, rank, items, item_cell, item_base,
                   &counters[kRound1], &counters[kRound2], sorted);
    return;
  }
  const long long tile = blockIdx.x - crowd_blocks;
  const long long first = tile * kAgentTile + threadIdx.x * kAgentsPerThread;
  int c[kAgentsPerThread], m[kAgentsPerThread];
  load_ids(cid, first, n, c);
  unsigned dead = 0u;
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    const bool live = first + k < n && c[k] >= 0 && c[k] < n_cells;
    m[k] = live ? count[c[k]] : 0;
    dead += first + k < n && c[k] == n_cells;
  }
  unsigned total;
  unsigned r_dead = block_exclusive_scan(dead, &total) + static_cast<unsigned>(tile_dead[tile]);
  // An agent alone in its cell has rank 0; a cell of at most kRow agents has
  // them all in its table row; a larger small cell in its bucket.  A crowded
  // cell is ranked by the first blocks.
  int r[kAgentsPerThread];
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    const int i = static_cast<int>(first + k);
    r[k] = 0;
    if (m[k] > 1 && m[k] <= kRow) {
      const int4 row = *reinterpret_cast<const int4*>(table + static_cast<long long>(c[k]) * kRow);
      r[k] = (row.x < i) + (row.y < i) + (m[k] > 2 && row.z < i) + (m[k] > 3 && row.w < i);
    } else if (m[k] > kRow && m[k] <= kSmallCell) {
      const int* b = bucket + offsets[c[k]];
      for (int t = 0; t < m[k]; ++t) r[k] += b[t] < i;
    }
  }
#pragma unroll
  for (int k = 0; k < kAgentsPerThread; ++k) {
    const long long i = first + k;
    if (i >= n) break;
    if (c[k] == n_cells) {
      rank[i] = static_cast<int>(r_dead++);
    } else if (c[k] < 0 || c[k] > n_cells) {
      rank[i] = -1;  // outside the domain [0, n_cells]
    } else if (m[k] <= kSmallCell) {
      rank[i] = r[k];
    }
  }
}

}  // namespace

extern "C" long long cell_rank_workspace_bytes(int n, int n_cells) {
  return static_cast<long long>(layout(n, n_cells).total);
}

// cid (n,) int32 -> rank (n,) int32 on `stream`; ws: workspace_bytes(n,
// n_cells) bytes, 16-byte aligned.  Returns a cudaError_t.
extern "C" int cell_rank_launch(int device, const void* cid, int n, int n_cells, void* ws,
                                long long ws_bytes, void* rank, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout l = layout(n, n_cells);
  if (n < 0 || n_cells < 0 || ws_bytes < static_cast<long long>(l.total) ||
      (reinterpret_cast<size_t>(ws) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* w = static_cast<char*>(ws);
  int* count = reinterpret_cast<int*>(w + l.count);
  int* counters = reinterpret_cast<int*>(w + l.counters);
  int* sorted = reinterpret_cast<int*>(w + l.sorted);
  int* table = reinterpret_cast<int*>(w + l.table);
  int* offsets = reinterpret_cast<int*>(w + l.offsets);
  int* tile_dead = reinterpret_cast<int*>(w + l.tile_dead);
  int* item_cell = reinterpret_cast<int*>(w + l.item_cell);
  int* item_base = reinterpret_cast<int*>(w + l.item_base);
  int* slot = reinterpret_cast<int*>(w + l.slot);
  int* bucket = reinterpret_cast<int*>(w + l.bucket);
  const int* ids = static_cast<const int*>(cid);

  err = cudaMemsetAsync(ws, 0, l.zero_end, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_rank_count<<<static_cast<unsigned>(l.tiles_a), kThreads, 0, st>>>(
      ids, n, n_cells, count, table, slot, tile_dead);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_rank_alloc_fill<<<static_cast<unsigned>(1 + l.tiles_c + l.tiles_a), kThreads, 0, st>>>(
      ids, n, n_cells, l.tiles_a, l.tiles_c, count, table, offsets, tile_dead, slot, bucket,
      counters, item_cell, item_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int crowd_blocks = sms * kCrowdBlocksPerSm;
  cell_rank_rank<<<static_cast<unsigned>(crowd_blocks + l.tiles_a), kThreads, 0, st>>>(
      ids, n, n_cells, crowd_blocks, count, table, offsets, tile_dead, bucket,
      static_cast<int*>(rank), counters, item_cell, item_base, sorted);
  return static_cast<int>(cudaGetLastError());
}
