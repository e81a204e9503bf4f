// Eq 4.1 contact force on every query agent, summed over its dense candidate
// set: cand (N, K) ids into the source arrays, cand_mask (N, K).
//
// Replaces: src/repro/kernels/pairwise_force/kernel.py:pairwise_force_planar
// (the Pallas _force_kernel).  That kernel takes candidate positions already
// gathered by XLA into (3, N, K) and padded to (128, 128) tiles, because TPU
// BlockSpecs can only fetch rectangular tiles; the gather alone writes and
// reads 12 bytes per candidate slot.  Here the kernel reads the mask, and the
// id of a slot only where its mask is set, and gathers each masked-in
// source's position and radius itself, so no (N, K, 3) tensor and no planar
// copy exist.
//
// Bound on this card: bytes.  The function must read every mask byte (1 B a
// slot), the id of every masked-in slot, the queries, and write the output.
// At the dense path's shape (131,072 queries, K = 27 * 96 = 2,592, about
// 8.2e6 masked-in slots) that is about 376 MB, 0.112 ms at 3.35 TB/s; the
// 8.2e6 pair evaluations of ~20 f32 operations are far below it.  This design
// reads the mask once (340 MB) and each 32-byte sector of ids that holds a
// set slot: the candidate build fills a neighbour cell's slots from its
// first, so a live row's set slots sit in about 27 sectors (about 0.1 GB in
// all).  With the queries and the output that is about 0.44 GB, 0.13 ms at
// 3.35 TB/s (kernel.py's design_bytes counts it from the inputs).  The
// sources (16 B an agent) are gathered from L2.
//
// Design: one warp per query row, in three stages.
//  1. Stream the mask wide.  Where the row's bytes are 16-byte aligned each
//     lane loads uint4 words, kChunkWords of them issued before any is used
//     (a warp has 6 x 512 = 3,072 slots in flight: a whole K = 2,592 row).
//     Bytes before the row's first 16-byte boundary and after its last (rows
//     of K % 16 != 0) are read one a lane.
//  2. Compact across the warp.  A word's 16 bytes become 16 bits; __popc and
//     a warp scan rank the set slots in slot order, and each lane writes its
//     set slots' offsets into the warp's queue in shared memory (a ring of
//     kRing).  A segment with no set slot costs one ballot; a row with none
//     ends after its mask.
//  3. Evaluate.  Lane L takes the queued slots of rank = L (mod 32), kDepth
//     at a time: it loads their ids, then their sources' positions and
//     radii, then adds the pairs, so the loads of a batch overlap.  The pairs
//     are spread over all 32 lanes whatever slots they sit in.
// Sum order: each lane adds its pairs in ascending slot order, then the lanes
// reduce with __shfl_down_sync and lane 0 stores every row, empty ones as
// zeros, so the output needs no fill.  No atomics: two calls give the same
// bits.  No allocation and no host sync: a call can be captured in a CUDA
// graph.  Sources may be longer than the queries (the distributed engine's
// ghost-extended arrays).
//
// Arithmetic: verbatim from the Pallas kernel (kernel.py:65-74),
//   dist = sqrt(dx*dx + dy*dy + dz*dz + 1e-20)  (left-associated)
//   scale = (k*delta - gamma*sqrt(max(rbar*delta, 0))) / dist,  f += scale*dx,
// with explicit round-to-nearest intrinsics so that nvcc contracts nothing into
// an FMA.  Pairs that do not overlap (delta <= 0) add nothing and are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 query rows a block, a warp each
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = 6;       // 16-byte mask words a lane loads at once
constexpr int kDepth = 4;            // queued slots a lane evaluates at once
constexpr int kBatch = 32 * kDepth;
constexpr int kRing = 1024;          // a warp's queue of set slots (a power of two)
constexpr unsigned kAll = 0xffffffffu;

// Four mask bytes as four bits, byte 0 in bit 0; any non-zero byte is set.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned word_bits(uint4 w) {
  return nibble(w.x) | nibble(w.y) << 4 | nibble(w.z) << 8 | nibble(w.w) << 12;
}

// Appends the warp's set slots to its queue in slot order: bit b of lane l's
// `bits` stands for slot `slot0 + b` of that lane, and the lanes' slots
// ascend with the lane.  Warp-collective; `produced` is the same in every lane.
__device__ __forceinline__ void enqueue(unsigned bits, int slot0, int lane, int* queue,
                                        int& produced) {
  if (__ballot_sync(kAll, bits != 0u) == 0u) return;
  const int count = __popc(bits);
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  __syncwarp();  // earlier readers of the ring are done
  int at = produced + incl - count;
  while (bits) {
    queue[at++ & (kRing - 1)] = slot0 + __ffs(bits) - 1;
    bits &= bits - 1u;
  }
  produced += __shfl_sync(kAll, incl, 31);
}

// One pair, verbatim from the Pallas kernel.
__device__ __forceinline__ void add_pair(float qx, float qy, float qz, float qr, float sx,
                                         float sy, float sz, float sr, float k, float gamma,
                                         float& fx, float& fy, float& fz) {
  const float dxc = __fsub_rn(qx, sx);
  const float dyc = __fsub_rn(qy, sy);
  const float dzc = __fsub_rn(qz, sz);
  const float d2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc)), __fmul_rn(dzc, dzc)),
      1e-20f);
  const float dist = __fsqrt_rn(d2);
  const float delta = __fsub_rn(__fadd_rn(qr, sr), dist);
  if (!(delta > 0.f)) return;
  const float rbar = __fdiv_rn(__fmul_rn(qr, sr), fmaxf(__fadd_rn(qr, sr), 1e-20f));
  const float mag = __fsub_rn(
      __fmul_rn(k, delta), __fmul_rn(gamma, __fsqrt_rn(fmaxf(__fmul_rn(rbar, delta), 0.f))));
  const float scale = __fdiv_rn(mag, dist);
  fx = __fadd_rn(fx, __fmul_rn(scale, dxc));
  fy = __fadd_rn(fy, __fmul_rn(scale, dyc));
  fz = __fadd_rn(fz, __fmul_rn(scale, dzc));
}

// The lane's share of the queued ranks [first, last): ranks first + lane +
// 32 d, d < kDepth (last - first <= kBatch).  Ids first, then sources, then
// the pairs in rank order.  Warp-collective.
__device__ __forceinline__ void evaluate(const int* queue, int first, int last, int lane,
                                         const int* __restrict__ ids,
                                         const float* __restrict__ src_pos,
                                         const float* __restrict__ src_rad, float qx,
                                         float qy, float qz, float qr, float k, float gamma,
                                         float& fx, float& fy, float& fz) {
  __syncwarp();  // the ring's writers are done
  int id[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int r = first + 32 * d + lane;
    id[d] = r < last ? __ldcs(ids + queue[r & (kRing - 1)]) : 0;
  }
  float sx[kDepth], sy[kDepth], sz[kDepth], sr[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const long long j = id[d];
    const bool live = first + 32 * d + lane < last;
    sx[d] = live ? __ldg(src_pos + 3 * j) : 0.f;
    sy[d] = live ? __ldg(src_pos + 3 * j + 1) : 0.f;
    sz[d] = live ? __ldg(src_pos + 3 * j + 2) : 0.f;
    sr[d] = live ? __ldg(src_rad + j) : 0.f;
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (first + 32 * d + lane < last)
      add_pair(qx, qy, qz, qr, sx[d], sy[d], sz[d], sr[d], k, gamma, fx, fy, fz);
  }
}

__global__ void __launch_bounds__(kThreads)
    pairwise_force_kernel(const float* __restrict__ pos, const float* __restrict__ rad,
                          const int* __restrict__ cand, const uint8_t* __restrict__ cand_mask,
                          const float* __restrict__ src_pos,
                          const float* __restrict__ src_rad, int n, int kdim, float k,
                          float gamma, float* __restrict__ out) {
  __shared__ int queues[kWarps][kRing];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= n) return;  // whole warps exit together
  int* queue = queues[warp];
  const uint8_t* mask = cand_mask + row * kdim;
  const int* ids = cand + row * kdim;
  const float qx = pos[3 * row], qy = pos[3 * row + 1], qz = pos[3 * row + 2];
  const float qr = rad[row];

  // The row's mask: single bytes up to its first 16-byte boundary (head),
  // whole 16-byte words, single bytes after the last word (tail).
  const int head =
      min(static_cast<int>((16u - (reinterpret_cast<uintptr_t>(mask) & 15u)) & 15u), kdim);
  const int words = (kdim - head) >> 4;
  const int tail_at = head + 16 * words;
  const uint4* wmask = reinterpret_cast<const uint4*>(mask + head);
  int produced = 0, consumed = 0;
  float fx = 0.f, fy = 0.f, fz = 0.f;

  enqueue(lane < head && mask[lane] ? 1u : 0u, lane, lane, queue, produced);
  for (int w0 = 0; w0 < words; w0 += 32 * kChunkWords) {
    uint4 v[kChunkWords];
#pragma unroll
    for (int s = 0; s < kChunkWords; ++s) {
      const int w = w0 + 32 * s + lane;
      v[s] = w < words ? __ldcs(wmask + w) : make_uint4(0u, 0u, 0u, 0u);
    }
    unsigned bits[kChunkWords];
#pragma unroll
    for (int s = 0; s < kChunkWords; ++s) bits[s] = word_bits(v[s]);
    const int segments = min(kChunkWords, (words - w0 + 31) >> 5);
#pragma unroll 1
    for (int s = 0; s < segments; ++s) {
      enqueue(bits[0], head + 16 * (w0 + 32 * s + lane), lane, queue, produced);
#pragma unroll
      for (int t = 0; t + 1 < kChunkWords; ++t) bits[t] = bits[t + 1];
      for (; produced - consumed >= kBatch; consumed += kBatch)
        evaluate(queue, consumed, consumed + kBatch, lane, ids, src_pos, src_rad, qx, qy,
                 qz, qr, k, gamma, fx, fy, fz);
    }
  }
  const int tail = kdim - tail_at;
  enqueue(lane < tail && mask[tail_at + lane] ? 1u : 0u, tail_at + lane, lane, queue,
          produced);
  for (; consumed < produced; consumed += kBatch)
    evaluate(queue, consumed, produced, lane, ids, src_pos, src_rad, qx, qy, qz, qr, k,
             gamma, fx, fy, fz);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fx = __fadd_rn(fx, __shfl_down_sync(kAll, fx, off));
    fy = __fadd_rn(fy, __shfl_down_sync(kAll, fy, off));
    fz = __fadd_rn(fz, __shfl_down_sync(kAll, fz, off));
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
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kWarps - 1) / kWarps);
  if (blocks > 0) {
    pairwise_force_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(rad),
        static_cast<const int*>(cand), static_cast<const uint8_t*>(cand_mask),
        static_cast<const float*>(src_pos), static_cast<const float*>(src_rad), n, kdim, k,
        gamma, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
