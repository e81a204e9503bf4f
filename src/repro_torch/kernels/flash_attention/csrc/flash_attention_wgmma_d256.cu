// Forward online-softmax ("flash") attention on Hopper's tensor cores, for
// bf16 q, k, v at head_dim 256: wgmma products fed by TMA, with the head dim
// split over two consumer warpgroups.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_flat
// (the Pallas _flash_kernel), for the inputs kernel.py routes here (bf16 at
// D 256: paligemma, recurrentgemma and gemma prefill); D 64 / 128 run
// csrc/flash_attention_wgmma.cu, f32 and D 16 csrc/flash_attention.cu.  It
// computes what that kernel computes: GQA through head h -> h / group (K and V
// never repeated), causal, sliding-window and prefix-LM masks, kv_offset and
// kv_len, the -1e30 sentinel, p zeroed where hidden and the final
// max(l, 1e-30), so a row whose keys are all hidden is 0; each row's lse on
// request.  The arithmetic is that of the D 64 / 128 kernel (its header):
// the running max m in raw-score units, p = 2^((s - m) * scale * log2 e) by
// ex2.approx, P in three bf16 terms each multiplied by V into a fresh f32
// accumulator that is added to alpha * O with round-to-nearest adds, S summed
// over the 16 steps of 16 values in the same order, and the output rounded
// once; ref.py:wgmma_arithmetic_ref repeats it for every head dim.
//
// Why a kernel of its own: at D 256 one warpgroup holding a 64-row tile's
// output O (64 x 256 f32: 128 registers a thread), the tile's fresh P V
// accumulator (another 128), S (32) and the three P terms (48) needs about
// 336 registers a thread; the cap is 255.
//
// Layout: one block per (64-query tile, batch * query head), 384 threads:
//   consumers  warpgroups 0 and 1 each hold all 64 rows of the tile and half
//              of D: warpgroup w owns O[:, 128 w .. 128 w + 127].  Both
//              compute the whole S = Q K^T (wgmma m64n64k16 over the 16
//              steps of D, Q and K from shared memory), so both run the same
//              softmax on the same bits and no S crosses between them; each
//              then multiplies P by its 128 columns of V in two steps of 64
//              (m64n64k16, P from registers, V MN-major with the transpose
//              bit), each step into a fresh accumulator.  The redundant S is
//              25% more tensor work than one S (five products a tile where
//              the function has two: 2.5x its FLOP).
//   producer   warpgroup 2: one thread issues the TMA copies of Q (once) and
//              of K and V tiles of 64 keys into a ring of 3 stages guarded by
//              mbarriers (full: the bytes arrived; empty: the 8 consumer warps
//              are done with the stage).  Tensor maps: 4-d views (D, T, H, B)
//              from the tensors' strides, 64-value (128-byte) panels with the
//              128-byte swizzle; TMA zero-fills rows past Tq and Tk and the
//              masks hide them.  cuTensorMapEncodeTiled is looked up with
//              cudaGetDriverEntryPoint (no -lcuda).
//   grid       the query heads of one KV head are neighbours (groups 8 and 16
//              at the two family shapes: K and V come from L2 for all but the
//              first), the query tiles run from the last to the first, the
//              longest causal rows first.  A tile the whole block cannot see
//              is skipped (the SIMT kernel's exact range test), and tiles the
//              block sees whole skip the masks.
//
// Registers: warp specialisation with setmaxnreg: the block starts at 168 a
// thread (65,536 / 384), the producer warpgroup drops to 24 and the two
// consumer warpgroups rise to 240 (128 x 24 + 256 x 240 = 64,512, the
// 384 x 168 the block was given).  A consumer holds O (64), one step's P V
// (32), S (32) and the three P terms (48).  ptxas -v (CUDA 12, sm_90a):
// "Used 168 registers" (the entry's count; the consumers run at 240), no
// stack frame, 0 bytes spilled.  With the 128 columns' P V in one m64n128
// accumulator (64 registers) it had a 160-byte stack frame and 364 bytes of
// spill stores in the rescale of O, and took 0.656-0.683 ms at paligemma's
// shape against this design's 0.433-0.443 in the same call
// (scripts/ablate_flash_d256.py, variant pv_m64n128).
//
// Shared memory: Q 32 KB (4 panels of 64 rows x 128 bytes), 3 stages of K
// and V at 32 KB each (192 KB), 7 barriers: 229,432 bytes + 1,024 to align
// the base, of the 232,448 a block may have, so one block an SM.
//
// Bound on this card, over the visible (query, key) pairs, Q K^T and P V at
// 989 TFLOP/s bf16: paligemma-3b's prefill call (B 4, 8 / 1 heads, T 2,304,
// prefix 256) 8.81e10 FLOP, 0.0891 ms; recurrentgemma-9b's (B 2, 16 / 1,
// T 4,096, window 2,048) 2.06e11 FLOP, 0.2085 ms.  This design computes every
// 64 x 64 tile holding a visible pair, five products a tile: 0.228 and
// 0.537 ms.  Each block re-reads K and V through L2 (64 KB a tile), about
// 1.4 GB from L2 at paligemma's shape.
//
// Left for a later PR: S computed once (each warpgroup a half-D partial,
// summed through shared memory: another sum order, which
// wgmma_arithmetic_ref would follow, and 32 KB that 3 stages leave no room
// for); issuing the next tile's S before this tile's softmax (a second S
// accumulator, 32 registers); a cluster of the group's query heads with TMA
// multicast of K and V; separate K and V barriers so S starts before V
// lands; a TMA store of O.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;
constexpr int kBQ = 64;                    // query rows a block
constexpr int kBK = 64;                    // keys a tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;          // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanel = 64;                 // bf16 values in one 128-byte swizzled row
constexpr int kPanels = kD / kPanel;       // 4
constexpr int kPanelBytes = 64 * 128;      // a panel of 64 rows (Q, K and V alike)
constexpr int kTile = kPanels * kPanelBytes;  // Q, or one K or V tile: 32 KB
constexpr int kDW = kD / 2;                // columns of O a consumer warpgroup owns
constexpr float kNegInf = -1e30f;

constexpr int kOffQ = 0;
constexpr int kOffK = kOffQ + kTile;
constexpr int kOffV = kOffK + kStages * kTile;
constexpr int kOffBar = kOffV + kStages * kTile;        // q, full[kStages], empty[kStages]
constexpr int kSmemBytes = kOffBar + 8 * (1 + 2 * kStages);
constexpr int kAlloc = kSmemBytes + 1024;               // room to align the base to 1,024
static_assert(kAlloc <= 232448, "shared memory beyond the 227 KB a block may have");
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "register file");

// Error codes beyond cudaError_t's range, returned by the launcher.
constexpr int kErrNoEncode = 20000;        // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10000;          // + the CUresult of a refused map

struct Masks {
  int causal, has_window, window, prefix_len, kv_offset, kv_len;
};

__device__ __forceinline__ bool visible(const Masks& mk, int qa, int k) {
  bool vis = true;
  if (mk.causal) vis = qa >= k;
  if (mk.has_window) vis = vis && (qa - k) < mk.window;
  if (mk.prefix_len > 0) vis = vis || k < mk.prefix_len;
  return k < mk.kv_len && vis;
}

// Whether any (q, k) with absolute q in [qlo, qhi] and k in [klo, khi] is
// visible: the differences q - k fill [qlo - khi, qhi - klo], so the causal
// and window terms hide the tile exactly when that range misses [0, window).
__device__ __forceinline__ bool tile_visible(const Masks& mk, int qlo, int qhi, int klo,
                                             int khi) {
  if (mk.prefix_len > 0 && klo < mk.prefix_len) return true;
  if (mk.causal && qhi - klo < 0) return false;
  if (mk.has_window && qlo - khi >= mk.window) return false;
  return true;
}

// Whether every (q, k) of the rectangle is visible (khi < kv_len checked by
// the caller).
__device__ __forceinline__ bool tile_whole(const Masks& mk, int qlo, int qhi, int klo,
                                           int khi) {
  if (mk.prefix_len > 0 && khi < mk.prefix_len) return true;
  return (!mk.causal || qlo >= khi) && (!mk.has_window || qhi - klo < mk.window);
}

// ------------------------------------------------------- PTX building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed.  A wait of more
// than ~10 s (2e10 cycles) can only be a broken pipeline: trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 in bits 62-63.  The
// swizzle atom is 8 rows of 128 bytes; every panel base is 1,024-aligned, so
// the base-offset field is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma wrappers (the operand lists are written out: PTX names every
// accumulator register).  _ss: A and B from shared memory, both K-major;
// _rs: A from registers, B MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile in the accumulator layout (sc[4 j + 2 hh
// + e] is row hh of the lane's pair, key kbase + 8 j + e), with m in raw
// score units: hidden -> NEG_INF, m_new = max(m, max s),
// alpha = 2^((m - m_new) * scale_log2), p = 2^((s - m_new) * scale_log2)
// zeroed where hidden, l = alpha l + sum p.  Row max and sum over the quad by
// shuffles (every lane ends with the same bits).  sc is overwritten with p.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Masks& mk, int qa0,
                                             int kbase, float scale_log2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qa = qa0 + 8 * hh;
    uint32_t hidden = 0;
    float mc = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        float x = sc[i];
        if (kMasked && !visible(mk, qa, kbase + 8 * j + e)) {
          x = kNegInf;
          hidden |= 1u << (2 * j + e);
        }
        sc[i] = x;
        mc = fmaxf(mc, x);
      }
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m[hh], mc);
    alpha[hh] = ex2(__fmul_rn(__fsub_rn(m[hh], m_new), scale_log2));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        float p = ex2(__fmul_rn(__fsub_rn(sc[i], m_new), scale_log2));
        if (kMasked && ((hidden >> (2 * j + e)) & 1u)) p = 0.f;
        sc[i] = p;
        rs = __fadd_rn(rs, p);
      }
    }
    rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
    rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
    l[hh] = __fadd_rn(__fmul_rn(alpha[hh], l[hh]), rs);
    m[hh] = m_new;
  }
}

// -------------------------------------------------------------------- kernel

__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_d256_kernel(const __grid_constant__ CUtensorMap q_map,
                                      const __grid_constant__ CUtensorMap k_map,
                                      const __grid_constant__ CUtensorMap v_map,
                                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                      int nb, int hq, int hkv, int tq, long long osb,
                                      long long osh, long long ost, Masks mk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + kOffQ;
  const uint32_t sK = base + kOffK;
  const uint32_t sV = base + kOffV;
  const uint32_t bar_q = base + kOffBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  // Block -> (query tile, batch, query head): the group's query heads are
  // neighbours, the last query tile comes first.
  const int group = hq / hkv;
  const int n_qt = (tq + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int g = idx % group;
  idx /= group;
  const int bkv = idx % (nb * hkv);
  const int q0 = (n_qt - 1 - idx / (nb * hkv)) * kBQ;
  const int bi = bkv / hkv;
  const int hk = bkv - bi * hkv;
  const int h = hk * group + g;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tk = mk.kv_len;
  const int qlo = q0 + mk.kv_offset;
  const int qhi = min(q0 + kBQ, tq) - 1 + mk.kv_offset;

  // One if / else for the two roles, never rejoined, so that ptxas can give
  // each side its setmaxnreg budget.
  if (tid >= 32 * kConsumerWarps) {
    // Producer warpgroup: one thread issues every copy, the rest exit.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 32 * kConsumerWarps) {
      mbar_expect_tx(bar_q, kTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(sQ + p * kPanelBytes, &q_map, bar_q, p * kPanel, q0, h, bi);
      int it = 0;
      for (int k0 = 0; k0 < tk; k0 += kBK) {
        if (!tile_visible(mk, qlo, qhi, k0, min(k0 + kBK, tk) - 1)) continue;
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(sK + s * kTile + p * kPanelBytes, &k_map, bar_full + 8 * s, p * kPanel,
                      k0, hk, bi);
          tma_load_4d(sV + s * kTile + p * kPanelBytes, &v_map, bar_full + 8 * s, p * kPanel,
                      k0, hk, bi);
        }
        ++it;
      }
    }
  } else {
    // Consumer warpgroups: warpgroup wg owns O[:, 128 wg .. + 127] of all 64
    // rows; in the accumulator layout lane owns rows r0 and r0 + 8 and, of
    // each 8-column block j, columns 8 j + 2 (lane % 4) + {0, 1}.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);

    float acc[kDW / 2];
#pragma unroll
    for (int i = 0; i < kDW / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    const float scale_log2 = __fmul_rn(scale, 1.44269504088896341f);  // scale * log2(e)
    const int qa0 = q0 + r0 + mk.kv_offset;
    const uint32_t v_cols = sV + 2 * wg * kPanelBytes;  // this warpgroup's two V panels
    mbar_wait(bar_q, 0);
    int it = 0;
    for (int k0 = 0; k0 < tk; k0 += kBK) {
      if (!tile_visible(mk, qlo, qhi, k0, min(k0 + kBK, tk) - 1)) continue;  // block-uniform
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

      // S = Q K^T over all of D: 16 steps of 16 values; step kk reads 32
      // bytes at (kk % 4) * 32 of panel kk / 4.
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = desc_sw128(sQ + (kk / 4) * kPanelBytes + off, 16, 1024);
        const uint64_t db = desc_sw128(sK + s * kTile + (kk / 4) * kPanelBytes + off, 16, 1024);
        wgmma_m64n64k16_ss(sc, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Tiles that the block's rows see whole skip the masks.
      float alpha[2];
      if (k0 + kBK <= tk && tile_whole(mk, qlo, qhi, k0, k0 + kBK - 1))
        softmax_tile<false>(sc, m, l, alpha, mk, qa0, k0 + c0, scale_log2);
      else
        softmax_tile<true>(sc, m, l, alpha, mk, qa0, k0 + c0, scale_log2);
      // alpha is 1 wherever the running max did not move: most tiles.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jd = 0; jd < kDW / 8; ++jd) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            acc[4 * jd + 2 * hh] = __fmul_rn(acc[4 * jd + 2 * hh], alpha[hh]);
            acc[4 * jd + 2 * hh + 1] = __fmul_rn(acc[4 * jd + 2 * hh + 1], alpha[hh]);
          }
        }
      }

      // P in three bf16 terms, as A fragments: register r of key step kk
      // holds the pair sc[8 kk + 2 r], sc[8 kk + 2 r + 1].
      uint32_t a_hi[4][4], a_mid[4][4], a_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hi);
          const float d0 = __fsub_rn(x0, hf.x), d1 = __fsub_rn(x1, hf.y);
          const __nv_bfloat162 mid = __floats2bfloat162_rn(d0, d1);
          const float2 mf = __bfloat1622float2(mid);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(__fsub_rn(d0, mf.x), __fsub_rn(d1, mf.y));
          a_hi[kk][r] = bf16x2_bits(hi);
          a_mid[kk][r] = bf16x2_bits(mid);
          a_lo[kk][r] = bf16x2_bits(lo);
        }
      }

      // O[:, these columns] = alpha O + P V[:, these columns], in two steps of
      // 64 columns (one V panel each): the step's P V goes into a fresh
      // accumulator of 32 registers and is added with round-to-nearest f32
      // adds (one m64n128 accumulator spilled: the header's registers).
      // V's 16 keys of step kk start at row 16 kk of the panel; groups of 8
      // keys are 1,024 bytes apart.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float pv[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv =
              desc_sw128(v_cols + half * kPanelBytes + s * kTile + kk * 16 * 128, kPanelBytes,
                         1024);
          wgmma_m64n64k16_rs(pv, a_lo[kk], dv, kk > 0 ? 1 : 0);
          wgmma_m64n64k16_rs(pv, a_mid[kk], dv, 1);
          wgmma_m64n64k16_rs(pv, a_hi[kk], dv, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[32 * half + i] = __fadd_rn(acc[32 * half + i], pv[i]);
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the stage
      ++it;
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = q0 + r0 + 8 * hh;
      if (t >= tq) continue;
      const float denom = fmaxf(l[hh], 1e-30f);
      // Both warpgroups hold the same m and l; the quad's four lanes too.
      if (lse != nullptr && wg == 0 && (lane & 3) == 0) {
        const float m_nat = m[hh] == kNegInf ? kNegInf : __fmul_rn(m[hh], scale);
        lse[(static_cast<long long>(bi) * hq + h) * tq + t] = __fadd_rn(m_nat, logf(denom));
      }
      __nv_bfloat16* orow = out + bi * osb + h * osh + t * ost + wg * kDW;
#pragma unroll
      for (int jd = 0; jd < kDW / 8; ++jd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd + c0) =
            __floats2bfloat162_rn(__fdiv_rn(acc[4 * jd + 2 * hh], denom),
                                  __fdiv_rn(acc[4 * jd + 2 * hh + 1], denom));
      }
    }
  }
}

// ---------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, T, H, B) view of a (B, H, T, D) tensor with element strides st[0..2]
// for (B, H, T), read in boxes of 64 values x 64 positions.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int t, int h, int b,
             const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

}  // namespace

// bf16 q, k, v, out; d must be 256.  strides: twelve element strides,
// (batch, head, time) of q, k, v and out; the feature axis is contiguous in
// each, and the q, k, v strides and pointers are 16-byte multiples
// (kernel.py checks).  lse: null, or a contiguous (B, Hq, Tq) f32 buffer for
// each row's logsumexp.  Returns a cudaError_t, or kErrEncode + CUresult when
// a tensor map is refused, or kErrNoEncode when cuTensorMapEncodeTiled cannot
// be found.
extern "C" int flash_attention_wgmma_d256_launch(int device, int d, const void* q,
                                                 const void* k, const void* v, void* out,
                                                 void* lse, int b, int hq, int hkv, int tq,
                                                 int tk, const long long* strides, int causal,
                                                 int has_window, int window, int prefix_len,
                                                 int kv_offset, float scale, void* stream) {
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const Masks mk{causal, has_window, window, prefix_len, kv_offset, tk};
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap qm, km, vm;
  int err = make_map(encode, &qm, q, tq, hq, b, strides);
  if (err == 0) err = make_map(encode, &km, k, tk, hkv, b, strides + 3);
  if (err == 0) err = make_map(encode, &vm, v, tk, hkv, b, strides + 6);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(flash_attention_wgmma_d256_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kAlloc);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const unsigned blocks = static_cast<unsigned>((tq + kBQ - 1) / kBQ) *
                          static_cast<unsigned>(b) * static_cast<unsigned>(hq);
  flash_attention_wgmma_d256_kernel<<<blocks, kThreads, kAlloc,
                                      static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), b, hq, hkv, tq,
      strides[9], strides[10], strides[11], mk, scale);
  return static_cast<int>(cudaGetLastError());
}
