// Forward online-softmax ("flash") attention on Hopper's tensor cores, for
// bf16 q, k, v at head_dim 64 and 128: wgmma products fed by TMA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_flat
// (the Pallas _flash_kernel), for the inputs kernel.py routes here; f32
// inputs and the other head dims run csrc/flash_attention.cu (f32 FMAs on the
// SIMT cores).  It computes what that kernel computes: GQA through head
// h -> h / group (K and V never repeated), causal, sliding-window and
// prefix-LM masks, kv_offset and kv_len, the -1e30 sentinel, p zeroed where
// hidden and the final max(l, 1e-30), so a row whose keys are all hidden is 0.
//
// Design: one block per (128-query tile, batch * query head): two consumer
// warpgroups of 64 query rows each and one producer warp (288 threads).  The
// grid is ordered so that the query heads of one KV head run next to each
// other (K and V come from L2 for all but the first) and the query tiles run
// from the last to the first, the longest causal rows first.
//   loads    one thread of the producer warp issues TMA copies: Q once, then
//            K and V tiles of 64 keys into a ring of 3 stages guarded by
//            mbarriers (full: the bytes arrived; empty: the 8 consumer warps
//            are done with the stage), so the next tiles load while the
//            current one is computed.  The tensor maps are 4-d views (D, T, H,
//            B) built on the host for each call from the tensors' strides, in
//            64-value (128-byte) panels with the 128-byte swizzle the wgmma
//            descriptors read; TMA zero-fills rows past Tq and Tk and the
//            masks hide them.  cuTensorMapEncodeTiled is looked up with
//            cudaGetDriverEntryPoint (no -lcuda).
//   S = QK^T wgmma m64n64k16, bf16 -> f32, Q and K both from shared memory
//            (K stored as (Tk, D) rows is the K-major B operand).
//   softmax  on the accumulator fragments in registers, with the running
//            max m kept in units of the raw score s = q . k and
//            p = 2^((s - m) * scale * log2 e) by ex2.approx (two instructions
//            where expf takes about eight; relative error ~2^-22, far below
//            the bf16 ulp the output keeps).  s - m is exact wherever s lies
//            within a factor two of m (Sterbenz), so the rounding of a large
//            score never enters the exponent (rounding x = s * scale * log2 e
//            first puts an absolute error near 2e-6 into the exponent at
//            |x| ~ 43, which a near-cancelling output keeps at a sharp
//            softmax; ROADMAP section 3, repaired faults): masks (a
//            second copy without them for tiles that the warpgroup's rows
//            see whole), row max and row sum over the four lanes of a quad by
//            shuffles, O rescaled only when a row's max moved; a tile the
//            whole block cannot see is skipped by the SIMT kernel's exact
//            range test, which changes no result.  With expf and the masks
//            on every tile the softmax took about half of the kernel's time
//            at the prefill shape (PERF.md).
//   O += PV  P is split in registers into hi = bf16(p), mid = bf16(p - hi),
//            lo = bf16(p - hi - mid) and fed as three register A operands
//            (the S accumulator layout is the A-fragment layout) against V
//            from shared memory with the transpose bit (V is (Tk, D), MN-major
//            for this product), into a fresh f32 accumulator per tile that is
//            added to alpha * O with round-to-nearest f32 adds (as the Pallas
//            kernel's acc * alpha + P V).  The tensor cores' f32 sums
//            truncate, and summing every tile into the running O put more
//            outputs beyond one bf16 ulp of the exact result at a sharp
//            softmax (PERF.md).
//   output   acc / max(l, 1e-30) rounded once to bf16 and stored from the
//            registers with the output's strides; when the caller passes an
//            lse buffer, each row's m * scale + log(max(l, 1e-30)) in f32
//            (natural log, (B, Hq, Tq); -1e30 for a row whose keys are all
//            hidden), which the training slice's backward reads.
//
// Why P has three terms: the Pallas kernel computes in f32 (it upcasts q, k
// and v, kernel.py:59-61) and the port holds bf16 outputs to one bf16 ulp of
// that (rtol 2^-7, atol 1e-6).  Q K^T products of bf16 values are exact in
// f32, but P is not bf16.  Emulated on a CPU (bf16 q, k, v, T 1,024, D 128,
// GQA 3, causal, against the exact result rounded to bf16): P rounded to one
// bf16 term puts 92,993 of 786,432 outputs outside one ulp; two terms pass at
// unit-scale q but leave 2 outside with q x4 or x8 (a sharper softmax); three
// terms (about 24 bits) pass in every case.  ref.py:wgmma_arithmetic_ref
// repeats this arithmetic and tests/test_torch_flash_attention.py holds it
// against the Pallas kernel.
//
// Bound on this card at the LM prefill shape (B 4, Hq 24, Hkv 8, T 2,048,
// D 128, causal): the function's causal half of Q K^T and P V is 1.03e11
// FLOP, 0.104 ms at the 989 TFLOP/s bf16 tensor-core rate (134 MB of q, k, v
// and output, 0.040 ms at 3.35 TB/s); this design's four products (Q K^T and
// three P V) are 2.1e11 FLOP, 0.21 ms.
//
// Registers: ptxas gives a 288-thread block at most 168 a thread; at D 128
// O (64), the tile's P V (64) and the three P terms (48) spill about 500
// bytes a thread to local memory, which stays in L1.  Head dim 256 stays on
// the SIMT kernel:
// its m64n256 accumulators alone would be 256 registers a thread.
//
// Left for a later PR: warp specialisation with setmaxnreg (consumers at
// 232+ registers: no spills, and room for a second S accumulator) and
// ping-pong scheduling of the two warpgroups (here each warpgroup waits for
// its S product, then for its P V products), overlapping the softmax of one
// tile with the Q K^T of the next; reading K and V once for the group's
// query heads (each head's blocks re-read them through L2; a cluster of the
// group's blocks with TMA multicast would not); a TMA store of the output,
// and tiles of 128 keys at D 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                   // query rows a block
constexpr int kBK = 64;                    // keys a tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;          // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;
constexpr int kPanel = 64;                 // bf16 values in one 128-byte swizzled row
constexpr float kNegInf = -1e30f;

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
// visible (the SIMT kernel's test): the differences q - k fill
// [qlo - khi, qhi - klo], so the causal and window terms hide the tile exactly
// when that range misses [0, window).
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

template <int D>
struct Smem {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQPanel = kBQ * 128;               // bytes
  static constexpr int kKVPanel = kBK * 128;
  static constexpr int kTile = kPanels * kKVPanel;        // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kPanels * kQPanel;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;       // q, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;            // room to align the base to 1,024
};

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
// swizzle atom is 8 rows of 128 bytes; every tile base is 1,024-aligned, so
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

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  wgmma_m64n64k16_rs(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  wgmma_m64n128k16_rs(d, a, db, scale_d);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                 int nb, int hq, int hkv,
                                 int tq, long long osb, long long osh, long long ost, Masks mk,
                                 float scale) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + S::kQ;
  const uint32_t sK = base + S::kK;
  const uint32_t sV = base + S::kV;
  const uint32_t bar_q = base + S::kBar;
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

  if (tid >= 32 * kConsumerWarps) {
    // Producer warp: one thread issues every copy.
    if (tid == 32 * kConsumerWarps) {
      mbar_expect_tx(bar_q, S::kPanels * S::kQPanel);
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p)
        tma_load_4d(sQ + p * S::kQPanel, &q_map, bar_q, p * kPanel, q0, h, bi);
      int it = 0;
      for (int k0 = 0; k0 < tk; k0 += kBK) {
        if (!tile_visible(mk, qlo, qhi, k0, min(k0 + kBK, tk) - 1)) continue;
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * S::kTile);
#pragma unroll
        for (int p = 0; p < S::kPanels; ++p) {
          tma_load_4d(sK + s * S::kTile + p * S::kKVPanel, &k_map, bar_full + 8 * s,
                      p * kPanel, k0, hk, bi);
          tma_load_4d(sV + s * S::kTile + p * S::kKVPanel, &v_map, bar_full + 8 * s,
                      p * kPanel, k0, hk, bi);
        }
        ++it;
      }
    }
    return;
  }

  // Consumer warpgroups: warpgroup wg owns query rows wg * 64 .. + 63 of the
  // tile; in the accumulator layout lane owns rows r0 and r0 + 8 and, of each
  // 8-column block j, columns 8 j + 2 (lane % 4) + {0, 1}.
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int wq_lo = q0 + wg * 64 + mk.kv_offset;
  const int wq_hi = min(q0 + wg * 64 + 64, tq) - 1 + mk.kv_offset;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const float scale_log2 = __fmul_rn(scale, 1.44269504088896341f);  // scale * log2(e)
  mbar_wait(bar_q, 0);
  const uint32_t q_rows = sQ + wg * 64 * 128;
  int it = 0;
  for (int k0 = 0; k0 < tk; k0 += kBK) {
    if (!tile_visible(mk, qlo, qhi, k0, min(k0 + kBK, tk) - 1)) continue;  // block-uniform
    const int s = it % kStages;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

    // S = Q K^T: D / 16 steps of 16 values; step kk reads 32 bytes at
    // (kk % 4) * 32 of panel kk / 4.
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc_sw128(q_rows + (kk / 4) * S::kQPanel + off, 16, 1024);
      const uint64_t db =
          desc_sw128(sK + s * S::kTile + (kk / 4) * S::kKVPanel + off, 16, 1024);
      wgmma_m64n64k16_ss(sc, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Tiles that the warpgroup's rows see whole skip the masks.
    float alpha[2];
    const int qa0 = q0 + r0 + mk.kv_offset;
    if (k0 + kBK <= tk && tile_whole(mk, wq_lo, wq_hi, k0, k0 + kBK - 1))
      softmax_tile<false>(sc, m, l, alpha, mk, qa0, k0 + c0, scale_log2);
    else
      softmax_tile<true>(sc, m, l, alpha, mk, qa0, k0 + c0, scale_log2);
    // alpha is 1 wherever the running max did not move: most tiles.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * jd + 2 * hh] = __fmul_rn(acc[4 * jd + 2 * hh], alpha[hh]);
          acc[4 * jd + 2 * hh + 1] = __fmul_rn(acc[4 * jd + 2 * hh + 1], alpha[hh]);
        }
      }
    }

    // P in three bf16 terms, as A fragments: register r of key step kk holds
    // the pair sc[8 kk + 2 r], sc[8 kk + 2 r + 1].
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
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fsub_rn(d0, mf.x), __fsub_rn(d1, mf.y));
        a_hi[kk][r] = bf16x2_bits(hi);
        a_mid[kk][r] = bf16x2_bits(mid);
        a_lo[kk][r] = bf16x2_bits(lo);
      }
    }

    // O = alpha O + P V: the tile's P V goes into a fresh accumulator and is
    // added to O with round-to-nearest f32 adds, so the tensor cores' own
    // sums (which truncate) run over one tile's terms, not over the running
    // O.  V's 16 keys of step kk start at row 16 kk of each panel; the panels
    // (64 columns of D each) are kKVPanel bytes apart (the leading byte
    // offset of an MN-major operand), groups of 8 keys 1,024 bytes.
    float pv[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_sw128(sV + s * S::kTile + kk * 16 * 128, S::kKVPanel, 1024);
      wgmma_rs<D>(pv, a_lo[kk], dv, kk > 0 ? 1 : 0);
      wgmma_rs<D>(pv, a_mid[kk], dv, 1);
      wgmma_rs<D>(pv, a_hi[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = __fadd_rn(acc[i], pv[i]);
    ++it;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + r0 + 8 * hh;
    if (t >= tq) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0) {  // the quad's four lanes hold the same m, l
      const float m_nat = m[hh] == kNegInf ? kNegInf : __fmul_rn(m[hh], scale);
      lse[(static_cast<long long>(bi) * hq + h) * tq + t] = __fadd_rn(m_nat, logf(denom));
    }
    __nv_bfloat16* orow = out + bi * osb + h * osh + t * ost;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd + c0) =
          __floats2bfloat162_rn(__fdiv_rn(acc[4 * jd + 2 * hh], denom),
                                __fdiv_rn(acc[4 * jd + 2 * hh + 1], denom));
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
// for (B, H, T), read in boxes of 64 values x `rows` positions.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int t, int h,
             int b, const long long* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), static_cast<cuuint32_t>(rows),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int b, int hq,
             int hkv, int tq, int tk, const long long* st, Masks mk, float scale,
             cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap qm, km, vm;
  int err = make_map(encode, &qm, q, D, tq, hq, b, st, kBQ);
  if (err == 0) err = make_map(encode, &km, k, D, tk, hkv, b, st + 3, kBK);
  if (err == 0) err = make_map(encode, &vm, v, D, tk, hkv, b, st + 6, kBK);
  if (err != 0) return err;
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          Smem<D>::kAlloc);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const unsigned blocks = static_cast<unsigned>((tq + kBQ - 1) / kBQ) *
                          static_cast<unsigned>(b) * static_cast<unsigned>(hq);
  kernel<<<blocks, kThreads, Smem<D>::kAlloc, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, b, hq, hkv, tq, st[9], st[10], st[11],
      mk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, out; d 64 or 128.  strides: twelve element strides, (batch,
// head, time) of q, k, v and out; the feature axis is contiguous in each, and
// the q, k, v strides and pointers are 16-byte multiples (kernel.py checks).
// lse: null, or a contiguous (B, Hq, Tq) f32 buffer for each row's logsumexp.
// Returns a cudaError_t, or kErrEncode + CUresult when a tensor map is
// refused, or kErrNoEncode when cuTensorMapEncodeTiled cannot be found.
extern "C" int flash_attention_wgmma_launch(int device, int d, const void* q, const void* k,
                                            const void* v, void* out, void* lse, int b, int hq,
                                            int hkv,
                                            int tq, int tk, const long long* strides,
                                            int causal, int has_window, int window,
                                            int prefix_len, int kv_offset, float scale,
                                            void* stream) {
  cudaSetDevice(device);
  const Masks mk{causal, has_window, window, prefix_len, kv_offset, tk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_d<64>(q, k, v, out, static_cast<float*>(lse), b, hq, hkv, tq, tk, strides,
                          mk, scale, s);
    case 128:
      return launch_d<128>(q, k, v, out, static_cast<float*>(lse), b, hq, hkv, tq, tk, strides,
                           mk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
