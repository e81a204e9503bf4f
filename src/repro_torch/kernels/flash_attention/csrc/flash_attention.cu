// Forward online-softmax ("flash") attention with GQA, causal / sliding-window
// / prefix-LM masks, a kv_offset and a kv_len padding mask.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_flat
// (the Pallas _flash_kernel).  That kernel runs the grid (B*Hq, Tq/BQ, Tk/BK)
// with the KV axis innermost and sequential, carrying the running max, the
// running sum and the unnormalised accumulator in revisited output blocks, and
// executes every KV block, masked ones included.  CUDA blocks run in no order
// and share nothing, so here the KV axis is a loop inside the block.
//
// Design: one block of 256 threads per (64-query tile, batch * query head).
// The query tile is staged once in shared memory as f32; the loop walks the
// KV tiles of 64 keys, staging K and V as f32 from KV head h / group (read
// directly, never repeated), and skips a tile only when the masks hide all of
// it, which changes no result (a hidden tile adds exp(...) * 0 and rescales
// by exp(0) = 1 in the Pallas kernel).  The 16 x 16 threads own rows
// ty + 16 i (i < 4) of the tile: for S = Q K^T they own columns tx + 16 j
// (j < 4), for the accumulator columns tx + 16 jj (jj < D / 16), so the
// running max, sum and the rescaling of a row stay in the registers of the 16
// threads of one half-warp, reduced with __shfl_xor_sync (a butterfly: every
// lane ends with the same bits).  P goes through shared memory to the P V
// product.  Rows of Q and K are padded to D + 1 floats so that the 16 lanes of
// a half-warp read 16 banks.  Shared memory: 29 KB (D = 16) to 209 KB
// (D = 256), above 48 KB by the dynamic opt-in.
//
// Arithmetic: f32 throughout, as the Pallas kernel upcasts its blocks
// (kernel.py:59-61), with its sentinel and order of masking: s = (q . k) *
// scale; hidden -> NEG_INF = -1e30 (not -inf); m_new = max(m, max_row s);
// alpha = exp(m - m_new); p = exp(s - m_new), then p = 0 where hidden, so a
// hidden tile adds nothing and no NaN arises; l = alpha l + sum p;
// acc = alpha acc + P V; out = acc / max(l, 1e-30), so a row whose keys are
// all hidden is 0.  Visible: k < kv_len and (((not causal) or q + kv_offset >=
// k) and ((no window) or q + kv_offset - k < window) or k < prefix_len).  The
// output is rounded once to the input's dtype (the Pallas path writes f32 and
// its wrapper casts, ops.py:153).  With an lse buffer the kernel also writes
// each row's m + log(max(l, 1e-30)) in f32, (B, Hq, Tq) (the Pallas kernel's
// m and l outputs, kernel.py:153-166, formed as chunked_vjp.py:118 forms
// them): the training slice's backward reads it.
//
// Bound on this card: at the LM prefill shape (B 4, Hq 24, Hkv 8, T 2048,
// D 128, causal, bf16) the causal half of Q K^T and P V is 1.03e11 FLOP:
// 0.104 ms at the 989 TFLOP/s bf16 tensor-core rate, 1.54 ms at 67 TFLOP/s
// f32; q, k, v and the output are 134 MB, 0.040 ms.  This first kernel runs
// f32 FMAs on the SIMT cores from shared memory (two shared loads per FMA
// pair in the Q K^T loop), so it is bound by shared-memory bandwidth at some
// fraction of the f32 rate; wgmma on bf16 tiles fed by TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Masks {
  int causal, has_window, window, prefix_len, kv_offset, kv_len;
};

// Absolute query position qa (= row + kv_offset) against key k.
__device__ __forceinline__ bool visible(const Masks& mk, int qa, int k) {
  bool vis = true;
  if (mk.causal) vis = qa >= k;
  if (mk.has_window) vis = vis && (qa - k) < mk.window;
  if (mk.prefix_len > 0) vis = vis || k < mk.prefix_len;
  return k < mk.kv_len && vis;
}

// Whether any (q, k) with absolute q in [qlo, qhi] and k in [klo, khi]
// (khi < kv_len) is visible.  The differences q - k fill [qlo - khi, qhi - klo],
// so the causal and window terms together hide the tile exactly when that
// range misses [0, window) (or [0, inf) without a window).
__device__ __forceinline__ bool tile_visible(const Masks& mk, int qlo, int qhi, int klo,
                                             int khi) {
  if (mk.prefix_len > 0 && klo < mk.prefix_len) return true;
  if (mk.causal && qhi - klo < 0) return false;
  if (mk.has_window && qlo - khi >= mk.window) return false;
  return true;
}

template <int D>
struct Smem {
  static constexpr int DP = D + 1;  // padded row of Q and K
  static constexpr int PP = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * DP;
  static constexpr int kV = kK + kBK * DP;
  static constexpr int kP = kV + kBK * D;
  static constexpr int kFloats = kP + kBQ * PP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int hq, int group,
                           int tq, long long qsb, long long qsh, long long qst, long long ksb,
                           long long ksh, long long kst, long long vsb, long long vsh,
                           long long vst, long long osb, long long osh, long long ost,
                           Masks mk, float scale) {
  using S = Smem<D>;
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem + S::kQ;
  float* sK = smem + S::kK;
  float* sV = smem + S::kV;
  float* sP = smem + S::kP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / group;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  T* ob = out + b * osb + h * osh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int t = q0 + r;
    sQ[r * S::DP + c] = t < tq ? to_f(qb[t * qst + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }

  const int qlo = q0 + mk.kv_offset;
  const int qhi = min(q0 + kBQ, tq) - 1 + mk.kv_offset;
  const int tk = mk.kv_len;
  for (int k0 = 0; k0 < tk; k0 += kBK) {
    if (!tile_visible(mk, qlo, qhi, k0, min(k0 + kBK, tk) - 1)) continue;  // block-uniform
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int t = k0 + r;
      const bool in = t < tk;
      sK[r * S::DP + c] = in ? to_f(kb[t * kst + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[t * vst + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * S::DP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * S::DP + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qa = q0 + ty + 16 * i + mk.kv_offset;
      bool vis[4];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(mk, qa, k0 + tx + 16 * j);
        s[i][j] = vis[j] ? __fmul_rn(s[i][j], scale) : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * S::PP + tx + 16 * j] = p;
        rs = __fadd_rn(rs, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(alpha, l[i]), rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = __fmul_rn(acc[i][jj], alpha);
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * S::PP + kk];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float vv = sV[kk * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the row's 16 threads hold the same m and l (butterfly reductions)
    if (lse != nullptr && tx == 0) lse[static_cast<long long>(bh) * tq + t] = m[i] + logf(denom);
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      ob[t * ost + tx + 16 * jj] = from_f<T>(__fdiv_rn(acc[i][jj], denom));
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, float* lse,
                         int b, int hq, int hkv, int tq, const long long* st, Masks mk,
                         float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, hq, hq / hkv, tq, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], mk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, void* out, float* lse,
                     int b, int hq, int hkv, int tq, const long long* st, Masks mk, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch_typed<T, 16>(q, k, v, out, lse, b, hq, hkv, tq, st, mk, scale, stream);
    case 64: return launch_typed<T, 64>(q, k, v, out, lse, b, hq, hkv, tq, st, mk, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, lse, b, hq, hkv, tq, st, mk, scale, stream);
    case 256:
      return launch_typed<T, 256>(q, k, v, out, lse, b, hq, hkv, tq, st, mk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (kernel.py DTYPES).  strides: twelve
// element strides, (batch, head, time) of q, k, v and out; the feature axis
// is contiguous in each.  lse: null, or a contiguous (B, Hq, Tq) f32 buffer.
extern "C" int flash_attention_launch(int device, int dtype, int d, const void* q,
                                      const void* k, const void* v, void* out, void* lse,
                                      int b, int hq,
                                      int hkv, int tq, int tk, const long long* strides,
                                      int causal, int has_window, int window, int prefix_len,
                                      int kv_offset, float scale, void* stream) {
  cudaSetDevice(device);
  const Masks mk{causal, has_window, window, prefix_len, kv_offset, tk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(d, q, k, v, out, static_cast<float*>(lse), b, hq, hkv, tq, strides,
                            mk, scale, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(d, q, k, v, out, static_cast<float*>(lse), b, hq, hkv, tq,
                                    strides, mk, scale, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
