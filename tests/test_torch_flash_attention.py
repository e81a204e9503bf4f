"""The port's flash attention against the reference's Pallas kernel
(interpret mode, 16 × 16 or 32 × 32 blocks), on the CPU.

The port's ``impl="cuda"`` on CPU tensors is its plain online softmax; the
``"reference"`` oracle and ``"chunked"`` are checked too.  Tolerances: f32
``rtol=2e-4, atol=2e-5``, as the reference's own tests hold its Pallas
kernel against its oracle (the softmax sums run in another order); bf16 one
bf16 ulp of the output, ``rtol=2**-7`` (the f32 results round once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as port_fa

TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2**-7, atol=1e-6)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: ((B, Hq, Hkv, Tq, Tk, D), mask kwargs, block)
CASES = {
    "causal_group2": ((1, 4, 2, 48, 48, 16), dict(causal=True), 16),
    "full_group1": ((1, 2, 2, 40, 40, 16), dict(causal=False), 16),
    "window_group4": ((1, 4, 1, 64, 64, 16), dict(causal=True, window=12), 16),
    "prefix": ((1, 2, 1, 48, 48, 16), dict(causal=True, prefix_len=20), 16),
    "window_prefix": ((1, 2, 2, 48, 48, 16), dict(causal=True, window=8, prefix_len=5), 16),
    "kv_offset_decode": ((2, 4, 2, 1, 70, 16), dict(causal=True, kv_offset=69), 32),
    "kv_offset_chunk": ((1, 2, 1, 20, 52, 32), dict(causal=True, kv_offset=32), 16),
    "padded_tk": ((1, 2, 2, 33, 45, 16), dict(causal=False), 16),
    "padded_causal_group4": ((1, 8, 2, 37, 37, 64), dict(causal=True), 32),
}


def _qkv(shape, dtype, seed):
    b, hq, hkv, tq, tk, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]
    js = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    ts = [torch.from_numpy(to_np(j.astype(jnp.float32))).to(TORCH[dtype]) for j in js]
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax_pallas(case, dtype):
    shape, kw, block = CASES[case]
    (qj, kj, vj), (q, k, v) = _qkv(shape, dtype, sorted(CASES).index(case))
    want = fa_ops.flash_attention(qj, kj, vj, impl="pallas", block_q=block, block_k=block,
                                  **kw)
    want = to_np(want.astype(jnp.float32))
    before = fa_kernel.launches
    for impl in ("cuda", "chunked", "reference"):
        got = port_fa.flash_attention(q, k, v, impl=impl, block_q=block, block_k=block, **kw)
        assert got.dtype == q.dtype and got.shape == q.shape, impl
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=impl, **TOL[dtype])
    assert fa_kernel.launches == before             # CPU tensors: the plain version


def test_fully_masked_rows_are_zero():
    """A query row whose keys are all hidden gives 0, not NaN (the final
    max(l, 1e-30)); here a window of 4 with kv_offset past every key."""
    (qj, kj, vj), (q, k, v) = _qkv((1, 2, 1, 8, 16, 16), "float32", 3)
    kw = dict(causal=True, window=4, kv_offset=40)
    want = to_np(fa_ops.flash_attention(qj, kj, vj, impl="pallas", block_q=16, block_k=16,
                                        **kw))
    got = port_fa.flash_attention(q, k, v, impl="cuda", block_k=16, **kw).numpy()
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("q_lo,q_hi,k_lo,k_hi,kw,want", [
    (0, 15, 16, 31, dict(causal=True, window=None, prefix_len=0), False),
    (0, 16, 16, 31, dict(causal=True, window=None, prefix_len=0), True),
    (40, 47, 0, 15, dict(causal=True, window=8, prefix_len=0), False),
    (40, 47, 0, 15, dict(causal=True, window=8, prefix_len=4), True),
    (40, 47, 16, 33, dict(causal=True, window=8, prefix_len=0), True),
    (0, 7, 8, 15, dict(causal=False, window=None, prefix_len=0), True),
])
def test_block_visible_is_exact(q_lo, q_hi, k_lo, k_hi, kw, want):
    """The block skip of the plain version and the kernel against the
    element-wise mask: a block is skipped exactly when no pair is visible."""
    from repro_torch.kernels.flash_attention.ref import visible

    qi = torch.arange(q_lo, q_hi + 1)[:, None]
    ki = torch.arange(k_lo, k_hi + 1)[None, :]
    assert bool(visible(qi, ki, **kw).any()) == want
    assert port_fa.block_visible(q_lo, q_hi, k_lo, k_hi, **kw) == want


# name: ((B, Hq, Hkv, T, D), mask kwargs) of the tensor-core kernels'
# arithmetic: the D 128 kernel's causal GQA 3, and D 256 at small T with
# paligemma's prefix-LM mask and MQA group 8 and recurrentgemma's window with
# group 16 (the D 256 kernel sums S as the D 128 one does, so one reference
# serves both).
WGMMA_CASES = {
    "causal_g3_d128": ((1, 6, 2, 130, 128), dict(causal=True)),
    "prefix_g8_d256": ((1, 8, 1, 100, 256), dict(causal=True, prefix_len=20)),
    "window_g16_d256": ((1, 16, 1, 130, 256), dict(causal=True, window=40)),
}


@pytest.mark.parametrize("case,q_scale", [
    pytest.param(case, q_scale,
                 id=str(q_scale) if case == "causal_g3_d128" else f"{case}-{q_scale}")
    for case in WGMMA_CASES for q_scale in (1.0, 8.0)])
def test_wgmma_arithmetic_matches_jax_pallas(case, q_scale):
    """The tensor-core kernels' arithmetic (P in three bf16 terms, f32
    accumulation; ``ref.wgmma_arithmetic_ref``) against the Pallas kernel in
    interpret mode, bf16, q at unit scale and scaled by 8 (a sharp softmax);
    one bf16 ulp."""
    from repro_torch.kernels.flash_attention.ref import wgmma_arithmetic_ref

    (b, hq, hkv, t, d), kw = WGMMA_CASES[case]
    rng = np.random.default_rng(7 + sorted(WGMMA_CASES).index(case))
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    arrs[0] *= q_scale
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = to_np(fa_ops.flash_attention(*js, impl="pallas", block_q=64, block_k=64,
                                        **kw).astype(jnp.float32))
    q, k, v = (torch.from_numpy(to_np(j.astype(jnp.float32))).bfloat16() for j in js)
    got = wgmma_arithmetic_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL["bfloat16"])
