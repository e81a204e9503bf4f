"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's.

Inputs from numpy seeds; the reference's weights carried across.  Expert ids
and the kept assignments exact; f32 outputs ``atol=5e-5`` (seen: 9e-6 at
outputs up to ~30: products summed in other orders); the aux loss
``rtol=1e-6``; bf16 outputs a relative L2 of 2e-2 (the two frameworks round
the bf16 expert products at other places; seen: 5e-3).  The reference's
dispatch internals (stable argsort, ``_ranks_in_runs``, the one-hot ranks)
are rebuilt here from its own functions to read its keep mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.models import moe as jmoe
from repro.models.params import unzip
from repro_torch.models import moe as tmoe

ATOL = 5e-5
CASES = {   # (E, k, D, F, B, T, capacity_factor)
    "olmoe_like": (8, 4, 32, 48, 2, 40, 1.25),
    "drops": (8, 2, 32, 48, 2, 64, 0.25),
    "top2_of_4": (4, 2, 16, 32, 3, 17, 1.25),
    "decode_row": (8, 4, 32, 48, 4, 1, 4.0),
}


def _setup(e, k, d, f, b, t, seed=0, router_zero=False):
    params = unzip(jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e))[0]
    if router_zero:
        params["router"] = jnp.zeros_like(params["router"])
    x = np.random.default_rng(seed).normal(0, 1, (b, t, d)).astype(np.float32)
    pt = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    return params, pt, x


def _jax_routing(params, x, k, e, capacity, token_sort):
    """The reference's expert ids and keep mask, (B, T, k) in assignment order."""
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", jnp.asarray(x), params["router"]), -1)
    _, ids = jax.lax.top_k(probs, k)
    b, t, _ = ids.shape
    keeps = []
    for row in np.asarray(ids).reshape(b, t * k):
        flat = jnp.asarray(row)
        if token_sort:
            order = jnp.argsort(flat, stable=True)
            rank_sorted = jmoe._ranks_in_runs(flat[order])
            rank = jnp.zeros_like(rank_sorted).at[order].set(rank_sorted)
        else:
            onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
            rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(t * k), flat]
        keeps.append(np.asarray(rank < capacity))
    return np.asarray(ids), np.stack(keeps).reshape(b, t, k)


@pytest.mark.parametrize("token_sort", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, token_sort):
    e, k, d, f, b, t, cf = CASES[case]
    params, pt, x = _setup(e, k, d, f, b, t, seed=sorted(CASES).index(case))
    kw = dict(top_k=k, n_experts=e, capacity_factor=cf, activation="swiglu",
              token_sort=token_sort)
    want, aux_want = jmoe.moe_apply(params, jnp.asarray(x), compute_dtype=jnp.float32, **kw)
    got, aux_got = tmoe.moe_apply(pt, torch.from_numpy(x), compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux_got), float(aux_want), rtol=1e-6)

    capacity = tmoe.capacity_of(t, k, e, cf)
    ids_want, keep_want = _jax_routing(params, x, k, e, capacity, token_sort)
    probs = torch.softmax(torch.from_numpy(x) @ pt["router"], -1)
    _, ids = tmoe.topk_lower_first(probs, k)
    np.testing.assert_array_equal(ids.numpy(), ids_want)
    _, keep, _ = tmoe.assignments(ids, e, capacity, token_sort)
    np.testing.assert_array_equal(keep.numpy(), keep_want)
    if case == "drops":
        assert 0 < int((~keep).sum()) < keep.numel()
    if case == "decode_row":        # the decode capacity keeps every assignment
        assert capacity == 4 and bool(keep.all())


def test_capacity_rule_is_the_references():
    for t in (1, 3, 17, 64, 2048):
        for k, e in ((2, 16), (8, 64), (2, 4)):
            for cf in (0.25, 1.0, 1.25, 4.0):
                want = int(max(1, -(-t * k // e) * cf))
                assert tmoe.capacity_of(t, k, e, cf) == want
    assert tmoe.capacity_of(2048, 8, 64, 1.25) == 320        # olmoe's prefill rows


def test_top_k_ties_go_to_the_lower_expert():
    """A zero router makes every probability equal: the reference's top-k
    and the port's both take experts 0..k-1, and every output matches."""
    params, pt, x = _setup(8, 3, 16, 32, 2, 9, router_zero=True)
    kw = dict(top_k=3, n_experts=8, capacity_factor=4.0, activation="geglu")
    want, _ = jmoe.moe_apply(params, jnp.asarray(x), compute_dtype=jnp.float32, **kw)
    got, _ = tmoe.moe_apply(pt, torch.from_numpy(x), compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    _, ids = tmoe.topk_lower_first(torch.full((2, 9, 8), 0.125), 3)
    np.testing.assert_array_equal(ids.numpy(), np.broadcast_to([0, 1, 2], (2, 9, 3)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(jnp.full((2, 9, 8), 0.125),
                                                                        3)[1]))


@pytest.mark.parametrize("token_sort", [True, False])
def test_moe_bf16_matches_jax(token_sort):
    e, k, d, f, b, t, cf = CASES["olmoe_like"]
    params, pt, x = _setup(e, k, d, f, b, t, seed=7)
    kw = dict(top_k=k, n_experts=e, capacity_factor=cf, activation="swiglu",
              token_sort=token_sort)
    want = to_np(jmoe.moe_apply(params, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                                **kw)[0]).astype(np.float32)
    got = tmoe.moe_apply(pt, torch.from_numpy(x), compute_dtype=torch.bfloat16, **kw)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


@pytest.mark.parametrize("token_sort", [True, False])
def test_combine_is_the_references_scatter_add_bit_for_bit(token_sort):
    """The same bf16 contributions: the port's ordered adds equal the
    reference's ``zeros.at[s_token].add`` over its (sorted or unsorted)
    assignment list, bit for bit."""
    b, t, k, d, e = 2, 13, 4, 24, 8
    rng = np.random.default_rng(3)
    ids = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(t)]) for _ in range(b)])
    contrib = rng.normal(0, 3, (b, t, k, d)).astype(np.float32)
    ct = torch.from_numpy(contrib).bfloat16()
    _, _, add_order = tmoe.assignments(torch.from_numpy(ids), e, capacity=t * k,
                                       token_sort=token_sort)
    got = tmoe.combine(ct, add_order).float().numpy()
    for r in range(b):
        flat_e = ids[r].reshape(-1)
        flat_tok = np.repeat(np.arange(t), k)
        order = np.argsort(flat_e, kind="stable") if token_sort else np.arange(t * k)
        upd = jnp.asarray(ct[r].float().numpy().reshape(t * k, d)[order], jnp.bfloat16)
        want = jnp.zeros((t, d), jnp.bfloat16).at[jnp.asarray(flat_tok[order])].add(upd)
        np.testing.assert_array_equal(got[r], to_np(want.astype(jnp.float32)))
