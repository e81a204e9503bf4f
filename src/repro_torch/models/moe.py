"""Mixture-of-Experts FFN with token-sorted dispatch.

Port of ``repro/models/moe.py``.  Router: f32 softmax, top-k, the k gate
values renormalised.  Dispatch: each batch row's (token, expert)
assignments are sorted by expert id (stable, so tokens keep their order
within an expert's run), ranked within their run, and written into an
``(E, C + 1, D)`` buffer whose last column takes the assignments past the
capacity ``C = ceil(T·k / E) · capacity_factor``; the expert products are
one batched matmul over the experts; the combine adds each token's surviving
contributions back.  ``token_sort=False`` is the reference's ablation: ranks
from a one-hot cumulative sum in assignment order.

The reference runs one row at a time under ``vmap``; the port carries the
batch axis through every step, which computes the same values.

Two choices keep the experts and the sums equal to the reference's:

* **Ties in the top-k.** ``jax.lax.top_k`` puts the lower expert id first
  among equal probabilities; ``torch.topk`` promises no order, so the port
  takes the first k of a stable descending sort.
* **The combine.** The reference scatter-adds the ``T·k`` contributions into
  a zero ``(T, D)`` array in the compute dtype; XLA:CPU applies the updates
  in their order, so each token's contributions are added one after another
  in ascending expert id (sorted dispatch) or in top-k order (the ablation),
  rounding after each add.  On the card ``index_add_`` on bf16 is atomic,
  its order not fixed.  The port adds each token's k contributions in the
  reference's order, one tensor add at a time, so the card's result is
  deterministic and the CPU's equals the reference's order of rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh

from .params import normal


def moe_init(gen, d: int, f: int, n_experts: int, dtype=torch.float32):
    # The reference splits its key four ways (router, gate, up, out); the
    # port draws in that order from one generator.
    return {
        "router": normal(gen, (d, n_experts), 1.0, dtype, ("embed", None)),
        "wi_gate": normal(gen, (n_experts, d, f), 1.0, dtype, ("experts", "embed", "mlp")),
        "wi_up": normal(gen, (n_experts, d, f), 1.0, dtype, ("experts", "embed", "mlp")),
        "wo": normal(gen, (n_experts, f, d), 1.0, dtype, ("experts", "mlp", "embed")),
    }


def topk_lower_first(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values, the
    lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_of(t: int, k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert keeps for one row of ``t`` tokens (``moe.py:162``)."""
    return int(max(1, -(-t * k // n_experts) * capacity_factor))


def _ranks_in_runs(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values along the last
    axis (the ids must be sorted along it)."""
    n = sorted_ids.shape[-1]
    pos = torch.arange(n, device=sorted_ids.device).expand_as(sorted_ids)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    run_start = torch.cummax(torch.where(is_start, pos, -1), dim=-1).values
    return pos - run_start


def assignments(expert_ids: torch.Tensor, n_experts: int, capacity: int,
                token_sort: bool = True):
    """Each (token, j) assignment's rank within its expert and whether it is
    kept, both ``(B, T, k)`` in assignment order, and the order the
    reference's combine adds a token's k contributions in (``(B, T, k)``
    indices into j)."""
    b, t, k = expert_ids.shape
    flat = expert_ids.reshape(b, t * k)
    if token_sort:
        order = torch.argsort(flat, dim=-1, stable=True)          # the Morton sort
        rank_sorted = _ranks_in_runs(torch.gather(flat, 1, order))
        rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
        # A token's k experts are distinct: ascending expert id is the order
        # its contributions come in the sorted scatter-add.
        add_order = torch.argsort(expert_ids, dim=-1)
    else:
        onehot = F.one_hot(flat, n_experts)
        rank = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2, flat[..., None])[..., 0]
        add_order = torch.arange(k, device=flat.device).expand(b, t, k)
    rank = rank.reshape(b, t, k)
    return rank, rank < capacity, add_order


def moe_apply(
    p,
    x: torch.Tensor,             # (B, T, D)
    *,
    top_k: int,
    n_experts: int,
    capacity_factor: float = 1.25,
    activation: str = "swiglu",
    token_sort: bool = True,
    compute_dtype=torch.bfloat16,
    dispatch_sharding=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output (B, T, D) in the compute dtype, aux_loss ())``.
    ``dispatch_sharding``: the ``sharding.Constraint`` that pins the expert
    dim of the dispatched rows and of the expert outputs, (E, B·C, D), to the
    tensor axis in a partitioned step (the reference's, ``moe.py:112, 123``);
    it does nothing to plain tensors."""
    b, t, d = x.shape
    logits = torch.matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                       # (B, T, E)
    gate_vals, expert_ids = topk_lower_first(probs, top_k)      # (B, T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Load-balancing auxiliary loss (Switch §2.2), over all tokens; a token's
    # k experts are distinct, so its one-hot sum is 0 or 1 an expert.
    # (Counts by scatter_add: ``bincount`` on the card reads the largest id
    # back to the host.)
    me = probs.mean(dim=(0, 1))
    ids = expert_ids.reshape(-1)
    ce = torch.zeros(n_experts, device=x.device).scatter_add_(
        0, ids, torch.ones(ids.shape, device=x.device)) / (b * t)
    aux_loss = n_experts * torch.sum(me * ce)

    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    rank, keep, add_order = assignments(expert_ids, n_experts, capacity, token_sort)

    # Dispatch: kept assignments fill distinct (expert, rank) slots; the rest
    # land in the overflow column C, which is dropped.
    cd = compute_dtype
    rows = torch.arange(b, device=x.device)[:, None, None]
    buf = torch.zeros((b, n_experts, capacity + 1, d), dtype=cd, device=x.device)
    buf[rows, expert_ids, torch.where(keep, rank, capacity)] = \
        x.to(cd)[:, :, None].expand(b, t, top_k, d)
    # The expert products: one batched matmul over the experts, every row's
    # slots of an expert side by side, (E, B·C, D) @ (E, D, F) (a (B, E, C,
    # D) @ (E, D, F) matmul would copy the weights B times to broadcast).
    xe = buf[:, :, :capacity].transpose(0, 1).reshape(n_experts, b * capacity, d)
    xe = sh.constrain(dispatch_sharding, xe)
    gate = torch.bmm(xe, p["wi_gate"].to(cd))                   # (E, B·C, F)
    up = torch.bmm(xe, p["wi_up"].to(cd))
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" else F.silu(gate)
    expert_out = torch.bmm(act * up, p["wo"].to(cd))            # (E, B·C, D)
    expert_out = sh.constrain(dispatch_sharding, expert_out)
    expert_out = expert_out.reshape(n_experts, b, capacity, d).transpose(0, 1)

    gathered = expert_out[rows, expert_ids, torch.where(keep, rank, 0)]   # (B, T, k, D)
    contrib = torch.where(keep[..., None], gathered * gate_vals.to(cd)[..., None], 0.0)
    return combine(contrib, add_order), aux_loss


def combine(contrib: torch.Tensor, add_order: torch.Tensor) -> torch.Tensor:
    """Each token's k contributions ``(B, T, k, D)`` added into a zero
    ``(B, T, D)`` one after another in ``add_order``, rounding to their
    dtype after each add: the reference's scatter-add, deterministic."""
    contrib = torch.gather(contrib, 2, add_order[..., None].expand_as(contrib))
    out = torch.zeros_like(contrib[:, :, 0])
    for j in range(contrib.shape[2]):
        out = out + contrib[:, :, j]
    return out

