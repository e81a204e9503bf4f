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

Over DTensors (a partitioned step, ``launch/dryrun.py``) the layer is the
reference's expert parallelism, by explicit rules (``local_map``) rather
than DTensor's: the rows stay on the data axes and the experts go on the
axes ``dispatch_sharding`` names for them (the tensor axis ``model``); the
reference's ``vmap`` leaves the row dim of its constraint unconstrained,
and its partitioner keeps the batch split.  Every rank routes its rows
(the same on every rank of ``model``), and one all-reduce an axis over the
data axes sums the router's statistics, so the aux loss is the one-device
value.  It fills the dispatch buffer's slots of its own experts only, so
the redistribution from the batch split to the expert split moves nothing;
after the expert products, one all-gather over ``model`` brings every
expert's outputs to each rank's rows, where the gather and ``combine`` run
in the one-device order.

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

import math
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
    ``dispatch_sharding``: over DTensors, the ``sharding.Constraint`` whose
    spec's first entry names the axes the expert dim of the dispatched rows
    and of the expert outputs, (E, B·C, D), goes on (the reference's,
    ``moe.py:112, 123``; see the module docstring); plain tensors ignore it."""
    if sh.is_dtensor(x):
        return _moe_partitioned(p, x, top_k=top_k, n_experts=n_experts,
                                capacity_factor=capacity_factor, activation=activation,
                                token_sort=token_sort, compute_dtype=compute_dtype,
                                dispatch_sharding=dispatch_sharding)
    b, t, d = x.shape
    probs, gate_vals, expert_ids = _route(p["router"], x, top_k)

    # Load-balancing auxiliary loss (Switch §2.2), over all tokens.
    me = probs.mean(dim=(0, 1))
    ce = _expert_counts(expert_ids, n_experts) / (b * t)
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
    xe = buf[:, :, :capacity].transpose(0, 1).reshape(n_experts, b * capacity, d)
    expert_out = _expert_ffn(xe, p["wi_gate"], p["wi_up"], p["wo"], activation, cd)
    return _gather_combine(expert_out, gate_vals, expert_ids, rank, keep, add_order,
                           capacity), aux_loss


def _route(router, x: torch.Tensor, top_k: int):
    """The router's probabilities ``(B, T, E)`` and each token's top-k
    experts ``(B, T, k)`` with their gate values renormalised."""
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = topk_lower_first(probs, top_k)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_ids


def _expert_counts(expert_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments an expert, f32 ``(E,)``; a token's k experts are
    distinct, so this is its one-hot sum.  (By ``scatter_add``: ``bincount``
    on the card reads the largest id back to the host.)"""
    ids = expert_ids.reshape(-1)
    return torch.zeros(n_experts, device=ids.device).scatter_add_(
        0, ids, torch.ones(ids.shape, device=ids.device))


def _expert_ffn(xe: torch.Tensor, wi_gate, wi_up, wo, activation: str, cd) -> torch.Tensor:
    """The expert products: one batched matmul over the experts, every
    row's slots of an expert side by side, (E, B·C, D) @ (E, D, F) (a (B, E,
    C, D) @ (E, D, F) matmul would copy the weights B times to broadcast)."""
    gate = torch.bmm(xe, wi_gate.to(cd))                        # (E, B·C, F)
    up = torch.bmm(xe, wi_up.to(cd))
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" else F.silu(gate)
    return torch.bmm(act * up, wo.to(cd))                       # (E, B·C, D)


def _gather_combine(expert_out, gate_vals, expert_ids, rank, keep, add_order, capacity: int):
    """Each kept assignment's expert output ``(E, B·C, D)`` times its gate
    value, a token's contributions added in ``add_order`` (``combine``)."""
    e, _, d = expert_out.shape
    b = expert_ids.shape[0]
    out = expert_out.reshape(e, b, capacity, d).transpose(0, 1)
    rows = torch.arange(b, device=out.device)[:, None, None]
    gathered = out[rows, expert_ids, torch.where(keep, rank, 0)]      # (B, T, k, D)
    contrib = torch.where(keep[..., None], gathered * gate_vals.to(out.dtype)[..., None], 0.0)
    return combine(contrib, add_order)


def combine(contrib: torch.Tensor, add_order: torch.Tensor) -> torch.Tensor:
    """Each token's k contributions ``(B, T, k, D)`` added into a zero
    ``(B, T, D)`` one after another in ``add_order``, rounding to their
    dtype after each add: the reference's scatter-add, deterministic."""
    contrib = torch.gather(contrib, 2, add_order[..., None].expand_as(contrib))
    out = torch.zeros_like(contrib[:, :, 0])
    for j in range(contrib.shape[2]):
        out = out + contrib[:, :, j]
    return out


def _moe_partitioned(p, x, *, top_k, n_experts, capacity_factor, activation, token_sort,
                     compute_dtype, dispatch_sharding):
    """``moe_apply`` over DTensors, by the rule of the module docstring."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = x.device_mesh
    names = tuple(dmesh.mesh_dim_names)
    dp, _ = sh.mesh_dims(dmesh)
    b, t, d = x.shape
    cd = compute_dtype
    if b % math.prod(dmesh.size(i) for i in dp):
        dp = []
    part = dispatch_sharding.spec[0] if dispatch_sharding is not None else None
    ex = [names.index(a) for a in ((part,) if isinstance(part, str) else tuple(part or ()))]
    if n_experts % math.prod(dmesh.size(i) for i in ex):
        ex = []
    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    placed = lambda on_dp, on_ex=Replicate(): sh.placed(dmesh.ndim, (dp, on_dp), (ex, on_ex))
    rows_pl = placed(Shard(0))

    def route(x, router):
        probs, gate_vals, expert_ids = _route(router, x, top_k)
        # The router's statistics over every rank's rows: Σ probs and the
        # expert counts, one all-reduce a data axis.
        stats = torch.stack([probs.sum(dim=(0, 1)), _expert_counts(expert_ids, n_experts)])
        for i in dp:
            stats = sh.sum_across(stats, (dmesh, i))
        aux_loss = n_experts * torch.sum((stats[0] / (b * t)) * (stats[1] / (b * t)))
        rank, keep, add_order = assignments(expert_ids, n_experts, capacity, token_sort)
        return gate_vals, expert_ids, rank, keep, add_order, aux_loss

    gate_vals, expert_ids, rank, keep, add_order, aux_loss = local_map(
        route, out_placements=(rows_pl,) * 5 + (placed(Replicate()),),
        in_placements=(rows_pl, placed(Replicate())),
        in_grad_placements=(rows_pl, placed(Partial())),
        device_mesh=dmesh, redistribute_inputs=True)(x, p["router"])

    def experts(x, expert_ids, rank, keep, wg, wu, wo):
        # This rank's experts [e0, e0 + E_l): their kept assignments fill
        # their slots; every other assignment lands in the dropped column.
        n_local = wg.shape[0]
        e0 = 0
        for i in ex:
            e0 = e0 * dmesh.size(i) + dmesh.get_local_rank(i)
        e0 *= n_local
        bl = x.shape[0]
        mine = keep & (expert_ids >= e0) & (expert_ids < e0 + n_local)
        rows = torch.arange(bl, device=x.device)[:, None, None]
        buf = torch.zeros((bl, n_local, capacity + 1, d), dtype=cd, device=x.device)
        buf[rows, torch.where(mine, expert_ids - e0, 0), torch.where(mine, rank, capacity)] = \
            x.to(cd)[:, :, None].expand(bl, t, top_k, d)
        xe = buf[:, :, :capacity].transpose(0, 1).reshape(n_local, bl * capacity, d)
        return _expert_ffn(xe, wg, wu, wo, activation, cd)

    w_pl = placed(Replicate(), Shard(0))
    expert_out = local_map(
        experts, out_placements=(placed(Shard(1), Shard(0)),),
        in_placements=(rows_pl,) * 4 + (w_pl,) * 3,
        in_grad_placements=(placed(Shard(0), Partial()),) + (rows_pl,) * 3
        + (placed(Partial(), Shard(0)),) * 3,
        device_mesh=dmesh, redistribute_inputs=True)(
            x, expert_ids, rank, keep, p["wi_gate"], p["wi_up"], p["wo"])
    # Every expert's outputs to each rank's rows: one all-gather over the
    # expert axes (its backward takes each rank's block of the gradient).
    expert_out = expert_out.redistribute(dmesh, placed(Shard(1)))
    combined = lambda *a: _gather_combine(*a, capacity)
    out = local_map(combined, out_placements=(rows_pl,),
                    in_placements=(placed(Shard(1)),) + (rows_pl,) * 5,
                    device_mesh=dmesh, redistribute_inputs=True)(
                        expert_out, gate_vals, expert_ids, rank, keep, add_order)
    return out, aux_loss
