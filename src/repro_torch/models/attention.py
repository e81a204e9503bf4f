"""Attention blocks: GQA/MQA with RoPE, full / sliding-window / prefix-LM
masking, flash attention for prefill, and a KV-cache decode step.

Port of ``repro/models/attention.py``.

* Prefill (``attention_apply``) calls ``kernels.flash_attention``:
  ``impl="cuda"`` is the hand-written kernel (the reference's ``"pallas"``),
  ``"chunked"`` the plain online softmax, ``"reference"`` the O(T²) oracle.
  The ``(B, T, H, Dh)`` projections go to the kernel as ``(B, H, T, Dh)``
  views, without a copy.
* Decode (``attention_decode``) is a masked product over the cache in f32,
  plain PyTorch as in the reference: with one query token the scores are
  ``(B, H, 1, S)``, bound by bandwidth, no flash needed.  It writes the new
  K/V into the cache **in place** (the reference returns a new cache from
  ``dynamic_update_slice``) and returns the same dict.

Over DTensors (a partitioned step, ``launch/dryrun.py``) both run on each
rank's block under ``local_map``, the attention's explicit sharding rule
(the kernel is no aten op, and the decode's cache writes and masks need the
block's global positions):

* Prefill / train: the batch over the data axes and, on the tensor axis
  ``model``, the query heads where they divide it (a rank's K/V heads cut
  from replicated K/V where those do not); else, with the
  ``context_sharding`` hook (the reference's, ``attention.py:72, 92``), the
  GQA-folded query rows ``(B, Hkv, group·T, D)`` split over ``model`` with
  K/V whole, each rank attending its rows at their positions
  (``kv_offset``); else replicated.
* Decode: the cache's own blocks.  A cache split over heads attends its
  heads; one split over its sequence (flash-decoding's split-KV) writes the
  new K/V on the rank that holds the slot and combines the ranks' partial
  softmaxes with max / sum all-reduces over ``model``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import rope
from .params import normal

NEG_INF = -1e30


def attention_init(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.float32):
    return {
        "wq": normal(gen, (d, n_heads, head_dim), 1.0, dtype, ("embed", "heads", "head_dim")),
        "wk": normal(gen, (d, n_kv, head_dim), 1.0, dtype, ("embed", "kv", "head_dim")),
        "wv": normal(gen, (d, n_kv, head_dim), 1.0, dtype, ("embed", "kv", "head_dim")),
        "wo": normal(gen, (n_heads, head_dim, d), 1.0, dtype, ("heads", "head_dim", "embed")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _unproj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    h, k, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def proj_heads(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads.  A
    DTensor ``x`` split along its sequence takes the sequence-parallel rule
    (``sharding.rows_local``); another takes DTensor's."""
    x, w = x.to(compute_dtype), w.to(compute_dtype)
    if sh.seq_split(x):
        return sh.rows_local(_proj, x, w)
    d, h, k = w.shape
    y = torch.matmul(x, sh.flattened(w.reshape(d, h * k), -1, h))
    return sh.unflattenable(y, -1, h).reshape(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, compute_dtype) -> torch.Tensor:
    """einsum("bthk,hkd->btd") with ``out`` (B, T, H, Dh), by the rules of
    :func:`proj_heads`."""
    out, wo = out.to(compute_dtype), wo.to(compute_dtype)
    if sh.seq_split(out):
        return sh.rows_local(_unproj, out, wo)
    h, k, d = wo.shape
    flat = sh.flattened(out.reshape(*out.shape[:-2], h * k), -1, h)
    return torch.matmul(flat, sh.flattened(wo.reshape(h * k, d), 0, h))


def _project_qkv(p, x: torch.Tensor, positions: Optional[torch.Tensor], theta: float,
                 compute_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = proj_heads(x, p["wq"], compute_dtype)
    k = proj_heads(x, p["wk"], compute_dtype)
    v = proj_heads(x, p["wv"], compute_dtype)
    if positions is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def attention_apply(
    p,
    x: torch.Tensor,                # (B, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,            # prefix-LM: first P positions bidirectional
    rope_theta: float = 10000.0,
    impl: str = "chunked",
    block_q: int = 512,
    block_k: int = 1024,
    compute_dtype=torch.bfloat16,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attention
    context_sharding=None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``context_sharding``: the
    ``sharding.Constraint`` of the folded query rows of a partitioned step
    (see the module docstring); it does nothing to plain tensors."""
    b, t, d = x.shape
    positions = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    use_rope = kv_override is None  # cross-attention is position-free here
    q, k, v = _project_qkv(p, x, positions if use_rope else None, rope_theta, compute_dtype)
    if kv_override is not None:
        k, v = kv_override
        causal = False

    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)   # (B, H, T, Dh) views
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, impl=impl,
              block_q=block_q, block_k=block_k)
    if sh.is_dtensor(q):
        out = _flash_partitioned(q, k, v, context_sharding, kw)
    else:
        out = fa_ops.flash_attention(q, k, v, **kw)
    return _out_proj(out.transpose(1, 2), p["wo"], compute_dtype)


def _placed(ndim: int, dp: list, batch_split: bool, model: Optional[int], model_pl):
    """Placements over ``ndim`` mesh dims: dim 0 of the tensor over the
    data dims (when ``batch_split``), ``model_pl`` on ``model``."""
    from torch.distributed.tensor import Shard

    return sh.placed(ndim, (dp if batch_split else [], Shard(0)),
                     ([] if model is None else [model], model_pl))


def _flash_partitioned(q, k, v, context, kw):
    """``fa_ops.flash_attention`` over DTensors (B, H, T, Dh), by the rule of
    the module docstring."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = q.device_mesh
    dp, model = sh.mesh_dims(q.device_mesh)
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    split = b % math.prod(dmesh.size(i) for i in dp) == 0
    m = 1 if model is None else dmesh.size(model)
    nd = dmesh.ndim
    rank = lambda: 0 if model is None else dmesh.get_local_rank(model)
    whole = _placed(nd, dp, split, model, Replicate())

    if context is not None:
        # The reference's query-block split: rows g·T + t of the folded
        # (B, Hkv, group·T, D) are query head kv·group + g at position t.
        # Each rank takes its block of the rows padded (as the reference pads
        # to its blocks) to a multiple of the ranks; its padding rows come
        # out zero and are cut off.  The output is placed by the hook.
        n_rows = group * tq
        chunk = -(-n_rows // m)
        qf = q.redistribute(dmesh, whole).reshape(b, hkv, n_rows, d)
        rows_pl = sh.placements(context.spec, tuple(dmesh.mesh_dim_names))

        def rows(qf, k, v):
            start = rank() * chunk
            end = min(start + chunk, n_rows)
            outs, at = [], start
            while at < end:
                t0 = at % tq
                n = min(tq - t0, end - at)
                outs.append(fa_ops.flash_attention(qf[:, :, at:at + n], k, v, kv_offset=t0,
                                                   **kw))
                at += n
            if end - start < chunk:
                outs.append(qf.new_zeros(qf.shape[:2] + (chunk - max(end - start, 0), d)))
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

        out = local_map(rows, out_placements=(rows_pl,), in_placements=(whole, whole, whole),
                        device_mesh=dmesh, redistribute_inputs=True)(qf, k, v)
        out = out.redistribute(dmesh, whole)[:, :, :n_rows].reshape(b, hq, tq, d)
        out = sh.grad_placed(out, whole)
        # Back to the sequence split its output projection takes, where the
        # ranks divide the sequence.
        return out if tq % m else out.redistribute(dmesh, _placed(nd, dp, split, model, Shard(2)))

    heads = m > 1 and hq % m == 0
    kv_heads = heads and hkv % m == 0
    if heads and not kv_heads and (hq // m) % group and group % (hq // m):
        raise NotImplementedError(f"attention: {hq // m} query heads a rank do not align "
                                  f"with the K/V groups of {group}")
    q_pl = _placed(nd, dp, split, model, Shard(1) if heads else Replicate())
    kv_pl = _placed(nd, dp, split, model, Shard(1) if kv_heads else Replicate())

    def local(q, k, v):
        if heads and not kv_heads:
            # This rank's query heads [lo, lo + n) read K/V heads lo // group on.
            n = q.shape[1]
            lo = rank() * n
            k = k[:, lo // group:(lo + n - 1) // group + 1]
            v = v[:, lo // group:(lo + n - 1) // group + 1]
        return fa_ops.flash_attention(q, k, v, **kw)

    return local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                     device_mesh=dmesh, redistribute_inputs=True)(q, k, v)


# ------------------------------------------------------------------ decode

def init_kv_cache(batch: int, n_kv: int, max_seq: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu"):
    return {
        "k": torch.zeros((batch, n_kv, max_seq, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, n_kv, max_seq, head_dim), dtype=dtype, device=device),
    }


def attention_decode(
    p,
    cache,
    x: torch.Tensor,          # (B, 1, D)
    pos: int,                 # current absolute position
    *,
    window: Optional[int] = None,
    prefix_len: int = 0,
    rope_theta: float = 10000.0,
    compute_dtype=torch.bfloat16,
    cross: bool = False,      # cross-attention: cache holds encoder KV, no update
    ring: bool = False,       # sliding-window ring buffer (cache len == window)
) -> Tuple[torch.Tensor, dict]:
    """One decode step: write K/V at ``pos`` (in place), attend over the
    cache ≤ pos.  Returns ``(y (B, 1, D), cache)``.

    ``ring=True`` (requires ``window`` and a cache of exactly ``window``
    slots) keeps only the last W tokens: slot i holds absolute position
    pos − ((pos − i) mod W)."""
    b, _, d = x.shape
    pos = int(pos)
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _project_qkv(p, x, None if cross else positions, rope_theta,
                                   compute_dtype)
    q, k_new, v_new = q.transpose(1, 2), k_new.transpose(1, 2), v_new.transpose(1, 2)
    kw = dict(pos=pos, window=window, prefix_len=prefix_len, cross=cross, ring=ring)
    if sh.is_dtensor(q):
        out = _decode_partitioned(q, k_new, v_new, cache, kw)
    else:
        out = _decode_attend(q, k_new, v_new, cache["k"], cache["v"], **kw)
    out = out.to(compute_dtype).transpose(1, 2)             # (B, 1, H, Dh)
    return _out_proj(out, p["wo"], compute_dtype), cache


def _decode_attend(q, k_new, v_new, ck, cv, *, pos: int, window: Optional[int],
                   prefix_len: int, cross: bool, ring: bool, base: int = 0,
                   length: Optional[int] = None, combine=None) -> torch.Tensor:
    """The decode step's cache write and attention, ``(B, H, 1, Dh)`` f32:
    ``q`` (B, H, 1, Dh), the new ``k_new`` / ``v_new`` (B, Hkv, 1, Dh) written
    in place into the cache ``ck`` / ``cv`` (B, Hkv, S, Dh), which holds the
    slots ``base`` on of a cache of ``length`` (default: S) slots.
    ``combine`` (split-KV): ``(op, t)`` → ``t`` reduced over the ranks
    holding the other slots."""
    dev = q.device
    s_loc = ck.shape[2]
    s_len = s_loc if length is None else length
    if cross:
        k, v = ck, cv
        allowed = torch.ones((s_loc,), dtype=torch.bool, device=dev)
    else:
        if ring:
            assert window is not None and s_len == window
            slot = pos % window
        else:
            # dynamic_update_slice clamps the start into range
            slot = min(max(pos, 0), s_len - 1)
        if base <= slot < base + s_loc:
            ck[:, :, slot - base] = k_new[:, :, 0].to(ck.dtype)
            cv[:, :, slot - base] = v_new[:, :, 0].to(cv.dtype)
        k, v = ck, cv
        k_idx = torch.arange(base, base + s_loc, device=dev)
        if ring:
            allowed = (pos - torch.remainder(pos - k_idx, window)) >= 0
        else:
            allowed = k_idx <= pos
            if window is not None:
                in_window = (pos - k_idx) < window
                if prefix_len > 0:
                    in_window = in_window | (k_idx < prefix_len)
                allowed = allowed & in_window

    group = q.shape[1] // k.shape[1]
    kr = torch.repeat_interleave(k, group, dim=1) if group > 1 else k
    vr = torch.repeat_interleave(v, group, dim=1) if group > 1 else v
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), kr.float().transpose(-1, -2)) * scale
    s = torch.where(allowed[None, None, None, :], s, NEG_INF)
    if combine is None:
        w = torch.softmax(s, dim=-1)
        return torch.matmul(w, vr.float())
    # Split-KV: each rank's partial softmax over its slots, combined.
    mx = combine("max", s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - mx)
    total = combine("sum", e.sum(dim=-1, keepdim=True))
    return combine("sum", torch.matmul(e, vr.float())) / total


def _decode_partitioned(q, k_new, v_new, cache, kw) -> torch.Tensor:
    """``_decode_attend`` over DTensors, on the cache's own blocks (see the
    module docstring); the cache's local tensors are written in place."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ck, cv = cache["k"], cache["v"]
    dmesh = ck.device_mesh
    dp, model = sh.mesh_dims(ck.device_mesh)
    on_model = Replicate() if model is None else ck.placements[model]
    split = any(ck.placements[i] == Shard(0) for i in dp)
    heads = on_model == Shard(1)
    seq = on_model == Shard(2)
    q_pl = _placed(dmesh.ndim, dp, split, model, Shard(1) if heads else Replicate())
    length = ck.shape[2]
    combine = None
    if seq:
        group = (dmesh, model)
        combine = lambda op, t: funcol.all_reduce(t, op, group)

    def local(q, k_new, v_new, ck, cv):
        base = dmesh.get_local_rank(model) * ck.shape[2] if seq else 0
        return _decode_attend(q, k_new, v_new, ck, cv, base=base, length=length,
                              combine=combine, **kw)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, q_pl, q_pl, ck.placements, cv.placements),
                     device_mesh=dmesh, redistribute_inputs=True)(q, k_new, v_new, ck, cv)
