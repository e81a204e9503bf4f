"""Model assembly: config → init / backbone / forward / loss / cache /
decode_step.

Port of ``repro/models/model.py`` for every family of ``configs/archs.py``:

  dense / moe      pre-norm decoder blocks (attention + GLU MLP or MoE);
  ssm (rwkv6)      time-mix + channel-mix blocks;
  hybrid (rglru)   the Griffin pattern (rglru, rglru, local_attn);
  audio (whisper)  a bidirectional encoder over frame embeddings (the conv
                   front end is a stub: the batch supplies ``frames``) and a
                   decoder with cross-attention;
  vlm (paligemma)  a prefix-LM decoder over patch embeddings (the SigLIP
                   tower is a stub: the batch supplies ``patches``).

The reference's ``lax.scan`` over the stacked layer parameters is a Python
loop over the leading layer axis, whose stacks are unbound once a call
(``params.unstack``).  The reference's sharding hooks are kept:
``residual_sharding`` (the residual stream at each pattern group's start and
end, ``model.py:291-295``), ``expert_sharding`` (the MoE dispatch) and
``context_sharding`` (attention's query rows), each a ``sharding.Constraint``
that redistributes a DTensor in a partitioned step and is None otherwise.
A partitioned step also sets ``weight_gather`` (``sharding.gather_weights``): each
layer gathers its weights over the data axes as it starts, FSDP's gather,
re-done in the backward of a recomputed layer; and each block's normalised
input is gathered whole but for its batch split (``sharding.split_on``) before
products split over heads or features, sequence parallelism's all-gather, as
is the gradient of each product's output (``sharding.grad_split_on``) in the
backward.  Where the query rows are split instead (``context_sharding``),
attention's projections keep the sequence split.
With ``cfg.remat`` and autograd recording, each layer (and each encoder
layer and loss chunk) runs under ``torch.utils.checkpoint`` (non-reentrant): its
activations are recomputed in the backward, the reference's
``jax.checkpoint``.  ``remat_policy="dots"`` saves the outputs of the
products without batch dimensions (``mm``, ``addmm``) and recomputes the
rest, the reference's ``dots_with_no_batch_dims_saveable``.  ``loss`` is the
reference's masked cross-entropy over token chunks (``model.py:334-388``).

Two quirks of the reference are kept, so that the port's decode equals its
decode (ROADMAP §3):

* Nothing writes the patches' K/V into the decode cache: a VLM decode step
  writes at ``pos + prefix_tokens`` (``model.py:502-503``), which a cache of
  fewer slots clamps to its last slot.
* ``init_cache`` leaves ``cross_kv`` at zero: the reference's ignores its
  ``enc_out`` argument (``model.py:392``), so its decode's cross-attention
  adds 0; the port's ``init_cache`` takes no encoder output.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import attention as attn
from . import layers as ll
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .params import (SHAPE_ONLY, Param, randn, stack_layers, tree_leaves, tree_map, unstack,
                     unzip)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_ATTN_KINDS = ("attn", "local_attn")
REMAT_POLICIES = ("full", "dots")
# The products ``remat_policy="dots"`` saves: those without batch dimensions.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
# Decode routes one token a row: a capacity of 4 slots an expert drops none
# (``model.py:486``).
DECODE_CAPACITY_FACTOR = 4.0
# Leaves the reference reads in f32 whatever the compute dtype (``.astype(
# jnp.float32)`` at their use): the MoE router, rwkv6's decay LoRA, base and
# bonus, the RG-LRU gates.  ``init(dtype=...)`` holds them in the param dtype.
F32_LEAVES = frozenset({"router", "w0", "w_lora_a", "w_lora_b", "u", "wa", "ba", "wx", "bx",
                        "lam"})


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _hold(tree: Dict[str, Any], dtype: torch.dtype, f32_dtype: torch.dtype) -> Dict[str, Any]:
    """The ``Param`` tree ``tree`` cast to ``dtype``, its ``F32_LEAVES`` to
    ``f32_dtype``."""
    return {k: _hold(v, dtype, f32_dtype) if isinstance(v, dict)
            else Param(v.value.to(f32_dtype if k in F32_LEAVES else dtype), v.axes)
            for k, v in tree.items()}


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _copy_into(dst, src) -> None:
    """Write a new recurrent state into the cache's tensors, in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


class Model:
    """Stateless model functions bound to a ModelConfig."""

    def __init__(self, config: ModelConfig):
        if config.attention_impl not in ("cuda", "chunked", "reference"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}; expected "
                             f"'cuda' (the reference's 'pallas'), 'chunked' or 'reference'")
        if config.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {config.remat_policy!r}; expected "
                             f"{REMAT_POLICIES}")
        self.cfg = config
        self.compute_dtype = _dtype(config.dtype)
        self.param_dtype = _dtype(config.param_dtype)
        p = len(config.block_pattern)
        self.group_size = p
        self.n_groups = config.n_layers // p if config.scan_layers else 0
        self.tail_kinds = config.layer_kinds()[self.n_groups * p:]
        # The reference's sharding hooks (``sharding.Constraint``s; None:
        # nothing is constrained).
        self.residual_sharding = None
        self.context_sharding = None
        self.expert_sharding = None
        # A partitioned step's FSDP gather of a layer's weights over the data
        # axes (``sharding.gather_weights``), inside the layer's recomputed region.
        self.weight_gather = None

    # ------------------------------------------------------------- init

    def _layer_init(self, gen, kind: str):
        """One layer's tree in the param dtype (the reference's
        ``_layer_init``)."""
        cfg = self.cfg
        d, f, dt, dev = cfg.d_model, cfg.d_ff, self.param_dtype, gen.device
        layer: Dict[str, Any] = {"ln1": ll.norm_init(d, cfg.norm, dt, dev)}
        if kind in _ATTN_KINDS:
            layer["attn"] = attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                                cfg.head_dim, dt)
        elif kind == "rwkv6":
            layer["tmix"] = rwkv_mod.rwkv6_init(gen, d, d // cfg.rnn_head_dim, cfg.rnn_head_dim,
                                                dtype=dt)
        elif kind == "rglru":
            layer["rec"] = rglru_mod.rglru_init(gen, d, cfg.lru_width, cfg.conv1d_width, dt)
        else:
            raise ValueError(kind)
        layer["ln2"] = ll.norm_init(d, cfg.norm, dt, dev)
        if kind == "rwkv6":
            layer["cmix"] = rwkv_mod.rwkv6_channel_init(gen, d, f, dt)
        elif cfg.is_moe and kind in _ATTN_KINDS:
            layer["moe"] = moe_mod.moe_init(gen, d, f, cfg.n_experts, dt)
        else:
            layer["mlp"] = ll.glu_mlp_init(gen, d, f, dt, cfg.activation)
        if cfg.is_encoder_decoder and kind in _ATTN_KINDS:
            layer["ln_cross"] = ll.norm_init(d, cfg.norm, dt, dev)
            layer["cross"] = attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                                 cfg.head_dim, dt)
        return layer

    def _encoder_layer_init(self, gen):
        cfg = self.cfg
        d, dt, dev = cfg.d_model, self.param_dtype, gen.device
        return {
            "ln1": ll.norm_init(d, cfg.norm, dt, dev),
            "attn": attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt),
            "ln2": ll.norm_init(d, cfg.norm, dt, dev),
            "mlp": ll.glu_mlp_init(gen, d, cfg.d_ff, dt, cfg.activation),
        }

    def init(self, gen: Union[int, torch.Generator] = 0,
             device: Union[str, torch.device, None] = None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The parameter value tree, ``unzip(init_params(...))[0]``, as the
        reference's ``unzip(init)[0]``."""
        return unzip(self.init_params(gen, device, dtype))[0]

    def init_params(self, gen: Union[int, torch.Generator] = 0,
                    device: Union[str, torch.device, None] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The ``Param`` tree (values and logical axes), the reference's
        ``init``: ``embed/table``, ``ln_f/scale``, ``logits/w`` (untied),
        ``layers/b{j}/...`` stacked along a leading layer axis (``ln1``,
        ``attn`` / ``tmix`` / ``rec``, ``ln2``, ``mlp`` / ``moe`` / ``cmix``,
        and ``ln_cross`` / ``cross`` in an encoder–decoder), ``tail{j}`` for
        layers past the last whole pattern group, and ``encoder``
        (``layers``, ``pos_embed``, ``ln_f``) in an encoder–decoder.

        ``device`` is resolved by :func:`resolve_device`: the card unless
        the caller asks for the CPU.  Values are drawn in f32 by ``gen`` (a
        seed makes a generator on ``device``) on the generator's device, by
        the reference's rules (``normal``'s fan-in quirk, zeros, ones and
        the RG-LRU's Λ), cast to ``dtype`` (default: the config's param
        dtype) and moved to ``device``.  Holding the weights in the compute
        dtype gives the values the reference's casts at every use give
        (``layers.py:48, 111``, ``attention.py:49-51``); the leaves it reads
        in f32 (``F32_LEAVES``) stay in the param dtype; the norm scales are
        ones, exact in bf16.  On the meta device (``device="meta"``, the
        dry-run) ``gen`` is ignored: the tree holds shapes, dtypes and axes,
        no storage and no draws."""
        dev = resolve_device(device)
        if dev.type == "meta":
            gen = SHAPE_ONLY
        elif isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        cfg = self.cfg
        dt = self.param_dtype if dtype is None else dtype
        hold = lambda tree: _hold(tree, dt, self.param_dtype)
        gdev = gen.device
        tree: Dict[str, Any] = {
            "embed": hold(ll.embedding_init(gen, cfg.vocab_size, cfg.d_model, self.param_dtype)),
            "ln_f": hold(ll.norm_init(cfg.d_model, cfg.norm, self.param_dtype, gdev)),
        }
        if not cfg.tie_embeddings:
            tree["logits"] = hold(ll.logits_init(gen, cfg.d_model, cfg.vocab_size,
                                                 self.param_dtype))
        if self.n_groups:
            tree["layers"] = {
                f"b{j}": stack_layers(
                    lambda j=j: hold(self._layer_init(gen, cfg.block_pattern[j])),
                    self.n_groups)
                for j in range(self.group_size)
            }
        for j, kind in enumerate(self.tail_kinds):
            tree[f"tail{j}"] = hold(self._layer_init(gen, kind))
        if cfg.is_encoder_decoder:
            tree["encoder"] = hold({
                "layers": stack_layers(lambda: self._encoder_layer_init(gen),
                                       cfg.n_encoder_layers),
                "pos_embed": Param(randn(gen, (cfg.encoder_seq, cfg.d_model)) * 0.02,
                                   (None, "embed")),
                "ln_f": ll.norm_init(cfg.d_model, cfg.norm, self.param_dtype, gdev),
            })
        return tree_map(lambda p: Param(p.value.to(dev), p.axes), tree)

    # ---------------------------------------------------------- forward

    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
        is set and autograd records."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn(*args)
        kw = {}
        if self.cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_saveable)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    def _attention(self, p, h: torch.Tensor, **kw) -> torch.Tensor:
        cfg = self.cfg
        return attn.attention_apply(
            p, h, rope_theta=cfg.rope_theta, impl=cfg.attention_impl,
            block_q=cfg.attention_block_q, block_k=cfg.attention_block_k,
            compute_dtype=self.compute_dtype, context_sharding=self.context_sharding, **kw)

    def _attention_input(self, h):
        """A block's normalised input to attention: with the query rows
        split over the tensor axis (``context_sharding``) it keeps its
        sequence split, each rank projecting its rows; else it is gathered
        whole but for the batch split (the heads split the products)."""
        return h if self.context_sharding is not None else sh.split_on(h, 0)

    def _ffn(self, lp, kind: str, x: torch.Tensor, cache=None):
        """The block's second half, ``x + ffn(ln2(x))``, and the MoE aux loss
        (None for other blocks).  With ``cache`` (decode) the channel mix
        reads and updates its token shift in place and the MoE keeps every
        assignment."""
        cfg = self.cfg
        cd = self.compute_dtype
        h2 = sh.split_on(ll.norm_apply(lp["ln2"], x, cfg.norm), 0)
        aux = None
        if kind == "rwkv6":
            m, last = rwkv_mod.rwkv6_channel_mix(
                lp["cmix"], h2, state=None if cache is None else cache["cmix_prev"],
                compute_dtype=cd)
            if cache is not None:
                cache["cmix_prev"].copy_(last)
        elif cfg.is_moe and kind in _ATTN_KINDS:
            m, aux = moe_mod.moe_apply(
                lp["moe"], h2, top_k=cfg.top_k, n_experts=cfg.n_experts,
                capacity_factor=cfg.capacity_factor if cache is None else DECODE_CAPACITY_FACTOR,
                activation=cfg.activation, token_sort=cfg.moe_token_sort, compute_dtype=cd,
                dispatch_sharding=self.expert_sharding)
        else:
            m = ll.glu_mlp_apply(lp["mlp"], h2, cfg.activation, cd)
        return x + sh.grad_split_on(m, 0), aux

    def _block_forward(self, lp, kind: str, x: torch.Tensor, enc_out: Optional[torch.Tensor],
                       prefix_len: int):
        """One pre-norm residual block: ``(x', aux or None)``."""
        cfg = self.cfg
        lp = self._gathered(lp)
        h = self._attention_input(ll.norm_apply(lp["ln1"], x, cfg.norm))
        if kind in _ATTN_KINDS:
            x = x + sh.grad_split_on(self._attention(
                lp["attn"], h, causal=True, window=cfg.window if kind == "local_attn" else None,
                prefix_len=prefix_len), 0)
            if cfg.is_encoder_decoder and enc_out is not None:
                hc = self._attention_input(ll.norm_apply(lp["ln_cross"], x, cfg.norm))
                x = x + sh.grad_split_on(self._attention(
                    lp["cross"], hc, causal=False,
                    kv_override=self._encoder_kv(lp["cross"], enc_out)), 0)
        elif kind == "rwkv6":
            a, _ = rwkv_mod.rwkv6_time_mix(
                lp["tmix"], h, cfg.d_model // cfg.rnn_head_dim, cfg.rnn_head_dim,
                chunk=cfg.rwkv_chunk, impl="chunked", compute_dtype=self.compute_dtype)
            x = x + sh.grad_split_on(a, 0)
        elif kind == "rglru":
            a, _ = rglru_mod.rglru_block_apply(lp["rec"], h, compute_dtype=self.compute_dtype)
            x = x + sh.grad_split_on(a, 0)
        return self._ffn(lp, kind, x)

    def _encoder_kv(self, cross_p, enc_out: torch.Tensor):
        """The encoder output's cross-attention K and V, (B, S, Hkv, Dh)."""
        cd = self.compute_dtype
        return (attn.proj_heads(enc_out, cross_p["wk"], cd),
                attn.proj_heads(enc_out, cross_p["wv"], cd))

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over (stub) frame embeddings (B, S, D)."""
        cfg = self.cfg
        ep = params["encoder"]
        cd = self.compute_dtype
        x = frames.to(cd) + ep["pos_embed"][None, :frames.shape[1]].to(cd)
        for lp in unstack(ep["layers"], cfg.n_encoder_layers):
            x = self._remat(self._encoder_layer, lp, x)
        return ll.norm_apply(ep["ln_f"], x, cfg.norm)

    def _encoder_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lp = self._gathered(lp)
        h = self._attention_input(ll.norm_apply(lp["ln1"], x, cfg.norm))
        x = x + sh.grad_split_on(self._attention(lp["attn"], h, causal=False), 0)
        h = sh.split_on(ll.norm_apply(lp["ln2"], x, cfg.norm), 0)
        return x + sh.grad_split_on(ll.glu_mlp_apply(lp["mlp"], h, cfg.activation,
                                                     self.compute_dtype), 0)

    def _gathered(self, tree):
        return tree if self.weight_gather is None else self.weight_gather(tree)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = ll.embed_apply(self._gathered(params["embed"]), tokens, self.compute_dtype)
        # The reference multiplies by √d rounded to the compute dtype first
        # (model.py:277, :501): √3072 = 55.43 is 55.5 in bf16.
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.compute_dtype)

    def _layers(self, tree, unbind: bool = False):
        """Each layer's slice of ``tree`` (the parameters or the cache) in
        depth order with its kind: the stacked groups, then the tail layers.
        Slices of stacked tensors are views, so writes reach the stack.
        ``unbind``: the stacks are unbound once (``params.unstack``, for
        parameters that autograd differentiates); else each slice indexes its
        stack (the decode cache, written in place)."""
        stacks = {}
        if unbind and self.n_groups:
            stacks = {j: unstack(tree["layers"][f"b{j}"], self.n_groups)
                      for j in range(self.group_size)}
        for g in range(self.n_groups):
            for j in range(self.group_size):
                lp = (stacks[j][g] if unbind
                      else tree_map(lambda a: a[g], tree["layers"][f"b{j}"]))
                yield lp, self.cfg.block_pattern[j]
        for j, kind in enumerate(self.tail_kinds):
            yield tree[f"tail{j}"], kind

    def backbone(self, params, batch: Dict[str, torch.Tensor]):
        """Final-norm hidden states (B, T, D) of the tokens and the MoE aux
        loss (f32, 0 without MoE).  A VLM batch carries ``patches`` (B, P,
        D), prepended to the tokens and dropped after the final norm; an
        encoder–decoder batch carries ``frames`` (B, S, D)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        prefix_len = 0
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(self.compute_dtype), x], dim=1)
            prefix_len = cfg.prefix_tokens
        enc_out = self.encode(params, batch["frames"]) if cfg.is_encoder_decoder else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        grouped = self.n_groups * self.group_size
        for i, (lp, kind) in enumerate(self._layers(params, unbind=True)):
            # The residual stream is constrained as the reference's scan body
            # does: at each pattern group's start and end.
            at = i % self.group_size
            if i < grouped and at == 0:
                x = sh.constrain(self.residual_sharding, x)
            x, a = self._remat(self._block_forward, lp, kind, x, enc_out, prefix_len)
            if i < grouped and at == self.group_size - 1:
                x = sh.constrain(self.residual_sharding, x)
            if a is not None:
                aux = aux + a
        x = ll.norm_apply(params["ln_f"], x, cfg.norm)
        return x[:, prefix_len:], aux

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            out = ll.tied_logits_apply(params["embed"], x, self.compute_dtype)
        else:
            out = ll.logits_apply(params["logits"], x, self.compute_dtype)
        return out.float()

    def forward(self, params, batch: Dict[str, torch.Tensor]):
        """Teacher-forced logits (B, T, V) in f32, and the aux loss."""
        x, aux = self.backbone(params, batch)
        return self.logits(params, x), aux

    # ------------------------------------------------------------- loss

    LOSS_CHUNK = 8192  # tokens per logits chunk

    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """Masked softmax cross-entropy + 1e-4 z-loss + 1e-2 MoE aux, and the
        metrics ``ce``, ``aux``, ``zloss``, ``tokens`` (0-d f32 tensors).
        ``batch["targets"]`` (B, T) holds -1 where no token is predicted.

        The (tokens, vocab) logits are never whole: the vocabulary product
        and the log-softmax run over chunks of ``LOSS_CHUNK`` tokens (under
        ``torch.utils.checkpoint`` with ``cfg.remat``), their sums added in
        chunk order as the reference's scan carries them.  The last chunk is
        shorter where the reference pads it with masked rows, which add
        nothing.

        Over DTensors the sums run on each rank's rows and vocabulary block
        (:meth:`_partitioned_sums`)."""
        x, aux = self.backbone(params, batch)
        b, t, d = x.shape
        n = b * t
        xf = sh.split_on(x, 0).reshape(n, d)
        tf = batch["targets"].reshape(n).long()
        if self.cfg.tie_embeddings:
            w = params["embed"]["table"].to(self.compute_dtype).t()
        else:
            w = params["logits"]["w"].to(self.compute_dtype)
        if sh.is_dtensor(xf):
            ce_sum, z_sum, tok = self._partitioned_sums(xf, tf, w)
        else:
            ce_sum, z_sum, tok = self._chunk_sums(xf, tf, w)
        denom = torch.clamp(tok, min=1.0)
        ce = ce_sum / denom
        zl = 1e-4 * z_sum / denom
        total = ce + zl + 1e-2 * aux
        return total, {"ce": ce, "aux": aux, "zloss": zl, "tokens": tok}

    def _chunk_sums(self, xf: torch.Tensor, tf: torch.Tensor, w: torch.Tensor, **kw):
        """(Σ nll, Σ lse², tokens) over the rows of ``xf``, ``LOSS_CHUNK``
        rows at a time, added in chunk order."""
        n = xf.shape[0]
        chunk = min(self.LOSS_CHUNK, n)
        ce_sum = z_sum = tok = torch.zeros((), dtype=torch.float32, device=xf.device)
        for c0 in range(0, n, chunk):
            ce_c, z_c, tok_c = self._remat(functools.partial(self._chunk_loss, **kw),
                                           xf[c0:c0 + chunk], tf[c0:c0 + chunk], w)
            ce_sum, z_sum, tok = ce_sum + ce_c, z_sum + z_c, tok + tok_c
        return ce_sum, z_sum, tok

    def _partitioned_sums(self, xf, tf, w):
        """``_chunk_sums`` over DTensors, the loss's explicit sharding rule,
        under ``local_map``: where ``model`` divides the vocabulary, each
        rank takes its rows of the data axes (whole over ``model``) and its
        block of the vocabulary, the log-sum-exp's max and sum and the
        target's logit all-reduced over ``model``; else its rows of every
        axis and the whole vocabulary.  The sums come out partial over the
        axes that split the rows."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        dmesh = xf.device_mesh
        dp, model = sh.mesh_dims(dmesh)
        vocab = model is not None and dmesh.size(model) > 1 and w.shape[1] % dmesh.size(model) == 0
        split = dp if vocab or model is None else dp + [model]
        rows = xf.shape[0] % math.prod(dmesh.size(i) for i in split) == 0

        def placed(on_rows, on_model):
            pl = [Replicate()] * dmesh.ndim
            if model is not None:
                pl[model] = on_model
            for i in split:
                pl[i] = on_rows if rows else Replicate()
            return tuple(pl)

        row_pl = placed(Shard(0), Replicate())
        w_pl = placed(Replicate(), Shard(1) if vocab else Replicate())
        sum_pl = placed(Partial(), Replicate())
        group = (dmesh, model) if vocab else None

        def local(xf, tf, w):
            v0 = dmesh.get_local_rank(model) * w.shape[1] if vocab else 0
            return self._chunk_sums(xf, tf, w, v0=v0, group=group)

        return local_map(
            local, out_placements=(sum_pl, sum_pl, sum_pl), in_placements=(row_pl, row_pl, w_pl),
            in_grad_placements=(placed(Shard(0), Partial() if vocab else Replicate()), row_pl,
                                placed(Partial(), Shard(1) if vocab else Replicate())),
            device_mesh=dmesh, redistribute_inputs=True)(xf, tf, w)

    def _chunk_loss(self, xch: torch.Tensor, tch: torch.Tensor, w: torch.Tensor,
                    v0: int = 0, group=None):
        """One chunk's (Σ nll, Σ lse², tokens) over its masked rows.  With
        ``group`` (a partitioned step) ``w`` is the vocabulary block from
        ``v0`` on, the others' blocks on the ranks of ``group``."""
        logits = torch.matmul(xch.to(self.compute_dtype), w).float()
        mask = (tch >= 0).float()
        if group is None:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, 1, torch.clamp(tch, min=0)[:, None])[:, 0]
        else:
            mx = sh.max_across(logits.amax(dim=-1), group)
            lse = mx + torch.log(sh.sum_across(torch.exp(logits - mx[:, None]).sum(dim=-1),
                                               group))
            at = torch.clamp(tch, min=0) - v0
            here = (at >= 0) & (at < w.shape[1])
            picked = torch.gather(logits, 1, torch.clamp(at, 0, w.shape[1] - 1)[:, None])[:, 0]
            picked = sh.sum_across(torch.where(here, picked, 0.0), group)
        nll = lse - picked
        return (nll * mask).sum(), (torch.square(lse) * mask).sum(), mask.sum()

    # ------------------------------------------------------------ decode

    def init_cache(self, batch: int, max_seq: int,
                   device: Union[str, torch.device, None] = None):
        """Decode cache on ``device`` (the card unless the caller asks for the
        CPU), grouped to mirror the stacked layers (``layers/b{j}/...`` with
        a leading group axis): an attention layer's ``kv`` (B, Hkv, S, Dh),
        a ring of ``window`` slots for ``local_attn``, and in an
        encoder–decoder ``cross_kv`` of ``encoder_seq`` zero slots (see the
        module docstring); an rwkv6 layer's ``rwkv`` = (prev_x (B, D), S (B,
        H, Dh, Dh) f32) and ``cmix_prev`` (B, D); an rglru layer's ``rglru``
        :class:`RGLRUState`."""
        cfg = self.cfg
        dev = resolve_device(device)
        cd = self.compute_dtype

        def one(kind):
            c: Dict[str, Any] = {}
            if kind in _ATTN_KINDS:
                s = max_seq
                if kind == "local_attn" and cfg.window is not None:
                    s = min(max_seq, cfg.window)
                c["kv"] = attn.init_kv_cache(batch, cfg.n_kv_heads, s, cfg.head_dim, cd, dev)
                if cfg.is_encoder_decoder:
                    c["cross_kv"] = attn.init_kv_cache(batch, cfg.n_kv_heads, cfg.encoder_seq,
                                                       cfg.head_dim, cd, dev)
            elif kind == "rwkv6":
                h = cfg.d_model // cfg.rnn_head_dim
                c["rwkv"] = (
                    torch.zeros((batch, cfg.d_model), dtype=cd, device=dev),
                    torch.zeros((batch, h, cfg.rnn_head_dim, cfg.rnn_head_dim),
                                dtype=torch.float32, device=dev),
                )
                c["cmix_prev"] = torch.zeros((batch, cfg.d_model), dtype=cd, device=dev)
            elif kind == "rglru":
                c["rglru"] = rglru_mod.rglru_init_state(batch, cfg.lru_width, cfg.conv1d_width,
                                                        cd, dev)
            return c

        cache: Dict[str, Any] = {}
        if self.n_groups:
            cache["layers"] = {
                f"b{j}": stack_layers(lambda j=j: one(cfg.block_pattern[j]), self.n_groups)
                for j in range(self.group_size)
            }
        for j, kind in enumerate(self.tail_kinds):
            cache[f"tail{j}"] = one(kind)
        return cache

    def _block_decode(self, lp, kind: str, c, x: torch.Tensor, pos: int, prefix_len: int):
        cfg = self.cfg
        lp = self._gathered(lp)
        cd = self.compute_dtype
        h = ll.norm_apply(lp["ln1"], x, cfg.norm)
        if kind in _ATTN_KINDS:
            window = cfg.window if kind == "local_attn" else None
            ring = window is not None and c["kv"]["k"].shape[2] == window
            a, _ = attn.attention_decode(
                lp["attn"], c["kv"], h, pos, window=window, prefix_len=prefix_len, ring=ring,
                rope_theta=cfg.rope_theta, compute_dtype=cd)
            x = x + a
            if cfg.is_encoder_decoder:
                hc = ll.norm_apply(lp["ln_cross"], x, cfg.norm)
                a2, _ = attn.attention_decode(lp["cross"], c["cross_kv"], hc, pos,
                                              rope_theta=cfg.rope_theta, compute_dtype=cd,
                                              cross=True)
                x = x + a2
        elif kind == "rwkv6":
            a, new = rwkv_mod.rwkv6_decode_step(
                lp["tmix"], h, c["rwkv"], cfg.d_model // cfg.rnn_head_dim, cfg.rnn_head_dim,
                compute_dtype=cd)
            _copy_into(c["rwkv"], new)
            x = x + a
        elif kind == "rglru":
            a, new = rglru_mod.rglru_decode_step(lp["rec"], h, c["rglru"], compute_dtype=cd)
            _copy_into(c["rglru"], new)
            x = x + a
        return self._ffn(lp, kind, x, cache=c)[0]

    def decode_step(self, params, cache, tokens: torch.Tensor, pos):
        """One token for every sequence in the batch.

        tokens: (B, 1) int; pos: the current absolute position (an int or a
        0-d tensor); a VLM decodes at ``pos + prefix_tokens``.  Returns
        ``(logits (B, 1, V) f32, cache)``; the cache is updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        prefix_len = cfg.prefix_tokens if cfg.family == "vlm" else 0
        dec_pos = int(pos) + prefix_len
        for (lp, kind), (lc, _) in zip(self._layers(params), self._layers(cache)):
            x = self._block_decode(lp, kind, lc, x, dec_pos, prefix_len)
        x = ll.norm_apply(params["ln_f"], x, cfg.norm)
        return self.logits(params, x), cache


def build_model(config: ModelConfig) -> Model:
    return Model(config)
