"""Model assembly: config → init / backbone / forward / cache / decode_step.

Port of ``repro/models/model.py`` for the decoder families whose blocks are
attention (``attn`` / ``local_attn``) plus a GLU or two-matrix MLP, with
RMSNorm or LayerNorm: phi4-mini, gemma, mistral-nemo, command-r.  The
reference's ``lax.scan`` over the stacked layer parameters is a Python loop
over the leading layer axis; ``remat`` and the sharding hooks have no
counterpart.  Not ported yet, each raising ``NotImplementedError`` with its
ROADMAP item: MoE, ``rwkv6`` and ``rglru`` blocks, the encoder–decoder, the
VLM prefix path and ``loss`` (training).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import attention as attn
from . import layers as ll
from .params import stack_layers, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_ATTN_KINDS = ("attn", "local_attn")
ITEM = "ROADMAP queue 1, item 15"


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _unported(cfg: ModelConfig) -> Optional[str]:
    if cfg.is_moe:
        return "MoE blocks"
    bad = sorted(set(cfg.block_pattern) - set(_ATTN_KINDS))
    if bad:
        return f"{'/'.join(bad)} blocks"
    if cfg.is_encoder_decoder:
        return "the encoder-decoder"
    if cfg.family == "vlm":
        return "the VLM prefix path"
    return None


class Model:
    """Stateless model functions bound to a ModelConfig."""

    def __init__(self, config: ModelConfig):
        what = _unported(config)
        if what is not None:
            raise NotImplementedError(
                f"{config.name}: {what} are not ported yet ({ITEM})")
        if config.attention_impl not in ("cuda", "chunked", "reference"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}; expected "
                             f"'cuda' (the reference's 'pallas'), 'chunked' or 'reference'")
        self.cfg = config
        self.compute_dtype = _dtype(config.dtype)
        self.param_dtype = _dtype(config.param_dtype)
        p = len(config.block_pattern)
        self.group_size = p
        self.n_groups = config.n_layers // p if config.scan_layers else 0
        self.n_tail = config.n_layers - self.n_groups * p
        self.tail_kinds = config.layer_kinds()[self.n_groups * p:]

    # ------------------------------------------------------------- init

    def _layer_init(self, gen, dtype, device):
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        return {
            "ln1": ll.norm_init(d, cfg.norm, dtype, device),
            "attn": attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                        dtype),
            "ln2": ll.norm_init(d, cfg.norm, dtype, device),
            "mlp": ll.glu_mlp_init(gen, d, f, dtype, cfg.activation),
        }

    def init(self, gen: Union[int, torch.Generator] = 0,
             device: Union[str, torch.device, None] = None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """The parameter value tree, as the reference's ``unzip(init)[0]``:
        ``embed/table``, ``ln_f/scale``, ``logits/w`` (untied),
        ``layers/b{j}/{ln1,attn,ln2,mlp}`` stacked along a leading layer axis,
        ``tail{j}`` for layers past the last whole pattern group.

        ``device`` is resolved by :func:`resolve_device`: the card unless
        the caller asks for the CPU.  Values are drawn in f32 by ``gen`` (a
        seed makes a generator on ``device``) on the generator's device, cast
        to ``dtype`` (default: the config's param dtype) and moved to
        ``device``.  Holding the weights in the compute dtype gives the values
        the reference's casts at every use give (``layers.py:48, 111``,
        ``attention.py:49-51``); the norm scales are ones, exact in bf16."""
        dev = resolve_device(device)
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        cfg = self.cfg
        dt = self.param_dtype if dtype is None else dtype
        gdev = gen.device
        tree: Dict[str, Any] = {
            "embed": ll.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt),
            "ln_f": ll.norm_init(cfg.d_model, cfg.norm, dt, gdev),
        }
        if not cfg.tie_embeddings:
            tree["logits"] = ll.logits_init(gen, cfg.d_model, cfg.vocab_size, dt)
        if self.n_groups:
            tree["layers"] = {
                f"b{j}": stack_layers(lambda: self._layer_init(gen, dt, gdev), self.n_groups)
                for j in range(self.group_size)
            }
        for j in range(self.n_tail):
            tree[f"tail{j}"] = self._layer_init(gen, dt, gdev)
        return tree_map(lambda t: t.to(dev), tree)

    # ---------------------------------------------------------- forward

    def _block_forward(self, lp, kind: str, x: torch.Tensor) -> torch.Tensor:
        """One pre-norm residual block."""
        cfg = self.cfg
        h = ll.norm_apply(lp["ln1"], x, cfg.norm)
        a = attn.attention_apply(
            lp["attn"], h,
            causal=True,
            window=cfg.window if kind == "local_attn" else None,
            rope_theta=cfg.rope_theta,
            impl=cfg.attention_impl,
            block_q=cfg.attention_block_q,
            block_k=cfg.attention_block_k,
            compute_dtype=self.compute_dtype,
        )
        x = x + a
        h2 = ll.norm_apply(lp["ln2"], x, cfg.norm)
        return x + ll.glu_mlp_apply(lp["mlp"], h2, cfg.activation, self.compute_dtype)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = ll.embed_apply(params["embed"], tokens, self.compute_dtype)
        # The reference multiplies by √d rounded to the compute dtype first
        # (model.py:277, :501): √3072 = 55.43 is 55.5 in bf16.
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.compute_dtype)

    def _layers(self, tree):
        """Each layer's slice of ``tree`` (the parameters or the cache) in
        depth order with its kind: the stacked groups, then the tail layers.
        Slices of stacked tensors are views, so writes reach the stack."""
        for g in range(self.n_groups):
            for j in range(self.group_size):
                yield (tree_map(lambda a: a[g], tree["layers"][f"b{j}"]),
                       self.cfg.block_pattern[j])
        for j, kind in enumerate(self.tail_kinds):
            yield tree[f"tail{j}"], kind

    def backbone(self, params, batch: Dict[str, torch.Tensor]):
        """Final-norm hidden states (B, T, D) and the MoE aux loss (0 here)."""
        x = self._embed(params, batch["tokens"])
        for lp, kind in self._layers(params):
            x = self._block_forward(lp, kind, x)
        x = ll.norm_apply(params["ln_f"], x, self.cfg.norm)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

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

    def loss(self, params, batch):
        raise NotImplementedError(f"Model.loss belongs to the training slice ({ITEM})")

    # ------------------------------------------------------------ decode

    def init_cache(self, batch: int, max_seq: int,
                   device: Union[str, torch.device, None] = None):
        """Decode cache on ``device`` (the card unless the caller asks for the
        CPU), grouped to mirror the stacked layers: ``layers/b{j}/kv`` holds
        (G, B, Hkv, S, Dh) tensors; a ``local_attn`` layer keeps a ring of
        ``window`` slots."""
        cfg = self.cfg
        dev = resolve_device(device)

        def one(kind):
            s = max_seq
            if kind == "local_attn" and cfg.window is not None:
                s = min(max_seq, cfg.window)
            return {"kv": attn.init_kv_cache(batch, cfg.n_kv_heads, s, cfg.head_dim,
                                             self.compute_dtype, dev)}

        cache: Dict[str, Any] = {}
        if self.n_groups:
            cache["layers"] = {
                f"b{j}": stack_layers(lambda j=j: one(cfg.block_pattern[j]), self.n_groups)
                for j in range(self.group_size)
            }
        for j, kind in enumerate(self.tail_kinds):
            cache[f"tail{j}"] = one(kind)
        return cache

    def decode_step(self, params, cache, tokens: torch.Tensor, pos):
        """One token for every sequence in the batch.

        tokens: (B, 1) int; pos: the current absolute position (an int or a
        0-d tensor).  Returns ``(logits (B, 1, V) f32, cache)``; the cache is
        updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, tokens)
        for (lp, kind), (lc, _) in zip(self._layers(params), self._layers(cache)):
            kv = lc["kv"]
            window = cfg.window if kind == "local_attn" else None
            ring = kind == "local_attn" and window is not None and kv["k"].shape[-2] == window
            h = ll.norm_apply(lp["ln1"], x, cfg.norm)
            a, _ = attn.attention_decode(
                lp["attn"], kv, h, pos, window=window, ring=ring,
                rope_theta=cfg.rope_theta, compute_dtype=self.compute_dtype)
            x = x + a
            h2 = ll.norm_apply(lp["ln2"], x, cfg.norm)
            x = x + ll.glu_mlp_apply(lp["mlp"], h2, cfg.activation, self.compute_dtype)
        x = ll.norm_apply(params["ln_f"], x, cfg.norm)
        return self.logits(params, x), cache


def build_model(config: ModelConfig) -> Model:
    return Model(config)
