"""Train and serve step builders of the LM stack, ported from
``repro/training.py``.

``make_train_step`` closes over a Model and an AdamW config and returns the
step ``(state, batch) → (state', metrics)``: the loss and its gradient by
autograd, then ``adamw.apply``, which updates the parameters and moments in
place (the reference donates its state to the jitted step).  The dry-run's
helpers build the same trees on the meta device (``eval_params``,
``eval_train_state``: shapes, dtypes and logical axes, no storage), their
shardings from ``repro_torch.sharding``'s logical-axis rules
(``state_shardings``), and ``TensorSpec`` trees that carry them
(``attach_shardings``), the reference's ``ShapeDtypeStruct``s.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from . import sharding as sh
from .device import resolve_device
from .models.model import Model
from .models.params import tree_leaves, tree_map, unzip
from .optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor      # () int32


def init_train_state(model: Model, gen: Union[int, torch.Generator] = 0,
                     device: Union[str, torch.device, None] = None) -> TrainState:
    """Parameters from ``model.init(gen, device)`` (the card unless the
    caller asks for the CPU), zero moments, step 0."""
    params = model.init(gen, device=resolve_device(device))
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def eval_params(model: Model) -> Tuple[Any, Any]:
    """(params, logical axes): the parameter tree as meta tensors (no
    storage, no draws) and its axes tree."""
    return unzip(model.init_params(device="meta"))


def eval_train_state(model: Model) -> Tuple[TrainState, Any]:
    """(TrainState, axes) on the meta device: the parameters, AdamW's moments
    by ``adamw.init`` and the step."""
    params, axes = eval_params(model)
    state = TrainState(params=params, opt=adamw.init(params),
                       step=torch.empty((), dtype=torch.int32, device="meta"))
    return state, axes


def state_shardings(mesh, state: TrainState, axes) -> TrainState:
    """NamedSharding tree mirroring TrainState (opt moments follow params)."""
    p_sh = sh.param_shardings(mesh, state.params, axes)
    return TrainState(
        params=p_sh,
        opt=adamw.AdamWState(step=sh.NamedSharding(mesh, sh.P()), mu=p_sh, nu=p_sh),
        step=sh.NamedSharding(mesh, sh.P()),
    )


def attach_shardings(tree, shardings):
    """``TensorSpec`` trees (shape, dtype, sharding) of ``tree``'s tensors
    with the matching leaves of ``shardings``."""
    return sh.tree_map2(lambda t, s: sh.TensorSpec(tuple(t.shape), t.dtype, s), tree,
                        shardings)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    """``train_step(state, batch) → (state', metrics)``; metrics: ``loss``,
    ``ce``, ``aux``, ``zloss``, ``tokens``, ``grad_norm``, ``lr`` (0-d
    tensors).  ``state``'s parameters and moments are updated in place.  The
    batch is the loss's: ``tokens``, ``targets`` (-1 where masked), and
    ``patches`` (VLM) or ``frames`` (encoder–decoder)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # A leaf the loss does not reach has a zero gradient, as in JAX.
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        grads = tree_map(lambda _: next(it), state.params)
        params, opt, opt_metrics = adamw.apply(opt_cfg, state.opt, state.params, grads)
        out = TrainState(params=params, opt=opt, step=state.step + 1)
        return out, {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                     **opt_metrics}

    return train_step


def make_prefill_step(model: Model):
    """Forward over the full prompt; returns the last position's logits
    ``(B, 1, V)`` in f32.  The batch is the backbone's: ``tokens``, and
    ``patches`` (VLM) or ``frames`` (encoder–decoder).  The attention of
    every layer runs ``cfg.attention_impl``: the flash kernel only with
    ``"cuda"``, which ``get_config`` / ``reduced_config`` do not set (their
    default ``"chunked"`` is the plain version), so build the model from
    ``dataclasses.replace(cfg, attention_impl="cuda")`` to run it."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        hidden, _ = model.backbone(params, batch)
        return model.logits(params, hidden[:, -1:, :])

    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def serve_step(params, cache, tokens: torch.Tensor, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
