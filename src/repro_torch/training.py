"""Train and serve step builders of the LM stack, ported from
``repro/training.py``.

``make_train_step`` closes over a Model and an AdamW config and returns the
step ``(state, batch) → (state', metrics)``: the loss and its gradient by
autograd, then ``adamw.apply``, which updates the parameters and moments in
place (the reference donates its state to the jitted step).  The dry-run's
helpers (``eval_params``, ``eval_train_state``, ``state_shardings``,
``attach_shardings``) wait for ROADMAP queue 1, item 15.6.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Union

import torch

from .device import resolve_device
from .models.model import Model
from .models.params import tree_leaves, tree_map
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
