"""Serve step builders of the LM stack, ported from ``repro/training.py``.

Only the prefill and decode steps: ``make_train_step``, the train state and
the sharding helpers belong to the training slice (ROADMAP queue 1, item 15.5).
"""

from __future__ import annotations

from typing import Dict

import torch

from .models.model import Model


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
