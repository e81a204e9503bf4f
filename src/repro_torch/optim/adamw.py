"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py`` over the port's parameter trees (nested
dicts of tensors).  The schedule and the bias corrections are computed in
f32 tensors, as the reference computes them; the moments are f32.

``apply`` updates in place: the gradients (scaled by the clip), the moments
and the parameters.  The values are the reference's, op for op (each
product and sum rounded as its expression rounds them); at full width its
per-leaf temporaries, and new parameter and moment trees, would cost several
GB each.  It returns the same trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.params import tree_leaves, tree_leaves_sorted, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero f32 moments beside each leaf and step 0, on the leaves' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, an f32 0-d tensor."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32, the leaves summed in sorted-key order (a
    resumed run's restored dicts sum as a straight run's)."""
    total = None
    for x in tree_leaves_sorted(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params, grads):
    """Returns ``(params, state, metrics)``, the trees updated in place;
    ``metrics``: ``grad_norm`` (before the clip) and ``lr``, 0-d f32."""
    gnorm = global_norm(grads)
    flat_g = tree_leaves(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g in flat_g:
            g.mul_(scale)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        gf = g if g.dtype == torch.float32 else g.float()
        m.mul_(b1).add_(gf * (1 - b1))                      # m2 = b1 m + (1 - b1) g
        v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))     # v2 = b2 v + (1 - b2) g²
        del gf
        delta = m / bc1                                     # mhat
        vhat = torch.div(v, bc2).sqrt_().add_(cfg.eps)      # sqrt(vhat) + eps
        delta.div_(vhat)
        pf = p if p.dtype == torch.float32 else p.float()
        delta.add_(torch.mul(pf, cfg.weight_decay, out=vhat))
        del vhat
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(pf - delta.mul_(lr))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm,
                                                                      "lr": lr}
