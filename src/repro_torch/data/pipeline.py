"""Deterministic synthetic token pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only, the same draws in the same
order), with ``device_batch`` placing the batch on an explicit torch device.

Stateless-seeded: ``host_batch(cfg, model_cfg, step)`` is a pure function of
(seed, step), so a restarted run regenerates identical batches with no
pipeline checkpointing (``launch/train.py`` relies on it).  Synthetic text:
Zipf-distributed unigrams and a copy-8-back repetition process, so the loss
curve has learnable structure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 256
    zipf_a: float = 1.2
    repeat_p: float = 0.3          # P(copy token from 8 back)


def _tokens_for_step(cfg: DataConfig, vocab: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, t = cfg.batch, cfg.seq_len
    # Zipf unigrams truncated to vocab
    base = rng.zipf(cfg.zipf_a, size=(b, t)).astype(np.int64)
    base = (base - 1) % vocab
    # repetition structure: with prob p, copy the token 8 positions back
    rep = rng.random((b, t)) < cfg.repeat_p
    out = base.copy()
    out[:, 8:][rep[:, 8:]] = out[:, :-8][rep[:, 8:]]
    return out.astype(np.int32)


def host_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int) -> Dict[str, np.ndarray]:
    """NumPy batch for one step: ``tokens``, ``targets`` (the next token, -1
    at the last position), ``frames`` (encoder–decoder) or ``patches``
    (VLM) of unit normals."""
    toks = _tokens_for_step(cfg, model_cfg.vocab_size, step)
    batch = {
        "tokens": toks,
        "targets": np.concatenate(
            [toks[:, 1:], np.full((cfg.batch, 1), -1, np.int32)], axis=1
        ),
    }
    if model_cfg.is_encoder_decoder:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 7]))
        batch["frames"] = rng.normal(
            0, 1, (cfg.batch, model_cfg.encoder_seq, model_cfg.d_model)
        ).astype(np.float32)
    if model_cfg.family == "vlm":
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 9]))
        batch["patches"] = rng.normal(
            0, 1, (cfg.batch, model_cfg.prefix_tokens, model_cfg.d_model)
        ).astype(np.float32)
    return batch


def device_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int,
                 device: torch.device | str) -> Dict[str, torch.Tensor]:
    """``host_batch`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in host_batch(cfg, model_cfg, step).items()}
