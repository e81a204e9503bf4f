"""The dry-run's input shapes and meta-tensor input specs, ported from
``repro/configs/shapes.py``.

Shapes (LM transformers: seq_len × global_batch):
  train_4k     seq 4'096,   batch 256   → train_step
  prefill_32k  seq 32'768,  batch 32    → serve prefill (forward, last logits)
  decode_32k   seq 32'768,  batch 128   → serve_step: 1 token, seq-long cache
  long_500k    seq 524'288, batch 1     → serve_step; sub-quadratic archs only

``input_specs`` returns meta tensors for every model input (no storage): the
reference's ``ShapeDtypeStruct``s, shape and dtype for shape and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason) per the sub-quadratic rule (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k dense-KV decode is the quadratic regime this shape excludes"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta tensors for the batch of one step of this (arch × shape)."""
    b, t = shape.global_batch, shape.seq_len
    cd = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, t), torch.int32)}
        if shape.kind == "train":
            batch["targets"] = _meta((b, t), torch.int32)
        if cfg.is_encoder_decoder:
            batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cd)
        if cfg.family == "vlm":
            batch["patches"] = _meta((b, cfg.prefix_tokens, cfg.d_model), cd)
        return batch

    # decode: one new token against a seq_len-deep cache/state
    return {
        "tokens": _meta((b, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The decode cache at context depth seq_len, as meta tensors."""
    from repro_torch.models.model import build_model

    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
