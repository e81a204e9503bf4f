"""Architecture registry (``--arch <id>``) and the dry-run's input shapes,
copied from ``repro.configs``.

``configs/shapes.py`` gives the dry-run's shapes and its inputs as meta
tensors, where the reference's are ``jax.ShapeDtypeStruct``s.
"""

from .archs import ARCHS
from .base import ModelConfig
from .shapes import SHAPES, ShapeSpec, cache_specs, input_specs, shape_applicable


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses

    cfg = get_config(name)
    pattern = len(cfg.block_pattern)
    small = dict(
        n_layers=max(2 * pattern, pattern * 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 16) if cfg.window else None,
        lru_width=64,
        rnn_head_dim=16,
        encoder_seq=24,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        prefix_tokens=8 if cfg.family == "vlm" else 0,
        rwkv_chunk=8,
        attention_block_q=16,
        attention_block_k=16,
        dtype="float32",
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
