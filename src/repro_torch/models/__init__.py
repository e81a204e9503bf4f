"""The LM stack's models, ported from ``repro.models``: dense decoder blocks
(attention + GLU MLP) with RMSNorm / LayerNorm, RoPE and a KV cache."""
