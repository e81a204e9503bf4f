"""The 10 assigned architectures, exact configs from the public pool.

Source tags from the assignment brackets are kept in each docstring.
"""

from __future__ import annotations

from .base import ModelConfig

# [hf:microsoft/Phi-3.5-MoE-instruct; hf] — 16 experts, top-2
PHI35_MOE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    activation="swiglu",
)

# [arXiv:2409.02060; hf] — 64 experts, top-8
OLMOE = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    activation="swiglu",
)

# [arXiv:2412.08905; hf] — RoPE SwiGLU GQA
PHI4_MINI = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
)

# [hf:CohereForAI/c4ai-command-r-v01; unverified] — GQA, no-bias, LayerNorm
COMMAND_R = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    activation="swiglu",
    norm="layernorm",
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)

# [arXiv:2403.08295; hf] — GeGLU, head_dim=256
GEMMA_7B = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
)

# [hf:mistralai/Mistral-Nemo-Base-2407; hf] — 128k ctx
MISTRAL_NEMO = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    activation="swiglu",
    rope_theta=1_000_000.0,
)

# [arXiv:2212.04356; unverified] — enc-dec; conv frontend stubbed
WHISPER_BASE = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,
    tie_embeddings=True,
)

# [arXiv:2404.05892; unverified] — Finch, data-dependent decay
RWKV6 = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads = d_model / rnn_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    norm="layernorm",
    rnn_head_dim=64,
)

# [arXiv:2402.19427; unverified] — RG-LRU + local attention, 1:2
RECURRENTGEMMA = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,          # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    activation="geglu",
    window=2048,
    lru_width=4096,
    conv1d_width=4,
    tie_embeddings=True,
)

# [arXiv:2407.07726; hf] — SigLIP stub + gemma backbone, prefix-LM
PALIGEMMA = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    prefix_tokens=256,     # 224² / 14² SigLIP patches
    tie_embeddings=True,
)

ARCHS = {
    c.name: c
    for c in (
        PHI35_MOE, OLMOE, PHI4_MINI, COMMAND_R, GEMMA_7B,
        MISTRAL_NEMO, WHISPER_BASE, RWKV6, RECURRENTGEMMA, PALIGEMMA,
    )
}
