"""Model configuration schema for the assigned architecture pool.

A copy of ``repro/configs/base.py``; the port names the attention kernel
impl ``"cuda"`` where the reference says ``"pallas"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM-family architecture (decoder LM / enc-dec / recurrent / VLM)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads

    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- block structure
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled across layers
    activation: str = "swiglu"                   # swiglu | geglu
    norm: str = "rmsnorm"
    use_bias: bool = False

    # --- attention
    window: Optional[int] = None                 # sliding-window size
    rope_theta: float = 10000.0
    prefix_tokens: int = 0                       # VLM prefix (bidirectional)

    # --- recurrent (rwkv6 / rg-lru)
    rnn_head_dim: int = 64                       # rwkv6 wkv head size
    lru_width: int = 0                           # 0 → d_model
    conv1d_width: int = 4

    # --- encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500                      # whisper: 30 s @ 50 Hz

    # --- numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save matmul outputs)
    scan_layers: bool = True
    attention_impl: str = "chunked"              # chunked | reference | cuda
    attention_block_q: int = 512
    attention_block_k: int = 1024
    rwkv_chunk: int = 64
    tie_embeddings: bool = False
    # Dry-run cost-accounting mode: unroll inner lax.scans (flash kv blocks,
    # rwkv chunks, loss chunks) so XLA cost_analysis — which counts a while
    # body once — sees every iteration.  Never used for real runs.
    unroll_inner_scans: bool = False

    # --- paper-technique features
    moe_token_sort: bool = True                  # §5.4.2 insight → MoE dispatch

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_recurrent_only(self) -> bool:
        return all(b in ("rwkv6", "rglru") for b in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True when decode cost is O(1)/O(window) in context length —
        required for the long_500k shape (sub-quadratic rule)."""
        return all(b in ("rwkv6", "rglru", "local_attn") for b in self.block_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind per layer (pattern cycled to n_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def params_dense(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, v, h = self.d_model, self.d_ff, self.vocab_size, self.head_dim
        kinds = self.layer_kinds()
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        glu = 3 if self.activation in ("swiglu", "geglu") else 2
        for kind in kinds:
            if kind in ("attn", "local_attn"):
                q = d * self.n_heads * h
                kv = 2 * d * self.n_kv_heads * h
                o = self.n_heads * h * d
                total += q + kv + o
            elif kind == "rwkv6":
                total += 4 * d * d + d * d  # r,k,v,g + out
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d + 3 * w  # in×2, out, gates
            if self.is_moe and kind in ("attn", "local_attn"):
                total += self.n_experts * glu * d * f + d * self.n_experts
            elif kind == "rwkv6":
                total += 2 * d * self.d_ff  # channel mix (k, v)
            else:
                total += glu * d * f
        if self.is_encoder_decoder:
            # encoder layers (attn + mlp) + cross-attention in decoder counted above approximately
            for _ in range(self.n_encoder_layers):
                total += 4 * d * self.n_heads * h + glu * d * f
            total += self.n_layers * (2 * d * self.n_kv_heads * h + 2 * d * self.n_heads * h)
        return int(total)

    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.params_dense()
        d, f = self.d_model, self.d_ff
        glu = 3 if self.activation in ("swiglu", "geglu") else 2
        expert_params = self.n_experts * glu * d * f * self.n_layers
        active_expert = self.top_k * glu * d * f * self.n_layers
        return int(self.params_dense() - expert_params + active_expert)
