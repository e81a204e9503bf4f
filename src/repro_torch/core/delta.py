"""Delta encoding + quantization codecs (§6.2.3 data-transfer minimization).

Port of ``repro.core.delta``.  TeraAgent cuts aura (halo) traffic by sending
the *difference* between an attribute's value in iteration *i* and *i−1*.
Collectives want fixed shapes, so the entropy coder is replaced by
fixed-rate *quantization*:

    payload_i  = round((x_i − ref_{i−1}) / scale)   (int8 or int16)
    ref_i      = ref_{i−1} + payload_i · scale       (identically on both ends)

The sender keeps ``ref`` — the receiver's exact reconstruction — so the
quantization error is fed back and never accumulates.  ``torch.round``
rounds half to even, as ``jnp.round`` does, and the payload is clipped to
the wire type's symmetric range before the cast.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_INT_INFO = {
    torch.int8: 127,
    torch.int16: 32767,
    torch.int32: 2**31 - 1,
}


def seal(x: torch.Tensor) -> torch.Tensor:
    """The identity.  The reference pins ``x`` to one f32 rounding with a
    full-width ``reduce_precision`` because XLA may duplicate a cheap
    producer into several fusions and contract a multiply-add into an FMA in
    some of them.  Eager PyTorch runs each op as its own kernel and rounds
    every result once, so there is nothing to pin."""
    return x


@dataclasses.dataclass(frozen=True)
class DeltaCodec:
    """Stateful delta codec over a fixed-shape f32 buffer.

    ref:   (…,) f32 — receiver-side reconstruction (shared by construction).
    scale: ()   f32 — quantization step.
    """

    ref: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def create(shape: Tuple[int, ...], scale: float, dtype=torch.float32,
               device: torch.device | str = "cpu") -> "DeltaCodec":
        return DeltaCodec(
            ref=torch.zeros(shape, dtype=dtype, device=device),
            scale=torch.tensor(scale, dtype=torch.float32, device=device),
        )


def encode(codec: DeltaCodec, x: torch.Tensor, wire_dtype=torch.int16,
           scale: torch.Tensor | None = None) -> Tuple[torch.Tensor, DeltaCodec]:
    """Quantize the delta to ``wire_dtype``; returns (payload, codec').

    ``scale`` optionally overrides the stored scale and may be per-slot
    (broadcastable): two-scale coding of fresh vs. stale slots."""
    s = codec.scale if scale is None else scale
    qmax = _INT_INFO[wire_dtype]
    delta = (x - codec.ref) / s
    q = torch.clamp(torch.round(delta), -qmax, qmax).to(wire_dtype)
    new_ref = seal(codec.ref + q.to(torch.float32) * s)
    return q, dataclasses.replace(codec, ref=new_ref)


def decode(codec: DeltaCodec, payload: torch.Tensor, scale: torch.Tensor | None = None
           ) -> Tuple[torch.Tensor, DeltaCodec]:
    """Receiver side: reconstruct and advance the reference."""
    s = codec.scale if scale is None else scale
    x = seal(codec.ref + payload.to(torch.float32) * s)
    return x, dataclasses.replace(codec, ref=x)


def reset_slots(codec: DeltaCodec, mask: torch.Tensor) -> DeltaCodec:
    """Zero the reference where ``mask`` — a buffer slot's occupant changed
    (the paper re-sends a full record for new agents)."""
    ref = torch.where(torch.broadcast_to(mask, codec.ref.shape), 0.0, codec.ref)
    return dataclasses.replace(codec, ref=ref)


def wire_bytes(payload: torch.Tensor) -> int:
    """Bytes this payload puts on the interconnect."""
    return int(payload.numel()) * payload.element_size()


def roundtrip_error_bound(codec: DeltaCodec) -> float:
    """|x − decode(encode(x))| ≤ scale/2 whenever the delta is in range."""
    return float(codec.scale) * 0.5


# ---------------------------------------------------------------------------
# Stateless helpers (the reference's gradient-compression path).
# ---------------------------------------------------------------------------

def quantize_symmetric(x: torch.Tensor, wire_dtype=torch.int8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization: returns (q, scale)."""
    qmax = _INT_INFO[wire_dtype]
    scale = torch.clamp(x.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(wire_dtype)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
