"""ctypes wrapper of ``csrc/pairwise_force.cu`` (replaces the Pallas
``pairwise_force_planar``; the design note is in the source).

Natural layouts in and out: ``(N, 3)`` positions, ``(N, K)`` candidate ids
and mask; the kernel gathers the candidates' positions and radii itself.
``launches`` counts the wrapper's kernel launches; ``design_bytes`` counts
what the kernel's design moves on given candidates.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("pairwise_force")
    if not getattr(lib, "_typed", False):
        lib.pairwise_force_launch.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P, _P,
        ]
        lib.pairwise_force_launch.restype = _I
        lib._typed = True
    return lib


def pairwise_force_cuda(
    position: torch.Tensor,      # (N, 3) f32
    radius: torch.Tensor,        # (N,) f32
    cand: torch.Tensor,          # (N, K) int32, ids in [0, S) where masked in
    cand_mask: torch.Tensor,     # (N, K) bool
    k: float = 2.0,
    gamma: float = 1.0,
    all_position: torch.Tensor | None = None,   # (S, 3) f32
    all_radius: torch.Tensor | None = None,     # (S,) f32
) -> torch.Tensor:
    """Net Eq-4.1 force per query agent, ``(N, 3)`` f32, over the candidates
    whose mask is set."""
    global launches
    src_pos = position if all_position is None else all_position
    src_rad = radius if all_radius is None else all_radius
    n = position.shape[0]
    s = src_pos.shape[0]
    if position.shape != (n, 3) or radius.shape != (n,):
        raise ValueError(f"pairwise_force: position {tuple(position.shape)} / radius "
                         f"{tuple(radius.shape)} must be (N, 3) / (N,)")
    if src_pos.shape != (s, 3) or src_rad.shape != (s,) or s < n:
        raise ValueError(f"pairwise_force: sources {tuple(src_pos.shape)} / "
                         f"{tuple(src_rad.shape)} must be (S, 3) / (S,) with S >= N")
    if cand.ndim != 2 or cand.shape[0] != n or cand_mask.shape != cand.shape:
        raise ValueError(f"pairwise_force: cand {tuple(cand.shape)} / cand_mask "
                         f"{tuple(cand_mask.shape)} must both be (N, K), N = {n}")
    for name, t in (("position", position), ("radius", radius),
                    ("all_position", src_pos), ("all_radius", src_rad)):
        if t.dtype != torch.float32:
            raise ValueError(f"pairwise_force: {name} must be float32, got {t.dtype}")
    if cand.dtype != torch.int32 or cand_mask.dtype != torch.bool:
        raise ValueError("pairwise_force: cand must be int32 and cand_mask bool")
    _build.require_cuda("pairwise_force", position, radius, cand, cand_mask,
                        src_pos, src_rad)
    kdim = cand.shape[1]
    if n == 0 or kdim == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=position.device)
    out = torch.empty((n, 3), dtype=torch.float32, device=position.device)  # every row written
    lib = _lib()
    _build.check(
        lib.pairwise_force_launch(
            position.device.index, _build.ptr(position), _build.ptr(radius),
            _build.ptr(cand), _build.ptr(cand_mask), _build.ptr(src_pos),
            _build.ptr(src_rad), n, kdim, float(k), float(gamma), _build.ptr(out),
            _build.stream_of(position),
        ),
        "pairwise_force",
    )
    launches += 1
    return out


def design_bytes(cand_mask: torch.Tensor) -> int:
    """Bytes the kernel's design moves on ``(N, K)`` candidates whose ids lie
    in a 32-byte aligned ``(N, K)`` int32 tensor and whose sources are the
    queries: every mask byte, each 32-byte sector of ids that holds a
    masked-in slot, the queries' positions and radii (16 B a row) and the
    output (12 B a row)."""
    n, kdim = cand_mask.shape
    flat = cand_mask.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])  # 8 ids a sector
    sectors = int(flat.view(-1, 8).any(1).sum())
    return n * kdim + 32 * sectors + 16 * n + 12 * n
