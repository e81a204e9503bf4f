"""The H100's peaks and the least time a piece of work can take on it.

A frozen copy of ``chip_smoke.py``'s peaks (lines 405-407) and ``bound``
(lines 4164-4169): NVIDIA's data sheet for the H100 SXM at its 700 W limit,
dense rates.  f32 work outside the tensor cores runs at 67 TFLOP/s (integer
ALU work is counted at the same rate), and HBM3 moves 3.35 TB/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes at full bandwidth and the operations at the
    f32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
