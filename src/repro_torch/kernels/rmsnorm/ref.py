"""Plain PyTorch version of the fused RMSNorm.

Port of ``repro/kernels/rmsnorm/ref.py``, the same function as the Pallas
``_rmsnorm_kernel`` (``kernel.py:26-30``) and the reference model's
``norm_apply`` (``models/layers.py:28-38``): f32 row statistics, the
output cast back to the input's dtype.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x², axis=-1) + eps) * scale, stats in fp32."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)
