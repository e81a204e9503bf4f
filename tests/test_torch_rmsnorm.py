"""The port's RMSNorm against the reference's Pallas kernel (interpret mode)
and its model's ``norm_apply``, on the CPU.

Tolerances: f32 ``rtol=1e-5, atol=1e-6`` (the row sums run in another
order); bf16 one bf16 ulp, ``rtol=2**-7`` (the f32 results, a few f32 ulp
apart, may round to neighbouring bf16 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.kernels.rmsnorm import ops as rms_ops
from repro.models.layers import norm_apply as jax_norm_apply
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as port_rms
from repro_torch.models.layers import norm_apply

TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2**-7, atol=1e-6)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, shape).astype(np.float32)
    s = rng.normal(1, 0.2, shape[-1:]).astype(np.float32)
    xj = jnp.asarray(x, JNP[dtype])
    # The same (rounded) values on both sides.
    return xj, s, torch.from_numpy(to_np(xj.astype(jnp.float32))).to(TORCH[dtype])


# Row counts not a multiple of the Pallas tile (256), a 3-D input, D not a
# multiple of a warp's 16-byte chunk.
@pytest.mark.parametrize("shape", [(8, 64), (300, 128), (3, 17, 256), (5, 3072), (7, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_rmsnorm_matches_jax_pallas(shape, dtype, impl):
    xj, s, xt = _inputs(shape, dtype, sum(shape))
    want = rms_ops.rmsnorm(xj, jnp.asarray(s), impl="pallas")
    got = port_rms.rmsnorm(xt, torch.from_numpy(s), impl=impl)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(), to_np(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_apply_matches_jax_model(dtype):
    """The port's norm_apply (through the rmsnorm ops) against the
    reference model's plain-jnp norm_apply."""
    xj, s, xt = _inputs((4, 32, 128), dtype, 9)
    want = jax_norm_apply({"scale": jnp.asarray(s)}, xj, "rmsnorm")
    before = rms_kernel.launches
    got = norm_apply({"scale": torch.from_numpy(s)}, xt, "rmsnorm")
    assert rms_kernel.launches == before           # CPU tensors: the plain version
    np.testing.assert_allclose(got.float().numpy(), to_np(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_layernorm_matches_jax_model():
    xj, s, xt = _inputs((3, 5, 96), "float32", 4)
    b = np.linspace(-1, 1, 96).astype(np.float32)
    want = jax_norm_apply({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, xj, "layernorm")
    got = norm_apply({"scale": torch.from_numpy(s), "bias": torch.from_numpy(b)}, xt,
                     "layernorm")
    np.testing.assert_allclose(got.numpy(), to_np(want), **TOL["float32"])
