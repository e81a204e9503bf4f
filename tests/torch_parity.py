"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages as numpy; states go
across through ``repro_torch.convert``'s numpy layout.
"""

import dataclasses

import jax
import numpy as np
import torch

CPU = torch.device("cpu")

# The suite runs in several worker processes on a few cores: one intra-op
# thread per process keeps the port's tests from starving the other files.
torch.set_num_threads(1)


def to_np(x):
    """A JAX array or a torch tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(jax.device_get(x))


def jax_state_to_numpy(state):
    """The reference ``SimulationState`` in ``repro_torch.convert``'s layout."""
    pool = state.pool
    fields = ("position", "diameter", "kind", "age", "alive", "static", "overflow")
    return {
        "pool": {
            **{f: to_np(getattr(pool, f)) for f in fields},
            "attrs": {k: to_np(v) for k, v in pool.attrs.items()},
        },
        "grids": {
            name: {
                "concentration": to_np(g.concentration),
                "origin": g.origin,
                "spacing": g.spacing,
                "diffusion_coefficient": g.diffusion_coefficient,
                "decay_constant": g.decay_constant,
            }
            for name, g in state.grids.items()
        },
        "rng": to_np(jax.random.key_data(state.rng)
                     if jax.dtypes.issubdtype(state.rng.dtype, jax.dtypes.prng_key)
                     else state.rng),
        "step": int(state.step),
        "health": {f.name: int(getattr(state.health, f.name))
                   for f in dataclasses.fields(state.health)},
    }


def random_positions(rng, n, space, margin=0.0):
    return rng.uniform(margin, space - margin, (n, 3)).astype(np.float32)
