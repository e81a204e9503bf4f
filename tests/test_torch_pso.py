"""``repro_torch.optim.pso`` against the reference's ``repro.optim.pso``.

Both are numpy only and draw from ``np.random.default_rng(seed)`` in the
same order, so on one deterministic objective the swarms must agree
exactly: the same best position, best value and history, and the same
particles evaluated in the same order.
"""

import numpy as np
import pytest

from repro.optim import pso as jpso
from repro_torch.optim import pso as tpso

# examples/epidemiology_sir.py's bounds: infection radius, infection
# probability, maximum movement.
BOUNDS = [(1.0, 6.0), (0.05, 0.6), (1.0, 8.0)]


def _objective(calls):
    """A smooth deterministic stand-in for the SIR trajectory MSE, with its
    minimum inside the box, recording each point it is asked about."""
    target = np.array([3.24, 0.36, 6.2])
    scale = np.array([5.0, 0.55, 7.0])

    def f(p):
        calls.append(np.array(p, copy=True))
        z = (np.asarray(p) - target) / scale
        return float(np.sum(z * z) + 0.1 * np.sin(7.0 * z).sum() ** 2)

    return f


@pytest.mark.parametrize("n_particles,n_iters,seed", [(8, 8, 1), (4, 1, 1), (5, 3, 7)])
def test_optimize_equals_the_reference(n_particles, n_iters, seed):
    calls = {"jax": [], "torch": []}
    got = tpso.optimize(_objective(calls["torch"]), BOUNDS, n_iters=n_iters,
                        config=tpso.PSOConfig(n_particles=n_particles, seed=seed))
    want = jpso.optimize(_objective(calls["jax"]), BOUNDS, n_iters=n_iters,
                         config=jpso.PSOConfig(n_particles=n_particles, seed=seed))
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert np.array_equal(np.array(got[2]), np.array(want[2]))
    assert len(got[2]) == n_iters + 1
    assert len(calls["torch"]) == n_particles * (n_iters + 1)
    assert np.array_equal(np.stack(calls["torch"]), np.stack(calls["jax"]))
    lo, hi = np.array(BOUNDS).T
    assert ((got[0] >= lo) & (got[0] <= hi)).all()
    # The history never rises (global best).
    assert all(b <= a for a, b in zip(got[2], got[2][1:]))


def test_config_defaults_equal_the_reference():
    assert tpso.PSOConfig() == tpso.PSOConfig(**vars(jpso.PSOConfig()))
    assert vars(tpso.PSOConfig()) == vars(jpso.PSOConfig())


def test_verbose_prints_each_iteration(capsys):
    tpso.optimize(_objective([]), BOUNDS, n_iters=2,
                  config=tpso.PSOConfig(n_particles=3), verbose=True)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["pso iter 0", "pso iter 1"]
