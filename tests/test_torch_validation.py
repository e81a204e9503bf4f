"""The reproduction's certifications (tests/test_validation.py) applied to the
port, at the same thresholds, with the models of tests/torch_usecases.py
on the CPU:

  * SIR against the Kermack–McKendrick solution (Fig 4.17, ``--fast``):
    trajectory RMSE < 0.08 of the population;
  * soma clustering emerges (Fig 4.18): 400 cells, 200 steps, space 90,
    the same-kind neighbour fraction rises by more than 0.15;
  * neurite arborization (Fig 4.13): 8 neurons, 100 steps, more than 320
    agents and a static fraction above 0.6;
  * the tumor spheroid grows (Fig 4.16): examples/tumor_spheroid.py's own
    bars — population > 1.5×, diameter > 1.2×, roughly monotone.
"""

import torch_parity  # noqa: F401  (one intra-op thread per worker)
import torch_usecases as U


def test_sir_matches_analytical():
    assert U.sir_fast_rmse() < 0.08


def test_soma_clustering_emerges():
    before, after = U.soma_main(n_cells=400, steps=200, space=90.0)
    assert after > before + 0.15


def test_neurite_growth_arborizes():
    alive, static_frac = U.neurite_main(n_neurons=8, steps=100)
    assert alive > 8 * 40
    assert static_frac > 0.6


def test_tumor_spheroid_grows():
    n0, n1, d0, diam = U.spheroid_main()
    assert n1 > 1.5 * n0 and diam[-1] > 1.2 * d0
