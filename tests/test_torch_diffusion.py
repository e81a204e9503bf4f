"""Extracellular diffusion: the port vs the JAX reference.

The JAX stencil runs as its own tests run it (the Pallas kernel in interpret
mode).  Fields agree to ``rtol=atol=1e-6``, the reference's own tolerance
between its kernel and its plain version (tests/test_kernels.py); voxel
indices and the secretion scatter are exact.  The Fig 4.9 point-source
assertions of tests/test_diffusion.py are re-run on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diffusion as j_diff
from repro.kernels.diffusion3d import ops as j_d3
from repro_torch.core import diffusion as t_diff
from repro_torch.kernels.diffusion3d import ops as t_d3
from torch_parity import to_np

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 8, 8), (13, 16, 24), (8, 1, 4), (5, 5, 5)])
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_diffusion_step_matches_jax_kernel(shape, impl):
    rng = np.random.default_rng(sum(shape))
    u = rng.random(shape).astype(np.float32)
    want = to_np(j_d3.diffusion_step(jnp.asarray(u), 0.16, 0.002, impl="pallas"))
    got = t_d3.diffusion_step(torch.from_numpy(u), 0.16, 0.002, impl=impl)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def _grids(res=12, lo=0.0, hi=60.0, d=2.0, decay=0.01, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 5, (res,) * 3).astype(np.float32)
    jg = j_diff.make_grid(lo, hi, res, diffusion_coefficient=d, decay_constant=decay)
    tg = t_diff.make_grid(lo, hi, res, diffusion_coefficient=d, decay_constant=decay)
    jg = dataclasses.replace(jg, concentration=jnp.asarray(u))
    tg = dataclasses.replace(tg, concentration=torch.from_numpy(u))
    return jg, tg


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_diffuse_matches_jax(impl):
    jg, tg = _grids()
    j_impl = "pallas" if impl == "cuda" else "reference"
    for _ in range(3):
        jg = j_diff.diffuse(jg, 0.5, impl=j_impl)
        tg = t_diff.diffuse(tg, 0.5, impl=impl)
    np.testing.assert_allclose(to_np(tg.concentration), to_np(jg.concentration), **TOL)
    assert t_diff.stability_limit(tg) == j_diff.stability_limit(jg)


def _probe_positions(spacing, res, seed=0):
    """Random positions, points on voxel-centre half-way marks (round half
    to even), and points outside the grid (clipped onto its edge)."""
    rng = np.random.default_rng(seed)
    extent = spacing * res
    pos = rng.uniform(0, extent, (200, 3))
    halves = spacing * (np.arange(res)[:, None] + np.array([0.0, 1.0, 0.5])[None])
    pos = np.concatenate([pos, halves[:, [0, 1, 2]], [[-3.0, extent + 4.0, 1.0],
                                                      [extent, 0.0, extent * 0.5]]])
    return pos.astype(np.float32)


def test_coupling_matches_jax():
    jg, tg = _grids(res=10, hi=50.0)
    pos = _probe_positions(jg.spacing, 10)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    np.testing.assert_array_equal(to_np(t_diff._nearest_voxel(tg, tpos)),
                                  to_np(j_diff._nearest_voxel(jg, jpos)))
    np.testing.assert_array_equal(to_np(t_diff.concentration_at(tg, tpos)),
                                  to_np(j_diff.concentration_at(jg, jpos)))
    for normalized in (True, False):
        np.testing.assert_allclose(
            to_np(t_diff.gradient_at(tg, tpos, normalized=normalized)),
            to_np(j_diff.gradient_at(jg, jpos, normalized=normalized)), **TOL)
    # Secretion: repeated voxels accumulate, masked agents add nothing.
    amount = np.linspace(0.5, 3.0, pos.shape[0]).astype(np.float32)
    mask = np.arange(pos.shape[0]) % 4 != 1
    want = j_diff.increase_concentration(jg, jpos, jnp.asarray(amount), jnp.asarray(mask))
    got = t_diff.increase_concentration(tg, tpos, torch.from_numpy(amount),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got.concentration), to_np(want.concentration), **TOL)
    want = j_diff.increase_concentration(jg, jpos, 1.0)
    got = t_diff.increase_concentration(tg, tpos, 1.0)
    np.testing.assert_allclose(to_np(got.concentration), to_np(want.concentration), **TOL)


def test_padded_grid_coupling_matches_jax():
    """``n_valid`` / ``frame_shift`` (the distributed engine's ghost-voxel
    padding) clip and shift sampling the same way."""
    jg, tg = _grids(res=10, hi=50.0, seed=3)
    n_valid, shift = np.array([8, 10, 7], np.int32), np.array([1.5, -2.0, 0.0], np.float32)
    jg = dataclasses.replace(jg, n_valid=jnp.asarray(n_valid), frame_shift=jnp.asarray(shift))
    tg = dataclasses.replace(tg, n_valid=torch.from_numpy(n_valid),
                             frame_shift=torch.from_numpy(shift))
    pos = _probe_positions(jg.spacing, 10, seed=4)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    np.testing.assert_array_equal(to_np(t_diff.concentration_at(tg, tpos)),
                                  to_np(j_diff.concentration_at(jg, jpos)))
    np.testing.assert_allclose(to_np(t_diff.gradient_at(tg, tpos)),
                               to_np(j_diff.gradient_at(jg, jpos)), **TOL)


def test_analytical_point_source_matches_jax():
    r = np.linspace(0.0, 80.0, 33).astype(np.float32)
    want = j_diff.analytical_point_source(1.0, 50.0, jnp.asarray(r), jnp.float32(20.0))
    got = t_diff.analytical_point_source(1.0, 50.0, torch.from_numpy(r), 20.0)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-12)


# ------------------------------------- tests/test_diffusion.py on the port

IMPLS = ["reference", "cuda"]


def _source(grid, where, amount):
    return t_diff.increase_concentration(grid, torch.tensor([where], dtype=torch.float32),
                                         torch.tensor([amount], dtype=torch.float32))


@pytest.mark.parametrize("impl", IMPLS)
def test_mass_conserved_interior(impl):
    g = _source(t_diff.make_grid(0.0, 100.0, 40, diffusion_coefficient=0.5),
                [50.0, 50.0, 50.0], 42.0)
    total0 = float(g.concentration.sum())
    for _ in range(20):
        g = t_diff.diffuse(g, 0.5, impl=impl)
    np.testing.assert_allclose(float(g.concentration.sum()), total0, rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_decay_reduces_mass(impl):
    g = _source(t_diff.make_grid(0.0, 100.0, 20, diffusion_coefficient=0.0,
                                 decay_constant=0.1), [50.0, 50.0, 50.0], 10.0)
    g = t_diff.diffuse(g, 1.0, impl=impl)
    np.testing.assert_allclose(float(g.concentration.sum()), 9.0, rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_outflow_boundary_loses_mass(impl):
    g = _source(t_diff.make_grid(0.0, 10.0, 5, diffusion_coefficient=0.5),
                [0.5, 0.5, 0.5], 10.0)
    for _ in range(10):
        g = t_diff.diffuse(g, 0.5, impl=impl)
    assert float(g.concentration.sum()) < 10.0


@pytest.mark.parametrize("impl", IMPLS)
def test_gradient_points_to_source(impl):
    g = _source(t_diff.make_grid(0.0, 50.0, 25, diffusion_coefficient=0.5),
                [25.0, 25.0, 25.0], 100.0)
    for _ in range(5):
        g = t_diff.diffuse(g, 1.0, impl=impl)
    grad = t_diff.gradient_at(g, torch.tensor([[15.0, 25.0, 25.0]]))
    assert float(grad[0, 0]) > 0.9


def test_convergence_to_analytical():
    """Fig 4.9: the relative L2 error against the point-source solution over
    the 20 ≤ r ≤ 60 μm shell falls with resolution, below 0.1 at 80³ (on
    the stencil the engine runs, the kernel's plain version)."""
    d_coeff, extent, t_end = 50.0, 400.0, 20.0
    errors = []
    for res in (20, 40, 80):
        g = t_diff.make_grid(-extent / 2, extent / 2, res, diffusion_coefficient=d_coeff)
        g = _source(g, [0.0, 0.0, 0.0], 1.0 / g.spacing**3)
        dt = 0.8 * t_diff.stability_limit(g)
        n_steps = int(np.ceil(t_end / dt))
        dt = t_end / n_steps
        for _ in range(n_steps):
            g = t_diff.diffuse(g, dt, impl="cuda")
        centers = -extent / 2 + g.spacing * (np.arange(res) + 0.5)
        xx, yy, zz = np.meshgrid(centers, centers, centers, indexing="ij")
        r = np.sqrt(xx**2 + yy**2 + zz**2)
        shell = (r >= 20.0) & (r <= 60.0)
        ana = to_np(t_diff.analytical_point_source(
            1.0, d_coeff, torch.from_numpy(r[shell].astype(np.float32)), t_end))
        sim = to_np(g.concentration)[shell]
        errors.append(float(np.linalg.norm(sim - ana) / np.linalg.norm(ana)))
    assert errors[2] < errors[1] < errors[0], errors
    assert errors[2] < 0.1, errors
