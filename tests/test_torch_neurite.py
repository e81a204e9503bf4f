"""The neurite-growth use case (examples/neurite_growth.py, paper §4.6.1)
and §5.5 static-agent omission on the port against the JAX reference.

(a) The example's smoke run (4 neurons, 12 steps) under ``run_jit`` is its
    ``run`` bit for bit, and within tests/test_torch_usecases.py's
    tolerances of the reference's model stepped by the reference's
    ``run_jit``, the example's own entry point.
(b) The same model with ``impl="fused"`` and work compaction against the
    reference's ``impl="fused"`` with ``active_capacity`` (its Pallas
    kernels in interpret mode, which take seconds a call at 128 slots a
    box): in a 40 µm space (10^3 boxes, the somata on a 24 µm plate, the
    cue still peaking at 120 µm) with ``active_capacity`` 26, which the
    active set outgrows at steps 9 and 10 only, so both branches of
    ``mechanical_forces`` run, the fused kernel's plain version in the
    crowded steps and the compacted branch before and after.
(c) ``neurite``'s ``plate`` and ``cue_top`` at their defaults give the
    example's model leaf for leaf; at a scaled plate the cue is the
    example's as a function of z.

Tolerances: alive flags, kinds, static flags and kind counts exact;
positions, directions and path lengths ``atol=1e-4``.
"""

import dataclasses
import os
import sys

import numpy as np

import repro.core as jc
from repro import Simulation as JSimulation
from repro_torch import convert
from repro_torch.core import gradient_at
from torch_parity import jax_state_to_numpy, to_np
import torch
import torch_usecases as U

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

N, STEPS, ATOL = 4, 12, 1e-4
FLOATS = ("position", "direction", "path_len")


def _observed(sim):
    return (sim.observe("position", lambda s: s.pool.position)
               .observe("alive", lambda s: s.pool.alive)
               .observe("static", lambda s: s.pool.static)
               .observe_kinds(n_kinds=2))


def _jax_neurite(tsim, impl, active_capacity):
    """The reference's model (the example's ops) from the port's start."""
    import neurite_growth as G

    g, cue = tsim._groups[0], tsim._grids["guide"].concentration
    return _observed(
        JSimulation(space=(tsim.min_bound, tsim.max_bound), cell_size=4.0,
                    boundary="closed", dt=0.5, capacity=8192, max_per_cell=128, seed=0, diffusion_frequency=0)
        .add_agents(N, position=to_np(g.position), diameter=2.0, kind=to_np(g.kind),
                    direction=to_np(g.attrs["direction"]), path_len=0.0)
        .add_substance("guide", diffusion=0.0, resolution=cue.shape[0],
                       concentration=to_np(cue))
        .use(G.neurite_extension("guide", speed=2.4, w_old=4.0, w_grad=1.5, w_rand=0.6,
                                 branch_prob=0.02, target_z=104.0))
        .mechanics(jc.ForceParams(static_tolerance=1e-3), impl=impl,
                   active_capacity=active_capacity)
        .op(G.path_length_op, name="path_length", phase="post")
    ).build()


def _jax_run(tsim, impl, active_capacity):
    built = _jax_neurite(tsim, impl, active_capacity)
    final, obs = built.run_jit(STEPS)
    return built.state, final, {k: to_np(v) for k, v in obs.items()}


def _leaves(final, obs):
    pool = final.pool
    out = {f"obs/{k}": to_np(v) for k, v in obs.items()}
    out.update({f: to_np(getattr(pool, f)) for f in ("alive", "kind", "static", "overflow")})
    out.update({f: to_np(pool.position if f == "position" else pool.get(f)) for f in FLOATS})
    return out


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if k in FLOATS or k == "obs/position":
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _bits(tree) -> dict:
    return {k: v.tobytes() for k, v in tree.items()}


def test_neurite_smoke_run_jit_equals_run_and_the_reference():
    """(a) The port's run_jit against its run, bit for bit, and against
    the reference's run_jit."""
    jstate, jfinal, jobs = _jax_run(U.neurite(N), "reference", 2048)
    built = _observed(U.neurite(N)).build()
    start = convert.state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    eager = _leaves(*built.run(STEPS, state=start))
    jit = _leaves(*built.run_jit(STEPS, state=start))
    assert _bits(jit) == _bits(eager)
    _assert_close(jit, _leaves(jfinal, jobs))
    stats = built._jitted.stats
    assert stats["replays"] >= STEPS - stats["eager_steps"] and not stats["rollbacks"]
    assert int(jobs["alive"][-1].sum()) > N and eager["path_len"].max() > 0


def test_fused_compaction_matches_the_reference(monkeypatch):
    """(b) impl="fused" with compaction against the reference's fused impl:
    the fused kernel runs only in the steps whose active set outgrows the
    capacity."""
    from repro_torch.kernels.cell_force import ops as cf_ops

    calls = []
    list_force = cf_ops.cell_list_force
    monkeypatch.setattr(cf_ops, "cell_list_force",
                        lambda *a, **kw: calls.append(1) or list_force(*a, **kw))
    model = dict(space=40.0, plate=(8.0, 32.0), cue_top=120.0, active_capacity=26)
    jstate, jfinal, jobs = _jax_run(U.neurite(N, **model), "fused", 26)
    built = _observed(U.neurite(N, impl="fused", rank_impl="cuda", **model)).build()
    assert built.config.spec.dims == (10, 10, 10)
    start = convert.state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    _assert_close(_leaves(*built.run(STEPS, state=start)), _leaves(jfinal, jobs))
    assert 0 < len(calls) < STEPS


def _example_start(n, space, seed=0):
    """examples/neurite_growth.py's somata and cue, as its ``main`` makes them."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, space - 20, (n, 2))
    pos = np.concatenate([xy, np.full((n, 1), 10.0)], axis=1).astype(np.float32)
    res = 24
    zs = (np.arange(res) + 0.5) * (space / res)
    conc = np.exp(-((zs - space) ** 2) / (2 * 40.0**2))
    return pos, np.broadcast_to(conc[None, None, :], (res, res, res)).astype(np.float32)


def test_builder_defaults_are_the_example_and_the_cue_scales():
    """(c) The defaults give the example's start leaf for leaf; a 640 µm
    space with its cue peak at 120 µm has the example's cue below it."""
    pos, cue = _example_start(8, 120.0)
    default = U.neurite(8).build()
    spelled = U.neurite(8, plate=(20.0, 100.0), cue_top=120.0, capacity=8192,
                        active_capacity=2048, impl="reference", rank_impl="tiled").build()
    # The behaviour is a closure made anew by each call: every other field.
    same = lambda cfg: dataclasses.replace(cfg, behaviors=())
    assert same(default.config) == same(spelled.config)
    a, b = convert.state_to_numpy(default.state), convert.state_to_numpy(spelled.state)
    flat = lambda t, p="": ({p: t} if not isinstance(t, dict) else
                            {k: v for n, s in t.items() for k, v in flat(s, f"{p}/{n}").items()})
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)
    pool = default.state.pool
    np.testing.assert_array_equal(to_np(pool.position)[:8], pos)
    np.testing.assert_array_equal(to_np(default.state.grids["guide"].concentration), cue)
    cfg = default.config
    assert (cfg.spec.dims, cfg.spec.max_per_cell, pool.capacity) == ((30, 30, 30), 128, 8192)
    assert cfg.active_capacity == 2048 and cfg.force_impl == "reference"

    big = U.neurite(900, space=640.0, plate=(20.0, 620.0), cue_top=120.0)
    guide = big._grids["guide"]
    assert guide.concentration.shape == (128, 128, 128) and guide.spacing == 5.0
    np.testing.assert_array_equal(to_np(guide.concentration)[:, :, :24][:24, :24], cue)
    xy = to_np(big._groups[0].position)[:, :2]
    assert xy.min() >= 20.0 and xy.max() <= 620.0 and xy.max() > 500.0
    small = U.neurite(8)._grids["guide"]
    z = torch.linspace(10.0, 110.0, 41)
    probe = lambda g, x: gradient_at(g, torch.stack([torch.full_like(z, x), torch.full_like(z, x),
                                                     z], dim=-1), normalized=True)
    np.testing.assert_array_equal(to_np(probe(small, 60.0)), to_np(probe(guide, 300.0)))
