"""The slot axis of the engine's primitives, on their plain versions (CPU).

Each batched primitive over B sessions — the flat view of ``core/slots.py``
— against the same primitive run on each session alone: slot b's result
must equal the solo result bit for bit.  The sessions differ (their own
seeds), and the cases include a session whose positions are NaN and one
with no live agent, which must leave the other sessions untouched.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import grid, prng
from repro_torch.core.agents import add_agents
from repro_torch.core.diffusion import (
    concentration_at,
    diffuse,
    gradient_at,
    increase_concentration,
    make_grid,
)
from repro_torch.core import forces
from repro_torch.core.forces import ForceParams, update_static_flags_celllist
from repro_torch.kernels.cell_force import ops as cf_ops
from repro_torch.kernels.cell_rank import ops as cr_ops
from repro_torch.kernels.diffusion3d import ops as d3_ops
from repro_torch.kernels.pairwise_force import ops as pf_ops
from torch_force_cases import (MIXED_BLOCK, MIXED_SPEC, fused_call_counts, mixed_gate_pools,
                               slot_pools)

torch.set_num_threads(1)

B, C, SPACE = 4, 96, 40.0
SPEC = grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=5.0, dims=(8, 8, 8), max_per_cell=6,
                     rank_impl="cuda")


def _pools(nan_slot=None, empty_slot=None):
    """B solo pools (different seeds, some dead rows) and their flat view."""
    return slot_pools(B, C, SPEC, SPACE, nan_slot=nan_slot, empty_slot=empty_slot)


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.numpy().tobytes() == b.numpy().tobytes(), what


def _rows(x, b):
    return x.reshape((B, -1) + tuple(x.shape[1:]))[b]


CASES = [dict(), dict(nan_slot=1), dict(empty_slot=2), dict(nan_slot=3, empty_slot=0)]
IDS = ["plain", "nan_slot", "empty_slot", "both"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_build_and_sort_are_per_session(case):
    pools, flat = _pools(**case)
    assert flat.slots == B
    index = grid.build_index(SPEC, flat)
    assert index.slots == B and tuple(index.cell_list.shape) == (B, SPEC.n_cells, 6)
    sorted_flat = grid.sort_agents(SPEC, flat)
    sorted_index = grid.build_index(SPEC, sorted_flat, assume_sorted=True)
    for b, pool in enumerate(pools):
        solo = grid.build_index(SPEC, pool)
        for f in ("cell_list", "cell_count", "overflowed"):
            _same(getattr(index, f)[b], getattr(solo, f), (b, f))
        _same(_rows(index.cell_of_agent, b), solo.cell_of_agent, (b, "cell_of_agent"))
        spool = grid.sort_agents(SPEC, pool)
        for f in ("position", "kind", "alive"):
            _same(_rows(getattr(sorted_flat, f), b), getattr(spool, f), (b, "sorted", f))
        ssolo = grid.build_index(SPEC, spool, assume_sorted=True)
        _same(sorted_index.cell_list[b], ssolo.cell_list, (b, "sorted cell_list"))


def test_cell_list_rows_fill_their_first_slots_in_every_session():
    """The cell_list_force kernel stops at a row's first sentinel: each
    session's rows hold agents in slots 0..min(count, M)-1 and nothing else."""
    _, flat = _pools(nan_slot=1, empty_slot=2)
    index = grid.build_index(SPEC, flat)
    filled = index.cell_list < C
    m = SPEC.max_per_cell
    want = torch.arange(m) < torch.clamp(index.cell_count, max=m)[..., None]
    assert torch.equal(filled, want)
    assert bool(index.overflowed[1]) and not bool(index.overflowed[2])


def test_sort_past_the_table_limit_sorts_each_session():
    """Grids past ``MAX_TABLE_CELLS`` sort by a stable argsort of Morton
    keys offset per session."""
    spec = dataclasses.replace(SPEC, box_size=0.25, dims=(160, 160, 160))
    assert spec.n_cells > grid.morton.MAX_TABLE_CELLS
    pools, flat = _pools(nan_slot=1, empty_slot=2)
    out = grid.sort_agents(spec, flat)
    for b, pool in enumerate(pools):
        solo = grid.sort_agents(spec, pool)
        for f in ("position", "alive", "kind"):
            _same(_rows(getattr(out, f), b), getattr(solo, f), (b, f))


def test_cell_rank_over_session_offset_keys_equals_each_session():
    pools, flat = _pools(nan_slot=1, empty_slot=2)
    cid = grid._live_cell_ids(SPEC, flat.position, flat.alive)
    keys = grid._slot_keys(cid, B, SPEC.n_cells + 1)
    n_all = B * (SPEC.n_cells + 1) - 1
    for impl in ("tiled", "cuda", "reference"):
        ranks = cr_ops.cell_rank(keys, n_all, impl=impl)
        for b in range(B):
            _same(_rows(ranks, b), cr_ops.cell_rank(_rows(cid, b).contiguous(),
                                                    SPEC.n_cells, impl=impl), (impl, b))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_force_kernels_plain_versions_are_per_session(case):
    pools, flat = _pools(**case)
    index = grid.build_index(SPEC, flat)
    cand, mask = grid.candidate_neighbors_arrays(SPEC, index, flat.position, flat.alive)
    assert int(cand.max()) <= B * C
    radius = flat.radius()
    fused = cf_ops.cell_list_force(flat.position, radius, index.cell_list, SPEC.dims,
                                   impl="cuda", num_out=C)
    dense = pf_ops.pairwise_force(flat.position, radius, cand, mask, impl="cuda")
    window = cf_ops.cell_window_force(flat.position, radius, index.cell_of_agent, SPEC.dims,
                                      block=16, window=2, impl="cuda", slots=B)
    for b, pool in enumerate(pools):
        solo = grid.build_index(SPEC, pool)
        scand, smask = grid.candidate_neighbors_arrays(SPEC, solo, pool.position, pool.alive)
        _same(_rows(mask, b), smask, (b, "mask"))
        _same(torch.where(_rows(mask, b), _rows(cand, b) - b * C, scand), scand, (b, "cand"))
        _same(_rows(fused, b), cf_ops.cell_list_force(
            pool.position, pool.radius(), solo.cell_list, SPEC.dims, impl="cuda"),
            (b, "cell_list_force"))
        _same(_rows(dense, b), pf_ops.pairwise_force(
            pool.position, pool.radius(), scand, smask, impl="cuda"), (b, "pairwise_force"))
        _same(_rows(window, b), cf_ops.cell_window_force(
            pool.position, pool.radius(), solo.cell_of_agent, SPEC.dims, block=16, window=2,
            impl="cuda"), (b, "cell_window_force"))
    # A NaN agent adds no force to any pair (as in the kernels), so even the
    # NaN session's forces are finite.
    for out in (fused, dense, window):
        assert bool(torch.isfinite(out).all())


def test_morton_gate_is_per_session():
    """The window each row needs, the coverage gate and the covering
    half-window over a batch's flat view: each session's own, from rows
    and blocks counted within it (a sorted, a shuffled, an empty session)."""
    pools, flat, window = mixed_gate_pools()
    index = grid.build_index(MIXED_SPEC, flat)
    need = forces._window_need(MIXED_SPEC, index, MIXED_BLOCK)
    covers = []
    for b, pool in enumerate(pools):
        solo = grid.build_index(MIXED_SPEC, pool)
        _same(need.reshape(3, -1)[b], forces._window_need(MIXED_SPEC, solo, MIXED_BLOCK), b)
        covers.append(forces.covering_half_window(MIXED_SPEC, solo, MIXED_BLOCK))
        for w in (window - 1, window, None):
            assert bool(forces._morton_window_ok(MIXED_SPEC, index, MIXED_BLOCK, w)[b]) == \
                bool(forces._morton_window_ok(MIXED_SPEC, solo, MIXED_BLOCK, w)), (b, w)
    gate = forces._morton_window_ok(MIXED_SPEC, index, MIXED_BLOCK, window)
    assert gate.tolist() == [True, False, True]
    assert covers == [window, covers[1], 0] and covers[1] > window
    assert forces.covering_half_window(MIXED_SPEC, index, MIXED_BLOCK) == covers[1]


def test_mixed_morton_gates_over_one_flat_view_equal_each_solo_call(monkeypatch):
    """Over one flat view, the sorted session takes the window kernel and the
    shuffled one the linear kernel (the empty one either): each kernel is
    called once for all three sessions, and each session's forces equal its
    solo call's bit for bit."""
    pools, flat, window = mixed_gate_pools()
    params = ForceParams()
    kw = dict(impl="fused", tile_order="morton", morton_block=MIXED_BLOCK,
              morton_window=window)
    calls = fused_call_counts(monkeypatch)
    got = forces.mechanical_forces(MIXED_SPEC, grid.build_index(MIXED_SPEC, flat), flat,
                                   params, **kw)
    assert calls == {"window": 1, "linear": 1}
    took = []
    for b, pool in enumerate(pools):
        before = dict(calls)
        solo = forces.mechanical_forces(MIXED_SPEC, grid.build_index(MIXED_SPEC, pool), pool,
                                        params, **kw)
        took.append("window" if calls["window"] > before["window"] else "linear")
        _same(_rows3(got, b), solo, b)
    assert took == ["window", "linear", "window"]
    assert float(got.abs().max()) > 0.1 and not bool(_rows3(got, 2).any())
    # Sessions that are not live do not count: with only the sorted one live,
    # the window kernel alone runs.
    calls.update(window=0, linear=0)
    forces.mechanical_forces(MIXED_SPEC, grid.build_index(MIXED_SPEC, flat), flat, params,
                             live=[True, False, False], **kw)
    assert calls == {"window": 1, "linear": 0}


def _rows3(x, b):
    return x.reshape((3, -1) + tuple(x.shape[1:]))[b]


def test_dense_force_over_chunks_of_queries_equals_one_call():
    """Queries a chunk at a time against all the sources, as the card tests
    and chip_smoke call it: session 0 (the first chunk) holds NaN agents,
    which no later chunk may read through a masked-out slot."""
    pools, flat = _pools(nan_slot=0)
    index = grid.build_index(SPEC, flat)
    cand, mask = grid.candidate_neighbors_arrays(SPEC, index, flat.position, flat.alive)
    radius = flat.radius()
    whole = pf_ops.pairwise_force(flat.position, radius, cand, mask, impl="cuda")
    for i in range(0, B * C, C):
        part = pf_ops.pairwise_force(flat.position[i:i + C], radius[i:i + C], cand[i:i + C],
                                     mask[i:i + C], impl="cuda", all_position=flat.position,
                                     all_radius=radius)
        _same(part, whole[i:i + C], i)
        if i:
            assert bool(torch.isfinite(part).all()), i


def test_static_flags_are_per_session():
    pools, flat = _pools(nan_slot=1)
    index = grid.build_index(SPEC, flat)
    rng = np.random.default_rng(9)
    disp = torch.from_numpy(rng.normal(scale=1e-3, size=(B * C, 3)).astype(np.float32))
    disp[::5] = 0.0
    out = update_static_flags_celllist(SPEC, index, flat, disp, ForceParams(1.0, 1.0, 1e-3))
    for b, pool in enumerate(pools):
        solo = update_static_flags_celllist(SPEC, grid.build_index(SPEC, pool), pool,
                                            _rows(disp, b), ForceParams(1.0, 1.0, 1e-3))
        _same(_rows(out.static, b), solo.static, b)


def test_stencil_over_a_slot_axis_equals_each_field():
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.uniform(0, 5, (B, 9, 7, 12)).astype(np.float32))
    u[1] = float("nan")
    u[2] = 0.0
    for impl in ("cuda", "reference"):
        out = d3_ops.diffusion_step(u, 0.1, 0.002, impl=impl)
        for b in range(B):
            _same(out[b], d3_ops.diffusion_step(u[b], 0.1, 0.002, impl=impl), (impl, b))
    g = make_grid(0.0, SPACE, 8, 4.0, 0.01)
    gb = dataclasses.replace(g, concentration=u[:, :8, :7, :8].contiguous())
    assert gb.slots == B and gb.resolution == (8, 7, 8)
    for impl in ("cuda", "reference"):
        out = diffuse(gb, 1.0, impl=impl).concentration
        for b in range(B):
            solo = dataclasses.replace(g, concentration=gb.concentration[b].contiguous())
            _same(out[b], diffuse(solo, 1.0, impl=impl).concentration, (impl, b))


def test_agent_coupling_to_fields_is_per_session():
    pools, flat = _pools(nan_slot=1, empty_slot=2)
    rng = np.random.default_rng(4)
    conc = torch.from_numpy(rng.uniform(0, 3, (B, 8, 8, 8)).astype(np.float32))
    g = dataclasses.replace(make_grid(0.0, SPACE, 8, 4.0), concentration=conc)
    mask = flat.alive & (flat.kind == 1)
    sec = increase_concentration(g, flat.position, 0.5, mask=mask).concentration
    at = concentration_at(g, flat.position)
    grad = gradient_at(g, flat.position)
    for b, pool in enumerate(pools):
        solo = dataclasses.replace(g, concentration=conc[b])
        m = pool.alive & (pool.kind == 1)
        _same(sec[b], increase_concentration(solo, pool.position, 0.5, mask=m).concentration,
              (b, "secretion"))
        _same(_rows(at, b), concentration_at(solo, pool.position), (b, "concentration_at"))
        _same(_rows(grad, b), gradient_at(solo, pool.position), (b, "gradient_at"))


def test_key_batch_draws_equal_each_solo_draw():
    keys = prng.fold_in(prng.PRNGKey(7), torch.arange(B, dtype=torch.int32))
    assert tuple(keys.shape) == (B, 2)
    split = prng.split(keys)
    assert tuple(split.shape) == (2, B, 2)
    bits = prng.random_bits(keys, (B * 5, 3))
    uni = prng.uniform(keys, (B * 7,), -1.0, 1.0)
    nor = prng.normal(keys, (B * 6, 3))
    for b in range(B):
        _same(keys[b], prng.fold_in(prng.PRNGKey(7), b), (b, "fold_in"))
        _same(split[:, b], prng.split(keys[b]), (b, "split"))
        _same(_rows(bits, b), prng.random_bits(keys[b], (5, 3)), (b, "bits"))
        _same(_rows(uni, b), prng.uniform(keys[b], (7,), -1.0, 1.0), (b, "uniform"))
        _same(_rows(nor, b), prng.normal(keys[b], (6, 3)), (b, "normal"))
    with pytest.raises(ValueError, match="do not split"):
        prng.random_bits(keys, (B * 5 + 1,))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_births_land_in_each_sessions_own_free_rows(case):
    pools, flat = _pools(**case)
    keys = prng.fold_in(prng.PRNGKey(1), torch.arange(B, dtype=torch.int32))
    spawn = prng.uniform(keys, (B * C,)) < 0.4
    child = flat.position + 1.0
    out = add_agents(flat, spawn, child, flat.diameter * 0.5, flat.kind)
    assert tuple(out.overflow.shape) == (B,)
    for b, pool in enumerate(pools):
        solo = add_agents(pool, _rows(spawn, b), _rows(child, b), pool.diameter * 0.5,
                          pool.kind)
        for f in ("position", "diameter", "kind", "alive", "static", "age"):
            _same(_rows(getattr(out, f), b), getattr(solo, f), (b, f))
        _same(_rows(out.attrs["w"], b), solo.attrs["w"], (b, "attr"))
        _same(out.overflow[b], solo.overflow, (b, "overflow"))
    assert int(out.overflow.sum()) > 0           # the fuller sessions ran out of rows
