"""Contact forces: the port vs the JAX reference.

Forces agree to ``atol=1e-5`` — the port sums pairs in another order, and
the reference holds its own Pallas kernel to its plain version at the same
tolerance (tests/test_cell_force.py:56).  Static flags and the Morton
coverage gate are exact, and a failed gate gives the linear fused result
bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agents as j_agents
from repro.core import forces as j_forces
from repro.core import grid as j_grid
from repro.kernels.cell_force import ops as j_cf
from repro.kernels.pairwise_force import ops as j_pf
from repro_torch.core import agents as t_agents
from repro_torch.core import forces as t_forces
from repro_torch.core import grid as t_grid
from repro_torch.kernels.cell_force import ops as t_cf
from repro_torch.kernels.cell_force.ref import window_sweep_mask, window_walk, window_walk_pairs
from repro_torch.kernels.pairwise_force import kernel as t_pf_kernel
from repro_torch.kernels.pairwise_force import ops as t_pf
from torch_force_cases import WINDOW_CASES as CARD_WINDOW_CASES
from torch_force_cases import dense_inputs
from torch_force_cases import window_inputs as card_window_inputs
from torch_parity import CPU, to_np

ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(case):
    """Both packages' (spec, pool, index) of one named case (built once)."""
    return _build_setup(**{**KERNEL_CASES, **MECH_CASES}[case])


def _build_setup(n, cap, extent, box, m, dead_frac=0.2, seed=0, clump=0, static_frac=0.0):
    """(spec, pool, index) of both packages over one random pool.  ``extent``
    is the per-axis space size (non-cubic grids allowed)."""
    rng = np.random.default_rng(seed)
    extent = np.broadcast_to(np.asarray(extent, np.float32), (3,))
    pos = (rng.uniform(0, 1, (n, 3)) * extent).astype(np.float32)
    if clump:
        pos[:clump] = (box * 1.2 + rng.uniform(0, box * 0.6, (clump, 3))).astype(np.float32)
    diam = rng.uniform(1.0, 6.0, n).astype(np.float32)
    alive = np.ones(cap, bool)
    alive[n:] = False
    alive[rng.choice(n, int(n * dead_frac), replace=False)] = False
    static = (rng.random(cap) < static_frac) & alive
    dims = tuple(int(e // box) for e in extent)
    common = dict(origin=(0.0, 0.0, 0.0), box_size=box, dims=dims, max_per_cell=m)
    jspec, tspec = j_grid.GridSpec(**common), t_grid.GridSpec(**common)
    jpool = j_agents.make_pool(cap, jnp.asarray(pos), diameter=jnp.asarray(diam))
    jpool = jpool.replace(alive=jnp.asarray(alive), static=jnp.asarray(static))
    tpool = t_agents.make_pool(cap, pos, diameter=diam, device=CPU)
    tpool = tpool.replace(alive=torch.from_numpy(alive), static=torch.from_numpy(static))
    return (jspec, jpool, j_grid.build_index(jspec, jpool),
            tspec, tpool, t_grid.build_index(tspec, tpool))


# Coarse grids: interpret-mode Pallas time grows with the (x, y) column count.
KERNEL_CASES = {
    "generic": dict(n=60, cap=80, extent=20.0, box=5.0, m=16),
    "boundary_2x2x2": dict(n=30, cap=64, extent=12.0, box=6.0, m=32),
    "noncubic_8x1x4": dict(n=50, cap=64, extent=(16.0, 2.0, 8.0), box=2.0, m=16),
    "near_empty": dict(n=5, cap=8, extent=10.0, box=5.0, m=4),
    "overflowed": dict(n=60, cap=64, extent=20.0, box=5.0, m=4, clump=12),
}


@functools.lru_cache(maxsize=None)
def _jax_kernel_force(case):
    jspec, jpool, jidx, *_ = _setup(case)
    assert bool(jidx.overflowed) == (case == "overflowed")
    return to_np(j_cf.cell_list_force(jpool.position, jpool.radius(), jidx.cell_list,
                                      jspec.dims, impl="pallas"))


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_cell_list_force_matches_jax_kernel(case, impl):
    *_, tspec, tpool, tidx = _setup(case)
    want = _jax_kernel_force(case)
    got = t_cf.cell_list_force(tpool.position, tpool.radius(), tidx.cell_list,
                               tspec.dims, impl=impl)
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)
    if case != "near_empty":
        assert np.abs(want).max() > 0.1           # some pairs really overlap


def test_cell_list_force_num_out_and_cell_ranges():
    jspec, jpool, jidx, tspec, tpool, tidx = _setup("generic")
    full = t_cf.cell_list_force(tpool.position, tpool.radius(), tidx.cell_list,
                                tspec.dims, impl="reference")
    part = t_cf.cell_list_force(tpool.position, tpool.radius(), tidx.cell_list,
                                tspec.dims, impl="reference", num_out=30)
    np.testing.assert_array_equal(to_np(part), to_np(full)[:30])
    want = j_cf.cell_list_force(jpool.position, jpool.radius(), jidx.cell_list,
                                jspec.dims, impl="reference", num_out=30)
    np.testing.assert_allclose(to_np(part), to_np(want), atol=ATOL)
    # Evaluating the query cells in pieces adds up to the whole.
    from repro_torch.kernels.cell_force.ref import cell_list_force_ref

    n_cells = tspec.n_cells
    pieces = sum(
        cell_list_force_ref(tpool.position, tpool.radius(), tidx.cell_list, tspec.dims,
                            cells=(lo, min(lo + 7, n_cells)))
        for lo in range(0, n_cells, 7)
    )
    np.testing.assert_array_equal(to_np(pieces), to_np(full))


@pytest.mark.parametrize("case", ["generic", "overflowed", "noncubic_8x1x4"])
def test_cell_list_rows_are_filled_from_slot_zero(case):
    """The CUDA kernel stops a row walk at its first sentinel: the build must
    fill slots 0..min(count, M)-1 of every row and nothing else."""
    *_, tspec, tpool, tidx = _setup(case)
    occupied = to_np(tidx.cell_list) < tpool.capacity
    filled = np.minimum(to_np(tidx.cell_count), tspec.max_per_cell)
    np.testing.assert_array_equal(occupied.sum(1), filled)
    np.testing.assert_array_equal(
        occupied, np.arange(tspec.max_per_cell)[None, :] < filled[:, None])


MECH_CASES = {
    "m_plain": dict(n=60, cap=80, extent=20.0, box=5.0, m=16, static_frac=0.3),
    "m_overflowed": dict(n=60, cap=64, extent=20.0, box=5.0, m=4, clump=12,
                         static_frac=0.3),
}


@functools.lru_cache(maxsize=None)
def _jax_mechanical(case, impl, active_capacity, masked=False):
    jspec, jpool, jidx, *_ = _setup(case)
    rmask = jnp.asarray(_row_mask(jpool.capacity)) if masked else None
    return to_np(j_forces.mechanical_forces(
        jspec, jidx, jpool, j_forces.ForceParams(), active_capacity=active_capacity,
        impl=impl, row_mask=rmask))


def _row_mask(c):
    return np.arange(c) % 3 != 0


# active_capacity: None (no compaction), 16 (more active agents than that:
# the full evaluation), 80 (the compacted path).
@pytest.mark.parametrize("case", ["plain", "overflowed"])
@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("active_capacity", [None, 16, 80])
@pytest.mark.parametrize("masked", [False, True])
def test_mechanical_forces_match_jax(case, impl, active_capacity, masked):
    *_, tspec, tpool, tidx = _setup("m_" + case)
    want = _jax_mechanical("m_" + case, impl, active_capacity)
    rmask = None
    if masked:
        # row_mask is output masking only (the reference's contract).
        rmask = _row_mask(tpool.capacity)
        want = np.where(rmask[:, None], want, 0.0)
        rmask = torch.from_numpy(rmask)
    got = t_forces.mechanical_forces(tspec, tidx, tpool, t_forces.ForceParams(),
                                     active_capacity=active_capacity, impl=impl,
                                     row_mask=rmask)
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)


def test_row_mask_matches_jax_row_mask():
    *_, tspec, tpool, tidx = _setup("m_overflowed")
    want = _jax_mechanical("m_overflowed", "fused", 80, masked=True)
    got = t_forces.mechanical_forces(
        tspec, tidx, tpool, t_forces.ForceParams(), active_capacity=80, impl="fused",
        row_mask=torch.from_numpy(_row_mask(tpool.capacity)))
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)


def test_fused_without_fallback_drops_overflowed_agents():
    """``fused_fallback=False`` on an overflowed grid runs the kernel alone,
    like the reference: agents cut from the cell list get no force."""
    jspec, jpool, jidx, tspec, tpool, tidx = _setup("m_overflowed")
    want = j_forces.mechanical_forces(jspec, jidx, jpool, j_forces.ForceParams(),
                                      impl="fused", fused_fallback=False)
    got = t_forces.mechanical_forces(tspec, tidx, tpool, t_forces.ForceParams(),
                                     impl="fused", fused_fallback=False)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)


def test_dense_helpers_match_jax():
    rng = np.random.default_rng(3)
    dx = rng.normal(0, 2, (40, 7, 3)).astype(np.float32)
    r1 = rng.uniform(1, 3, (40, 1)).astype(np.float32)
    r2 = rng.uniform(1, 3, (40, 7)).astype(np.float32)
    jp, tp = j_forces.ForceParams(), t_forces.ForceParams()
    want = j_forces.pair_force(jnp.asarray(dx), jnp.asarray(r1), jnp.asarray(r2), jp)
    got = t_forces.pair_force(*map(torch.from_numpy, (dx, r1, r2)), tp)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-6)
    f = rng.normal(size=(9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_np(t_forces._tree_sum(torch.from_numpy(f))),
                                  to_np(j_forces._tree_sum(jnp.asarray(f))))
    jspec, jpool, jidx, tspec, tpool, tidx = _setup("m_plain")
    jc, jm = j_grid.candidate_neighbors(jspec, jidx, jpool)
    tc, tm = t_grid.candidate_neighbors(tspec, tidx, tpool)
    want = j_forces.forces_from_candidates_tiled(
        jpool.position, jpool.radius(), jc, jm, jp, jpool.position, jpool.radius(), tile=32)
    got = t_forces.forces_from_candidates_tiled(
        tpool.position, tpool.radius(), tc, tm, tp, tpool.position, tpool.radius(), tile=32)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "overflowed"])
def test_static_flags_match_jax(case):
    jspec, jpool, jidx, tspec, tpool, tidx = _setup("m_" + case)
    rng = np.random.default_rng(11)
    disp = rng.normal(0, 1e-4, (jpool.capacity, 3)).astype(np.float32)
    disp[rng.random(jpool.capacity) < 0.7] = 0.0
    params = (j_forces.ForceParams(), t_forces.ForceParams())
    want = j_forces.update_static_flags_celllist(jspec, jidx, jpool, jnp.asarray(disp),
                                                 params[0])
    got = t_forces.update_static_flags_celllist(tspec, tidx, tpool, torch.from_numpy(disp),
                                                params[1])
    np.testing.assert_array_equal(to_np(got.static), to_np(want.static))
    assert 0 < to_np(got.static).sum() < to_np(got.alive).sum()
    jc, jm = j_grid.candidate_neighbors(jspec, jidx, jpool)
    tc, tm = t_grid.candidate_neighbors(tspec, tidx, tpool)
    want = j_forces.update_static_flags(jpool, jnp.asarray(disp), jc, jm, params[0])
    got = t_forces.update_static_flags(tpool, torch.from_numpy(disp), tc, tm, params[1])
    np.testing.assert_array_equal(to_np(got.static), to_np(want.static))


# --------------------------------------------------- Morton window (sorted)

@functools.lru_cache(maxsize=None)
def _sorted_setup(case):
    """``case``'s pool in both packages after the layout sort, with the grid
    rebuilt over the sorted pool (as env_build does at sort_frequency=1)."""
    jspec, jpool, _, tspec, tpool, _ = _setup(case)
    jpool, tpool = j_grid.sort_agents(jspec, jpool), t_grid.sort_agents(tspec, tpool)
    np.testing.assert_array_equal(to_np(tpool.position), to_np(jpool.position))
    return (jspec, jpool, j_grid.build_index(jspec, jpool),
            tspec, tpool, t_grid.build_index(tspec, tpool, assume_sorted=True))


# (case, sorted, block, window): an all-pairs window over an unsorted pool
# (exact for any layout), narrow windows over the sorted pool, one of them
# clipped at both ends of the pool, and a narrow one over the unsorted pool.
WINDOW_CASES = {
    "allpairs_unsorted": ("generic", False, 16, 5),
    "sorted_narrow": ("generic", True, 16, 2),
    "sorted_clipped_both_ends": ("noncubic_8x1x4", True, 32, 1),
    "unsorted_narrow": ("generic", False, 16, 1),
}


@functools.lru_cache(maxsize=None)
def _jax_window_force(name):
    case, is_sorted, block, window = WINDOW_CASES[name]
    jspec, jpool, jidx, *_ = (_sorted_setup if is_sorted else _setup)(case)
    return to_np(j_cf.cell_window_force(jpool.position, jpool.radius(), jidx.cell_of_agent,
                                        jspec.dims, block=block, window=window))


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_cell_window_force_matches_jax_kernel(name, impl):
    case, is_sorted, block, window = WINDOW_CASES[name]
    *_, tspec, tpool, tidx = (_sorted_setup if is_sorted else _setup)(case)
    want = _jax_window_force(name)
    got = t_cf.cell_window_force(tpool.position, tpool.radius(), tidx.cell_of_agent,
                                 tspec.dims, block=block, window=window, impl=impl)
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)
    assert np.abs(want).max() > 0.1
    if name == "allpairs_unsorted":
        # All pairs: the 27-box sum, the same function as the cell-list kernel.
        linear = t_cf.cell_list_force(tpool.position, tpool.radius(), tidx.cell_list,
                                      tspec.dims, impl="reference")
        np.testing.assert_allclose(to_np(got), to_np(linear), atol=ATOL)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_cell_window_force_rejects_negative_cell_ids(impl):
    """A negative cell id raises ``ValueError`` on either path (the card
    kernel would take the agent as dead, the reference decodes the id into
    cells beside x = 0).  In-domain ids give the same forces as before, with
    the check made here or left to a caller (``ids_checked``)."""
    *_, tspec, tpool, tidx = _sorted_setup("generic")
    args = (tpool.position, tpool.radius())
    kw = dict(block=16, window=2, impl=impl)
    cid = tidx.cell_of_agent
    got = t_cf.cell_window_force(*args, cid, tspec.dims, **kw)
    np.testing.assert_allclose(to_np(got), _jax_window_force("sorted_narrow"), atol=ATOL)
    np.testing.assert_array_equal(
        to_np(t_cf.cell_window_force(*args, cid, tspec.dims, ids_checked=True, **kw)),
        to_np(got))
    dead = int(torch.nonzero(cid >= tspec.n_cells)[0])
    for row, value in ((0, -1), (dead, -1), (cid.shape[0] - 1, -(2**31))):
        bad = cid.clone()
        bad[row] = value
        with pytest.raises(ValueError, match="negative"):
            t_cf.cell_window_force(*args, bad, tspec.dims, **kw)


def test_morton_dispatch_rejects_negative_cell_ids():
    """The engine's Morton path checks the ids in the read its coverage gate
    makes, and raises as ``cell_window_force`` does, covering window or not."""
    *_, tspec, tpool, tidx = _sorted_setup("generic")
    cover = t_forces.covering_half_window(tspec, tidx, 16)
    cid = tidx.cell_of_agent.clone()
    cid[3] = -1
    bad = dataclasses.replace(tidx, cell_of_agent=cid)
    for window in (cover, 0):
        with pytest.raises(ValueError, match="negative"):
            t_forces.mechanical_forces(tspec, bad, tpool, t_forces.ForceParams(),
                                       impl="fused", tile_order="morton",
                                       morton_block=16, morton_window=window)


# ------------------------------------ the window kernel's walk (on the CPU)

def _jax_window_pairs(cid, dims, block, window):
    """``(C, C)`` bool: the pair mask of the JAX package's
    ``_window_force_kernel`` (through ``cell_window_force``, Pallas in
    interpret mode), read off its output.

    With k = 1, gamma = 0 and every radius 2^15, a pair at distance d adds
    2^16 - d along the line between the two.  Every row sits at the origin
    except up to 48 probe rows, 16 on each axis at 2^16 - 2^b (b = 0..15):
    the force on any other row is then, on each axis, minus the sum of 2^b
    over the probes it pairs with, within 0.2 of an integer whose bits name
    them.  The probes run through the halves of the rows by each bit of the
    row index, 48 at a time, so every ordered pair (q, r) is read in a run
    where r is a probe and q is not."""
    c = cid.shape[0]
    rad = jnp.full((c,), 2.0**15, jnp.float32)
    force = jax.jit(lambda pos: j_cf.cell_window_force(
        pos, rad, jnp.asarray(cid), dims, k=1.0, gamma=0.0, block=block, window=window))
    rows = np.arange(c)
    pairs = np.zeros((c, c), bool)
    for bit in range(max(1, (c - 1).bit_length())):
        for half in (0, 1):
            side = rows[(rows >> bit) & 1 == half]
            for at in range(0, len(side), 48):
                probes = side[at:at + 48]
                pos = np.zeros((c, 3), np.float32)
                slot = np.arange(len(probes))
                pos[probes, slot // 16] = 2.0**16 - 2.0 ** (slot % 16)
                readers = np.setdiff1d(rows, probes)
                got = -np.asarray(force(jnp.asarray(pos)), np.float64)[readers]
                code = np.rint(got)
                assert np.abs(got - code).max() < 0.25
                code = code.astype(np.int64)
                for s, r in enumerate(probes):
                    pairs[readers, r] = (code[:, s // 16] >> (s % 16)) & 1 == 1
    return pairs


def _walk_case(name):
    """(cell ids, dims, block, half_window) of a window case of this file
    (``jax:``) or of the card tests (``card:``), at the window geometry the
    ops functions use."""
    where, case = name.split(":")
    if where == "jax":
        base, is_sorted, block, window = WINDOW_CASES[case]
        *_, tspec, _, tidx = (_sorted_setup if is_sorted else _setup)(base)
        cid, dims = tidx.cell_of_agent, tspec.dims
    else:
        _, _, index, spec, block, window = card_window_inputs(case)
        cid, dims = index.cell_of_agent, spec.dims
    block, window = t_cf.window_defaults(cid.shape[0], block, window)
    return cid.to(torch.int32), dims, block, window


@pytest.mark.parametrize("name", [f"jax:{n}" for n in sorted(WINDOW_CASES)]
                         + [f"card:{n}" for n in sorted(CARD_WINDOW_CASES)])
def test_window_walk_pairs_match_the_sweep_and_jax(name):
    """The rows ``cell_window_force.cu`` walks (each neighbour cell's first
    to last row, clipped to the window, merged) hold exactly the pairs of the
    window sweep: ``cell_window_force_ref``'s masks and the Pallas kernel's,
    for sorted and unsorted pools and narrow windows."""
    cid, dims, block, window = _walk_case(name)
    c = cid.shape[0]
    walk = to_np(window_walk_pairs(cid, dims, block, window))
    sweep = np.zeros((c, c), bool)
    for tile in range(-(-c // block)):
        q, w, pair = window_sweep_mask(cid, dims, block, window, tile)
        sweep[q, w] = to_np(pair)
    np.testing.assert_array_equal(walk, sweep)
    np.testing.assert_array_equal(walk, _jax_window_pairs(to_np(cid), dims, block, window))
    assert walk.any()
    # The walk's intervals are disjoint, ascending and inside the window.
    start, end = window_walk(cid, dims, block, window)
    assert bool((end >= start).all()) and bool((start[:, 1:] >= end[:, :-1]).all())
    tile = torch.arange(c) // block
    assert bool((start >= ((tile - window).clamp(min=0) * block)[:, None]).all())
    assert bool((end <= ((tile + window + 1) * block).clamp(max=c)[:, None]).all())


def test_window_defaults_match_jax():
    for c in (0, 1, 5, 100, 128, 129, 4096, 131072):
        for block, window in ((None, None), (32, None), (None, 3), (1000, 2)):
            assert t_cf.window_defaults(c, block, window) == \
                j_cf.window_defaults(c, block, window), (c, block, window)


@pytest.mark.parametrize("case", ["generic", "noncubic_8x1x4", "overflowed"])
@pytest.mark.parametrize("is_sorted", [False, True])
def test_morton_window_ok_matches_jax(case, is_sorted):
    jspec, _, jidx, tspec, _, tidx = (_sorted_setup if is_sorted else _setup)(case)
    cover = t_forces.covering_half_window(tspec, tidx, 16)
    verdicts = []
    for block, window in ((16, 0), (16, 1), (16, cover - 1), (16, cover), (None, None),
                          (8, 3), (64, 1)):
        want = bool(j_forces._morton_window_ok(jspec, jidx, block, window))
        assert bool(t_forces._morton_window_ok(tspec, tidx, block, window)) == want
        verdicts.append(want)
    assert verdicts[2:4] == [cover == 0, True]     # the least covering window


MORTON_CASES = {"sorted": "generic", "overflowed": "overflowed"}


@pytest.mark.parametrize("case", sorted(MORTON_CASES))
def test_morton_dispatch_matches_jax(case):
    """Covering window: the window kernel, against JAX's morton dispatch.
    Narrow window: the gate fails and the result is the linear fused one,
    bit for bit.  An overflowed grid takes the dense fallback in both."""
    jspec, jpool, jidx, tspec, tpool, tidx = _sorted_setup(MORTON_CASES[case])
    cover = t_forces.covering_half_window(tspec, tidx, 16)
    params = (j_forces.ForceParams(), t_forces.ForceParams())
    linear = t_forces.mechanical_forces(tspec, tidx, tpool, params[1], impl="fused")
    for window in (cover, max(cover - 1, 0)):
        want = j_forces.mechanical_forces(jspec, jidx, jpool, params[0], impl="fused",
                                          tile_order="morton", morton_block=16,
                                          morton_window=window)
        got = t_forces.mechanical_forces(tspec, tidx, tpool, params[1], impl="fused",
                                         tile_order="morton", morton_block=16,
                                         morton_window=window)
        np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL)
        window_ran = window == cover and case == "sorted"
        gate = bool(t_forces._morton_window_ok(tspec, tidx, 16, window)
                    & ~tidx.overflowed)
        assert gate == window_ran
        if not window_ran:
            np.testing.assert_array_equal(to_np(got), to_np(linear))
    assert cover > 1


# ------------------------------------------------- dense pairwise kernel

@pytest.mark.parametrize("case", ["m_plain", "m_overflowed"])
@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_pairwise_force_matches_jax_kernel(case, impl):
    jspec, jpool, jidx, tspec, tpool, tidx = _setup(case)
    jc, jm = j_grid.candidate_neighbors(jspec, jidx, jpool)
    tcand, tm = t_grid.candidate_neighbors(tspec, tidx, tpool)
    want = to_np(j_pf.pairwise_force(jpool.position, jpool.radius(), jc, jm, impl="pallas"))
    got = t_pf.pairwise_force(tpool.position, tpool.radius(), tcand, tm, impl=impl)
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)
    assert np.abs(want).max() > 0.1
    # Sources longer than the queries: the first 30 agents as queries.
    want = to_np(j_pf.pairwise_force(
        jpool.position[:30], jpool.radius()[:30], jc[:30], jm[:30], impl="pallas",
        all_position=jpool.position, all_radius=jpool.radius()))
    got = t_pf.pairwise_force(tpool.position[:30], tpool.radius()[:30], tcand[:30],
                              tm[:30], impl=impl, all_position=tpool.position,
                              all_radius=tpool.radius())
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)


# Hand-counted masks: (rows, 32-byte id sectors that hold a set slot); the
# int32 ids lie 8 to a sector in row-major order.
DESIGN_BYTE_CASES = {
    # Flat slots 0, 1, 7 (sector 0), 12 (sector 1) and 23 (sector 2).
    "three_sectors": ([[1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
                       [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]], 3),
    "empty": ([[0] * 12, [0] * 12], 0),
    # Every slot of one 20-slot row: sectors 0, 1 and the partial 2.
    "all_set_ragged": ([[1] * 20], 3),
    # Flat slots 4 (sector 0), 8 and 14 (sector 1): a sector across rows.
    "sector_across_rows": ([[0, 0, 0, 0, 1], [0, 0, 0, 1, 0], [0, 0, 0, 0, 1]], 2),
}


@pytest.mark.parametrize("case", sorted(DESIGN_BYTE_CASES))
def test_pairwise_force_design_bytes_hand_counted(case):
    rows, sectors = DESIGN_BYTE_CASES[case]
    mask = torch.tensor(rows, dtype=torch.bool)
    n, kdim = mask.shape
    # Mask bytes, id sectors, queries (16 B a row), output (12 B a row).
    assert t_pf_kernel.design_bytes(mask) == n * kdim + 32 * sectors + 28 * n


def test_pairwise_force_design_bytes_at_the_engine_layout():
    """At K = 27 x 96 each cell's slots fill from its first: about one id
    sector per (row, neighbour cell) that holds a candidate."""
    mask = dense_inputs("layout_27x96")[3]
    n, kdim = mask.shape
    flat = np.flatnonzero(mask.numpy().reshape(-1))
    sectors = np.unique(flat // 8).size
    assert t_pf_kernel.design_bytes(mask) == n * kdim + 32 * sectors + 28 * n
    cells = mask.reshape(n, 27, 96).any(-1).sum()
    assert cells <= sectors <= 2 * cells


@pytest.mark.parametrize("case", ["plain", "overflowed"])
@pytest.mark.parametrize("active_capacity", [None, 16, 80])
def test_mechanical_forces_cuda_matches_jax_pallas(case, active_capacity):
    *_, tspec, tpool, tidx = _setup("m_" + case)
    want = _jax_mechanical("m_" + case, "pallas", active_capacity)
    got = t_forces.mechanical_forces(tspec, tidx, tpool, t_forces.ForceParams(),
                                     active_capacity=active_capacity, impl="cuda")
    np.testing.assert_allclose(to_np(got), want, atol=ATOL)


# ------------------------------------------- non-finite sources (plain versions)

def _nan_corner_case():
    """4³ boxes of 5 µm: agent 0 with x = NaN (its cell clamps to 0), agents
    1 and 2 of radius 2 overlapping 1 µm apart in the far corner box (cell
    63), and 5 dead rows.  Eq 4.1 gives ∓(2·3 − √3) along x to 1 and 2."""
    pos = np.full((8, 3), 2.5, np.float32)
    pos[0, 0] = np.nan
    pos[1] = (17.0, 17.5, 17.5)
    pos[2] = (18.0, 17.5, 17.5)
    alive = np.arange(8) < 3
    spec = t_grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=5.0, dims=(4, 4, 4),
                           max_per_cell=4)
    pool = t_agents.make_pool(8, pos, diameter=4.0, device=CPU)
    pool = pool.replace(alive=torch.from_numpy(alive))
    return spec, pool, t_grid.build_index(spec, pool), pos, alive


NAN_CORNER_FORCE = 6.0 - np.sqrt(3.0)          # k·δ − γ·√(r̄·δ), δ = 3, r̄ = 1


def _plain_forces(spec, pool, index):
    """Every plain force version the engine reaches, on one pool: the two
    fused ones through their dispatchers (both impls), the dense one over
    the engine's candidates, and the engine's three force impls."""
    pos, rad, cid = pool.position, pool.radius(), index.cell_of_agent
    cand, mask = t_grid.candidate_neighbors_arrays(spec, index, pos, pool.alive)
    out = {}
    for impl in ("reference", "cuda"):
        out[f"cell_list_force[{impl}]"] = t_cf.cell_list_force(
            pos, rad, index.cell_list, spec.dims, impl=impl)
        out[f"cell_window_force[{impl}]"] = t_cf.cell_window_force(
            pos, rad, cid, spec.dims, block=2, window=8, impl=impl)
        out[f"pairwise_force[{impl}]"] = t_pf.pairwise_force(pos, rad, cand, mask, impl=impl)
    for impl, kw in (("reference", {}), ("fused", {}), ("cuda", {}),
                     ("fused", dict(tile_order="morton", morton_block=2, morton_window=8))):
        out[f"mechanical_forces[{impl}{'+morton' if kw else ''}]"] = \
            t_forces.mechanical_forces(spec, index, pool, t_forces.ForceParams(), impl=impl,
                                       **kw)
    return out


def test_plain_force_versions_add_nothing_from_a_nan_agent():
    """Row 0 NaN (the row the fault models NaN-bomb), read by every sentinel
    slot of the plain cell_list_force: agents 1 and 2 still get ∓4.2679,
    the NaN agent itself zero, as the kernels give."""
    spec, pool, index, _, _ = _nan_corner_case()
    assert int(index.cell_of_agent[0]) == 0 and int(index.cell_of_agent[1]) == 63
    want = np.zeros((8, 3), np.float32)
    want[1, 0], want[2, 0] = -NAN_CORNER_FORCE, NAN_CORNER_FORCE
    for name, got in _plain_forces(spec, pool, index).items():
        np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=0, err_msg=name)


def test_reference_propagates_nan_where_the_port_does_not():
    """The reference's fused kernel (and its oracle) multiplies a masked
    pair's zero scale by a NaN offset: on the NaN corner case its forces on
    agents 1 and 2 are NaN, the port's ∓4.2679 (ROADMAP §3, "Quirks")."""
    spec, pool, index, pos, alive = _nan_corner_case()
    jpool = j_agents.make_pool(8, jnp.asarray(pos), diameter=4.0).replace(
        alive=jnp.asarray(alive))
    jspec = j_grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=5.0, dims=(4, 4, 4),
                            max_per_cell=4)
    jidx = j_grid.build_index(jspec, jpool)
    np.testing.assert_array_equal(to_np(jidx.cell_list), to_np(index.cell_list))
    want = to_np(j_cf.cell_list_force(jpool.position, jpool.radius(), jidx.cell_list,
                                      jspec.dims))
    got = to_np(t_cf.cell_list_force(pool.position, pool.radius(), index.cell_list,
                                     spec.dims, impl="reference"))
    assert np.isnan(want[1:3, 0]).all()            # agent 0's x is the NaN
    np.testing.assert_array_equal(got[1:3, 1:], want[1:3, 1:])
    np.testing.assert_allclose(got[1:3, 0], [-NAN_CORNER_FORCE, NAN_CORNER_FORCE], rtol=1e-6)


@pytest.mark.parametrize("rows", [(0,), (0, 17), (17,)], ids=["row0", "row0_interior",
                                                                   "interior"])
def test_a_nan_agent_is_a_dead_one_to_the_plain_force_versions(rows):
    """NaN at row 0 and at an interior live row: every plain version gives
    finite forces, equal (to the parity tolerance: the cell lists and
    candidate rows differ by the NaN agents' slots) to the same pool with
    those agents dead, and zero on the NaN rows."""
    _, _, _, tspec, tpool, _ = _setup("generic")
    assert all(bool(tpool.alive[r]) for r in rows)
    pos = tpool.position.clone()
    pos[list(rows), 0] = float("nan")
    sick = tpool.replace(position=pos)
    dead_mask = tpool.alive.clone()
    dead_mask[list(rows)] = False
    dead = tpool.replace(position=pos, alive=dead_mask)
    got = _plain_forces(tspec, sick, t_grid.build_index(tspec, sick))
    want = _plain_forces(tspec, dead, t_grid.build_index(tspec, dead))
    for name in got:
        out = to_np(got[name])
        assert np.isfinite(out).all(), name
        assert not out[list(rows)].any(), name
        np.testing.assert_allclose(out, to_np(want[name]), atol=ATOL, err_msg=name)
    assert float(np.abs(to_np(want["cell_list_force[reference]"])).max()) > 0.1
