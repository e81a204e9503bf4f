"""Grid build, within-cell ranks and the layout sort: the port vs the JAX
reference, exactly (every result here is an integer or a permutation).

The JAX ``cell_rank`` runs both its ``"xla"`` impl and its Pallas kernel
(interpret mode, coarse tiles); ``tests/grid_oracle.py``'s argsort build is
the third witness.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_oracle import build_index_arrays_argsort, sort_agents_argsort
from repro.core import agents as j_agents
from repro.core import grid as j_grid
from repro.core import morton as j_morton
from repro.kernels.cell_rank import ops as j_cr
from repro_torch.core import agents as t_agents
from repro_torch.core import grid as t_grid
from repro_torch.core import morton as t_morton
from repro_torch.core.neighbors import NeighborContext
from repro_torch.kernels.cell_rank import ops as t_cr
from torch_parity import CPU, to_np


def _case(name):
    """(dims, box, max_per_cell, positions, alive) of one named pool."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        dims, box, m, n = (8, 8, 8), 5.0, 16, 200
        pos = rng.uniform(0, 40, (n, 3))
        alive = rng.random(n) > 0.2
    elif name == "overflow":
        dims, box, m, n = (6, 6, 6), 5.0, 8, 100
        pos = rng.uniform(0, 30, (n, 3))
        pos[:60] = rng.uniform(10.2, 14.8, (60, 3))      # 60 agents in one box
        alive = rng.random(n) > 0.1
    elif name == "all_dead":
        dims, box, m, n = (4, 4, 4), 5.0, 8, 50
        pos = rng.uniform(0, 20, (n, 3))
        alive = np.zeros(n, bool)
    elif name == "single":
        dims, box, m, n = (4, 4, 4), 5.0, 8, 1
        pos = np.array([[7.0, 3.0, 12.0]])
        alive = np.ones(1, bool)
    elif name == "noncubic":
        dims, box, m, n = (8, 1, 4), 2.5, 16, 80
        pos = rng.uniform(0, 1, (n, 3)) * np.array([20.0, 2.5, 10.0])
        alive = rng.random(n) > 0.25
    else:
        raise KeyError(name)
    return dims, box, m, pos.astype(np.float32), alive


CASES = ["random", "overflow", "all_dead", "single", "noncubic"]


def _specs(dims, box, m, use_morton=True):
    common = dict(origin=(0.0, 0.0, 0.0), box_size=box, dims=dims, max_per_cell=m,
                  use_morton=use_morton)
    return j_grid.GridSpec(**common), t_grid.GridSpec(**common)


def _pools(pos, alive):
    jpool = j_agents.make_pool(pos.shape[0], jnp.asarray(pos), diameter=2.0)
    jpool = jpool.replace(alive=jnp.asarray(alive))
    tpool = t_agents.make_pool(pos.shape[0], pos, diameter=2.0, device=CPU)
    tpool = tpool.replace(alive=torch.from_numpy(alive))
    return jpool, tpool


# ------------------------------------------------------------------ morton

@pytest.mark.parametrize("dims", [(4, 4, 4), (8, 1, 4), (5, 7, 3), (16, 16, 16)])
@pytest.mark.parametrize("use_morton", [True, False])
def test_morton_tables(dims, use_morton):
    np.testing.assert_array_equal(t_morton.zorder_cells(dims, use_morton),
                                  j_morton.zorder_cells(dims, use_morton))
    np.testing.assert_array_equal(t_morton.cell_zrank(dims, use_morton),
                                  j_morton.cell_zrank(dims, use_morton))


def test_morton_encode_and_helpers():
    rng = np.random.default_rng(0)
    ijk = rng.integers(0, 1024, (500, 3)).astype(np.uint32)
    want = to_np(j_morton.encode3(*(jnp.asarray(ijk[:, d]) for d in range(3))))
    np.testing.assert_array_equal(t_morton.encode3(*ijk.T), want)
    got = t_morton.encode3_torch(*(torch.from_numpy(ijk[:, d].astype(np.int64))
                                   for d in range(3)))
    np.testing.assert_array_equal(to_np(got), want.astype(np.int64))
    assert t_morton.MAX_TABLE_CELLS == j_morton.MAX_TABLE_CELLS
    assert t_morton.max_grid_dim() == j_morton.max_grid_dim()


def test_morton_decode_bits_for_and_encode3_np():
    """``decode3`` inverts ``encode3`` / ``encode3_torch`` and equals the
    reference's on any uint32 code; ``bits_for`` and ``encode3_np`` equal
    the reference's, the codes bit for bit."""
    rng = np.random.default_rng(1)
    ijk = rng.integers(0, 1024, (500, 3)).astype(np.uint32)
    codes = t_morton.encode3(*ijk.T)
    on_tensors = t_morton.encode3_torch(*(torch.from_numpy(ijk[:, d].astype(np.int64))
                                          for d in range(3)))
    for c in (codes, on_tensors):
        for got, want in zip(t_morton.decode3(c), ijk.T):
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(to_np(got), want.astype(np.int64))
    any_code = rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    for got, want in zip(t_morton.decode3(any_code), j_morton.decode3(jnp.asarray(any_code))):
        np.testing.assert_array_equal(to_np(got), to_np(want).astype(np.int64))
    for n in [*range(1, 70), 1023, 1024, 1025, 2 ** 20, 2 ** 20 + 1]:
        assert t_morton.bits_for(n) == j_morton.bits_for(n), n
    got, want = t_morton.encode3_np(*ijk.T), j_morton.encode3_np(*ijk.T)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# --------------------------------------------------------------- cell_rank

def _cids(case):
    dims, box, m, pos, alive = _case(case)
    jspec, _ = _specs(dims, box, m)
    jcid = jnp.where(jnp.asarray(alive),
                     j_grid.linear_cell_id(jspec, j_grid.cell_coords(jspec, jnp.asarray(pos))),
                     jspec.n_cells)
    return to_np(jcid).astype(np.int32), jspec.n_cells


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("impl", ["tiled", "reference", "cuda"])
def test_cell_rank_matches_jax(case, impl):
    cid, n_cells = _cids(case)
    want_xla = to_np(j_cr.cell_rank(jnp.asarray(cid), n_cells=n_cells, impl="xla"))
    want_pallas = to_np(j_cr.cell_rank(jnp.asarray(cid), n_cells=n_cells,
                                       impl="pallas", tile=64))
    np.testing.assert_array_equal(want_pallas, want_xla)
    got = t_cr.cell_rank(torch.from_numpy(cid), n_cells=n_cells, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), want_xla)


@pytest.mark.parametrize("tile", [1, 7, 32, 1024])
def test_cell_rank_tiled_any_tile(tile):
    cid, n_cells = _cids("overflow")
    want = to_np(j_cr.cell_rank(jnp.asarray(cid), n_cells=n_cells, impl="reference"))
    got = t_cr.cell_rank(torch.from_numpy(cid), n_cells=n_cells, impl="tiled", tile=tile)
    np.testing.assert_array_equal(to_np(got), want)


# ----------------------------------------------------------- index build

def _assert_index_equal(jidx, tidx):
    for f in ("cell_of_agent", "cell_list", "cell_count", "overflowed"):
        np.testing.assert_array_equal(to_np(getattr(tidx, f)), to_np(getattr(jidx, f)),
                                      err_msg=f)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank_impl", ["tiled", "cuda"])
def test_build_index_matches_jax(case, rank_impl):
    dims, box, m, pos, alive = _case(case)
    jspec, tspec = _specs(dims, box, m)
    tspec = dataclasses.replace(tspec, rank_impl=rank_impl)
    jidx = j_grid.build_index_arrays(jspec, jnp.asarray(pos), jnp.asarray(alive))
    oracle = build_index_arrays_argsort(jspec, jnp.asarray(pos), jnp.asarray(alive))
    _assert_index_equal(oracle, jidx)
    tidx = t_grid.build_index_arrays(tspec, torch.from_numpy(pos), torch.from_numpy(alive))
    _assert_index_equal(jidx, tidx)
    assert bool(tidx.overflowed) == (case == "overflow")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("use_morton", [True, False])
def test_sort_agents_and_sorted_build_match_jax(case, use_morton):
    dims, box, m, pos, alive = _case(case)
    jspec, tspec = _specs(dims, box, m, use_morton)
    tspec = dataclasses.replace(tspec, rank_impl="cuda")
    jpool, tpool = _pools(pos, alive)
    jpool = jpool.set_attr("tag", jnp.arange(pos.shape[0], dtype=jnp.int32))
    tpool = tpool.set_attr("tag", torch.arange(pos.shape[0], dtype=torch.int32))
    jsorted = j_grid.sort_agents(jspec, jpool)
    oracle = sort_agents_argsort(jspec, jpool)
    tsorted = t_grid.sort_agents(tspec, tpool)
    for f in ("position", "alive", "diameter"):
        np.testing.assert_array_equal(to_np(getattr(jsorted, f)), to_np(getattr(oracle, f)))
        np.testing.assert_array_equal(to_np(getattr(tsorted, f)), to_np(getattr(jsorted, f)))
    np.testing.assert_array_equal(to_np(tsorted.get("tag")), to_np(jsorted.get("tag")))
    # A sorted pool builds the same index through the rank-free shortcut.
    jidx = j_grid.build_index(jspec, jsorted, assume_sorted=True)
    tidx = t_grid.build_index(tspec, tsorted, assume_sorted=True)
    _assert_index_equal(jidx, tidx)
    _assert_index_equal(j_grid.build_index(jspec, jsorted), tidx)


def test_sort_agents_argsort_path_past_table_limit():
    rng = np.random.default_rng(5)
    dims = (128, 128, 65)                       # > MAX_TABLE_CELLS
    pos = rng.uniform(0, 1, (300, 3)).astype(np.float32) * np.array(dims, np.float32)
    alive = rng.random(300) > 0.3
    jspec, tspec = _specs(dims, 1.0, 4)
    assert tspec.n_cells > t_morton.MAX_TABLE_CELLS
    jpool, tpool = _pools(pos, alive)
    jsorted = j_grid.sort_agents(jspec, jpool)
    tsorted = t_grid.sort_agents(tspec, tpool)
    np.testing.assert_array_equal(to_np(tsorted.position), to_np(jsorted.position))
    np.testing.assert_array_equal(to_np(tsorted.alive), to_np(jsorted.alive))


@pytest.mark.parametrize("case", ["random", "noncubic"])
def test_cell_starts_and_layout_table(case):
    dims, box, m, pos, alive = _case(case)
    jspec, tspec = _specs(dims, box, m)
    jidx = j_grid.build_index_arrays(jspec, jnp.asarray(pos), jnp.asarray(alive))
    js, je = j_grid.cell_starts_sorted(jspec, jidx.cell_count)
    ts, te = t_grid.cell_starts_sorted(tspec, torch.from_numpy(to_np(jidx.cell_count)))
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    np.testing.assert_array_equal(to_np(te), to_np(je))
    np.testing.assert_array_equal(to_np(t_grid.layout_rank_table(tspec, CPU)),
                                  to_np(j_grid.layout_rank_table(jspec)))


# -------------------------------------------------------------- neighbors

@pytest.mark.parametrize("case", ["random", "overflow", "noncubic"])
def test_candidates_match_jax(case):
    dims, box, m, pos, alive = _case(case)
    jspec, tspec = _specs(dims, box, m)
    jpool, tpool = _pools(pos, alive)
    jidx = j_grid.build_index(jspec, jpool)
    tidx = t_grid.build_index(tspec, tpool)
    jc, jm = j_grid.candidate_neighbors(jspec, jidx, jpool)
    nb = NeighborContext.for_pool(tspec, tidx, tpool)
    tc, tm = nb.candidates()
    np.testing.assert_array_equal(to_np(tc), to_np(jc))
    np.testing.assert_array_equal(to_np(tm), to_np(jm))
    nbr, rng_ = t_grid.neighbor_cell_ids(tspec, tpool.position)
    jnbr, jrng = j_grid.neighbor_cell_ids(jspec, jpool.position)
    np.testing.assert_array_equal(to_np(nbr), to_np(jnbr))
    np.testing.assert_array_equal(to_np(rng_), to_np(jrng))
    # The subset builder reproduces rows of the dense tensor.
    ids = torch.tensor([3, 0, 17, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False])
    sc, sm = nb.candidates_for(ids, valid)
    np.testing.assert_array_equal(to_np(sc[:3]), to_np(tc[ids[:3].long()]))
    np.testing.assert_array_equal(to_np(sm[:3]), to_np(tm[ids[:3].long()]))
    assert not bool(sm[3].any())


# ----------------------------------------------------------- agent pools

@pytest.mark.parametrize("capacity", [1, 5, 40, 64])
def test_compact_indices_and_free_slots(capacity):
    rng = np.random.default_rng(capacity)
    mask = rng.random(40) > 0.5
    j = j_agents.compact_indices(jnp.asarray(mask), capacity, fill=7)
    t = t_agents.compact_indices(torch.from_numpy(mask), capacity, fill=7)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    np.testing.assert_array_equal(to_np(t_agents.free_slot_table(torch.from_numpy(mask))),
                                  to_np(j_agents.free_slot_table(jnp.asarray(mask))))


def test_make_pool_permute_and_schema():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 10, (6, 3)).astype(np.float32)
    kind = np.arange(6, dtype=np.int32) % 2
    attrs = {"w": rng.random((6, 2)).astype(np.float32)}
    jp = j_agents.make_pool(9, jnp.asarray(pos), diameter=3.0, kind=jnp.asarray(kind),
                            attrs={"w": jnp.asarray(attrs["w"])},
                            attr_defaults={"n": jnp.int32(0)})
    tp = t_agents.make_pool(9, pos, diameter=3.0, kind=kind, attrs=attrs,
                            attr_defaults={"n": 0}, device=CPU)
    perm = rng.permutation(9).astype(np.int32)
    for jq, tq in [(jp, tp),
                   (j_agents.permute(jp, jnp.asarray(perm)),
                    t_agents.permute(tp, torch.from_numpy(perm))),
                   (j_agents.permute_to(jp, jnp.asarray(perm)),
                    t_agents.permute_to(tp, torch.from_numpy(perm)))]:
        for f in ("position", "diameter", "kind", "age", "alive", "static", "overflow"):
            a, b = to_np(getattr(tq, f)), to_np(getattr(jq, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for k in ("w", "n"):
            assert to_np(tq.get(k)).dtype == to_np(jq.get(k)).dtype
            np.testing.assert_array_equal(to_np(tq.get(k)), to_np(jq.get(k)))
    arr = t_agents.canonicalize_attr("x", 1.5, 4)
    assert arr.dtype == torch.float32 and tuple(arr.shape) == (4,)
    assert t_agents.canonicalize_attr("i", 3, 2).dtype == torch.int32
    with pytest.raises(ValueError):
        t_agents.canonicalize_attr("x", np.zeros(3), 4)
    schema = {"x": t_agents.attr_signature(arr)}
    with pytest.raises(TypeError):
        t_agents.check_attr_schema("x", torch.zeros(4, dtype=torch.int32), schema)
