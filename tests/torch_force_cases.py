"""Named inputs of the port's force-kernel tests, shared by
``tests/test_torch_cuda.py`` (kernels against their plain versions, no JAX)
and ``tests/test_torch_forces.py`` (the window walk against the sweep and
the JAX kernel).  Everything is made with numpy from a fixed seed per case
and built on the CPU.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.core import agents, grid

CPU = torch.device("cpu")

# n agents (a fifth of them dead, plus 7 dead spare rows) uniform over
# `extent`, diameters 1..6.  `clump` agents go into box (0, 0, 0); `crowd`
# puts exactly that many live agents there and every other agent out of it,
# all with diameters 0.2..0.6 (so that the sums stay of the other cases' size).
FORCE_CASES = {
    "generic": dict(n=600, extent=(40.0, 40.0, 40.0), box=5.0, m=16, seed=2),
    "boundary_2x2x2": dict(n=40, extent=(12.0, 12.0, 12.0), box=6.0, m=32, seed=0),
    "noncubic_8x1x4": dict(n=80, extent=(16.0, 2.0, 8.0), box=2.0, m=16, seed=4),
    "near_empty": dict(n=3, extent=(10.0, 10.0, 10.0), box=5.0, m=4, seed=3),
    "overflowed": dict(n=200, extent=(20.0, 20.0, 20.0), box=5.0, m=4, clump=20, seed=5),
    "full_row": dict(n=40, extent=(5.0, 5.0, 5.0), box=5.0, m=32, seed=1),  # 32 alive, M = 32
    # Dims (6, 5, 19): no axis a multiple of cell_list_force's tile.
    "ragged_tiles": dict(n=700, extent=(30.0, 25.0, 95.0), box=5.0, m=16, seed=6),
    # One box holding M = 1,100 agents: more than a tile stages in shared
    # memory (kernel.STAGE_BUDGET), so its tile walks global memory.
    "crowded_box": dict(n=1400, extent=(10.0, 5.0, 5.0), box=5.0, m=1100, crowd=1100,
                        seed=7),
}


def force_inputs(case):
    """(position, radius, index, spec, capacity) on the CPU."""
    p = FORCE_CASES[case]
    rng = np.random.default_rng(p["seed"])
    n, extent, box = p["n"], np.asarray(p["extent"], np.float32), p["box"]
    pos = (rng.uniform(0, 1, (n, 3)) * extent).astype(np.float32)
    if p.get("clump"):
        c = p["clump"]
        pos[:c] = (box * 0.1 + rng.uniform(0, box * 0.8, (c, 3))).astype(np.float32)
    diam = rng.uniform(1.0, 6.0, n).astype(np.float32)
    cap = n + 7
    alive = np.ones(cap, bool)
    alive[n:] = False
    alive[rng.choice(n, n // 5, replace=False)] = False
    if p.get("crowd"):
        pos[:, 0] = box + pos[:, 0] * (extent[0] - box) / extent[0]
        inside = np.flatnonzero(alive[:n])[: p["crowd"]]
        pos[inside] = (box * 0.1 + rng.uniform(0, box * 0.8, (len(inside), 3))).astype(
            np.float32)
        diam = rng.uniform(0.2, 0.6, n).astype(np.float32)
    spec = grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=box,
                         dims=tuple(int(e // box) for e in extent), max_per_cell=p["m"])
    pool = agents.make_pool(cap, pos, diameter=diam, device=CPU)
    pool = pool.replace(alive=torch.from_numpy(alive))
    return pool.position, pool.radius(), grid.build_index(spec, pool), spec, cap


# (force case, layout-sorted, block, half_window): C = n + 7 is never a
# multiple of the block, every case has dead rows; windows clipped at both
# ends of the pool, narrow over unsorted rows, cutting cells' row runs, and
# all-pairs.
WINDOW_CASES = {
    "allpairs_unsorted": ("generic", False, 64, 20),
    "sorted_narrow": ("generic", True, 32, 2),
    "sorted_clipped_both_ends": ("noncubic_8x1x4", True, 32, 1),
    "sorted_block_128": ("overflowed", True, 128, 1),
    "tiny_block": ("near_empty", False, 4, 1),
    # Cells' rows scattered over the pool and cut by a narrow window.
    "unsorted_narrow": ("generic", False, 32, 2),
    # The clump's run of 20 sorted rows spans window edges of 8-row blocks.
    "sorted_straddling_runs": ("overflowed", True, 8, 1),
}


def window_inputs(name):
    """(position, radius, index, spec, block, half_window) on the CPU."""
    case, is_sorted, block, window = WINDOW_CASES[name]
    pos, rad, index, spec, cap = force_inputs(case)
    if is_sorted:
        pool = agents.make_pool(cap, pos, diameter=2.0 * rad, device=CPU)
        pool = pool.replace(alive=index.cell_of_agent < spec.n_cells)
        pool = grid.sort_agents(spec, pool)
        index = grid.build_index(spec, pool, assume_sorted=True)
        pos, rad = pool.position, pool.radius()
    return pos, rad, index, spec, block, window


def runs_cut_by_a_window_edge(cid: np.ndarray, n_cells: int, block: int, window: int) -> int:
    """Live cells whose rows [first, last] hold a window edge strictly
    inside (some query's window takes part of the cell's rows)."""
    c = cid.shape[0]
    nbw = -(-c // block)
    edges = {max(t - window, 0) * block for t in range(nbw)}
    edges |= {min((t + window + 1) * block, c) for t in range(nbw)}
    rows = np.arange(c)
    live = cid < n_cells
    cut = 0
    for cell in np.unique(cid[live]):
        at = rows[cid == cell]
        cut += any(at[0] < e <= at[-1] for e in edges)
    return cut


# Dense candidate sets for the pairwise_force kernel, each
# (position, radius, cand, mask, source position, source radius) on the CPU.
# "layout_27x96" is the engine's own layout at the dense path's K = 27 * 96
# (each neighbour cell's slots filled from its first) over the "overflowed"
# agents, N = 207 rows (not a multiple of a block's 8); the others vary it:
# rows whose bases are not 16-byte aligned (K = 135, 2,593), every slot set
# (a warp's segment of 16-byte words holds 512 set slots), a single set slot
# at a row's first or last slot, one row and 13 rows of a longer source array.
DENSE_CASES = ("layout_27x96", "unaligned_135", "unaligned_2593", "every_slot_set",
               "first_or_last_slot_2592", "first_or_last_slot_2593", "single_row",
               "ragged_rows")


def _layout(case, m):
    pos, rad, index, spec, cap = force_inputs(case)
    alive = index.cell_of_agent < spec.n_cells
    if m != spec.max_per_cell:
        spec = dataclasses.replace(spec, max_per_cell=m)
        pool = agents.make_pool(cap, pos, diameter=2.0 * rad, device=CPU)
        index = grid.build_index(spec, pool.replace(alive=alive))
    cand, mask = grid.candidate_neighbors_arrays(spec, index, pos, alive)
    return pos, rad, cand, mask


def dense_inputs(name):
    rng = np.random.default_rng(DENSE_CASES.index(name))
    pos, rad, cand, mask = _layout("overflowed", 96)
    n = pos.shape[0]
    if name == "unaligned_135":
        pos, rad, cand, mask = _layout("generic", 16)
        cand, mask = cand[:, :135].contiguous(), mask[:, :135].contiguous()
    elif name == "unaligned_2593":
        extra = torch.from_numpy(rng.integers(0, n, (n, 1), dtype=np.int32))
        cand = torch.cat([cand, extra], 1)
        mask = torch.cat([mask, torch.from_numpy(rng.uniform(size=(n, 1)) < 0.5)], 1)
    elif name == "every_slot_set":
        cand = torch.from_numpy(rng.integers(0, n, cand.shape, dtype=np.int32))
        mask = torch.ones_like(mask)
        # Radii / 4 keep the 2,592-pair sums of the other cases' size (max|F|
        # ~10, not ~340), as "crowded_box" does, for the absolute tolerance.
        rad = rad * 0.25
    elif name.startswith("first_or_last_slot"):
        kdim = int(name.rsplit("_", 1)[1])
        # Each row's one candidate is its nearest other agent.
        d = torch.cdist(pos, pos).fill_diagonal_(float("inf"))
        cand = d.argmin(1).int()[:, None].repeat(1, kdim)
        mask = torch.zeros((n, kdim), dtype=torch.bool)
        mask[0::2, 0] = True
        mask[1::2, -1] = True
    elif name in ("single_row", "ragged_rows"):
        rows = slice(5, 6) if name == "single_row" else slice(0, 13)
        return (pos[rows], rad[rows], cand[rows].contiguous(), mask[rows].contiguous(),
                pos, rad)
    return pos, rad, cand, mask, pos, rad


def slot_pools(slots, capacity, spec, space, nan_slot=None, empty_slot=None):
    """``slots`` solo pools (a seed each, the later ones with fewer agents)
    and their flat view, the batch layout of ``repro_torch.core.slots``.
    ``nan_slot``'s positions are NaN in every third row; ``empty_slot`` has
    no live agent."""
    pools = []
    for b in range(slots):
        rng = np.random.default_rng(b)
        n = capacity - 8 * b
        pos = rng.uniform(0.0, space, (n, 3)).astype(np.float32)
        if b == nan_slot:
            pos[::3] = np.nan
        pool = agents.make_pool(capacity, pos,
                                diameter=rng.uniform(3.0, 6.0, n).astype(np.float32),
                                kind=rng.integers(0, 2, n).astype(np.int32),
                                attrs={"w": rng.normal(size=(n, 2)).astype(np.float32)})
        if b == empty_slot:
            pool = pool.replace(alive=torch.zeros_like(pool.alive))
        pools.append(pool)
    return pools, stack_pools(pools)


def stack_pools(pools):
    """The flat view of equally sized solo pools (``repro_torch.core.slots``)."""
    rows = lambda xs: torch.cat(xs)
    return pools[0].replace(
        position=rows([p.position for p in pools]), diameter=rows([p.diameter for p in pools]),
        kind=rows([p.kind for p in pools]), age=rows([p.age for p in pools]),
        alive=rows([p.alive for p in pools]), static=rows([p.static for p in pools]),
        attrs={k: rows([p.attrs[k] for p in pools]) for k in pools[0].attrs},
        overflow=torch.stack([p.overflow for p in pools]))


def mixed_gate_pools(capacity=256, seed=5, device=None):
    """Three pools of one grid (``MIXED_SPEC``) for the Morton window's
    per-session gate: layout-sorted (its window covers it at
    ``covering_half_window``), the same agents shuffled (no narrow window
    covers it), and one with no live agent.  Returns ``(pools, flat view,
    half_window)`` with the half-window (blocks of ``MIXED_BLOCK``) that
    covers the sorted pool and not the shuffled one."""
    from repro_torch.core.forces import covering_half_window

    rng = np.random.default_rng(seed)
    n = capacity - 16
    pos = rng.uniform(0.0, 40.0, (n, 3)).astype(np.float32)
    diam = rng.uniform(3.0, 6.0, n).astype(np.float32)
    pool = agents.make_pool(capacity, pos, diameter=diam)
    ordered = grid.sort_agents(MIXED_SPEC, pool)
    perm = torch.from_numpy(rng.permutation(capacity))
    shuffled = ordered.replace(position=ordered.position[perm],
                               diameter=ordered.diameter[perm], kind=ordered.kind[perm],
                               age=ordered.age[perm], alive=ordered.alive[perm],
                               static=ordered.static[perm])
    empty = ordered.replace(alive=torch.zeros_like(ordered.alive))
    pools = [ordered, shuffled, empty]
    window = covering_half_window(MIXED_SPEC, grid.build_index(MIXED_SPEC, ordered),
                                  MIXED_BLOCK)
    if device is not None:
        pools = [move_pool(p, device) for p in pools]
    return pools, stack_pools(pools), window


def move_pool(pool, device):
    """``pool`` with every tensor leaf on ``device``."""
    return dataclasses.replace(pool, **{
        f.name: ({k: v.to(device) for k, v in pool.attrs.items()} if f.name == "attrs"
                 else getattr(pool, f.name).to(device))
        for f in dataclasses.fields(pool)})


MIXED_SPEC = grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=5.0, dims=(8, 8, 8),
                           max_per_cell=16, rank_impl="cuda")
MIXED_BLOCK = 16


def fused_call_counts(monkeypatch):
    """``{"window": n, "linear": n}``: calls of the two fused force
    dispatchers (``cell_window_force``, ``cell_list_force``) from here on,
    counted through ``monkeypatch``.  On CPU tensors no launch counter moves,
    so this is how a CPU test sees which fused kernel a step took."""
    from repro_torch.kernels.cell_force import ops as cf_ops

    calls = {"window": 0, "linear": 0}
    for name, fn in (("window", cf_ops.cell_window_force), ("linear", cf_ops.cell_list_force)):
        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(cf_ops, fn.__name__, spy)
    return calls
