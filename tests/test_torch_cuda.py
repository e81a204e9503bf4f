"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` need an NVIDIA GPU and ``nvcc``; without a card they
skip (the decision is taken inside the ``card`` fixture, never at import).
On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: ranks exact; forces ``atol=1e-5`` (the plain versions sum the
pairs in another order); diffusion bit for bit against the plain version on
the card (the kernel keeps its sum order and rounding) and ``rtol=atol=1e-6``
against it on the CPU; RMSNorm and flash attention f32 ``rtol=1e-5,
atol=2e-6`` and ``atol=2e-5``, bf16 one bf16 ulp (``rtol=2**-7``: the f32
results, summed in other orders, round once to bf16); the tensor-core flash
kernels' sharp-softmax cases one bf16 ulp of a float64 oracle (at D 256 and
q x8 at most twice the f32 plain version's outputs beyond it + 2, none
beyond one bf16 ulp + 2e-5).  The training
slice's tests (flash lse, gradients through the kernels' forwards, the
RMSNorm Function, train steps card against CPU) state theirs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import agents, grid
from repro_torch.core.slots import slot_of as tree_slot
from repro_torch.kernels import _build
from repro_torch.kernels.cell_force import kernel as cf_kernel
from repro_torch.kernels.cell_force import ops as cf_ops
from repro_torch.kernels.cell_force.ref import cell_list_force_ref, cell_window_force_ref
from repro_torch.kernels.cell_rank import kernel as cr_kernel
from repro_torch.kernels.cell_rank import ops as cr_ops
from repro_torch.kernels.cell_rank.ref import cell_rank_ref
from repro_torch.kernels.diffusion3d import kernel as d3_kernel
from repro_torch.kernels.diffusion3d import ops as d3_ops
from repro_torch.kernels.diffusion3d.ref import diffusion_step_ref
from repro_torch.kernels.pairwise_force import kernel as pf_kernel
from repro_torch.kernels.pairwise_force import ops as pf_ops
from repro_torch.kernels.pairwise_force.ref import pairwise_force_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from torch_force_cases import DENSE_CASES, FORCE_CASES, WINDOW_CASES, runs_cut_by_a_window_edge
from torch_force_cases import MIXED_BLOCK, MIXED_SPEC, mixed_gate_pools, move_pool, slot_pools
from torch_force_cases import dense_inputs as _dense_inputs
from torch_force_cases import force_inputs as _force_inputs
from torch_force_cases import window_inputs as _window_inputs

CPU = torch.device("cpu")

# One intra-op thread, as tests/torch_parity.py sets for the other port
# tests: with several, the first torch.sqrt of a process on the CPU has been
# seen to return values up to 2.5e-4 off (torch 2.13, AVX512), which made
# the plain-version comparisons below flaky.
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


# ------------------------------------------------------------------ cell_rank

def _cid_case(name):
    """(cid (C,) int32, n_cells) of one named input."""
    rng = np.random.default_rng(len(name))
    if name == "random":
        n_cells, cid = 512, rng.integers(0, 513, 3000)
    elif name == "crowded_box":
        n_cells = 64
        cid = rng.integers(0, 65, 5000)
        cid[rng.random(5000) < 0.8] = 17                 # one box holds most agents
    elif name == "all_dead":
        n_cells, cid = 64, np.full(700, 64)
    elif name == "single":
        n_cells, cid = 64, np.array([5])
    elif name == "empty":
        n_cells, cid = 64, np.zeros(0, np.int64)
    elif name == "noncubic_8x1x4":
        n_cells, cid = 32, rng.integers(0, 33, 257)
    elif name == "soma_density":                         # the soma path's shape
        n_cells = 100**3
        cid = rng.integers(0, n_cells, 600_000)
        cid[rng.random(600_000) < 0.05] = n_cells
    elif name in ("just_above_threshold", "far_above_threshold"):
        # One cell just above / far above the block-ranking threshold, one at
        # it, the rest sparse; shuffled.
        big = cr_kernel.SMALL_CELL + 1 if name == "just_above_threshold" else \
            3 * cr_kernel.CHUNK + 17
        n_cells = 4096
        rest = rng.integers(0, n_cells + 1, 5000)
        rest[(rest == 123) | (rest == 3000)] = n_cells
        cid = np.concatenate([np.full(big, 123), np.full(cr_kernel.SMALL_CELL, 3000), rest])
        cid = cid[rng.permutation(cid.shape[0])]
    elif name == "ragged_pool":                          # C not a multiple of a tile
        n_cells, cid = 1000, rng.integers(0, 1001, 3 * cr_kernel.AGENT_TILE + 7)
    elif name == "mostly_dead":
        n_cells = 5000
        cid = np.where(rng.random(20_000) < 0.95, n_cells, rng.integers(0, n_cells, 20_000))
    else:
        raise KeyError(name)
    return torch.from_numpy(cid.astype(np.int32)), n_cells


RANK_CASES = ["random", "crowded_box", "all_dead", "single", "empty", "noncubic_8x1x4",
              "soma_density", "just_above_threshold", "far_above_threshold", "ragged_pool",
              "mostly_dead"]


def _rank_by_stable_sort(cid: torch.Tensor, n_cells: int) -> np.ndarray:
    """The ranks from a stable sort by cell id: exact at any size."""
    c = cid.numpy().astype(np.int64)
    order = np.argsort(c, kind="stable")
    counts = np.bincount(c, minlength=n_cells + 1)
    rank = np.empty_like(c)
    rank[order] = np.arange(c.shape[0]) - (np.cumsum(counts) - counts)[c[order]]
    return rank


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANK_CASES)
def test_cell_rank_kernel_matches_plain(card, case):
    cid, n_cells = _cid_case(case)
    # The O(C^2) oracle where it fits; else a stable sort (held to the oracle
    # on every smaller case).
    want = cell_rank_ref(cid).numpy() if cid.numel() <= 20_000 else \
        _rank_by_stable_sort(cid, n_cells)
    if cid.numel():
        np.testing.assert_array_equal(_rank_by_stable_sort(cid, n_cells)[:20_000],
                                      want[:20_000])
    before = cr_kernel.launches
    got = cr_ops.cell_rank(cid.to(card), n_cells, impl="cuda")
    torch.cuda.synchronize()
    assert got.device == card and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(
        cr_ops.cell_rank_tiled(cid.to(card), n_cells).cpu().numpy(), want)
    assert cr_kernel.launches == before + (1 if cid.numel() else 0)
    counts = np.bincount(cid.numpy(), minlength=n_cells + 1)[:n_cells]
    if case.endswith("_threshold"):
        assert (counts > cr_kernel.SMALL_CELL).sum() == 1
        assert (counts == cr_kernel.SMALL_CELL).sum() >= 1
    if case == "far_above_threshold":
        assert counts.max() > 3 * cr_kernel.CHUNK        # ranked across four chunks


@pytest.mark.cuda
def test_cell_rank_workspace_size_matches_the_source(card):
    lib = cr_kernel._lib()
    for n, n_cells in ((1, 0), (1000, 64), (600_000, 100**3), (131_072, 56**3), (70_001, 3)):
        assert lib.cell_rank_workspace_bytes(n, n_cells) == cr_kernel.workspace_bytes(n, n_cells)


@pytest.mark.cuda
def test_cell_rank_graph_replay_matches_eager(card):
    """One call captured in a CUDA graph (memset and kernels, workspace from
    the graph's pool) replays to the eager ranks, again after the input
    changes in place."""
    inputs = [_cid_case(name) for name in ("crowded_box", "random")]
    n = max(c.numel() for c, _ in inputs)
    n_cells = max(nc for _, nc in inputs)
    pad = lambda c: torch.cat([c, torch.full((n - c.numel(),), n_cells, dtype=torch.int32)])
    first, second = (pad(c).to(card) for c, _ in inputs)
    cid = first.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cr_kernel.cell_rank_cuda(cid, n_cells)                 # warm-up: build, load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cr_kernel.cell_rank_cuda(cid, n_cells)
    for src in (first, second, first):
        cid.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cr_kernel.cell_rank_cuda(src, n_cells))
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      _rank_by_stable_sort(src.cpu(), n_cells))


# ------------------------------------------------------------ cell_list_force

def _cell_list_plain(pos, rad, cell_list, dims):
    """``cell_list_force_ref`` over chunks of query boxes of about 1e7 pairs
    each (its pair tensors are (boxes, M, 27·M))."""
    n_cells, m = cell_list.shape
    chunk = max(1, int(1e7 // (27 * m * m)))
    return sum(cell_list_force_ref(pos, rad, cell_list, dims, cells=(lo, min(lo + chunk, n_cells)))
               for lo in range(0, n_cells, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FORCE_CASES))
def test_cell_list_force_kernel_matches_plain(card, case):
    pos, rad, index, spec, cap = _force_inputs(case)
    assert bool(index.overflowed) == (case == "overflowed")
    want = _cell_list_plain(pos, rad, index.cell_list, spec.dims)
    args = [t.to(card) for t in (pos, rad, index.cell_list)]
    before = cf_kernel.launches
    crowded = cf_kernel.crowded_tiles(card)
    got = cf_ops.cell_list_force(*args, spec.dims, impl="cuda")
    torch.cuda.synchronize()
    assert cf_kernel.launches == before + 1
    # Only the crowded box's tile walks global memory.
    assert (cf_kernel.crowded_tiles(card) > crowded) == (case == "crowded_box")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    on_card = _cell_list_plain(*args, spec.dims)
    np.testing.assert_allclose(got.cpu().numpy(), on_card.cpu().numpy(), atol=1e-5)
    if case != "near_empty":
        assert float(want.abs().max()) > 0.1
    if case == "ragged_tiles":
        assert all(d % t for d, t in zip(spec.dims, cf_kernel.TILE))
    # Rows past num_out drop; the rows kept are unchanged.
    part = cf_ops.cell_list_force(*args, spec.dims, impl="cuda", num_out=cap // 2)
    np.testing.assert_array_equal(part.cpu().numpy(), got.cpu().numpy()[: cap // 2])


def _dist_case():
    """The reference's 4×2 force-only relaxation (tests/torch_dist_reference.py)."""
    import torch_dist_reference as R
    from repro_torch.core import EngineConfig, ForceParams
    from repro_torch.core import distributed as dist

    domain, engine, pos = R.force_setup()
    dcfg = dist.DomainConfig(**domain, halo_codec="int16")
    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32, rank_impl="cuda"),
                        force_params=ForceParams(), force_impl="fused", **engine)
    return dcfg, ecfg, pos


def _ghost_inputs():
    """Rank 0's ghost-extended sources after one step of the 4×2 case, from
    ``halo_exchange``, and the halo-extended grid built over them, on the
    CPU: (position (S, 3), radius (S,), index, spec, C)."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    dcfg, ecfg, pos = _dist_case()
    mesh = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices="cpu")
    state = dist.make_distributed_step(mesh, dcfg, ecfg)(
        dist.init_dist_state(dcfg, 192, pos, diameter=1.6))
    ranks = dist.unstack_state(state, mesh.devices)
    out, _ = dist.halo_exchange(dcfg, mesh, [r.pool for r in ranks], [r.codec for r in ranks])
    g_pos, g_rad, _, g_alive, _, _ = out[0]
    index = grid.build_index_arrays(ecfg.spec, g_pos, g_alive)
    return g_pos, g_rad, index, ecfg.spec, ranks[0].pool.capacity


@pytest.mark.cuda
def test_cell_list_force_over_ghost_sources_matches_plain(card):
    """The distributed engine's input: S = C + 2·D·H sources (the pool and
    its halo rows), forces for the first C rows only."""
    pos, rad, index, spec, c = _ghost_inputs()
    assert pos.shape[0] > c and bool((index.cell_list[index.cell_list < pos.shape[0]] >= c).any())
    want = cell_list_force_ref(pos, rad, index.cell_list, spec.dims, num_out=c)
    got = cf_ops.cell_list_force(pos.to(card), rad.to(card), index.cell_list.to(card),
                                 spec.dims, impl="cuda", num_out=c)
    assert got.shape == (c, 3)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    assert float(want.abs().max()) > 0.1


@pytest.mark.cuda
def test_dist_small_step_on_card_matches_cpu(card):
    """One step of the 4×2 relaxation (fused forces over ghost-extended
    sources, cell_rank) on the card against the CPU: integer leaves equal,
    floats within 5e-4 (the reference's fused-against-dense tolerance)."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    dcfg, ecfg, pos = _dist_case()
    finals = {}
    for dev in (card, CPU):
        mesh = make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=[dev] * dcfg.n_devices)
        state = dist.init_dist_state(dcfg, 192, pos, diameter=1.6, device=dev)
        before = cf_kernel.launches
        finals[dev.type] = dist.make_distributed_step(mesh, dcfg, ecfg)(state)
        if dev.type == "cuda":
            assert cf_kernel.launches == before + dcfg.n_devices
    card_leaves, cpu_leaves = _leaves(finals["cuda"]), _leaves(finals["cpu"])
    assert list(card_leaves) == list(cpu_leaves)
    for a, b in zip(card_leaves.values(), cpu_leaves.values()):
        if a.is_floating_point():
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=5e-4)
        else:
            assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------- cell_window_force

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_cell_window_force_kernel_matches_plain(card, name):
    pos, rad, index, spec, block, window = _window_inputs(name)
    cid = index.cell_of_agent
    want = cell_window_force_ref(pos, rad, cid, spec.dims, block=block, half_window=window)
    before = cf_kernel.window_launches
    got = cf_ops.cell_window_force(pos.to(card), rad.to(card), cid.to(card), spec.dims,
                                   block=block, window=window, impl="cuda")
    torch.cuda.synchronize()
    assert cf_kernel.window_launches == before + 1
    assert pos.shape[0] % block != 0
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    dead = (cid >= spec.n_cells).numpy()
    assert dead.any() and not got.cpu().numpy()[dead].any()
    if name == "allpairs_unsorted":
        # All pairs: the 27-box sum, a second witness.
        linear = cell_list_force_ref(pos, rad, index.cell_list, spec.dims)
        np.testing.assert_allclose(got.cpu().numpy(), linear.numpy(), atol=1e-5)
    if name != "tiny_block":
        assert float(want.abs().max()) > 0.1
    if name == "sorted_straddling_runs":
        assert runs_cut_by_a_window_edge(cid.numpy(), spec.n_cells, block, window) > 0


# ------------------------------------------------ non-finite sources

def _nan_inputs(rows):
    """The "generic" force case with x = NaN at ``rows``, made live, the
    grid rebuilt over it, on the CPU."""
    pos, rad, index, spec, cap = _force_inputs("generic")
    alive = index.cell_of_agent < spec.n_cells
    alive[list(rows)] = True
    pos = pos.clone()
    pos[list(rows), 0] = float("nan")
    pool = agents.make_pool(cap, pos, diameter=2.0 * rad, device=CPU).replace(alive=alive)
    return pos, rad, grid.build_index(spec, pool), spec, alive


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0,), (0, 17)], ids=["row0", "row0_interior"])
@pytest.mark.parametrize("kernel", ["cell_list_force", "cell_window_force", "pairwise_force"])
def test_force_kernels_match_plain_with_nan_agents(card, kernel, rows):
    """NaN at row 0 (read by the plain cell_list_force's sentinel slots) and
    at an interior row: the kernel and its plain version have the same
    non-finite rows (none) and agree within 1e-5 elsewhere."""
    pos, rad, index, spec, alive = _nan_inputs(rows)
    if kernel == "cell_list_force":
        call = lambda *t: cf_ops.cell_list_force(*t, spec.dims, impl="cuda")
        args = (pos, rad, index.cell_list)
        want = cell_list_force_ref(*args, spec.dims)
    elif kernel == "cell_window_force":
        call = lambda *t: cf_ops.cell_window_force(*t, spec.dims, block=64, window=20,
                                                   impl="cuda")
        args = (pos, rad, index.cell_of_agent)
        want = cell_window_force_ref(*args, spec.dims, block=64, half_window=20)
    else:
        cand, mask = grid.candidate_neighbors_arrays(spec, index, pos, alive)
        call = lambda *t: pf_ops.pairwise_force(*t, impl="cuda")
        args = (pos, rad, cand, mask)
        want = pairwise_force_ref(*args)
    got = call(*(t.to(card) for t in args)).cpu()
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert bool(torch.isfinite(got).all()) and not bool(got[list(rows)].any())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert float(want.abs().max()) > 0.1


# ------------------------------------------------------------- pairwise_force

def _pairwise_on(card, pos, rad, cand, mask, src_pos, src_rad):
    return pf_ops.pairwise_force(pos.to(card), rad.to(card), cand.to(card), mask.to(card),
                                 impl="cuda", all_position=src_pos.to(card),
                                 all_radius=src_rad.to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["generic", "overflowed", "near_empty", *DENSE_CASES])
def test_pairwise_force_kernel_matches_plain(card, case):
    if case in DENSE_CASES:
        pos, rad, cand, mask, src_pos, src_rad = _dense_inputs(case)
    else:
        pos, rad, index, spec, cap = _force_inputs(case)
        alive = index.cell_of_agent < spec.n_cells
        cand, mask = grid.candidate_neighbors_arrays(spec, index, pos, alive)
        # K not a multiple of 32, and some rows with every slot masked out.
        cand, mask = cand[:, :45].contiguous(), mask[:, :45].clone()
        mask[::3] = False
        src_pos, src_rad = pos, rad
    want = pairwise_force_ref(pos, rad, cand, mask, all_position=src_pos, all_radius=src_rad)
    before = pf_kernel.launches
    got = _pairwise_on(card, pos, rad, cand, mask, src_pos, src_rad)
    torch.cuda.synchronize()
    assert pf_kernel.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    if case in DENSE_CASES:
        # Row bases off the 16-byte grid exactly where K % 16 != 0.
        assert (cand.shape[1] % 16 != 0) == (case in ("unaligned_135", "unaligned_2593",
                                                      "first_or_last_slot_2593"))
        assert float(want.abs().max()) > 0.1
        return
    assert not got.cpu().numpy()[::3].any()
    # Sources longer than the queries.
    q = cap // 2
    want = pairwise_force_ref(pos[:q], rad[:q], cand[:q], mask[:q],
                              all_position=pos, all_radius=rad)
    got = pf_ops.pairwise_force(pos[:q].to(card), rad[:q].to(card), cand[:q].to(card),
                                mask[:q].to(card), impl="cuda",
                                all_position=pos.to(card), all_radius=rad.to(card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layout_27x96", "every_slot_set", "unaligned_2593"])
def test_pairwise_force_two_calls_are_bit_identical(card, case):
    args = _dense_inputs(case)
    first = _pairwise_on(card, *args)
    second = _pairwise_on(card, *args)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_pairwise_force_graph_replay_matches_eager(card):
    """One call captured in a CUDA graph replays to the eager result, again
    after its inputs change in place (two cases of the same shapes)."""
    cases = [[t.to(card) for t in _dense_inputs(name)]
             for name in ("layout_27x96", "every_slot_set")]
    assert [t.shape for t in cases[0]] == [t.shape for t in cases[1]]
    live = [t.clone() for t in cases[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pf_kernel.pairwise_force_cuda(*live[:4], all_position=live[4], all_radius=live[5])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pf_kernel.pairwise_force_cuda(*live[:4], all_position=live[4],
                                            all_radius=live[5])
    for src in (cases[1], cases[0], cases[1]):
        for t, s in zip(live, src):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        eager = pf_kernel.pairwise_force_cuda(*src[:4], all_position=src[4],
                                              all_radius=src[5])
        assert torch.equal(out, eager)


# ----------------------------------------------------------------- diffusion

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (8, 1, 4), (17, 9, 5), (64, 64, 64),
                                   (23, 19, 30), (6, 37, 12), (200, 200, 200)],
                         ids=["1", "nz_lt_tile", "nz_odd", "64", "nz_mod4_lt_tile",
                              "ny_ragged", "200"])
@pytest.mark.parametrize("aligned", [True, False])
def test_diffusion_kernel_matches_plain(card, shape, aligned):
    """Bit for bit against the plain version on the card (the kernel keeps
    its sum order and rounding); a field that starts one float into its
    buffer takes the kernel's 4-byte path."""
    rng = np.random.default_rng(sum(shape))
    u = torch.from_numpy(rng.uniform(0, 10, shape).astype(np.float32))
    want = diffusion_step_ref(u, 0.16, 0.002)
    size = u.numel()
    buf = torch.zeros(size + 1, dtype=torch.float32, device=card)
    on = buf[(0 if aligned else 1):][:size].view(shape)
    on.copy_(u)
    before = d3_kernel.launches
    got = d3_ops.diffusion_step(on, 0.16, 0.002, impl="cuda")
    torch.cuda.synchronize()
    assert d3_kernel.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, diffusion_step_ref(on, 0.16, 0.002))


# ------------------------------------------------------------------- rmsnorm

RMS_TOL = {torch.float32: dict(rtol=1e-5, atol=2e-6),
           torch.bfloat16: dict(rtol=2**-7, atol=1e-6)}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4, 3072), (8192, 3072), (7, 50), (300, 128), (1, 24),
                                    (4, 5120), (1000, 5120), (4, 8192), (513, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(card, rows, d, dtype):
    g = torch.Generator().manual_seed(rows * d)
    x = (2 * torch.randn((rows, d), generator=g)).to(dtype)
    for scale_dtype in (torch.float32, dtype):
        s = (1 + 0.2 * torch.randn((d,), generator=g)).to(scale_dtype)
        want = rmsnorm_ref(x, s)
        before = rms_kernel.launches
        got = rms_ops.rmsnorm(x.to(card), s.to(card), impl="cuda")
        torch.cuda.synchronize()
        assert rms_kernel.launches == before + 1
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                                   **RMS_TOL[dtype])
    # A row slice that is not 16-byte aligned takes the scalar path.
    got = rms_ops.rmsnorm(x[1:].to(card), s.to(card), impl="cuda")
    np.testing.assert_allclose(got.float().cpu().numpy(), rmsnorm_ref(x[1:], s).float().numpy(),
                               **RMS_TOL[dtype])


# ----------------------------------------------------------- flash_attention

FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
             torch.bfloat16: dict(rtol=2**-7, atol=1e-6)}

# (seed, (B, Hq, Hkv, Tq, Tk, D), mask kwargs): groups 1 to 16, D 16 / 64
# / 128 / 256, Tq and Tk not multiples of the 64-row tiles, every mask
# term.  Each case keeps its own seed (the first ten: their index in sorted
# order, which seeded them before the seed was a field).
FLASH_CASES = {
    "causal_g3_d128": (1, (2, 6, 2, 100, 100, 128), dict(causal=True)),
    "full_g1_d16": (3, (1, 2, 2, 70, 70, 16), dict(causal=False)),
    "window_g4_d64": (9, (1, 8, 2, 150, 150, 64), dict(causal=True, window=40)),
    "prefix_d128": (6, (1, 3, 1, 90, 90, 128), dict(causal=True, prefix_len=20)),
    "kv_offset_d256": (4, (1, 2, 1, 33, 129, 256), dict(causal=True, kv_offset=96)),
    "decode_row_d128": (2, (2, 24, 8, 1, 200, 128), dict(causal=True, kv_offset=199)),
    "all_terms_d16": (0, (1, 4, 2, 80, 95, 16), dict(causal=True, window=8, prefix_len=5,
                                                      kv_offset=3)),
    "masked_rows_d64": (5, (1, 2, 1, 16, 40, 64), dict(causal=True, window=4, kv_offset=60)),
    # paligemma's prefix-LM mask at D 256 and MQA group 8; recurrentgemma's
    # window shorter than T at D 256 and group 16.
    "prefix_g8_d256": (7, (2, 8, 1, 200, 200, 256), dict(causal=True, prefix_len=72)),
    "window_g16_d256": (8, (1, 16, 1, 230, 230, 256), dict(causal=True, window=64)),
    # The train steps' new shapes: whisper's cross-attention (448 decoder
    # queries over 1,500 frames, D 64, no mask) and command-r's D 128 at
    # group 8 (64 / 8 heads) under a plain causal mask.
    "cross_d64_1500": (10, (1, 8, 8, 448, 1500, 64), dict(causal=False)),
    "causal_g8_d128": (11, (1, 16, 2, 200, 200, 128), dict(causal=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    seed, (b, hq, hkv, tq, tk, d), kw = FLASH_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    want = fa_ops.flash_attention(q, k, v, impl="chunked", block_k=64, **kw)
    before = (fa_kernel.launches, fa_kernel.launches_tc)
    got = fa_ops.flash_attention(q.to(card), k.to(card), v.to(card), impl="cuda", **kw)
    torch.cuda.synchronize()
    # bf16 at D 64 / 128 / 256 runs a tensor-core kernel, the rest the SIMT one.
    tc = fa_kernel.uses_tensor_cores(dtype, d)
    assert (fa_kernel.launches, fa_kernel.launches_tc) == (before[0] + (not tc), before[1] + tc)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               **FLASH_TOL[dtype])
    if case != "masked_rows_d64":
        # The O(T²) oracle's softmax over a row of NEG_INF is uniform; the
        # Pallas kernel and its port give 0 there (max(l, 1e-30)).
        oracle = fa_ops.flash_attention(q.to(card), k.to(card), v.to(card), impl="reference",
                                        **kw)
        np.testing.assert_allclose(got.float().cpu().numpy(), oracle.float().cpu().numpy(),
                                   **FLASH_TOL[dtype])
    else:                                           # every row's keys are hidden
        assert float(got.float().abs().max()) == 0.0
    # (B, T, H, D) storage seen as (B, H, T, D): the model's layout, no copy.
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2).to(card) for t in (q, k, v))
    strided = fa_ops.flash_attention(qs, ks, vs, impl="cuda", **kw)
    assert strided.stride() == qs.stride()
    np.testing.assert_array_equal(strided.float().cpu().numpy(), got.float().cpu().numpy())


# (seed, (B, Hq, Hkv, Tq, Tk, D), mask kwargs): bf16 cases of the tensor-core
# kernels with Tq and Tk not multiples of their 128- (D 64 / 128) or 64-query
# (D 256) and 64-key tiles, and q scaled by 8 (a sharp softmax, where P in
# fewer than three bf16 terms loses the one-ulp bound).  Each case keeps its
# own seed: seed 104 at whisper's shape is the input that found the sharp-
# softmax fault of the D 64 / 128 kernel.
FLASH_TC_CASES = {
    "ragged_causal_d128": (100, (2, 6, 2, 200, 200, 128), dict(causal=True)),
    "ragged_full_d128": (101, (1, 3, 1, 131, 93, 128), dict(causal=False)),
    "ragged_kv_offset_d128": (102, (1, 6, 2, 77, 205, 128), dict(causal=True, kv_offset=128)),
    "ragged_window_prefix_d64": (103, (1, 8, 2, 150, 190, 64),
                                 dict(causal=True, window=70, prefix_len=9, kv_offset=40)),
    # whisper's cross-attention: 448 decoder queries over 1,500 frames, D 64.
    "whisper_cross_d64": (104, (1, 8, 8, 448, 1500, 64), dict(causal=False)),
    # D 256: paligemma's prefix-LM mask with MQA group 8, recurrentgemma's
    # window shorter than T with group 16, a chunk past a cache, one decode row.
    "ragged_prefix_g8_d256": (105, (2, 8, 1, 301, 301, 256), dict(causal=True, prefix_len=100)),
    "ragged_window_g16_d256": (106, (1, 16, 1, 333, 333, 256), dict(causal=True, window=130)),
    "ragged_kv_offset_d256": (107, (1, 4, 2, 77, 205, 256), dict(causal=True, kv_offset=128)),
    "decode_row_g8_d256": (108, (2, 8, 1, 1, 259, 256), dict(causal=True, kv_offset=258)),
    # The dense archs' prefills: gemma-7b's D 256 at group 1 (16 / 16 heads)
    # with a plain causal mask; command-r's D 128 at group 8 (64 / 8 heads)
    # with a plain causal mask and as one decode row past a cache.
    "ragged_causal_g1_d256": (109, (1, 16, 16, 261, 261, 256), dict(causal=True)),
    "ragged_causal_g8_d128": (110, (1, 16, 2, 203, 203, 128), dict(causal=True)),
    "decode_row_g8_d128": (111, (2, 16, 2, 1, 203, 128), dict(causal=True, kv_offset=202)),
}


def _exact_attention(q, k, v, causal=True, window=None, prefix_len=0, kv_offset=0):
    """Masked softmax attention in float64 on the CPU (every row here sees
    at least one key)."""
    from repro_torch.kernels.flash_attention.ref import visible

    b, hq, tq, d = q.shape
    group = hq // k.shape[1]
    kr, vr = (t.double().repeat_interleave(group, 1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) * d ** -0.5
    mask = visible(torch.arange(tq)[:, None] + kv_offset, torch.arange(k.shape[2])[None, :],
                   causal, window, prefix_len)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s.masked_fill(~mask, -torch.inf), -1),
                        vr)


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("case", sorted(FLASH_TC_CASES))
def test_flash_attention_tensor_cores_ragged_and_sharp(card, case, q_scale):
    """One bf16 ulp of the exact (f64) result, and at unit scale of the plain
    version too.  With q x8 the f32 plain version is itself more than one ulp
    from the exact result at rare outputs (12 of 786,432 at T 2,048 on the
    card), so the sharp case is held to the exact result.  At D 256 and q x8
    the scores reach |s| ~ 500, where one f32 ulp of s (3e-5) moves a rare
    near-cancelling output by more than the bound's 1e-6: the f32 plain
    version (the Pallas kernel's arithmetic) lies beyond one bf16 ulp of the
    exact result there too (13 of 1,232,896 outputs of the prefix case on
    the CPU, by at most 2.9e-6).  Which rare outputs cross it depends on the
    sum order, so two f32 versions' counts differ by a few (the SIMT kernel
    had more than the f32 plain version at 13 of 68 such inputs on the
    card, never more than twice as many + 2).  So there the kernel may lie
    beyond it at no more than twice the f32 plain version's outputs on the
    same inputs + 2, and at none by more than the f32 tolerance's atol
    (2e-5; every version stayed within 4.6e-6 on those inputs).  Every
    output is finite."""
    seed, (b, hq, hkv, tq, tk, d), kw = FLASH_TC_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    before = (fa_kernel.launches, fa_kernel.launches_tc)
    # The model's layout: (B, T, H, D) storage seen as (B, H, T, D).
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2).to(card) for t in (q, k, v))
    got = fa_ops.flash_attention(qs, ks, vs, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert (fa_kernel.launches, fa_kernel.launches_tc) == (before[0], before[1] + 1)
    got = got.float().cpu().numpy()
    assert np.isfinite(got).all()
    exact = _exact_attention(q, k, v, **kw).numpy()
    if d == 256 and q_scale == 8.0:
        plain = fa_ops.chunked_attention(q.float().to(card), k.float().to(card),
                                         v.float().to(card), block_k=64, **kw).cpu().numpy()
        excess = lambda x: np.abs(x - exact) - 2.0 ** -7 * np.abs(exact)
        beyond = lambda x: int((excess(x) > 1e-6).sum())
        assert beyond(got) <= 2 * beyond(plain) + 2, (beyond(got), beyond(plain))
        assert excess(got).max() <= FLASH_TOL[torch.float32]["atol"], excess(got).max()
    else:
        np.testing.assert_allclose(got, exact, **FLASH_TOL[torch.bfloat16])
    if q_scale == 1.0:
        want = fa_ops.flash_attention(q, k, v, impl="chunked", block_k=64, **kw)
        np.testing.assert_allclose(got, want.float().numpy(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_lse_matches_plain(card, case, dtype):
    """Both kernels' row logsumexp (``return_lse``) against the plain
    version's on the same inputs: ``rtol=1e-5, atol=1e-5`` (f32 sums of
    exp in other orders, ``logf``); -1e30 exactly where a row's keys are
    all hidden; the output equals the launch without lse bit for bit."""
    seed, (b, hq, hkv, tq, tk, d), kw = FLASH_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(dtype).to(card)
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    out, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    plain_out, plain_lse = fa_ops.chunked_attention(q, k, v, block_k=64, return_lse=True, **kw)
    assert lse.shape == (b, hq, tq) and lse.dtype == torch.float32
    assert torch.equal(out, fa_kernel.flash_attention_cuda(q, k, v, **kw))
    np.testing.assert_allclose(lse.cpu().numpy(), plain_lse.cpu().numpy(), rtol=1e-5, atol=1e-5)
    hidden = plain_lse == -1e30
    assert torch.equal(lse == -1e30, hidden)
    if case == "masked_rows_d64":
        assert bool(hidden.all())


# (FLASH_CASES case, dtype): the tensor-core kernels at D 128, 64 and 256
# (bf16), the SIMT kernel at D 256 (f32); whisper's cross shape and D 128
# at group 8, as the train steps run them.
FLASH_GRAD_CASES = [("causal_g3_d128", torch.bfloat16), ("window_g4_d64", torch.bfloat16),
                    ("prefix_g8_d256", torch.float32), ("kv_offset_d256", torch.float32),
                    ("prefix_g8_d256", torch.bfloat16), ("window_g16_d256", torch.bfloat16),
                    ("cross_d64_1500", torch.bfloat16), ("causal_g8_d128", torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", FLASH_GRAD_CASES)
def test_flash_attention_kernel_gradients_match_plain(card, case, dtype):
    """Autograd through the kernel's forward (``chunked_vjp.FlashAttention``
    with ``impl="cuda"``: one kernel launch) against the plain forward's
    (``impl="chunked"``) on the card, the same backward after each:
    relative L2 of dq, dk, dv ≤ 1e-4 in f32 (the forwards' out and lse agree
    to 2e-5) and ≤ 2e-2 in bf16 (out differs by a bf16 ulp and the
    gradients round to bf16)."""
    seed, (b, hq, hkv, tq, tk, d), kw = FLASH_CASES[case]
    g = torch.Generator().manual_seed(50 + seed)
    base = [torch.randn(s, generator=g).to(dtype).to(card)
            for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))]
    dout = torch.randn((b, hq, tq, d), generator=g).to(dtype).to(card)
    grads = {}
    for impl in ("cuda", "chunked"):
        ts = [t.clone().requires_grad_() for t in base]
        before = (fa_kernel.launches, fa_kernel.launches_tc)
        out = fa_ops.flash_attention(*ts, impl=impl, block_k=64, **kw)
        grads[impl] = torch.autograd.grad(out, ts, dout)
        torch.cuda.synchronize()
        launched = (fa_kernel.launches - before[0]) + (fa_kernel.launches_tc - before[1])
        assert launched == (impl == "cuda")
    bound = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, w in zip(("dq", "dk", "dv"), grads["cuda"], grads["chunked"]):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        rel = float(torch.linalg.norm((a - w).float()) / torch.linalg.norm(w.float()))
        assert rel <= bound, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradient_matches_plain_autograd(card, dtype):
    """``rms_ops.rmsnorm`` under autograd (the ``RMSNorm`` Function: the
    kernel forward, one launch; the written-out backward) against autograd
    through the plain version on the card: dx in f32 ``rtol=1e-5,
    atol=1e-6``, in bf16 one bf16 ulp; dscale (f32) ``rtol=1e-4,
    atol=1e-4``."""
    g = torch.Generator().manual_seed(9)
    x0 = (2 * torch.randn((300, 3072), generator=g)).to(dtype).to(card)
    s0 = (1 + 0.2 * torch.randn((3072,), generator=g)).to(card)
    dy = torch.randn((300, 3072), generator=g).to(dtype).to(card)
    out = {}
    for impl in ("cuda", "reference"):
        x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
        before = rms_kernel.launches
        y = rms_ops.rmsnorm(x, s, 1e-6, impl=impl)
        out[impl] = torch.autograd.grad(y, (x, s), dy)
        torch.cuda.synchronize()
        assert rms_kernel.launches - before == (impl == "cuda")
    (dx, ds), (dx_w, ds_w) = out["cuda"], out["reference"]
    tol = RMS_TOL[dtype] if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(dx.float().cpu().numpy(), dx_w.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(ds.cpu().numpy(), ds_w.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(card):
    """Reduced phi4-mini (f32, ``remat=True``): 3 ``make_train_step`` steps
    on the card (the SIMT flash kernel and rmsnorm, each in the forward and
    in the recomputed forward) against the CPU from one set of weights:
    losses and grad norms ``rtol=1e-5``, every parameter ``atol=1e-5``
    (AdamW with eps 1e-3, so a gradient within round-off of 0 moves its
    parameter by about lr·g/eps, not by ±lr)."""
    from repro_torch import training
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(reduced_config("phi4-mini-3.8b"), attention_impl="cuda",
                              remat=True)
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    opt = adamw.AdamWConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    start = training.init_train_state(model, 0, CPU)
    data = DataConfig(seed=0, batch=2, seq_len=40)
    out = {}
    for dev in (card, CPU):
        state = tree_map(lambda t: t.to(dev, copy=True), start)
        step = training.make_train_step(model, opt)
        counts = (fa_kernel.launches, rms_kernel.launches)
        mets = []
        for i in range(3):
            state, m = step(state, device_batch(data, cfg, i, dev))
            mets.append([float(m["loss"]), float(m["grad_norm"])])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = cfg.n_layers
            assert (fa_kernel.launches - counts[0], rms_kernel.launches - counts[1]) == (
                3 * 2 * n, 3 * (4 * n + 1))
        out[dev.type] = (np.array(mets), [t.cpu() for t in tree_leaves(state.params)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_lm_small_on_card_matches_cpu(card):
    """Reduced phi4-mini (f32): the prefill step with the flash kernel and 8
    decode steps over the prompt's first tokens on the card against the CPU;
    logits atol 1e-4."""
    import dataclasses

    from repro_torch import training
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_map

    model = build_model(dataclasses.replace(reduced_config("phi4-mini-3.8b"),
                                            attention_impl="cuda"))
    params = model.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32))
    out = {}
    counts = (fa_kernel.launches, rms_kernel.launches)
    for dev in (card, CPU):
        p = tree_map(lambda t: t.to(dev), params)
        pre = training.make_prefill_step(model)(p, {"tokens": toks.to(dev)})
        cache = model.init_cache(2, 48, dev)
        logits = []
        for i in range(8):
            lg, cache = model.decode_step(p, cache, toks[:, i:i + 1].to(dev), i)
            logits.append(lg)
        out[dev.type] = (pre.cpu(), torch.cat(logits, 1).cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (fa_kernel.launches - counts[0], rms_kernel.launches - counts[1]) == (
                2, 5 + 8 * 5)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


LM_FAMILIES = ["paligemma-3b", "olmoe-1b-7b", "rwkv6-1.6b", "recurrentgemma-9b",
               "whisper-base"]


def _family_batch(cfg, b, t):
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_family_on_card_matches_cpu(card, arch):
    """Each family's reduced config (f32): the prefill step with the flash
    kernel (the SIMT kernel in f32) and 8 decode steps on the card against
    the CPU, logits atol 1e-4; the flash launches are the attention layers'
    (encoder and cross-attention included), the rmsnorm launches the
    RMSNorm configs' norms."""
    from repro_torch import training
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_map

    cfg = dataclasses.replace(reduced_config(arch), attention_impl="cuda")
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = _family_batch(cfg, 2, 24)
    out = {}
    counts = (fa_kernel.launches, rms_kernel.launches)
    for dev in (card, CPU):
        p = tree_map(lambda t: t.to(dev), params)
        pre = training.make_prefill_step(model)(p, {k: v.to(dev) for k, v in batch.items()})
        cache = model.init_cache(2, 32, dev)
        logits = []
        for i in range(8):
            lg, cache = model.decode_step(p, cache, batch["tokens"][:, i:i + 1].to(dev), i)
            logits.append(lg)
        out[dev.type] = (pre.cpu(), torch.cat(logits, 1).cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            attn_layers = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds())
            flash = attn_layers * (2 if cfg.is_encoder_decoder else 1) + cfg.n_encoder_layers
            rms = (2 * cfg.n_layers + 1) * 9 if cfg.norm == "rmsnorm" else 0
            assert (fa_kernel.launches - counts[0], rms_kernel.launches - counts[1]) == (
                flash, rms)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_moe_combine_on_card_is_deterministic(card):
    """bf16 MoE at olmoe's routing (64 experts, top 8) twice on the card:
    bit for bit equal, and within a relative L2 of 2e-2 of the CPU."""
    from repro_torch.models import moe
    from repro_torch.models.params import unzip

    g = torch.Generator().manual_seed(0)
    p = unzip(moe.moe_init(g, 256, 128, 64))[0]
    x = torch.randn((2, 512, 256), generator=g)
    kw = dict(top_k=8, n_experts=64, capacity_factor=1.25, compute_dtype=torch.bfloat16)
    pc = {k: v.to(card) for k, v in p.items()}
    first, aux1 = moe.moe_apply(pc, x.to(card), **kw)
    second, aux2 = moe.moe_apply(pc, x.to(card), **kw)
    assert torch.equal(first, second) and torch.equal(aux1, aux2)
    cpu = moe.moe_apply(p, x, **kw)[0].float()
    assert float(torch.linalg.norm(first.float().cpu() - cpu) / torch.linalg.norm(cpu)) <= 2e-2


# --------------------------------------------------------------- the slice

def _soma_sim(device):
    from repro_torch import Simulation
    from repro_torch.core import ForceParams, chemotaxis, secretion

    rng = np.random.default_rng(0)
    pos = rng.uniform(10, 90, (120, 3)).astype(np.float32)
    kind = (rng.random(120) < 0.5).astype(np.int32)
    i, j, k = np.meshgrid(*[np.arange(20, dtype=np.float32)] * 3, indexing="ij")
    sim = (Simulation(space=(0.0, 100.0), cell_size=10.0, boundary="closed",
                      max_per_cell=64, rank_impl="cuda", device=device)
           .add_agents(120, position=pos, diameter=5.0, kind=kind)
           .add_substance("s0", diffusion=4.0, decay=0.002, resolution=20,
                          concentration=2.0 + 0.6 * i + 0.4 * j + 0.2 * k)
           .add_substance("s1", diffusion=4.0, decay=0.002, resolution=20,
                          concentration=2.0 + 0.1 * i + 0.3 * j + 0.2 * k)
           .use(secretion("s0", 1.0, kind=0), secretion("s1", 1.0, kind=1),
                chemotaxis("s0", 0.75, kind=0), chemotaxis("s1", 0.75, kind=1))
           .mechanics(ForceParams(), impl="fused", diffusion_impl="cuda")
           .observe_kinds("counts", n_kinds=2, frequency=3))
    return sim


def _soma(device, steps=8):
    return _soma_sim(device).run(steps)[0]


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(card):
    counts = [m.launches for m in (cr_kernel, cf_kernel, d3_kernel)]
    gpu = _soma("cuda")
    torch.cuda.synchronize()
    assert [m.launches - c for m, c in zip((cr_kernel, cf_kernel, d3_kernel), counts)] \
        == [8 + 1, 8, 16]
    cpu = _soma("cpu")
    np.testing.assert_allclose(gpu.pool.position.cpu().numpy(),
                               cpu.pool.position.numpy(), atol=1e-4)
    for name in cpu.grids:
        np.testing.assert_allclose(gpu.grids[name].concentration.cpu().numpy(),
                                   cpu.grids[name].concentration.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["morton", "dense"])
def test_spheroid_on_card_matches_cpu(card, variant):
    """The tumor-spheroid model (births, deaths, threefry draws) 8 steps on
    the card against the CPU run: decisions exact, positions atol 1e-4."""
    import torch_usecases as U

    pos, diam, age = U.spheroid_start(300, 200.0, seed=0, lattice=20.0)
    kw = (dict(impl="fused", tile_order="morton", morton_window=7) if variant == "morton"
          else dict(impl="cuda"))
    finals = {}
    counts = (cf_kernel.window_launches, pf_kernel.launches)
    for dev in ("cuda", "cpu"):
        built = U.spheroid(pos, diam, space=200.0, capacity=1024, device=dev,
                           sort_frequency=1, rank_impl="cuda", **kw).build()
        ages = torch.zeros(1024, device=built.state.pool.device)
        ages[:300] = torch.from_numpy(age)
        state = dataclasses.replace(built.state, pool=built.state.pool.replace(age=ages))
        finals[dev], _ = built.run(8, state=state)
    torch.cuda.synchronize()
    launched = (cf_kernel.window_launches - counts[0], pf_kernel.launches - counts[1])
    assert launched == ((8, 0) if variant == "morton" else (0, 8))
    gpu, cpu = finals["cuda"].pool, finals["cpu"].pool
    for f in ("alive", "kind", "overflow"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    np.testing.assert_allclose(gpu.position.cpu().numpy(), cpu.position.numpy(), atol=1e-4)
    assert int(cpu.alive.sum()) != 300


@pytest.mark.cuda
def test_neurite_on_card_matches_cpu(card):
    """The neurite model of examples/neurite_growth.py (8 neurons) with the
    fused force impl, the cuda rank impl and §5.5 work compaction, 100 steps
    on the card against the CPU: alive, kind and static flags exact;
    positions, directions and path lengths atol 1e-4.  Then 8 steps on the
    card with compaction and without (the fused kernel over every agent):
    the same flags exact, positions atol 1e-4."""
    import torch_usecases as U

    model = dict(impl="fused", rank_impl="cuda")
    finals = {}
    counts = (cr_kernel.launches, cf_kernel.launches)
    for dev in ("cuda", "cpu"):
        finals[dev], _ = U.neurite(8, device=dev, **model).build().run(100)
    torch.cuda.synchronize()
    # A step's grid build and the Morton sort every 16 steps; no step's
    # active set outgrows the example's active_capacity.
    assert (cr_kernel.launches - counts[0], cf_kernel.launches - counts[1]) == (107, 0)
    gpu, cpu = finals["cuda"].pool, finals["cpu"].pool
    for f in ("alive", "kind", "static", "overflow"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    np.testing.assert_allclose(gpu.position.cpu().numpy(), cpu.position.numpy(), atol=1e-4)
    for name in ("direction", "path_len"):
        np.testing.assert_allclose(gpu.get(name).cpu().numpy(), cpu.get(name).numpy(),
                                   atol=1e-4, err_msg=name)
    U.neurite_bars(gpu, 8)
    # The same run replayed from CUDA graphs: the model's behaviour must
    # copy no host value to the card while a step is captured.
    built = U.neurite(8, device="cuda", **model).build()
    jit, _ = built.run_jit(100)
    for f in ("alive", "kind", "static", "position", "diameter"):
        assert torch.equal(getattr(jit.pool, f), getattr(gpu, f)), f
    for name in ("direction", "path_len"):
        assert torch.equal(jit.pool.get(name), gpu.get(name)), name

    runs = {}
    for capacity in (2048, None):
        counts = cf_kernel.launches
        runs[capacity], _ = U.neurite(8, device="cuda", active_capacity=capacity,
                                      **model).build().run(8)
        torch.cuda.synchronize()
        assert cf_kernel.launches - counts == (0 if capacity else 8)
    on, off = runs[2048].pool, runs[None].pool
    for f in ("alive", "kind", "static"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    np.testing.assert_allclose(on.position.cpu().numpy(), off.position.cpu().numpy(), atol=1e-4)


# ------------------------------------------------------------- slot axis
# One launch over a batch's 3 sessions against 3 solo launches, bit for bit;
# session 1 has NaN positions and session 2 no live agent, and neither may
# change what the others get.

SLOTS, SLOT_ROWS, SLOT_SPACE = 3, 2000, 60.0
SLOT_SPEC = grid.GridSpec(origin=(0.0, 0.0, 0.0), box_size=6.0, dims=(10, 10, 10),
                          max_per_cell=24, rank_impl="cuda")


def _slot_case(dev):
    pools, flat = slot_pools(SLOTS, SLOT_ROWS, SLOT_SPEC, SLOT_SPACE, nan_slot=1,
                             empty_slot=2)
    return [move_pool(p, dev) for p in pools], move_pool(flat, dev)


def _rows(x, b):
    return x.reshape((SLOTS, -1) + tuple(x.shape[1:]))[b]


def _bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(), what


@pytest.mark.cuda
def test_cell_rank_one_launch_over_slots_equals_solo_launches(card):
    pools, flat = _slot_case(card)
    n = SLOT_SPEC.n_cells
    cid = grid._live_cell_ids(SLOT_SPEC, flat.position, flat.alive)
    before = cr_kernel.launches
    ranks = cr_kernel.cell_rank_cuda(grid._slot_keys(cid, SLOTS, n + 1), SLOTS * (n + 1) - 1)
    assert cr_kernel.launches == before + 1
    for b in range(SLOTS):
        _bits(_rows(ranks, b), cr_kernel.cell_rank_cuda(_rows(cid, b).contiguous(), n), b)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cell_list_force_one_launch_over_slots_equals_solo_launches(card):
    pools, flat = _slot_case(card)
    index = grid.build_index(SLOT_SPEC, flat)
    before = cf_kernel.launches
    got = cf_kernel.cell_list_force_cuda(flat.position, flat.radius(), index.cell_list,
                                         SLOT_SPEC.dims, num_out=SLOT_ROWS)
    assert cf_kernel.launches == before + 1 and got.shape == (SLOTS * SLOT_ROWS, 3)
    for b, pool in enumerate(pools):
        solo_index = grid.build_index(SLOT_SPEC, pool)
        solo = cf_kernel.cell_list_force_cuda(pool.position, pool.radius(),
                                              solo_index.cell_list, SLOT_SPEC.dims)
        _bits(_rows(got, b), solo, b)
        if b != 1:
            want = cell_list_force_ref(pool.position, pool.radius(), solo_index.cell_list,
                                       SLOT_SPEC.dims)
            np.testing.assert_allclose(solo.cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    assert not bool(_rows(got, 2).any())             # no live agent, no force


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 20, 18, 24), (3, 9, 7, 13)], ids=["vec", "scalar"])
def test_diffusion_one_launch_over_slots_equals_solo_launches(card, shape):
    g = torch.Generator(device=card).manual_seed(0)
    u = torch.rand(shape, generator=g, device=card) * 5
    u[1, 3, 4, 5] = float("nan")
    u[2] = 0.0
    before = d3_kernel.launches
    got = d3_kernel.diffusion_step_cuda(u, 0.1, 0.002)
    assert d3_kernel.launches == before + 1
    for b in range(shape[0]):
        _bits(got[b], d3_kernel.diffusion_step_cuda(u[b].contiguous(), 0.1, 0.002), b)
    _bits(got, diffusion_step_ref(u, 0.1, 0.002), "plain")
    assert bool(torch.isfinite(got[0]).all()) and not bool(got[2].any())


@pytest.mark.cuda
def test_pairwise_force_flat_candidates_equal_solo_launches(card):
    pools, flat = _slot_case(card)
    index = grid.build_index(SLOT_SPEC, flat)
    cand, mask = grid.candidate_neighbors_arrays(SLOT_SPEC, index, flat.position, flat.alive)
    got = pf_kernel.pairwise_force_cuda(flat.position, flat.radius(), cand, mask)
    for b, pool in enumerate(pools):
        solo_index = grid.build_index(SLOT_SPEC, pool)
        scand, smask = grid.candidate_neighbors_arrays(SLOT_SPEC, solo_index, pool.position,
                                                       pool.alive)
        _bits(_rows(got, b), pf_kernel.pairwise_force_cuda(pool.position, pool.radius(),
                                                           scand, smask), b)


@pytest.mark.cuda
@pytest.mark.parametrize("block,window", [(128, 2), (64, 40)], ids=["narrow", "allpairs"])
def test_cell_window_force_one_launch_over_slots_equals_solo_launches(card, block, window):
    """One launch over the 3 sessions (NaN positions in session 1, no live
    agent in session 2) is bit for bit 3 solo launches; each session against
    the plain version: the same non-finite rows (none: a NaN agent adds no
    force) and the rest within 1e-5."""
    pools, flat = _slot_case(card)
    index = grid.build_index(SLOT_SPEC, flat)
    assert int(index.cell_of_agent.max()) <= SLOT_SPEC.n_cells        # within-session ids
    before = cf_kernel.window_launches
    got = cf_kernel.cell_window_force_cuda(flat.position, flat.radius(), index.cell_of_agent,
                                           SLOT_SPEC.dims, block=block, half_window=window,
                                           slots=SLOTS)
    assert cf_kernel.window_launches == before + 1 and got.shape == (SLOTS * SLOT_ROWS, 3)
    for b, pool in enumerate(pools):
        cid = grid.build_index(SLOT_SPEC, pool).cell_of_agent
        solo = cf_kernel.cell_window_force_cuda(pool.position, pool.radius(), cid,
                                                SLOT_SPEC.dims, block=block,
                                                half_window=window)
        _bits(_rows(got, b), solo, b)
        want = cell_window_force_ref(pool.position, pool.radius(), cid, SLOT_SPEC.dims,
                                     block=block, half_window=window)
        assert torch.equal(torch.isfinite(solo), torch.isfinite(want)), b
        np.testing.assert_allclose(solo.cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    assert bool(torch.isfinite(got).all()) and not bool(_rows(got, 2).any())
    assert float(_rows(got, 0).abs().max()) > 0.1


@pytest.mark.cuda
def test_mixed_morton_gates_batched_step_on_card_equals_solo_steps(card):
    """The engine's force dispatch over one flat view on the card: the
    sorted session's window covers it, the shuffled one's does not, the
    third is empty.  One window launch and one linear launch for the three,
    and each session's forces equal its solo step's bit for bit."""
    from repro_torch.core import forces

    pools, flat, window = mixed_gate_pools(device=card)
    kw = dict(impl="fused", tile_order="morton", morton_block=MIXED_BLOCK,
              morton_window=window)
    params = forces.ForceParams()
    counts = lambda: (cf_kernel.window_launches, cf_kernel.launches)
    before = counts()
    got = forces.mechanical_forces(MIXED_SPEC, grid.build_index(MIXED_SPEC, flat), flat,
                                   params, **kw)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1)
    took = []
    for b, pool in enumerate(pools):
        before = counts()
        solo = forces.mechanical_forces(MIXED_SPEC, grid.build_index(MIXED_SPEC, pool), pool,
                                        params, **kw)
        took.append(tuple(a - c for a, c in zip(counts(), before)))
        _bits(got.reshape(3, -1, 3)[b], solo, b)
    assert took == [(1, 0), (0, 1), (1, 0)]
    assert float(got.abs().max()) > 0.1


@pytest.mark.cuda
def test_run_batch_on_card_equals_solo_card_runs(card):
    """The soma model with every kernel of the slice, 3 seeds in one batch:
    each slot bit-identical to its solo card run; one launch a step of
    cell_list_force and of diffusion3d per field, for all three slots."""
    built = _soma_sim("cuda").build()
    seeds = [1, 2, 3]
    counts = [m.launches for m in (cr_kernel, cf_kernel, d3_kernel)]
    finals, obs = built.run_batch(6, seeds=seeds)
    torch.cuda.synchronize()
    assert [m.launches - c for m, c in zip((cr_kernel, cf_kernel, d3_kernel), counts)] \
        == [6 + 1, 6, 12]
    eng = built.batched()
    for b, seed in enumerate(seeds):
        solo, solo_obs = built.run(6, state=eng.session_state(seed=seed))
        _assert_same_leaves(solo, tree_slot(finals, b))
        for k in solo_obs:
            _bits(solo_obs[k], obs[k][b], (b, k))
    # A slot whose budget ends mid-run is rolled back by a select each step
    # after it (its key included) and stays bit-frozen.
    bstate = eng.stack([eng.session_state(seed=1), eng.session_state(seed=2)],
                       budgets=[2, 6])
    bstate, _, _ = eng.run(bstate, 6)
    assert bstate.states.step.tolist() == [2, 6]
    solo, _ = built.run(2, state=eng.session_state(seed=1))
    _assert_same_leaves(solo, tree_slot(bstate.states, 0))


# ------------------------------------------------------------ checkpoints

def _leaves(tree):
    from repro_torch.checkpoint.checkpoint import _leaves_with_paths

    return dict(_leaves_with_paths(tree))


def _assert_same_leaves(a, b, device=None):
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        if device is not None:
            assert lb[k].device == device, k
        assert torch.equal(la[k].cpu(), lb[k].cpu()), k


@pytest.mark.cuda
def test_card_state_checkpoint_roundtrip(card, tmp_path):
    """A card state saved and restored into itself: every leaf equal, of the
    same dtype (the uint32 key too), back on the card."""
    from repro_torch import checkpoint

    state, _ = _soma_sim("cuda").build().run(3)
    checkpoint.save(str(tmp_path), 3, {"state": state})
    _, back = checkpoint.restore(str(tmp_path), {"state": state})
    assert back["state"].rng.dtype == torch.uint32
    _assert_same_leaves({"state": state}, back, device=card)


@pytest.mark.cuda
def test_resume_on_card_is_bit_exact(card, tmp_path):
    """8 steps straight == 4 steps + kill + resume + 4 on the card, bit for
    bit in state and series, with the three soma kernels in the resumed
    half."""

    class Die(Exception):
        pass

    def kill(state):
        if int(state.step) >= 4:
            raise Die

    straight, straight_obs = _soma_sim("cuda").run(8)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Die):
        _soma_sim("cuda").run(8, checkpoint_dir=d, checkpoint_every=4, on_chunk=kill)
    counts = [m.launches for m in (cr_kernel, cf_kernel, d3_kernel)]
    final, obs = _soma_sim("cuda").resume(d)
    torch.cuda.synchronize()
    assert all(m.launches > c for m, c in zip((cr_kernel, cf_kernel, d3_kernel), counts))
    _assert_same_leaves(straight, final, device=card)
    assert torch.equal(straight_obs["counts"], obs["counts"])


@pytest.mark.cuda
def test_card_checkpoint_restores_on_the_cpu(card, tmp_path):
    """A checkpoint the card wrote restores into a CPU ``like`` state, leaf
    for leaf equal and on the CPU."""
    d = str(tmp_path / "ckpt")
    final, _ = _soma_sim("cuda").run(4, checkpoint_dir=d, checkpoint_every=2)
    from repro_torch import checkpoint

    like = _soma_sim("cpu").build().state
    step, back = checkpoint.restore(d, {"state": like})
    assert step == 4
    _assert_same_leaves({"state": final}, back, device=CPU)


# ------------------------------------------- wrappers (run without a card)

def test_wrappers_refuse_cpu_tensors_and_bad_inputs():
    cid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cr_kernel.cell_rank_cuda(cid, 8)
    with pytest.raises(ValueError, match="int32"):
        cr_kernel.cell_rank_cuda(cid.long(), 8)
    pos, rad, index, spec, _ = _force_inputs("near_empty")
    with pytest.raises(ValueError, match="CUDA"):
        cf_kernel.cell_list_force_cuda(pos, rad, index.cell_list, spec.dims)
    with pytest.raises(ValueError, match="float32"):
        cf_kernel.cell_list_force_cuda(pos.double(), rad, index.cell_list, spec.dims)
    with pytest.raises(ValueError, match="rows"):
        cf_kernel.cell_list_force_cuda(pos, rad, index.cell_list, (1, 1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        cf_kernel.cell_window_force_cuda(pos, rad, index.cell_of_agent, spec.dims, block=4)
    with pytest.raises(ValueError, match="power of two"):
        cf_kernel.cell_window_force_cuda(pos, rad, index.cell_of_agent, spec.dims, block=6)
    with pytest.raises(ValueError, match="int32"):
        cf_kernel.cell_window_force_cuda(pos, rad, index.cell_of_agent.long(), spec.dims)
    with pytest.raises(ValueError, match="do not split into 3 slots"):
        cf_kernel.cell_window_force_cuda(pos, rad, index.cell_of_agent, spec.dims, slots=3)
    with pytest.raises(ValueError, match="do not split into 3 slots"):
        cf_ops.cell_window_force(pos, rad, index.cell_of_agent, spec.dims, slots=3)
    cand = torch.zeros((pos.shape[0], 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pf_kernel.pairwise_force_cuda(pos, rad, cand, cand > 0)
    with pytest.raises(ValueError, match="bool"):
        pf_kernel.pairwise_force_cuda(pos, rad, cand, cand)
    with pytest.raises(ValueError, match="S >= N"):
        pf_kernel.pairwise_force_cuda(pos, rad, cand, cand > 0, all_position=pos[:1],
                                      all_radius=rad[:1])
    with pytest.raises(ValueError, match="CUDA"):
        d3_kernel.diffusion_step_cuda(torch.zeros((2, 2, 2)), 0.1, 0.0)
    with pytest.raises(ValueError, match="float32"):
        d3_kernel.diffusion_step_cuda(torch.zeros((2, 2, 2), dtype=torch.float64), 0.1, 0.0)


def test_kernel_impls_on_cpu_tensors_take_the_plain_versions():
    counters = lambda: [m.launches for m in (cr_kernel, cf_kernel, d3_kernel, pf_kernel)] + [
        cf_kernel.window_launches]
    counts = counters()
    cid, n_cells = _cid_case("random")
    np.testing.assert_array_equal(cr_ops.cell_rank(cid, n_cells, impl="cuda").numpy(),
                                  cell_rank_ref(cid).numpy())
    pos, rad, index, spec, _ = _force_inputs("generic")
    np.testing.assert_array_equal(
        cf_ops.cell_list_force(pos, rad, index.cell_list, spec.dims, impl="cuda").numpy(),
        cell_list_force_ref(pos, rad, index.cell_list, spec.dims).numpy())
    u = torch.rand((5, 6, 7), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(d3_ops.diffusion_step(u, 0.1, 0.01, impl="cuda").numpy(),
                                  diffusion_step_ref(u, 0.1, 0.01).numpy())
    cid = index.cell_of_agent
    np.testing.assert_array_equal(
        cf_ops.cell_window_force(pos, rad, cid, spec.dims, block=32, window=3,
                                 impl="cuda").numpy(),
        cell_window_force_ref(pos, rad, cid, spec.dims, block=32, half_window=3).numpy())
    cand, mask = grid.candidate_neighbors_arrays(spec, index, pos, cid < spec.n_cells)
    np.testing.assert_array_equal(
        pf_ops.pairwise_force(pos, rad, cand, mask, impl="cuda").numpy(),
        pairwise_force_ref(pos, rad, cand, mask).numpy())
    assert counts == counters()


def test_lm_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    x = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.rmsnorm_cuda(x, torch.ones(8))
    with pytest.raises(ValueError, match=r"\(D,\)"):
        rms_kernel.rmsnorm_cuda(x, torch.ones(7))
    for bad in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            rms_kernel.rmsnorm_cuda(x.to(bad), torch.ones(8))
    q = torch.zeros((1, 4, 5, 16))
    kv = torch.zeros((1, 2, 5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.flash_attention_cuda(torch.zeros((1, 4, 5, 32)), torch.zeros((1, 2, 5, 32)),
                                       torch.zeros((1, 2, 5, 32)))
    with pytest.raises(ValueError, match="divide"):
        fa_kernel.flash_attention_cuda(q, torch.zeros((1, 3, 5, 16)), torch.zeros((1, 3, 5, 16)))
    with pytest.raises(ValueError, match="all bfloat16"):
        fa_kernel.flash_attention_cuda(q, kv.to(torch.bfloat16), kv)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention_cuda(torch.zeros((1, 4, 16, 5)).transpose(2, 3), kv, kv)


def test_lm_kernel_impls_on_cpu_tensors_take_the_plain_versions():
    counts = (rms_kernel.launches, fa_kernel.launches)
    g = torch.Generator().manual_seed(0)
    x, s = torch.randn((5, 3, 64), generator=g), torch.randn((64,), generator=g)
    np.testing.assert_array_equal(rms_ops.rmsnorm(x, s, impl="cuda").numpy(),
                                  rmsnorm_ref(x, s).numpy())
    q, k = torch.randn((1, 4, 9, 16), generator=g), torch.randn((1, 2, 9, 16), generator=g)
    np.testing.assert_array_equal(
        fa_ops.flash_attention(q, k, k, impl="cuda", block_k=4).numpy(),
        fa_ops.chunked_attention(q, k, k, block_k=4).numpy())
    assert counts == (rms_kernel.launches, fa_kernel.launches)


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True), (torch.bfloat16, 16, False),
    (torch.bfloat16, 256, True), (torch.float32, 64, False), (torch.float32, 128, False),
])
def test_flash_dispatch_rule(dtype, d, tc):
    """bf16 at D 64 / 128 / 256 goes to a tensor-core kernel, the rest to the
    SIMT one; each is built from its own source."""
    assert fa_kernel.uses_tensor_cores(dtype, d) == tc
    assert {"flash_attention", "flash_attention_wgmma",
            "flash_attention_wgmma_d256"} <= set(_build.SOURCES)
    if tc:
        assert fa_kernel.TC_KERNELS[d][0] in _build.SOURCES


def test_build_recipe():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-O3" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for name, src in _build.SOURCES.items():
        text = src.read_text()
        assert "Replaces: src/repro/kernels/" in text, name
        assert 'extern "C"' in text and "cudaGetLastError" in text, name
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


@pytest.mark.parametrize("case", ["generic", "overflowed", "full_row", "ghost_extended"])
def test_cell_list_rows_stop_at_first_sentinel(case):
    """The force kernel stops a row walk at its first sentinel, so the
    build must fill slots 0..min(count, M)-1 of each row and nothing else
    (``ghost_extended``: the distributed engine's halo-extended build over
    a rank's pool and its halo rows)."""
    if case == "ghost_extended":
        pos, _, index, spec, _ = _ghost_inputs()
        cap = pos.shape[0]
        assert int((index.cell_list >= 192).logical_and(index.cell_list < cap).sum()) > 0
    else:
        pos, _, index, spec, cap = _force_inputs(case)
    occupied = index.cell_list.numpy() < cap
    filled = np.minimum(index.cell_count.numpy(), spec.max_per_cell)
    np.testing.assert_array_equal(
        occupied, np.arange(spec.max_per_cell)[None, :] < filled[:, None])
    if case == "full_row":
        assert occupied.all() and not bool(index.overflowed)


# ------------------------------------------------------------------- run_jit
# The compiled run (core/runner.py) against the eager run on the card, bit
# for bit: every state leaf and every observable row.

def _jit_and_eager(built, steps, state=None, runs=2):
    """``(eager, [run_jit results], eager counts, [run_jit counts])``, the
    launch counters zeroed before and read after each run; the run_jit
    runs share the model's runner (the second replays the first's graphs)."""
    from repro_torch import kernels
    import torch_jit_cases as J

    def counted(fn):
        kernels.add_launches({k: -n for k, n in kernels.read_launches().items()})
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.read_launches()

    eager, eager_counts = counted(lambda: built.run(steps, state=state))
    jit = [counted(lambda: built.run_jit(steps, state=state)) for _ in range(runs)]
    for result, _ in jit:
        J.assert_runs_bit_equal(eager, result)
    return eager, [r for r, _ in jit], eager_counts, [c for _, c in jit]


@pytest.mark.cuda
def test_run_jit_soma_fused_equals_eager_on_card(card):
    import torch_jit_cases as J

    built = J.soma(card, n=4000, space=200.0, res=40).build()
    _, _, eager, jit = _jit_and_eager(built, 20)
    stats = built._jitted.stats
    assert stats["graphs"] >= 2 and stats["replays"] >= 2 * 16 and stats["rollbacks"] == 0
    assert eager["cell_list_force"] == 20 and eager["diffusion3d"] == 40
    assert jit == [eager, eager]


@pytest.mark.cuda
def test_run_jit_launch_counters_after_replay_equal_eager(card):
    """Each graph's launches are counted at each replay, not at capture:
    the counters after a run_jit equal the eager run's, kernel by kernel."""
    import torch_jit_cases as J

    built = J.soma(card, n=1000, space=100.0, res=20, sort_frequency=4).build()
    _, _, eager, jit = _jit_and_eager(built, 9, runs=1)
    assert built._jitted.stats["replays"] >= 5
    assert eager["cell_rank"] == 9 + 3 and jit == [eager]


@pytest.mark.cuda
def test_run_jit_morton_spheroid_rolls_back_on_card(card):
    """A Morton spheroid whose window covers it until 97 rows are stacked in
    one box in step 5: from step 6 the coverage gate fails, the chunk rolls
    back, and the run takes the window kernel before and the linear kernel
    after, bit for bit the eager run."""
    import torch_jit_cases as J

    built, state = J.spheroid(card, crowd_at=5, impl="fused", tile_order="morton",
                              morton_window=4096 // 128 - 1, overflow_fallback=False)
    _, _, eager, jit = _jit_and_eager(built, 10, state=state)
    assert built._jitted.stats["rollbacks"] >= 1
    assert eager["cell_window_force"] == 6 and eager["cell_list_force"] == 4
    for counts in jit:
        assert counts["cell_window_force"] >= 6 and counts["cell_list_force"] >= 4


@pytest.mark.cuda
def test_run_jit_spheroid_dense_equals_eager_on_card(card):
    import torch_jit_cases as J

    built, state = J.spheroid(card, impl="cuda")
    _, _, eager, jit = _jit_and_eager(built, 6, state=state)
    assert eager["pairwise_force"] == 6 and jit == [eager, eager]


@pytest.mark.cuda
def test_run_jit_raises_when_an_op_reads_the_card(card):
    """A custom op that reads the device cannot be captured: run_jit raises
    a ValueError naming it instead of freezing the value it read."""
    import torch_jit_cases as J

    def reads(ctx, state):
        if int(state.pool.alive.sum()) < 0:
            raise AssertionError
        return state

    built = J.soma(card).op(reads, name="reads", phase="post").build()
    built.run(2)
    with pytest.raises(ValueError, match="op 'reads'"):
        built.run_jit(3)
    torch.cuda.synchronize()
    built.run(2)              # the card is still usable


@pytest.mark.cuda
def test_kernels_stay_in_bounds_on_a_thrown_away_state(card):
    """A captured step after a divergence is computed and thrown away; the
    kernels on its path must not fault on what it feeds them: an overflowed
    cell list, an uncovered Morton window, cell ids below 0 and at or above
    n_cells."""
    pos, rad, index, spec, _ = _force_inputs("overflowed")
    assert bool(index.overflowed)
    out = cf_ops.cell_list_force(pos.to(card), rad.to(card), index.cell_list.to(card),
                                 spec.dims, impl="cuda")
    cid = index.cell_of_agent.clone()
    cid[::7] = -5
    cid[1::7] = spec.n_cells + 3
    win = cf_kernel.cell_window_force_cuda(pos.to(card), rad.to(card), cid.to(card),
                                           spec.dims, block=16, half_window=0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(win).all())


# ------------------------------------------------------------- batch run_jit
# The batch engine's compiled run (BatchedSimulation.run_jit) against its
# eager run on the card, bit for bit: every leaf of every slot, every
# observable row and count, and the launches.

def _batch_jit_and_eager(eng, bstate, steps, runs=2):
    """``(eager counts, [run_jit counts])`` of an eager batched run and
    ``runs`` run_jit runs from ``bstate``, each bit-identical to the eager
    run; the run_jit runs share the batch's runner."""
    from repro_torch import kernels
    import torch_jit_cases as J

    def counted(fn):
        kernels.add_launches({k: -n for k, n in kernels.read_launches().items()})
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.read_launches()

    (ef, eo, ec), eager_counts = counted(lambda: eng.run(bstate, steps))
    jit = [counted(lambda: eng.run_jit(bstate, steps)) for _ in range(runs)]
    for (f, o, c), _ in jit:
        J.assert_runs_bit_equal((ef, eo), (f, o))
        assert {k: v.tolist() for k, v in c.items()} == {k: v.tolist() for k, v in ec.items()}
    return eager_counts, [c for _, c in jit]


@pytest.mark.cuda
def test_batch_run_jit_sweep_equals_eager_on_card(card):
    """3 soma sessions (a custom op and two observables run once a session,
    kind counts batched, a per-slot field), 12 steps: the compiled run's
    launches are the eager run's, and its second run starts warm."""
    import torch_jit_cases as J

    built = J.soma(card, n=4000, space=200.0, res=40).build()
    eng = built.batched()
    bstate = eng.sweep_state(seeds=[1, 2, 3], params={
        "substance:substance_1": np.array([0.0, 1.0, 2.0], np.float32)})
    eager, jit = _batch_jit_and_eager(eng, bstate, 12)
    stats = eng._jitted.stats
    assert stats["rollbacks"] == 0 and stats["warm_starts"] == 1
    assert stats["replays"] + stats["eager_steps"] == 24 and stats["replays"] >= 12 + 8
    assert eager["cell_list_force"] == 12 and eager["diffusion3d"] == 24
    assert jit == [eager, eager]


@pytest.mark.cuda
def test_batch_run_jit_one_slot_rolls_back_on_card(card):
    """A Morton spheroid batch: session 0 crowded from step 5 (its gate
    fails from step 6), session 1 crowded from its first step.  The window
    branch speculated for session 0 rolls back; bit-identical to the eager
    batch, and the launches less the thrown-away replays' are its."""
    import torch_jit_cases as J

    built, state = J.spheroid(card, crowd_at=5, impl="fused", tile_order="morton",
                              morton_window=4096 // 128 - 1, overflow_fallback=False)
    ahead = J.crowd_op(97, 5, 0.0)(None, dataclasses.replace(
        state, step=torch.full_like(state.step, 100)))
    eng = built.batched()
    eager, (jit,) = _batch_jit_and_eager(eng, eng.stack([state, ahead]), 10, runs=1)
    runner = eng._jitted
    assert runner.stats["rollbacks"] >= 1
    assert eager["cell_window_force"] == 6 and eager["cell_list_force"] == 10
    assert {k: v - runner.rolled_back_launches[k] for k, v in jit.items()} == eager


@pytest.mark.cuda
def test_batch_run_jit_raises_when_an_op_reads_the_card(card):
    """A custom op that reads the device cannot be captured in a batch's
    step either: run_jit raises CaptureError naming it."""
    import torch_jit_cases as J
    from repro_torch.core.schedule import CaptureError

    def reads(ctx, state):
        if int(state.pool.alive.sum()) < 0:
            raise AssertionError
        return state

    built = J.soma(card).op(reads, name="reads", phase="post").build()
    eng = built.batched()
    bstate = eng.sweep_state(seeds=[1, 2])
    eng.run(bstate, 2)
    with pytest.raises(CaptureError, match="op 'reads'"):
        eng.run_jit(bstate, 3)
    torch.cuda.synchronize()
    eng.run(bstate, 2)              # the card is still usable


# ------------------------------------------------------- distributed run_jit
# The distributed engine's compiled run (DistributedSimulation.run_jit): the
# lock-step step of the 4 ranks of a 2x2 mesh on the card, replayed from CUDA
# graphs, against the eager run: every leaf of the stacked state, every
# observable row and the launches.

def _dist_jit_and_eager(dsim, steps, runs=2):
    """``(eager counts, [run_jit counts])`` of an eager distributed run and
    ``runs`` run_jit runs from the built state, each bit-identical to the
    eager run; the run_jit runs share the deployment's runner."""
    from repro_torch import kernels
    import torch_jit_cases as J

    def counted(fn):
        kernels.add_launches({k: -n for k, n in kernels.read_launches().items()})
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.read_launches()

    eager, eager_counts = counted(lambda: dsim.run(steps))
    jit = [counted(lambda: dsim.run_jit(steps)) for _ in range(runs)]
    for result, _ in jit:
        J.assert_runs_bit_equal(eager, result)
    return eager_counts, [c for _, c in jit]


@pytest.mark.cuda
def test_dist_run_jit_soma_equals_eager_on_card(card):
    """The soma model (cell_rank, the fused force over ghost-extended
    sources, diffusion) on 4 ranks, 10 steps: the replayed run's state,
    series and launches are the eager run's, and its second run starts
    warm."""
    import torch_jit_cases as J

    dsim = J.dist_soma(card)
    eager, jit = _dist_jit_and_eager(dsim, 10)
    stats = dsim._jitted.stats
    assert stats["rollbacks"] == 0 and stats["warm_starts"] == 1
    assert stats["replays"] + stats["eager_steps"] == 20 and stats["replays"] >= 10 + 6
    assert eager["cell_list_force"] == 40 and eager["cell_rank"] >= 40
    assert jit == [eager, eager]


@pytest.mark.cuda
def test_dist_run_jit_one_rank_rolls_back_on_card(card):
    """Rank 0's cell overflows from step 4 (torch_jit_cases.dist_crowd): the
    speculated branch rolls back, the run stays bit-identical, and the
    launches less the thrown-away replays' are the eager run's."""
    import torch_jit_cases as J

    dsim = J.dist_crowd(card)
    eager, (jit,) = _dist_jit_and_eager(dsim, 10, runs=1)
    runner = dsim._jitted
    assert runner.stats["rollbacks"] >= 1
    assert {k: v - runner.rolled_back_launches[k] for k, v in jit.items()} == eager
    keys = [dict(key[1]) for key in runner._graphs]
    assert {key["rank0/overflowed"] for key in keys} == {False, True}
    assert all(not key[f"rank{r}/overflowed"] for key in keys for r in (1, 2, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_dist_lanes_equal_one_stream_on_card(card, overlap, monkeypatch):
    """The small soma model on 4 ranks, serial and overlapped: its eager
    and run_jit runs with every rank on its own lanes (distinct streams)
    are bit-identical to the same runs with every lane on the current
    stream (the lane factory patched to make no stream)."""
    import torch_jit_cases as J
    from repro_torch.core import lanes

    def runs():
        dsim = J.dist_soma(card, overlap=overlap)
        eager = dsim.run(8)
        jit = dsim.run_jit(8)
        torch.cuda.synchronize()
        J.assert_runs_bit_equal(eager, jit)
        return dsim, eager, jit

    dsim, eager, jit = runs()
    streams = [lane.stream.cuda_stream for lane in lanes.lanes_for(dsim.step.mesh).all()]
    assert len(streams) == 8 and len(set(streams)) == 8
    assert torch.cuda.current_stream(card).cuda_stream not in streams
    monkeypatch.setattr(lanes, "_SETS", {})
    monkeypatch.setattr(lanes, "make_stream", lambda device: None)
    one, eager1, jit1 = runs()
    assert all(lane.stream is None for lane in lanes.lanes_for(one.step.mesh).all())
    J.assert_runs_bit_equal(eager, eager1)
    J.assert_runs_bit_equal(jit, jit1)


@pytest.mark.cuda
def test_dist_run_jit_raises_when_an_op_reads_the_card(card):
    """A custom op of a distributed model that reads the card cannot be
    captured: run_jit raises CaptureError naming it."""
    import torch_jit_cases as J
    from repro_torch.core import distributed as dist
    from repro_torch.core.schedule import CaptureError
    from repro_torch.launch.mesh import make_mesh

    def reads(ctx, state):
        if int(state.pool.alive.sum()) < 0:
            raise AssertionError
        return state

    sim = J.soma(card, n=1000, space=100.0, res=20).op(reads, name="reads", phase="post")
    dcfg = dist.DomainConfig(mesh_axes=("x", "y"), axis_sizes=(2, 2), extent=50.0,
                             halo_width=10.0, halo_capacity=512, migrate_capacity=256,
                             depth=100.0)
    dsim = sim.distribute(make_mesh((2, 2), ("x", "y"), devices=card), dcfg)
    dsim.run(2)
    with pytest.raises(CaptureError, match="op 'reads'"):
        dsim.run_jit(3)
    torch.cuda.synchronize()
    dsim.run(2)              # the card is still usable


# ------------------------------------------------------- spans and op maps

def _trace_model(card, name):
    """A small model of each benchmark configuration's kind: the soma tissue
    (sorted every 4 steps), the Morton spheroid, and the soma tissue batched
    over 3 slots; returns ``(runner of run, run(n), state)``."""
    import torch_jit_cases as J

    if name == "spheroid":
        built, state = J.spheroid(card, impl="fused", tile_order="morton",
                                  morton_window=4096 // 128 - 1)
    else:
        built = J.soma(card, n=4000, space=200.0, res=40, sort_frequency=4).build()
        state = built.state
    if name == "batch":
        eng = built.batched()
        return eng._jitted, lambda n, s: eng.run_jit(s, n), eng.sweep_state(batch=3)
    return built._jitted, lambda n, s: built.run_jit(n, state=s), state


def _layout(runner):
    (lay,) = runner._layouts.values()
    return lay


class _EndCount:
    """In ``spans.mapping``'s place: the graph's nodes counted once, at the
    end of its capture."""

    def __init__(self, count):
        self.count, self.entries = count, None

    def __enter__(self):
        return self

    def __exit__(self, kind, err, tb):
        if kind is None:
            self.entries = [("all", self.count())]
        return False


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_events(prof):
    """``(name, start µs, end µs)`` of the trace's device events, as the
    benchmark's harness reads them."""
    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["soma", "spheroid", "batch"])
def test_op_maps_count_every_graph_node_and_leave_the_graphs_alone(card, model, monkeypatch):
    """Each graph's op map sums to the kernel, memset and memcpy nodes that a
    runner recording no op map counts at the end of the same key's capture."""
    from repro_torch.core import spans

    runner, run, state = _trace_model(card, model)
    run(8, state)
    maps = _layout(runner).op_maps
    assert maps and all(m for m in maps.values())
    sums = {k: sum(n for _, n in m) for k, m in maps.items()}
    other, run, state = _trace_model(card, model)
    monkeypatch.setattr(spans, "mapping", _EndCount)
    run(8, state)
    assert {k: m[0][1] for k, m in _layout(other).op_maps.items()} == sums
    assert min(sums.values()) > 0


# The spans' name prefixes (a profiler may show a span on the device's
# timeline too, around the kernels launched in it).
SPAN_KINDS = ("op.", "observe.", "runner.", "facade.", "batch.")


def _eager_events_by_span(prof) -> dict:
    """Device events of an eager step by the ``op.`` / ``observe.`` span in
    which their launch ran (``record`` outside one), through the profiler's
    correlation of each device event with its launch."""
    import collections

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != cuda and e.name().startswith("cu")}
    named = [(e.start_ns(), e.end_ns(), e.name()) for e in events if e.device_type() != cuda
             and e.name().startswith(("op.", "observe."))]
    out = collections.Counter()
    for e in events:
        if e.device_type() != cuda or e.name().startswith(SPAN_KINDS):
            continue
        t = launch[e.correlation_id()]
        inside = [(s, n) for s, end, n in named if s <= t <= end]
        out[max(inside)[1] if inside else "record"] += 1
    return dict(out)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["soma", "spheroid"])
def test_each_op_map_segment_is_its_eager_step_under_the_profiler(card, model, monkeypatch):
    """The step of each captured key, run eagerly under the profiler with the
    same branches: its device events grouped by the op span that launched
    them are the op map's segments."""
    import collections

    from repro_torch.core.forces import Branches

    runner, run, state = _trace_model(card, model)
    keys = {}
    real = runner._capture

    def capture(lay, key, host, live):
        keys[key] = (host, live)
        return real(lay, key, host, live)

    monkeypatch.setattr(runner, "_capture", capture)
    run(8, state)
    lay = _layout(runner)
    assert keys and set(keys) == set(lay.op_maps)
    for key, (host, live) in keys.items():
        want = collections.Counter()
        for name, n in lay.op_maps[key]:
            want[name] += n
        lay.start.copy_(lay.static.step)

        def step():
            with runner._on_stream(lay):
                runner._step(lay, host, live, Branches(dict(key[1]), lay.diverged))

        got = _eager_events_by_span(_profiled(step))
        assert got == {k: v for k, v in want.items() if v}, key


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["soma", "spheroid", "batch"])
def test_a_profiled_run_of_replays_is_fully_attributed(card, model):
    """Under the profiler each replay is preceded by one marker and logged
    with its op map, and the chunk's last replay is followed by one more,
    logged as ``CLOSE``: between a replay's marker and the next lie exactly
    its op map's nodes, and every other event lies before the first marker
    or after a closing one.  A run without the profiler logs nothing, and
    the next profiled run's log starts anew."""
    from repro_torch.core import spans

    runner, run, state = _trace_model(card, model)
    run(8, state)
    before = dict(runner.stats)
    events = sorted(_device_events(_profiled(lambda: run(8, state))), key=lambda e: e[1:])
    replays = runner.stats["replays"] - before["replays"]
    assert runner.stats["eager_steps"] == before["eager_steps"] and replays == 8
    log = list(spans.LOG)
    assert len(log) == replays + 1 and log[-1] == spans.CLOSE
    assert all(isinstance(e, tuple) and e for e in log[:-1])
    marks = [i for i, (n, _, _) in enumerate(events) if spans.MARKER in n]
    assert len(marks) == len(log)
    for j, entry in enumerate(log[:-1]):
        assert marks[j + 1] - marks[j] - 1 == sum(n for _, n in entry)
    assert len(events) - marks[-1] - 1 > 0
    run(8, state)
    torch.cuda.synchronize()
    assert spans.LOG == log
    _profiled(lambda: run(2, state))
    assert len(spans.LOG) == 3 and spans.LOG[-1] == spans.CLOSE
