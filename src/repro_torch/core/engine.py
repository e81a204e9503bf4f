"""The simulation engine: Algorithm 8 stepped eagerly or replayed.

Port of ``repro.core.engine``.  :func:`simulation_step` is
``Scheduler.default(config).step``; :func:`run` loops it in Python (the
reference's ``lax.scan``) and records observables.  :func:`run_jit` is the
counterpart of the reference's ``jax.jit(run)``: the step captured in CUDA
graphs and replayed by a :class:`~repro_torch.core.runner.Runner`
(``core/runner.py``), bit for bit :func:`run`'s results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import diffusion as dgrid
from . import prng
from . import runner as _runner
from .agents import AgentPool
from .behaviors import Behavior
from .forces import ForceParams, check_impl
from .grid import GridSpec
from .schedule import HealthReport, Scheduler, empty_health

BOUNDARIES = ("open", "closed", "toroidal")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration.

    ``force_impl``: "reference" | "cuda" (the pairwise_force kernel, the
    reference's "pallas") | "fused" (the cell-list kernel);
    ``diffusion_impl``: "reference" | "cuda" (the stencil kernel).
    ``tile_order="morton"`` (fused only) runs the Morton-window kernel over
    the layout-sorted pool, guarded per step by a coverage check that falls
    back to the linear kernel (``morton_window_fallback``); block and window
    default per pool size (``kernels.cell_force.ops.window_defaults``, whose
    default window does not cover a Z-sorted pool).  The reference's
    ``kernel_interpret`` has no counterpart.
    """

    spec: GridSpec
    behaviors: Tuple[Behavior, ...] = ()
    force_params: Optional[ForceParams] = None       # None → no mechanics op
    dt: float = 1.0
    min_bound: float = 0.0
    max_bound: float = 100.0
    boundary: str = "open"                           # open | closed | toroidal
    sort_frequency: int = 16                         # §5.4.2 / Fig 5.14
    diffusion_frequency: int = 1                     # §4.4.4 multi-scale
    active_capacity: Optional[int] = None            # §5.5 work compaction
    force_tile: Optional[int] = None                 # tile-wise dense force eval
    force_impl: str = "reference"
    diffusion_impl: str = "reference"
    # "fused" only: fall back to the dense candidate path when a cell
    # overflows max_per_cell (the cell list dropped agents).
    fused_overflow_fallback: bool = True
    tile_order: str = "linear"                       # linear | morton
    morton_block: Optional[int] = None
    morton_window: Optional[int] = None
    morton_window_fallback: bool = True
    health_frequency: int = 1

    def __post_init__(self):
        check_impl(self.force_impl, self.tile_order)
        if self.diffusion_impl not in dgrid.IMPLS:
            raise ValueError(f"unknown diffusion_impl {self.diffusion_impl!r}; "
                             f"expected {dgrid.IMPLS}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary {self.boundary!r}; expected {BOUNDARIES}")


@dataclasses.dataclass(frozen=True)
class SimulationState:
    pool: AgentPool
    grids: Dict[str, dgrid.DiffusionGrid]
    rng: torch.Tensor        # (2,) uint32 key data
    step: torch.Tensor       # () int32 iteration counter
    health: HealthReport


def init_state(pool: AgentPool, grids: Optional[Dict[str, dgrid.DiffusionGrid]] = None,
               seed: int = 0) -> SimulationState:
    dev = pool.device
    return SimulationState(
        pool=pool,
        grids=dict(grids or {}),
        rng=prng.PRNGKey(seed, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        health=empty_health(dev),
    )


def simulation_step(config: EngineConfig, state: SimulationState) -> SimulationState:
    """One iteration of Algorithm 8 (the default schedule)."""
    return Scheduler.default(config).step(state)


def _stack(rows):
    """Stack a list of per-step outputs (tensors or dicts of tensors)."""
    if isinstance(rows[0], dict):
        return {k: _stack([r[k] for r in rows]) for k in rows[0]}
    return torch.stack(rows)


def run(
    config: EngineConfig,
    state: SimulationState,
    n_steps: int,
    collect: Optional[Callable] = None,
    scheduler: Optional[Scheduler] = None,
    observables: Optional[Tuple[Tuple[str, Callable, int], ...]] = None,
):
    """Run ``n_steps`` iterations → ``(final_state, outs)``.

    ``collect(state)`` records every post-step state; ``observables`` is a
    tuple of ``(name, fn, frequency)``: ``fn`` is evaluated on the post-step
    state of iterations whose pre-increment counter is ``≡ 0 (mod k)``.
    Frequency-1 series have one row per step; frequency-k ones come in a
    ``⌈n/k⌉``-row buffer whose rows beyond the window's firings stay zero
    (the facade slices them off).  ``outs`` is a dict by name, ``collect``'s
    stacked rows, or ``n_steps`` zeros when neither is given.
    """
    if collect is not None and observables:
        raise ValueError("pass either collect= or observables=, not both")
    step_fn = (scheduler or Scheduler.default(config)).step

    obs = tuple(observables or ())
    names = [n for n, _, _ in obs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate observable names in {names}")
    streamed = tuple((n, f) for n, f, k in obs if k == 1)
    gated = tuple((n, f, k) for n, f, k in obs if k > 1)

    start = int(state.step)
    rows: Dict[str, list] = {name: [] for name, _ in streamed}
    fired: Dict[str, list] = {name: [] for name, _, _ in gated}
    collected = []
    for i in range(n_steps):
        state = step_fn(state)
        for name, fn in streamed:
            rows[name].append(fn(state))
        for name, fn, k in gated:
            if (start + i) % k == 0:
                fired[name].append(fn(state))
        if collect is not None:
            collected.append(collect(state))

    if collect is not None:
        outs = _stack(collected) if collected else {}
        return state, outs
    if not obs:
        return state, torch.zeros((n_steps,), dtype=torch.int32,
                                  device=state.pool.device)
    outs = {name: _stack(r) if r else None for name, r in rows.items()}
    for name, fn, k in gated:
        r = fired[name]
        proto = r[0] if r else fn(state)
        buf = torch.zeros((-(-n_steps // k),) + tuple(proto.shape),
                          dtype=proto.dtype, device=proto.device)
        if r:
            buf[: len(r)] = torch.stack(r)
        outs[name] = buf
    for name, fn in streamed:
        if outs[name] is None:
            proto = fn(state)
            outs[name] = torch.zeros((0,) + tuple(proto.shape), dtype=proto.dtype,
                                     device=proto.device)
    return state, outs


def jitted_runner(config: EngineConfig, scheduler: Optional[Scheduler] = None
                  ) -> _runner.Runner:
    """A reusable compiled runner for one (config, scheduler), holding its
    CUDA graphs: ``runner(state, n_steps, collect=, observables=)``.

    Each :func:`run_jit` call makes a fresh one (its graphs die with it —
    the right lifetime for one-shot runs); callers that drive an evolving
    state in chunks hold one instead, as ``BuiltSimulation.run_jit`` does.
    """
    return _runner.Runner(config, scheduler)


def run_jit(config: EngineConfig, state: SimulationState, n_steps: int,
            collect=None, scheduler: Optional[Scheduler] = None, observables=None):
    """:func:`run` through a fresh :func:`jitted_runner`: the same
    ``(final_state, outs)``, bit for bit, with the step replayed from CUDA
    graphs on the card."""
    return jitted_runner(config, scheduler)(state, n_steps, collect=collect,
                                            observables=observables)


def derive_n_kinds(kind: torch.Tensor) -> int:
    """``max(kind) + 1`` — the derivation used by kind-count observables.
    Raises inside a compiled run (on either device), as the reference raises
    under a trace: the count sizes an output, and reading it would read the
    device inside the captured step."""
    if _runner.running():
        raise ValueError(
            "deriving n_kinds under run_jit is impossible (the output shape must be "
            "static) — pass n_kinds= explicitly")
    return int(kind.max()) + 1 if kind.numel() else 1


def count_kinds(state, n_kinds: Optional[int] = None) -> torch.Tensor:
    """Per-kind alive counts — the SIR observable of Fig 4.17."""
    kind = state.pool.kind.reshape(-1)
    alive = state.pool.alive.reshape(-1)
    if n_kinds is None:
        n_kinds = derive_n_kinds(kind)
    ks = torch.arange(n_kinds, device=kind.device)
    onehot = (kind[:, None] == ks[None, :]) & alive[:, None]
    return onehot.sum(dim=0, dtype=torch.int32)
