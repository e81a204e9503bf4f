"""The model API: one declarative description builds the engine (§4.4).

Port of the single-node surface of ``repro.core.api``:

    sim = (Simulation(space=(0, 100), cell_size=10.0, boundary="closed")
           .add_agents(600, position=pos, diameter=5.0, kind=kinds, exposure=0.0)
           .add_substance("attractant", diffusion=4.0, decay=0.002, resolution=20)
           .use(secretion("attractant", 1.0), chemotaxis("attractant", 0.75))
           .mechanics(ForceParams(), impl="fused", diffusion_impl="cuda")
           .observe("counts", my_counts_fn, frequency=4))
    final, obs = sim.run(300)

``build()`` returns the ``(EngineConfig, Scheduler, SimulationState)``
triple through the same primitives a hand-wired pipeline uses.  The port
adds two arguments: ``device`` (the card unless ``"cpu"`` is asked for) and
``rank_impl``, which reaches ``spec_for_space`` (the reference's facade
cannot select it).

Checkpointed runs are the reference's: ``run(n, checkpoint_dir=d,
checkpoint_every=k)`` persists the full run (state and observable rows) every
``k`` steps in the reference's on-disk format, and ``Simulation.resume(d)``
finishes a killed run bit for bit; a checkpoint written by either package
resumes in the other.  ``BuiltSimulation.batched()`` is the many-session
engine (``core/batch.py``) and ``run_batch`` sweeps B variants through it,
slot b bit-identical to a solo run of its variant.  ``distribute(mesh,
dcfg)`` deploys the same description on the distributed engine
(``core/distributed.py``) over an in-process mesh or a mesh of one process
a rank (``launch/mesh.py``); its grid build takes the facade's
``rank_impl``, where the reference's takes the default.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import checkpoint as _ckpt
from ..device import resolve_device
from . import diffusion as dgrid
from . import engine as _engine
from .agents import as_tensor, attr_signature, canonicalize_attr, check_attr_schema, make_pool
from .behaviors import Behavior
from .engine import EngineConfig, SimulationState, init_state
from .forces import ForceParams
from .grid import spec_for_space
from .schedule import Operation, Scheduler
from .slots import tree_map
from .spans import span

# Pool fields that are not free-form attrs (have dedicated arguments).
_RESERVED_ATTRS = ("position", "diameter", "kind", "age", "alive", "static",
                   "overflow")


@dataclasses.dataclass(frozen=True)
class _AgentGroup:
    n: int
    position: torch.Tensor   # (n, 3) f32
    diameter: torch.Tensor   # (n,) f32
    kind: torch.Tensor       # (n,) i32
    attrs: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Observable:
    """A recorded time series: ``fn(state)`` on the post-step state of every
    iteration whose pre-increment counter is ``≡ 0 (mod frequency)``;
    ``frequency=0`` disables it."""

    name: str
    fn: Callable[[Any], torch.Tensor]
    frequency: int = 1


@dataclasses.dataclass(frozen=True)
class _CustomOp:
    op: Operation
    before: Optional[str] = None
    after: Optional[str] = None
    replaces: Optional[str] = None


class Simulation:
    """Declarative model builder.  Registration methods return ``self``;
    ``build()`` freezes the description into a :class:`BuiltSimulation`.

    space:       extent (``100.0`` means ``[0, 100]``) or ``(min, max)``.
    cell_size:   neighbor-grid box size; defaults to the largest diameter.
    boundary:    "open" | "closed" | "toroidal".
    capacity:    pool capacity; defaults to the registered population.
    rank_impl:   within-cell ranking of the grid: "tiled" | "cuda" |
                 "reference".
    device:      where the state lives: ``None``/"cuda" (the card; raises
                 without one) or "cpu".
    dt, max_per_cell, seed, sort_frequency, diffusion_frequency, use_morton:
                 as in EngineConfig / GridSpec.
    """

    def __init__(
        self,
        space,
        cell_size: Optional[float] = None,
        boundary: str = "open",
        dt: float = 1.0,
        capacity: Optional[int] = None,
        max_per_cell: int = 16,
        seed: int = 0,
        sort_frequency: int = 16,
        diffusion_frequency: int = 1,
        use_morton: bool = True,
        rank_impl: str = "tiled",
        device: str | torch.device | None = None,
    ):
        if np.ndim(space) == 0:
            lo, hi = 0.0, float(space)
        else:
            lo, hi = float(space[0]), float(space[1])
        if not hi > lo:
            raise ValueError(f"space must have max > min, got ({lo}, {hi})")
        if boundary not in _engine.BOUNDARIES:
            raise ValueError(f"unknown boundary {boundary!r}")
        self.device = resolve_device(device)
        self.min_bound, self.max_bound = lo, hi
        self.cell_size = None if cell_size is None else float(cell_size)
        self.boundary = boundary
        self.dt = float(dt)
        self.capacity = capacity
        self.max_per_cell = int(max_per_cell)
        self.seed = int(seed)
        self.sort_frequency = int(sort_frequency)
        self.diffusion_frequency = int(diffusion_frequency)
        self.use_morton = bool(use_morton)
        self.rank_impl = rank_impl

        self._groups: List[_AgentGroup] = []
        self._attr_schema: Dict[str, tuple] = {}
        self._grids: Dict[str, dgrid.DiffusionGrid] = {}
        self._behaviors: List[Behavior] = []
        self._force_params: Optional[ForceParams] = None
        self._force_opts: Dict[str, Any] = {}
        self._custom_ops: List[_CustomOp] = []
        self._observables: List[Observable] = []

    # ------------------------------------------------------------ agents

    def add_agents(self, n: Optional[int] = None, *, position, diameter=10.0,
                   kind=0, **attrs) -> "Simulation":
        """Register a group of agents; groups share one validated SoA attr
        schema.  ``diameter`` / ``kind`` / ``**attrs`` are scalars
        (broadcast) or per-agent with ``n`` rows."""
        dev = self.device
        position = as_tensor(position, dev, torch.float32)
        if position.ndim != 2 or position.shape[1] != 3:
            raise ValueError(f"position must be (n, 3), got shape {tuple(position.shape)}")
        n_here = int(position.shape[0])
        if n is not None and int(n) != n_here:
            raise ValueError(f"n={n} but position has {n_here} rows")
        if n_here:
            pmin, pmax = float(position.min()), float(position.max())
            if pmin < self.min_bound or pmax > self.max_bound:
                raise ValueError(
                    f"positions outside the declared space "
                    f"[{self.min_bound}, {self.max_bound}]: range [{pmin:.3g}, {pmax:.3g}]"
                )
        diam = canonicalize_attr("diameter", diameter, n_here, dev).to(torch.float32)
        kind_arr = canonicalize_attr("kind", kind, n_here, dev)
        if kind_arr.is_floating_point() or kind_arr.dtype == torch.bool:
            raise TypeError(f"kind must be integer, got dtype {kind_arr.dtype}")
        kind_arr = kind_arr.to(torch.int32)

        group_attrs: Dict[str, torch.Tensor] = {}
        for name, value in attrs.items():
            if name in _RESERVED_ATTRS:
                raise ValueError(f"attr {name!r} is a built-in pool field — pass it "
                                 f"via its dedicated argument")
            arr = canonicalize_attr(name, value, n_here, dev)
            if name in self._attr_schema:
                check_attr_schema(name, arr, self._attr_schema)
            group_attrs[name] = arr
        missing = set(self._attr_schema) - set(group_attrs)
        extra = set(group_attrs) - set(self._attr_schema) if self._groups else set()
        if missing or extra:
            raise ValueError(
                f"agent groups must share one attr schema: missing "
                f"{sorted(missing)}, new {sorted(extra)} "
                f"(schema so far: {sorted(self._attr_schema)})"
            )
        for name, arr in group_attrs.items():
            self._attr_schema.setdefault(name, attr_signature(arr))

        if self.capacity is not None:
            n_before = sum(g.n for g in self._groups)
            if n_before + n_here > int(self.capacity):
                raise ValueError(
                    f"add_agents: group of {n_here} agents would bring the "
                    f"registered population to {n_before + n_here}, beyond the "
                    f"declared capacity {int(self.capacity)} ({n_before} already "
                    f"registered)"
                )
        self._groups.append(_AgentGroup(n=n_here, position=position, diameter=diam,
                                        kind=kind_arr, attrs=group_attrs))
        return self

    # -------------------------------------------------------- substances

    def add_substance(self, name: str, diffusion: float, decay: float = 0.0,
                      resolution: int = 32, concentration=None) -> "Simulation":
        """Register an extracellular substance (Eq 4.3) on a ``resolution³``
        grid over the declared space; ``concentration`` sets the initial field."""
        if name in self._grids:
            raise ValueError(f"substance {name!r} already registered")
        grid = dgrid.make_grid(self.min_bound, self.max_bound, int(resolution),
                               diffusion_coefficient=float(diffusion),
                               decay_constant=float(decay), device=self.device)
        if concentration is not None:
            conc = as_tensor(concentration, self.device, torch.float32)
            if tuple(conc.shape) != grid.resolution:
                raise ValueError(f"substance {name!r}: concentration shape "
                                 f"{tuple(conc.shape)} != grid {grid.resolution}")
            grid = dataclasses.replace(grid, concentration=conc.contiguous())
        self._grids[name] = grid
        return self

    # --------------------------------------------- behaviors / mechanics

    def use(self, *behaviors: Behavior) -> "Simulation":
        """Register agent behaviors (Algorithm 8 L7–11), in execution order."""
        for b in behaviors:
            if not callable(b):
                raise TypeError(f"behavior {b!r} is not callable")
        self._behaviors.extend(behaviors)
        return self

    def mechanics(
        self,
        params: Optional[ForceParams] = ForceParams(),
        impl: str = "reference",
        active_capacity: Optional[int] = None,
        tile: Optional[int] = None,
        overflow_fallback: bool = True,
        diffusion_impl: str = "reference",
        tile_order: str = "linear",
        morton_block: Optional[int] = None,
        morton_window: Optional[int] = None,
        morton_window_fallback: bool = True,
    ) -> "Simulation":
        """Enable Eq-4.1 contact mechanics and choose the engine impls:
        ``impl`` "reference" | "cuda" | "fused", ``diffusion_impl``
        "reference" | "cuda"; ``tile_order="morton"`` (fused) runs the
        Morton-window kernel with the ``morton_*`` knobs of EngineConfig;
        ``params=None`` disables the force ops."""
        self._force_params = params
        self._force_opts = dict(
            force_impl=impl,
            active_capacity=active_capacity,
            force_tile=tile,
            fused_overflow_fallback=overflow_fallback,
            diffusion_impl=diffusion_impl,
            tile_order=tile_order,
            morton_block=morton_block,
            morton_window=morton_window,
            morton_window_fallback=morton_window_fallback,
        )
        return self

    # -------------------------------------------------------- operations

    def op(self, fn, *, name: Optional[str] = None, phase: str = "post",
           frequency: int = 1, gate: str = "cond", before: Optional[str] = None,
           after: Optional[str] = None, replaces: Optional[str] = None) -> "Simulation":
        """Register a custom scheduler operation, ``(OpContext, state) ->
        state`` (or a ready-made :class:`Operation`), anchored by at most one
        of ``before=`` / ``after=`` / ``replaces=``; appended by default."""
        if sum(x is not None for x in (before, after, replaces)) > 1:
            raise ValueError("pass at most one of before=/after=/replaces=")
        if isinstance(fn, Operation):
            if name is not None or (phase, frequency, gate) != ("post", 1, "cond"):
                raise ValueError("pass scheduling fields on the Operation itself when "
                                 "registering a ready-made Operation")
            operation = fn
        else:
            if name is None:
                name = getattr(fn, "__name__", None)
                if not name or name == "<lambda>":
                    raise ValueError("op(fn) needs name= for anonymous functions")
            operation = Operation(name=name, fn=fn, phase=phase, frequency=frequency,
                                  gate=gate)
        self._custom_ops.append(_CustomOp(op=operation, before=before, after=after,
                                          replaces=replaces))
        return self

    # ------------------------------------------------------- observables

    def observe(self, name: str, fn: Callable, frequency: int = 1) -> "Simulation":
        """Record ``fn(state)`` as a named time series: ⌈n/k⌉ rows over an
        n-step run from step 0."""
        if any(o.name == name for o in self._observables):
            raise ValueError(f"observable {name!r} already registered")
        if not isinstance(frequency, (int, np.integer)) or frequency < 0:
            raise ValueError(f"frequency must be a non-negative int, got {frequency!r}")
        self._observables.append(Observable(name=name, fn=fn, frequency=int(frequency)))
        return self

    def observe_kinds(self, name: str = "kind_counts", frequency: int = 1,
                      n_kinds: Optional[int] = None) -> "Simulation":
        """Built-in observable: per-kind alive counts (Fig 4.17)."""
        if n_kinds is None:
            if not self._groups:
                raise ValueError("observe_kinds before add_agents needs explicit n_kinds=")
            n_kinds = 1 + max(int(g.kind.max()) if g.n else 0 for g in self._groups)
        fn = functools.partial(_engine.count_kinds, n_kinds=int(n_kinds))
        return self.observe(name, fn, frequency)

    # ------------------------------------------------------------- build

    def interaction_radius(self) -> float:
        """The neighbor-grid box size: ``cell_size``, else the largest diameter."""
        if self.cell_size is not None:
            return self.cell_size
        if not self._groups:
            raise ValueError("no agents registered — call add_agents first")
        d = max(float(g.diameter.max()) for g in self._groups)
        if d <= 0.0:
            raise ValueError("cannot derive cell_size from zero diameters — pass "
                             "cell_size= explicitly")
        return d

    def _pool(self):
        if not self._groups:
            raise ValueError("no agents registered — call add_agents first")
        n_total = sum(g.n for g in self._groups)
        capacity = self._capacity()
        if n_total > capacity:
            raise ValueError(f"{n_total} registered agents exceed capacity {capacity}")
        cat = lambda xs: torch.cat(xs, dim=0)
        return make_pool(
            capacity,
            cat([g.position for g in self._groups]),
            diameter=cat([g.diameter for g in self._groups]),
            kind=cat([g.kind for g in self._groups]),
            attrs={name: cat([g.attrs[name] for g in self._groups])
                   for name in self._attr_schema},
            device=self.device,
        )

    def _engine_config(self) -> EngineConfig:
        spec = spec_for_space(self.min_bound, self.max_bound, self.interaction_radius(),
                              max_per_cell=self.max_per_cell, use_morton=self.use_morton,
                              rank_impl=self.rank_impl)
        return EngineConfig(
            spec=spec,
            behaviors=tuple(self._behaviors),
            force_params=self._force_params,
            dt=self.dt,
            min_bound=self.min_bound,
            max_bound=self.max_bound,
            boundary=self.boundary,
            sort_frequency=self.sort_frequency,
            diffusion_frequency=self.diffusion_frequency,
            **self._force_opts,
        )

    def _apply_custom_ops(self, sched: Scheduler) -> Scheduler:
        for c in self._custom_ops:
            if c.replaces is not None:
                sched = sched.replace_op(c.replaces, c.op)
            elif c.before is not None:
                sched = sched.insert_before(c.before, c.op)
            elif c.after is not None:
                sched = sched.insert_after(c.after, c.op)
            else:
                sched = sched.append(c.op)
        return sched

    def build(self, seed: Optional[int] = None) -> "BuiltSimulation":
        """Compile the description into the explicit engine triple."""
        config = self._engine_config()
        scheduler = self._apply_custom_ops(Scheduler.default(config))
        state = init_state(self._pool(), dict(self._grids),
                           seed=self.seed if seed is None else seed)
        return BuiltSimulation(config=config, scheduler=scheduler, state=state,
                               observables=tuple(self._observables))

    # -------------------------------------------------------- execution

    def run(self, n_steps: int, seed: Optional[int] = None, **run_kwargs):
        """Build and run from a fresh initial state.  ``checkpoint_dir=`` /
        ``checkpoint_every=`` pass through to :meth:`BuiltSimulation.run`."""
        return self.build(seed=seed).run(n_steps, **run_kwargs)

    def run_jit(self, n_steps: int, seed: Optional[int] = None, **run_kwargs):
        """Build and run through the compiled runner (:meth:`BuiltSimulation.
        run_jit`): :meth:`run`'s results, bit for bit."""
        return self.build(seed=seed).run_jit(n_steps, **run_kwargs)

    def run_batch(self, n_steps: int, params: Optional[Dict[str, Any]] = None, *,
                  seeds: Optional[Sequence[int]] = None, batch: Optional[int] = None,
                  seed: Optional[int] = None):
        """Build and sweep B variants in one batched run → ``(finals, obs)``.
        See :meth:`BuiltSimulation.run_batch` for the override namespace;
        slot b is bit-exactly the solo run of that variant."""
        return self.build(seed=seed).run_batch(n_steps, params, seeds=seeds, batch=batch)

    def resume(self, checkpoint_dir: str, seed: Optional[int] = None, **resume_kwargs):
        """Rebuild this model and finish an interrupted checkpointed run:
        ``Simulation.resume(dir)`` alone recovers a killed ``run(...,
        checkpoint_dir=dir)`` bit for bit (the manifest records the target
        step and interval).  The description must match the one that wrote
        the checkpoint; restore's shape and dtype checks enforce that."""
        return self.build(seed=seed).resume(checkpoint_dir, **resume_kwargs)

    def distribute(self, mesh, dcfg, capacity: Optional[int] = None,
                   seed: Optional[int] = None) -> "DistributedSimulation":
        """Deploy the same model description onto a mesh (Ch. 6).

        ``dcfg`` (a :class:`~repro_torch.core.distributed.DomainConfig`)
        chooses the decomposition; it must tile the declared space
        (``extent × axis_size`` per decomposed dim, ``depth`` = the full
        extent on the rest) and its ``halo_width`` must reach the
        interaction radius.  Agents are binned to ranks, substances split,
        and the same behaviours, mechanics, custom ops and observables run
        through the distributed schedule.  ``capacity`` is per rank (default:
        the single-node capacity).  ``mesh`` is a
        :class:`~repro_torch.launch.mesh.Mesh`; the state lives on its
        devices.  On a process mesh (``process_mesh``) every process builds
        the same stacked initial state on the host from the seed, and a run
        moves only its own rank's slice to its device.
        """
        from . import distributed as dist

        extent_total = self.max_bound - self.min_bound
        for d in range(dcfg.n_decomposed):
            want = extent_total / dcfg.axis_sizes[d]
            if abs(dcfg.extent - want) > 1e-6 * max(extent_total, 1.0):
                raise ValueError(
                    f"DomainConfig.extent {dcfg.extent} × axis_sizes[{d}]="
                    f"{dcfg.axis_sizes[d]} does not tile the declared space "
                    f"extent {extent_total} (want extent {want})")
        if dcfg.n_decomposed < 3 and abs(dcfg.depth - extent_total) > 1e-6 * max(
                extent_total, 1.0):
            raise ValueError(f"DomainConfig.depth {dcfg.depth} must equal the space extent "
                             f"{extent_total} on non-decomposed dims")
        radius = self.interaction_radius()
        if dcfg.halo_width < radius - 1e-9:
            raise ValueError(f"DomainConfig.halo_width {dcfg.halo_width} < interaction "
                             f"radius {radius}: remote neighbors would be missed")
        mesh = dist._check_mesh(mesh, dcfg)
        device = torch.device("cpu") if mesh.process else mesh.devices[0]

        # The single-node config with the deployment's fields swapped: the
        # halo-extended grid (with the facade's rank_impl) and the local frame.
        ecfg = dataclasses.replace(
            self._engine_config(),
            spec=dcfg.grid_spec(box_size=radius, max_per_cell=self.max_per_cell,
                                use_morton=self.use_morton, rank_impl=self.rank_impl),
            min_bound=0.0,
            max_bound=extent_total,
        )
        scheduler = self._apply_custom_ops(dist.distributed_scheduler(dcfg, ecfg))

        if not self._groups:
            raise ValueError("no agents registered — call add_agents first")
        g = lambda arrs: np.concatenate([a.detach().cpu().numpy() for a in arrs])
        positions = g([grp.position for grp in self._groups]) - self.min_bound
        state = dist.init_dist_state(
            dcfg,
            capacity=self._capacity() if capacity is None else int(capacity),
            positions=positions.astype(np.float32),
            diameter=g([grp.diameter for grp in self._groups]),
            kind=g([grp.kind for grp in self._groups]),
            seed=self.seed if seed is None else seed,
            attrs={name: g([grp.attrs[name] for grp in self._groups])
                   for name in self._attr_schema},
            stacked_grids=self._split_grids(dcfg, device),
            device=device,
        )
        step = dist.make_distributed_step(mesh, dcfg, ecfg, scheduler=scheduler)
        return DistributedSimulation(mesh=mesh, dcfg=dcfg, config=ecfg, scheduler=scheduler,
                                     state=state, step=step,
                                     observables=tuple(self._observables))

    def _capacity(self) -> int:
        n_total = sum(g.n for g in self._groups)
        return n_total if self.capacity is None else int(self.capacity)

    def _split_grids(self, dcfg, device) -> Dict[str, dgrid.DiffusionGrid]:
        """Each global substance grid split into per-rank local grids
        (stacked on a leading rank axis) in the rank-local frame (origin 0).

        Uneven splits use ghost-voxel padding: every rank carries a uniform
        ``ceil(R/S)``-voxel frame; ranks past the end of the global lattice
        pad with zeros, and the grid's ``n_valid`` / ``frame_shift`` mask the
        padding out of diffusion and sampling.  A resolution smaller than the
        mesh raises, as does an uneven split under a toroidal boundary."""
        out: Dict[str, dgrid.DiffusionGrid] = {}
        nd = dcfg.n_decomposed
        for name, grid in self._grids.items():
            res = grid.resolution
            small = [d for d in range(nd) if res[d] < dcfg.axis_sizes[d]]
            if small:
                detail = ", ".join(f"dim {d}: {res[d]} < {dcfg.axis_sizes[d]}" for d in small)
                raise ValueError(
                    f"substance {name!r}: resolution smaller than the mesh on dims "
                    f"{small} ({detail}); every decomposed dim needs at least one "
                    f"voxel per device")
            uneven = [d for d in range(nd) if res[d] % dcfg.axis_sizes[d] != 0]
            if uneven and self.boundary == "toroidal":
                raise ValueError(
                    f"substance {name!r}: uneven split on dims {uneven} with a toroidal "
                    f"boundary — ghost-voxel padding would break the periodic wrap "
                    f"alignment; pick a resolution divisible by the device counts on "
                    f"every decomposed dim")
            per = [-(-res[d] // dcfg.axis_sizes[d]) if d < nd else res[d] for d in range(3)]
            conc = grid.concentration.detach().cpu().numpy()
            locals_ = []
            for dev in range(dcfg.n_devices):
                coords = list(dcfg.device_coords(dev)) + [0] * (3 - nd)
                lo = [coords[d] * per[d] if d < nd else 0 for d in range(3)]
                block = conc[tuple(slice(lo[d], min(lo[d] + per[d], res[d]))
                                   for d in range(3))]
                block = np.pad(block, [(0, per[d] - block.shape[d]) for d in range(3)])
                extra = {}
                if uneven:
                    extra = dict(
                        n_valid=torch.tensor(
                            [min(per[d], max(res[d] - lo[d], 0)) if d < nd else res[d]
                             for d in range(3)], dtype=torch.int32, device=device),
                        frame_shift=torch.tensor(
                            [lo[d] * grid.spacing - coords[d] * dcfg.extent if d < nd
                             else 0.0 for d in range(3)], dtype=torch.float32,
                            device=device),
                    )
                locals_.append(dataclasses.replace(
                    grid, concentration=torch.from_numpy(np.ascontiguousarray(block)).to(
                        device), origin=(0.0, 0.0, 0.0), **extra))
            out[name] = tree_map(lambda *xs: torch.stack(xs), *locals_)
        return out


def _slice_observed(observables, ys: Dict[str, torch.Tensor], start: int,
                    n_steps: int) -> Dict[str, torch.Tensor]:
    """Trim each frequency-k buffer to the firings inside the window."""
    out: Dict[str, torch.Tensor] = {}
    for o in observables:
        k = o.frequency
        if k == 0:
            continue
        if k == 1:
            out[o.name] = ys[o.name]
            continue
        first = (-start) % k
        fired = 0 if first >= n_steps else -(-(n_steps - first) // k)
        out[o.name] = ys[o.name][:fired]
    return out


# --------------------------------------------------------------- checkpoints

#: Manifest meta format tag of a run checkpoint, the reference's: ``resume``
#: rejects checkpoints from an incompatible writer instead of mis-restoring.
CKPT_FORMAT = "abm-run/1"


def _step_of(state) -> int:
    """The absolute step counter, in one device read."""
    return int(state.step.reshape(-1)[0])


def _concat_obs(acc: Dict[str, np.ndarray], new) -> Dict[str, np.ndarray]:
    out = dict(acc)
    for name, rows in new.items():
        rows = rows.detach().cpu().numpy()
        prev = out.get(name)
        out[name] = rows if prev is None else np.concatenate([prev, rows], 0)
    return out


def _obs_tensors(acc: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in acc.items()}


def _checkpointed_loop(
    run_chunk: Callable[[int, Any], Tuple[Any, Dict[str, torch.Tensor]]],
    state,
    n_steps: int,
    *,
    engine: str,
    checkpoint_dir: str,
    checkpoint_every: Optional[int],
    keep: int,
    on_chunk: Optional[Callable[[Any], None]],
    obs_acc: Optional[Dict[str, np.ndarray]] = None,
    target_step: Optional[int] = None,
    mesh=None,
):
    """Drive ``run_chunk`` in checkpoint-interval chunks up to the target.

    The persisted tree is the full run — simulation state (pool, grids, RNG
    key, step counter, health) plus every observable row recorded so far —
    so a resume returns the final state AND the complete series of an
    uninterrupted run.  Chunking is invisible to the dynamics: the per-step
    RNG folds the absolute step counter.  An anchor checkpoint is written
    before the first chunk; ``on_chunk(state)`` fires after each save.  The
    step counter is read from the device once a chunk.  On a process
    ``mesh`` every process holds the stacked state, one writes it, and all
    wait for the write.
    """
    every = int(checkpoint_every) if checkpoint_every else int(n_steps)
    if every <= 0:
        raise ValueError(f"checkpoint_every must be positive, got {every}")
    step = _step_of(state)
    target = step + int(n_steps) if target_step is None else int(target_step)
    acc = {k: np.asarray(v) for k, v in (obs_acc or {}).items()}

    def save(st, at):
        if mesh is None or mesh.writes_checkpoints:
            _ckpt.save(
                checkpoint_dir,
                at,
                {"state": st, "obs": acc},
                keep=keep,
                meta={
                    "format": CKPT_FORMAT,
                    "engine": engine,
                    "target_step": target,
                    "checkpoint_every": every,
                    "obs_rows": {k: int(v.shape[0]) for k, v in acc.items()},
                },
            )
        if mesh is not None:
            mesh.barrier()

    save(state, step)
    while step < target:
        state, obs = run_chunk(min(every, target - step), state)
        acc = _concat_obs(acc, obs)
        step = _step_of(state)
        save(state, step)
        if on_chunk is not None:
            on_chunk(state)
    return state, _obs_tensors(acc, state.pool.device)


def _resume_payload(checkpoint_dir: str, engine: str, proto_state, observables):
    """Validate and restore the latest run checkpoint against this model.

    The ``like`` tree is the built initial state (every pool, grid, rng and
    health leaf is shape- and dtype-checked by ``checkpoint.restore``) plus a
    row buffer per observable, sized from the manifest's ``obs_rows``.  The
    reference types the buffers with ``jax.eval_shape``; the port evaluates
    each live observable once on the built state instead.
    """
    step, manifest = _ckpt.read_manifest(checkpoint_dir)
    meta = manifest.get("meta") or {}
    if meta.get("format") != CKPT_FORMAT:
        raise ValueError(
            f"{checkpoint_dir} step {step} is not an ABM run checkpoint "
            f"(manifest meta format {meta.get('format')!r}, want "
            f"{CKPT_FORMAT!r}) — was it written by checkpoint.save directly?"
        )
    if meta.get("engine") != engine:
        raise ValueError(
            f"checkpoint at {checkpoint_dir} was written by the "
            f"{meta.get('engine')!r} engine and cannot resume on {engine!r}"
        )
    protos = {o.name: o.fn(proto_state) for o in observables if o.frequency > 0}
    rows = meta.get("obs_rows") or {}
    like_obs = {
        name: torch.empty((int(rows.get(name, 0)),) + tuple(p.shape), dtype=p.dtype)
        for name, p in protos.items()
    }
    # checkpoint.restore tolerates extra arrays; a resume is stricter — the
    # model must account for every persisted array, or it is not the model
    # that wrote the run.
    like = {"state": proto_state, "obs": like_obs}
    n_like = _ckpt.n_leaves(like)
    n_saved = manifest.get("n_arrays")
    if n_saved is not None and n_saved != n_like:
        raise ValueError(
            f"checkpoint at {checkpoint_dir} holds {n_saved} arrays but "
            f"this model expects {n_like} — stale or foreign checkpoint"
        )
    _, payload = _ckpt.restore(checkpoint_dir, like, step=step)
    acc = {k: v.numpy() for k, v in payload["obs"].items()}
    return step, payload["state"], acc, int(meta["target_step"]), int(
        meta.get("checkpoint_every") or 1
    )


@dataclasses.dataclass(frozen=True)
class BuiltSimulation:
    """The built model: the explicit engine triple + observables.  ``run``
    defaults to the built initial state; pass ``state=`` to continue."""

    config: EngineConfig
    scheduler: Scheduler
    state: SimulationState
    observables: Tuple[Observable, ...] = ()

    @property
    def _jitted(self):
        """The compiled runner (``core/runner.py``), one for the model's
        lifetime, so chunked runs replay the graphs it captured."""
        cache = self._runner_cache
        if ("solo",) not in cache:
            cache[("solo",)] = _engine.jitted_runner(self.config, self.scheduler)
        return cache[("solo",)]

    def _execute(self, n_steps: int, state: Optional[SimulationState], jit: bool = False):
        state = self.state if state is None else state
        # The compiled run's own read, counted and timed by its runner.
        start = self._jitted.read_step(state) if jit else int(state.step)
        triples = tuple((o.name, o.fn, o.frequency) for o in self.observables
                        if o.frequency > 0)
        if jit:
            final, ys = self._jitted(state, n_steps, observables=triples or None)
        else:
            final, ys = _engine.run(self.config, state, n_steps, scheduler=self.scheduler,
                                    observables=triples or None)
        obs = _slice_observed(self.observables, ys, start, n_steps) if triples else {}
        return final, obs

    def run(self, n_steps: int, state: Optional[SimulationState] = None, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None, keep: int = 3,
            on_chunk: Optional[Callable[[Any], None]] = None):
        """Run ``n_steps`` eagerly → ``(final_state, {name: rows})``.

        With ``checkpoint_dir=`` the run goes in ``checkpoint_every``-step
        chunks, persisting the full run (state + observable rows so far)
        after each; kill the process at any point and :meth:`resume`
        finishes the run bit for bit.
        """
        if checkpoint_dir is None:
            return self._execute(n_steps, state)
        return self._run_checkpointed(n_steps, state, False, checkpoint_dir,
                                      checkpoint_every, keep, on_chunk)

    def run_jit(self, n_steps: int, state: Optional[SimulationState] = None, *,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: Optional[int] = None, keep: int = 3,
                on_chunk: Optional[Callable[[Any], None]] = None):
        """The compiled run → :meth:`run`'s ``(final_state, {name: rows})``,
        bit for bit: the step replayed from CUDA graphs by the model's
        runner.  Checkpointing as in :meth:`run`; the chunks reuse the
        runner's graphs.  A ``facade.run_jit`` span (``core/spans.py``)."""
        with span("facade.run_jit"):
            if checkpoint_dir is None:
                return self._execute(n_steps, state, jit=True)
            return self._run_checkpointed(n_steps, state, True, checkpoint_dir,
                                          checkpoint_every, keep, on_chunk)

    def _run_checkpointed(self, n_steps, state, jit, checkpoint_dir, checkpoint_every,
                          keep, on_chunk, obs_acc=None, target_step=None):
        state = self.state if state is None else state
        return _checkpointed_loop(
            lambda k, st: self._execute(k, st, jit=jit), state, n_steps, engine="single",
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            keep=keep, on_chunk=on_chunk, obs_acc=obs_acc, target_step=target_step,
        )

    def resume(self, checkpoint_dir: str, *, jit: bool = True, keep: int = 3,
               on_chunk: Optional[Callable[[Any], None]] = None):
        """Finish an interrupted checkpointed run → the ``(final_state,
        {name: rows})`` the uninterrupted run returns.

        Restores the latest valid checkpoint (validated against this model's
        built state, :func:`_resume_payload`) onto the built state's device,
        then runs the remaining ``target_step − restored_step`` steps under
        the recorded interval, through :meth:`run_jit` (``jit=True``) or
        :meth:`run`.
        """
        step, state, acc, target, every = _resume_payload(
            checkpoint_dir, "single", self.state, self.observables
        )
        if target - step <= 0:
            return state, _obs_tensors(acc, state.pool.device)
        return self._run_checkpointed(target - step, state, jit, checkpoint_dir, every,
                                      keep, on_chunk, obs_acc=acc, target_step=target)

    @functools.cached_property
    def _runner_cache(self) -> Dict[tuple, Any]:
        # One runner per execution signature, for the BuiltSimulation's
        # lifetime: ``("solo",)`` holds the compiled runner (chunked runs
        # replay its graphs), ``("batch",)`` the BatchedSimulation.
        return {}

    def batched(self):
        """The many-simulation engine for this model: a
        :class:`~repro_torch.core.batch.BatchedSimulation` stepping B session
        states at once, with the built state as the validation template.
        Cached for the model's lifetime."""
        from . import batch as _batch

        cache = self._runner_cache
        if ("batch",) not in cache:
            cache[("batch",)] = _batch.BatchedSimulation(
                self.config, self.scheduler, self.state, self.observables)
        return cache[("batch",)]

    def run_batch(self, n_steps: int, params: Optional[Dict[str, Any]] = None, *,
                  seeds: Optional[Sequence[int]] = None, batch: Optional[int] = None):
        """Sweep B parameter variants through one batched run.

        ``params`` maps override keys to per-slot values with a leading slot
        axis: ``"attr:NAME"`` sets initial agent-attr values (scalar per
        slot, or per-agent over the registered agents), and
        ``"substance:NAME"`` sets initial concentrations (uniform scalar per
        slot, or a full field); per-slot op constants ride as attrs the op
        reads.  ``seeds`` gives slot ``b`` its own ``PRNGKey(seeds[b])``
        stream (default: ``fold_in(built_rng, b)``); ``batch`` forces the
        width when neither implies it.

        Returns ``(finals, obs)``: the stacked final states (every leaf with
        a leading B axis) and ``obs[name]`` of shape ``(B, rows, ...)``.
        Slot b equals a solo run of that variant, bit for bit.  The batch
        runs through the compiled run (``BatchedSimulation.run_jit``).
        """
        eng = self.batched()
        bstate = eng.sweep_state(batch=batch, seeds=seeds, params=params)
        bstate, obs, counts = eng.run_jit(bstate, n_steps)
        # Sweep slots share the built start step, so every slot fired the
        # same rows: trim the buffers by slot 0's count.
        if obs:
            fired = {k: int(v[0]) for k, v in counts.items()}
            obs = {k: v[:, : fired[k]] for k, v in obs.items()}
        return bstate.states, obs


@dataclasses.dataclass(frozen=True)
class DistributedSimulation:
    """The same model deployed on a mesh: the stacked per-rank state and the
    distributed step (``core/distributed.py``).

    ``run`` steps the ranks in lock-step; observables are evaluated on the
    *stacked* state (the built-in kind-counts observable flattens the rank
    axis; custom observables that index pool arrays see a leading rank
    axis).  Between observable firings the loop keeps one state a local rank
    and stacks only when an observable fires and at the end of a chunk.  On
    a process mesh each process steps its own rank and the stack is an
    all-gather: every process gets the same stacked state and rows, and rank
    0 writes the checkpoints, in the in-process mesh's format.  ``run_jit``
    returns the same, bit for bit, with the lock-step step of every rank
    replayed from CUDA graphs (``core/runner.py``); on a process mesh each
    process replays its own rank's step as graphs cut at every exchange.
    """

    mesh: Any
    dcfg: Any
    config: EngineConfig
    scheduler: Scheduler
    state: Any                       # DistState
    step: Any                        # core.distributed.DistributedStep
    observables: Tuple[Observable, ...] = ()

    def run(self, n_steps: int, state=None, *, checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None, keep: int = 3,
            on_chunk: Optional[Callable[[Any], None]] = None):
        """Step ``n_steps`` iterations → ``(final_state, {name: rows})``.
        ``checkpoint_dir=`` persists the stacked state and the observable
        rows every ``checkpoint_every`` steps, as ``BuiltSimulation.run``
        does; :meth:`resume` finishes a killed run bit for bit."""
        return self._run(n_steps, state, self._run_chunk, checkpoint_dir, checkpoint_every,
                         keep, on_chunk)

    def run_jit(self, n_steps: int, state=None, *, checkpoint_dir: Optional[str] = None,
                checkpoint_every: Optional[int] = None, keep: int = 3,
                on_chunk: Optional[Callable[[Any], None]] = None):
        """The compiled run → :meth:`run`'s ``(final_state, {name: rows})``,
        bit for bit: the lock-step step of every rank replayed from CUDA
        graphs by the deployment's runner
        (:func:`~repro_torch.core.distributed.jitted_distributed_runner`),
        kept for the object's lifetime, so checkpointed chunks reuse its
        graphs.  An in-process mesh must hold every rank on one device; on a
        process mesh each process replays its rank's step as segments cut at
        its exchanges, every process returns the same stacked state and
        rows, and rank 0 writes the checkpoints."""
        return self._run(n_steps, state, self._jit_chunk, checkpoint_dir, checkpoint_every,
                         keep, on_chunk)

    def _run(self, n_steps, state, run_chunk, checkpoint_dir, checkpoint_every, keep,
             on_chunk):
        state = self.state if state is None else state
        if checkpoint_dir is None:
            return run_chunk(n_steps, state)
        return _checkpointed_loop(
            run_chunk, state, n_steps, engine="dist",
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            keep=keep, on_chunk=on_chunk, mesh=self.mesh,
        )

    @functools.cached_property
    def _jitted(self):
        """The compiled runner, one for the deployment's lifetime."""
        from . import distributed as dist

        return dist.jitted_distributed_runner(self.mesh, self.dcfg, self.config,
                                              self.scheduler)

    def _jit_chunk(self, n_steps: int, state):
        triples = tuple((o.name, o.fn, o.frequency) for o in self.observables
                        if o.frequency > 0)
        return self._jitted(state, n_steps, observables=triples or None)

    def _run_chunk(self, n_steps: int, state):
        live = [o for o in self.observables if o.frequency > 0]
        rows: Dict[str, List[torch.Tensor]] = {o.name: [] for o in live}
        # One host read of the counter; it advances by exactly 1 a step.
        start = _step_of(state)
        ranks = self.step.unstack(state)
        for i in range(n_steps):
            ranks = self.step.step_ranks(ranks, start + i)
            fired = [o for o in live if (start + i) % o.frequency == 0]
            if fired:
                stacked = self.step.stack(ranks)
                for o in fired:
                    rows[o.name].append(o.fn(stacked))
        state = self.step.stack(ranks) if n_steps else state
        obs = {}
        for o in live:
            r = rows[o.name]
            if r:
                obs[o.name] = torch.stack(r)
            else:
                proto = o.fn(state)
                obs[o.name] = torch.zeros((0,) + tuple(proto.shape), dtype=proto.dtype,
                                          device=proto.device)
        return state, obs

    def resume(self, checkpoint_dir: str, *, jit: bool = False, keep: int = 3,
               on_chunk: Optional[Callable[[Any], None]] = None):
        """Finish an interrupted distributed checkpointed run, its chunks
        through :meth:`run_jit` (``jit=True``) or :meth:`run`.  The
        checkpoint's per-rank shapes are checked against this deployment's
        state, so a different mesh shape or capacity fails loudly.  Either
        kind of mesh resumes either's checkpoint; on a process mesh rank 0
        reads it, sends it to every process, and each steps its own rank's
        slice."""
        if self.mesh.process:
            def payload():
                step, state, acc, target, every = _resume_payload(
                    checkpoint_dir, "dist", self.state, self.observables)
                return (step, acc, target, every), state

            (step, acc, target, every), state = self.mesh.from_first(payload, self.state)
        else:
            step, state, acc, target, every = _resume_payload(
                checkpoint_dir, "dist", self.state, self.observables)
        if target - step <= 0:
            return state, _obs_tensors(acc, state.pool.device)
        return _checkpointed_loop(
            self._jit_chunk if jit else self._run_chunk, state, target - step, engine="dist",
            checkpoint_dir=checkpoint_dir, checkpoint_every=every, keep=keep,
            on_chunk=on_chunk, obs_acc=acc, target_step=target, mesh=self.mesh,
        )
