"""repro_torch.core — the agent engine, ported from ``repro.core``.

Layer map (same module names as the reference):
  api          the declarative model API: Simulation → the engine
  agents       SoA agent pools, sort-free compaction (§5.3.2)
  morton       space-filling-curve tables (§5.4.2)
  grid         uniform-grid neighbor index (§5.3.1)
  neighbors    per-step neighbor dataflow, built once
  forces       mechanical contact forces + static omission (§4.5.1, §5.5)
  diffusion    extracellular diffusion, Eq 4.3 (§4.5.2)
  prng         threefry keys and draws, bit for bit as jax.random
  behaviors    the behaviours of App. D
  schedule     Algorithm 8 as data: Operation / Scheduler
  engine       the default schedule stepped eagerly, or replayed (run_jit)
  runner       the compiled run: the step captured in CUDA graphs
  slots        the slot axis of a batch of sessions (flat view, selects)
  batch        the many-session engine: BatchState, BatchedSimulation
"""

from .agents import (
    AgentPool,
    add_agents,
    compact,
    compact_indices,
    make_pool,
    permute,
    permute_to,
    remove_agents,
)
from .api import BuiltSimulation, Observable, Simulation
from .batch import NO_BUDGET, BatchedSimulation, BatchState, batched_run, slot_state
from .behaviors import (
    INFECTED,
    RECOVERED,
    SUSCEPTIBLE,
    StepContext,
    apoptosis,
    brownian_motion,
    cell_division,
    chemotaxis,
    growth,
    random_movement,
    secretion,
    sir_infection,
    sir_recovery,
)
from .diffusion import (
    DiffusionGrid,
    analytical_point_source,
    concentration_at,
    diffuse,
    gradient_at,
    increase_concentration,
    make_grid,
)
from .engine import (
    EngineConfig,
    SimulationState,
    count_kinds,
    init_state,
    jitted_runner,
    run,
    run_jit,
    simulation_step,
)
from .forces import (
    ForceParams,
    mechanical_forces,
    pair_force,
    update_static_flags,
    update_static_flags_celllist,
)
from .grid import GridIndex, GridSpec, build_index, candidate_neighbors, sort_agents, spec_for_space
from .neighbors import NeighborContext
from .schedule import HealthReport, Operation, OpContext, Scheduler

__all__ = [
    "Simulation", "BuiltSimulation", "Observable",
    "NO_BUDGET", "BatchedSimulation", "BatchState", "batched_run", "slot_state",
    "AgentPool", "add_agents", "compact", "compact_indices", "make_pool", "permute",
    "permute_to", "remove_agents",
    "INFECTED", "RECOVERED", "SUSCEPTIBLE", "StepContext", "apoptosis",
    "brownian_motion", "cell_division", "chemotaxis", "growth", "random_movement",
    "secretion", "sir_infection", "sir_recovery",
    "DiffusionGrid", "analytical_point_source", "concentration_at", "diffuse",
    "gradient_at", "increase_concentration", "make_grid",
    "EngineConfig", "SimulationState", "count_kinds", "init_state", "jitted_runner",
    "run", "run_jit", "simulation_step",
    "ForceParams", "mechanical_forces", "pair_force",
    "update_static_flags", "update_static_flags_celllist",
    "GridIndex", "GridSpec", "build_index", "candidate_neighbors", "sort_agents",
    "spec_for_space", "NeighborContext",
    "HealthReport", "Operation", "OpContext", "Scheduler",
]
