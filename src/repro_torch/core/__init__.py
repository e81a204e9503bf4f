"""repro_torch.core — the agent engine, ported from ``repro.core``.

Layer map (same module names as the reference):
  api          the declarative model API: Simulation → the engine
  agents       SoA agent pools, sort-free compaction (§5.3.2)
  morton       space-filling-curve tables (§5.4.2)
  grid         uniform-grid neighbor index (§5.3.1)
  neighbors    per-step neighbor dataflow, built once
  forces       mechanical contact forces + static omission (§4.5.1, §5.5)
  diffusion    extracellular diffusion, Eq 4.3 (§4.5.2)
  prng         threefry keys, bit for bit as jax.random
  behaviors    the deterministic behaviours of App. D
  schedule     Algorithm 8 as data: Operation / Scheduler
  engine       the default schedule stepped eagerly
"""

from .agents import AgentPool, compact_indices, make_pool, permute, permute_to
from .api import BuiltSimulation, Observable, Simulation
from .behaviors import StepContext, chemotaxis, growth, secretion
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
    "AgentPool", "compact_indices", "make_pool", "permute", "permute_to",
    "StepContext", "chemotaxis", "growth", "secretion",
    "DiffusionGrid", "analytical_point_source", "concentration_at", "diffuse",
    "gradient_at", "increase_concentration", "make_grid",
    "EngineConfig", "SimulationState", "count_kinds", "init_state", "run",
    "run_jit", "simulation_step",
    "ForceParams", "mechanical_forces", "pair_force",
    "update_static_flags", "update_static_flags_celllist",
    "GridIndex", "GridSpec", "build_index", "candidate_neighbors", "sort_agents",
    "spec_for_space", "NeighborContext",
    "HealthReport", "Operation", "OpContext", "Scheduler",
]
