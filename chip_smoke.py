#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing one JSON line; any failure raises and exits non-zero:

  device          the card's name, capability, power limit.
  build           the nine CUDA sources of the seven ported kernels (flash
                  attention has two tensor-core kernels, D 64 / 128 and D 256,
                  and a SIMT kernel) compiled from
                  ``kernels/*/csrc/*.cu``
                  (one nvcc each, all started together); build time and the
                  ptxas register / shared-memory report.
  small           the soma-clustering model at the quickstart's smoke size
                  (120 agents, 10^3 boxes, resolution 20) for 8 steps on the
                  card, held against the same model on the CPU (the kernels'
                  plain versions): positions atol 1e-4, fields rtol 1e-5.
  slice           path 1: the 600,000-agent soma-clustering model over 100^3
                  boxes with two 200^3 substances, built through
                  ``repro_torch.Simulation`` with cell_rank, cell_list_force
                  and diffusion3d switched on, 20 steps.
  spheroid_small  the tumor-spheroid model (births, deaths, threefry draws) at
                  2,000 cells for 8 steps, Morton windows covering the pool,
                  on the card against the CPU: alive flags, kinds and counts
                  exact, positions atol 1e-4.
  spheroid        path 2: the 100,000-cell tumor spheroid (space 1008 um, 56^3
                  boxes, capacity 131,072), sorted every step, forces by
                  cell_window_force at the covering half-window W (+25%), 20
                  steps; then ``spheroid_dense``: the same start with the dense
                  pairwise_force kernel, 4 steps.
  slice_jit, spheroid_jit, spheroid_dense_jit, sir_jit
                  the compiled run (``BuiltSimulation.run_jit``, the step
                  replayed from CUDA graphs, core/runner.py) of path 1's and
                  path 2's models (no per-step clock) and of the SIR model of
                  examples/epidemiology_sir.py (2,000 agents, 300 steps): the
                  model run eagerly, then twice through one runner from the
                  same start (the first run captures, the second replays);
                  every state leaf and observable row bit-identical to the
                  eager run, the launches equal to its; ``run_s`` and
                  ``step_ms`` (``run_s / steps`` around one synchronize()) of
                  each beside the eager run's, graphs, replays, eager steps,
                  rollbacks, capture seconds, peak memory.  Then
                  ``jit_divergence``: the spheroid at spheroid_small's size
                  with 97 cells stacked in one box at step 5, so the Morton
                  gate fails from step 6: at least one rollback, both force
                  kernels launched, bit-identical to the eager run.
  kernels         each kernel at its path's shapes (taken from the final state
                  of that path's run) against its plain PyTorch version on the
                  same card: cell_rank exact (plus a stable-sort oracle, one
                  crowded box and an all-dead pool, also at the spheroid's
                  shape), diffusion bit for bit,
                  the three force kernels atol 1e-5 * max|F|, the window and
                  dense ones also against cell_list_force.  CUDA-event times of
                  the kernel, the plain version and, where one exists, a single
                  PyTorch call that computes the same function; for cell_rank
                  and diffusion3d also ``device_ms``, calls replayed from a
                  CUDA graph (the device's work without the host's dispatch);
                  the bound from this run's inputs, and for cell_rank,
                  diffusion3d, pairwise_force and the two cell-force kernels
                  the bytes their design moves (``design_bytes``,
                  ``design_bound_ms``): the rows the window kernel's walk
                  visits, the mask and the id sectors holding a set slot of
                  pairwise_force (which also has ``device_ms``), and
                  cell_list_force's crowded tiles (halos past the staging
                  budget, in the path's run and in one call).
  checkpoint      path 1's model at full size (600,000 agents, two 200^3
                  fields) 8 steps straight, twice, bit-identical; then the same
                  8 steps checkpointed every 4, killed by an exception from
                  ``on_chunk`` after the first interval and finished by
                  ``Simulation.resume``: every state leaf and both series
                  bit-identical to the straight run, cell_rank,
                  cell_list_force and diffusion3d launched in the resumed
                  half; the checkpoint's bytes, each save's and restore's
                  seconds, and a restore into a CPU state, leaf for leaf.
  elastic         path 2's start (100,000 cells) in a pool of the cells plus
                  half a step's expected births, ``launch.elastic.run_elastic``
                  for 6 steps in 2-step chunks: at least one regrow, each to
                  ceil(2 x capacity), no agent dropped, the last ``pop`` row
                  equal to the alive count; the force kernel and capacity of
                  each chunk as run; a second run bit-identical.
  batch_small     3 slots of the soma model at 2,000 agents each (three
                  starts), 8 steps in one batch on the card: each slot
                  bit-identical to its solo card run. At 26^3 boxes (the
                  ``small`` phase's density) the same batch on the CPU (plain
                  versions) within the ``small`` tolerances; at 15^3 (path
                  1's density) its distance printed, beside the card running
                  its plain versions.
  batch_sweep     ``run_batch``'s sweep at full width: 8 slots x 75,000 soma
                  agents (500 um, 50^3 boxes, two 100^3 fields each; 8 seeds
                  and a per-slot initial concentration of substance_1), 20
                  steps; every slot's final state and series bit-identical to
                  its solo card run; batched and solo step medians, agent-steps
                  a second, launches a batched step (cell_rank,
                  cell_list_force, diffusion3d once a call site, not once a
                  slot), device-to-host reads a step both ways, peak memory.
  batch_spheroid  the spheroid in 4 slots of 25,000 cells (capacity 32,768
                  each), sorted every step, fused, 10 steps: births and
                  deaths in every slot, every slot bit-identical to its solo
                  run; then ``batch_spheroid_dense``, the same with the dense
                  pairwise_force kernel, 2 steps.
  batch_spheroid_morton
                  the same 4 slots with ``tile_order="morton"``: blocks of
                  128 rows, the half-window the least that covers every slot
                  at step 0 plus 25%, 10 steps with births and deaths; every
                  slot bit-identical to its solo Morton run, cell_window_force
                  launched once a step for all four slots and no slot falling
                  back to the linear kernel (the fallbacks' count printed), in
                  the batch and in the solo runs.
  abm_serve       ``launch/abm_serve.serve``: 10 soma sessions of 20,000
                  agents through 4 slots in chunks of 8 (budgets 24, one of
                  21), one NaN-bombed and evicted; the 21-step session saved
                  and restored through the checkpoint store and served on to
                  24; every done series equal to its solo run (SHA-256).
  kernels (batch) cell_rank, cell_list_force and diffusion3d at batch_sweep's
                  final state over all 8 slots in one call, pairwise_force
                  over batch_spheroid_dense's 4 slots' flat candidates,
                  cell_window_force over batch_spheroid_morton's 4 slots
                  (sorted as the next step sorts them, within-slot cell ids):
                  each bit-identical to one launch a slot (``solo_ms`` times
                  the B launches), against the plain version (diffusion bit
                  for bit, forces atol 1e-5 x max|F|; the window also against
                  cell_list_force over the same slots).
  calibrate       the paper's §4.4.10 calibration (``repro_torch.optim.pso``)
                  of the SIR model of examples/epidemiology_sir.py at its full
                  population (2,000 agents, 20 infected, space 100) on the
                  card, its runs cut from 1,000 steps to 300 (an SIR step
                  takes 15-23 ms): PSOConfig(n_particles=4, seed=1), one
                  iteration over the example's bounds, 8 runs; the median
                  run's wall time and step, the 72 runs of 1,000 steps of the
                  example's full calibration (8 particles, 8 iterations)
                  reckoned from it, the history and the best triple with its
                  MSE over the 300 steps.  Then the fast mode's
                  calibrated triple (3.24, 0.36, 6.2) at 400 agents, space 55,
                  300 steps: trajectory RMSE against the analytical solution
                  below 0.08, the example's own bar.
  neurite_small   the neurite-growth model of examples/neurite_growth.py
                  (tests/torch_usecases.py ``neurite``, the fused force impl,
                  the cuda rank impl, §5.5 work compaction): the example's
                  smoke run (4 neurons, 12 steps) and its validation run (8
                  neurons, 100 steps, ``neurite_main``'s five bars, and
                  ``neurite_main(jit=True)``, the example's four run_jit
                  chunks, with the same bars) on the
                  card against the CPU: alive, kind and static flags and the
                  kind counts exact, positions, directions and path lengths
                  atol 1e-4; each then through ``run_jit``
                  (``neurite_small_jit[...]``, as ``slice_jit``); then the
                  crowded case, active_capacity 40 below the active set from
                  step 5 on: at least one rollback, both ``crowded`` branches
                  captured, bit-identical to the eager run.
  neurite         the example's model at 900 neurons on a 600 x 600 um plate
                  (its density), space 640 um (160^3 boxes of 4 um, 128 slots
                  a box), the cue peaking at 120 um on 5 um voxels, capacity
                  131,072, 120 steps, from one start with active_capacity
                  32,768 and without compaction (cell_list_force over every
                  agent), each eagerly and twice through ``run_jit`` in
                  10-step chunks: every run_jit pass bit-identical to the
                  eager pass; the two runs equal after 8 steps (flags exact,
                  positions atol 1e-4); ``neurite_main``'s bars per neuron at
                  step 120.  Printed: alive, active and static fraction every
                  10 steps, the steps that outgrew active_capacity, eager and
                  replayed step medians of both runs, launches, peak memory,
                  set-up seconds.
  neurite_batch   4 slots of the 8-neuron model differing in their seed, 100
                  steps in one batch with compaction: each slot bit-identical
                  to its solo card run; then ``neurite_batch_jit`` (as
                  ``batch_sweep_jit``).
  kernels (neurite)
                  cell_rank and cell_list_force at the 900-neuron run's final
                  state, as the ``kernels`` rows of path 1.
  dist_small     the distributed engine (``core/distributed.py``) at the
                  reference's test sizes: the 4x2 force-only relaxation (500
                  agents, 5 steps, fused) and its corner-cluster layout (572
                  agents, 8 steps, fused and the dense pairwise_force over
                  ghost-extended sources) on a mesh of 8 ranks on the card,
                  each against the same mesh on the CPU: integer leaves
                  equal, floats within 5e-4; fused and dense card runs within
                  5e-4; the overlapped schedule bit-identical to the serial
                  one; one overlapped step with a Morton-window interior pass
                  (cell_window_force launched) within 1e-5 of the serial step.
  distributed     path 1's soma model (600,000 agents, two 200^3 fields, the
                  exposure op, closed boundary, a ``gid`` attribute) through
                  ``Simulation.distribute`` on a 2x2 mesh of 4 ranks on the
                  one card (150,000 agents and capacity 160,000 a rank, 100 x
                  100 x 200 voxels a field a rank, halo 10 um, halo and
                  migration buffers 4,096, int16 codec, fused), 20
                  steps. Gates: 600,000 alive at every step, the population
                  series equal to the single-node card run's, every overflow
                  counter 0, a second run bit-identical in every leaf and
                  series, 4 overlapped steps bit-identical to the serial
                  run's first 4. Printed: the largest gid-matched distance to
                  the single-node run with codecs int16 and none, the step-0
                  band counts, wire bytes a step and their ratio, the median
                  step against the single-node one, the host's time a step in
                  migrate + halo_exchange and in the other ops, launches a
                  step, peak memory.
  distributed_procs
                  the distributed engine with one process a rank
                  (``launch/procs.spawn``, ``launch/mesh.process_mesh``), eight
                  processes on the one card over gloo (a card's tensors staged
                  through pinned host memory): dist_small's corner case (int16)
                  on its 4x2 mesh, serial and overlapped, 8 steps, each
                  bit-identical to its in-process card run; then on four of
                  them (a subgroup) ``distributed``'s model on its 2x2 mesh,
                  20 steps: the final state (every leaf, so the gid-keyed
                  positions), the population series and the overflow counters
                  bit-identical to ``distributed``'s in-process run, every
                  process launching cell_rank and cell_list_force[ghost], the
                  four processes' launches adding up to the in-process run's,
                  the bytes each rank sends through ``Mesh.shift`` a step equal
                  to the in-process mesh's.  Printed: each process's median
                  step, host-staging ms a step, bytes a rank a step, the card's
                  name and power limit.  With 4 or more cards the 2x2 case also
                  runs over NCCL, one rank a card, against the gloo run;
                  otherwise a line ``nccl: not run (N card)``.
  kernels (dist)  cell_list_force over rank 0's ghost-extended sources (S = C
                  + 4H rows, num_out = C) of the distributed run's final
                  state, against its plain version (atol 1e-5 x max|F|), its
                  rows checked to stop at their first sentinel; cell_rank on
                  that halo-extended grid, exact.
  lm_small        path 3 at a small size: reduced phi4-mini (f32, 2 layers,
                  head_dim 16), weights from one CPU generator, the prefill
                  step with the flash kernel (f32: the SIMT kernel) and 8
                  decode steps on the card against the CPU: logits atol 1e-4.
  lm_prefill      path 3: phi4-mini-3.8b at full width and depth (32 layers,
                  d 3072, vocab 200,064, bf16), ``make_prefill_step`` over 4
                  prompts of 2,048 tokens: flash_attention 32 launches a call,
                  all of the tensor-core kernel (bf16, head_dim 128), and
                  rmsnorm 65; median of 3 timed calls after a warm-up.
  lm_serve        the port's ``launch/serve.py`` main loop at full width:
                  batch 4, 128 prompt tokens fed through ``decode_step``, 64
                  greedy tokens (rmsnorm 65 launches a step); then the prompt's
                  last logits against the prefill step (flash kernel) on the
                  same prompts: relative L2 <= 0.05, top-1 equal wherever the
                  prefill's top-1 margin exceeds twice the largest difference.
  kernels (LM)    flash_attention and rmsnorm on the inputs of the first call
                  of each in lm_prefill, against their plain versions (one
                  bf16 ulp), timed beside the plain versions,
                  ``scaled_dot_product_attention`` / ``rms_norm`` and (flash)
                  the SIMT kernel on the same inputs; then the flash kernels
                  on every mask variant at small shapes (the tensor-core ones
                  at D 64, 128 and 256).
  train_small     reduced phi4-mini (f32, ``remat=True``), one set of weights
                  from a CPU generator, 3 ``make_train_step`` steps over the
                  data pipeline's batches on the card and on the CPU (AdamW
                  with eps 1e-3): losses and grad norms rtol 1e-5, every
                  parameter atol 1e-5; the SIMT flash kernel once a layer in
                  the forward and once in the recomputed forward, rmsnorm
                  4 x layers + 1 a step.
  train           phi4-mini-3.8b training at its published widths, cut to 16
                  of 32 layers (f32 weights, grads and two AdamW moments take
                  16 B a parameter: 45 GB), bf16 compute, remat, 2 x 2,048
                  tokens a step: 2 warm-up and 4 timed steps; median step ms,
                  tokens a second, peak memory beside the one-device plan's
                  estimate, each step's loss and grad norm
                  (finite), the tensor-core flash kernel 32 and rmsnorm 65
                  launches a step; then one more AdamW update timed alone.
  kernels (train) the flash row at the training shape (B 2, 24 / 8 heads, T
                  2,048, D 128, causal, bf16): the tensor-core forward with
                  its lse (against the plain version's: one bf16 ulp, lse
                  rtol 1e-5), the plain backward a call, gradients through the
                  kernel's forward against the plain forward's (relative L2
                  <= 2e-2), ``scaled_dot_product_attention`` forward and
                  forward + backward, the bound of forward + backward (3.5 x
                  the forward's FLOP at 989 TFLOP/s); rmsnorm at (4,096,
                  3,072) bf16 with its plain backward.
  train_small (the other nine archs)
                  the same for each arch of ``TRAIN_PHASES`` at its reduced
                  config with ``remat=True``: the SIMT flash kernel with the
                  prefix (paligemma), window (recurrentgemma) and cross
                  (whisper) masks, the MoE backward, rwkv6's chunked WKV and
                  the RG-LRU scan under autograd, command-r's LayerNorm.
  <family>_train  the train step of the other nine archs at their published
                  widths (``TRAIN_PHASES``: vlm, moe, rwkv6, hybrid, audio,
                  gemma7b, nemo, commandr, phimoe), depth cut to the deepest
                  that the port's one-device plan puts under
                  ``TRAIN_PLAN_LIMIT`` (72 GB): as ``train``, 1 warm-up and 2
                  timed steps; each prints its cut (L of the published
                  layers), the plan's peak estimate at L and at the next
                  depth beside the card's peak, the AdamW share, and the
                  launches (two flash calls a step for each attention,
                  cross-attention and encoder layer; 4L + 1 rmsnorm where the
                  config norms by RMS, none for rwkv6, whisper and
                  command-r).  phi3.5-moe-42b-a6.6b trains at its published
                  widths (d 4,096, 16 experts) at 2 of 32 layers.
  kernels (train families)
                  the ``kernels (train)`` rows at each train phase's layer-0
                  shapes: the tensor-core flash kernel at D 256 with the
                  prefix and window masks, D 64 without a mask over 1,500
                  frames, D 128 at groups 1, 4 and 8 (rwkv6: none).
  families_small  reduced paligemma, olmoe, rwkv6, recurrentgemma, whisper,
                  gemma-7b, mistral-nemo and command-r (f32) on the card
                  against the CPU: the prefill step (flash kernel) and 8
                  decode steps, logits atol 1e-4.
  <family>_prefill, <family>_serve
                  the other serving families at published widths and full
                  depth, bf16 weights from a seed, one model on the card at a
                  time: vlm (paligemma-3b, 4 x (256 patches + 2,048 tokens);
                  decode_step with a cache of 256 + 192 slots), moe
                  (olmoe-1b-7b, 4 x 2,048; the assignments dropped by capacity
                  a layer), rwkv6 (rwkv6-1.6b, 4 x 2,048), hybrid
                  (recurrentgemma-9b, 2 x 4,096, past its 2,048 window),
                  audio (whisper-base, 4 x (1,500 frames, 448 tokens)) and
                  the dense gemma7b (gemma-7b), nemo (mistral-nemo-12b) and
                  commandr (command-r-35b, LayerNorm), 4 x 2,048; serve:
                  ``launch/serve.py``'s loop, batch 4, 128 + 64 tokens (rwkv6,
                  hybrid and the dense three also against their prefill step,
                  relative L2 <= 0.05).  Setup, median prefill ms and prompt
                  tokens a second, decode ms a step, peak memory, the flash
                  launches (tensor cores and SIMT) and rmsnorm launches
                  against the count the layer list implies, finite logits.
                  phi3.5-moe-42b-a6.6b (83.7 GB in bf16) does not fit one
                  card.
  kernels (LM families)
                  flash_attention (a tensor-core kernel) and rmsnorm on the
                  first calls' inputs of the vlm, hybrid, gemma7b, nemo and
                  commandr prefills (commandr: flash alone), against their
                  plain versions (one bf16 ulp), timed beside them, the SIMT
                  kernel on the same inputs (``simt_ms``) and
                  ``scaled_dot_product_attention`` (``is_causal`` for a plain
                  causal mask, else the same boolean mask; with the mask
                  too, ``library_masked_ms``) / ``rms_norm``; the flash bound
                  also over the 64 x 64 tiles holding a visible pair.
  dryrun_grid     ``python -m repro_torch.launch.dryrun --arch A --mesh M``
                  for every arch of ``configs/archs.py`` and ``teraagent``
                  (every shape) on the multi-pod production mesh, and
                  ``teraagent`` on the single-pod one too
                  (``DRYRUN_SINGLE_MESH``: 42 of the grid's 82 cells), one CLI
                  process an arch and mesh, ``DRYRUN_JOBS`` at a time, no card
                  visible to them; every cell ``ok`` but the reference's
                  skips (``long_500k`` on full-attention archs), every cell
                  partitioned (collective bytes: TeraAgent's exchange, each
                  LM cell rank 0's program over DTensor), and no LM cell
                  planned in more than ``DRYRUN_CELL_S`` (120) host seconds;
                  per cell its status, per-device argument, temp and
                  collective bytes and host seconds.
  dryrun          the dry-run's plans held against the card, on a one-device
                  meta mesh: ``train``'s configuration (phi4-mini, 16 layers,
                  2 x 2,048, f32 + AdamW, remat, the flash kernel) planned,
                  then built on the card: argument bytes (state + batch)
                  exact, one step's FlopCounterMode count + the flash
                  formula a launch equal to the plan's, the measured peak of
                  two steps no more than 10% above the plan's
                  ``peak_estimate_bytes``; ``lm_prefill``'s (4 x 2,048, bf16)
                  argument bytes and FLOPs exact, its peak against the plan's
                  (printed); ``lm_serve``'s parameters and cache bytes
                  exact; the ``moe`` family phase's prefill (olmoe, 4 x
                  2,048, bf16, all 16 layers): argument
                  bytes and FLOPs exact, launches as the layer list
                  implies, the measured peak no more than
                  ``MOE_PEAK_SLACK`` (10%) above the plan's estimate, and
                  its first flash (D 128 tensor-core kernel) and rmsnorm
                  calls against their plain versions (rows
                  ``flash_attention[olmoe-1b-7b, dryrun]`` and
                  ``rmsnorm[...]``, this run's launches); the TeraAgent cell's per-device state (one rank's
                  ``DistState``, 1M agents) built on the card, bytes exact on
                  both meshes, and one eager lock-step step of the plan's
                  (2, 2) / (2, 2, 2) ranks on the card at the cell's
                  capacities (``DRYRUN_AGENTS`` seeded agents a rank): the
                  bytes every rank sends through ``Mesh.shift`` equal to the
                  plan's collective bytes (2,523,136 / 3,784,704), the step's
                  peak printed beside the plan's estimate.

Each path is driven with every launch counter set to 0 just before it and
read just after; the ``kernels`` line gives each kernel's count from the path
it belongs to.

Then a ``wall`` line (seconds of the build and of each path with its
checks), one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

``--save-force-inputs FILE`` also saves the inputs of the kernels phases'
cell_list_force and cell_window_force calls and of the pairwise_force call
(every 8th query row of it, with all sources; ``torch.save``), for
``scripts/force_kernel_bits.py`` to run another checkout's kernels on.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores; also used for int32 ALU work

STEPS = 20
N_AGENTS = 600_000
SPACE = 1000.0                 # 100^3 boxes of 10 um
RESOLUTION = 200               # 5 um voxels

# The tumor spheroid of examples/tumor_spheroid.py at the size of a mature
# MCF-7 spheroid: 100,000 cells about 0.7 mm across.
SPH_CELLS = 100_000
SPH_SPACE = (0.0, 1008.0)      # 56^3 boxes of 18 um
SPH_CAPACITY = 131_072
SPH_STEPS = 20
SPH_DENSE_STEPS = 4
SPH_BLOCK = 128
SPH_DIVISION = 0.02            # Table 4.2: division probability a step ...
SPH_TRIGGER = 17.0             # ... of a cell at least this wide (um)

# Checkpointed runs: path 1's model, killed after the first interval and
# resumed; path 2's start in a pool that its first chunk's births overflow.
CKPT_STEPS = 8
CKPT_EVERY = 4
ELASTIC_STEPS = 6
ELASTIC_EVERY = 2

# Batches of sessions (core/batch.py, launch/abm_serve.py): the soma model at
# path 1's density (0.6 agents a 10 um box, 5 um voxels) in slots of a
# batch, and the spheroid at path 2's rates in 4 slots of a quarter of its
# capacity.
# batch_small holds the card to the CPU at the ``small`` phase's density
# (0.12 agents a box). At path 1's 0.6 the contacts amplify last-bit
# differences to ~3e-4 in 8 steps, solo runs as much as batched ones, and
# the card running its plain versions parts from the CPU as far as its
# kernels do (scripts/card_cpu_divergence.py): that density is run and its
# three readings printed beside the gated one.
BATCH_SMALL_AGENTS = 2_000
BATCH_SMALL_CASES = (           # (name, space um, field resolution, gated)
    ("small_density", 260.0, 52, True),     # 26^3 boxes
    ("path1_density", 150.0, 30, False),    # 15^3 boxes
)
SWEEP_SLOTS = 8
SWEEP_AGENTS = 75_000
SWEEP_SPACE = 500.0            # 50^3 boxes of 10 um
SWEEP_RES = 100                # 5 um voxels
SWEEP_STEPS = 20
SPHB_SLOTS = 4
SPHB_CELLS = 25_000
SPHB_CAPACITY = 32_768
SPHB_SPACE = (0.0, 504.0)      # 28^3 boxes of 18 um
SPHB_STEPS = 10
SPHB_DENSE_STEPS = 2
# The SIR calibration of examples/epidemiology_sir.py (paper §4.4.10, Table
# 4.3 measles rates): its population, its bounds, and the fast mode's check.
# Its runs are 1,000 steps; an SIR step takes 15-23 ms on the card
# (host-bound), so the 8 runs here are cut to 300 steps to keep the phase
# near a minute; the example's full calibration (72 runs of 1,000 steps) is
# reckoned from the measured step.
SIR_BETA, SIR_GAMMA = 0.06719, 0.00521
CAL_AGENTS, CAL_INFECTED, CAL_SPACE, CAL_STEPS = 2_000, 20, 100.0, 300
CAL_FULL_STEPS = 1_000
CAL_BOUNDS = [(1.0, 6.0), (0.05, 0.6), (1.0, 8.0)]
CAL_PARTICLES, CAL_ITERS, CAL_SEED = 4, 1, 1
CAL_FULL_RUNS = 8 * (8 + 1)      # the example's n_particles=8, n_iters=8
SIR_FAST = ((3.24, 0.36, 6.2), 400, 8, 55.0, 300)   # params, agents, infected, space, steps
SIR_FULL = (3.24, 0.285, 5.79)     # the example's triple calibrated at 2,000 agents
# The neurite-growth use case of examples/neurite_growth.py (paper §4.6.1,
# Algorithm 1; §5.5 static-agent omission), its builder from
# tests/torch_usecases.py with the fused force impl and the cuda rank impl.
# neurite_small: the example's smoke run (neurons, steps) and its validation
# run (neurite_main), and a crowded case whose active set outgrows
# NEU_CROWD_ACTIVE from step 5 to ~40 of NEU_CROWD_STEPS.  neurite: the
# example's plate (16 neurons on 80 x 80 um) scaled to 900 neurons on 600 x
# 600 um at its density, the space to 640 um (160^3 boxes of 4 um, 128 slots
# a box), the cue's peak kept at 120 um on 5 um voxels (resolution 128),
# capacity and active_capacity the example's 8,192 / 2,048 scaled by 16,
# 120 steps (its main); the runs with and without compaction are held to
# each other after NEU_GATE_STEP steps, before any cone reaches target_z.
NEU_SMOKE = (4, 12)
NEU_VALID = (8, 100)
NEU_CROWD_ACTIVE, NEU_CROWD_STEPS = 40, 60
NEU_NEURONS, NEU_SPACE, NEU_PLATE, NEU_CUE_TOP = 900, 640.0, (20.0, 620.0), 120.0
NEU_CAPACITY, NEU_ACTIVE, NEU_STEPS, NEU_GATE_STEP = 131_072, 32_768, 120, 8
NEU_CHUNK = 10                 # steps between the census reads of the neurite runs
NEU_SLOTS = 4
SERVE_AGENTS = 20_000
SERVE_SPACE = 320.0            # 32^3 boxes
SERVE_RES = 64
# The distributed engine: path 1's soma model split over a 2x2 mesh of four
# ranks on the one card (x and y decomposed, 500 x 500 x 1000 um a rank),
# halo = the interaction radius, halo buffers sized to the ~3,000-3,120
# agents of a face band.  Contacts push ~1,900 agents across a face in a
# step at this density (25x the ~77 of a 200 um run on the CPU), so the
# migration buffers hold 4,096 too.
DIST_MESH = (2, 2)
DIST_CAPACITY = 160_000
DIST_HALO = 10.0
DIST_HALO_CAPACITY = 4096
DIST_MIGRATE_CAPACITY = 4096
DIST_OVERLAP_STEPS = 4
# distributed_procs: one process a rank (launch/procs.py), gloo on one card.
PROCS_SMALL_RANKS = 8           # dist_small's 4x2 mesh; the first 4 run DIST_MESH
PROCS_SMALL_STEPS = 8
PROCS_TIMEOUT_S = 300
# distributed_procs_jit's elastic case: tests/dist_scenarios.py's regrowth.
DIST_ELASTIC_STEPS = 4
DIST_ELASTIC_EVERY = 2
DIST_ELASTIC_CAPACITY = 32
DIST_KERNELS = ("cell_rank", "cell_list_force", "cell_window_force", "pairwise_force",
                "diffusion3d")

# The LM serving path: phi4-mini-3.8b at its published widths and depth.
LM_ARCH = "phi4-mini-3.8b"
LM_BATCH = 4
LM_PREFILL_LEN = 2048
LM_SERVE_PROMPT = 128
LM_SERVE_GEN = 64
BF16_TENSOR_OPS_PER_S = 989e12   # dense bf16 tensor-core rate

# The other serving archs at their published widths and full depth:
# (phase prefix, arch, prefill batch, prefill prompt tokens).  With
# phi4-mini above, eight of the ten archs run on the card: paligemma-3b,
# olmoe-1b-7b, rwkv6-1.6b, recurrentgemma-9b, whisper-base and the three
# dense archs gemma-7b (D 256 at group 1), mistral-nemo-12b (D 128 at
# group 4) and command-r-35b (D 128 at group 8, LayerNorm, 60.6 GB of bf16
# weights: the largest model on the card).  The VLM prefill adds its 256
# patches before the prompt; whisper's prompt is 448 decoder tokens over
# 1,500 frames.  Serving: batch 4, 128 + 64 tokens, every arch at full
# depth.  phi3.5-moe-42b-a6.6b (41.9e9 parameters, 83.7 GB in bf16) does
# not fit one card; olmoe runs the same MoE code.
FAMILY_PHASES = (
    ("vlm", "paligemma-3b", 4, 2048),
    ("moe", "olmoe-1b-7b", 4, 2048),
    ("rwkv6", "rwkv6-1.6b", 4, 2048),
    ("hybrid", "recurrentgemma-9b", 2, 4096),
    ("audio", "whisper-base", 4, 448),
    ("gemma7b", "gemma-7b", 4, 2048),
    ("nemo", "mistral-nemo-12b", 4, 2048),
    ("commandr", "command-r-35b", 4, 2048),
)
# The train step of the other nine archs at their published widths, depth
# cut to fit one card: (phase prefix, arch, layers, batch, tokens a row).
# Each L is the deepest that the port's one-device plan (launch/dryrun.py,
# on the meta device: f32 weights, gradients and AdamW moments, bf16
# compute, remat) puts under TRAIN_PLAN_LIMIT, at least 2, a multiple of 3
# for recurrentgemma (one layer of three is local attention); paligemma,
# rwkv6 and whisper fit at full depth.  Plan peaks, in GB, at L and L + 1
# (recurrentgemma L + 3): olmoe 65.6 / 73.4, recurrentgemma 64.8 / 72.9,
# gemma-7b 68.9 / 73.0, mistral-nemo 71.0 / 75.9, phi3.5-moe 52.5 / 76.7.
# command-r's 2 layers plan at 73.0 GB, over the limit at the least depth
# (31 GB of its temp are the 256,000 x 8,192 tied vocabulary's gradients
# and do not shrink with batch: 1 x 2,048 plans at 72.9).  The VLM adds its
# 256 patches before the tokens; whisper's 448 tokens attend over 1,500
# frames.  No batch is cut: 2 rows as phi4-mini's phase, recurrentgemma's
# 4,096 tokens so that its 2,048-token window masks.
TRAIN_PHASES = (
    ("vlm", "paligemma-3b", 18, 2, 2048),
    ("moe", "olmoe-1b-7b", 8, 2, 2048),
    ("rwkv6", "rwkv6-1.6b", 24, 2, 2048),
    ("hybrid", "recurrentgemma-9b", 3, 2, 4096),
    ("audio", "whisper-base", 6, 2, 448),
    ("gemma7b", "gemma-7b", 11, 2, 2048),
    ("nemo", "mistral-nemo-12b", 10, 2, 2048),
    ("commandr", "command-r-35b", 2, 2, 2048),
    ("phimoe", "phi3.5-moe-42b-a6.6b", 2, 2, 2048),
)
TRAIN_PLAN_LIMIT = 72e9          # bytes: 90% of the card's 80 GB
TRAIN_FAMILY_WARMUP = 1
TRAIN_FAMILY_STEPS = 2
# The phases whose decode of the prompt is held against the prefill step
# (the others' decode differs by design: the VLM's cache holds no patches,
# whisper's cross-attention is zero, MoE capacity drops depend on the
# tokens a call routes), and those whose first flash and RMSNorm calls get
# kernel rows: the shapes no other phase or card test runs.
DECODE_VS_PREFILL = ("rwkv6", "hybrid", "gemma7b", "nemo", "commandr")
FAMILY_ROWS = ("vlm", "hybrid", "gemma7b", "nemo", "commandr")
FLASH_TILE = 64                  # the SIMT kernel's query and key tiles


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` back-to-back calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def warm_timed(fn):
    """``(fn(), its CUDA-event ms)`` of one call after a warm-up call, as
    ``cuda_ms(fn, 1)`` times it, for plain versions that take seconds: they
    run twice, not a third time for their answer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` per call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's launch cost drops out (for kernels of a
    few microseconds, which ``cuda_ms`` times at the host's launch rate)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts() -> None:
    from repro_torch import kernels

    kernels.add_launches({k: -n for k, n in kernels.read_launches().items()})


def read_counts() -> dict:
    from repro_torch import kernels

    return kernels.read_launches()


# --------------------------------------------------------------------- model

def soma_model(n, space, resolution, seed, device, concentration=None, **attrs):
    """The soma-clustering model of examples/quickstart.py (paper §4.7.1),
    with every kernel of the slice switched on; ``attrs``: more agent
    attributes."""
    from repro_torch import Simulation
    from repro_torch.core import ForceParams, chemotaxis, concentration_at, secretion

    def exposure_op(ctx, state):
        """Integrate each agent's own-substance concentration."""
        pool = state.pool
        c0 = concentration_at(state.grids["substance_0"], pool.position)
        c1 = concentration_at(state.grids["substance_1"], pool.position)
        own = torch.where(pool.kind == 0, c0, c1)
        dose = torch.where(pool.alive, own * ctx.config.dt, 0.0)
        return dataclasses.replace(
            state, pool=pool.set_attr("exposure", pool.get("exposure") + dose))

    rng = np.random.default_rng(seed)
    pos = rng.uniform(10, space - 10, (n, 3)).astype(np.float32)
    kind = (rng.random(n) < 0.5).astype(np.int32)
    conc = concentration or (None, None)
    return (
        Simulation(space=(0.0, space), cell_size=10.0, boundary="closed", dt=1.0,
                   max_per_cell=64, seed=seed, rank_impl="cuda", device=device)
        .add_agents(n, position=pos, diameter=5.0, kind=kind, exposure=0.0, **attrs)
        .add_substance("substance_0", diffusion=4.0, decay=0.002,
                       resolution=resolution, concentration=conc[0])
        .add_substance("substance_1", diffusion=4.0, decay=0.002,
                       resolution=resolution, concentration=conc[1])
        .use(secretion("substance_0", 1.0, kind=0), secretion("substance_1", 1.0, kind=1),
             chemotaxis("substance_0", 0.75, kind=0),
             chemotaxis("substance_1", 0.75, kind=1))
        .mechanics(ForceParams(), impl="fused", diffusion_impl="cuda")
        .op(exposure_op, name="exposure", phase="post")
    )


def ramp_fields(resolution):
    """Smooth initial fields whose gradients stay far from zero, so that
    chemotaxis directions do not hinge on the last ulp."""
    i, j, k = np.meshgrid(*[np.arange(resolution, dtype=np.float32)] * 3, indexing="ij")
    return ((2.0 + 0.6 * i + 0.4 * j + 0.2 * k).astype(np.float32),
            (2.0 + 0.1 * i + 0.3 * j + 0.2 * k).astype(np.float32))


def phase_small():
    """The quickstart smoke model on the card against the CPU port."""
    fields = ramp_fields(20)
    finals = {}
    for dev in ("cuda", "cpu"):
        built = soma_model(120, 100.0, 20, 0, dev, concentration=fields).build()
        finals[dev], _ = built.run(8)
    gpu, cpu = finals["cuda"], finals["cpu"]
    pos_err = float((gpu.pool.position.cpu() - cpu.pool.position).abs().max())
    if not pos_err <= 1e-4:
        raise AssertionError(f"small: positions differ from the CPU run by {pos_err}")
    field_err = 0.0
    for name in gpu.grids:
        g, c = gpu.grids[name].concentration.cpu(), cpu.grids[name].concentration
        torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))
        field_err = max(field_err, float((g - c).abs().max()))
    if not bool(torch.equal(gpu.pool.alive.cpu(), cpu.pool.alive)):
        raise AssertionError("small: alive masks differ")
    emit("small", agents=120, steps=8, max_position_err=pos_err, max_field_err=field_err)


# --------------------------------------------------------------------- slice

def phase_slice():
    t0 = time.perf_counter()
    sim = soma_model(N_AGENTS, SPACE, RESOLUTION, 0, "cuda")
    step_ends = []

    def clock(state):
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())
        return torch.zeros((), dtype=torch.int32, device=state.pool.device)

    sim.observe("step_clock", clock).observe_kinds(frequency=STEPS // 4)
    built = sim.build()
    spec = built.config.spec
    assert spec.dims == (int(SPACE / 10.0),) * 3 and spec.rank_impl == "cuda"
    assert built.state.grids["substance_0"].resolution == (RESOLUTION,) * 3
    alive0 = int(built.state.pool.alive.sum())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    from repro_torch.kernels.cell_force import kernel as cf_k

    torch.cuda.reset_peak_memory_stats()
    cf_k.crowded_tiles(built.state.pool.device, reset=True)
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    final, obs = built.run(STEPS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    crowded = cf_k.crowded_tiles(built.state.pool.device, reset=True)

    step_s = [b - a for a, b in zip([start] + step_ends[:-1], step_ends)]
    pool, health = final.pool, final.health
    alive = pool.alive
    if int(final.step) != STEPS or len(step_s) != STEPS:
        raise AssertionError(f"slice: ran {int(final.step)} steps")
    if int(alive.sum()) != alive0:
        raise AssertionError(f"slice: alive count {int(alive.sum())} != {alive0}")
    if not bool(torch.isfinite(pool.position[alive]).all()):
        raise AssertionError("slice: non-finite agent positions")
    bad = {f.name: int(getattr(health, f.name)) for f in dataclasses.fields(health)
           if int(getattr(health, f.name)) != 0}
    if bad:
        raise AssertionError(f"slice: health not clean: {bad}")
    exposure = pool.get("exposure")[alive]
    if not bool((exposure > 0).any()) or not bool(torch.isfinite(exposure).all()):
        raise AssertionError("slice: the exposure op did not fire")
    for name, g in final.grids.items():
        if not bool(torch.isfinite(g.concentration).all()):
            raise AssertionError(f"slice: non-finite field {name}")
    kinds = obs["kind_counts"]
    if tuple(kinds.shape) != (4, 2) or int(kinds[-1].sum()) != alive0:
        raise AssertionError(f"slice: kind counts {kinds.tolist()}")
    want = {"cell_rank": STEPS + 2, "cell_list_force": STEPS, "diffusion3d": 2 * STEPS,
            "cell_window_force": 0, "pairwise_force": 0, "flash_attention": 0,
            "flash_attention_simt": 0, "rmsnorm": 0}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"slice: {name} launched {launches[name]} times, want {n}")
    emit("slice", agents=alive0, boxes=spec.n_cells, voxels_per_substance=RESOLUTION**3,
         steps=STEPS, setup_s=setup_s, run_s=total_s,
         median_step_ms=1e3 * statistics.median(step_s),
         min_step_ms=1e3 * min(step_s), max_step_ms=1e3 * max(step_s),
         step_ms=[1e3 * t for t in step_s],
         peak_memory_bytes=peak, launches=launches,
         cell_list_force_crowded_tiles=crowded, exposure_mean=float(exposure.mean()))
    return built, final, launches, crowded, 1e3 * statistics.median(step_s)


# ------------------------------------------------------------------ spheroid

def spheroid_model(position, diameter, space, capacity, device, **mechanics):
    """The tumor-spheroid model of examples/tumor_spheroid.py (paper §4.6.2,
    Algorithm 2): Brownian motion, growth, division and apoptosis at the
    Table 4.2 rates, Eq 4.1 mechanics, 18 um boxes, max_per_cell 96, dt 1 h,
    closed boundary, sorted every step, and the mask-gated radial census
    (frequency 8) at the centre of the space."""
    from repro_torch import Simulation
    from repro_torch.core import (ForceParams, Operation, apoptosis, brownian_motion,
                                  cell_division, growth)

    lo, hi = space
    center = (lo + hi) / 2.0

    def census(ctx, state):
        pool = state.pool
        r = torch.linalg.vector_norm(pool.position - center, dim=-1)
        return dataclasses.replace(
            state, pool=pool.set_attr("radial", torch.where(pool.alive, r, 0.0)))

    return (
        Simulation(space=(lo, hi), cell_size=18.0, boundary="closed", dt=1.0,
                   capacity=capacity, max_per_cell=96, seed=0, sort_frequency=1,
                   rank_impl="cuda", device=device)
        .add_agents(len(position), position=position, diameter=diameter, radial=0.0)
        .use(brownian_motion(0.15), growth(60.0, 18.0),
             cell_division(SPH_DIVISION, trigger_diameter=SPH_TRIGGER),
             apoptosis(0.002, min_age=87.0))
        .mechanics(ForceParams(), **mechanics)
        .op(Operation("radial_census", census, phase="post", frequency=8, gate="mask"))
    )


def spheroid_start(n, space, lattice, seed=0):
    """A grown spheroid: the ``n`` sites of a cubic ``lattice`` (um) nearest
    the centre of ``space``, jittered by U(-1, 1) um; diameters U[14, 18),
    ages U[20, 220) h.  Numpy ``(position, diameter, age)``."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((2 * n) ** (1 / 3))) + 2
    g = (np.arange(side) - (side - 1) / 2.0) * lattice
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    order = np.argsort(np.linalg.norm(sites, axis=1), kind="stable")[:n]
    pos = sites[order] + (space[0] + space[1]) / 2.0 + rng.uniform(-1.0, 1.0, (n, 3))
    return (pos.astype(np.float32), rng.uniform(14.0, 18.0, n).astype(np.float32),
            rng.uniform(20.0, 220.0, n).astype(np.float32))


def with_ages(built, age):
    """The built initial state with the first ``len(age)`` agents' ages set."""
    pool = built.state.pool
    ages = torch.zeros_like(pool.age)
    ages[: len(age)] = torch.from_numpy(age).to(ages.device)
    return dataclasses.replace(built.state, pool=pool.replace(age=ages))


def phase_spheroid_small():
    """2,000 cells, 8 steps, Morton windows covering the whole pool, on the
    card against the CPU.  A looser start than the slice's (a 20 um lattice,
    centred on 0): in a packed spheroid every contact is stiff at dt = 1 h,
    and a pair's separation error grows about 3x a step, so the two devices'
    sum orders would part by more than 1e-4 within 8 steps."""
    space, capacity, steps = (-200.0, 200.0), 4096, 8
    pos, diam, age = spheroid_start(2000, space, lattice=20.0)
    window = capacity // SPH_BLOCK - 1
    finals, obs = {}, {}
    for dev in ("cuda", "cpu"):
        built = (spheroid_model(pos, diam, space, capacity, dev, impl="fused",
                                tile_order="morton", morton_window=window)
                 .observe_kinds(n_kinds=1).build())
        if dev == "cuda":
            reset_counts()
        finals[dev], obs[dev] = built.run(steps, state=with_ages(built, age))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
    gpu, cpu = finals["cuda"].pool, finals["cpu"].pool
    for f in ("alive", "kind", "overflow"):
        if not torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)):
            raise AssertionError(f"spheroid_small: {f} differs between the card and the CPU")
    if not torch.equal(obs["cuda"]["kind_counts"].cpu(), obs["cpu"]["kind_counts"]):
        raise AssertionError("spheroid_small: kind counts differ")
    pos_err = float((gpu.position.cpu() - cpu.position).abs().max())
    if not pos_err <= 1e-4:
        raise AssertionError(f"spheroid_small: positions differ from the CPU run by {pos_err}")
    want = {"cell_rank": steps, "cell_window_force": steps, "cell_list_force": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"spheroid_small: launches {launches}, want {want}")
    n1 = int(cpu.alive.sum())
    births = int((cpu.alive & (cpu.age <= steps)).sum())
    emit("spheroid_small", cells=2000, capacity=capacity, steps=steps, half_window=window,
         max_position_err=pos_err, cells_end=n1, births=births, deaths=2000 + births - n1,
         launches=launches)


def covering_window(built, state):
    """The least half-window (blocks of SPH_BLOCK) that covers the pool once
    it is Z-sorted, as the coverage gate reckons it."""
    from repro_torch.core.forces import covering_half_window
    from repro_torch.core.grid import build_index, sort_agents

    spec = built.config.spec
    pool = sort_agents(spec, state.pool)
    return covering_half_window(spec, build_index(spec, pool, assume_sorted=True),
                                SPH_BLOCK)


def run_spheroid(sim, state, steps, name):
    """Drive ``steps`` steps through ``BuiltSimulation.run`` with the
    counters zeroed just before and read just after; per-step host times
    around ``synchronize()`` and per-step launch counts."""
    step_ends, step_counts = [], []

    def clock(s):
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())
        step_counts.append(read_counts())
        return torch.zeros((), dtype=torch.int32, device=s.pool.device)

    built = sim.observe("step_clock", clock).build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    final, _ = built.run(steps, state=state)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([start] + step_ends[:-1], step_ends)]
    if int(final.step) != steps or len(step_s) != steps:
        raise AssertionError(f"{name}: ran {int(final.step)} steps")
    pool, health = final.pool, final.health
    bad = {f.name: int(getattr(health, f.name)) for f in dataclasses.fields(health)
           if int(getattr(health, f.name)) != 0}
    if bad or int(pool.overflow) != 0:
        raise AssertionError(f"{name}: health not clean: {bad}, overflow {int(pool.overflow)}")
    alive = pool.alive
    if not bool(torch.isfinite(pool.position[alive]).all()):
        raise AssertionError(f"{name}: non-finite agent positions")
    # A child is born at age 0 and ages with its step, so it is at most
    # ``steps`` old at the end; the initial cells are at least 20 + steps.
    n1 = int(alive.sum())
    births = int((alive & (pool.age <= steps)).sum())
    deaths = SPH_CELLS + births - n1
    per_step = [{k: c[k] - p[k] for k in c}
                for p, c in zip([{k: 0 for k in launches}] + step_counts[:-1], step_counts)]
    stats = dict(cells_start=SPH_CELLS, cells_end=n1, births=births, deaths=deaths,
                 steps=steps, run_s=total_s, median_step_ms=1e3 * statistics.median(step_s),
                 min_step_ms=1e3 * min(step_s), max_step_ms=1e3 * max(step_s),
                 step_ms=[1e3 * t for t in step_s], peak_memory_bytes=peak,
                 launches=launches)
    return built, final, per_step, stats


def spheroid_setup():
    """The 100,000-cell start on the card: ``(morton, dense, state, cover,
    window)`` — the two model declarations (not built), the initial state
    with its ages, the covering half-window of the Z-sorted start and W, that
    plus 25% capped at the block count."""
    pos, diam, age = spheroid_start(SPH_CELLS, SPH_SPACE, lattice=12.0)
    dense = spheroid_model(pos, diam, SPH_SPACE, SPH_CAPACITY, "cuda", impl="cuda")
    built = dense.build()
    state = with_ages(built, age)
    n = int((SPH_SPACE[1] - SPH_SPACE[0]) / 18.0)
    assert built.config.spec.dims == (n, n, n) and n ** 3 <= 1 << 20
    cover = covering_window(built, state)
    window = min(cover + -(-cover // 4), SPH_CAPACITY // SPH_BLOCK)
    morton = spheroid_model(pos, diam, SPH_SPACE, SPH_CAPACITY, "cuda", impl="fused",
                            tile_order="morton", morton_block=SPH_BLOCK,
                            morton_window=window)
    return morton, dense, state, cover, window


def phase_spheroid():
    from repro_torch.kernels.cell_force.ops import window_defaults

    t0 = time.perf_counter()
    sim, dense, state, cover, window = spheroid_setup()
    n_blocks = SPH_CAPACITY // SPH_BLOCK
    default = window_defaults(SPH_CAPACITY, SPH_BLOCK, None)[1]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    built, final, per_step, stats = run_spheroid(sim, state, SPH_STEPS, "spheroid")
    spec = built.config.spec
    fell_back = [i for i, c in enumerate(per_step)
                 if c["cell_list_force"] or c["cell_window_force"] != 1]
    if fell_back:
        raise AssertionError(f"spheroid: steps {fell_back} took the linear fallback "
                             f"(launches {[per_step[i] for i in fell_back]}); widen the "
                             f"window margin")
    want = {"cell_rank": SPH_STEPS, "cell_window_force": SPH_STEPS, "cell_list_force": 0,
            "pairwise_force": 0, "diffusion3d": 0, "flash_attention": 0,
            "flash_attention_simt": 0, "rmsnorm": 0}
    if stats["launches"] != want:
        raise AssertionError(f"spheroid: launches {stats['launches']}, want {want}")
    if not stats["births"] > 0 or not stats["deaths"] > 0:
        raise AssertionError(f"spheroid: births {stats['births']}, deaths {stats['deaths']}")
    radial = final.pool.get("radial")[final.pool.alive]
    if not bool((radial > 0).any()):
        raise AssertionError("spheroid: the radial census did not fire")
    emit("spheroid", boxes=spec.n_cells, capacity=SPH_CAPACITY, block=SPH_BLOCK,
         half_window=window, covering_half_window=cover, default_half_window=default,
         blocks=n_blocks, setup_s=setup_s, radial_p95=float(radial.quantile(0.95)), **stats)

    _, _, _, dstats = run_spheroid(dense, state, SPH_DENSE_STEPS, "spheroid_dense")
    want = {"cell_rank": SPH_DENSE_STEPS, "pairwise_force": SPH_DENSE_STEPS,
            "cell_window_force": 0, "cell_list_force": 0, "diffusion3d": 0,
            "flash_attention": 0, "flash_attention_simt": 0, "rmsnorm": 0}
    if dstats["launches"] != want:
        raise AssertionError(f"spheroid_dense: launches {dstats['launches']}, want {want}")
    emit("spheroid_dense", **dstats)
    return (built, final, window, stats["launches"], dstats["launches"],
            (stats["median_step_ms"], dstats["median_step_ms"]))


# ------------------------------------------------------------ compiled runs

JIT_RUNS = 2                  # run_jit runs a phase: the first captures


def jit_phase(name, built, steps, state=None, eager_median_ms=None, warm=False,
              extra=None):
    """``steps`` steps of ``built`` (a built or a distributed simulation)
    eagerly, then ``JIT_RUNS`` times through its runner (``run_jit``) from
    the same start, each bit-identical to the eager run (every state leaf and
    observable row) with the eager run's launches; emits the times and the
    runner's counts.  ``warm``: the last run must make no eager step.
    ``extra()``: more fields, measured after the runs.  A replay allocates
    nothing, so a run's peak counts the graph pool only when the run
    captures; ``reserved_bytes`` (the allocator's, pool included) is printed
    beside it.  Returns the launches of the run_jit runs, summed."""
    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_counts(), torch.cuda.max_memory_allocated()

    (efinal, eobs), eager_s, eager_launches, eager_peak = timed(
        lambda: built.run(steps, state=state))
    runner = built._jitted
    runs, total = [], {k: 0 for k in eager_launches}
    for i in range(JIT_RUNS):
        before = dict(runner.stats)
        (final, obs), run_s, launches, peak = timed(lambda: built.run_jit(steps, state=state))
        bad = differing_leaves(efinal, final)
        bad += [k for k in eobs if eobs[k].dtype != obs[k].dtype
                or eobs[k].shape != obs[k].shape or not torch.equal(eobs[k], obs[k])]
        if bad or set(obs) != set(eobs):
            raise AssertionError(f"{name}: run_jit run {i} differs from the eager run in {bad}")
        if launches != eager_launches:
            raise AssertionError(f"{name}: run_jit launched {launches}, eager {eager_launches}")
        counts = {k: runner.stats[k] - before[k] for k in runner.stats}
        if counts["rollbacks"] or counts["replays"] < steps - counts["eager_steps"]:
            raise AssertionError(f"{name}: run_jit run {i}: {counts}")
        total = {k: total[k] + launches[k] for k in total}
        runs.append(dict(run_s=run_s, step_ms=1e3 * run_s / steps, peak_memory_bytes=peak,
                         reserved_bytes=torch.cuda.memory_reserved(), **counts))
    if warm and runs[-1]["eager_steps"]:
        raise AssertionError(f"{name}: the last run_jit run made eager steps: {runs[-1]}")
    emit(name, steps=steps, eager_run_s=eager_s, eager_step_ms=1e3 * eager_s / steps,
         eager_median_step_ms=eager_median_ms, eager_peak_memory_bytes=eager_peak,
         run_s=runs[-1]["run_s"], step_ms=runs[-1]["step_ms"], runs=runs,
         launches=eager_launches, **(extra() if extra else {}), nvidia_smi=nvidia_smi_line())
    return total


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b.get(k, 0) for k in a}


def phase_slice_jit(eager_median_ms):
    sim = soma_model(N_AGENTS, SPACE, RESOLUTION, 0, "cuda")
    built = sim.observe_kinds(frequency=STEPS // 4).build()
    return jit_phase("slice_jit", built, STEPS, eager_median_ms=eager_median_ms)


def phase_spheroid_jit(eager_median_ms):
    """The Morton spheroid and the dense one, from path 2's start."""
    morton, dense, state, _, _ = spheroid_setup()
    launches = jit_phase("spheroid_jit", morton.build(), SPH_STEPS, state=state,
                         eager_median_ms=eager_median_ms[0])
    dense_launches = jit_phase("spheroid_dense_jit", dense.build(), SPH_DENSE_STEPS,
                               state=state, eager_median_ms=eager_median_ms[1])
    return launches, dense_launches


def crowd_model(cells=2000, capacity=4096, space=(-200.0, 200.0), at=5):
    """spheroid_small's model and start (a Morton window over all but one
    block, no overflow fallback) with 97 cells stacked at the centre on every
    step from step ``at`` on: the box overflows and the Morton gate fails
    from the next step.  Returns the built model, its start and the op."""
    pos, diam, age = spheroid_start(cells, space, lattice=20.0)

    def crowd(ctx, state):
        p = state.pool.position
        head = torch.where(state.step >= at, (space[0] + space[1]) / 2.0, p[:97])
        return dataclasses.replace(state, pool=state.pool.replace(
            position=torch.cat([head, p[97:]])))

    built = (spheroid_model(pos, diam, space, capacity, "cuda", impl="fused",
                            tile_order="morton", morton_window=capacity // SPH_BLOCK - 1,
                            overflow_fallback=False)
             .op(crowd, name="crowd", phase="agent").observe_kinds(n_kinds=1).build())
    return built, with_ages(built, age), crowd


def phase_jit_divergence(cells=2000, capacity=4096, space=(-200.0, 200.0)):
    """crowd_model's run: the runner's speculated window branch rolls
    back."""
    steps, at = 10, 5
    built, state, _ = crowd_model(cells, capacity, space, at)
    reset_counts()
    efinal, eobs = built.run(steps, state=state)
    torch.cuda.synchronize()
    eager = read_counts()
    reset_counts()
    final, obs = built.run_jit(steps, state=state)
    torch.cuda.synchronize()
    launches = read_counts()
    stats = built._jitted.stats
    bad = differing_leaves(efinal, final)
    if bad or not torch.equal(eobs["kind_counts"], obs["kind_counts"]):
        raise AssertionError(f"jit_divergence: run_jit differs from the eager run in {bad}")
    if stats["rollbacks"] < 1 or not (launches["cell_window_force"] and
                                      launches["cell_list_force"]):
        raise AssertionError(f"jit_divergence: {stats}, launches {launches}")
    emit("jit_divergence", cells=cells, capacity=capacity, steps=steps, crowd_at=at,
         eager_launches=eager, launches=launches, **stats)


def phase_sir_jit():
    """The SIR model of examples/epidemiology_sir.py at its full population
    (2,000 agents, 20 infected, space 100) with the triple it was
    calibrated at there, 300 steps."""
    built = sir_model(SIR_FULL, CAL_AGENTS, CAL_INFECTED, CAL_SPACE)
    return jit_phase("sir_jit", built, CAL_STEPS)


# --------------------------------------------------------------- checkpoints

def state_leaves(tree) -> dict:
    """``{checkpoint key: leaf}`` of a state, in the checkpoint's order."""
    from repro_torch.checkpoint.checkpoint import _leaves_with_paths

    return dict(_leaves_with_paths(tree))


def differing_leaves(a, b) -> list:
    """Keys of the leaves of ``a`` and ``b`` that are not bit-identical
    (dtype, shape and every value); compared on the host."""
    la, lb = state_leaves(a), state_leaves(b)
    if list(la) != list(lb):
        return sorted(set(la) ^ set(lb))
    return [k for k in la if la[k].dtype != lb[k].dtype
            or not torch.equal(la[k].cpu(), lb[k].cpu())]


class Timed:
    """Wrap ``module.name`` so that each call's host seconds land in
    ``seconds`` (the checkpoint store's save and restore, as the facade
    calls them); restored on exit."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self.original = fn = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


class Killed(Exception):
    """Raised from ``on_chunk`` to stand in for the death of the process:
    the interval's checkpoint is on disk when it fires."""


def checkpoint_model(device="cuda"):
    """Path 1's soma model at full size with two series to persist: kind
    counts every 2 steps and the summed exposure every step."""
    return (soma_model(N_AGENTS, SPACE, RESOLUTION, 0, device)
            .observe_kinds(frequency=2)
            .observe("exposure_sum", lambda s: s.pool.get("exposure").sum()))


def phase_checkpoint():
    """8 steps straight, twice (the step itself must be deterministic on the
    card); then the same 8 steps checkpointed every 4, killed after the first
    interval and finished by ``Simulation.resume`` from the description
    alone: every state leaf and every series bit-identical.  The card-written
    checkpoint also restores into a CPU ``like`` state, leaf for leaf."""
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt

    straight, straight_obs = checkpoint_model().run(CKPT_STEPS)
    again, again_obs = checkpoint_model().run(CKPT_STEPS)
    bad = differing_leaves({"state": straight, "obs": straight_obs},
                           {"state": again, "obs": again_obs})
    if bad:
        raise AssertionError(f"checkpoint: two straight runs differ in {bad}: the step "
                             f"is not deterministic on the card")
    del again, again_obs

    def kill(state):
        if int(state.step) >= CKPT_EVERY:
            raise Killed

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_ckpt_") as d:
        with Timed(ckpt, "save") as saves, Timed(ckpt, "restore") as restores:
            try:
                checkpoint_model().run(CKPT_STEPS, checkpoint_dir=d,
                                       checkpoint_every=CKPT_EVERY, on_chunk=kill)
            except Killed:
                killed_at = ckpt.latest_step(d)
            else:
                raise AssertionError("checkpoint: the interrupted run was not killed")
            if killed_at != CKPT_EVERY:
                raise AssertionError(f"checkpoint: latest step {killed_at} after the kill")
            sim = checkpoint_model()
            torch.cuda.synchronize()
            reset_counts()
            final, obs = sim.resume(d)
            torch.cuda.synchronize()
            launches = read_counts()
            _, back = ckpt.restore(d, {"state": final})
            torch.cuda.synchronize()
        bad = differing_leaves({"state": straight, "obs": straight_obs},
                               {"state": final, "obs": obs})
        if bad:
            raise AssertionError(f"checkpoint: the resumed run differs from the straight "
                                 f"run in {bad}")
        if differing_leaves({"state": final}, back):
            raise AssertionError("checkpoint: a restore of the last checkpoint differs")
        want = ("cell_rank", "cell_list_force", "diffusion3d")
        if not all(launches[k] > 0 for k in want):
            raise AssertionError(f"checkpoint: launches in the resumed half {launches}")
        like_cpu = checkpoint_model("cpu").build().state
        t0 = time.perf_counter()
        _, on_cpu = ckpt.restore(d, {"state": like_cpu})
        restore_cpu_s = time.perf_counter() - t0
        if {leaf.device.type for leaf in state_leaves(on_cpu).values()} != {"cpu"}:
            raise AssertionError("checkpoint: the CPU restore left leaves off the CPU")
        bad = differing_leaves({"state": final}, on_cpu)
        if bad:
            raise AssertionError(f"checkpoint: the CPU restore differs in {bad}")
        step_dir = Path(d) / f"step_{CKPT_STEPS:010d}"
        n_bytes = (step_dir / ckpt.ARRAYS).stat().st_size
        n_arrays = ckpt.read_manifest(d)[1]["n_arrays"]
    emit("checkpoint", agents=N_AGENTS, voxels_per_substance=RESOLUTION**3,
         steps=CKPT_STEPS, checkpoint_every=CKPT_EVERY, killed_at=killed_at,
         checkpoint_bytes=n_bytes, arrays=n_arrays,
         save_s=statistics.median(saves.seconds), save_s_each=saves.seconds,
         restore_s=statistics.median(restores.seconds), restore_s_each=restores.seconds,
         restore_cpu_s=restore_cpu_s,
         resumed_launches={k: launches[k] for k in want},
         bit_identical=True, straight_runs_bit_identical=True,
         series={k: list(v.shape) for k, v in obs.items()})


def phase_elastic():
    """Path 2's spheroid start in a pool just above its population, run by
    ``run_elastic`` in 2-step chunks: the first chunk's births overflow the
    pool, the chunk is rolled back to its checkpoint and replayed in a pool
    ⌈2×⌉ larger.  Twice, bit for bit."""
    import math
    import tempfile

    from repro_torch.launch.elastic import run_elastic

    pos, diam, _ = spheroid_start(SPH_CELLS, SPH_SPACE, lattice=12.0)
    # Expected births a step at the start: the cells already wide enough to
    # divide, at the division probability.  Half a step's births of headroom
    # cannot hold the first chunk's two steps.
    births_a_step = SPH_DIVISION * int((diam >= SPH_TRIGGER).sum())
    capacity = SPH_CELLS + int(births_a_step // 2)
    probe = spheroid_model(pos, diam, SPH_SPACE, capacity, "cuda", impl="cuda").build()
    cover = covering_window(probe, probe.state)
    window = min(cover + -(-cover // 4), -(-capacity // SPH_BLOCK))
    del probe

    def elastic_run(d):
        log = []

        def chunk_log(s):
            log.append((s.pool.capacity, read_counts()))
            return torch.zeros((), dtype=torch.int32, device=s.pool.device)

        sim = (spheroid_model(pos, diam, SPH_SPACE, capacity, "cuda", impl="fused",
                              tile_order="morton", morton_block=SPH_BLOCK,
                              morton_window=window)
               .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32))
               .observe("chunk_log", chunk_log))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        final, obs, grows = run_elastic(sim, ELASTIC_STEPS, d, checkpoint_every=ELASTIC_EVERY)
        torch.cuda.synchronize()
        return final, obs, grows, log, time.perf_counter() - t0

    (ROOT / "build").mkdir(exist_ok=True)
    runs = []
    for _ in range(2):
        with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_elastic_") as d:
            runs.append(elastic_run(d))
    (final, obs, grows, log, run_s), (final2, obs2, grows2, _, run2_s) = runs

    # The chunks as run, rolled-back ones included: each ELASTIC_EVERY steps.
    force = ("cell_window_force", "cell_list_force")
    chunks, prev = [], {k: 0 for k in log[0][1]}
    for i in range(0, len(log), ELASTIC_EVERY):
        cap, counts = log[i + ELASTIC_EVERY - 1]
        used = {k: counts[k] - prev[k] for k in ("cell_rank",) + force}
        chunks.append(dict(capacity=cap, **used,
                           force_kernel=[k for k in force if used[k]]))
        prev = counts
    caps = [capacity]
    for _ in range(grows):
        caps.append(math.ceil(2.0 * caps[-1]))
    pool, health = final.pool, final.health
    pop = obs["pop"]
    if grows < 1:
        raise AssertionError(f"elastic: no regrow at capacity {capacity}")
    if pool.capacity != caps[-1] or sorted({c["capacity"] for c in chunks}) != caps:
        raise AssertionError(f"elastic: capacities {[c['capacity'] for c in chunks]}, "
                             f"want each regrow to double: {caps}")
    if int(pool.overflow) != 0 or int(health.pool_overflow) != 0:
        raise AssertionError(f"elastic: overflow {int(pool.overflow)}, health "
                             f"{int(health.pool_overflow)}")
    if tuple(pop.shape) != (ELASTIC_STEPS,) or int(pop[-1]) != int(pool.alive.sum()):
        raise AssertionError(f"elastic: pop {pop.tolist()} vs alive {int(pool.alive.sum())}")
    regrown = [c for c in chunks if c["capacity"] > capacity]
    if not all(c["cell_rank"] > 0 and c["force_kernel"] for c in regrown):
        raise AssertionError(f"elastic: kernels at the regrown capacity {regrown}")
    if grows2 != grows or not torch.equal(obs2["pop"], pop):
        raise AssertionError(f"elastic: a second run regrew {grows2} times (first {grows}), "
                             f"pop {obs2['pop'].tolist()} vs {pop.tolist()}")
    bad = differing_leaves(final, final2)
    if bad:
        raise AssertionError(f"elastic: the second run's final state differs in {bad}")
    emit("elastic", cells_start=SPH_CELLS, births_a_step_expected=births_a_step,
         capacity=capacity, capacity_end=pool.capacity, regrows=grows,
         steps=ELASTIC_STEPS, checkpoint_every=ELASTIC_EVERY, half_window=window,
         covering_half_window=cover, pop=pop.tolist(), chunks=chunks,
         run_s=[run_s, run2_s], second_run_bit_identical=True)


# ------------------------------------------------------------------- batches

def slots_of(states, slots):
    """Solo views of a slots-layout state, one a slot."""
    from repro_torch.core.slots import slot_of

    return [slot_of(states, b) for b in range(slots)]


def step_clock():
    """A post op that synchronises and stamps the host clock at the end of
    each step, batched or solo (``batched=True``: once a batched step)."""
    from repro_torch.core import Operation

    ends = []

    def fn(ctx, state):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return state

    return Operation("step_clock", fn, phase="post", batched=True), ends


def step_ms(start, ends):
    return [1e3 * (b - a) for a, b in zip([start] + ends[:-1], ends)]


def dtoh_reads(run) -> float:
    """Device-to-host copies a step of ``run(n)`` (n steps from one state),
    from profiled runs of 3 steps and of 1: the difference over 2, so the
    reads a run makes once (its budgets, its start counter) drop out."""
    counts = [dtoh_in(lambda: run(n)) for n in (1, 3)]
    return (counts[1] - counts[0]) / 2


def dtoh_in(fn) -> int:
    """Device-to-host copies ``fn()`` makes, from one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "DtoH" in e.name)


def _with_impl(fn, impl, /, *args, **kwargs):
    return fn(*args, **{**kwargs, "impl": impl})


@contextlib.contextmanager
def plain_versions_on_card():
    """The soma path's kernel dispatchers take their plain versions on card
    tensors as they do on CPU tensors: the card in the CPU's sum orders."""
    from repro_torch.kernels.cell_force import ops as cf_ops
    from repro_torch.kernels.cell_rank import ops as cr_ops
    from repro_torch.kernels.diffusion3d import ops as d3_ops

    swaps = ((cr_ops, "cell_rank", "tiled"), (cf_ops, "cell_list_force", "reference"),
             (d3_ops, "diffusion_step", "reference"))
    saved = [getattr(module, name) for module, name, _ in swaps]
    for (module, name, impl), fn in zip(swaps, saved):
        setattr(module, name, functools.partial(_with_impl, fn, impl))
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, saved):
            setattr(module, name, fn)


def phase_batch_small():
    """3 slots of the soma model at 2,000 agents each (different starts), 8
    steps batched on the card: each slot bit-identical to its solo card run.
    At the ``small`` phase's density the batched run on the CPU (plain
    versions) must be within that phase's tolerances of the card's; at path
    1's density its distance is printed, beside that of the card running its
    plain versions."""
    n, steps = BATCH_SMALL_AGENTS, 8
    for density, space, res, gated in BATCH_SMALL_CASES:
        fields = ramp_fields(res)
        out = {}
        for run in ("cuda", "cpu") if gated else ("cuda", "cpu", "card_plain"):
            dev = "cpu" if run == "cpu" else "cuda"
            built = soma_model(n, space, res, 0, dev, concentration=fields).observe_kinds(
                frequency=3).build()
            starts = [soma_model(n, space, res, s, dev, concentration=fields).build().state
                      for s in range(3)]
            eng = built.batched()
            if run == "card_plain":
                with plain_versions_on_card():
                    out[run] = eng.run(eng.stack(starts), steps)[0].states
                continue
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_counts()
            bstate, obs, counts = eng.run(eng.stack(starts), steps)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
                for b, (start, got) in enumerate(zip(starts, slots_of(bstate.states, 3))):
                    solo, solo_obs = built.run(steps, state=start)
                    bad = differing_leaves(solo, got)
                    rows = obs["kind_counts"][b][: int(counts["kind_counts"][b])]
                    if bad or not torch.equal(rows, solo_obs["kind_counts"]):
                        raise AssertionError(f"batch_small: slot {b} differs from its solo "
                                             f"card run in {bad or 'kind_counts'} ({density})")
            out[run] = bstate.states
        pos = {k: v.pool.position.cpu() for k, v in out.items()}
        pos_err = float((pos["cuda"] - pos["cpu"]).abs().max())
        field_err = 0.0
        for name in out["cuda"].grids:
            g = out["cuda"].grids[name].concentration.cpu()
            c = out["cpu"].grids[name].concentration
            if gated:
                torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5 * float(c.abs().max()))
            field_err = max(field_err, float((g - c).abs().max()))
        if gated and not pos_err <= 1e-4:
            raise AssertionError(f"batch_small: positions differ from the CPU batch by {pos_err}")
        want = {"cell_rank": steps + 1, "cell_list_force": steps, "diffusion3d": 2 * steps}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"batch_small: launches {launches}, want {want} ({density})")
        extra = {} if gated else dict(
            max_position_err_vs_card_plain=float((pos["cuda"] - pos["card_plain"]).abs().max()),
            max_position_err_card_plain_vs_cpu=float(
                (pos["card_plain"] - pos["cpu"]).abs().max()))
        emit("batch_small", density=density, agents_a_box=n / (space / 10.0) ** 3,
             cpu_tolerances_gated=gated, slots=3, agents_a_slot=n, steps=steps,
             slots_bit_identical_to_solo=True, max_position_err_vs_cpu=pos_err,
             max_field_err_vs_cpu=field_err, launches={k: launches[k] for k in want}, **extra)


def sweep_model(device="cuda", concentration=None):
    """Path 1's soma model at one slot's size: 500 um, 50^3 boxes of 10 um,
    75,000 agents (0.6 a box), two 100^3 fields at 5 um."""
    return soma_model(SWEEP_AGENTS, SWEEP_SPACE, SWEEP_RES, 0, device,
                      concentration=concentration)


def phase_batch_sweep():
    """``run_batch``'s sweep at full width: 8 slots x 75,000 soma agents (8
    seeds, a per-slot initial concentration of substance_1), 20 steps in one
    batch; then the 8 solo runs on the card.  Every slot's final state and
    series bit-identical to its solo run; step times, launches and
    device-to-host reads a step both ways."""
    clock, ends = step_clock()
    sim = sweep_model().observe_kinds(frequency=SWEEP_STEPS // 4).observe(
        "exposure_sum", lambda s: s.pool.get("exposure").sum())
    built = sim.op(clock).build()
    spec = built.config.spec
    assert spec.dims == (int(SWEEP_SPACE // 10),) * 3 and spec.max_per_cell == 64
    seeds = [100 + b for b in range(SWEEP_SLOTS)]
    params = {"substance:substance_1": np.linspace(0.0, 3.5, SWEEP_SLOTS).astype(np.float32)}
    eng = built.batched()
    bstate = eng.sweep_state(seeds=seeds, params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ends.clear()
    start = time.perf_counter()
    final, obs, counts = eng.run(bstate, SWEEP_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    batch_ms = step_ms(start, ends)
    sorts = len(range(0, SWEEP_STEPS, built.config.sort_frequency))
    want = {"cell_rank": SWEEP_STEPS + sorts, "cell_list_force": SWEEP_STEPS,
            "diffusion3d": 2 * SWEEP_STEPS, "cell_window_force": 0, "pairwise_force": 0}
    if any(launches[k] != v for k, v in want.items()) or len(batch_ms) != SWEEP_STEPS:
        raise AssertionError(f"batch_sweep: launches {launches}, want {want}; "
                             f"{len(batch_ms)} steps timed")
    states = final.states
    health = {f.name: getattr(states.health, f.name).tolist()
              for f in dataclasses.fields(states.health)}
    if any(any(v) for v in health.values()):
        raise AssertionError(f"batch_sweep: health not clean: {health}")
    if not bool(torch.isfinite(states.pool.position).all()):
        raise AssertionError("batch_sweep: non-finite positions")
    reads_batched = dtoh_reads(lambda n: eng.run(final, n))
    if not reads_batched >= 1:      # the step reads its counters: the trace lost copies
        raise AssertionError(f"batch_sweep: {reads_batched} device-to-host reads a step")

    solo_ms = []
    for b, seed in enumerate(seeds):
        state = eng.session_state(seed=seed, params={k: v[b] for k, v in params.items()})
        torch.cuda.synchronize()
        ends.clear()
        t0 = time.perf_counter()
        solo, solo_obs = built.run(SWEEP_STEPS, state=state)
        torch.cuda.synchronize()
        solo_ms += step_ms(t0, ends)
        got = slots_of(states, SWEEP_SLOTS)[b]
        bad = differing_leaves({"state": solo, "obs": solo_obs},
                               {"state": got, "obs": {k: v[b][: int(counts[k][b])]
                                                      for k, v in obs.items()}})
        if bad:
            raise AssertionError(f"batch_sweep: slot {b} differs from its solo run in {bad}")
        if b == 0:
            reads_solo = dtoh_reads(lambda n: built.run(n, state=solo))
        del solo, solo_obs
    med_b, med_s = statistics.median(batch_ms), statistics.median(solo_ms)
    agents = SWEEP_SLOTS * SWEEP_AGENTS
    emit("batch_sweep", slots=SWEEP_SLOTS, agents_a_slot=SWEEP_AGENTS, boxes_a_slot=spec.n_cells,
         voxels_per_substance=SWEEP_RES**3, steps=SWEEP_STEPS, run_s=run_s,
         median_step_ms=med_b, min_step_ms=min(batch_ms), max_step_ms=max(batch_ms),
         step_ms=batch_ms, solo_median_step_ms=med_s, solo_min_step_ms=min(solo_ms),
         solo_max_step_ms=max(solo_ms),
         agent_steps_per_s=agents / (med_b / 1e3),
         solo_agent_steps_per_s=SWEEP_AGENTS / (med_s / 1e3),
         launches=launches,
         launches_a_batched_step={k: launches[k] / SWEEP_STEPS for k in
                                  ("cell_rank", "cell_list_force", "diffusion3d")},
         dtoh_reads_a_batched_step=reads_batched, dtoh_reads_a_solo_step=reads_solo,
         peak_memory_bytes=peak,
         cell_list_bytes=SWEEP_SLOTS * spec.n_cells * spec.max_per_cell * 4,
         field_bytes=SWEEP_SLOTS * 2 * SWEEP_RES**3 * 4,
         slots_bit_identical_to_solo=True)
    return built, final, launches


def spheroid_batch_setup(**mechanics):
    """The spheroid batch's model and its 4 slots' starts (25,000 cells,
    capacity 32,768 each, ages set, a seed a slot)."""
    from repro_torch.core import prng

    pos, diam, age = spheroid_start(SPHB_CELLS, SPHB_SPACE, lattice=12.0)
    built = spheroid_model(pos, diam, SPHB_SPACE, SPHB_CAPACITY, "cuda", **mechanics).build()
    start = with_ages(built, age)
    return built, [dataclasses.replace(start, rng=prng.PRNGKey(200 + b, device=start.rng.device))
                   for b in range(SPHB_SLOTS)]


def spheroid_batch(steps, name, **mechanics):
    """4 slots of the spheroid (25,000 cells, capacity 32,768 each, ages set,
    a seed a slot), sorted every step, ``steps`` steps batched, then each
    slot's solo card run: every slot bit-identical.  ``solo_launches``: the
    four solo runs' launches."""
    built, starts = spheroid_batch_setup(**mechanics)
    eng = built.batched()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, _, _ = eng.run(eng.stack(starts), steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    births, deaths = [], []
    solo_s = 0.0
    reset_counts()
    for b, (s0, got) in enumerate(zip(starts, slots_of(final.states, SPHB_SLOTS))):
        t0 = time.perf_counter()
        solo, _ = built.run(steps, state=s0)
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t0
        bad = differing_leaves(solo, got)
        if bad:
            raise AssertionError(f"{name}: slot {b} differs from its solo run in {bad}")
        alive = got.pool.alive
        n1 = int(alive.sum())
        births.append(int((alive & (got.pool.age <= steps)).sum()))
        deaths.append(SPHB_CELLS + births[-1] - n1)
    return built, final, launches, dict(run_s=run_s, solo_runs_s=solo_s, births=births,
                                        deaths=deaths, solo_launches=read_counts())


def phase_batch_spheroid():
    built, final, launches, stats = spheroid_batch(SPHB_STEPS, "batch_spheroid", impl="fused")
    if not (all(x > 0 for x in stats["births"]) and all(x > 0 for x in stats["deaths"])):
        raise AssertionError(f"batch_spheroid: births {stats['births']}, "
                             f"deaths {stats['deaths']}")
    want = {"cell_rank": SPHB_STEPS, "cell_list_force": SPHB_STEPS, "pairwise_force": 0,
            "cell_window_force": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"batch_spheroid: launches {launches}, want {want}")
    emit("batch_spheroid", slots=SPHB_SLOTS, cells_a_slot=SPHB_CELLS,
         capacity_a_slot=SPHB_CAPACITY, boxes=built.config.spec.n_cells, steps=SPHB_STEPS,
         launches=launches, slots_bit_identical_to_solo=True, **stats)

    dbuilt, dfinal, dlaunches, dstats = spheroid_batch(SPHB_DENSE_STEPS,
                                                       "batch_spheroid_dense", impl="cuda")
    if dlaunches["pairwise_force"] != SPHB_DENSE_STEPS:
        raise AssertionError(f"batch_spheroid_dense: launches {dlaunches}")
    emit("batch_spheroid_dense", slots=SPHB_SLOTS, steps=SPHB_DENSE_STEPS, launches=dlaunches,
         slots_bit_identical_to_solo=True, **dstats)
    return dbuilt, dfinal, dlaunches


def phase_batch_spheroid_morton():
    """batch_spheroid's 4 slots with Morton windows: the half-window the
    least that covers every slot's sorted start (the slots share it) plus
    25%, capped at the block count.  Every step of the batch and of each
    solo run must take the window kernel: a step where a slot fell back
    launches cell_list_force."""
    pos, diam, _ = spheroid_start(SPHB_CELLS, SPHB_SPACE, lattice=12.0)
    linear = spheroid_model(pos, diam, SPHB_SPACE, SPHB_CAPACITY, "cuda", impl="fused").build()
    cover = covering_window(linear, linear.state)
    window = min(cover + -(-cover // 4), SPHB_CAPACITY // SPH_BLOCK)
    del linear
    built, final, launches, stats = spheroid_batch(
        SPHB_STEPS, "batch_spheroid_morton", impl="fused", tile_order="morton",
        morton_block=SPH_BLOCK, morton_window=window)
    if not (all(x > 0 for x in stats["births"]) and all(x > 0 for x in stats["deaths"])):
        raise AssertionError(f"batch_spheroid_morton: births {stats['births']}, "
                             f"deaths {stats['deaths']}")
    want = {"cell_rank": SPHB_STEPS, "cell_window_force": SPHB_STEPS, "cell_list_force": 0,
            "pairwise_force": 0}
    solo_want = {k: SPHB_SLOTS * v for k, v in want.items()}
    solo = stats["solo_launches"]
    if any(launches[k] != v for k, v in want.items()) or any(
            solo[k] != v for k, v in solo_want.items()):
        raise AssertionError(f"batch_spheroid_morton: launches {launches} (want {want}), "
                             f"solo runs {solo} (want {solo_want}); a slot fell back to "
                             f"the linear kernel")
    emit("batch_spheroid_morton", slots=SPHB_SLOTS, cells_a_slot=SPHB_CELLS,
         capacity_a_slot=SPHB_CAPACITY, boxes=built.config.spec.n_cells, steps=SPHB_STEPS,
         block=SPH_BLOCK, half_window=window, covering_half_window=cover,
         blocks=SPHB_CAPACITY // SPH_BLOCK, launches=launches,
         fallback_launches=launches["cell_list_force"],
         solo_fallback_launches=solo["cell_list_force"],
         slots_bit_identical_to_solo=True, **stats)
    return built, final, launches, window


def serve_model(device="cuda"):
    """The soma model at 20,000 agents a session (320 um, 32^3 boxes, two
    64^3 fields) with a NaN bomb armed by an attr."""

    def nan_bomb(ctx, state):
        pos = state.pool.position.clone()
        hit = state.step >= state.pool.attrs["nan_bomb_at"][0].to(state.step.dtype)
        pos[0, 0] = torch.where(hit, torch.nan, pos[0, 0])
        return dataclasses.replace(state, pool=state.pool.replace(position=pos))

    return (soma_model(SERVE_AGENTS, SERVE_SPACE, SERVE_RES, 0, device,
                       nan_bomb_at=np.full(SERVE_AGENTS, 2**30, np.int32))
            .op(nan_bomb, name="nan_bomb", phase="post")
            .observe_kinds(frequency=4)
            .observe("exposure_sum", lambda s: s.pool.get("exposure").sum())
            .build())


def phase_abm_serve():
    """``launch/abm_serve.serve`` on the card: 10 sessions through 4 slots
    in chunks of 8 (budgets 24, one of 21), one session NaN-bombed at step 5
    and evicted; the 21-step session's final state saved and restored
    through the checkpoint store and served again to 24.  Every done
    session's series equal to its solo run (SHA-256)."""
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.abm_serve import SessionRequest, _series_sha, serve

    built = serve_model()
    eng = built.batched()
    # A session's own initial substance_1 level (the soma model draws no
    # random numbers, so a seed alone would not tell two sessions apart).
    params = [{"substance:substance_1": np.float32(0.25 * i)} for i in range(10)]
    params[6]["attr:nan_bomb_at"] = np.int32(5)
    reqs = [SessionRequest(name=f"s{i}", n_steps=21 if i == 3 else 24, seed=300 + i,
                           params=params[i]) for i in range(10)]
    lines = []
    runner = eng._jitted
    before = dict(runner.stats)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = {r.name: r for r in serve(built, reqs, slots=4, chunk=8, log=lines.append)}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    stats = {k: runner.stats[k] - before[k] for k in runner.stats}
    # The same requests served eagerly (BatchedSimulation.run in place of
    # run_jit): every session's series must be the compiled serve's.
    eng.run_jit = eng.run
    try:
        t0 = time.perf_counter()
        eager = {r.name: r for r in serve(built, reqs, slots=4, chunk=8, log=None)}
        torch.cuda.synchronize()
        eager_serve_s = time.perf_counter() - t0
    finally:
        del eng.run_jit
    differ = [n for n in results if _series_sha(results[n].obs) != _series_sha(eager[n].obs)
              or results[n].status != eager[n].status or results[n].steps != eager[n].steps]
    if differ or set(results) != set(eager):
        raise AssertionError(f"abm_serve: the compiled serve differs from the eager serve "
                             f"in {differ}")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_serve_") as d:
        first = results["s3"]
        ckpt.save(d, first.steps, {"state": first.final})
        _, back = ckpt.restore(d, {"state": built.state})
    (resumed,) = serve(built, [SessionRequest(name="s3+", n_steps=24, state=back["state"])],
                       slots=4, chunk=8, log=lines.append)
    sick = results.pop("s6")
    if sick.status != "evicted" or sick.health["nonfinite_agents"] < 1 or sick.steps >= 24:
        raise AssertionError(f"abm_serve: the bombed session ended {sick.status} at "
                             f"step {sick.steps}, health {sick.health}")
    shas = {}
    for name, r in sorted(results.items()):
        req = next(q for q in reqs if q.name == name)
        if r.status != "done" or r.steps != req.n_steps:
            raise AssertionError(f"abm_serve: {name} ended {r.status} at step {r.steps}")
        _, solo = built.run(req.n_steps, state=eng.session_state(seed=req.seed,
                                                                 params=req.params))
        if _series_sha(r.obs) != _series_sha(solo):
            raise AssertionError(f"abm_serve: {name}'s series differs from its solo run")
        shas[name] = _series_sha(r.obs)[:16]
    _, solo = built.run(24, state=eng.session_state(seed=303, params=params[3]))
    joined = {k: np.concatenate([results["s3"].obs[k]]
                                + ([resumed.obs[k]] if k in resumed.obs else []))
              for k in solo}
    if resumed.status != "done" or _series_sha(joined) != _series_sha(solo):
        raise AssertionError("abm_serve: the restored session's joined series differs "
                             "from its solo run")
    if not all(launches[k] > 0 for k in ("cell_rank", "cell_list_force", "diffusion3d")):
        raise AssertionError(f"abm_serve: launches {launches}")
    if len(set(shas.values())) != len(shas):
        raise AssertionError(f"abm_serve: sessions with equal series {shas}")
    emit("abm_serve", sessions=10, slots=4, chunk=8, agents_a_session=SERVE_AGENTS,
         serve_s=serve_s, eager_serve_s=eager_serve_s, runner=stats,
         series_sha_equal_to_the_eager_serve=True, evicted=sick.name,
         evicted_at_step=sick.steps, resumed_from_step=first.steps, series_sha=shas,
         launches=launches, nvidia_smi=nvidia_smi_line(),
         chunks=[ln for ln in lines if ln.startswith("chunk")],
         summary=[ln for ln in lines if ln.startswith("served")])


# ------------------------------------------------------ compiled batch runs

def batch_differences(a, b) -> list:
    """Keys of the leaves of two ``(bstate, obs, counts)`` results that are
    not bit-identical."""
    names = ("state", "obs", "counts")
    return differing_leaves(dict(zip(names, a)), dict(zip(names, b)))


def batch_jit_phase(name, eng, bstate, steps, dtoh_steps=None, **fields):
    """``steps`` steps of a batch eagerly (``BatchedSimulation.run``), then
    ``JIT_RUNS`` times through ``run_jit`` from the same start: each run
    bit-identical to the eager run (every leaf of every slot, every
    observable row and count) with its launches and no rollback, and the
    last run with no eager step (it starts warm and replays every step).
    Emits the times, the runner's counts, peak and reserved memory and the
    device-to-host reads of a run of ``dtoh_steps`` (default ``steps``)
    both ways, from profiled runs.  Returns the launches of the run_jit
    runs, summed."""
    dtoh_steps = dtoh_steps or steps
    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_counts(), torch.cuda.max_memory_allocated()

    eager, eager_s, eager_launches, eager_peak = timed(lambda: eng.run(bstate, steps))
    runner = eng._jitted
    runs, total = [], {k: 0 for k in eager_launches}
    for i in range(JIT_RUNS):
        before = dict(runner.stats)
        out, run_s, launches, peak = timed(lambda: eng.run_jit(bstate, steps))
        bad = batch_differences(eager, out)
        if bad:
            raise AssertionError(f"{name}: run_jit run {i} differs from the eager run in {bad}")
        if launches != eager_launches:
            raise AssertionError(f"{name}: run_jit launched {launches}, eager {eager_launches}")
        counts = {k: runner.stats[k] - before[k] for k in runner.stats}
        if counts["rollbacks"] or (i == JIT_RUNS - 1 and counts["eager_steps"]):
            raise AssertionError(f"{name}: run_jit run {i}: {counts}")
        total = add_counts(total, launches)
        runs.append(dict(run_s=run_s, step_ms=1e3 * run_s / steps, peak_memory_bytes=peak,
                         reserved_bytes=torch.cuda.memory_reserved(), **counts))
        del out
    emit(name, slots=bstate.batch_size, steps=steps, eager_run_s=eager_s,
         eager_step_ms=1e3 * eager_s / steps, eager_peak_memory_bytes=eager_peak,
         run_s=runs[-1]["run_s"], step_ms=runs[-1]["step_ms"], runs=runs,
         launches=eager_launches, bit_identical_to_eager=True,
         dtoh_steps=dtoh_steps,
         dtoh_reads_a_run=dtoh_in(lambda: eng.run_jit(bstate, dtoh_steps)),
         eager_dtoh_reads_a_run=dtoh_in(lambda: eng.run(bstate, dtoh_steps)),
         nvidia_smi=nvidia_smi_line(), **fields)
    return total


def phase_batch_sweep_jit():
    """batch_sweep's sweep (8 slots x 75,000 soma agents, 20 steps) without
    its per-step clock op (which synchronises), eagerly and through
    ``run_jit``."""
    built = sweep_model().observe_kinds(frequency=SWEEP_STEPS // 4).observe(
        "exposure_sum", lambda s: s.pool.get("exposure").sum()).build()
    eng = built.batched()
    params = {"substance:substance_1": np.linspace(0.0, 3.5, SWEEP_SLOTS).astype(np.float32)}
    bstate = eng.sweep_state(seeds=[100 + b for b in range(SWEEP_SLOTS)], params=params)
    return batch_jit_phase("batch_sweep_jit", eng, bstate, SWEEP_STEPS,
                           agents_a_slot=SWEEP_AGENTS)


def phase_batch_spheroid_morton_jit(window):
    """batch_spheroid_morton's 4 slots (window ``window``), eagerly and
    through ``run_jit``: every step of both takes the window kernel."""
    built, starts = spheroid_batch_setup(impl="fused", tile_order="morton",
                                         morton_block=SPH_BLOCK, morton_window=window)
    eng = built.batched()
    launches = batch_jit_phase("batch_spheroid_morton_jit", eng, eng.stack(starts),
                               SPHB_STEPS, cells_a_slot=SPHB_CELLS, half_window=window)
    want = {"cell_window_force": JIT_RUNS * SPHB_STEPS, "cell_list_force": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"batch_spheroid_morton_jit: launches {launches}, want {want}")
    return launches


def phase_batch_jit_divergence():
    """crowd_model's model as a batch of two sessions: session 0 from its
    start, crowded from step 5 (its Morton gate fails from step 6), session
    1 from the same start at step 100 with the crowd applied, so the linear
    kernel from its first step.  The runner speculates session 0's window
    branch, rolls back, and gives the eager batch's bits; its launches less
    those of the replays it threw away are the eager batch's, and both
    kernels run."""
    steps = 10
    built, state, crowd = crowd_model()
    ahead = crowd(None, dataclasses.replace(state, step=torch.full_like(state.step, 100)))
    eng = built.batched()
    bstate = eng.stack([state, ahead])
    reset_counts()
    eager = eng.run(bstate, steps)
    torch.cuda.synchronize()
    eager_launches = read_counts()
    reset_counts()
    out = eng.run_jit(bstate, steps)
    torch.cuda.synchronize()
    launches = read_counts()
    stats = eng._jitted.stats
    thrown = eng._jitted.rolled_back_launches
    kept = {k: v - thrown[k] for k, v in launches.items()}
    bad = batch_differences(eager, out)
    if bad or kept != eager_launches:
        raise AssertionError(f"batch_jit_divergence: run_jit differs from the eager run in "
                             f"{bad}, launches {launches} less {dict(thrown)} rolled back "
                             f"(eager {eager_launches})")
    if stats["rollbacks"] < 1 or not (launches["cell_window_force"]
                                      and launches["cell_list_force"]):
        raise AssertionError(f"batch_jit_divergence: {stats}, launches {launches}")
    branches = sorted({dict(k[1])["window"] for k in eng._jitted._graphs})
    emit("batch_jit_divergence", slots=2, steps=steps, crowd_at=5, launches=launches,
         rolled_back_launches=dict(thrown), eager_launches=eager_launches,
         window_branches=branches, bit_identical_to_eager=True, **stats)


def batch_kernel_rows(sweep, dense):
    """The four kernels of the batched path at its shapes, each call over
    every slot: ``cell_rank``, ``cell_list_force`` and ``diffusion3d`` at
    batch_sweep's final state (8 slots), ``pairwise_force`` at
    batch_spheroid_dense's (4 slots, the spheroid_dense capacity split in
    four).  Each held bit for bit against one launch a slot (timed as
    ``solo_ms``, the B calls together) and against its plain version."""
    from repro_torch.core.grid import _live_cell_ids, _slot_keys, build_index, sort_agents
    from repro_torch.core.grid import candidate_neighbors_arrays
    from repro_torch.core.slots import to_flat
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.cell_force.ref import cell_list_force_ref
    from repro_torch.kernels.cell_rank import kernel as cr_k
    from repro_torch.kernels.cell_rank import ops as cr_ops
    from repro_torch.kernels.diffusion3d import kernel as d3_k
    from repro_torch.kernels.diffusion3d.ref import diffusion_step_ref
    from repro_torch.kernels.pairwise_force import kernel as pf_k
    from repro_torch.kernels.pairwise_force.ref import pairwise_force_ref

    rows = []
    built, final, launches = sweep
    spec, b = built.config.spec, final.batch_size
    n_cells, m = spec.n_cells, spec.max_per_cell
    pool = to_flat(final.states).pool
    c = pool.capacity // b
    per = lambda x, s: x.reshape((b, -1) + tuple(x.shape[1:]))[s]

    def same_as_solo(name, got, solo):
        for s, want in enumerate(solo):
            if not torch.equal(got[s] if got.shape[0] == b else per(got, s), want):
                raise AssertionError(f"{name}: slot {s} differs from a launch of that slot "
                                     f"alone")

    # ---- cell_rank over session-offset keys.
    cid = _live_cell_ids(spec, pool.position, pool.alive)
    keys = _slot_keys(cid, b, n_cells + 1)
    n_all = b * (n_cells + 1) - 1
    check_cell_rank(keys, n_all)
    cids = [per(cid, s).contiguous() for s in range(b)]
    same_as_solo("cell_rank", cr_k.cell_rank_cuda(keys, n_all),
                 [cr_k.cell_rank_cuda(x, n_cells) for x in cids])
    rows.append(dict(
        name=f"cell_rank[{b} slots]", route="cuda",
        source="src/repro_torch/kernels/cell_rank/csrc/cell_rank.cu",
        replaces="src/repro/kernels/cell_rank/kernel.py:88",
        launches=launches["cell_rank"], max_abs_err=0.0, slots=b,
        plain_ms=cuda_ms(lambda: cr_ops.cell_rank_tiled(keys, n_all), 3), library_ms=None,
        solo_ms=cuda_ms(lambda: [cr_k.cell_rank_cuda(x, n_cells) for x in cids], 20),
        **cell_rank_times(keys, n_all),
    ))

    # ---- cell_list_force with the slot axis.
    index = build_index(spec, pool)
    if bool(index.overflowed.any()):
        raise AssertionError("kernels: a slot of the final sweep state overflowed a box")
    radius = pool.radius()
    call = lambda: cf_k.cell_list_force_cuda(pool.position, radius, index.cell_list, spec.dims,
                                             num_out=c)
    solo_args = [(per(pool.position, s), per(radius, s), index.cell_list[s])
                 for s in range(b)]
    solo = lambda: [cf_k.cell_list_force_cuda(p, r, cl, spec.dims) for p, r, cl in solo_args]
    got = call()
    same_as_solo("cell_list_force", got, solo())
    cnt = index.cell_count.reshape(-1).long()
    k_max = max(int(cnt.max()), 1)
    chunk = max(1, int(1e8 // (27 * k_max * k_max)))
    plain = lambda: torch.cat([
        sum(cell_list_force_ref(p, r, cl, spec.dims, cells=(lo, min(lo + chunk, n_cells)))
            for lo in range(0, n_cells, chunk)) for p, r, cl in solo_args])
    want, plain_ms = warm_timed(plain)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"cell_list_force[{b} slots]: max error {err} vs max|F| {scale}")
    row_bytes = (torch.clamp(cnt + 1, max=m) * 4 + 31) // 32 * 32
    force_bytes = int(row_bytes.sum()) + int(torch.clamp(cnt, max=m).sum()) * 16 + b * c * 12
    pairs = sum(box_pairs(index.cell_count[s], spec.dims) for s in range(b))
    rows.append(dict(
        name=f"cell_list_force[{b} slots]", route="cuda",
        source="src/repro_torch/kernels/cell_force/csrc/cell_list_force.cu",
        replaces="src/repro/kernels/cell_force/kernel.py:186",
        launches=launches["cell_list_force"], max_abs_err=err, slots=b,
        ms=cuda_ms(call, 20), solo_ms=cuda_ms(solo, 10), plain_ms=plain_ms,
        library_ms=None, **bound(force_bytes, 12 * pairs), pair_evaluations=pairs,
        max_force=scale, fullest_box=k_max,
    ))
    del index, got, want

    # ---- diffusion3d with the slot axis: one substance's 8 fields.
    g = final.states.grids["substance_0"]
    u = g.concentration.contiguous()
    nu = g.diffusion_coefficient * built.config.dt / g.spacing**2
    decay = g.decay_constant * built.config.dt
    call = lambda: d3_k.diffusion_step_cuda(u, nu, decay)
    fields = [u[s].contiguous() for s in range(b)]
    solo = lambda: [d3_k.diffusion_step_cuda(x, nu, decay) for x in fields]
    got, want = call(), diffusion_step_ref(u, nu, decay)
    if not torch.equal(got, want):
        raise AssertionError(f"diffusion3d[{b} slots]: {int((got != want).sum())} values "
                             f"differ from the plain version")
    same_as_solo("diffusion3d", got, solo())
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device=u.device)
    w[0, 0, 1, 1, 1] = (1.0 - decay) - 6.0 * nu
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[0, 0, i, j, k] = nu
    conv = lambda: torch.nn.functional.conv3d(u[:, None], w, padding=1)
    rows.append(dict(
        name=f"diffusion3d[{b} slots]", route="cuda",
        source="src/repro_torch/kernels/diffusion3d/csrc/diffusion3d.cu",
        replaces="src/repro/kernels/diffusion3d/kernel.py:61",
        launches=launches["diffusion3d"], max_abs_err=0.0, slots=b,
        ms=cuda_ms(call, 50), device_ms=graph_ms(call, 20), solo_ms=cuda_ms(solo, 20),
        plain_ms=cuda_ms(lambda: diffusion_step_ref(u, nu, decay), 10),
        library_ms=cuda_ms(conv, 10), **bound(2 * u.numel() * 4, 8 * u.numel()),
        library_max_abs_err=float((conv()[:, 0] - want).abs().max()),
    ))
    del got, want, fields

    # ---- pairwise_force over a batch's flat candidates.
    built, final, launches = dense
    spec, b = built.config.spec, final.batch_size
    pool = sort_agents(spec, to_flat(final.states).pool)
    index = build_index(spec, pool, assume_sorted=True)
    pos, rad = pool.position, pool.radius()
    cand, mask = candidate_neighbors_arrays(spec, index, pos, pool.alive)
    c = pool.capacity // b
    call = lambda: pf_k.pairwise_force_cuda(pos, rad, cand, mask)
    solo_args = []
    for s in range(b):
        sp = dataclasses.replace(pool, **{
            f: per(getattr(pool, f), s) for f in ("position", "diameter", "kind", "age",
                                                  "alive", "static")},
            attrs={k: per(v, s) for k, v in pool.attrs.items()}, overflow=pool.overflow[s])
        si = build_index(spec, sp, assume_sorted=True)
        sc, sm = candidate_neighbors_arrays(spec, si, sp.position, sp.alive)
        solo_args.append((sp.position, sp.radius(), sc, sm))
    solo = lambda: [pf_k.pairwise_force_cuda(*a) for a in solo_args]
    got = call()
    same_as_solo("pairwise_force", got, solo())
    step = 8192
    plain = lambda: torch.cat([
        pairwise_force_ref(pos[i:i + step], rad[i:i + step], cand[i:i + step],
                           mask[i:i + step], all_position=pos, all_radius=rad)
        for i in range(0, pos.shape[0], step)])
    want = plain()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"pairwise_force[{b} slots]: max error {err} vs max|F| {scale}")
    slots_set = int(mask.sum())
    n, kdim = cand.shape
    rows.append(dict(
        name=f"pairwise_force[{b} slots]", route="cuda",
        source="src/repro_torch/kernels/pairwise_force/csrc/pairwise_force.cu",
        replaces="src/repro/kernels/pairwise_force/kernel.py:107",
        launches=launches["pairwise_force"], max_abs_err=err, slots=b,
        ms=cuda_ms(call, 20), device_ms=graph_ms(call, 20), solo_ms=cuda_ms(solo, 10),
        plain_ms=cuda_ms(plain, 1), library_ms=None,
        **bound(n * kdim + 4 * slots_set + n * 16 + n * 12, 12 * slots_set),
        candidate_slots=n * kdim, masked_in_slots=slots_set, max_force=scale,
    ))
    del cand, mask, solo_args
    for r in rows:
        emit("kernel", **r)
    return rows


def batch_window_row(morton):
    """cell_window_force over batch_spheroid_morton's 4 slots in one launch:
    the final state's flat view sorted as the next step sorts it, each
    slot's index built within its own grid (within-slot cell ids).  Held bit
    for bit against one launch a slot (``solo_ms`` times the four), against
    the plain version slot by slot and against cell_list_force over the
    same slots (atol 1e-5 x max|F|); the bound as path 2's row counts it."""
    from repro_torch.core.forces import _morton_window_ok
    from repro_torch.core.grid import build_index, sort_agents
    from repro_torch.core.slots import to_flat
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.cell_force.ref import cell_window_force_ref, window_walk

    built, final, launches, window = morton
    spec, b = built.config.spec, final.batch_size
    pool = sort_agents(spec, to_flat(final.states).pool)
    index = build_index(spec, pool, assume_sorted=True)
    gate = _morton_window_ok(spec, index, SPH_BLOCK, window) & ~index.overflowed
    if not bool(gate.all()):
        raise AssertionError(f"kernels: the window does not cover every slot ({gate.tolist()})")
    pos, rad, cid = pool.position, pool.radius(), index.cell_of_agent
    c = pool.capacity // b
    if int(cid.max()) > spec.n_cells:
        raise AssertionError("kernels: cell ids are not within each slot's grid")
    per = lambda x, s: x[s * c:(s + 1) * c]
    call = lambda: cf_k.cell_window_force_cuda(pos, rad, cid, spec.dims, block=SPH_BLOCK,
                                               half_window=window, slots=b)
    solo_args = [(per(pos, s).contiguous(), per(rad, s).contiguous(), per(cid, s).contiguous())
                 for s in range(b)]
    solo = lambda: [cf_k.cell_window_force_cuda(*a, spec.dims, block=SPH_BLOCK,
                                                half_window=window) for a in solo_args]
    got = call()
    for s, want in enumerate(solo()):
        if not torch.equal(per(got, s), want):
            raise AssertionError(f"cell_window_force[{b} slots]: slot {s} differs from a "
                                 f"launch of that slot alone")
    nbw = -(-c // SPH_BLOCK)
    plain = lambda: torch.cat([
        sum(cell_window_force_ref(*a, spec.dims, block=SPH_BLOCK, half_window=window,
                                  tiles=(t, min(t + 64, nbw))) for t in range(0, nbw, 64))
        for a in solo_args])
    want, plain_ms = warm_timed(plain)
    linear = cf_k.cell_list_force_cuda(pos, rad, index.cell_list, spec.dims, num_out=c)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    witness = float((got - linear).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale or not witness <= 1e-5 * scale:
        raise AssertionError(f"cell_window_force[{b} slots]: max error {err} (vs "
                             f"cell_list_force {witness}) vs max|F| {scale}")
    pairs = sum(box_pairs(index.cell_count[s], spec.dims) for s in range(b))
    visited = sum(int((e - st).sum()) for st, e in (
        window_walk(a[2], spec.dims, SPH_BLOCK, window) for a in solo_args))
    design_bytes = b * 16 * spec.n_cells + 8 * int((index.cell_count > 0).sum()) + 36 * b * c
    row = dict(
        name=f"cell_window_force[{b} slots]", route="cuda",
        source="src/repro_torch/kernels/cell_force/csrc/cell_window_force.cu",
        replaces="src/repro/kernels/cell_force/kernel.py:330",
        launches=launches["cell_window_force"], max_abs_err=err, slots=b,
        ms=cuda_ms(call, 20), solo_ms=cuda_ms(solo, 20), plain_ms=plain_ms, library_ms=None,
        **bound(32 * b * c, 12 * pairs),
        design_bound_ms=bound(design_bytes, 12 * pairs)["bound_ms"], design_bytes=design_bytes,
        half_window=window, block=SPH_BLOCK, pair_evaluations=pairs,
        candidate_rows_visited=visited, max_force=scale, max_err_vs_cell_list_force=witness,
    )
    emit("kernel", **row)
    return [row]


# ---------------------------------------------------------------- calibration

def analytical_sir(n, i0, beta, gamma, steps):
    """RK4 integration of the Kermack-McKendrick ODEs (hourly steps), as
    examples/epidemiology_sir.py integrates them: (steps + 1, 3)."""
    y = np.array([n - i0, i0, 0.0], np.float64)

    def f(y):
        s, i, _ = y
        inf = beta * s * i / n
        return np.array([-inf, inf - gamma * i, gamma * i])

    out = [y.copy()]
    for _ in range(steps):
        k1 = f(y)
        k2 = f(y + 0.5 * k1)
        k3 = f(y + 0.5 * k2)
        k4 = f(y + k3)
        y = y + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        out.append(y.copy())
    return np.stack(out)


def sir_model(params, n, i0, space, seed=0):
    """The agent-based SIR model of examples/epidemiology_sir.py (random
    movement, infection, recovery, the infectious-time op, toroidal space)
    on the card, built, its S/I/R counts observed every step."""
    from repro_torch import Simulation
    from repro_torch.core import (INFECTED, SUSCEPTIBLE, prng, random_movement,
                                  sir_infection, sir_recovery)

    radius, prob, move = (float(p) for p in params)

    def infectious_time(ctx, state):
        pool = state.pool
        dt = torch.where(pool.alive & (pool.kind == INFECTED), ctx.config.dt, 0.0)
        return dataclasses.replace(state, pool=pool.set_attr("t_inf", pool.get("t_inf") + dt))

    pos = prng.uniform(prng.PRNGKey(seed), (n, 3), 0.0, space)
    kind = torch.where(torch.arange(n) < i0, INFECTED, SUSCEPTIBLE).to(torch.int32)
    built = (
        Simulation(space=(0.0, space), cell_size=max(radius, 4.0), boundary="toroidal",
                   dt=1.0, max_per_cell=128, seed=seed, device="cuda")
        .add_agents(n, position=pos, diameter=0.5, kind=kind, t_inf=0.0)
        .use(random_movement(move), sir_infection(radius, prob), sir_recovery(SIR_GAMMA))
        .op(infectious_time, name="infectious_time", phase="post")
        .observe_kinds("counts", n_kinds=3)
        .build()
    )
    return built


def sir_counts(params, n, i0, space, steps, seed=0):
    """:func:`sir_model` run ``steps`` steps: the S/I/R counts a step,
    (steps, 3), and the final state."""
    final, obs = sir_model(params, n, i0, space, seed).run(steps)
    counts = obs["counts"].cpu().numpy()
    if counts.shape != (steps, 3) or not (counts.sum(axis=1) == n).all():
        raise AssertionError(f"calibrate: counts {counts.shape} do not sum to {n} a step")
    return counts, final


def phase_calibrate():
    """``optim.pso.optimize`` over the SIR model at the example's full size
    on the card (8 runs), then the fast mode's calibrated triple against the
    analytical solution."""
    from repro_torch.core import RECOVERED
    from repro_torch.optim import pso

    truth = analytical_sir(CAL_AGENTS, CAL_INFECTED, SIR_BETA, SIR_GAMMA, CAL_STEPS)[1:]
    runs = []

    def objective(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, _ = sir_counts(p, CAL_AGENTS, CAL_INFECTED, CAL_SPACE, CAL_STEPS)
        runs.append(time.perf_counter() - t0)
        return float(np.mean(((counts - truth) / CAL_AGENTS) ** 2))

    t0 = time.perf_counter()
    best, err, history = pso.optimize(objective, CAL_BOUNDS, n_iters=CAL_ITERS,
                                      config=pso.PSOConfig(n_particles=CAL_PARTICLES,
                                                           seed=CAL_SEED))
    calibration_s = time.perf_counter() - t0
    if len(runs) != CAL_PARTICLES * (CAL_ITERS + 1) or not np.isfinite(err):
        raise AssertionError(f"calibrate: {len(runs)} runs, best MSE {err}")
    median_s = statistics.median(runs)
    full_run_s = median_s * CAL_FULL_STEPS / CAL_STEPS

    params, n, i0, space, steps = SIR_FAST
    fast_truth = analytical_sir(n, i0, SIR_BETA, SIR_GAMMA, steps)[1:]
    counts, final = sir_counts(params, n, i0, space, steps)
    rmse = float(np.sqrt(np.mean(((counts - fast_truth) / n) ** 2)))
    recovered = final.pool.kind == RECOVERED
    if not rmse < 0.08 or not bool(recovered.any()):
        raise AssertionError(f"calibrate: the fast mode's triple gives RMSE {rmse} "
                             f"(bar 0.08), {int(recovered.sum())} recovered")
    emit("calibrate", agents=CAL_AGENTS, infected=CAL_INFECTED, space=CAL_SPACE,
         steps=CAL_STEPS, bounds=CAL_BOUNDS, n_particles=CAL_PARTICLES, n_iters=CAL_ITERS,
         seed=CAL_SEED, runs=len(runs), run_s=runs, median_run_s=median_s,
         median_step_ms=1e3 * median_s / CAL_STEPS, calibration_s=calibration_s,
         full_steps=CAL_FULL_STEPS, full_run_s_reckoned=full_run_s,
         full_calibration_runs=CAL_FULL_RUNS,
         full_calibration_s_reckoned=CAL_FULL_RUNS * full_run_s, history=history,
         best=[float(x) for x in best], best_mse=err,
         fast_check=dict(params=list(params), agents=n, space=space, steps=steps,
                         rmse=rmse, bar=0.08,
                         mean_infectious_h=float(final.pool.get("t_inf")[recovered].mean())))


# -------------------------------------------------------------- neurite growth

def usecases():
    """tests/torch_usecases.py, the use-case models declared through the port
    (it imports no JAX)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_usecases

    return torch_usecases


def neurite_model(n, device="cuda", **model):
    """The neurite model with the kernels of its path switched on."""
    return usecases().neurite(n, device=device, impl="fused", rank_impl="cuda", **model)


NEU_FLOATS = ("position", "direction", "path_len")


def neurite_leaves(state, obs) -> dict:
    """The leaves the neurite phases compare, on the host."""
    pool = state.pool
    out = {f: getattr(pool, f).cpu() for f in ("alive", "kind", "static", "overflow")}
    out.update({f: (pool.position if f == "position" else pool.get(f)).cpu()
                for f in NEU_FLOATS})
    out.update({f"obs/{k}": v.cpu() for k, v in obs.items()})
    return out


def neurite_distance(a: dict, b: dict, label: str, atol: float = 1e-4) -> float:
    """Flags, kinds and counts of ``a`` and ``b`` equal, the float leaves
    within ``atol``; returns their largest difference."""
    bad = [k for k in a if k not in NEU_FLOATS and not torch.equal(a[k], b[k])]
    err = max(float((a[k] - b[k]).abs().max()) for k in NEU_FLOATS)
    if bad or set(a) != set(b) or not err <= atol:
        raise AssertionError(f"{label}: {bad} differ, float leaves by {err} (atol {atol})")
    return err


def phase_neurite_small():
    """The example's smoke and validation runs on the card against the CPU
    (the kernels' plain versions), each then through ``run_jit``; the
    validation run's final state meets ``neurite_main``'s bars.  Then the
    crowded case: ``run_jit`` speculates the compacted branch, rolls back
    where the active set outgrows the capacity, captures both branches and
    gives the eager run's bits.  Returns the launches of its card runs."""
    U = usecases()
    total = collections.Counter()
    for label, (n, steps) in (("smoke", NEU_SMOKE), ("validation", NEU_VALID)):
        out = {}
        for dev in ("cuda", "cpu"):
            built = neurite_model(n, dev).observe_kinds(n_kinds=2).build()
            if dev == "cuda":
                torch.cuda.synchronize()
                reset_counts()
            final, obs = built.run(steps)
            out[dev] = neurite_leaves(final, obs)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
                card_final = final
        err = neurite_distance(out["cuda"], out["cpu"], f"neurite_small[{label}] card vs CPU")
        want = {"cell_rank": steps + len(range(0, steps, 16)), "cell_list_force": 0}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"neurite_small[{label}]: launches {launches}, want {want}")
        bars = None
        if label == "validation":
            # The example's main on the card: four run_jit chunks, its bars.
            bars = U.neurite_bars(card_final.pool, n)
            reset_counts()
            main_bars = U.neurite_main(n, steps, jit=True, device="cuda", impl="fused",
                                       rank_impl="cuda")
            torch.cuda.synchronize()
            total.update(read_counts())
            if main_bars != bars:
                raise AssertionError(f"neurite_small: neurite_main(jit=True) gives {main_bars}, "
                                     f"the eager run {bars}")
        card = neurite_model(n).observe_kinds(n_kinds=2).build()
        total.update(jit_phase(f"neurite_small_jit[{label}]", card, steps, warm=True))
        total.update(launches)
        emit("neurite_small", run=label, neurons=n, steps=steps,
             alive=int(out["cuda"]["alive"].sum()),
             static=int(out["cuda"]["static"].sum()), max_float_err_vs_cpu=err,
             launches=launches, bars=bars and dict(alive=bars[0], static_fraction=bars[1]))

    n, steps = NEU_VALID[0], NEU_CROWD_STEPS
    built = neurite_model(n, active_capacity=NEU_CROWD_ACTIVE).observe_kinds(n_kinds=2).build()
    reset_counts()
    eager = neurite_leaves(*built.run(steps))
    torch.cuda.synchronize()
    eager_launches = read_counts()
    reset_counts()
    got = neurite_leaves(*built.run_jit(steps))
    torch.cuda.synchronize()
    launches = read_counts()
    runner = built._jitted
    kept = {k: v - runner.rolled_back_launches[k] for k, v in launches.items()}
    bad = [k for k in eager if not torch.equal(eager[k], got[k])]
    branches = sorted({dict(k[1])["crowded"] for k in runner._graphs})
    if bad or kept != eager_launches:
        raise AssertionError(f"neurite_small[crowded]: run_jit differs from the eager run in "
                             f"{bad}, launches {launches} less {dict(runner.rolled_back_launches)}"
                             f" rolled back (eager {eager_launches})")
    if runner.stats["rollbacks"] < 1 or branches != [False, True] or not (
            eager_launches["cell_list_force"]):
        raise AssertionError(f"neurite_small[crowded]: {runner.stats}, crowded branches "
                             f"captured {branches}, eager launches {eager_launches}")
    total.update(launches)
    emit("neurite_small", run="crowded", neurons=n, steps=steps,
         active_capacity=NEU_CROWD_ACTIVE, eager_launches=eager_launches, launches=launches,
         rolled_back_launches=dict(runner.rolled_back_launches), crowded_branches=branches,
         bit_identical_to_eager=True, **runner.stats)
    return dict(total)


def neurite_census():
    """A post op that records the fused kernel's launch count after each
    eager step (a host counter: no device read), and its list."""
    from repro_torch.core import Operation

    seen = []

    def fn(ctx, state):
        seen.append(read_counts()["cell_list_force"])
        return state

    return Operation("census", fn, phase="post"), seen


def neurite_pass(built, state, jit: bool) -> dict:
    """NEU_STEPS steps from ``state`` in chunks (NEU_GATE_STEP, then up to
    each multiple of NEU_CHUNK), eagerly or through ``run_jit``: each
    chunk's wall, the state after the gate step and at the end, the alive
    and active counts and the static fraction after each chunk (read
    outside the clock), launches and peak memory."""
    ends = [NEU_GATE_STEP] + list(range(NEU_CHUNK, NEU_STEPS + 1, NEU_CHUNK))
    run = built.run_jit if jit else built.run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, census, at, gate = [], [], 0, None
    for end in ends:
        t0 = time.perf_counter()
        state, _ = run(end - at, state=state)
        torch.cuda.synchronize()
        walls.append((end - at, time.perf_counter() - t0))
        at = end
        pool = state.pool
        alive = int(pool.alive.sum())
        census.append(dict(step=end, alive=alive, active=int((pool.alive & ~pool.static).sum()),
                           static_fraction=int(pool.static.sum()) / max(alive, 1)))
        if end == NEU_GATE_STEP:
            gate = state
    chunk_ms = [1e3 * s / n for n, s in walls if n == NEU_CHUNK]
    return dict(final=state, gate=gate, walls=walls, census=census, launches=read_counts(),
                peak=torch.cuda.max_memory_allocated(),
                median_step_ms=statistics.median(chunk_ms), chunk_step_ms=chunk_ms)


def phase_neurite():
    """The example's model at 900 neurons (NEU_* above) from one start, with
    compaction and without, each eagerly and twice through ``run_jit`` (the
    first captures, the second replays): every run_jit pass bit-identical to
    its eager pass at the gate step and at the end, with its launches; the
    two eager runs equal at the gate step (flags exact, positions atol
    1e-4); ``neurite_main``'s bars per neuron at the end of both.  Returns
    the full run's built model and eager final state, and the phase's
    launches."""
    from repro_torch.core import morton
    from repro_torch.kernels.cell_force import kernel as cf_k

    U = usecases()
    gates, total = {}, collections.Counter()
    cf_k.crowded_tiles(torch.device("cuda", 0), reset=True)
    for label, active in (("compaction", NEU_ACTIVE), ("full", None)):
        census_op, seen = neurite_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = neurite_model(NEU_NEURONS, space=NEU_SPACE, plate=NEU_PLATE,
                              cue_top=NEU_CUE_TOP, capacity=NEU_CAPACITY,
                              active_capacity=active).op(census_op).build()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        spec = built.config.spec
        assert spec.dims == (int(NEU_SPACE // 4),) * 3 and spec.max_per_cell == 128
        assert built.state.grids["guide"].concentration.shape == (int(NEU_SPACE // 5),) * 3
        eager = neurite_pass(built, built.state, jit=False)
        per_step = [b - a for a, b in zip([0] + seen[:-1], seen)]
        crowded = [i for i, d in enumerate(per_step) if d]
        passes = []
        for i in range(JIT_RUNS):
            before = dict(built._jitted.stats)
            out = neurite_pass(built, built.state, jit=True)
            for at in ("gate", "final"):
                bad = differing_leaves(eager[at], out[at])
                if bad:
                    raise AssertionError(f"neurite[{label}]: run_jit pass {i} differs from "
                                         f"the eager pass at the {at} step in {bad}")
            if out["launches"] != eager["launches"]:
                raise AssertionError(f"neurite[{label}]: run_jit launched {out['launches']}, "
                                     f"eager {eager['launches']}")
            counts = {k: built._jitted.stats[k] - before[k] for k in before}
            if counts["rollbacks"] or (i == JIT_RUNS - 1 and counts["eager_steps"]):
                raise AssertionError(f"neurite[{label}]: run_jit pass {i}: {counts}")
            total.update(out["launches"])
            passes.append(dict(median_step_ms=out["median_step_ms"],
                               chunk_step_ms=out["chunk_step_ms"], peak_memory_bytes=out["peak"],
                               **counts))
            del out
        total.update(eager["launches"])
        bars = U.neurite_bars(eager["final"].pool, NEU_NEURONS)
        # The Morton sort ranks with cell_rank up to MAX_TABLE_CELLS boxes;
        # past them (160^3 here) it takes a stable argsort, as the reference.
        sorts = (len(range(0, NEU_STEPS, built.config.sort_frequency))
                 if spec.n_cells <= morton.MAX_TABLE_CELLS else 0)
        want = {"cell_rank": NEU_STEPS + sorts,
                "cell_list_force": len(crowded) if active else NEU_STEPS}
        if any(eager["launches"][k] != v for k, v in want.items()):
            raise AssertionError(f"neurite[{label}]: launches {eager['launches']}, want {want}")
        gates[label] = eager["gate"]
        emit("neurite", run=label, neurons=NEU_NEURONS, space=NEU_SPACE, plate=NEU_PLATE,
             boxes=spec.n_cells, max_per_cell=spec.max_per_cell, capacity=NEU_CAPACITY,
             active_capacity=active, steps=NEU_STEPS, setup_s=setup_s,
             census=eager["census"], crowded_steps=crowded if active else None,
             eager_median_step_ms=eager["median_step_ms"],
             eager_chunk_step_ms=eager["chunk_step_ms"],
             replayed_median_step_ms=passes[-1]["median_step_ms"], jit_passes=passes,
             launches=eager["launches"], eager_peak_memory_bytes=eager["peak"],
             bars=dict(alive=bars[0], static_fraction=bars[1]),
             capacity_overflow=int(eager["final"].pool.overflow),
             run_jit_bit_identical_to_eager=True, nvidia_smi=nvidia_smi_line())
        if label == "compaction":
            del built, eager          # the runner's graphs and their pool
        torch.cuda.empty_cache()

    on, off = gates["compaction"], gates["full"]
    gate_err = neurite_distance(neurite_leaves(on, {}), neurite_leaves(off, {}),
                                f"neurite: compaction vs full at step {NEU_GATE_STEP}")
    crowded_tiles = cf_k.crowded_tiles(torch.device("cuda", 0), reset=True)
    emit("neurite_gate", step=NEU_GATE_STEP, max_float_err=gate_err,
         flags_equal=True, alive=int(on.pool.alive.sum()))
    return built, eager["final"], dict(total), crowded_tiles


def neurite_kernel_rows(built, final, launches, crowded_in_path):
    """cell_rank and cell_list_force at the 900-neuron run's final state
    (160^3 boxes, mostly empty), with the neurite phases' launches."""
    spec, pool = built.config.spec, final.pool
    rows = [cell_rank_row(spec, pool, launches, name="cell_rank[neurite]"),
            cell_list_force_row(spec, pool, launches, crowded_in_path,
                                name="cell_list_force[neurite]")]
    for r in rows:
        emit("kernel", **r)
    return rows


def phase_neurite_batch():
    """NEU_SLOTS slots of the validation run's model that differ only in
    their seed, NEU_VALID[1] steps in one batch with compaction: each slot
    bit-identical to its solo card run; then eagerly and through the batch
    engine's ``run_jit`` as batch_jit_phase does.  Returns the launches."""
    n, steps = NEU_VALID
    built = neurite_model(n).observe_kinds(n_kinds=2).build()
    eng = built.batched()
    seeds = list(range(NEU_SLOTS))
    bstate = eng.sweep_state(seeds=seeds)
    torch.cuda.synchronize()
    reset_counts()
    final, obs, counts = eng.run(bstate, steps)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {"cell_rank": steps + len(range(0, steps, 16)), "cell_list_force": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"neurite_batch: launches {launches}, want {want}")
    alive = []
    for b, seed in enumerate(seeds):
        solo, solo_obs = built.run(steps, state=eng.session_state(seed=seed))
        got = slots_of(final.states, NEU_SLOTS)[b]
        bad = differing_leaves({"state": solo, "obs": solo_obs},
                               {"state": got, "obs": {k: v[b][: int(counts[k][b])]
                                                      for k, v in obs.items()}})
        if bad:
            raise AssertionError(f"neurite_batch: slot {b} differs from its solo run in {bad}")
        alive.append(int(got.pool.alive.sum()))
    if len(set(alive)) < 2:
        raise AssertionError(f"neurite_batch: the seeds gave one arbor size {alive}")
    emit("neurite_batch", slots=NEU_SLOTS, neurons=n, steps=steps, seeds=seeds, alive=alive,
         launches=launches, slots_bit_identical_to_solo=True)
    # The device-to-host reads counted over 10 steps: a profiled 100-step
    # eager batch records ~10^5 launches, which take the profiler tens of
    # seconds to hand back.
    jit = batch_jit_phase("neurite_batch_jit", eng, bstate, steps, dtoh_steps=10, neurons=n)
    return add_counts(launches, jit)


# ---------------------------------------------------------------- distributed

def dist_force_case(corners: bool):
    """tests/dist_scenarios.py's 4x2 force-only relaxation (500 agents,
    extent 16 a rank, halo 2, halo buffers of 96, migration buffers of 48,
    int16 codec) and, with ``corners``, its fused-parity layout: three
    clusters of 24 overlapping agents on rank corners."""
    from repro_torch.core.distributed import DomainConfig

    dcfg = DomainConfig(mesh_axes=("data", "model"), axis_sizes=(4, 2), extent=16.0,
                        halo_width=2.0, halo_capacity=96, migrate_capacity=48, depth=16.0,
                        halo_codec="int16")
    rng = np.random.default_rng(42)
    pos = rng.uniform(2.0, [62.0, 30.0, 14.0], (500, 3))
    if corners:
        rng = np.random.default_rng(3)
        pos = np.concatenate([pos] + [
            np.stack([rng.uniform(cx - 1.5, cx + 1.5, 24), rng.uniform(cy - 1.5, cy + 1.5, 24),
                      rng.uniform(4.0, 12.0, 24)], axis=1)
            for cx, cy in ((16.0, 16.0), (32.0, 16.0), (48.0, 16.0))])
    return dcfg, pos.astype(np.float32), (256 if corners else 192)


def dist_small_engine(dcfg, pos, capacity, device, mesh=None, **engine):
    """A force-only case's engine config, mesh (in-process on ``device``
    unless ``mesh``, a process mesh, is given) and initial state; grid
    ranks by cell_rank."""
    from repro_torch.core import EngineConfig, ForceParams
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    ecfg = EngineConfig(spec=dcfg.grid_spec(box_size=2.0, max_per_cell=32, rank_impl="cuda"),
                        force_params=ForceParams(), dt=0.05, min_bound=0.0, max_bound=16.0,
                        boundary="open", sort_frequency=4, **engine)
    mesh = mesh or make_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=device)
    return ecfg, mesh, dist.init_dist_state(dcfg, capacity, pos, diameter=1.6,
                                            device=mesh.devices[0])


def dist_small_run(dcfg, pos, capacity, device, steps, mesh=None, **engine):
    """``steps`` distributed steps of a force-only case on ``device``
    (``"cuda"`` or ``"cpu"``); on an in-process mesh unless ``mesh`` (a
    process mesh) is given."""
    from repro_torch.core import distributed as dist

    ecfg, mesh, state = dist_small_engine(dcfg, pos, capacity, device, mesh, **engine)
    step = dist.make_distributed_step(mesh, dcfg, ecfg)
    for _ in range(steps):
        state = step(state)
    return state


def dist_small_jit(dcfg, pos, capacity, device, steps, mesh, **engine):
    """The same steps through ``jitted_distributed_runner`` on the process
    mesh ``mesh``: the final state and the runner's counts."""
    from repro_torch.core import distributed as dist

    ecfg, mesh, state = dist_small_engine(dcfg, pos, capacity, device, mesh, **engine)
    runner = dist.jitted_distributed_runner(mesh, dcfg, ecfg)
    final, _ = runner(state, steps)
    return final, dict(runner.stats)


def dist_leaf_errors(card, cpu, label, atol):
    """Integer and bool leaves of a card state equal to the CPU run's, float
    leaves within ``atol``; returns the largest float difference."""
    a, b = state_leaves(card), state_leaves(cpu)
    if list(a) != list(b):
        raise AssertionError(f"{label}: leaves differ: {sorted(set(a) ^ set(b))}")
    worst = 0.0
    for k in a:
        x, y = a[k].cpu(), b[k]
        if x.is_floating_point():
            err = float((x - y).abs().max()) if x.numel() else 0.0
            if not err <= atol:
                raise AssertionError(f"{label}: {k} differs from the CPU run by {err}")
            worst = max(worst, err)
        elif not torch.equal(x, y):
            raise AssertionError(f"{label}: {k}: {int((x != y).sum())} values differ "
                                 f"from the CPU run")
    return worst


def phase_dist_small():
    """The distributed engine at the reference's test sizes on the card
    against the port's CPU run of the same 4x2 mesh."""
    import dataclasses as dc

    out = {}
    relax = dist_force_case(False)
    corners = dist_force_case(True)
    reset_counts()
    fused = {dev: dist_small_run(*relax, dev, 5, force_impl="fused") for dev in ("cuda", "cpu")}
    out["relax_fused_5_steps_max_float_err"] = dist_leaf_errors(
        fused["cuda"], fused["cpu"], "dist_small relax", 5e-4)
    launches = read_counts()
    for name in ("cell_rank", "cell_list_force"):
        if launches[name] == 0:
            raise AssertionError(f"dist_small: {name} was not launched")
    out["relax_launches"] = launches

    runs = {}
    for impl in ("fused", "cuda"):
        reset_counts()
        for dev in ("cuda", "cpu"):
            runs[impl, dev] = dist_small_run(*corners, dev, 8, force_impl=impl)
        out[f"corners_{impl}_launches"] = read_counts()
        out[f"corners_{impl}_8_steps_max_float_err"] = dist_leaf_errors(
            runs[impl, "cuda"], runs[impl, "cpu"], f"dist_small corners {impl}", 5e-4)
    if out["corners_cuda_launches"]["pairwise_force"] == 0:
        raise AssertionError("dist_small: pairwise_force was not launched")
    gap = float((runs["fused", "cuda"].pool.position
                 - runs["cuda", "cuda"].pool.position).abs().max())
    if not gap < 5e-4:
        raise AssertionError(f"dist_small: fused and dense card runs part by {gap}")
    out["corners_fused_vs_dense_card"] = gap

    dcfg, pos, cap = corners
    overlap = dist_small_run(dc.replace(dcfg, overlap_halo=True), pos, cap, "cuda", 8,
                             force_impl="fused")
    bad = differing_leaves(runs["fused", "cuda"], overlap)
    if bad:
        raise AssertionError(f"dist_small: overlapped schedule differs from serial in {bad}")

    reset_counts()
    morton = dist_small_run(dc.replace(dcfg, overlap_halo=True), pos, cap, "cuda", 1,
                            force_impl="fused", tile_order="morton", morton_window=2)
    out["morton_overlap_launches"] = read_counts()
    if out["morton_overlap_launches"]["cell_window_force"] == 0:
        raise AssertionError("dist_small: the Morton interior pass did not launch "
                             "cell_window_force")
    serial1 = dist_small_run(dcfg, pos, cap, "cuda", 1, force_impl="fused")
    err = float((morton.pool.position - serial1.pool.position).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"dist_small: Morton-interior overlap step parts from the serial "
                             f"step by {err}")
    out["morton_overlap_vs_serial_max_err"] = err
    emit("dist_small", mesh=[4, 2], agents=[500, 572], overlap_bit_identical=True, **out)


def dist_soma(codec="int16", overlap=False, device="cuda", mesh=None, n=None, capacity=None):
    """Path 1's soma model through ``Simulation.distribute`` on a 2x2 mesh of
    ranks on the one card (or on ``mesh``, a process mesh), with a ``gid``
    attribute and a ``pop`` series (``n`` agents and ``capacity`` a rank:
    path 1's unless cut)."""
    from repro_torch.core.distributed import DomainConfig
    from repro_torch.launch.mesh import make_mesh

    half = SPACE / DIST_MESH[0]
    dcfg = DomainConfig(mesh_axes=("x", "y"), axis_sizes=DIST_MESH, extent=half,
                        halo_width=DIST_HALO, halo_capacity=DIST_HALO_CAPACITY,
                        migrate_capacity=DIST_MIGRATE_CAPACITY, depth=SPACE,
                        halo_codec=codec, overlap_halo=overlap)
    sim = dist_soma_model(device, n)
    return sim.distribute(mesh or make_mesh(DIST_MESH, ("x", "y"), devices=device), dcfg,
                          capacity=DIST_CAPACITY if capacity is None else capacity)


def dist_soma_model(device, n=None):
    n = N_AGENTS if n is None else n
    return (soma_model(n, SPACE, RESOLUTION, 0, device, gid=np.arange(n, dtype=np.int32))
            .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))


def gid_distance(a, b, dims, extent):
    """Largest distance between matched rows of ``a`` and ``b`` (the
    single-node run's), the first ``dims`` coordinates taken on the torus of
    period SPACE (the distributed engine's decomposed dims wrap, where the
    single-node closed boundary clamps): over all agents, and over those the
    single-node run keeps 20 um (two halo widths) away from every rank face
    of those dims (a rank samples and secretes into its own voxels only, so
    chemotaxis within a voxel of a face differs from the single-node run's)."""
    d = a - b
    d[:, :dims] -= SPACE * np.round(d[:, :dims] / SPACE)
    dist = np.linalg.norm(d, axis=1)
    off = b[:, :dims] - extent * np.round(b[:, :dims] / extent)
    inner = (np.abs(off) >= 2 * DIST_HALO).all(1)
    return {"all": float(dist.max()),
            "inner": float(dist[inner].max()) if inner.any() else None}


def gid_positions(state, dcfg=None):
    """``{gid: global position}`` arrays: (gid sorted, positions) of the
    live agents; a stacked distributed state is rebased rank by rank."""
    pool = state.pool
    pos = pool.position.detach().cpu().numpy().astype(np.float64)
    alive = pool.alive.cpu().numpy()
    gid = pool.get("gid").cpu().numpy()
    if dcfg is not None:
        for r in range(pos.shape[0]):
            for d, c in enumerate(dcfg.device_coords(r)):
                pos[r, :, d] += c * dcfg.extent
    pos, gid = pos[alive], gid[alive]
    order = np.argsort(gid)
    return gid[order], pos[order]


def timed_ops(dsim):
    """A copy of ``dsim``'s step whose ops add their host seconds to
    ``seconds[op name]`` (no synchronisation: the host's own time)."""
    from repro_torch.core import distributed as dist

    seconds = {}

    def wrap(op):
        fn = op.fn

        def timed(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            seconds[op.name] = seconds.get(op.name, 0.0) + time.perf_counter() - t0
            return out

        return dataclasses.replace(op, fn=timed)

    sched = dataclasses.replace(dsim.scheduler, ops=tuple(wrap(op) for op in dsim.scheduler.ops))
    step = dist.DistributedStep(mesh=dsim.step.mesh, dcfg=dsim.dcfg, config=dsim.config,
                                scheduler=sched)
    return dataclasses.replace(dsim, scheduler=sched, step=step), seconds


def dist_counters(final) -> dict:
    """The distributed state's overflow and health counters, a rank each."""
    return {"migrate_overflow": final.migrate_overflow, "halo_overflow": final.halo_overflow,
            "pool_overflow": final.pool.overflow,
            **{f"health.{f.name}": getattr(final.health, f.name)
               for f in dataclasses.fields(final.health)}}


def state_digest(state) -> str:
    """SHA-1 of every leaf of a state (its checkpoint key, dtype, shape and
    bytes), so that states held by other processes compare bit for bit."""
    import hashlib

    h = hashlib.sha1()
    for key, x in state_leaves(state).items():
        h.update(f"{key}|{x.dtype}|{tuple(x.shape)}".encode())
        h.update(x.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def phase_distributed():
    """Path 1's 600,000-agent soma model on a 2x2 mesh of four ranks on the
    card, through ``Simulation.distribute``; against the single-node card run
    of the same model in the same call.  Returns the deployment, its final
    state and launches, and the record ``distributed_procs`` is held to."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lanes
    from repro_torch.core.api import Observable
    from repro_torch.launch.mesh import count_shift_bytes

    t0 = time.perf_counter()
    # The single-node reference run, timed step by step.
    single_ends = []

    def clock_single(state):
        torch.cuda.synchronize()
        single_ends.append(time.perf_counter())
        return torch.zeros((), dtype=torch.int32, device=state.pool.device)

    built = dist_soma_model("cuda").observe("step_clock", clock_single).build()
    torch.cuda.synchronize()
    start = time.perf_counter()
    single4, obs4 = built.run(DIST_OVERLAP_STEPS)
    single, single_obs = built.run(STEPS - DIST_OVERLAP_STEPS, state=single4)
    single_step_s = [b - a for a, b in zip([start] + single_ends[:-1], single_ends)]
    single_pop = torch.cat([obs4["pop"], single_obs["pop"]]).cpu()
    single4 = gid_positions(single4)
    del built

    dsim = dist_soma()
    dcfg = dsim.dcfg
    state0 = dsim.state
    if int(state0.pool.alive.sum()) != N_AGENTS:
        raise AssertionError("distributed: binning lost agents")
    # The first exchange's band counts (corner halos included), from step 0.
    ranks = dsim.step.unstack(state0)
    bands, _ = dist.halo_exchange(dcfg, dsim.mesh, [s.pool for s in ranks],
                                  [s.codec for s in ranks])
    h, c = dcfg.halo_capacity, state0.pool.position.shape[1]
    band_counts = [[int(g_alive[c + k * h:c + (k + 1) * h].sum()) for k in range(4)]
                   for (_, _, _, g_alive, _, _) in bands]
    del bands, ranks
    setup_s = time.perf_counter() - t0

    ends = []

    def clock(state):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return torch.zeros((), dtype=torch.int32, device=state.pool.device)

    dsim = dataclasses.replace(dsim, observables=dsim.observables + (
        Observable("step_clock", clock),))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lanes.counts.reset()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with count_shift_bytes() as sent:
        s4, obs4 = dsim.run(DIST_OVERLAP_STEPS)
        final, obs16 = dsim.run(STEPS - DIST_OVERLAP_STEPS, state=s4)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - start
    lane_counts = dataclasses.asdict(lanes.counts)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([start] + ends[:-1], ends)]
    pop = torch.cat([obs4["pop"], obs16["pop"]]).cpu()
    for name in ("cell_rank", "cell_list_force"):
        if launches[name] == 0:
            raise AssertionError(f"distributed: {name} was not launched")

    # ---- the gates.
    if not bool((pop == N_AGENTS).all()) or pop.shape[0] != STEPS:
        raise AssertionError(f"distributed: population series {pop.tolist()}")
    if not torch.equal(pop, single_pop):
        raise AssertionError("distributed: population series differs from the single-node run")
    counters = dist_counters(final)
    bad = {k: int(v.sum()) for k, v in counters.items() if int(v.sum()) != 0}
    if bad:
        raise AssertionError(f"distributed: counters not zero: {bad}")
    if not bool(torch.isfinite(final.pool.position[final.pool.alive]).all()):
        raise AssertionError("distributed: non-finite positions")

    again, obs_again = dist_soma().run(STEPS)
    bad = differing_leaves(final, again)
    if bad or not torch.equal(obs_again["pop"].cpu(), pop):
        raise AssertionError(f"distributed: a second run differs in {bad or ['pop']}")
    del again

    overlap, _ = dist_soma(overlap=True).run(DIST_OVERLAP_STEPS)
    bad = differing_leaves(s4, overlap)
    if bad:
        raise AssertionError(f"distributed: the overlapped schedule differs from the serial "
                             f"run after {DIST_OVERLAP_STEPS} steps in {bad}")
    if not np.array_equal(gid_positions(s4, dcfg)[0], single4[0]):
        raise AssertionError("distributed: the live gids differ from the single-node run")
    dist_at4 = gid_distance(gid_positions(s4, dcfg)[1], single4[1], dcfg.n_decomposed,
                           dcfg.extent)
    del overlap, s4

    # ---- printed, not gated.
    sg, sp = gid_positions(single)
    dg, dp = gid_positions(final, dcfg)
    if not np.array_equal(sg, dg):
        raise AssertionError("distributed: the live gids differ from the single-node run")
    dist_int16 = gid_distance(dp, sp, dcfg.n_decomposed, dcfg.extent)
    plain, _ = dist_soma(codec="none").run(STEPS)
    dist_none = gid_distance(gid_positions(plain, dcfg)[1], sp, dcfg.n_decomposed,
                             dcfg.extent)
    del plain
    wire = dist.halo_wire_stats(final)
    ranks_n = dcfg.n_devices

    timed, seconds = timed_ops(dsim)
    timed_steps = 3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    timed.run(timed_steps, state=final)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t1
    exchange = seconds.get("migrate", 0.0) + seconds.get("halo_exchange", 0.0)
    emit("distributed", agents=N_AGENTS, mesh=list(DIST_MESH), ranks=ranks_n,
         capacity_a_rank=DIST_CAPACITY, halo_width=DIST_HALO,
         halo_capacity=DIST_HALO_CAPACITY, migrate_capacity=DIST_MIGRATE_CAPACITY,
         grid_dims_a_rank=list(dsim.config.spec.dims), steps=STEPS, setup_s=setup_s,
         run_s=run_s, median_step_ms=1e3 * statistics.median(step_s),
         step_ms=[1e3 * t for t in step_s],
         single_node_median_step_ms=1e3 * statistics.median(single_step_s),
         band_counts_step0=band_counts, band_count_max=max(max(b) for b in band_counts),
         payload_bytes_a_step=wire["payload_bytes"] / STEPS,
         baseline_bytes_a_step=wire["baseline_bytes"] / STEPS,
         compression_ratio=wire["compression_ratio"],
         host_ms_a_step_exchange=1e3 * exchange / timed_steps,
         host_ms_a_step_other_ops=1e3 * (sum(seconds.values()) - exchange) / timed_steps,
         wall_ms_a_step_timed=1e3 * timed_wall / timed_steps,
         host_ms_a_step_by_op={k: 1e3 * v / timed_steps for k, v in seconds.items()},
         launches=launches,
         launches_a_step={k: v / STEPS for k, v in launches.items() if v},
         lane_events_a_step=lane_counts["events"] / STEPS,
         lane_waits_a_step=lane_counts["waits"] / STEPS,
         peak_memory_bytes=peak,
         max_gid_distance_to_single_node={"int16": dist_int16, "none": dist_none,
                                          f"int16_after_{DIST_OVERLAP_STEPS}": dist_at4},
         overlap_bit_identical_steps=DIST_OVERLAP_STEPS, second_run_bit_identical=True,
         shift_bytes_a_rank_a_step={r: n / STEPS for r, n in sent.ranks().items()})
    record = dict(digest=state_digest(final), gid=(dg, dp), pop=pop.numpy(),
                  counters={k: v.cpu().numpy() for k, v in counters.items()},
                  launches=launches,
                  shift_bytes_a_step={r: n / STEPS for r, n in sent.ranks().items()})
    return dsim, final, launches, record


# ---------------------------------------------------- one process a rank

def procs_soma(mesh):
    """``dist_soma``'s model on ``mesh`` (this process's rank of a process
    mesh), STEPS steps with a step clock: what ``distributed_procs`` holds
    the process to, and its times."""
    from repro_torch.core.api import Observable
    from repro_torch.launch.mesh import count_shift_bytes

    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    dsim = dist_soma(device=str(dev), mesh=mesh)
    ends = []

    def clock(state):
        sync()
        ends.append(time.perf_counter())
        return torch.zeros((), dtype=torch.int32, device=state.pool.device)

    dsim = dataclasses.replace(dsim, observables=dsim.observables + (
        Observable("step_clock", clock),))
    stats, rank = dsim.mesh.stats, dsim.mesh.rank
    setup_s = time.perf_counter() - t0
    stats.reset()
    reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    start = time.perf_counter()
    with count_shift_bytes() as sent:
        final, obs = dsim.run(STEPS)
    sync()
    run_s = time.perf_counter() - start
    launches = read_counts()
    step_s = [b - a for a, b in zip([start] + ends[:-1], ends)]
    out = dict(rank=rank, device=str(dev), launches=launches, setup_s=setup_s, run_s=run_s,
               step_ms=[1e3 * t for t in step_s],
               median_step_ms=1e3 * statistics.median(step_s),
               staging_ms_a_step=1e3 * stats.staging_s / STEPS,
               staged_bytes_a_step=stats.staged_bytes / STEPS,
               wire_ms_a_step=1e3 * stats.wire_s / STEPS,
               gather_wire_ms_a_step=1e3 * stats.gather_s / STEPS,
               exchanges_a_step=stats.exchanges / STEPS,
               shift_bytes_a_step=sent.ranks()[rank] / STEPS,
               peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
               digest=state_digest(final))
    if rank == 0:
        out.update(gid=gid_positions(final, dsim.dcfg), pop=obs["pop"].cpu().numpy(),
                   counters={k: v.cpu().numpy() for k, v in dist_counters(final).items()})
    return out


def procs_rank(device, soma_ranks):
    """One process of ``distributed_procs`` (``launch.procs.spawn``'s
    worker): dist_small's corner case on the 4x2 process mesh, serial and
    overlapped, then on the first ``soma_ranks`` processes ``procs_soma``
    on DIST_MESH."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import process_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dcfg, pos, cap = dist_force_case(True)
    mesh = process_mesh(dcfg.axis_sizes, dcfg.mesh_axes, devices=device)
    out = {}
    for name, d in (("serial", dcfg), ("overlap", dataclasses.replace(dcfg, overlap_halo=True))):
        out[f"small_{name}"] = state_digest(
            dist_small_run(d, pos, cap, device, PROCS_SMALL_STEPS, mesh=mesh,
                           force_impl="fused"))
        reset_counts()
        final, stats = dist_small_jit(d, pos, cap, device, PROCS_SMALL_STEPS, mesh,
                                      force_impl="fused")
        out[f"small_jit_{name}"] = (state_digest(final), dict(stats, launches=read_counts()))
    group = tdist.new_group(list(range(soma_ranks)))
    if tdist.get_rank() < soma_ranks:
        mesh = process_mesh(DIST_MESH, ("x", "y"), devices=device, group=group)
        out["soma"] = procs_soma(mesh)
        out["jit"] = procs_soma_jit(mesh)
    # The others return at once: the four run longer than a collective on
    # the whole group may wait, and use only their subgroup from here on.
    return out


def procs_nccl_rank():
    """One process of ``distributed_procs``' NCCL run: ``procs_soma`` on
    DIST_MESH, rank r on ``cuda:r``."""
    from repro_torch.launch.mesh import process_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = process_mesh(DIST_MESH, ("x", "y"))
    return dict(procs_soma(mesh), jit=procs_soma_jit(mesh))


def procs_jit_runs(dsim):
    """Two ``run_jit`` runs of STEPS steps of ``dsim`` (a deployment on a
    process mesh) from its start, the first capturing, the second replaying:
    each run's digest, series, counters, launches, the runner's counts and
    the exchanges' costs, and the second run's wall time a step."""
    runner, stats, dev = dsim._jitted, dsim.mesh.stats, dsim.mesh.device
    runs = []
    for _ in range(2):
        before = dict(runner.stats)
        stats.reset()
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        final, obs = dsim.run_jit(STEPS)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
        counts = {k: runner.stats[k] - before[k] for k in runner.stats}
        run = dict(run_s=run_s, step_ms=1e3 * run_s / STEPS, launches=read_counts(),
                   digest=state_digest(final),
                   staging_ms_a_step=1e3 * stats.staging_s / STEPS,
                   staged_bytes_a_step=stats.staged_bytes / STEPS,
                   wire_ms_a_step=1e3 * stats.wire_s / STEPS,
                   gather_wire_ms_a_step=1e3 * stats.gather_s / STEPS,
                   exchanges_a_step=stats.exchanges / STEPS,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                   segments_a_graph=runner.stats["segments"] / max(runner.stats["graphs"], 1),
                   **counts)
        if dsim.mesh.rank == 0:
            run.update(pop=obs["pop"].cpu().numpy() if "pop" in obs else None,
                       counters={k: v.cpu().numpy() for k, v in dist_counters(final).items()})
        runs.append(run)
    return runs


def procs_soma_jit(mesh):
    """``distributed_procs_jit``'s runs on this process's rank of ``mesh``:
    ``dist_soma``'s model through ``run_jit`` with ``pop`` every step and
    with its observables off (``procs_jit_runs``), ``dist_crowd_model``'s
    rollback, and the regrowing elastic case with ``jit=True``."""
    import tempfile

    from repro_torch.launch.elastic import run_elastic_distributed

    dev = mesh.device
    dsim = dist_soma(device=str(dev), mesh=mesh)
    out = {"pop_every_step": procs_jit_runs(dsim),
           "observables_off": procs_jit_runs(dataclasses.replace(dsim, observables=()))}
    del dsim
    torch.cuda.empty_cache()
    crowd = dist_crowd_model(mesh, str(dev))
    reset_counts()
    final, obs = crowd.run_jit(DIST_CROWD_STEPS)
    torch.cuda.synchronize(dev)
    runner = crowd._jitted
    out["crowd"] = dict(digest=state_digest(final), pop=obs["pop"].cpu().numpy(),
                        launches=read_counts(),
                        rolled_back_launches=dict(runner.rolled_back_launches),
                        overflowed=sorted({dict(key[1])[f"rank{mesh.rank}/overflowed"]
                                           for key in runner._graphs}),
                        **runner.stats)
    del crowd, runner
    torch.cuda.empty_cache()
    sim, dcfg = dist_elastic_case(str(dev))
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_procs_") as d:
        final, obs, grows = run_elastic_distributed(
            sim, mesh, dcfg, DIST_ELASTIC_STEPS, d, checkpoint_every=DIST_ELASTIC_EVERY,
            capacity=DIST_ELASTIC_CAPACITY, max_regrows=4, jit=True)
    out["elastic"] = dict(digest=state_digest(final), pop=obs["pop"].cpu().numpy(),
                          grows=grows)
    return out


def dist_elastic_case(device):
    """tests/dist_scenarios.py's distributed regrowth (48 dividing agents on
    a 2x2 mesh, halo 3, pools of DIST_ELASTIC_CAPACITY a rank), ranked by
    cell_rank, its population every step: the model and its decomposition."""
    from repro_torch import Simulation
    from repro_torch.core import cell_division
    from repro_torch.core.distributed import DomainConfig

    space = 32.0
    dcfg = DomainConfig(mesh_axes=("x", "y"), axis_sizes=DIST_MESH, extent=space / 2,
                        halo_width=3.0, halo_capacity=64, migrate_capacity=32, depth=space,
                        halo_codec="none")
    pos = np.random.default_rng(5).uniform(3.0, space - 3.0, (48, 3)).astype(np.float32)
    sim = (Simulation(space=(0.0, space), cell_size=3.0, boundary="open", dt=1.0,
                      max_per_cell=32, seed=2, capacity=256, rank_impl="cuda", device=device)
           .add_agents(position=pos, diameter=2.0)
           .use(cell_division(0.5))
           .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))
    return sim, dcfg


def elastic_record(device="cuda"):
    """The elastic case on an in-process 2x2 mesh on the card, ``jit=True``:
    what the processes' elastic run is held to."""
    import tempfile

    from repro_torch.launch.elastic import run_elastic_distributed
    from repro_torch.launch.mesh import make_mesh

    sim, dcfg = dist_elastic_case(device)
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_procs_") as d:
        final, obs, grows = run_elastic_distributed(
            sim, make_mesh(DIST_MESH, ("x", "y"), devices=device), dcfg, DIST_ELASTIC_STEPS, d,
            checkpoint_every=DIST_ELASTIC_EVERY, capacity=DIST_ELASTIC_CAPACITY,
            max_regrows=4, jit=True)
    if grows < 1:
        raise AssertionError("distributed_procs_jit: the in-process elastic run did not regrow")
    return dict(digest=state_digest(final), pop=obs["pop"].cpu().numpy(), grows=grows)


def check_procs_soma(runs, record, label):
    """The processes' runs of ``dist_soma``'s model against the in-process
    card run's ``record``: bit-identical state, series and counters, the
    launches adding up, the shift bytes a rank a step equal."""
    digests = {r["digest"] for r in runs}
    if digests != {record["digest"]}:
        raise AssertionError(f"{label}: the processes' final states {sorted(digests)} are not "
                             f"the in-process run's {record['digest']}")
    head = next(r for r in runs if r["rank"] == 0)
    if not (np.array_equal(head["gid"][0], record["gid"][0])
            and np.array_equal(head["gid"][1], record["gid"][1])):
        raise AssertionError(f"{label}: gid-keyed positions differ from the in-process run")
    if not np.array_equal(head["pop"], record["pop"]):
        raise AssertionError(f"{label}: population series {head['pop'].tolist()} vs "
                             f"{record['pop'].tolist()}")
    bad = [k for k in record["counters"]
           if not np.array_equal(head["counters"][k], record["counters"][k])]
    if bad:
        raise AssertionError(f"{label}: counters differ from the in-process run: {bad}")
    for r in runs:
        missing = [k for k in ("cell_rank", "cell_list_force") if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"{label}: rank {r['rank']} launched no {missing}")
    total = functools.reduce(add_counts, [r["launches"] for r in runs])
    if {k: v for k, v in total.items() if v} != {k: v for k, v in record["launches"].items()
                                                if v}:
        raise AssertionError(f"{label}: the processes' launches {total} do not add up to the "
                             f"in-process run's {record['launches']}")
    for r in runs:
        want = record["shift_bytes_a_step"][r["rank"]]
        if r["shift_bytes_a_step"] != want:
            raise AssertionError(f"{label}: rank {r['rank']} sent {r['shift_bytes_a_step']} "
                                 f"bytes a step through Mesh.shift, in-process {want}")
    return total


def phase_distributed_procs(record, device="cuda"):
    """The distributed engine with one process a rank on the one card over
    gloo, against the in-process card runs: dist_small's corner case on
    eight processes, ``distributed``'s model on four (``record``).  The same
    processes then run ``distributed_procs_jit``'s cases; returns their
    results (the NCCL run's second, None with fewer cards than ranks) and
    the corner case's in-process digests, which that phase checks."""
    from repro_torch.launch import procs

    smi = nvidia_smi_line()
    dcfg, pos, cap = dist_force_case(True)
    small = {name: state_digest(dist_small_run(d, pos, cap, device, PROCS_SMALL_STEPS,
                                               force_impl="fused"))
             for name, d in (("serial", dcfg),
                             ("overlap", dataclasses.replace(dcfg, overlap_halo=True)))}
    (ROOT / "build").mkdir(exist_ok=True)
    if small["serial"] != small["overlap"]:
        raise AssertionError("distributed_procs: the in-process overlapped run differs from "
                             "the serial one")
    t0 = time.perf_counter()
    results = procs.spawn(procs_rank, PROCS_SMALL_RANKS, args=(device, math.prod(DIST_MESH)),
                          timeout_s=PROCS_TIMEOUT_S,
                          kernels=DIST_KERNELS if device == "cuda" else ())
    launch_s = time.perf_counter() - t0
    for name in ("serial", "overlap"):
        got = {r[f"small_{name}"] for r in results}
        if got != {small[name]}:
            raise AssertionError(f"distributed_procs: dist_small's corner case ({name}) on "
                                 f"{PROCS_SMALL_RANKS} processes differs from its in-process "
                                 f"run")
    runs = [r["soma"] for r in results if "soma" in r]
    total = check_procs_soma(runs, record, "distributed_procs")
    per = lambda key: [r[key] for r in runs]
    emit("distributed_procs", backend="gloo", processes=len(runs), agents=N_AGENTS,
         mesh=list(DIST_MESH), steps=STEPS, nvidia_smi=smi,
         small_case=dict(mesh=[4, 2], processes=PROCS_SMALL_RANKS, steps=PROCS_SMALL_STEPS,
                         serial_and_overlap_bit_identical_to_in_process=True),
         launch_s=launch_s, setup_s=per("setup_s"), run_s=per("run_s"),
         median_step_ms=per("median_step_ms"), step_ms=per("step_ms"),
         staging_ms_a_step=per("staging_ms_a_step"),
         staged_bytes_a_step=per("staged_bytes_a_step"),
         wire_ms_a_step=per("wire_ms_a_step"),
         gather_wire_ms_a_step=per("gather_wire_ms_a_step"),
         exchanges_a_step=per("exchanges_a_step"),
         shift_bytes_a_rank_a_step=per("shift_bytes_a_step"),
         peak_memory_bytes=per("peak_memory_bytes"),
         launches=per("launches"), launches_total=total,
         bit_identical_to_in_process=True)
    print(f"distributed_procs: median step ms {per('median_step_ms')}, host staging ms a step "
          f"{per('staging_ms_a_step')}, bytes a rank a step {per('shift_bytes_a_step')} "
          f"({smi})", flush=True)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    nccl = None
    if cards >= math.prod(DIST_MESH):
        t0 = time.perf_counter()
        nccl = procs.spawn(procs_nccl_rank, math.prod(DIST_MESH), backend="nccl",
                           timeout_s=PROCS_TIMEOUT_S, kernels=DIST_KERNELS)
        check_procs_soma(nccl, record, "distributed_procs (nccl)")
        emit("distributed_procs_nccl", processes=len(nccl), cards=cards, nvidia_smi=smi,
             launch_s=time.perf_counter() - t0,
             median_step_ms=[r["median_step_ms"] for r in nccl],
             wire_ms_a_step=[r["wire_ms_a_step"] for r in nccl],
             bit_identical_to_in_process=True)
    else:
        print(f"nccl: not run ({cards} card{'s' if cards != 1 else ''})", flush=True)
    return (results, nccl), small


def check_procs_jit(runs, record, crowd, elastic, label):
    """The processes' compiled runs (``procs_soma_jit``; ``runs``: each
    process's ``procs_soma`` result with its ``jit``) against the
    in-process card records: ``dist_soma``'s (``record``: digest, series,
    counters, launches), ``dist_crowd_model``'s rollback (``crowd``) and the
    elastic case's (``elastic``).  Every process replays; its only eager
    steps are cold starts, missing graphs (its own or a peer's) and
    rolled-back chunks; the second run of each variant replays every step.
    Returns the fields ``distributed_procs_jit`` prints."""
    ranks = [r["rank"] for r in runs]
    fields = {}
    for variant in ("pop_every_step", "observables_off"):
        for i in range(2):
            got = [r["jit"][variant][i] for r in runs]
            where = f"{label}: {variant} run {i}"
            if {g["digest"] for g in got} != {record["digest"]}:
                raise AssertionError(f"{where}: final states differ from the in-process run")
            head = got[ranks.index(0)]
            if variant == "pop_every_step" and not np.array_equal(head["pop"], record["pop"]):
                raise AssertionError(f"{where}: population series {head['pop'].tolist()}")
            bad = [k for k in record["counters"]
                   if not np.array_equal(head["counters"][k], record["counters"][k])]
            if bad:
                raise AssertionError(f"{where}: counters differ from the in-process run: {bad}")
            total = functools.reduce(add_counts, [g["launches"] for g in got])
            if ({k: v for k, v in total.items() if v}
                    != {k: v for k, v in record["launches"].items() if v}):
                raise AssertionError(f"{where}: launches {total} do not add up to the "
                                     f"in-process run_jit's {record['launches']}")
            for g in got:
                allowed = (g["runs"] - g["warm_starts"] + g["missing_steps"] + g["peer_steps"]
                           + g["rolled_back_steps"])
                if g["replays"] < 1 or g["eager_steps"] != allowed or g["rollbacks"]:
                    raise AssertionError(f"{where}: runner counts {g}")
                if i == 1 and (g["eager_steps"] or g["replays"] != STEPS):
                    raise AssertionError(f"{where}: the second run stepped eagerly: {g}")
            if len({g["exchanges"] for g in got}) != 1:
                raise AssertionError(f"{where}: the processes ran different exchanges")
        cold, warm = ([r["jit"][variant][i] for r in runs] for i in (0, 1))
        fields[variant] = dict(
            launches_a_run=functools.reduce(add_counts, [w["launches"] for w in warm]),
            replayed_step_ms=[w["step_ms"] for w in warm],
            cold_run_step_ms=[c["step_ms"] for c in cold],
            graphs=[c["graphs"] for c in cold], segments_a_graph=[c["segments_a_graph"]
                                                              for c in cold],
            replays=[c["replays"] for c in cold], eager_steps=[c["eager_steps"] for c in cold],
            missing_steps=[c["missing_steps"] for c in cold],
            peer_steps=[c["peer_steps"] for c in cold], capture_s=[c["capture_s"] for c in cold],
            exchanges_a_step=[w["exchanges_a_step"] for w in warm],
            staging_ms_a_step=[w["staging_ms_a_step"] for w in warm],
            staged_bytes_a_step=[w["staged_bytes_a_step"] for w in warm],
            wire_ms_a_step=[w["wire_ms_a_step"] for w in warm],
            gather_wire_ms_a_step=[w["gather_wire_ms_a_step"] for w in warm],
            peak_memory_bytes=[max(c["peak_memory_bytes"], w["peak_memory_bytes"])
                               for c, w in zip(cold, warm)])
    got = [r["jit"]["crowd"] for r in runs]
    if {g["digest"] for g in got} != {crowd["digest"]}:
        raise AssertionError(f"{label}: the crowd run differs from the in-process run_jit")
    if not np.array_equal(got[ranks.index(0)]["pop"], crowd["pop"]):
        raise AssertionError(f"{label}: the crowd run's population series differs")
    kept = functools.reduce(add_counts, [
        {k: v - g["rolled_back_launches"].get(k, 0) for k, v in g["launches"].items()}
        for g in got])
    if {k: v for k, v in kept.items() if v} != {k: v for k, v in crowd["eager"].items() if v}:
        raise AssertionError(f"{label}: the crowd run's launches less the rolled-back ones "
                             f"{kept} are not the eager run's {crowd['eager']}")
    flips = {r: g["overflowed"] for r, g in zip(ranks, got)}
    if (len({(g["rollbacks"], g["rolled_back_steps"]) for g in got}) != 1
            or got[0]["rollbacks"] < 1 or flips[0] != [False, True]
            or any(flips[r] != [False] for r in ranks if r)):
        raise AssertionError(f"{label}: the crowd run's rollbacks "
                             f"{[(g['rollbacks'], g['rolled_back_steps']) for g in got]}, "
                             f"branches {flips}")
    fields["crowd"] = dict(launches=functools.reduce(add_counts, [g["launches"] for g in got]),
                           rolled_back_launches=functools.reduce(add_counts, [
                               {k: g["rolled_back_launches"].get(k, 0) for k in g["launches"]}
                               for g in got]),
                           rollbacks=got[0]["rollbacks"],
                           rolled_back_steps=got[0]["rolled_back_steps"],
                           overflowed_branches=flips,
                           eager_steps=[g["eager_steps"] for g in got],
                           peer_steps=[g["peer_steps"] for g in got])
    got = [r["jit"]["elastic"] for r in runs]
    if ({g["digest"] for g in got} != {elastic["digest"]}
            or any(g["grows"] != elastic["grows"] for g in got)
            or not all(np.array_equal(g["pop"], elastic["pop"]) for g in got)):
        raise AssertionError(f"{label}: the elastic run differs from the in-process one")
    fields["elastic"] = dict(grows=elastic["grows"], pop=elastic["pop"].tolist())
    return fields


def phase_distributed_procs_jit(procs_results, small, record, crowd, elastic, device="cuda"):
    """The compiled run with one process a rank (gloo on the one card, the
    processes ``distributed_procs`` started): dist_small's corner case on
    eight processes, serial and overlapped, bit-identical to the in-process
    eager runs (``small``); on four, ``dist_soma``'s model with ``pop``
    every step and with observables off, ``dist_crowd_model``'s rollback and
    the elastic case, held by ``check_procs_jit``.  Under NCCL (four or more
    cards) the same checks hold the NCCL run's.  Returns the launches of
    the four processes' compiled runs, summed (the distributed kernel rows
    count them)."""
    (results, nccl) = procs_results
    smi = nvidia_smi_line()
    for name in ("serial", "overlap"):
        got = [r[f"small_jit_{name}"] for r in results]
        if {d for d, _ in got} != {small[name]}:
            raise AssertionError(f"distributed_procs_jit: dist_small's corner case ({name}) "
                                 f"under run_jit differs from its in-process run")
        if any(st["replays"] < 1 or (device == "cuda" and st["segments"] < 2)
               for _, st in got):
            raise AssertionError(f"distributed_procs_jit: dist_small ({name}) counts "
                                 f"{[st for _, st in got]}")
    runs = [dict(r["soma"], jit=r["jit"]) for r in results if "soma" in r]
    fields = check_procs_jit(runs, record, crowd, elastic, "distributed_procs_jit")
    eager = [r["median_step_ms"] for r in runs]
    # Every launch of the four processes' compiled runs (rolled back included).
    total = functools.reduce(add_counts, [
        r["jit"][v][i]["launches"] for r in runs for v in ("pop_every_step", "observables_off")
        for i in (0, 1)] + [r["jit"]["crowd"]["launches"] for r in runs])
    emit("distributed_procs_jit", backend="gloo", processes=len(runs), agents=N_AGENTS,
         mesh=list(DIST_MESH), steps=STEPS, nvidia_smi=smi,
         small_case=dict(mesh=[4, 2], processes=PROCS_SMALL_RANKS, steps=PROCS_SMALL_STEPS,
                         segments=[st["segments"] for _, st in
                                   (r["small_jit_serial"] for r in results)],
                         launches={name: functools.reduce(add_counts, [
                             r[f"small_jit_{name}"][1]["launches"] for r in results])
                             for name in ("serial", "overlap")},
                         serial_and_overlap_bit_identical_to_in_process=True),
         eager_median_step_ms=eager, launches_total=total, **fields,
         bit_identical_to_in_process=True)
    print(f"distributed_procs_jit: replayed step ms, pop every step "
          f"{fields['pop_every_step']['replayed_step_ms']}, observables off "
          f"{fields['observables_off']['replayed_step_ms']}; eager median {eager} ({smi})",
          flush=True)
    if nccl is not None:
        check_procs_jit(nccl, record, crowd, elastic, "distributed_procs_jit (nccl)")
        emit("distributed_procs_jit_nccl", processes=len(nccl), nvidia_smi=smi,
             replayed_step_ms=[r["jit"]["pop_every_step"][1]["step_ms"] for r in nccl],
             bit_identical_to_in_process=True)
    return total


DIST_CROWD = 100              # agents stacked in one 10 um box of 64 ...
DIST_CROWD_AT = 5             # ... from this step on, in rank 0's box only
DIST_CROWD_STEPS = 10


def phase_distributed_jit():
    """Path 1's soma model on the 2x2 mesh (``dist_soma``, without the
    step clock) through ``DistributedSimulation.run_jit``: bit-identical to
    its eager run, with its launches, no rollback, and a second run that
    replays from its first step.  Prints the device-to-host reads of an
    eager step and of a run_jit run, the overlap report (equal to the
    CPU's), the lanes' events and waits a step, where the graphs' lane
    allocations went, and the rank concurrency of a replayed step."""
    dsim = dist_soma()

    def extra():
        return dict(dtoh_reads_a_step_eager=dtoh_reads(lambda n: dsim.run(n)),
                    dtoh_reads_a_run_jit_run=dtoh_in(lambda: dsim.run_jit(STEPS)),
                    **lane_fields(dsim))

    with capture_pools() as pools:
        return jit_phase("distributed_jit", dsim, STEPS, warm=True,
                         extra=lambda: {**extra(), "graph_pool_bytes_by_stream": pools})


def phase_distributed_jit_variants():
    """The int8 codec (its two-scale path) and the overlapped schedule (two
    force passes a rank, each keying its own branches; each rank's halo
    exchange on its exchange lane beside its interior pass) through
    run_jit, a few steps each, bit-identical to their own eager runs, with
    their overlap reports and replays' concurrency."""
    int8 = dist_soma(codec="int8")
    launches = jit_phase("distributed_jit_int8", int8, DIST_OVERLAP_STEPS,
                         extra=lambda: lane_fields(int8))
    overlap = dist_soma(overlap=True)
    with capture_pools() as pools:
        launches = add_counts(launches, jit_phase(
            "distributed_jit_overlap", overlap, DIST_OVERLAP_STEPS,
            extra=lambda: {**lane_fields(overlap), "graph_pool_bytes_by_stream": pools}))
    return launches


# The CPU's copy of the model: agents, and capacity a rank (the report
# counts shifts, not agents).
DIST_REPORT_CPU_AGENTS, DIST_REPORT_CPU_CAPACITY = 4_000, 8_192


def lane_fields(dsim) -> dict:
    """The overlap report of ``dsim``'s model on the card, which must equal
    the CPU's (``distributed.overlap_report`` of the same model on a CPU
    mesh, cut to DIST_REPORT_CPU_AGENTS agents in DIST_REPORT_CPU_CAPACITY
    rows a rank); the lanes' events and waits a step (one eager step); and
    the concurrency of one replayed step (:func:`replay_concurrency`)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lanes

    dcfg = dsim.dcfg
    card = dist.overlap_report(dsim.mesh, dcfg, dsim.config, dsim.state, dsim.scheduler)
    cpu_sim = dist_soma(codec=dcfg.halo_codec, overlap=dcfg.overlap_halo, device="cpu",
                        n=DIST_REPORT_CPU_AGENTS, capacity=DIST_REPORT_CPU_CAPACITY)
    cpu = dist.overlap_report(cpu_sim.mesh, cpu_sim.dcfg, cpu_sim.config, cpu_sim.state,
                              cpu_sim.scheduler)
    if card != cpu:
        raise AssertionError(f"the overlap report on the card {card} is not the CPU's {cpu}")
    rule = (card["forces"]["halo_collective_ancestors"] >= 1 if not dcfg.overlap_halo else
            card["interior_forces"]["halo_collective_ancestors"] == 0
            and card["interior_forces"]["collective_ancestors"] >= 1
            and card["shell_forces"]["halo_collective_ancestors"] >= 1)
    if not rule:
        raise AssertionError(f"the overlap report breaks the reference's rule: {card}")
    ranks = dsim.step.unstack(dsim.state)
    lanes.counts.reset()
    dsim.step.step_ranks(ranks, 0)
    torch.cuda.synchronize()
    streams = [lane.stream.cuda_stream for lane in lanes.lanes_for(dsim.step.mesh).all()]
    if len(set(streams)) != len(streams):
        raise AssertionError("two lanes share a stream")
    return dict(overlap_report=card, overlap_report_equals_cpu=True,
                lane_events_a_step=lanes.counts.events, lane_waits_a_step=lanes.counts.waits,
                **replay_concurrency(dsim))


@contextlib.contextmanager
def capture_pools():
    """Within the context, every graph capture of a runner is followed by a
    reading of the memory snapshot: the bytes of the capture's pool by the
    stream that allocated them, each lane's stream by its name (a dict the
    caller prints once the context is left)."""
    from repro_torch.core import lanes
    from repro_torch.core.runner import Runner

    names = {}
    pools = {}
    real = Runner._capture

    def capture(self, lay, key, host, live):
        real(self, lay, key, host, live)
        if self.mesh is None or lay.pool is None:
            return
        for lane in lanes.lanes_for(self.mesh).all():
            names[lane.stream.cuda_stream] = f"rank{lane.rank}/{lane.role}"
        seen = collections.Counter()
        for seg in torch.cuda.memory._snapshot()["segments"]:
            if tuple(seg.get("segment_pool_id", ())) == tuple(lay.pool):
                seen[names.get(seg["stream"], f"stream {seg['stream']:#x}")] += seg["total_size"]
        pools.update(seen)

    Runner._capture = capture
    try:
        yield pools
    finally:
        Runner._capture = real
    lane_bytes = sum(n for k, n in pools.items() if k.startswith("rank"))
    if pools and not lane_bytes:
        raise AssertionError(f"no lane allocated in the graphs' pool: {dict(pools)}")


def replay_concurrency(dsim) -> dict:
    """From a ``torch.profiler`` trace of one replayed step of ``dsim``'s
    runner (its graph of step 1, the run's usual key): ``rank_concurrency``,
    the device activities' summed time over the union of their intervals
    (1 when nothing overlaps), and the streams the trace shows.  In the
    overlapped schedule also ``exchange_busy_ms`` (the exchange lanes'
    work), ``interior_exchange_overlap_ms`` (the time in which an interior
    force pass and exchange work run together) and ``exchange_hidden_ms``
    (exchange work beside any other work of the step).

    A replay runs the graph's branches on streams of CUDA's choosing, not
    the lanes' (a rank's work before the exchange forks continues on one of
    the two branches' streams), so the exchange work is found by its
    activities: each exchange lane's sequence in the trace of one eager
    step (a lane's stream there; one without a force pass), found as a run
    on a replay stream (a branch keeps its order).  The interior passes are
    the first of each stream's pairs of ``cell_list_force`` launches (a
    rank's interior, then its shell pass)."""
    runner = dsim._jitted
    lay = next(reversed(runner._layouts.values()))
    key = (runner._pattern(1), lay.branches)
    graph, _ = lay.graphs[key] if key in lay.graphs else next(iter(lay.graphs.values()))

    def replay():
        # The observables' row of a replay is its step less the run's start:
        # a replay outside a run writes row 0.
        lay.start.copy_(lay.static.step)
        graph.replay()

    replay()
    events = device_events(replay)
    busy = _union((a, b) for a, b, _, _ in events)
    total = sum(b - a for a, b, _, _ in events)
    out = {"replay_activities": len(events),
           "replay_streams": len({st for _, _, _, st in events}),
           "replay_busy_ms": _length(busy) / 1e3, "replay_activity_ms": total / 1e3,
           "rank_concurrency": total / max(_length(busy), 1e-9)}
    if dsim.dcfg.overlap_halo:
        ranks = dsim.step.unstack(dsim.state)
        eager = _by_stream(device_events(lambda: dsim.step.step_ranks(ranks, 1)))
        signatures = {tuple(n for _, _, n in evs) for evs in eager.values()
                      if not any("cell_list_force" in n for _, _, n in evs)}
        out.update(exchange_overlap(_by_stream(events), signatures, len(ranks)))
    return out


def _by_stream(events) -> dict:
    by_stream = collections.defaultdict(list)
    for a, b, name, stream in sorted(events):
        by_stream[stream].append((a, b, name))
    return by_stream


def exchange_overlap(by_stream: dict, signatures, ranks: int) -> dict:
    """The exchange's and the interior passes' activities in a trace
    (``{stream: [(start, end, name)]}``, see :func:`replay_concurrency`),
    and how long they ran beside each other and beside the rest."""
    exchange, interior, rest = [], [], []
    for evs in by_stream.values():
        names = [n for _, _, n in evs]
        mine = [False] * len(evs)
        for sig in signatures:
            i = 0
            while i + len(sig) <= len(names):
                if tuple(names[i:i + len(sig)]) == sig:
                    mine[i:i + len(sig)] = [True] * len(sig)
                    i += len(sig)
                else:
                    i += 1
        forces = [e for e in evs if "cell_list_force" in e[2]]
        interior.extend(e[:2] for e in forces[0::2])
        exchange.extend(e[:2] for e, m in zip(evs, mine) if m)
        rest.extend(e[:2] for e, m in zip(evs, mine) if not m)
    per_lane = sum(len(s) for s in signatures) / max(len(signatures), 1)
    found = len(exchange) == ranks * per_lane and len(interior) == ranks
    t0 = min(a for evs in by_stream.values() for a, _, _ in evs)
    span = lambda xs: [round((min(a for a, _ in xs) - t0) / 1e3, 4),
                       round((max(b for _, b in xs) - t0) / 1e3, 4)] if xs else None
    return {"exchange_activities": len(exchange), "exchange_signatures": len(signatures),
            "exchange_found": found,
            "exchange_busy_ms": _length(_union(exchange)) / 1e3 if found else None,
            "interior_exchange_overlap_ms": _overlap(interior, exchange) / 1e3 if found
            else None,
            "exchange_hidden_ms": _overlap(rest, exchange) / 1e3 if found else None,
            # When each ran, ms from the trace's first activity.
            "interior_pass_spans": [span([x]) for x in sorted(interior)],
            "exchange_span": span(exchange)}


def _overlap(a, b) -> float:
    """The time in which some span of ``a`` and some span of ``b`` run."""
    both = 0.0
    for x, y in _union(a):
        for u, v in _union(b):
            both += max(0.0, min(y, v) - max(x, u))
    return both


def device_events(fn) -> list:
    """``(start_us, end_us, name, stream)`` of every device activity of one
    profiled call of ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.time_range.start, e.time_range.end, e.name, e.device_resource_id)
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(spans) -> float:
    return sum(b - a for a, b in spans)


def dist_crowd_model(mesh=None, device="cuda"):
    """``dist_soma`` with the ``gid``s renumbered so that the agents deep in
    rank 0's box (100-400 um of its 500 on both decomposed axes;
    soma_model's positions, drawn again from its seed) come first, and an op
    that stacks the first DIST_CROWD of them at the box's centre from
    DIST_CROWD_AT on: rank 0's box overflows (the fused pass falls back to
    its dense candidates there) and no other rank's does."""
    from repro_torch.core.distributed import DomainConfig
    from repro_torch.launch.mesh import make_mesh

    pos = np.random.default_rng(0).uniform(10, SPACE - 10, (N_AGENTS, 3))
    inner = ((pos[:, :2] > 0.1 * SPACE) & (pos[:, :2] < 0.4 * SPACE)).all(1)
    gid = np.empty(N_AGENTS, np.int32)
    gid[np.argsort(~inner, kind="stable")] = np.arange(N_AGENTS, dtype=np.int32)

    def crowd(ctx, state):
        pool = state.pool
        hit = (pool.get("gid") < DIST_CROWD) & pool.alive & (state.step >= DIST_CROWD_AT)
        return dataclasses.replace(state, pool=pool.replace(
            position=torch.where(hit[:, None], SPACE / 4, pool.position)))

    sim = (soma_model(N_AGENTS, SPACE, RESOLUTION, 0, device, gid=gid)
           .op(crowd, name="crowd", phase="agent")
           .observe("pop", lambda s: s.pool.alive.sum(dtype=torch.int32)))
    dcfg = DomainConfig(mesh_axes=("x", "y"), axis_sizes=DIST_MESH, extent=SPACE / 2,
                        halo_width=DIST_HALO, halo_capacity=DIST_HALO_CAPACITY,
                        migrate_capacity=DIST_MIGRATE_CAPACITY, depth=SPACE)
    return sim.distribute(mesh or make_mesh(DIST_MESH, ("x", "y"), devices=device), dcfg,
                          capacity=DIST_CAPACITY)


def phase_dist_jit_divergence():
    """dist_crowd_model's run: rank 0's speculated ``overflowed`` branch
    rolls back; the run stays bit-identical to the eager run, the other
    ranks keep their branch, and the launches less the thrown-away replays'
    are the eager run's.  Returns the eager run's digest, series and
    launches (what ``distributed_procs_jit`` holds its processes to)."""
    dsim = dist_crowd_model()
    reset_counts()
    efinal, eobs = dsim.run(DIST_CROWD_STEPS)
    torch.cuda.synchronize()
    eager = read_counts()
    reset_counts()
    final, obs = dsim.run_jit(DIST_CROWD_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()
    runner = dsim._jitted
    bad = differing_leaves(efinal, final)
    if bad or not torch.equal(eobs["pop"], obs["pop"]):
        raise AssertionError(f"dist_jit_divergence: run_jit differs from the eager run in "
                             f"{bad or ['pop']}")
    kept = {k: v - runner.rolled_back_launches[k] for k, v in launches.items()}
    keys = [dict(key[1]) for key in runner._graphs]
    flips = {r: sorted({key[f"rank{r}/overflowed"] for key in keys}) for r in range(4)}
    if (runner.stats["rollbacks"] < 1 or kept != eager or flips[0] != [False, True]
            or any(flips[r] != [False] for r in (1, 2, 3))):
        raise AssertionError(f"dist_jit_divergence: {runner.stats}, launches {launches} less "
                             f"{dict(runner.rolled_back_launches)} vs eager {eager}, "
                             f"branches {flips}")
    emit("dist_jit_divergence", agents=N_AGENTS, crowd=DIST_CROWD, crowd_at=DIST_CROWD_AT,
         steps=DIST_CROWD_STEPS, eager_launches=eager, launches=launches,
         rolled_back_launches=dict(runner.rolled_back_launches),
         overflowed_branches=flips, **runner.stats)
    return dict(digest=state_digest(efinal), pop=eobs["pop"].cpu().numpy(), eager=eager)


def dist_kernel_rows(dsim, final, launches):
    """cell_list_force over ghost-extended sources (``S = C + 4H`` rows,
    ``num_out = C``) and cell_rank on the halo-extended grid, at rank 0 of
    the distributed run's final state (its pool and its latest ghost frame)."""
    from repro_torch.core.grid import _live_cell_ids, build_index_arrays
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.cell_force.ref import cell_list_force_ref
    from repro_torch.kernels.cell_rank import ops as cr_ops

    spec = dsim.config.spec
    rank0 = dsim.step.unstack(final)[0]
    pool, gf = rank0.pool, rank0.ghost
    c = pool.capacity
    g_pos = torch.cat([pool.position, gf.position]).contiguous()
    g_rad = torch.cat([pool.radius(), gf.radius]).contiguous()
    g_alive = torch.cat([pool.alive, gf.alive])
    s, n_cells, m = g_pos.shape[0], spec.n_cells, spec.max_per_cell
    rows = []

    cid = _live_cell_ids(spec, g_pos, g_alive)
    check_cell_rank(cid, n_cells)
    rows.append(dict(
        name="cell_rank[halo grid]", route="cuda",
        source="src/repro_torch/kernels/cell_rank/csrc/cell_rank.cu",
        replaces="src/repro/kernels/cell_rank/kernel.py:88",
        launches=launches["cell_rank"], max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: cr_ops.cell_rank_tiled(cid, n_cells), 5), library_ms=None,
        sources=s, ghost_rows=s - c, **cell_rank_times(cid, n_cells),
    ))

    index = build_index_arrays(spec, g_pos, g_alive)
    if bool(index.overflowed):
        raise AssertionError("kernels: the halo-extended grid overflowed a box")
    # Each row is filled in slots 0..min(count, M)-1 and holds the sentinel
    # after them: the kernel walks a row only up to its first sentinel.
    cnt = index.cell_count.long()
    filled = index.cell_list < s
    want = torch.arange(m, device=cnt.device)[None, :] < torch.clamp(cnt, max=m)[:, None]
    if not torch.equal(filled, want):
        raise AssertionError("kernels: a halo-extended cell-list row has a gap before its "
                             "last agent")
    args = (g_pos, g_rad, index.cell_list, spec.dims)
    got = cf_k.cell_list_force_cuda(*args, num_out=c)
    k_max = max(int(cnt.max()), 1)
    chunk = max(1, int(1e8 // (27 * k_max * k_max)))
    plain_f = lambda: sum(cell_list_force_ref(*args, num_out=c,
                                              cells=(lo, min(lo + chunk, n_cells)))
                          for lo in range(0, n_cells, chunk))
    want_f, plain_ms = warm_timed(plain_f)
    scale = float(want_f.abs().max())
    err = float((got - want_f).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"cell_list_force[ghost]: max error {err} vs max|F| {scale}")
    ints = torch.clamp(cnt + 1, max=m)
    listed = torch.clamp(cnt, max=m)
    force_bytes = int(((ints * 4 + 31) // 32 * 32).sum()) + int(listed.sum()) * 16 + c * 12
    pairs = box_pairs(cnt, spec.dims)
    rows.append(dict(
        name="cell_list_force[ghost]", route="cuda",
        source="src/repro_torch/kernels/cell_force/csrc/cell_list_force.cu",
        replaces="src/repro/kernels/cell_force/kernel.py:186",
        launches=launches["cell_list_force"], max_abs_err=err,
        ms=cuda_ms(lambda: cf_k.cell_list_force_cuda(*args, num_out=c), 20),
        plain_ms=plain_ms, library_ms=None, **bound(force_bytes, 12 * pairs),
        sources=s, num_out=c, ghost_rows_live=int(gf.alive.sum()), n_cells=n_cells,
        pair_evaluations=pairs, max_force=scale, fullest_box=k_max,
    ))
    for r in rows:
        emit("kernel", **r)
    return rows


def rank_oracle(cid: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Within-cell ranks from a stable sort (used here only)."""
    order = torch.sort(cid.long(), stable=True).indices
    counts = torch.bincount(cid.long(), minlength=n_cells + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(cid)
    sorted_cid = cid.long()[order]
    rank[order] = (torch.arange(cid.shape[0], device=cid.device)
                   - starts[sorted_cid]).to(torch.int32)
    return rank


def check_cell_rank(cid: torch.Tensor, n_cells: int):
    from repro_torch.kernels.cell_rank import kernel as cr_k
    from repro_torch.kernels.cell_rank import ops as cr_ops

    got = cr_k.cell_rank_cuda(cid, n_cells)
    plain = cr_ops.cell_rank_tiled(cid, n_cells)
    oracle = rank_oracle(cid, n_cells)
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got, oracle)):
        raise AssertionError(
            f"cell_rank: {int((got != plain).sum())} ranks differ from the plain "
            f"version, {int((got != oracle).sum())} from the sort oracle")
    return 0.0


def cell_rank_design_bytes(cid: torch.Tensor, n_cells: int) -> int:
    """Bytes the kernel's passes move for these ids, each array once a pass:
    the memset (counts, counters, chunk flags); the count pass (ids, the
    counts read and written, the live agents' slots and table entries);
    bucket placement (counts) and the fill (ids, slots); the rank pass (ids,
    a count a live agent, a 16-byte table row for each agent that shares
    its cell, the ranks).  Cells of more than ``ROW`` agents add their bucket
    (offsets, entries written and read)."""
    from repro_torch.kernels.cell_rank import kernel as cr_k

    n = cid.numel()
    live_ids = cid[(cid >= 0) & (cid < n_cells)].long()
    live = live_ids.numel()
    per_agent = torch.bincount(live_ids, minlength=n_cells)[live_ids]
    shared = int((per_agent > 1).sum())
    bucketed = int((per_agent > cr_k.ROW).sum())
    zeroed = 4 * (n_cells + cr_k._COUNTERS + cr_k.max_chunks(n))
    return (zeroed + (4 * n + 8 * n_cells + 8 * live)
            + (4 * n_cells + 4 * n + 4 * live)
            + (8 * n + 4 * live + 16 * shared) + 16 * bucketed)


def cell_rank_times(cid: torch.Tensor, n_cells: int) -> dict:
    """cell_rank at one input: event time (the host's dispatch included),
    device time (calls replayed from a CUDA graph), the function's bound
    (ids read once, ranks written once; a compare per pair of a cell) and
    this design's."""
    from repro_torch.kernels.cell_rank import kernel as cr_k

    call = lambda: cr_k.cell_rank_cuda(cid, n_cells)
    counts = torch.bincount(cid.long(), minlength=n_cells + 1)[:n_cells]
    ops = int((counts * counts).sum()) + 4 * cid.numel()
    design_bytes = cell_rank_design_bytes(cid, n_cells)
    return dict(ms=cuda_ms(call, 50), device_ms=graph_ms(call, 50),
                **bound(2 * cid.numel() * 4, ops),
                design_bytes=design_bytes, design_bound_ms=bound(design_bytes, ops)["bound_ms"],
                agents=cid.numel(), n_cells=n_cells, fullest_cell=int(counts.max()))


def halo_multiplicity(dims, tile) -> torch.Tensor:
    """Per box of the grid: how many of cell_list_force's tiles hold it in
    their tile or one-box halo (the times the kernel reads its row)."""
    axes = []
    for n, t in zip(dims, tile):
        mult = torch.zeros(n, dtype=torch.long)
        for j in range(-(-n // t)):
            mult[max(j * t - 1, 0):min(j * t + t + 1, n)] += 1
        axes.append(mult)
    mx, my, mz = axes
    return (mx[:, None, None] * my[None, :, None] * mz[None, None, :]).reshape(-1)


def cell_rank_row(spec, pool, launches, name="cell_rank") -> dict:
    """cell_rank on the env_build input of ``pool`` (and on one crowded box
    and an all-dead pool at its grid) against its plain version and a sort
    oracle, exact; its times and bounds."""
    from repro_torch.core.grid import _live_cell_ids
    from repro_torch.kernels.cell_rank import kernel as cr_k
    from repro_torch.kernels.cell_rank import ops as cr_ops

    n_cells = spec.n_cells
    cid = _live_cell_ids(spec, pool.position, pool.alive)
    check_cell_rank(cid, n_cells)
    crowded = torch.full((65_536,), 4242, dtype=torch.int32, device=cid.device)
    check_cell_rank(crowded, n_cells)           # every agent in one box
    check_cell_rank(torch.full_like(cid, n_cells), n_cells)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/cell_rank/csrc/cell_rank.cu",
        replaces="src/repro/kernels/cell_rank/kernel.py:88",
        launches=launches["cell_rank"], max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: cr_ops.cell_rank_tiled(cid, n_cells), 5),
        library_ms=None,
        **cell_rank_times(cid, n_cells),
        crowded_box_ms=cuda_ms(lambda: cr_k.cell_rank_cuda(crowded, n_cells), 3),
        crowded_box_device_ms=graph_ms(lambda: cr_k.cell_rank_cuda(crowded, n_cells), 3),
    )


def cell_list_force_row(spec, pool, launches, crowded_in_path, name="cell_list_force",
                        force_inputs=None) -> dict:
    """cell_list_force over every box of ``pool``'s cell list against its
    plain version (atol 1e-5 x max|F|); its times and bounds.
    ``force_inputs``, a dict, also receives its inputs."""
    from repro_torch.core.grid import build_index
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.cell_force.ref import cell_list_force_ref

    n_cells = spec.n_cells
    index = build_index(spec, pool)
    if bool(index.overflowed):
        raise AssertionError(f"{name}: the final state overflowed a box")
    radius = pool.radius()
    args = (pool.position, radius, index.cell_list, spec.dims)
    list_force = lambda: cf_k.cell_list_force_cuda(*args, num_out=pool.capacity)
    cf_k.crowded_tiles(pool.device, reset=True)
    got = list_force()
    crowded_call = cf_k.crowded_tiles(pool.device, reset=True)
    if force_inputs is not None:
        force_inputs["cell_list_force"] = dict(args=args, num_out=pool.capacity)
    m = spec.max_per_cell
    cnt = index.cell_count.long()
    # The plain version builds (boxes, k, 27k) pair tensors, k the fullest
    # box: evaluate it over chunks of query boxes of about 1e8 pairs each.
    k_max = max(int(cnt.max()), 1)
    chunk = max(1, int(1e8 // (27 * k_max * k_max)))
    plain_f = lambda: sum(cell_list_force_ref(*args, num_out=pool.capacity,
                                              cells=(lo, min(lo + chunk, n_cells)))
                          for lo in range(0, n_cells, chunk))
    want, plain_ms = warm_timed(plain_f)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"{name}: max error {err} vs max|F| {scale}")
    # Bytes this run's data needs: each row's occupied slots and its first
    # sentinel in 32-byte sectors, position + radius of each listed agent,
    # and the (C, 3) output.  Operations: ~12 f32 ops per pair evaluation.
    ints = torch.clamp(cnt + 1, max=m)
    row_bytes = (ints * 4 + 31) // 32 * 32
    listed = torch.clamp(cnt, max=m)
    force_bytes = int(row_bytes.sum()) + int(listed.sum()) * 16 + pool.capacity * 12
    # This design: each row and listed agent read once per tile that holds
    # it in its halo, the output zero-filled and then stored.
    mult = halo_multiplicity(spec.dims, cf_k.TILE).to(cnt.device)
    design_bytes = int((mult * (row_bytes + 16 * listed)).sum()) + 2 * pool.capacity * 12
    pairs = box_pairs(cnt, spec.dims)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/cell_force/csrc/cell_list_force.cu",
        replaces="src/repro/kernels/cell_force/kernel.py:186",
        launches=launches["cell_list_force"], max_abs_err=err,
        ms=cuda_ms(list_force, 20),
        plain_ms=plain_ms,
        library_ms=None,
        **bound(force_bytes, 12 * pairs),
        design_bound_ms=bound(design_bytes, 12 * pairs)["bound_ms"], design_bytes=design_bytes,
        tile=list(cf_k.TILE), stage_budget=cf_k.STAGE_BUDGET,
        crowded_tiles=crowded_in_path, crowded_tiles_a_call=crowded_call,
        pair_evaluations=pairs, max_force=scale, fullest_box=k_max,
    )


def phase_kernels(built, final, launches, crowded_in_path, force_inputs=None):
    """Path 1's kernels at the final state; ``force_inputs``, a dict, also
    receives cell_list_force's inputs."""
    from repro_torch.kernels.diffusion3d import kernel as d3_k
    from repro_torch.kernels.diffusion3d.ref import diffusion_step_ref

    spec, pool = built.config.spec, final.pool
    rows = [cell_rank_row(spec, pool, launches),
            cell_list_force_row(spec, pool, launches, crowded_in_path,
                                force_inputs=force_inputs)]

    # ---- diffusion3d: a substance field of the final state.
    u = final.grids["substance_0"].concentration.contiguous()
    g = final.grids["substance_0"]
    nu = g.diffusion_coefficient * built.config.dt / g.spacing**2
    decay = g.decay_constant * built.config.dt
    got = d3_k.diffusion_step_cuda(u, nu, decay)
    want = diffusion_step_ref(u, nu, decay)
    if not torch.equal(got, want):
        raise AssertionError(f"diffusion3d: {int((got != want).sum())} values differ from "
                             f"the plain version (max {float((got - want).abs().max())})")
    err = float((got - want).abs().max())
    # One PyTorch call for the same function: a 3x3x3 convolution (full f32).
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device=u.device)
    w[0, 0, 1, 1, 1] = (1.0 - decay) - 6.0 * nu
    for a, b, c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[0, 0, a, b, c] = nu
    conv = lambda: torch.nn.functional.conv3d(u[None, None], w, padding=1)
    conv_err = float((conv()[0, 0] - want).abs().max())
    rows.append(dict(
        name="diffusion3d", route="cuda",
        source="src/repro_torch/kernels/diffusion3d/csrc/diffusion3d.cu",
        replaces="src/repro/kernels/diffusion3d/kernel.py:61",
        launches=launches["diffusion3d"], max_abs_err=err,
        ms=cuda_ms(lambda: d3_k.diffusion_step_cuda(u, nu, decay), 50),
        device_ms=graph_ms(lambda: d3_k.diffusion_step_cuda(u, nu, decay), 20),
        plain_ms=cuda_ms(lambda: diffusion_step_ref(u, nu, decay), 20),
        library_ms=cuda_ms(conv, 20),
        **bound(2 * u.numel() * 4, 8 * u.numel()),
        # This design: each block's planes with their one-voxel halo (x, y
        # and z, whole 16-byte chunks in z) read once, the output once.
        design_bytes=diffusion_design_bytes(u.shape),
        design_bound_ms=bound(diffusion_design_bytes(u.shape), 8 * u.numel())["bound_ms"],
        library_max_abs_err=conv_err,
    ))
    for r in rows:
        emit("kernel", **r)
    return rows


def diffusion_design_bytes(shape) -> int:
    """Bytes the diffusion kernel reads and writes at ``shape``: each block
    stages its x run plus two halo planes, each plane its tile's rows plus
    two halo rows of whole 16-byte chunks from z0 - 4 to z0 + kTz + 4
    (clipped to the grid), as the launcher cuts the grid for this card."""
    nx, ny, nz = shape
    src = (ROOT / "src/repro_torch/kernels/diffusion3d/csrc/diffusion3d.cu").read_text()
    ty, tz, per_sm = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                      for k in ("kTy", "kTz", "kBlocksPerSm"))
    tiles_y, tiles_z = -(-ny // ty), -(-nz // tz)
    want = torch.cuda.get_device_properties(0).multi_processor_count * per_sm
    runs = min(nx, max(1, -(-want // (tiles_y * tiles_z))))
    run = -(-nx // runs)
    planes = sum(min(x0 + run, nx) - x0 + min(x0, 1) + (x0 + run < nx)
                 for x0 in range(0, nx, run))
    rows = sum(min(y0 + ty + 1, ny) - max(y0 - 1, 0) for y0 in range(0, ny, ty))
    cols = sum(min(z0 + tz + 4, nz) - max(z0 - 4, 0) for z0 in range(0, nz, tz))
    return 4 * planes * rows * cols + 4 * nx * ny * nz


def box_pairs(counts: torch.Tensor, dims) -> int:
    """Ordered pairs (i, j), i != j, of agents in 27-adjacent boxes: the pair
    evaluations the 27-box force sum needs for these cell counts."""
    nx, ny, nz = dims
    cnt = counts.long()
    padded = torch.nn.functional.pad(cnt.reshape(nx, ny, nz), (1, 1, 1, 1, 1, 1))
    box27 = sum(padded[a:a + nx, b:b + ny, c:c + nz]
                for a in range(3) for b in range(3) for c in range(3))
    return int((cnt * (box27.reshape(-1) - 1)).sum())


def window_sweep_pair_tests(c, block, window) -> int:
    """Pair tests of the reference's window sweep: in-range window blocks x
    block^2."""
    nbw = -(-c // block)
    tiles = torch.arange(nbw)
    w = tiles[:, None] + torch.arange(-window, window + 1)[None]
    return int(((w >= 0) & (w < nbw)).sum()) * block * block


def spheroid_kernel_rows(built, final, window, launches, dense_launches, force_inputs=None):
    """cell_window_force and pairwise_force at the spheroid's final state,
    sorted as the next step would sort it; ``force_inputs``, a dict, also
    receives the three force kernels' inputs."""
    from repro_torch.core.forces import _morton_window_ok
    from repro_torch.core.grid import (_live_cell_ids, build_index,
                                       candidate_neighbors_arrays, layout_rank_table,
                                       sort_agents)
    from repro_torch.kernels.cell_force import kernel as cf_k
    from repro_torch.kernels.cell_force.ref import cell_window_force_ref, window_walk
    from repro_torch.kernels.pairwise_force import kernel as pf_k
    from repro_torch.kernels.pairwise_force.ref import pairwise_force_ref

    spec = built.config.spec
    # ---- cell_rank at the spheroid's shape: the Morton keys the next step's
    # sort ranks.
    zid = layout_rank_table(spec, final.pool.device)[
        _live_cell_ids(spec, final.pool.position, final.pool.alive).long()]
    check_cell_rank(zid, spec.n_cells)
    emit("kernel_at_spheroid_shape", name="cell_rank", **cell_rank_times(zid, spec.n_cells))
    pool = sort_agents(spec, final.pool)
    index = build_index(spec, pool, assume_sorted=True)
    if not bool(_morton_window_ok(spec, index, SPH_BLOCK, window) & ~index.overflowed):
        raise AssertionError("kernels: the window does not cover the final state")
    pos, rad, cid = pool.position, pool.radius(), index.cell_of_agent
    c = pool.capacity
    nbw = -(-c // SPH_BLOCK)
    linear = cf_k.cell_list_force_cuda(pos, rad, index.cell_list, spec.dims, num_out=c)
    pairs = box_pairs(index.cell_count, spec.dims)
    rows = []

    # ---- cell_window_force at W: plain version over chunks of 64 query tiles.
    win = lambda: cf_k.cell_window_force_cuda(pos, rad, cid, spec.dims, block=SPH_BLOCK,
                                              half_window=window)
    plain = lambda: sum(cell_window_force_ref(pos, rad, cid, spec.dims, block=SPH_BLOCK,
                                              half_window=window, tiles=(t, min(t + 64, nbw)))
                        for t in range(0, nbw, 64))
    got = win()
    want, plain_ms = warm_timed(plain)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    witness = float((got - linear).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale or not witness <= 1e-5 * scale:
        raise AssertionError(f"cell_window_force: max error {err} (vs cell_list_force "
                             f"{witness}) vs max|F| {scale}")
    if force_inputs is not None:
        force_inputs["cell_window_force"] = dict(
            args=(pos, rad, cid, spec.dims), block=SPH_BLOCK, half_window=window)
        force_inputs["cell_list_force_spheroid"] = dict(
            args=(pos, rad, index.cell_list, spec.dims), num_out=c)
    # The rows the kernel's walk visits (each neighbour cell's rows clipped
    # to the window, merged).
    start, end = window_walk(cid, spec.dims, SPH_BLOCK, window)
    visited = (end - start).sum(1)
    # This design: the (first, last) table filled, set by the live cells'
    # atomics and read back, the cell ids read twice.
    design_bytes = 16 * spec.n_cells + 8 * int((index.cell_count > 0).sum()) + 36 * c
    rows.append(dict(
        name="cell_window_force", route="cuda",
        source="src/repro_torch/kernels/cell_force/csrc/cell_window_force.cu",
        replaces="src/repro/kernels/cell_force/kernel.py:330",
        launches=launches["cell_window_force"], max_abs_err=err,
        ms=cuda_ms(win, 20), plain_ms=plain_ms, library_ms=None,
        # Bytes: position, radius and cell id read once, the output written
        # once.  Operations: ~12 f32 ops per true 27-box pair.
        **bound(32 * c, 12 * pairs),
        design_bound_ms=bound(design_bytes, 12 * pairs)["bound_ms"], design_bytes=design_bytes,
        half_window=window, block=SPH_BLOCK, pair_evaluations=pairs,
        reference_sweep_pair_tests=window_sweep_pair_tests(c, SPH_BLOCK, window),
        candidate_rows_visited=int(visited.sum()),
        most_rows_visited_by_a_query=int(visited.max()),
        max_force=scale, max_err_vs_cell_list_force=witness,
    ))

    # ---- pairwise_force on the same state's dense candidates.
    cand, mask = candidate_neighbors_arrays(spec, index, pos, pool.alive)
    kdim = cand.shape[1]
    dense = lambda: pf_k.pairwise_force_cuda(pos, rad, cand, mask)
    chunk = 8192
    plain = lambda: torch.cat([
        pairwise_force_ref(pos[i:i + chunk], rad[i:i + chunk], cand[i:i + chunk],
                           mask[i:i + chunk], all_position=pos, all_radius=rad)
        for i in range(0, c, chunk)])
    got, want = dense(), plain()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    witness = float((got - linear).abs().max())
    if not scale > 0 or not err <= 1e-5 * scale or not witness <= 1e-5 * scale:
        raise AssertionError(f"pairwise_force: max error {err} (vs cell_list_force "
                             f"{witness}) vs max|F| {scale}")
    if force_inputs is not None:
        # Every 8th query row (the full candidates are 1.7 GB), all sources.
        force_inputs["pairwise_force"] = dict(
            args=(pos[::8].contiguous(), rad[::8].contiguous(), cand[::8].contiguous(),
                  mask[::8].contiguous()), all_position=pos, all_radius=rad)
    slots = int(mask.sum())
    design_bytes = pf_k.design_bytes(mask)
    rows.append(dict(
        name="pairwise_force", route="cuda",
        source="src/repro_torch/kernels/pairwise_force/csrc/pairwise_force.cu",
        replaces="src/repro/kernels/pairwise_force/kernel.py:107",
        launches=dense_launches["pairwise_force"], max_abs_err=err,
        ms=cuda_ms(dense, 20), device_ms=graph_ms(dense, 20), plain_ms=cuda_ms(plain, 1),
        library_ms=None,
        # Bytes these inputs need: every mask byte, the ids of the masked-in
        # slots, position + radius once (sources are the queries), the output.
        **bound(c * kdim + 4 * slots + c * 16 + c * 12, 12 * slots),
        # This design: the mask, each 32-byte id sector holding a set slot.
        design_bytes=design_bytes, design_bound_ms=bound(design_bytes, 12 * slots)["bound_ms"],
        candidate_slots=c * kdim, masked_in_slots=slots, pair_evaluations=pairs,
        max_force=scale, max_err_vs_cell_list_force=witness,
    ))
    del cand, mask
    for r in rows:
        emit("kernel", **r)
    return rows


def bound(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=n_ops)


# ------------------------------------------------------------------------ LM

def lm_model(reduced: bool):
    """phi4-mini with the flash kernel for prefill attention."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import build_model

    cfg = reduced_config(LM_ARCH) if reduced else get_config(LM_ARCH)
    return build_model(dataclasses.replace(cfg, attention_impl="cuda"))


def lm_tokens(batch, length, vocab, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, length)).astype(np.int32))


def phase_lm_small():
    """Reduced phi4-mini (f32) on the card against the CPU: one set of
    weights from a CPU generator, the prefill step (flash kernel) on 40-token
    prompts and 8 decode steps over the prompts' first 8 tokens."""
    from repro_torch.models.params import tree_map
    from repro_torch.training import make_decode_step, make_prefill_step

    model = lm_model(reduced=True)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = lm_tokens(2, 40, model.cfg.vocab_size, 0)
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        if dev == "cuda":
            reset_counts()
        pre = make_prefill_step(model)(p, {"tokens": toks.to(dev)})
        cache = model.init_cache(2, 48, dev)
        step = make_decode_step(model)
        dec = []
        for i in range(8):
            lg, cache = step(p, cache, toks[:, i:i + 1].to(dev), i)
            dec.append(lg)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
        out[dev] = (pre.cpu(), torch.cat(dec, 1).cpu())
    n = model.cfg.n_layers
    want = {"flash_attention_simt": n, "flash_attention": 0, "rmsnorm": (2 * n + 1) * 9}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"lm_small: launches {launches}, want {want}")
    errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
    if not max(errs) <= 1e-4:
        raise AssertionError(f"lm_small: logits differ from the CPU run by {errs}")
    emit("lm_small", layers=n, d_model=model.cfg.d_model, head_dim=model.cfg.head_dim,
         prefill_max_logit_err=errs[0], decode_max_logit_err=errs[1],
         max_logit=float(out["cpu"][0].abs().max()), launches=launches)


def capture_first_calls():
    """Wrap the model's flash-attention and RMSNorm dispatchers so that the
    inputs of their first calls are kept; returns ``(store, undo)``."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as layers_mod

    store = {}

    def spy(name, fn):
        def call(*args, **kw):
            store.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    old = attn_mod.fa_ops, layers_mod.rms_ops
    attn_mod.fa_ops = types.SimpleNamespace(
        flash_attention=spy("flash_attention", old[0].flash_attention))
    layers_mod.rms_ops = types.SimpleNamespace(rmsnorm=spy("rmsnorm", old[1].rmsnorm))

    def undo():
        attn_mod.fa_ops, layers_mod.rms_ops = old

    return store, undo


def phase_lm_prefill():
    """Full-width phi4-mini prefill: 4 x 2,048 prompt tokens through
    ``make_prefill_step`` with the flash kernel; one warm-up and 3 timed calls,
    counters zeroed just before the warm-up and read after the last call."""
    from repro_torch.models.params import tree_size
    from repro_torch.training import make_prefill_step

    t0 = time.perf_counter()
    model = lm_model(reduced=False)
    cfg = model.cfg
    # Weights drawn on the card and held in bf16, the compute dtype: the
    # reference casts its f32 weights to bf16 at every use, one cast up front
    # gives the same values.
    params = model.init(0, device="cuda", dtype=model.compute_dtype)
    n_params = tree_size(params)
    toks = lm_tokens(LM_BATCH, LM_PREFILL_LEN, cfg.vocab_size, 1).cuda()
    step = make_prefill_step(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    store, undo = capture_first_calls()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    finally:
        undo()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    want = {k: 0 for k in launches}
    # Every flash launch through the tensor-core kernel, none through SIMT.
    want.update(flash_attention=4 * n, rmsnorm=4 * (2 * n + 1))
    if launches != want:
        raise AssertionError(f"lm_prefill: launches {launches}, want {want}")
    if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_prefill: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    med = statistics.median(times[1:])
    emit("lm_prefill", arch=cfg.name, layers=n, d_model=cfg.d_model, vocab=cfg.vocab_size,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         params=n_params, batch=LM_BATCH, prompt_len=LM_PREFILL_LEN, setup_s=setup_s,
         warmup_ms=1e3 * times[0], call_ms=[1e3 * t for t in times[1:]],
         median_ms=1e3 * med, prompt_tokens_per_s=LM_BATCH * LM_PREFILL_LEN / med,
         peak_memory_bytes=peak, launches=launches,
         launches_per_call={"flash_attention": launches["flash_attention"] // 4,
                            "rmsnorm": launches["rmsnorm"] // 4})
    return store, launches


def phase_lm_serve():
    """The port's serve.py main loop at full width, then the decode path's
    last prompt logits against the prefill step on the same prompts."""
    from repro_torch.launch import serve
    from repro_torch.training import make_prefill_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.main(["--arch", LM_ARCH, "--no-reduced", "--batch", str(LM_BATCH),
                      "--prompt-len", str(LM_SERVE_PROMPT), "--gen", str(LM_SERVE_GEN),
                      "--seed", "0"])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg = out["config"]
    steps = LM_SERVE_PROMPT + LM_SERVE_GEN
    want = {k: 0 for k in launches}
    want["rmsnorm"] = steps * (2 * cfg.n_layers + 1)
    if launches != want:
        raise AssertionError(f"lm_serve: launches {launches}, want {want}")
    if out["generated"].shape != (LM_BATCH, LM_SERVE_GEN):
        raise AssertionError(f"lm_serve: generated {out['generated'].shape}")

    # Cross-check: the same prompts through the prefill step (flash kernel).
    model = lm_model(reduced=False)
    pre = make_prefill_step(model)(out["params"], {"tokens": out["prompt"]})[:, 0]
    dec = out["prompt_logits"][:, 0]
    diff = (dec - pre).abs()
    rel_l2 = float(torch.linalg.norm(dec - pre) / torch.linalg.norm(pre))
    top2 = pre.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = (dec.argmax(-1) == pre.argmax(-1)).cpu()
    decisive = (margin > 2 * diff.max(dim=-1).values).cpu()
    if not rel_l2 <= 0.05 or bool((decisive & ~agree).any()):
        raise AssertionError(f"lm_serve: decode vs prefill relative L2 {rel_l2}, top-1 "
                             f"{agree.tolist()}, decisive rows {decisive.tolist()}")
    emit("lm_serve", arch=cfg.name, batch=LM_BATCH, prompt_len=LM_SERVE_PROMPT,
         gen=LM_SERVE_GEN, run_s=total_s, prefill_by_decode_s=out["prefill_s"],
         prefill_by_decode_ms_per_step=1e3 * out["prefill_s"] / LM_SERVE_PROMPT,
         decode_s=out["decode_s"], decode_ms_per_step=1e3 * out["decode_s"] / LM_SERVE_GEN,
         decode_tokens_per_s=out["tokens_per_s"], peak_memory_bytes=peak,
         launches=launches, rmsnorm_per_step=launches["rmsnorm"] / steps,
         decode_vs_prefill_rel_l2=rel_l2, decode_vs_prefill_max_abs=float(diff.max()),
         top1_agree=agree.tolist(), top1_margin=margin.tolist(),
         top1_decisive=decisive.tolist(),
         sample=out["generated"][0][:8].tolist())


def bf16_ulp_check(name, got, want):
    """One bf16 ulp of the plain version's value (the f32 results, summed in
    other orders, round once); returns the largest absolute difference."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if bool((err > 2.0 ** -7 * w.abs() + 1e-6).any()):
        raise AssertionError(f"{name}: {int((err > 2.0 ** -7 * w.abs() + 1e-6).sum())} "
                             f"values beyond one bf16 ulp; max error {float(err.max())}")
    return float(err.max())


def beyond_ulp(got, exact) -> int:
    """Outputs more than one bf16 ulp (``2**-7 |x| + 1e-6``) from ``exact``."""
    err = (got.double() - exact).abs()
    return int((err > 2.0 ** -7 * exact.abs() + 1e-6).sum())


def sharp_softmax_agreement(d, t, group, device):
    """Causal GQA attention over one KV head at length ``t``, q at unit scale
    and scaled by 4 and 8 (a sharper softmax): how many bf16 outputs of the
    tensor-core kernel, the SIMT kernel and the plain version lie beyond one
    bf16 ulp of a float64 oracle."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops

    g = torch.Generator(device=device).manual_seed(1)
    q1, k, v = (torch.randn(s, generator=g, device=device)
                for s in ((1, group, t, d), (1, 1, t, d), (1, 1, t, d)))
    k, v = k.bfloat16(), v.bfloat16()
    causal = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    out = {}
    for qs in (1, 4, 8):
        q = (q1 * qs).bfloat16()
        s = torch.einsum("bhqd,bkd->bhqk", q.double(), k[:, 0].double()) * d ** -0.5
        exact = torch.einsum("bhqk,bkd->bhqd",
                             torch.softmax(s.masked_fill(~causal, -torch.inf), -1),
                             v[:, 0].double())
        out[str(qs)] = {
            "tensor_cores": beyond_ulp(fa_k.flash_attention_wgmma_cuda(q, k, v), exact),
            "simt": beyond_ulp(fa_k.flash_attention_simt_cuda(q, k, v), exact),
            "plain": beyond_ulp(fa_ops.chunked_attention(q, k, v, block_k=128), exact),
        }
    if out["1"]["tensor_cores"]:
        raise AssertionError(f"flash_attention: beyond one bf16 ulp of the exact result: {out}")
    return out


def lm_kernel_rows(store, launches):
    """flash_attention and rmsnorm on the inputs of their first calls in
    lm_prefill (layer 0), against the plain versions."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import visible
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    rows = []
    (q, k, v), kw = store["flash_attention"]
    causal, window, prefix = kw["causal"], kw["window"], kw["prefix_len"]
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    flash = lambda: fa_k.flash_attention_wgmma_cuda(q, k, v, causal=causal, window=window,
                                                    prefix_len=prefix)
    simt = lambda: fa_k.flash_attention_simt_cuda(q, k, v, causal=causal, window=window,
                                                  prefix_len=prefix)
    plain = lambda: fa_ops.chunked_attention(q, k, v, causal=causal, window=window,
                                             prefix_len=prefix, block_k=128)
    got, want = flash(), plain()
    err = bf16_ulp_check("flash_attention", got, want)
    simt_err = bf16_ulp_check("flash_attention (SIMT)", simt(), want)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    sdpa_err = float((sdpa().float() - want.float()).abs().max())
    pairs = int(visible(torch.arange(tq, device=q.device)[:, None],
                        torch.arange(tk, device=q.device)[None, :],
                        causal, window, prefix).sum()) * b * hq
    flash_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flash_ops = 4 * d * pairs                  # Q K^T and P V, 2 FLOP a multiply-add
    # The tensor-core design's work: Q K^T and P V in three bf16 terms.
    design_ops = 2 * d * pairs * 4
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:150",
        launches=launches["flash_attention"], max_abs_err=err,
        launches_per_call=launches["flash_attention"] // 4,
        ms=cuda_ms(flash, 10), plain_ms=cuda_ms(plain, 2), library_ms=cuda_ms(sdpa, 10),
        simt_ms=cuda_ms(simt, 3), simt_max_abs_err=simt_err,
        simt_source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        **bound(flash_bytes, flash_ops, BF16_TENSOR_OPS_PER_S),
        bound_ms_4_products=max(design_ops / BF16_TENSOR_OPS_PER_S,
                                flash_bytes / HBM_BYTES_PER_S) * 1e3,
        bound_ms_f32=flash_ops / F32_OPS_PER_S * 1e3,
        shape={"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)},
        visible_pairs=pairs, library_max_abs_err=sdpa_err,
        max_abs_out=float(want.float().abs().max()),
        sharp_softmax_beyond_ulp_of_exact=sharp_softmax_agreement(d, tq, hq // hkv, q.device),
        sharp_softmax_outputs=(hq // hkv) * tq * d,
    ))

    (x, scale, eps), _ = store["rmsnorm"]
    x2 = x.reshape(-1, x.shape[-1])
    norm = lambda: rms_k.rmsnorm_cuda(x2, scale, eps)
    plain = lambda: rmsnorm_ref(x2, scale, eps)
    err = bf16_ulp_check("rmsnorm", norm(), plain())
    # The path's scales are the init's ones: a random scale on the same rows
    # also checks how the kernel indexes it.
    g = torch.Generator(device=x2.device).manual_seed(0)
    rand = (1 + 0.2 * torch.randn(scale.shape, generator=g, device=x2.device)).to(scale.dtype)
    rand_err = bf16_ulp_check("rmsnorm, random scale", rms_k.rmsnorm_cuda(x2, rand, eps),
                              rmsnorm_ref(x2, rand, eps))
    lib = lambda: F.rms_norm(x2, (x2.shape[-1],), weight=scale, eps=eps)
    lib_err = float((lib().float() - plain().float()).abs().max())
    dec = x2[:LM_BATCH].contiguous()
    rows.append(dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:41",
        launches=launches["rmsnorm"], max_abs_err=max(err, rand_err),
        launches_per_call=launches["rmsnorm"] // 4, random_scale_max_abs_err=rand_err,
        ms=cuda_ms(norm, 50), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 50),
        **bound(2 * x2.numel() * x2.element_size() + scale.numel() * scale.element_size(),
                3 * x2.numel()),
        shape={"x": list(x2.shape), "dtype": str(x2.dtype), "scale_dtype": str(scale.dtype)},
        library_max_abs_err=lib_err,
        decode_rows=LM_BATCH,
        decode_ms=cuda_ms(lambda: rms_k.rmsnorm_cuda(dec, scale, eps), 200),
        decode_plain_ms=cuda_ms(lambda: rmsnorm_ref(dec, scale, eps), 200),
        decode_library_ms=cuda_ms(
            lambda: F.rms_norm(dec, (dec.shape[-1],), weight=scale, eps=eps), 200),
        decode_device_ms=graph_ms(lambda: rms_k.rmsnorm_cuda(dec, scale, eps), 200),
        decode_library_device_ms=graph_ms(
            lambda: F.rms_norm(dec, (dec.shape[-1],), weight=scale, eps=eps), 200),
    ))
    for r in rows:
        emit("kernel", **r)
    return rows


# ((B, Hq, Hkv, Tq, Tk, D), mask kwargs) of the flash kernels' small checks:
# groups 1 and 3, D 16 / 128 / 256, Tk not a multiple of the 64-key tile.
FLASH_VARIANTS = {
    "window_g3_d128": ((1, 6, 2, 200, 200, 128), dict(causal=True, window=50)),
    "prefix_g1_d16": ((1, 2, 2, 130, 130, 16), dict(causal=True, prefix_len=40)),
    "kv_offset_d256": ((1, 3, 1, 40, 170, 256), dict(causal=True, kv_offset=130)),
    "kv_len_full_d128": ((2, 3, 3, 70, 93, 128), dict(causal=False)),
    "decode_row_d128": ((4, 24, 8, 1, 333, 128), dict(causal=True, kv_offset=332)),
    "all_terms_d16": ((1, 4, 2, 90, 101, 16), dict(causal=True, window=9, prefix_len=7,
                                                    kv_offset=11)),
}


def phase_flash_variants():
    """Every mask variant through the flash kernels: the SIMT kernel in f32
    and bf16 at the variant's head dim, the tensor-core kernels in bf16 at
    that head dim (64, 128, 256), and a D 16 variant at 64 and at 256."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops

    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    runs = [(name, shape, kw, dtype, fa_k.flash_attention_simt_cuda, "simt")
            for name, (shape, kw) in FLASH_VARIANTS.items()
            for dtype in (torch.float32, torch.bfloat16)]
    for name, (shape, kw) in FLASH_VARIANTS.items():
        for d in (shape[-1],) if shape[-1] in fa_k.TC_KERNELS else (64, 256):
            runs.append((name, shape[:-1] + (d,), kw, torch.bfloat16,
                         fa_k.flash_attention_wgmma_cuda, "tc"))
    for name, (b, hq, hkv, tq, tk, d), kw, dtype, kernel, which in runs:
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
        got = kernel(q, k, v, **kw)
        want = fa_ops.chunked_attention(q, k, v, block_k=64, **kw)
        oracle = fa_ops.flash_attention(q, k, v, impl="reference", **kw)
        key = f"{name}_{str(dtype).split('.')[-1]}_{which}_d{d}"
        if dtype == torch.float32:
            e = float((got - want).abs().max())
            e2 = float((got - oracle).abs().max())
            if not max(e, e2) <= 2e-5:
                raise AssertionError(f"flash_attention {key}: max error {e} (oracle {e2})")
        else:
            e = bf16_ulp_check(f"flash_attention {key}", got, want)
            bf16_ulp_check(f"flash_attention {key} (oracle)", got, oracle)
        errs[key] = e
    emit("flash_variants", cases={k: list(v[0]) + [v[1]] for k, v in FLASH_VARIANTS.items()},
         max_abs_err=errs, tolerance="f32 2e-5; bf16 one bf16 ulp")

# -------------------------------------------------------- the LM families

def family_model(arch: str, reduced: bool = False):
    """``arch`` with the flash kernel for prefill attention."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import build_model

    cfg = reduced_config(arch) if reduced else get_config(arch)
    return build_model(dataclasses.replace(cfg, attention_impl="cuda"))


def family_batch(cfg, batch, length, device, dtype, seed=1):
    """Tokens from a numpy seed, and unit-normal ``patches`` (VLM) or
    ``frames`` (encoder–decoder) from a generator on ``device``."""
    out = {"tokens": lm_tokens(batch, length, cfg.vocab_size, seed).to(device)}
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "vlm":
        out["patches"] = torch.randn((batch, cfg.prefix_tokens, cfg.d_model), generator=g,
                                     device=device).to(dtype)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=g,
                                    device=device).to(dtype)
    return out


def family_launches(cfg, prefill_calls: int, decode_steps: int, dtype) -> dict:
    """The launches the model's layer list implies: a flash call for each
    attention layer, cross-attention and encoder layer of a prefill (the
    kernel by the dispatch rule); two RMSNorms a layer and the final one a
    call or step where the config norms by RMS."""
    from repro_torch.kernels.flash_attention import kernel as fa_k

    want = {k: 0 for k in read_counts()}
    attn = sum(k in ("attn", "local_attn") for k in cfg.layer_kinds())
    flash = attn * (2 if cfg.is_encoder_decoder else 1) + cfg.n_encoder_layers
    tc = fa_k.uses_tensor_cores(dtype, cfg.head_dim)
    want["flash_attention" if tc else "flash_attention_simt"] = flash * prefill_calls
    if cfg.norm == "rmsnorm":
        want["rmsnorm"] = (2 * cfg.n_layers + 1) * (prefill_calls + decode_steps)
    return want


def train_launches(cfg, steps: int) -> dict:
    """Launches of ``steps`` train steps with remat: a prefill's flash calls
    twice a step (each attention, cross-attention and encoder layer in the
    forward and in its recomputed forward); where the config norms by RMS,
    two RMSNorms a layer in each pass and the final norm once (outside the
    layers' remat)."""
    want = family_launches(cfg, 2 * steps, 0, getattr(torch, cfg.dtype))
    if cfg.norm == "rmsnorm":
        want["rmsnorm"] = steps * (4 * cfg.n_layers + 1)
    return want


def train_plan(arch: str, cfg, batch: int, length: int) -> dict:
    """The ``memory`` of the port's one-device plan of a train step of
    ``cfg`` over ``batch`` x ``length`` tokens (``launch/dryrun.py`` on the
    meta device, no card), and its host seconds."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    rec = dryrun.run_cell(arch, ShapeSpec("train", length, batch, "train"), "one", None,
                          verbose=False, mesh=mesh, cfg=cfg)
    return dict(rec["memory"], plan_s=time.perf_counter() - t0)


def phase_family_train(name: str, arch: str, layers: int, batch: int, length: int,
                       warmup: int = TRAIN_FAMILY_WARMUP, steps: int = TRAIN_FAMILY_STEPS):
    """``arch`` at its published widths cut to ``layers`` layers, for
    training: f32 weights and AdamW moments drawn on the card, bf16 compute,
    remat, the flash kernel; ``make_train_step`` over the data pipeline's
    ``batch`` x ``length`` batches, ``warmup`` + ``steps`` steps, counters
    zeroed just before the first and read after the last.  Printed beside
    the card's peak: the one-device plan's peak estimate at ``layers`` and
    at the next depth the pattern allows.  Returns the first flash and
    RMSNorm calls' inputs, the launches and the config."""
    from repro_torch import training
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models.params import tree_map, tree_size
    from repro_torch.optim import adamw

    published = get_config(arch)
    model = train_model(reduced=False, arch=arch, layers=layers)
    cfg = model.cfg
    plan = train_plan(arch, cfg, batch, length)
    step_l = len(cfg.block_pattern)
    deeper = None
    if layers + step_l <= published.n_layers:
        deeper = train_plan(arch, dataclasses.replace(cfg, n_layers=layers + step_l), batch,
                            length)
    t0 = time.perf_counter()
    state = training.init_train_state(model, 0, "cuda")
    n_params = tree_size(state.params)
    data = DataConfig(seed=0, batch=batch, seq_len=length)
    batches = [device_batch(data, cfg, i, "cuda") for i in range(warmup + steps)]
    opt = adamw.AdamWConfig()
    step = training.make_train_step(model, opt)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    store, undo = capture_first_calls()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses, norms = [], [], []
    try:
        for b in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        undo()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(batches)
    want = train_launches(cfg, n_steps)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{name}: losses {losses}, grad norms {norms}")
    med = statistics.median(times[warmup:])
    # The optimizer's share of a step: one more AdamW update of every leaf
    # (zero gradients; the same passes), timed after a warm-up call.
    grads = tree_map(torch.zeros_like, state.params)
    _, adamw_ms = warm_timed(lambda: adamw.apply(opt, state.opt, state.params, grads))
    del grads
    extra = {}
    if cfg.is_moe:
        extra.update(experts=cfg.n_experts, top_k=cfg.top_k)
    if cfg.family == "vlm":
        extra["patches"] = cfg.prefix_tokens
    if cfg.is_encoder_decoder:
        extra.update(frames=cfg.encoder_seq, encoder_layers=cfg.n_encoder_layers)
    cuts = {}
    if layers < published.n_layers:
        cuts["layers"] = f"{layers} of {published.n_layers}"
    emit(name, arch=cfg.name, nvidia_smi=nvidia_smi_line(), layers=cfg.n_layers,
         published_layers=published.n_layers, cuts=cuts, d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, params=n_params, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.dtype, remat=cfg.remat, batch=batch, seq_len=length,
         setup_s=setup_s, plan_s=plan["plan_s"], warmup_ms=[1e3 * t for t in times[:warmup]],
         step_ms=[1e3 * t for t in times[warmup:]], median_step_ms=1e3 * med,
         tokens_per_s=batch * length / med, losses=losses, grad_norms=norms,
         peak_memory_bytes=peak, plan_peak_estimate_bytes=plan["peak_estimate_bytes"],
         peak_over_plan=peak / plan["peak_estimate_bytes"],
         plan_argument_bytes=plan["argument_bytes"], plan_temp_bytes=plan["temp_bytes"],
         plan_limit_bytes=TRAIN_PLAN_LIMIT,
         plan_next_depth=None if deeper is None else layers + step_l,
         plan_next_depth_peak_bytes=None if deeper is None else deeper["peak_estimate_bytes"],
         adamw_apply_ms=adamw_ms, adamw_share=adamw_ms / (1e3 * med), launches=launches,
         launches_per_step={k: v / n_steps for k, v in launches.items() if v}, **extra)
    del state, batches, step
    torch.cuda.empty_cache()
    return store, launches, cfg


def phase_train_families():
    """Each train arch's reduced config on the card against the CPU, then
    the full-width train phases of ``TRAIN_PHASES`` in order, each freed
    before the next; returns their kernel rows."""
    rows = []
    for _, arch, *_ in TRAIN_PHASES:
        phase_train_small(arch)
    for prefix, arch, layers, batch, length in TRAIN_PHASES:
        store, launches, cfg = phase_family_train(f"{prefix}_train", arch, layers, batch,
                                                  length)
        rows += train_kernel_rows(store, launches, cfg, tag=f"train, {arch}")
        del store
        torch.cuda.empty_cache()
    return rows


def moe_drop_spy():
    """Wrap ``moe.assignments`` to keep each call's count of assignments
    dropped by capacity (a device tensor, read later) and of assignments;
    returns ``(drops, undo)``."""
    from repro_torch.models import moe as moe_mod

    drops, old = [], moe_mod.assignments

    def spy(*args, **kw):
        rank, keep, order = old(*args, **kw)
        drops.append(((~keep).sum(), keep.numel()))
        return rank, keep, order

    moe_mod.assignments = spy

    def undo():
        moe_mod.assignments = old

    return drops, undo


def phase_families_small():
    """Each family's reduced config (f32) on the card against the CPU: one
    set of weights from a CPU generator, the prefill step (flash kernel) on
    24-token prompts and 8 decode steps; logits atol 1e-4, launches as the
    layer list implies."""
    from repro_torch.models.params import tree_map
    from repro_torch.training import make_decode_step, make_prefill_step

    errs = {}
    for _, arch, _, _ in FAMILY_PHASES:
        model = family_model(arch, reduced=True)
        cfg = model.cfg
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = family_batch(cfg, 2, 24, "cpu", torch.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), params)
            if dev == "cuda":
                reset_counts()
            pre = make_prefill_step(model)(p, {k: v.to(dev) for k, v in batch.items()})
            cache = model.init_cache(2, 32, dev)
            step = make_decode_step(model)
            dec = []
            for i in range(8):
                lg, cache = step(p, cache, batch["tokens"][:, i:i + 1].to(dev), i)
                dec.append(lg)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counts()
            out[dev] = (pre.cpu(), torch.cat(dec, 1).cpu())
        want = family_launches(cfg, 1, 8, torch.float32)
        if launches != want:
            raise AssertionError(f"families_small {arch}: launches {launches}, want {want}")
        errs[arch] = [float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
        if not max(errs[arch]) <= 1e-4:
            raise AssertionError(f"families_small {arch}: logits differ from the CPU by "
                                 f"{errs[arch]}")
    emit("families_small", max_logit_err={a: {"prefill": e[0], "decode": e[1]}
                                          for a, e in errs.items()}, tolerance=1e-4)


def phase_family_prefill(prefix: str, arch: str, batch: int, length: int):
    """Full-width ``make_prefill_step`` of ``arch`` (bf16 weights from a seed)
    over ``batch`` prompts: one warm-up and 3 timed calls, counters zeroed
    just before the warm-up and read after the last call.  Returns the first
    flash and RMSNorm calls' inputs and the launches."""
    from repro_torch.models.params import tree_size
    from repro_torch.training import make_prefill_step

    t0 = time.perf_counter()
    model = family_model(arch)
    cfg = model.cfg
    params = model.init(0, device="cuda", dtype=model.compute_dtype)
    n_params = tree_size(params)
    inputs = family_batch(cfg, batch, length, "cuda", model.compute_dtype)
    step = make_prefill_step(model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    store, undo = capture_first_calls()
    drops, undo_drops = moe_drop_spy()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = step(params, inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    finally:
        undo()
        undo_drops()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = family_launches(cfg, 4, 0, model.compute_dtype)
    if launches != want:
        raise AssertionError(f"{prefix}_prefill: launches {launches}, want {want}")
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) or not finite:
        raise AssertionError(f"{prefix}_prefill: logits {tuple(logits.shape)}, finite {finite}")
    med = statistics.median(times[1:])
    extra = {}
    if cfg.is_moe:
        layer_drops = [int(d) for d, _ in drops[:cfg.n_layers]]       # the warm-up call
        extra = dict(capacity_factor=cfg.capacity_factor,
                     assignments_per_layer=drops[0][1], dropped_per_layer=layer_drops,
                     dropped_share=sum(layer_drops) / (drops[0][1] * cfg.n_layers))
    if cfg.family == "vlm":
        extra["patches"] = cfg.prefix_tokens
    if cfg.is_encoder_decoder:
        extra["frames"] = cfg.encoder_seq
    emit(f"{prefix}_prefill", arch=cfg.name, nvidia_smi=nvidia_smi_line(), layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, params=n_params, batch=batch,
         prompt_len=length, setup_s=setup_s, warmup_ms=1e3 * times[0],
         call_ms=[1e3 * t for t in times[1:]], median_ms=1e3 * med,
         prompt_tokens_per_s=batch * length / med, peak_memory_bytes=peak,
         launches=launches, launches_per_call={k: v // 4 for k, v in launches.items() if v},
         logits_finite=finite, **extra)
    del params, inputs, logits
    torch.cuda.empty_cache()
    return store, launches


def decode_loop(model, params, prompt, gen, cache_len):
    """serve.py's loop through ``decode_step`` with a cache of ``cache_len``
    slots: the prompt fed token by token, then ``gen`` greedy tokens."""
    cache = model.init_cache(prompt.shape[0], cache_len, prompt.device)
    step = torch.no_grad()(model.decode_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(prompt.shape[1]):
        logits, cache = step(params, cache, prompt[:, i:i + 1], i)
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    generated = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for i in range(prompt.shape[1], prompt.shape[1] + gen):
        generated.append(tok[:, 0].cpu().numpy())
        logits, cache = step(params, cache, tok, i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    return dict(prefill_s=t_prompt, decode_s=time.perf_counter() - t0, logits=logits,
                generated=np.stack(generated, axis=1))


def phase_family_serve(prefix: str, arch: str):
    """Batch 4, 128 prompt tokens fed through ``decode_step`` and 64 greedy
    tokens at full width: ``serve.main`` (the VLM: the same loop with a
    cache of 256 + 192 slots, so that the decode positions, offset by the
    prefix, are written).  The phases of ``DECODE_VS_PREFILL`` also hold
    the prompt's last logits against the prefill step (flash kernel) on the
    same prompts (relative L2 <= 0.05)."""
    from repro_torch.launch import serve
    from repro_torch.training import make_prefill_step

    steps = LM_SERVE_PROMPT + LM_SERVE_GEN
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if prefix == "vlm":
        model = family_model(arch)
        params = model.init(0, device="cuda", dtype=model.compute_dtype)
        prompt = lm_tokens(LM_BATCH, LM_SERVE_PROMPT, model.cfg.vocab_size, 0).cuda()
        reset_counts()
        out = decode_loop(model, params, prompt, LM_SERVE_GEN, model.cfg.prefix_tokens + steps)
        out["config"] = model.cfg
        del params
    else:
        reset_counts()
        out = serve.main(["--arch", arch, "--no-reduced", "--batch", str(LM_BATCH),
                          "--prompt-len", str(LM_SERVE_PROMPT), "--gen", str(LM_SERVE_GEN),
                          "--seed", "0"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg = out["config"]
    want = family_launches(cfg, 0, steps, torch.bfloat16)
    if launches != want:
        raise AssertionError(f"{prefix}_serve: launches {launches}, want {want}")
    finite = bool(torch.isfinite(out["logits"]).all())
    if out["generated"].shape != (LM_BATCH, LM_SERVE_GEN) or not finite:
        raise AssertionError(f"{prefix}_serve: generated {out['generated'].shape}, "
                             f"finite {finite}")
    extra = {}
    if prefix in DECODE_VS_PREFILL:
        pre = make_prefill_step(family_model(arch))(out["params"], {"tokens": out["prompt"]})
        dec = out["prompt_logits"][:, 0]
        rel_l2 = float(torch.linalg.norm(dec - pre[:, 0]) / torch.linalg.norm(pre[:, 0]))
        if not rel_l2 <= 0.05:
            raise AssertionError(f"{prefix}_serve: decode vs prefill relative L2 {rel_l2}")
        extra = dict(decode_vs_prefill_rel_l2=rel_l2,
                     top1_agree=(dec.argmax(-1) == pre[:, 0].argmax(-1)).tolist())
    emit(f"{prefix}_serve", arch=cfg.name, nvidia_smi=nvidia_smi_line(), batch=LM_BATCH,
         prompt_len=LM_SERVE_PROMPT, gen=LM_SERVE_GEN, run_s=run_s,
         prefill_by_decode_ms_per_step=1e3 * out["prefill_s"] / LM_SERVE_PROMPT,
         decode_s=out["decode_s"], decode_ms_per_step=1e3 * out["decode_s"] / LM_SERVE_GEN,
         decode_tokens_per_s=LM_BATCH * LM_SERVE_GEN / out["decode_s"],
         peak_memory_bytes=peak, launches=launches, logits_finite=finite,
         sample=out["generated"][0][:8].tolist(), **extra)
    del out
    torch.cuda.empty_cache()


def visible_tiles(tq, tk, causal, window, prefix, device) -> int:
    """(64-query, 64-key) tiles holding a visible pair: the blocks a kernel
    that skips hidden tiles computes."""
    from repro_torch.kernels.flash_attention.ref import visible

    vis = visible(torch.arange(tq, device=device)[:, None],
                  torch.arange(tk, device=device)[None, :], causal, window, prefix)
    vis = torch.nn.functional.pad(vis, (0, -tk % FLASH_TILE, 0, -tq % FLASH_TILE))
    tiles = vis.reshape(vis.shape[0] // FLASH_TILE, FLASH_TILE, vis.shape[1] // FLASH_TILE,
                        FLASH_TILE).any(3).any(1)
    return int(tiles.sum())


def flash_source(dtype, d) -> str:
    """The source of the flash kernel that ``flash_attention_cuda`` runs on
    ``dtype`` at head dim ``d``, relative to the checkout."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k

    name = fa_k.TC_KERNELS[d][0] if fa_k.uses_tensor_cores(dtype, d) else "flash_attention"
    return str(_build.SOURCES[name].relative_to(ROOT))


def family_kernel_rows(tag, store, launches):
    """flash_attention and rmsnorm on the inputs of their first calls in a
    family's prefill (layer 0), against their plain versions (one bf16
    ulp), timed beside the plain versions and one PyTorch call of the same
    function (``scaled_dot_product_attention`` as ``sdpa_call`` gives it;
    ``library_masked_ms`` times it with the boolean mask in every case;
    ``rms_norm``).  A model that norms by LayerNorm (command-r) calls no
    RMSNorm and gets the flash row alone."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import visible
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    (q, k, v), kw = store["flash_attention"]
    causal, window, prefix = kw["causal"], kw["window"], kw["prefix_len"]
    b, hq, tq, d = q.shape
    tk = k.shape[2]
    mask = visible(torch.arange(tq, device=q.device)[:, None],
                   torch.arange(tk, device=q.device)[None, :], causal, window, prefix)
    kernel = lambda: fa_k.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                               prefix_len=prefix)
    # The SIMT kernel on the same inputs: the kernel this path ran before
    # the D 256 tensor-core kernel, timed in the same run.
    simt = lambda: fa_k.flash_attention_simt_cuda(q, k, v, causal=causal, window=window,
                                                  prefix_len=prefix)
    plain = lambda: fa_ops.chunked_attention(q, k, v, causal=causal, window=window,
                                             prefix_len=prefix, block_k=128)
    sdpa_masked = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                         enable_gqa=True)
    sdpa = sdpa_call(q, k, v, causal, window, prefix)
    tc = fa_k.uses_tensor_cores(q.dtype, d)
    counter = "flash_attention" if tc else "flash_attention_simt"
    want, plain_ms = warm_timed(plain)
    err = bf16_ulp_check(f"flash_attention[{tag}]", kernel(), want)
    simt_err = bf16_ulp_check(f"flash_attention[{tag}] (SIMT)", simt(), want)
    lib_err = float((sdpa().float() - want.float()).abs().max())
    pairs = int(mask.sum()) * b * hq
    tiles = visible_tiles(tq, tk, causal, window, prefix, q.device) * b * hq
    flash_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    blocks_ms = 4 * d * tiles * FLASH_TILE ** 2 / BF16_TENSOR_OPS_PER_S * 1e3
    rows = [dict(
        name=f"flash_attention[{tag}]", route="cuda", source=flash_source(q.dtype, d),
        replaces="src/repro/kernels/flash_attention/kernel.py:150",
        launches=launches[counter], max_abs_err=err, counter=counter,
        ms=cuda_ms(kernel, 5), plain_ms=plain_ms, library_ms=cuda_ms(sdpa, 5),
        library_masked_ms=cuda_ms(sdpa_masked, 5), simt_ms=cuda_ms(simt, 3),
        simt_max_abs_err=simt_err, simt_source=flash_source(torch.float32, d),
        **bound(flash_bytes, 4 * d * pairs, BF16_TENSOR_OPS_PER_S),
        blocks_bound_ms=blocks_ms,
        # The D 256 kernel's five products a visible tile (S in each of its
        # two warpgroups, three P V terms over half of D in each).
        design_bound_ms=2.5 * blocks_ms if tc and d == 256 else None,
        nvidia_smi=nvidia_smi_line(), visible_pairs=pairs, visible_tiles=tiles, library_max_abs_err=lib_err,
        mask={"causal": causal, "window": window, "prefix_len": prefix},
        shape={"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)},
    )]
    if "rmsnorm" in store:
        (x, scale, eps), _ = store["rmsnorm"]
        x2 = x.reshape(-1, x.shape[-1])
        norm = lambda: rms_k.rmsnorm_cuda(x2, scale, eps)
        plain = lambda: rmsnorm_ref(x2, scale, eps)
        lib = lambda: F.rms_norm(x2, (x2.shape[-1],), weight=scale, eps=eps)
        rows.append(dict(
            name=f"rmsnorm[{tag}]", route="cuda",
            source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm/kernel.py:41",
            launches=launches["rmsnorm"],
            max_abs_err=bf16_ulp_check(f"rmsnorm[{tag}]", norm(), plain()),
            ms=cuda_ms(norm, 50), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 50),
            **bound(2 * x2.numel() * x2.element_size() + scale.numel() * scale.element_size(),
                    3 * x2.numel()),
            shape={"x": list(x2.shape), "dtype": str(x2.dtype)},
        ))
    for r in rows:
        emit("kernel", **r)
    return rows


def phase_families():
    """The family phases in order, each model freed before the next; returns
    the kernel rows of the ``FAMILY_ROWS`` prefills."""
    rows = []
    phase_families_small()
    for prefix, arch, batch, length in FAMILY_PHASES:
        store, launches = phase_family_prefill(prefix, arch, batch, length)
        if prefix in FAMILY_ROWS:
            rows += family_kernel_rows(arch, store, launches)
        del store
        torch.cuda.empty_cache()
        phase_family_serve(prefix, arch)
    return rows

# ------------------------------------------------------------ LM training

TRAIN_LAYERS = 16                # of phi4-mini's 32: params, f32 grads, two moments
TRAIN_BATCH = 2
TRAIN_LEN = 2048
TRAIN_WARMUP = 2
TRAIN_STEPS = 4
# train_small: AdamW with eps 1e-3, so that a gradient within round-off of 0
# moves its parameter by about lr * g / eps on both devices, not by +-lr
# with a sign that round-off picks.
TRAIN_SMALL_OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10, eps=1e-3)
TRAIN_SMALL_RTOL = 1e-5          # losses and grad norms
TRAIN_SMALL_ATOL = 1e-5          # every parameter after 3 steps


def train_model(reduced: bool, arch: str = LM_ARCH, layers: int = TRAIN_LAYERS):
    """``arch`` for training: the flash kernel, ``remat=True`` (the reduced
    config turns it off), the full config cut to ``layers`` layers."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import build_model

    if reduced:
        cfg = reduced_config(arch)
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return build_model(dataclasses.replace(cfg, attention_impl="cuda", remat=True))


def phase_train_small(arch: str = LM_ARCH):
    """``arch``'s reduced config (f32, remat) training on the card against
    the CPU: one set of weights from a CPU generator, 3 ``make_train_step``
    steps on each over the data pipeline's batches; losses, grad norms and
    every parameter compared and gated, launches as the layer list implies."""
    from repro_torch import training
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw

    model = train_model(reduced=True, arch=arch)
    cfg = model.cfg
    start = training.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    data = DataConfig(seed=0, batch=2, seq_len=40)
    opt = adamw.AdamWConfig(**TRAIN_SMALL_OPT)
    out = {}
    for dev in ("cuda", "cpu"):
        state = tree_map(lambda t: t.to(dev, copy=True), start)
        step = training.make_train_step(model, opt)
        batches = [device_batch(data, cfg, i, dev) for i in range(3)]
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append(m)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
        out[dev] = ([{k: float(v) for k, v in m.items()} for m in mets],
                    [t.cpu() for t in tree_leaves(state.params)])
    want = train_launches(cfg, 3)
    if launches != want:
        raise AssertionError(f"train_small {arch}: launches {launches}, want {want}")
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(out["cuda"][0], out["cpu"][0]))
           for k in ("loss", "ce", "grad_norm", "lr")}
    param_err = max(float((a - b).abs().max()) for a, b in zip(out["cuda"][1], out["cpu"][1]))
    if not (max(rel.values()) <= TRAIN_SMALL_RTOL and param_err <= TRAIN_SMALL_ATOL):
        raise AssertionError(f"train_small {arch}: card against CPU: relative {rel}, "
                             f"parameters {param_err}")
    emit("train_small", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, remat=cfg.remat,
         steps=3, losses={d: [m["loss"] for m in out[d][0]] for d in out},
         grad_norms={d: [m["grad_norm"] for m in out[d][0]] for d in out},
         max_rel_err=rel, max_param_abs_err=param_err,
         tolerance={"rtol": TRAIN_SMALL_RTOL, "param_atol": TRAIN_SMALL_ATOL},
         adamw=TRAIN_SMALL_OPT, launches=launches)


def phase_train():
    """phi4-mini training at its published widths, 16 of 32 layers
    (``phase_family_train``): 2 x 2,048-token batches, 2 warm-up and 4 timed
    steps.  Returns the first flash and rmsnorm calls' inputs, the launches
    and the config."""
    return phase_family_train("train", LM_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_LEN,
                              TRAIN_WARMUP, TRAIN_STEPS)


def sdpa_call(q, k, v, causal, window, prefix):
    """``scaled_dot_product_attention`` of the flash call's function:
    ``is_causal`` at a plain causal mask (its flash backend), no mask where
    every key is visible, else the boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import visible

    if window is None and not prefix:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
    mask = visible(torch.arange(q.shape[2], device=q.device)[:, None],
                   torch.arange(k.shape[2], device=q.device)[None, :], causal, window, prefix)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def train_kernel_rows(store, launches, cfg, tag="train"):
    """The flash and rmsnorm rows at a training shape (layer 0's first call
    in a train phase): the forward kernels with the outputs the backward
    reads, the plain backward a call, and the library's forward + backward;
    the kernels against their plain versions.  A model without attention
    (rwkv6) gets no flash row, one that norms by LayerNorm no rmsnorm row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.chunked_vjp import attention_backward
    from repro_torch.kernels.flash_attention.ref import visible
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    if "flash_attention" in store:
        (q, k, v), kw = store["flash_attention"]
        q, k, v = (t.detach() for t in (q, k, v))
        causal, window, prefix = kw["causal"], kw["window"], kw["prefix_len"]
        mask = dict(causal=causal, window=window, prefix_len=prefix)
        b, hq, tq, d = q.shape
        tk = k.shape[2]
        block = cfg.attention_block_k
        counter = ("flash_attention" if fa_k.uses_tensor_cores(q.dtype, d)
                   else "flash_attention_simt")
        dout = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
        fwd = lambda: fa_k.flash_attention_cuda(q, k, v, return_lse=True, **mask)
        plain_fwd = lambda: fa_ops.chunked_attention(q, k, v, block_k=128, return_lse=True, **mask)
        out, lse = fwd()
        (want, want_lse), plain_ms = warm_timed(plain_fwd)
        err = bf16_ulp_check(f"flash_attention[{tag}]", out, want)
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= 1e-5 * float(want_lse.abs().max()) + 1e-5:
            raise AssertionError(f"flash_attention[{tag}]: lse differs by {lse_err}")
        bwd = lambda: attention_backward(q, k, v, out, lse, dout, causal, window, prefix, 0, None,
                                         block)
        (dq, dk, dv), bwd_ms = warm_timed(bwd)
        # The gradients through the plain forward: the same backward on its out and lse.
        dq_w, dk_w, dv_w = attention_backward(q, k, v, want, want_lse, dout, causal, window, prefix,
                                              0, None, block)
        grad_rel = {n: float(torch.linalg.norm((a - w).float()) / torch.linalg.norm(w.float()))
                    for n, a, w in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w))}
        if not max(grad_rel.values()) <= 2e-2:
            raise AssertionError(f"flash_attention[{tag}]: gradients through the kernel's forward "
                                 f"against the plain forward's: relative L2 {grad_rel}")
        del dq, dk, dv, dq_w, dk_w, dv_w
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = sdpa_call(qs, ks, vs, causal, window, prefix)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qs, ks, vs), dout)

        pairs = int(visible(torch.arange(tq, device=q.device)[:, None],
                            torch.arange(tk, device=q.device)[None, :],
                            causal, window, prefix).sum()) * b * hq
        flash_ops = 4 * d * pairs
        flash_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * lse.numel()
        rows.append(dict(
            name=f"flash_attention[{tag}]", route="cuda", source=flash_source(q.dtype, d),
            replaces="src/repro/kernels/flash_attention/kernel.py:150",
            launches=launches[counter], counter=counter, max_abs_err=err, lse_max_abs_err=lse_err,
            ms=cuda_ms(fwd, 10), plain_ms=plain_ms, library_ms=cuda_ms(sdpa, 10),
            **bound(flash_bytes, flash_ops, BF16_TENSOR_OPS_PER_S),
            backward_plain_ms=bwd_ms, backward_block_k=block,
            library_fwd_bwd_ms=cuda_ms(sdpa_fwd_bwd, 5),
            fwd_bwd_bound_ms=3.5 * flash_ops / BF16_TENSOR_OPS_PER_S * 1e3,
            serving_ms=cuda_ms(lambda: fa_k.flash_attention_cuda(q, k, v, **mask), 10),
            grad_rel_l2_vs_plain_forward=grad_rel, visible_pairs=pairs, mask=mask,
            shape={"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)},
        ))

    if "rmsnorm" in store:
        (x, scale, eps), _ = store["rmsnorm"]
        x2 = x.detach().reshape(-1, x.shape[-1])
        scale = scale.detach()
        norm = lambda: rms_k.rmsnorm_cuda(x2, scale, eps)
        plain = lambda: rmsnorm_ref(x2, scale, eps)
        # The library's fused path takes a weight of the input's dtype: the
        # first call's scale is the init's ones, exact in bf16.
        scale_lib = scale.to(x2.dtype)
        lib = lambda: F.rms_norm(x2, (x2.shape[-1],), weight=scale_lib, eps=eps)
        dy = torch.randn(x2.shape, generator=g, device=x2.device).to(x2.dtype)
        rows.append(dict(
            name=f"rmsnorm[{tag}]", route="cuda",
            source="src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm/kernel.py:41",
            launches=launches["rmsnorm"],
            max_abs_err=bf16_ulp_check(f"rmsnorm[{tag}]", norm(), plain()),
            ms=cuda_ms(norm, 50), plain_ms=cuda_ms(plain, 20), library_ms=cuda_ms(lib, 50),
            **bound(2 * x2.numel() * x2.element_size() + scale.numel() * scale.element_size(),
                    3 * x2.numel()),
            backward_plain_ms=cuda_ms(lambda: rms_ops.rmsnorm_backward(x2, scale, eps, dy), 20),
            shape={"x": list(x2.shape), "dtype": str(x2.dtype),
                   "scale_dtype": str(scale.dtype)},
        ))
    for r in rows:
        emit("kernel", **r)
    return rows

# ----------------------------------------------------------------- dry-run

DRYRUN_JOBS = 8                  # dry-run CLI processes at a time (the host has 8 cores)
# The single-pod (16 x 16) mesh plans only these archs here: the LM archs'
# cells are planned on the multi-pod (2 x 16 x 16) mesh, the same shapes over
# one more axis.  With both meshes the phase took 195.8 s on 8 cores, 495.5
# of its 1,077.0 process seconds the single-pod LM processes (the host of an
# NVIDIA H100 80GB HBM3, 700.00 W); tests/test_torch_dryrun_partitioned.py
# plans reduced LM configs on a two-axis mesh on the CPU.
DRYRUN_SINGLE_MESH = ("teraagent",)
# The slowest planners start first, so that no long process starts last:
# rwkv6-1.6b took 101.8-122.7 s a mesh, recurrentgemma-9b 55.5-80.0, every
# other process 28.9-70.9 (the same hosts).
DRYRUN_FIRST = ("rwkv6-1.6b", "recurrentgemma-9b")
DRYRUN_CELL_S = 120.0            # host seconds an LM cell of the grid may take to plan
DRYRUN_AGENTS = 200_000          # agents a rank of the TeraAgent step on the card
TRAIN_PEAK_SLACK = 1.10          # measured train peak / the plan's estimate, at most
MOE_PEAK_SLACK = 1.10            # measured MoE prefill peak / the plan's estimate, at most


def phase_dryrun_grid():
    """Every cell of the dry-run's grid through its CLI, one process an arch
    and mesh (``DRYRUN_JOBS`` at a time, ``CUDA_VISIBLE_DEVICES`` empty), records
    under ``build/dryrun_smoke``; fails on a failed cell, a missing cell, a
    skip other than the reference's, a cell without collective bytes (every
    cell is partitioned) or an LM cell planned in more than
    ``DRYRUN_CELL_S`` seconds."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch import dryrun

    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    # One process a (arch, mesh), the multi-pod meshes' (the slower) first,
    # and in each the slowest archs first.
    archs = sorted(sorted({a for a, _ in dryrun.grid_cells()}),
                   key=lambda a: a not in DRYRUN_FIRST)
    meshes = {"multi": archs, "single": [a for a in archs if a in DRYRUN_SINGLE_MESH]}
    jobs = [(a, m) for m in ("multi", "single") for a in meshes[m]]

    job_s = {}

    def run(job):
        arch, mesh = job
        t0 = time.perf_counter()
        out_ = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--mesh", mesh, "--out", str(out)],
                              env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        job_s[f"{arch}/{mesh}"] = time.perf_counter() - t0
        return out_

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(DRYRUN_JOBS) as pool:
        runs = dict(zip(jobs, pool.map(run, jobs)))
    wall = time.perf_counter() - t0
    failed = {a: (r.stdout[-1500:], r.stderr[-1500:]) for a, r in runs.items() if r.returncode}
    records = {(r["mesh"], r["arch"], r["shape"]): r
               for r in (json.loads(p.read_text()) for p in sorted(out.glob("*.json")))}
    want = [(m, a, s) for m in ("single", "multi") for a, s in dryrun.grid_cells()
            if a in meshes[m]]
    skip = {c for c in want if c[1] != "teraagent"
            and not shape_applicable(get_config(c[1]), SHAPES[c[2]])[0]}
    wrong = [c for c in want if c not in records
             or records[c]["status"] != ("skipped" if c in skip else "ok")]
    if failed or wrong or len(records) != len(want):
        raise AssertionError(f"dryrun_grid: failed processes {failed}, cells missing or with "
                             f"another status {wrong}, {len(records)} records for {len(want)}")
    unpartitioned = [c for c in want if c not in skip and not records[c].get(
        "collective_bytes_per_device", {}).get("total")]
    host_s = lambda c: records[c].get("lower_s", 0) + records[c].get("compile_s", 0)
    slow = [(c, host_s(c)) for c in want if c[1] != "teraagent" and host_s(c) > DRYRUN_CELL_S]
    if unpartitioned or slow:
        raise AssertionError(f"dryrun_grid: cells without collective bytes {unpartitioned}, "
                             f"LM cells over {DRYRUN_CELL_S} s {slow}")
    memory = lambda c, k: records[c].get("memory", {}).get(k)
    total = lambda c: (records[c].get("collective_bytes_per_device") or {}).get("total")
    cells = [[*c, records[c]["status"], memory(c, "argument_bytes"), memory(c, "temp_bytes"),
              total(c), host_s(c)] for c in want]
    emit("dryrun_grid", wall_s=wall, jobs=DRYRUN_JOBS, job_s=job_s, cells_total=len(want),
         ok=len(want) - len(skip), skipped=len(skip),
         partitioned=sum(bool(total(c)) for c in want),
         host_s_total=sum(c[7] for c in cells), host_s_max_lm=max(
             c[7] for c in cells if c[1] != "teraagent"), host_s_limit=DRYRUN_CELL_S,
         columns=["mesh", "arch", "shape", "status", "argument_bytes", "temp_bytes",
                  "collective_bytes", "host_s"], cells=cells)


def tree_nbytes(*trees) -> int:
    """Bytes of the tensors of ``trees`` (dicts, tuples and dataclasses)."""
    from repro_torch.launch.dryrun import tree_tensors

    return sum(t.numel() * t.element_size() for t in tree_tensors(trees))


def counted_flops(step, *args):
    """``(step(*args), FlopCounterMode's count over it, flash launches
    during it)`` on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.synchronize()
    reset_counts()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    return out, fc.get_total_flops(), read_counts()["flash_attention"]


def teraagent_step_on_card(kind: str, capacity: int) -> dict:
    """One eager lock-step step of the TeraAgent plan's mesh (2 ranks an
    axis) on ``cuda:0``, at the cell's capacities, with ``DRYRUN_AGENTS``
    seeded agents a rank: the bytes each rank sends through ``Mesh.shift``,
    the step's wall, and its peak over the state beside the plan's temp
    bytes a rank (the record of ``dryrun_grid``, or the dry-run's own run of
    the cell) and that times the ranks: the ranks run in lock-step on one
    card and peak at different ops, so one rank's peak is not separable."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import count_shift_bytes, make_mesh, make_production_mesh

    path = ROOT / "build" / "dryrun_smoke" / f"{kind}__teraagent__train_4k.json"
    rec = (json.loads(path.read_text()) if path.is_file()
           else dryrun.run_cell("teraagent", "train_4k", kind, None, verbose=False))
    small = dryrun.stepped_mesh(make_production_mesh(multi_pod=kind == "multi"))
    dcfg, _ = dryrun.teraagent_config(small)
    mesh = make_mesh(small.axis_sizes, small.axis_names, devices="cuda:0").ordered(
        dcfg.mesh_axes)
    extent = ([dcfg.extent * n for n in dcfg.axis_sizes]
              + [dcfg.extent] * (3 - dcfg.n_decomposed))
    pos = np.random.default_rng(0).uniform(0.0, extent, (DRYRUN_AGENTS * mesh.size, 3))
    state = dist.init_dist_state(dcfg, capacity, pos.astype(np.float32), diameter=1.0,
                                 device="cuda")
    ranks = dist.unstack_state(state, mesh.devices)
    scheduler = dist.distributed_scheduler(dcfg, dryrun.teraagent_engine(dcfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with count_shift_bytes() as sent:
        stepped = dist.step_ranks(mesh, scheduler, ranks, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    alive = int(sum(int(r.pool.alive.sum()) for r in stepped))
    del state, ranks, stepped
    torch.cuda.empty_cache()
    return dict(stepped_mesh=list(mesh.axis_sizes), agents=DRYRUN_AGENTS * mesh.size,
                agents_after=alive,
                collective_bytes_plan=rec["collective_bytes_per_device"]["total"],
                shift_bytes_card={str(r): n for r, n in sorted(sent.ranks().items())},
                step_s=wall, step_peak_over_state_bytes_card=peak,
                peak_estimate_bytes_plan=rec["memory"]["peak_estimate_bytes"],
                temp_bytes_plan=rec["memory"]["temp_bytes"],
                temp_bytes_plan_x_ranks=rec["memory"]["temp_bytes"] * mesh.size)


def moe_prefill_on_card(mesh) -> tuple:
    """The ``moe`` family phase's prefill (olmoe at full depth, 4 x 2,048
    tokens, the flash kernel, bf16 weights and router), planned on the
    one-device ``mesh`` and run once on the card: argument
    bytes, FLOPs (the counter's and the flash formula's), launches and peak
    beside the plan's.  Returns ``(fields, disagreements, kernel rows)``:
    the flash (D 128, group 1) and RMSNorm rows hold the first calls against
    their plain versions, with this run's launches."""
    from repro_torch import training
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model

    _, arch, batch, length = next(f for f in FAMILY_PHASES if f[0] == "moe")
    cfg = dataclasses.replace(family_model(arch).cfg, param_dtype="bfloat16")
    t0 = time.perf_counter()
    plan = dryrun.run_cell(arch, ShapeSpec("prefill", length, batch, "prefill"), "one", None,
                           verbose=False, mesh=mesh, cfg=cfg)
    plan_s = time.perf_counter() - t0
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    inputs = family_batch(cfg, batch, length, "cuda", model.compute_dtype)
    held = tree_nbytes(params, inputs)
    store, undo = capture_first_calls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        logits, flops, flash = counted_flops(training.make_prefill_step(model), params, inputs)
    finally:
        undo()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_call = dryrun.flash_attention_flops((batch, cfg.n_heads, length, cfg.head_dim),
                                            (batch, cfg.n_kv_heads, length, cfg.head_dim),
                                            True, None, 0)
    mem = plan["memory"]
    want = family_launches(cfg, 1, 0, model.compute_dtype)
    fields = dict(
        arch=arch, layers=cfg.n_layers, batch=batch, prompt_len=length, plan_s=plan_s,
        argument_bytes_plan=mem["argument_bytes"], argument_bytes_card=held,
        flops_plan=plan["flops_per_device"], flops_card=flops + flash * per_call,
        launches=launches, launches_want=want, peak_estimate_bytes=mem["peak_estimate_bytes"],
        temp_bytes=mem["temp_bytes"], peak_memory_bytes=peak,
        peak_over_estimate=peak / mem["peak_estimate_bytes"],
        logits_finite=bool(torch.isfinite(logits).all()))
    bad = [name for name, fine in (
        ("moe_prefill argument bytes", held == mem["argument_bytes"]),
        ("moe_prefill FLOPs", fields["flops_card"] == plan["flops_per_device"]),
        ("moe_prefill launches", launches == want),
        (f"moe_prefill peak over {MOE_PEAK_SLACK} x the estimate",
         fields["peak_over_estimate"] <= MOE_PEAK_SLACK),
        ("moe_prefill logits", fields["logits_finite"])) if not fine]
    del params, inputs, logits
    torch.cuda.empty_cache()
    rows = family_kernel_rows(f"{arch}, dryrun", store, launches)
    return fields, bad, rows


def phase_dryrun():
    """The dry-run's one-device plans of ``train``, ``lm_prefill``,
    ``lm_serve`` and the ``moe`` family's prefill, and the TeraAgent state,
    held against the same steps and state built on the card; returns the
    kernel rows of the MoE prefill (``moe_prefill_on_card``)."""
    from repro_torch import training
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.optim import adamw

    smi = nvidia_smi_line()
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    out = {}

    # train: phase_train's model, state and batches
    model = train_model(reduced=False)
    cfg = model.cfg
    t0 = time.perf_counter()
    plan = dryrun.run_cell(LM_ARCH, ShapeSpec("train", TRAIN_LEN, TRAIN_BATCH, "train"), "one",
                           None, verbose=False, mesh=mesh, cfg=cfg)
    plan_s = time.perf_counter() - t0
    state = training.init_train_state(model, 0, "cuda")
    data = DataConfig(seed=0, batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
    batches = [device_batch(data, cfg, i, "cuda") for i in range(2)]
    held = tree_nbytes(state, batches[0])
    step = training.make_train_step(model, adamw.AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batches[0])
    (state, _), flops, flash = counted_flops(step, state, batches[1])
    peak = torch.cuda.max_memory_allocated()
    b, t = TRAIN_BATCH, TRAIN_LEN
    per_call = dryrun.flash_attention_flops((b, cfg.n_heads, t, cfg.head_dim),
                                            (b, cfg.n_kv_heads, t, cfg.head_dim), True, None, 0)
    tiles_here = visible_tiles(t, t, True, None, 0, "cuda")
    card_flops = flops + flash * per_call
    mem = plan["memory"]
    ratio = peak / mem["peak_estimate_bytes"]
    out["train"] = dict(
        plan_s=plan_s, argument_bytes_plan=mem["argument_bytes"], argument_bytes_card=held,
        flops_plan=plan["flops_per_device"], flops_card=card_flops,
        flops_counter_card=flops, flash_launches=flash, flash_flops_per_launch=per_call,
        flash_tiles=dryrun.visible_tiles(t, t, True, None, 0), flash_tiles_chip_smoke=tiles_here,
        peak_estimate_bytes=mem["peak_estimate_bytes"], temp_bytes=mem["temp_bytes"],
        peak_memory_bytes=peak, peak_over_estimate=ratio)
    del state, batches, step
    torch.cuda.empty_cache()
    bad = []
    if held != mem["argument_bytes"]:
        bad.append("train argument bytes")
    if card_flops != plan["flops_per_device"] or tiles_here != out["train"]["flash_tiles"]:
        bad.append("train FLOPs")
    if not ratio <= TRAIN_PEAK_SLACK:
        bad.append(f"train peak {peak} over {TRAIN_PEAK_SLACK} x the estimate")

    # lm_prefill and lm_serve: phi4-mini at full depth, bf16 weights
    model = lm_model(reduced=False)
    cfg = dataclasses.replace(model.cfg, param_dtype="bfloat16")
    plan = dryrun.run_cell(LM_ARCH, ShapeSpec("prefill", LM_PREFILL_LEN, LM_BATCH, "prefill"),
                           "one", None, verbose=False, mesh=mesh, cfg=cfg)
    params = model.init(0, device="cuda", dtype=model.compute_dtype)
    toks = lm_tokens(LM_BATCH, LM_PREFILL_LEN, cfg.vocab_size, 1).cuda()
    held = tree_nbytes(params, toks)
    prefill = training.make_prefill_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, flops, flash = counted_flops(prefill, params, {"tokens": toks})
    peak = torch.cuda.max_memory_allocated()
    per_call = dryrun.flash_attention_flops((LM_BATCH, cfg.n_heads, LM_PREFILL_LEN, cfg.head_dim),
                                            (LM_BATCH, cfg.n_kv_heads, LM_PREFILL_LEN,
                                             cfg.head_dim), True, None, 0)
    mem = plan["memory"]
    out["lm_prefill"] = dict(
        argument_bytes_plan=mem["argument_bytes"], argument_bytes_card=held,
        flops_plan=plan["flops_per_device"], flops_card=flops + flash * per_call,
        flash_launches=flash, peak_estimate_bytes=mem["peak_estimate_bytes"],
        peak_memory_bytes=peak, peak_over_estimate=peak / mem["peak_estimate_bytes"])
    if held != mem["argument_bytes"]:
        bad.append("lm_prefill argument bytes")
    if out["lm_prefill"]["flops_card"] != plan["flops_per_device"]:
        bad.append("lm_prefill FLOPs")

    seq = LM_SERVE_PROMPT + LM_SERVE_GEN
    serve_plan = dryrun.lower_cell(LM_ARCH, ShapeSpec("serve", seq, LM_BATCH, "decode"), mesh,
                                   cfg=cfg)
    cache = model.init_cache(LM_BATCH, seq, "cuda")
    out["lm_serve"] = dict(
        param_bytes_plan=dryrun.spec_bytes(serve_plan.specs_in[0]),
        param_bytes_card=tree_nbytes(params),
        cache_bytes_plan=dryrun.spec_bytes(serve_plan.specs_in[1]),
        cache_bytes_card=tree_nbytes(cache))
    if out["lm_serve"]["param_bytes_plan"] != out["lm_serve"]["param_bytes_card"] or \
            out["lm_serve"]["cache_bytes_plan"] != out["lm_serve"]["cache_bytes_card"]:
        bad.append("lm_serve parameter or cache bytes")
    del params, cache, toks
    torch.cuda.empty_cache()
    out["moe_prefill"], moe_bad, rows = moe_prefill_on_card(mesh)
    bad += moe_bad

    # TeraAgent: one rank's state at the cell's capacities, and one eager
    # lock-step step of the plan's mesh on the card against the plan's bytes
    out["teraagent"] = {}
    for kind in ("single", "multi"):
        prod = make_production_mesh(multi_pod=kind == "multi")
        plan = dryrun.lower_teraagent(prod)
        dcfg, capacity = dryrun.teraagent_config(prod)
        one_rank = dataclasses.replace(dcfg, axis_sizes=(1,) * dcfg.n_decomposed)
        card = tree_nbytes(dryrun.teraagent_state(one_rank, capacity, device="cuda"))
        torch.cuda.empty_cache()
        out["teraagent"][kind] = dict(state_bytes_plan=dryrun.spec_bytes(plan.specs_in),
                                      state_bytes_card=card, capacity=capacity,
                                      **teraagent_step_on_card(kind, capacity))
        got = out["teraagent"][kind]
        if card != got["state_bytes_plan"]:
            bad.append(f"teraagent {kind} state bytes")
        if set(got["shift_bytes_card"].values()) != {got["collective_bytes_plan"]}:
            bad.append(f"teraagent {kind} exchange bytes")
    emit("dryrun", nvidia_smi=smi, peak_slack=TRAIN_PEAK_SLACK, moe_peak_slack=MOE_PEAK_SLACK,
         **out)
    if bad:
        raise AssertionError(f"dryrun: the plan disagrees with the card: {bad}")
    return rows


# ---------------------------------------------------------------------- main

def main() -> int:
    args = sys.argv[1:]
    save_to = args[1] if args[:1] == ["--save-force-inputs"] and len(args) == 2 else None
    force_inputs = {} if save_to else None
    if args and not save_to:
        print("usage: python3 chip_smoke.py [--save-force-inputs FILE]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              f"from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built_libs = _build.build(_build.SOURCES)
    emit("build", wall_s=time.perf_counter() - t0, flags=list(_build.NVCC_FLAGS),
         kernels={k: {"seconds": r.seconds, "library": str(r.library.relative_to(ROOT)),
                      "ptxas": [ln for ln in r.ptxas.splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, r in built_libs.items()})

    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    phase_small()
    built, final, launches, crowded, median = phase_slice()
    t1 = time.perf_counter()
    launches = add_counts(launches, phase_slice_jit(median))
    seconds["slice_jit"] = time.perf_counter() - t1
    rows = phase_kernels(built, final, launches, crowded, force_inputs)
    del built, final
    seconds["path 1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_spheroid_small()
    built, final, window, launches, dense_launches, medians = phase_spheroid()
    t1 = time.perf_counter()
    jit_launches, jit_dense_launches = phase_spheroid_jit(medians)
    phase_jit_divergence()
    seconds["spheroid_jit"] = time.perf_counter() - t1
    rows += spheroid_kernel_rows(built, final, window, add_counts(launches, jit_launches),
                                 add_counts(dense_launches, jit_dense_launches),
                                 force_inputs=force_inputs)
    del built, final
    if save_to:
        torch.save(force_inputs, save_to)
        force_inputs.clear()
    torch.cuda.empty_cache()
    seconds["path 2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_checkpoint()
    torch.cuda.empty_cache()
    seconds["checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_elastic()
    torch.cuda.empty_cache()
    seconds["elastic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch_s = {}

    def lap(name):
        nonlocal t0
        batch_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    phase_batch_small()
    lap("batch_small")
    sweep = phase_batch_sweep()
    lap("batch_sweep")
    built, final, launches = sweep
    sweep = (built, final, add_counts(launches, phase_batch_sweep_jit()))
    del built, final
    lap("batch_sweep_jit")
    dense = phase_batch_spheroid()
    lap("batch_spheroid")
    morton = phase_batch_spheroid_morton()
    lap("batch_spheroid_morton")
    built, final, launches, window = morton
    morton = (built, final, add_counts(launches, phase_batch_spheroid_morton_jit(window)),
              window)
    del built, final
    lap("batch_spheroid_morton_jit")
    phase_batch_jit_divergence()
    lap("batch_jit_divergence")
    phase_abm_serve()
    lap("abm_serve")
    rows += batch_kernel_rows(sweep, dense)
    rows += batch_window_row(morton)
    del sweep, dense, morton
    torch.cuda.empty_cache()
    lap("kernels")
    seconds["batch"] = sum(batch_s.values())
    seconds["batch_phases"] = batch_s
    t0 = time.perf_counter()
    phase_calibrate()
    seconds["calibrate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_sir_jit()
    seconds["sir_jit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    neurite_s = {}
    launches = phase_neurite_small()
    neurite_s["neurite_small"] = time.perf_counter() - t0
    built, final, big, crowded = phase_neurite()
    neurite_s["neurite"] = time.perf_counter() - t0 - sum(neurite_s.values())
    launches = add_counts(add_counts(big, launches), phase_neurite_batch())
    neurite_s["neurite_batch"] = time.perf_counter() - t0 - sum(neurite_s.values())
    rows += neurite_kernel_rows(built, final, launches, crowded)
    del built, final
    torch.cuda.empty_cache()
    neurite_s["kernels"] = time.perf_counter() - t0 - sum(neurite_s.values())
    seconds["neurite"] = time.perf_counter() - t0
    seconds["neurite_phases"] = neurite_s
    t0 = time.perf_counter()

    phase_dist_small()
    dsim, final, launches, record = phase_distributed()
    seconds["distributed_eager"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    procs_results, small = phase_distributed_procs(record)
    torch.cuda.empty_cache()
    seconds["distributed_procs"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    launches = add_counts(launches, phase_distributed_jit())
    torch.cuda.empty_cache()
    launches = add_counts(launches, phase_distributed_jit_variants())
    torch.cuda.empty_cache()
    crowd = phase_dist_jit_divergence()
    torch.cuda.empty_cache()
    seconds["distributed_jit"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    launches = add_counts(launches, phase_distributed_procs_jit(procs_results, small, record,
                                                                crowd, elastic_record()))
    del procs_results, record, crowd
    torch.cuda.empty_cache()
    seconds["distributed_procs_jit"] = time.perf_counter() - t1
    rows += dist_kernel_rows(dsim, final, launches)
    del dsim, final
    torch.cuda.empty_cache()
    seconds["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    phase_lm_small()
    store, lm_launches = phase_lm_prefill()
    rows += lm_kernel_rows(store, lm_launches)
    del store
    torch.cuda.empty_cache()
    phase_flash_variants()
    phase_lm_serve()
    torch.cuda.empty_cache()
    seconds["path 3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_train_small()
    rows += train_kernel_rows(*phase_train())
    torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += phase_train_families()
    seconds["train_families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += phase_families()
    seconds["families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_dryrun_grid()
    rows += phase_dryrun()
    seconds["dryrun"] = time.perf_counter() - t0
    emit("wall", seconds=seconds)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
