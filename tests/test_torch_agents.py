"""Births, deaths and compaction (§5.3.2): the port vs the JAX reference,
exactly — every slot, flag, attribute and the overflow count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agents as j_agents
from repro_torch.core import agents as t_agents
from torch_parity import CPU, to_np

CAP = 40
FIELDS = ("position", "diameter", "kind", "age", "alive", "static", "overflow")


def _pools(n_alive, seed=0):
    """One pool in both packages: ``n_alive`` live agents scattered over the
    slots, a float and a vector attribute, some static flags, ages."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 50, (CAP, 3)).astype(np.float32)
    diam = rng.uniform(1, 5, CAP).astype(np.float32)
    kind = rng.integers(0, 3, CAP).astype(np.int32)
    age = rng.uniform(0, 100, CAP).astype(np.float32)
    alive = np.zeros(CAP, bool)
    alive[rng.choice(CAP, n_alive, replace=False)] = True
    static = alive & (rng.random(CAP) < 0.5)
    attrs = {"dose": rng.uniform(0, 1, CAP).astype(np.float32),
             "direction": rng.normal(size=(CAP, 3)).astype(np.float32)}
    jp = j_agents.make_pool(CAP, jnp.asarray(pos), diameter=jnp.asarray(diam),
                            kind=jnp.asarray(kind),
                            attrs={k: jnp.asarray(v) for k, v in attrs.items()})
    jp = jp.replace(age=jnp.asarray(age), alive=jnp.asarray(alive),
                    static=jnp.asarray(static), overflow=jnp.asarray(3, jnp.int32))
    tp = t_agents.make_pool(CAP, pos, diameter=diam, kind=kind, attrs=attrs, device=CPU)
    tp = tp.replace(age=torch.from_numpy(age), alive=torch.from_numpy(alive),
                    static=torch.from_numpy(static),
                    overflow=torch.tensor(3, dtype=torch.int32))
    return jp, tp, rng


def _assert_pools_equal(tp, jp):
    for f in FIELDS:
        got, want = to_np(getattr(tp, f)), to_np(getattr(jp, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert set(tp.attrs) == set(jp.attrs)
    for k in jp.attrs:
        np.testing.assert_array_equal(to_np(tp.attrs[k]), to_np(jp.attrs[k]), err_msg=k)


# (live agents, spawners): fewer spawns than free slots, exactly as many,
# and more (the excess is dropped and counted).
SPAWN_CASES = {"fewer": (25, 6), "equal": (25, 15), "beyond": (30, 20)}


@pytest.mark.parametrize("case", sorted(SPAWN_CASES))
@pytest.mark.parametrize("given", ["inherited", "given"])
def test_add_agents_matches_jax(case, given):
    n_alive, n_spawn = SPAWN_CASES[case]
    jp, tp, rng = _pools(n_alive, seed=len(case))
    live = np.flatnonzero(to_np(tp.alive))
    spawn = np.zeros(CAP, bool)
    spawn[rng.choice(live, n_spawn, replace=False)] = True
    spawn[np.flatnonzero(~to_np(tp.alive))[:3]] = True     # dead spawners are ignored
    cpos = rng.uniform(0, 50, (CAP, 3)).astype(np.float32)
    cdiam = rng.uniform(1, 5, CAP).astype(np.float32)
    ckind = np.full(CAP, 2, np.int32)
    extra = {}
    if given == "given":
        extra = dict(attrs={"dose": rng.uniform(5, 6, CAP).astype(np.float32)},
                     age=rng.uniform(0, 1, CAP).astype(np.float32))
    want = j_agents.add_agents(
        jp, jnp.asarray(spawn), jnp.asarray(cpos), jnp.asarray(cdiam), jnp.asarray(ckind),
        attrs={k: jnp.asarray(v) for k, v in extra.get("attrs", {}).items()} or None,
        age=jnp.asarray(extra["age"]) if "age" in extra else None)
    got = t_agents.add_agents(
        tp, torch.from_numpy(spawn), torch.from_numpy(cpos), torch.from_numpy(cdiam),
        torch.from_numpy(ckind),
        attrs={k: torch.from_numpy(v) for k, v in extra.get("attrs", {}).items()} or None,
        age=torch.from_numpy(extra["age"]) if "age" in extra else None)
    _assert_pools_equal(got, want)
    n_free = CAP - n_alive
    assert int(got.overflow) == 3 + max(n_spawn - n_free, 0)
    assert int(got.num_alive()) == n_alive + min(n_spawn, n_free)


def test_remove_agents_and_compact_match_jax():
    jp, tp, rng = _pools(28, seed=7)
    kill = rng.random(CAP) < 0.3
    jr = j_agents.remove_agents(jp, jnp.asarray(kill))
    tr = t_agents.remove_agents(tp, torch.from_numpy(kill))
    _assert_pools_equal(tr, jr)
    assert int(tr.num_alive()) == int((to_np(tp.alive) & ~kill).sum())
    jc, tc = j_agents.compact(jr), t_agents.compact(tr)
    _assert_pools_equal(tc, jc)
    n = int(tc.num_alive())
    assert to_np(tc.alive)[:n].all() and not to_np(tc.alive)[n:].any()


def test_births_fill_slots_freed_by_deaths():
    """Deaths then births in one step, as the spheroid's behaviours do: the
    children take the lowest freed slots, in spawner order."""
    jp, tp, rng = _pools(CAP, seed=3)                   # a full pool
    kill = np.zeros(CAP, bool)
    kill[[4, 9, 30]] = True
    spawn = np.zeros(CAP, bool)
    spawn[[1, 2, 20, 33]] = True                        # four spawners, three slots
    pos = rng.uniform(0, 50, (CAP, 3)).astype(np.float32)
    args = (pos, np.ones(CAP, np.float32), np.zeros(CAP, np.int32))
    want = j_agents.add_agents(j_agents.remove_agents(jp, jnp.asarray(kill)),
                               jnp.asarray(spawn), *map(jnp.asarray, args))
    got = t_agents.add_agents(t_agents.remove_agents(tp, torch.from_numpy(kill)),
                              torch.from_numpy(spawn), *map(torch.from_numpy, args))
    _assert_pools_equal(got, want)
    np.testing.assert_array_equal(to_np(got.position)[[4, 9, 30]], pos[[1, 2, 20]])
    assert int(got.overflow) == 3 + 1
