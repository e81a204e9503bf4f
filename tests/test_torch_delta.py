"""The port's delta codec (core/delta.py) and the distributed engine's packing
primitives against the reference's, in-process, from the same numpy inputs.

The reference runs op by op here (no jit), so its multiply-adds are rounded
as the port's are: payloads, references and decoded values agree bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import to_np

from repro.core import delta as jd
from repro.core import distributed as jdist
from repro.core.agents import free_slot_table as j_free_slot_table
from repro.core.agents import make_pool as j_make_pool

from repro_torch.core import delta as td
from repro_torch.core import distributed as tdist
from repro_torch.core.agents import free_slot_table, make_pool

WIRE = {"int16": (jnp.int16, torch.int16), "int8": (jnp.int8, torch.int8)}


def _inputs(seed, n=512):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-20.0, 40.0, (n, 3)).astype(np.float32)
    x = (ref + rng.normal(0.0, 0.5, (n, 3))).astype(np.float32)
    return rng, ref, x


@pytest.mark.parametrize("wire", sorted(WIRE))
def test_encode_decode_match_reference(wire):
    """Payload, advanced reference and decoded values, bit for bit, with the
    stored scale and with a per-slot two-scale override."""
    jw, tw = WIRE[wire]
    rng, ref, x = _inputs(1)
    scale = np.float32(20.0 / 32767.0) if wire == "int16" else np.float32(2.0 / 127.0)
    per_slot = np.where(rng.random((ref.shape[0], 1)) < 0.3, np.float32(20.0 / 127.0),
                        scale).astype(np.float32)
    for override in (None, per_slot):
        jq, jc = jd.encode(jd.DeltaCodec(ref=jnp.asarray(ref), scale=jnp.float32(scale)),
                           jnp.asarray(x), wire_dtype=jw,
                           scale=None if override is None else jnp.asarray(override))
        tq, tc = td.encode(td.DeltaCodec(ref=torch.from_numpy(ref), scale=torch.tensor(scale)),
                           torch.from_numpy(x), wire_dtype=tw,
                           scale=None if override is None else torch.from_numpy(override))
        assert tq.dtype == tw
        np.testing.assert_array_equal(tq.numpy(), to_np(jq))
        np.testing.assert_array_equal(tc.ref.numpy(), to_np(jc.ref))
        jx, _ = jd.decode(jd.DeltaCodec(ref=jnp.asarray(ref), scale=jnp.float32(scale)), jq,
                          scale=None if override is None else jnp.asarray(override))
        tx, tc2 = td.decode(td.DeltaCodec(ref=torch.from_numpy(ref), scale=torch.tensor(scale)),
                            tq, scale=None if override is None else torch.from_numpy(override))
        np.testing.assert_array_equal(tx.numpy(), to_np(jx))
        assert torch.equal(tc2.ref, tx)


def test_roundtrip_bound_and_clip():
    """|x − decode(encode(x))| ≤ scale/2 in range; out-of-range deltas clip
    to the wire type's symmetric range, as the reference's do."""
    x = np.random.default_rng(2).uniform(-19.0, 19.0, (512, 3)).astype(np.float32)
    codec = td.DeltaCodec.create(x.shape, 20.0 / 32767.0)
    q, _ = td.encode(codec, torch.from_numpy(x))
    back, _ = td.decode(td.DeltaCodec.create(x.shape, 20.0 / 32767.0), q)
    assert float((back - torch.from_numpy(x)).abs().max()) <= td.roundtrip_error_bound(codec) * (
        1 + 1e-6)
    far = torch.full((4, 3), 1e6)
    q8, _ = td.encode(td.DeltaCodec.create((4, 3), 1.0), far, wire_dtype=torch.int8)
    jq8, _ = jd.encode(jd.DeltaCodec.create((4, 3), 1.0), jnp.full((4, 3), 1e6),
                       wire_dtype=jnp.int8)
    np.testing.assert_array_equal(q8.numpy(), to_np(jq8))
    assert td.wire_bytes(q8) == jd.wire_bytes(jq8) == 12
    assert td.seal(far) is far


def test_reset_slots_and_quantize_symmetric_match_reference():
    rng, ref, x = _inputs(3)
    mask = rng.random((ref.shape[0], 1)) < 0.4
    t = td.reset_slots(td.DeltaCodec(ref=torch.from_numpy(ref), scale=torch.tensor(0.1)),
                       torch.from_numpy(mask))
    j = jd.reset_slots(jd.DeltaCodec(ref=jnp.asarray(ref), scale=jnp.float32(0.1)),
                       jnp.asarray(mask))
    np.testing.assert_array_equal(t.ref.numpy(), to_np(j.ref))
    for jw, tw in WIRE.values():
        tq, ts = td.quantize_symmetric(torch.from_numpy(x), tw)
        jq, js = jd.quantize_symmetric(jnp.asarray(x), jw)
        np.testing.assert_array_equal(tq.numpy(), to_np(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(td.dequantize(tq, ts).numpy(), to_np(jd.dequantize(jq, js)))


def test_select_matches_reference():
    """_select: ids in ascending order, the valid prefix, the overflow."""
    rng = np.random.default_rng(0)
    for case in range(20):
        c = int(rng.integers(1, 200))
        capacity = int(rng.integers(1, 32))
        mask = rng.random(c) < rng.random()
        t = tdist._select(torch.from_numpy(mask), capacity)
        j = jdist._select(jnp.asarray(mask), capacity)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), to_np(b), err_msg=str(case))


def test_free_slot_table_matches_reference():
    rng = np.random.default_rng(1)
    for _ in range(10):
        alive = rng.random(int(rng.integers(1, 150))) < 0.6
        np.testing.assert_array_equal(free_slot_table(torch.from_numpy(alive)).numpy(),
                                      to_np(j_free_slot_table(jnp.asarray(alive))))


@pytest.mark.parametrize("n_records", [5, 40])
def test_insert_records_matches_reference(n_records):
    """Received records land in the free slots in the reference's order;
    records beyond the free slots are counted in ``overflow``."""
    rng = np.random.default_rng(n_records)
    c, n = 48, 30
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    tag = rng.integers(0, 100, n).astype(np.int32)
    alive = np.ones(c, bool)
    alive[n:] = False
    alive[rng.choice(n, 6, replace=False)] = False
    rec = dict(position=rng.uniform(0, 10, (n_records, 3)).astype(np.float32),
               diameter=rng.uniform(1, 2, n_records).astype(np.float32),
               kind=rng.integers(0, 3, n_records).astype(np.int32),
               age=rng.uniform(0, 5, n_records).astype(np.float32),
               attrs={"tag": rng.integers(0, 100, n_records).astype(np.int32)})
    valid = rng.random(n_records) < 0.8
    tp = make_pool(c, pos, diameter=1.5, attrs={"tag": tag})
    tp = tp.replace(alive=torch.from_numpy(alive))
    jp = j_make_pool(c, jnp.asarray(pos), diameter=1.5, attrs={"tag": jnp.asarray(tag)})
    jp = jp.replace(alive=jnp.asarray(alive))
    t_rec = {k: ({a: torch.from_numpy(b) for a, b in v.items()} if k == "attrs"
                 else torch.from_numpy(v)) for k, v in rec.items()}
    j_rec = {k: ({a: jnp.asarray(b) for a, b in v.items()} if k == "attrs" else jnp.asarray(v))
             for k, v in rec.items()}
    t = tdist._insert_records(tp, t_rec, torch.from_numpy(valid))
    j = jdist._insert_records(jp, j_rec, jnp.asarray(valid))
    for f in ("position", "diameter", "kind", "age", "alive", "static", "overflow"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), to_np(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t.attrs["tag"].numpy(), to_np(j.attrs["tag"]))
