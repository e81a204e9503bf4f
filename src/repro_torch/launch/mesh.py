"""The device meshes of the distributed engine.

The reference runs one program over a JAX device mesh (``shard_map``) and
moves data between devices with ``ppermute`` ring shifts.  The port has two
counterparts, which the engine reads through one interface: a mesh's
``local_ranks`` are the ranks this process steps, and :meth:`Mesh.shift`
takes one value a local rank and returns what each of them receives.

* :class:`Mesh` (``make_mesh``): R *ranks* inside one process, each a
  position on the named axes and a torch device (all on ``cuda:0`` with one
  card, ``cuda:i % n`` with n cards, or the host).  Its local ranks are all
  of them; a collective is a Python function over the list of the ranks'
  tensors, and the ring shift a rotation of that list followed by
  ``.to(receiver's device)``.
* :class:`ProcessMesh` (``process_mesh``): one process a rank, over an
  initialised ``torch.distributed`` process group (``launch/procs.py``
  starts one on this host; ``torchrun`` works as well).  Its one local rank
  is the process's own; the ring shift is one ``dist.batch_isend_irecv``
  with the two ring neighbours of every tensor of the value, packed into one
  byte buffer in a fixed leaf order.  Under NCCL device tensors go as they
  are; under gloo a card's tensors are staged through pinned host buffers
  (gloo's send and receive read host memory), and the time that takes is
  kept in ``ProcessMesh.stats``.

  While the compiled run (``core/runner.py``) captures a step of a process
  mesh in CUDA graphs (:func:`cutting`), a shift or a gather sends nothing:
  it packs its value inside the segment being captured, and the runner ends
  that segment there and keeps an :class:`Exchange`, which each replay runs
  between the segment and the next, from and into fixed buffers.

Ranks are numbered x-major over the axes in the mesh's order:
``rank = ((c0 · n1) + c1) · n2 + c2``, the linearization of
``DomainConfig.device_coords``.  :meth:`Mesh.ordered` gives the same ranks
numbered over another order of the axes (the distributed engine numbers
them in ``DomainConfig.mesh_axes`` order).

``make_production_mesh`` gives the reference's deployment meshes, (16, 16)
and (2, 16, 16), on the meta device: the dry-run (``launch/dryrun.py``)
plans them.

Two more views of a mesh serve the dry-run:

* ``count_shift_bytes()`` counts the bytes each rank sends through
  :meth:`Mesh.shift`, the distributed engine's only collective (the
  reference's ``collective-permute``).
* ``device_mesh(mesh)`` is a ``torch.distributed`` ``DeviceMesh`` of the
  mesh's shape and axis names over the default process group, which the
  caller initialises: ``fake_group(size)`` (the dry-run: the process is
  rank 0 of ``size``, and every collective only shapes its output), or any
  real group (gloo, NCCL).  DTensors placed on it carry the LM cells'
  shardings (``sharding.distribute_tree``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import socket
import time
from typing import Any, Callable, ClassVar, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import lanes
from ..device import resolve_device


def _tree_to(tree: Any, device: torch.device):
    """Every tensor of a (dict / list / tensor) tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor of a (dict / list / tensor) tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


# ``fn(sender, axis, nbytes)`` for each rank's value ``Mesh.shift`` moves.
shift_observers: List[Callable[[int, str, int], None]] = []


@dataclasses.dataclass
class ShiftBytes:
    """Bytes sent through :meth:`Mesh.shift`, ``sent[(rank, axis)]``."""

    sent: Dict[Tuple[int, str], int] = dataclasses.field(
        default_factory=collections.Counter)

    def ranks(self) -> Dict[int, int]:
        """``{rank: bytes}`` over every rank that sent."""
        out: Dict[int, int] = collections.Counter()
        for (r, _), n in self.sent.items():
            out[r] += n
        return dict(out)

    def on_axes(self, rank: int) -> Dict[str, int]:
        """``{axis: bytes}`` that ``rank`` sent along each axis."""
        return {a: n for (r, a), n in self.sent.items() if r == rank}


@contextlib.contextmanager
def count_shift_bytes() -> Iterator[ShiftBytes]:
    """Within the context, the bytes each rank sends through
    :meth:`Mesh.shift`."""
    count = ShiftBytes()

    def observe(rank: int, axis: str, nbytes: int) -> None:
        count.sent[rank, axis] += nbytes

    shift_observers.append(observe)
    try:
        yield count
    finally:
        shift_observers.remove(observe)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over R ranks, each with its device.

    axis_names: the axis names, in rank-numbering order.
    axis_sizes: the extent of each axis.
    devices:    one torch device a rank, in rank order.
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    # One process steps every rank (a ProcessMesh: one rank a process).
    process: ClassVar[bool] = False

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for {self.size} ranks")

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process steps, in the order of the lists the
        engine's collectives take: every rank."""
        return tuple(range(self.size))

    @property
    def writes_checkpoints(self) -> bool:
        """Whether this process writes a run's checkpoints."""
        return True

    def barrier(self) -> None:
        """Wait for every process of the mesh (one process: nothing)."""

    def rank_coords(self, rank: int) -> Tuple[int, ...]:
        """The coordinates of ``rank`` on the axes, in axis order."""
        coords = []
        for n in reversed(self.axis_sizes):
            coords.append(rank % n)
            rank //= n
        return tuple(coords[::-1])

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, n in zip(coords, self.axis_sizes):
            rank = rank * n + int(c) % n
        return rank

    def axis_index(self, rank: int, axis: str) -> int:
        """``jax.lax.axis_index(axis)`` as seen by ``rank``."""
        return self.rank_coords(rank)[self.axis_names.index(axis)]

    def shift(self, values: Sequence[Any], axis: str, direction: int) -> list:
        """The ring shift of ``_shift``/``ppermute``: rank i's value goes to
        the rank ``direction`` steps further along ``axis`` (mod its size),
        the other coordinates kept.  ``values`` holds one tensor (or tree of
        tensors) a rank; the result is indexed by the receiving rank and lies
        on its device.  In a running step (``core/lanes.py``) each
        receiver's lane waits on its sender's, and reads the value there."""
        if len(values) != self.size:
            raise ValueError(f"shift: {len(values)} values for {self.size} ranks")
        d = self.axis_names.index(axis)
        moves = []
        for rank, value in enumerate(values):
            if shift_observers:
                nbytes = tree_nbytes(value)
                for observe in shift_observers:
                    observe(rank, axis, nbytes)
            coords = list(self.rank_coords(rank))
            coords[d] += direction
            moves.append((rank, self.rank_of(coords)))
        lanes.shift(moves)
        out = [None] * self.size
        for (rank, dest), value in zip(moves, values):
            if self.devices[rank] == self.devices[dest]:
                out[dest] = _tree_to(value, self.devices[dest])
            else:
                # The copy is ordered after the sender's lane and before the
                # receiver's (the current streams of both devices).
                with lanes.entered(rank), lanes.entered(dest):
                    out[dest] = _tree_to(value, self.devices[dest])
            lanes.received(out[dest], dest)
        return out

    def ordered(self, axes: Sequence[str]) -> "Mesh":
        """The same ranks numbered x-major over ``axes`` (every axis of the
        mesh that is longer than 1 must be among them; the others are
        dropped)."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} are not axes of the mesh {self.axis_names}")
        left = [a for a in self.axis_names if a not in axes and self.shape[a] != 1]
        if left:
            raise ValueError(f"mesh axes {left} are not decomposed: every axis longer "
                             f"than 1 must be named")
        sizes = tuple(self.shape[a] for a in axes)
        out = Mesh(axis_names=axes, axis_sizes=sizes,
                   devices=tuple(self.devices[0] for _ in range(math.prod(sizes))))
        devices = []
        for rank in range(out.size):
            named = dict(zip(axes, out.rank_coords(rank)))
            devices.append(self.devices[self.rank_of([named.get(a, 0)
                                                      for a in self.axis_names])])
        return dataclasses.replace(out, devices=tuple(devices))


# ------------------------------------------------------------ one rank a process

_ALIGN = 8   # every packed leaf starts at a multiple of this many bytes


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[Sequence[torch.Tensor]], Any]]:
    """The tensor leaves of a (dataclass / dict / list / tuple / tensor)
    tree in a fixed order, and a function that rebuilds the tree around new
    leaves given in that order.  Anything else (None, numbers, a dataclass
    field marked ``metadata={"static": True}``) is kept as it is."""
    leaves: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            i = len(leaves) - 1
            return lambda new: new[i]
        if isinstance(t, dict):
            parts = {k: walk(v) for k, v in t.items()}
            return lambda new: {k: f(new) for k, f in parts.items()}
        if isinstance(t, (list, tuple)):
            items = [walk(v) for v in t]
            return lambda new: type(t)(f(new) for f in items)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            fields = {f.name: walk(getattr(t, f.name)) for f in dataclasses.fields(t)
                      if f.init and not f.metadata.get("static", False)}
            return lambda new: dataclasses.replace(t, **{k: f(new) for k, f in fields.items()})
        return lambda new: t

    return leaves, walk(tree)


def _offsets(leaves: Sequence[torch.Tensor]) -> Tuple[List[int], int]:
    """Each leaf's byte offset in the packed buffer, and the buffer's size."""
    offsets, end = [], 0
    for x in leaves:
        offsets.append(end)
        end += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    return offsets, max(end, _ALIGN)


def _pack(leaves: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The leaves' bytes in one uint8 buffer on ``device``, in order."""
    offsets, size = _offsets(leaves)
    buf = torch.empty((size,), dtype=torch.uint8, device=device)
    for x, at in zip(leaves, offsets):
        n = x.numel() * x.element_size()
        if n:
            buf[at:at + n].copy_(x.contiguous().reshape(-1).view(torch.uint8))
    return buf


def _unpack(buf: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``buf`` shaped and typed like ``leaves``; a (R, n) ``buf``
    gives each leaf a leading axis of R."""
    offsets, _ = _offsets(leaves)
    lead = tuple(buf.shape[:-1])
    return [buf[..., at:at + x.numel() * x.element_size()].view(x.dtype)
            .reshape(lead + tuple(x.shape)) for x, at in zip(leaves, offsets)]


@dataclasses.dataclass
class TransportStats:
    """What a :class:`ProcessMesh`'s exchanges cost this process.

    staging_s:     host seconds in gloo's staging copies (card → pinned host
                   before a send, host → card after a receive, each waited
                   for; the device's earlier work is waited for first, not
                   counted).
    staged_bytes:  the bytes those copies moved.
    wire_s:        host seconds from posting an exchange to its completion.
    gather_s:      the part of ``wire_s`` spent in all-gathers (stacking).
    exchanges:     shifts and gathers that went between processes.
    """

    staging_s: float = 0.0
    staged_bytes: int = 0
    wire_s: float = 0.0
    gather_s: float = 0.0
    exchanges: int = 0

    def reset(self) -> None:
        self.staging_s, self.staged_bytes, self.exchanges = 0.0, 0, 0
        self.wire_s = self.gather_s = 0.0


class Exchange:
    """A shift or a gather cut out of a step captured on a process mesh.

    ``send`` is the packed value, written by the segment before the cut (a
    tensor of the graphs' pool).  :meth:`place` gives the exchange its fixed
    buffers, made outside every capture: ``recv`` on the device, which the
    segment after the cut reads (a shift's receive, shaped like ``send``;
    a gather's ``(R, n)`` rows in mesh-rank order), and under gloo on a card
    the pinned host buffers the wire reads and writes.  :meth:`run` is the
    eager shift or gather, from and into those buffers."""

    def __init__(self, mesh: "ProcessMesh", kind: str, send: torch.Tensor,
                 dest: int = 0, source: int = 0):
        self.mesh, self.kind, self.send = mesh, kind, send
        self.dest, self.source = dest, source
        lead = (mesh.size,) if kind == "gather" else ()
        self.shape = lead + tuple(send.shape)
        self.recv: Optional[torch.Tensor] = None

    def place(self, store: Dict[tuple, tuple], position: int) -> None:
        """Take the buffers of the ``position``-th exchange of a step of this
        kind and shape from ``store`` (made there at first): the steps of
        one layout replay one at a time, and each consumes what it received
        before it ends, so they share them."""
        key = (position, self.kind, self.shape)
        if key not in store:
            m = self.mesh
            recv = torch.empty(self.shape, dtype=torch.uint8, device=m.device)
            if m._staging:
                store[key] = (recv, torch.empty(self.send.shape, dtype=torch.uint8,
                                                pin_memory=True),
                              torch.empty(self.shape, dtype=torch.uint8, pin_memory=True))
            else:
                store[key] = (recv, None, recv)
        self.recv, self._host_send, self._wire = store[key]

    def run(self) -> None:
        """The exchange, after the segment that packed ``send`` was enqueued
        on the current stream, and before the next segment (enqueued after
        it on the same stream) reads ``recv``."""
        m, stats = self.mesh, self.mesh.stats
        send, wire = self.send, self._wire
        if m._staging:
            torch.cuda.current_stream(m.device).record_event().synchronize()
            t0 = time.perf_counter()
            self._host_send.copy_(send)
            stats.staging_s += time.perf_counter() - t0
            stats.staged_bytes += send.nbytes
            send = self._host_send
        t0 = time.perf_counter()
        if self.kind == "shift":
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, self.dest, m.group),
                dist.P2POp(dist.irecv, wire, self.source, m.group)])
            for work in works:
                work.wait()
        else:
            dist.all_gather(list(wire.unbind(0)), send, group=m.group)
        took = time.perf_counter() - t0
        stats.wire_s += took
        if self.kind == "gather":
            stats.gather_s += took
            if m.members != tuple(range(m.size)):
                wire = wire[list(m.members)]
        stats.exchanges += 1
        if wire is not self.recv:
            t0 = time.perf_counter()
            self.recv.copy_(wire, non_blocking=True)
            stats.staging_s += time.perf_counter() - t0
            stats.staged_bytes += wire.nbytes


@dataclasses.dataclass
class Cut:
    """A step being captured on a process mesh (:func:`cutting`).

    ``cut(exchange)`` ends the segment being captured, places the exchange
    and begins the next segment; ``shifted`` collects ``(rank, axis,
    nbytes)`` of every shift of the step, for ``count_shift_bytes`` at each
    replay (the capture itself sends and counts nothing)."""

    cut: Callable[[Exchange], None]
    shifted: List[Tuple[int, str, int]] = dataclasses.field(default_factory=list)


_cutting: Optional[Cut] = None


@contextlib.contextmanager
def cutting(cut: Callable[[Exchange], None]) -> Iterator[Cut]:
    """Within the context, every shift and gather of a process mesh is cut
    out of the step being captured (``core/runner.py``)."""
    global _cutting
    if _cutting is not None:
        raise RuntimeError("a process mesh's step is already being captured")
    _cutting = Cut(cut)
    try:
        yield _cutting
    finally:
        _cutting = None


@dataclasses.dataclass(frozen=True)
class ProcessMesh(Mesh):
    """This process's view of a mesh of one process a rank, over a
    ``torch.distributed`` process group (:func:`process_mesh`).

    rank:    this process's rank on the mesh, in the mesh's numbering.
    peers:   every mesh rank's rank in the default group (the P2P peers).
    members: every mesh rank's rank within ``group`` (the order in which a
             collective over the group fills its outputs).
    group:   the process group; ``None`` is the default group.
    backend: the group's backend: ``"nccl"`` sends device tensors as they
             are; any other (gloo) stages a card's tensors through host
             memory.
    stats:   the exchanges' costs, shared by the mesh's reorderings.

    ``devices`` holds this process's device for every rank: a process sees
    no other rank's device.
    """

    rank: int = 0
    peers: Tuple[int, ...] = ()
    members: Tuple[int, ...] = ()
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    backend: str = "gloo"
    stats: TransportStats = dataclasses.field(default_factory=TransportStats, compare=False,
                                              repr=False)

    process: ClassVar[bool] = True

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        return (self.rank,)

    @property
    def writes_checkpoints(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    @property
    def _staging(self) -> bool:
        return self.backend != "nccl" and self.device.type == "cuda"

    def _to_wire(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` as the backend reads it: under gloo a card's buffer is
        copied into a pinned host buffer, once the buffer is packed (the
        host waits for the packing's event only: other work already
        enqueued, such as the interior pass on the rank's compute lane, runs
        on)."""
        if not self._staging:
            return buf
        packed = torch.cuda.current_stream(buf.device).record_event()
        packed.synchronize()
        t0 = time.perf_counter()
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        self.stats.staging_s += time.perf_counter() - t0
        self.stats.staged_bytes += buf.nbytes
        return host

    def _from_wire(self, buf: torch.Tensor) -> torch.Tensor:
        """A received buffer on this process's device."""
        if not self._staging:
            return buf
        t0 = time.perf_counter()
        out = buf.to(self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats.staging_s += time.perf_counter() - t0
        self.stats.staged_bytes += buf.nbytes
        return out

    def _like(self, wire: torch.Tensor, lead: Tuple[int, ...] = ()) -> torch.Tensor:
        if wire.device.type == "cpu":
            return torch.empty(lead + tuple(wire.shape), dtype=wire.dtype,
                               pin_memory=wire.is_pinned())
        return torch.empty(lead + tuple(wire.shape), dtype=wire.dtype, device=wire.device)

    def shift(self, values: Sequence[Any], axis: str, direction: int) -> list:
        """The ring shift over processes: ``values`` holds this process's
        one value (a tensor or tree of tensors), which goes to the rank
        ``direction`` steps further along ``axis``; the result holds what
        the rank as many steps back sent, on this process's device.  Every
        shape is static, so the receive buffer is shaped like the value
        sent.  One ``batch_isend_irecv`` posts the send and the receive
        together (on a 2-long axis both go to the same process); a shift by
        a multiple of the axis's length (an axis of length 1) sends
        nothing.  While a step is captured (:func:`cutting`) the value is
        packed in the segment being captured, the segment is cut there, and
        the result is a view of the exchange's receive buffer."""
        if len(values) != 1:
            raise ValueError(f"shift: {len(values)} values for one local rank")
        value = values[0]
        if _cutting is not None:
            _cutting.shifted.append((self.rank, axis, tree_nbytes(value)))
        elif shift_observers:
            nbytes = tree_nbytes(value)
            for observe in shift_observers:
                observe(self.rank, axis, nbytes)
        d = self.axis_names.index(axis)
        if direction % self.axis_sizes[d] == 0:
            lanes.shift([(self.rank, self.rank)])
            return [value]
        coords = list(self.rank_coords(self.rank))
        here = coords[d]
        coords[d] = here + direction
        dest = self.rank_of(coords)
        coords[d] = here - direction
        source = self.rank_of(coords)
        lanes.shift([(source, self.rank)])
        leaves, rebuild = _flatten(value)
        if _cutting is not None:
            with lanes.entered(self.rank):
                exchange = Exchange(self, "shift", _pack(leaves, self.device),
                                    dest=self.peers[dest], source=self.peers[source])
            _cutting.cut(exchange)
            return [rebuild(_unpack(exchange.recv, leaves))]
        # The packing, the wire's staging and the unpacking are the rank's
        # work: in its lane of the running step, after what made the value.
        with lanes.entered(self.rank):
            sent = self._to_wire(_pack(leaves, self.device))
            got = self._like(sent)
            t0 = time.perf_counter()
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, sent, self.peers[dest], self.group),
                dist.P2POp(dist.irecv, got, self.peers[source], self.group)])
            for work in works:
                work.wait()
            self.stats.wire_s += time.perf_counter() - t0
            self.stats.exchanges += 1
            return [rebuild(_unpack(self._from_wire(got), leaves))]

    def all_gather(self, tree: Any) -> Any:
        """Every rank's ``tree`` (the same structure, shapes and dtypes on
        every rank) stacked on a leading axis in mesh-rank order, on this
        process's device: one all-gather of the leaves packed into one
        buffer (cut out of a step being captured, as :meth:`shift` is)."""
        leaves, rebuild = _flatten(tree)
        if _cutting is not None:
            exchange = Exchange(self, "gather", _pack(leaves, self.device))
            _cutting.cut(exchange)
            return rebuild([x.contiguous() for x in _unpack(exchange.recv, leaves)])
        sent = self._to_wire(_pack(leaves, self.device))
        rows = self._like(sent, (self.size,))
        t0 = time.perf_counter()
        dist.all_gather(list(rows.unbind(0)), sent, group=self.group)
        took = time.perf_counter() - t0
        self.stats.wire_s += took
        self.stats.gather_s += took
        self.stats.exchanges += 1
        rows = self._from_wire(rows)
        if self.members != tuple(range(self.size)):
            rows = rows[list(self.members)]
        return rebuild([x.contiguous() for x in _unpack(rows, leaves)])

    def broadcast_object(self, obj: Any) -> Any:
        """Mesh rank 0's ``obj`` (a picklable object holding no tensor), on
        every process."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.peers[0], group=self.group)
        return box[0]

    def from_first(self, fn: Callable[[], Tuple[Any, Any]], like: Any) -> Tuple[Any, Any]:
        """``(meta, tree) = fn()`` run on mesh rank 0 only, on every process:
        ``meta`` (picklable, no tensor) by :meth:`broadcast_object`, ``tree``
        by :meth:`broadcast` (shaped like ``like``).  An error ``fn`` raises
        is raised on every process, not only on rank 0."""
        got = meta = None
        if self.writes_checkpoints:
            try:
                meta, got = fn()
            except Exception as err:
                meta = err
        meta = self.broadcast_object(meta)
        if isinstance(meta, Exception):
            raise meta
        return meta, self.broadcast(got, like)

    def broadcast(self, tree: Any, like: Any) -> Any:
        """Mesh rank 0's ``tree`` on every process, packed into one buffer
        (on the card under NCCL, else on the host); the other processes pass
        ``None`` and get a tree structured, shaped and typed like ``like``."""
        leaves, rebuild = _flatten(like if tree is None else tree)
        device = self.device if self.backend == "nccl" else torch.device("cpu")
        if tree is None:
            buf = torch.empty((_offsets(leaves)[1],), dtype=torch.uint8, device=device)
        else:
            buf = _pack(leaves, device)
        dist.broadcast(buf, src=self.peers[0], group=self.group)
        return rebuild(_unpack(buf, leaves))

    def all_max(self, values: Sequence[int]) -> List[int]:
        """The largest of every process's ``values``, element by element, on
        every process (one all-reduce; on the card under NCCL, else on the
        host)."""
        device = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return [int(v) for v in t.tolist()]

    def ordered(self, axes: Sequence[str]) -> "ProcessMesh":
        base = Mesh.ordered(self, axes)
        old = []
        for rank in range(base.size):
            named = dict(zip(base.axis_names, base.rank_coords(rank)))
            old.append(self.rank_of([named.get(a, 0) for a in self.axis_names]))
        return ProcessMesh(axis_names=base.axis_names, axis_sizes=base.axis_sizes,
                           devices=base.devices, rank=old.index(self.rank),
                           peers=tuple(self.peers[o] for o in old),
                           members=tuple(self.members[o] for o in old), group=self.group,
                           backend=self.backend, stats=self.stats)


def one_card_a_rank(places: Sequence[Tuple[str, str]]) -> None:
    """Raise ``ValueError`` when two ranks' ``(host, card)`` places are the
    same: NCCL refuses two ranks on one card."""
    seen: Dict[Tuple[str, str], int] = {}
    for rank, place in enumerate(places):
        place = tuple(place)
        if place in seen:
            raise ValueError(
                f"process_mesh: ranks {seen[place]} and {rank} share the card {place[1]} on "
                f"{place[0]}; NCCL takes one rank a card (gloo takes several, staging "
                f"through host memory)")
        seen[place] = rank


def process_mesh(shape: Sequence[int], axes: Sequence[str], devices=None,
                 group: Optional[Any] = None) -> ProcessMesh:
    """This process's rank of a mesh of one process a rank.

    The process group (``group``; default: the default group) must be
    initialised and hold ``prod(shape)`` processes; its rank i is mesh
    rank i.  ``devices``: ``None`` / ``"cuda"`` → ``cuda:{LOCAL_RANK %
    device_count}`` (``LOCAL_RANK`` from the environment, as ``torchrun``
    and ``launch/procs.py`` set it, else the group rank; raises without a
    card); ``"cpu"`` → the host; a device such as ``"cuda:1"`` → that one.
    Under NCCL every rank needs a card of its own: two ranks on one card
    raise ``ValueError``.  Collective: every process of the group calls it."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("process_mesh: no process group; initialise one first "
                           "(launch/procs.py, torchrun, or dist.init_process_group)")
    size = math.prod(shape)
    world = dist.get_world_size(group)
    if world != size:
        raise ValueError(f"process_mesh: the process group has {world} processes, the mesh "
                         f"{shape} {size} ranks")
    rank = dist.get_rank(group)
    if devices is None or devices == "cuda":
        resolve_device("cuda")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    else:
        dev = resolve_device(devices)
    if dev.type == "meta":
        raise ValueError("process_mesh: a rank runs on a card or on the host, not on meta")
    backend = str(dist.get_backend(group))
    peers = tuple(range(size)) if group is None else tuple(
        dist.get_global_rank(group, g) for g in range(size))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("process_mesh: NCCL runs a rank on a card; put CPU ranks on gloo")
        side = dist.new_group(ranks=list(peers), backend="gloo",
                              use_local_synchronization=True)
        places: List[Any] = [None] * size
        dist.all_gather_object(places, (socket.gethostname(),
                                        str(torch.cuda.get_device_properties(dev).uuid)),
                               group=side)
        one_card_a_rank(places)
    return ProcessMesh(axis_names=axes, axis_sizes=shape, devices=(dev,) * size, rank=rank,
                       peers=peers, members=tuple(range(size)), group=group, backend=backend)


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks on the named ``axes``.

    ``devices``: ``None`` / ``"cuda"`` spreads the ranks over the cards
    (rank i on ``cuda:i % n``; raises without a card), ``"cpu"`` puts them
    all on the host, ``"meta"`` on the meta device (the dry-run's plans: no
    storage), a sequence gives one device a rank."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    size = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and (devices is None or torch.device(devices).index is None):
            n = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", i % n) for i in range(size))
        else:
            devs = (dev,) * size
    else:
        devs = tuple(resolve_device(d) for d in devices)
    return Mesh(axis_names=axes, axis_sizes=shape, devices=devs)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's deployment meshes on the meta device (the dry-run
    plans them; nothing runs there): one pod, (16, 16) ``("data",
    "model")`` = 256 devices, or two, (2, 16, 16) ``("pod", "data",
    "model")`` = 512, whose leading axis crosses the inter-pod links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


def device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """``mesh``'s shape and axis names as a ``DeviceMesh`` over the default
    process group, which must hold ``mesh.size`` ranks (rank i at the
    coordinates ``mesh.rank_coords(i)``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group; initialise one first "
                           "(fake_group for a plan)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"device_mesh: the process group has {dist.get_world_size()} ranks, "
                         f"the mesh {mesh.size}")
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_group(size: int, rank: int = 0) -> Iterator[None]:
    """The default process group as ``torch.distributed``'s ``"fake"``
    backend over ``size`` ranks, this process being ``rank``: nothing is
    sent, a collective only gives its output's shape.  Destroyed on exit;
    raises if a group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already initialised")
    if "fake" not in dist.Backend.backend_list:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers it)
    dist.init_process_group("fake", rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
