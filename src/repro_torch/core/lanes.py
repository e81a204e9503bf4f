"""Lanes: the streams on which the distributed step's ranks run.

The reference runs every rank on its own device, all at once, and XLA
orders the work by its data alone: under ``overlap_halo`` the interior force
pass reads nothing the halo collective produced, so the two may run
concurrently (DESIGN.md §4; ``hlo_overlap_report`` asserts it).  The port
runs the ranks of an in-process mesh on one card from one host thread; a
*lane* gives each rank's work a stream of its own, so the ranks' kernels
run side by side, and the overlapped schedule's exchange a second lane
beside the interior pass.

* A :class:`Lane` is a logical stream: on the card it wraps a
  ``torch.cuda.Stream`` made by :func:`make_stream` (every lane its own;
  failing to make one raises), on the CPU or the meta device it has none,
  and entering it does nothing to the device.
* Every lane keeps a host-side *record*: the collective shifts
  (``Mesh.shift``) it has waited on, directly or through other lanes, each
  as ``(op, n)`` — the op that shifted (``migrate``, ``halo_exchange``,
  ``diffusion``) and its number within the step.  ``lane.wait(other)``
  orders the lane after the other's work so far (an event recorded on the
  other's stream, waited on by its own) and takes the other's record.  The
  bookkeeping is the same on every device, so the records — and
  ``distributed.overlap_report``, which reads them where each force pass
  issues — are the same on the CPU as on the card.
* Each local rank of a mesh has a *compute* lane and an *exchange* lane,
  made once a mesh and device (:func:`lanes_for`).  A step
  (:func:`running`, ``distributed.step_ranks``) forks every compute lane
  from the caller's current stream, runs each rank's ops in its lanes, and
  joins every lane it used back into the caller's stream before it
  returns, so the caller reads finished values.  An op that runs in the
  exchange lane forks that lane from the rank's compute lane first.
* A value an exchange-lane op hands to later ops is a :func:`product`: a
  :class:`Pending` proxy whose first use from another lane (an attribute,
  an item, a torch function, an operator) makes the reading lane wait on
  the producing one.  So the join follows the data: an op that never reads
  the exchange's products runs beside it.

A tensor read on a lane other than the one whose stream allocated it is
recorded for the reading stream (``Tensor.record_stream``), so that the
caching allocator does not hand its block to new work before the read: a
shifted value for its receiver, a rank's state for its exchange lane, a
product for its reader.  Events and waits are made once an op and rank
(never a kernel): :data:`counts` tallies them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

ROLES = ("compute", "exchange")


def make_stream(device: torch.device) -> "torch.cuda.Stream":
    """The lane factory: a new stream on the card ``device``."""
    return torch.cuda.Stream(device)


@dataclasses.dataclass
class Counts:
    """Events recorded and stream waits made by lanes (on the CPU: the
    same bookkeeping, with nothing sent to a device)."""

    events: int = 0
    waits: int = 0

    def reset(self) -> None:
        self.events = self.waits = 0


counts = Counts()

# The lanes entered, innermost last.
_current: List["Lane"] = []


class Lane:
    """A logical stream of one rank (``role``: "compute" or "exchange"), or
    the caller's stream (``rank`` None) while a step runs."""

    def __init__(self, rank: Optional[int], role: str, device: torch.device,
                 stream: Optional["torch.cuda.Stream"]):
        self.rank, self.role, self.device, self.stream = rank, role, device, stream
        self.record: frozenset = frozenset()
        self._work = 0           # bumped wherever work may have been enqueued
        self._event: Optional[tuple] = None     # (work, event) of the last event
        self._seen: Dict[int, int] = {}         # id(lane) -> its work when waited on

    def __repr__(self) -> str:
        return f"Lane(rank={self.rank}, role={self.role!r}, device={self.device})"

    def reset(self) -> None:
        """Start a step: an empty record, no event or wait kept (a graph
        capture may begin between two steps)."""
        self.record, self._event, self._seen = frozenset(), None, {}

    @contextlib.contextmanager
    def entered(self) -> Iterator["Lane"]:
        """Run the body's work on this lane."""
        self._work += 1
        _current.append(self)
        try:
            if self.stream is None:
                yield self
            else:
                with torch.cuda.stream(self.stream):
                    yield self
        finally:
            _current.pop()
            self._work += 1

    def event(self):
        """An event after this lane's work so far (one per batch of work)."""
        if self._event is None or self._event[0] != self._work:
            ev = None if self.stream is None else self.stream.record_event()
            self._event = (self._work, ev)
            counts.events += 1
        return self._event[1]

    def wait(self, other: "Lane", record: Optional[frozenset] = None) -> None:
        """Order this lane's later work after ``other``'s work so far, and
        take its record (``record``: the one to take instead, a snapshot)."""
        if other is self:
            return
        self.record = self.record | (other.record if record is None else record)
        if self._seen.get(id(other)) == other._work:
            return
        ev = other.event()
        self._seen[id(other)] = other._work
        counts.waits += 1
        if self.stream is not None and ev is not None:
            self.stream.wait_event(ev)


def current() -> Optional[Lane]:
    """The lane whose work is being issued (None outside every lane)."""
    return _current[-1] if _current else None


def tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a (dataclass / dict / list / tuple / Pending) tree."""
    if isinstance(tree, Pending):
        tree = object.__getattribute__(tree, "_value")
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


def read_on(lane: Lane, tree) -> None:
    """Record every card tensor of ``tree`` as read on ``lane``'s stream."""
    if lane.stream is None:
        return
    for t in tensors(tree):
        if t.is_cuda:
            t.record_stream(lane.stream)


# ------------------------------------------------------------------ a mesh's lanes


@dataclasses.dataclass
class LaneSet:
    """A mesh's lanes on one device: a compute and an exchange lane a
    local rank."""

    compute: Dict[int, Lane]
    exchange: Dict[int, Lane]

    def all(self) -> List[Lane]:
        return list(self.compute.values()) + list(self.exchange.values())


# Lane sets by (mesh, device); a mesh's lanes are made once.
_SETS: Dict[tuple, LaneSet] = {}


def lanes_for(mesh) -> LaneSet:
    """The compute and exchange lanes of ``mesh``'s local ranks (each on its
    rank's device), made at the first call and kept."""
    key = (mesh, tuple(str(d) for d in mesh.devices))
    lanes = _SETS.get(key)
    if lanes is None:
        def lane(r, role):
            dev = torch.device(mesh.devices[r])
            return Lane(r, role, dev, make_stream(dev) if dev.type == "cuda" else None)

        lanes = _SETS[key] = LaneSet(compute={r: lane(r, "compute") for r in mesh.local_ranks},
                                     exchange={r: lane(r, "exchange")
                                               for r in mesh.local_ranks})
    return lanes


# ------------------------------------------------------------------ a running step


class Step:
    """The lanes of one running step: which lane each local rank's work
    goes to for the op being run, the shifts numbered so far, and the
    lanes to join at the end."""

    def __init__(self, lanes: LaneSet):
        self.lanes = lanes
        self.active: Dict[int, Lane] = dict(lanes.compute)
        self.op: Optional[str] = None
        self.shifts: List[Tuple[str, int]] = []
        self.callers: Dict[str, Lane] = {}
        self.forked: set = set()
        for lane in lanes.all():
            lane.reset()
        for r, lane in lanes.compute.items():
            lane.wait(self._caller(lane.device))

    def _caller(self, device: torch.device) -> Lane:
        """The caller's current stream on ``device``, as a lane."""
        key = str(device)
        if key not in self.callers:
            stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
            self.callers[key] = Lane(None, "caller", device, stream)
        return self.callers[key]

    def use(self, role: str, states: Optional[Sequence[Any]] = None) -> None:
        """Send each local rank's work to its ``role`` lane for the next op.
        An exchange lane first waits on its rank's compute lane, and reads
        the rank's state (``states``, in local-rank order) from it."""
        for j, r in enumerate(self.lanes.compute):
            lane = getattr(self.lanes, role)[r]
            if role == "exchange":
                lane.wait(self.lanes.compute[r])
                self.forked.add(r)
                if states is not None:
                    read_on(lane, states[j])
            self.active[r] = lane

    def join(self) -> None:
        """Order the caller's streams after every lane this step used."""
        for r, lane in self.lanes.compute.items():
            self._caller(lane.device).wait(lane)
            if r in self.forked:
                self._caller(lane.device).wait(self.lanes.exchange[r])

    def refork(self) -> None:
        """Fork every lane this step used from the caller's streams again,
        after a cut (:func:`rejoined`): the events of before are dropped (a
        captured event serves its own graph only), the records kept."""
        for lane in self.lanes.all():
            lane._event, lane._seen = None, {}
        self.callers = {}
        for r, lane in self.lanes.compute.items():
            lane.wait(self._caller(lane.device))
            if r in self.forked:
                self.lanes.exchange[r].wait(self._caller(lane.device))


_step: Optional[Step] = None


@contextlib.contextmanager
def running(mesh) -> Iterator[Step]:
    """Run one step of ``mesh``'s local ranks in their lanes: every compute
    lane forks from the caller's current stream on entry, every lane used
    joins back into it on exit (also when the step raises)."""
    global _step
    if _step is not None:
        raise RuntimeError("a distributed step is already running in its lanes")
    step = Step(lanes_for(mesh))
    _step = step
    try:
        yield step
    except BaseException:
        # A failed capture leaves no stream to record an event on: the
        # step's own error is the one to see.
        _step = None
        with contextlib.suppress(Exception):
            step.join()
        raise
    _step = None
    step.join()
    for o in _observers:
        o.shifts.extend(step.shifts)


def rejoined(between: Callable[[], None]) -> None:
    """Cut the running step: join every lane it used into the caller's
    streams, call ``between()`` (the end of one captured segment and the
    begin of the next, ``core/runner.py``), and fork the lanes again, so
    that each segment holds its own branches a lane.  Outside a step only
    ``between()`` runs."""
    step = _step
    if step is None:
        between()
        return
    step.join()
    between()
    step.refork()


def entered(rank: int):
    """Run the body's work in ``rank``'s lane of the running step (nothing
    outside a step)."""
    if _step is None or rank not in _step.active:
        return contextlib.nullcontext()
    return _step.active[rank].entered()


def shift(moves: Sequence[Tuple[int, int]]) -> None:
    """A collective shift of the running step, ``(sender, receiver)`` a
    value: each local receiver's lane waits on its local sender's and takes
    its record and this shift's ``(op, n)``.  A sender of another process
    adds only the shift (its lanes are that process's)."""
    step = _step
    if step is None:
        return
    tag = (step.op, len(step.shifts))
    step.shifts.append(tag)
    before = {r: lane.record for r, lane in step.active.items()}
    for src, dst in moves:
        recv = step.active.get(dst)
        if recv is None:
            continue
        send = step.active.get(src)
        if send is not None:
            recv.wait(send, before[src])
        recv.record = recv.record | {tag}


def received(tree, rank: int) -> None:
    """``tree``, shifted to local ``rank``, is read on its lane."""
    if _step is not None and rank in _step.active:
        read_on(_step.active[rank], tree)


# ------------------------------------------------------------------ products


_OPERATORS = ("add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
              "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow", "and", "rand", "or",
              "ror", "xor", "rxor", "lt", "le", "gt", "ge", "eq", "ne", "neg", "pos",
              "invert", "abs", "bool", "int", "float", "index", "len", "iter", "getitem",
              "contains", "matmul", "rmatmul")


class Pending:
    """A value another lane produced: its first use from a lane (other
    than the producer) makes that lane wait on the producer and read the
    value's tensors there.  Attributes, items, iteration, operators and
    torch functions all go to the value."""

    __slots__ = ("_value", "_lane", "_readers")

    def __init__(self, value, lane: Lane):
        object.__setattr__(self, "_value", value)
        object.__setattr__(self, "_lane", lane)
        object.__setattr__(self, "_readers", set())

    def _get(self):
        reader = current()
        lane = object.__getattribute__(self, "_lane")
        value = object.__getattribute__(self, "_value")
        readers = object.__getattribute__(self, "_readers")
        if reader is not None and reader is not lane and id(reader) not in readers:
            readers.add(id(reader))
            reader.wait(lane)
            read_on(reader, value)
        return value

    def __getattr__(self, name):
        return getattr(self._get(), name)

    def __setattr__(self, name, value):
        setattr(self._get(), name, value)

    def __repr__(self) -> str:
        return f"Pending({object.__getattribute__(self, '_value')!r})"

    __hash__ = object.__hash__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*resolve(args), **resolve(kwargs or {}))


_UNARY = {"neg": operator.neg, "pos": operator.pos, "invert": operator.invert,
          "abs": abs, "bool": bool, "int": int, "float": float, "index": operator.index,
          "len": len, "iter": iter}


def _forward(name):
    if name in _UNARY:
        fn = _UNARY[name]
        return lambda self: fn(self._get())
    if name.startswith("r") and hasattr(operator, f"__{name[1:]}__"):
        op = getattr(operator, f"__{name[1:]}__")
        return lambda self, other: op(resolve(other), self._get())
    op = getattr(operator, f"__{name}__")
    return lambda self, other: op(self._get(), resolve(other))


for _name in _OPERATORS:
    setattr(Pending, f"__{_name}__", _forward(_name))


def resolve(tree):
    """``tree`` with every :class:`Pending` replaced by its value (joined
    into the current lane)."""
    if isinstance(tree, Pending):
        return tree._get()
    if isinstance(tree, (list, tuple)):
        return type(tree)(resolve(v) for v in tree)
    if isinstance(tree, dict):
        return {k: resolve(v) for k, v in tree.items()}
    return tree


def product(value):
    """``value`` as the current lane hands it to later ops: from an
    exchange lane a :class:`Pending` (its readers join the lane at first
    use), from a compute lane or outside every lane the value itself."""
    lane = current()
    if lane is None or lane.role != "exchange":
        return value
    return Pending(value, lane)


def settled(state):
    """A dataclass ``state`` with every field that is a :class:`Pending`
    replaced by its value, once its lane has joined the caller's stream."""
    done = {f.name: object.__getattribute__(v, "_value")
            for f in dataclasses.fields(state)
            if isinstance(v := getattr(state, f.name), Pending)}
    return dataclasses.replace(state, **done) if done else state


# ------------------------------------------------------------------ observing


@dataclasses.dataclass
class Seen:
    """What :func:`observe` saw: every shift of the steps run, as
    ``(op, n)``, and every force pass issued, as ``(rank, op, record of
    the issuing lane)``."""

    shifts: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    passes: List[Tuple[int, str, frozenset]] = dataclasses.field(default_factory=list)


_observers: List[Seen] = []


@contextlib.contextmanager
def observe() -> Iterator[Seen]:
    """Within the context, the shifts and force passes of the steps run."""
    seen = Seen()
    _observers.append(seen)
    try:
        yield seen
    finally:
        _observers.remove(seen)


@contextlib.contextmanager
def withheld() -> Iterator[Seen]:
    """Within the context the observers see nothing; what they would have
    seen goes to the :class:`Seen` yielded (a step being captured: its
    replays report its shifts)."""
    saved, seen = list(_observers), Seen()
    _observers[:] = [seen]
    try:
        yield seen
    finally:
        _observers[:] = saved


def force_pass_issued() -> None:
    """A force pass has taken its inputs on the current lane: note the
    lane's record under the running op (``schedule.force_pass``)."""
    lane = current()
    if not _observers or _step is None or lane is None or lane.rank is None:
        return
    for o in _observers:
        o.passes.append((lane.rank, _step.op, lane.record))
