"""Spans and counters inside the program, on the profiler's timeline.

A :class:`span` names a part of the program.  Tracing is on exactly while
``torch.profiler`` records (``torch._C._autograd._profiler_enabled()``);
then a span also opens a record function of that name (the profiler's
``_RecordFunctionFast``, an operator's scope: ``record_function``'s user
scope would also draw each span on the device's timeline, as if it were
device work), which puts it on the profiler's host timeline, on the clock of
the device events, so that each device gap can be matched to what the
program was doing.  Off, a span costs that one check.  Whether on or off, an error raised while a CUDA
graph is being captured becomes a :class:`CaptureError` naming the span.

The spans (their Python runs where the program's does: an op's only at an
eager step or a capture, never at a replay):

* ``facade.run_jit``: ``BuiltSimulation.run_jit``;
* ``batch.run_jit`` and ``batch.stack``: ``BatchedSimulation``;
* ``runner.read``: a device-to-host read of a compiled run (the facade's
  start step, the host count, a chunk's divergence flag);
* ``runner.replay``: one replay of a captured step;
* ``op.<name>`` (``op.fold_rng`` the key's fold), ``observe.<name>``: every
  scheduler op that runs and every observable.

**Op maps.**  While a runner captures a graph, :func:`mapping` notes at each
span boundary how many kernel, memset and memcpy nodes the graph under
capture holds (libcuda's ``cuStreamGetCaptureInfo``,
``cuGraphGetNodes`` and ``cuGraphNodeGetType``: read-only queries, allowed
during a capture).  The graph's op map is the ordered ``(segment, nodes)``
list: one entry an op that ran and an observable, and ``record`` for the
nodes outside a named span (the observables' row writes, the commit into
the static buffers).  It costs nothing at replay and leaves the graph as it
would be without it.

**Replays under the profiler.**  The runner enqueues a marker kernel
(``torch.cuda._sleep(0)``: ``spin_kernel``, built into PyTorch) before each
replay and appends the graph's op map to :data:`LOG` (:func:`mark_replay`),
and one more marker after the last replay of a chunk, logged as
:data:`CLOSE` (:func:`close_replays`), before the chunk's divergence
reduce; an eager step appends :data:`EAGER`.  So every replay's device
events lie between two markers, and a reader of the trace can hold each
replay to its op map's node count.  :data:`LOG` holds one profiled stretch:
the first entry after a run that started without the profiler
(:func:`unprofiled_run`) empties it.  Off, there is no marker and no log.
A distributed runner keeps no op map and logs nothing.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast

# The marker kernel's name (``torch.cuda._sleep``), in the device events.
MARKER = "spin_kernel"
# What an eager step logs, and the marker after a chunk's last replay.
EAGER = "eager"
CLOSE = "close"
# The op maps of the replays (and CLOSE and EAGER entries) of the latest
# profiled stretch, in order; one marker each, but EAGER.
LOG: list = []
# Set when a run starts without the profiler: the next entry empties LOG.
_stale = False

_open_map: Optional["mapping"] = None


class CaptureError(ValueError):
    """A step could not be captured in a CUDA graph; names the op, the
    observable or ``fold_rng`` that read the device."""


def _what(name: str) -> str:
    kind, _, rest = name.partition(".")
    if name == "op.fold_rng":
        return "fold_rng"
    if kind == "op":
        return f"op {rest!r}"
    if kind == "observe":
        return f"observable {rest!r}"
    return name


class span:
    """``with span(name):`` the program's part ``name``."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str):
        self.name, self._rec = name, None

    def __enter__(self):
        if _open_map is not None:
            _open_map.enter()
        if enabled():
            self._rec = _record(self.name)
            self._rec.__enter__()
        return self

    def __exit__(self, kind, err, tb):
        if self._rec is not None:
            self._rec.__exit__(kind, err, tb)
            self._rec = None
        if _open_map is not None:
            _open_map.exit(self.name)
        if (kind is not None and issubclass(kind, RuntimeError) and torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise CaptureError(
                f"{_what(self.name)} failed while the step was captured in a CUDA graph "
                f"({err}); under run_jit a step must not read the device (.item(), int(), "
                f"bool(), .tolist(), nonzero) or copy host values to it") from err
        return False


# ---------------------------------------------------------------------------
# Op maps
# ---------------------------------------------------------------------------


class mapping:
    """``with mapping(count) as m:`` the op map of what runs inside, by the
    node counts ``count()`` gives (:class:`GraphNodes` during a capture):
    ``m.entries``, the ``(segment, nodes)`` pairs.  At each outermost span
    boundary the nodes gained since the last one go to the span that closes,
    or to ``record`` where none was open.  ``entries`` is None once a count
    gives None."""

    def __init__(self, count: Callable[[], Optional[int]]):
        self.count, self.depth = count, 0
        self.last = self.entries = None

    def __enter__(self) -> "mapping":
        global _open_map
        self.last = self.count()
        self.entries = None if self.last is None else []
        _open_map = self
        return self

    def __exit__(self, kind, err, tb):
        global _open_map
        _open_map = None
        if kind is None:
            self._close("record")
        return False

    def _close(self, name: str) -> None:
        if self.entries is None:
            return
        now = self.count()
        if now is None:
            self.entries = None
            return
        n, self.last = now - self.last, now
        if name == "record":
            if not n:
                return
            if self.entries and self.entries[-1][0] == "record":
                self.entries[-1] = ("record", self.entries[-1][1] + n)
                return
        self.entries.append((name, n))

    def enter(self) -> None:
        if self.depth == 0:
            self._close("record")
        self.depth += 1

    def exit(self, name: str) -> None:
        self.depth -= 1
        if self.depth == 0:
            self._close(name)


_CU_GRAPH_NODE_KINDS = (0, 1, 2)  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
_CU_STREAM_CAPTURE_STATUS_ACTIVE = 1
_libcuda_cache: list = []


def _libcuda():
    """``libcuda`` with the queries the op map needs declared; None where it
    cannot be loaded."""
    if not _libcuda_cache:
        ptr, int_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            lib.cuStreamGetCaptureInfo_v2.argtypes = [
                ptr, int_p, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ptr),
                ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_size_t)]
            lib.cuGraphGetNodes.argtypes = [ptr, ptr, ctypes.POINTER(ctypes.c_size_t)]
            lib.cuGraphNodeGetType.argtypes = [ptr, int_p]
            for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
                       lib.cuGraphNodeGetType):
                fn.restype = ctypes.c_int
        except (OSError, AttributeError):
            lib = None
        _libcuda_cache.append(lib)
    return _libcuda_cache[0]


def _capture_graph(lib, stream: int) -> Optional[int]:
    """The graph that ``stream`` is capturing into, or None."""
    status, ident = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    err = lib.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), ctypes.byref(ident),
                                        ctypes.byref(graph), ctypes.byref(deps),
                                        ctypes.byref(ndeps))
    if err or status.value != _CU_STREAM_CAPTURE_STATUS_ACTIVE or not graph.value:
        return None
    return graph.value


class GraphNodes:
    """``count()``: the kernel, memset and memcpy nodes of the graph that the
    current CUDA stream is capturing into (each node's type read once), or
    None where libcuda cannot tell."""

    def __init__(self):
        self.lib = _libcuda()
        self.kinds: dict = {}

    def __call__(self) -> Optional[int]:
        lib = self.lib
        if lib is None:
            return None
        graph = _capture_graph(lib, torch.cuda.current_stream().cuda_stream)
        if graph is None:
            return None
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            return None
        nodes = (ctypes.c_void_p * n.value)()
        if n.value and lib.cuGraphGetNodes(graph, ctypes.cast(nodes, ctypes.c_void_p),
                                           ctypes.byref(n)):
            return None
        kind, total = ctypes.c_int(), 0
        for node in nodes[:n.value]:
            counted = self.kinds.get(node)
            if counted is None:
                if lib.cuGraphNodeGetType(node, ctypes.byref(kind)):
                    return None
                counted = self.kinds[node] = kind.value in _CU_GRAPH_NODE_KINDS
            total += counted
        return total


# ---------------------------------------------------------------------------
# Replays under the profiler
# ---------------------------------------------------------------------------


def _log(entry) -> None:
    global _stale
    if _stale:
        LOG.clear()
        _stale = False
    LOG.append(entry)


def mark_replay(op_map) -> None:
    """Before a replay under the profiler: the marker kernel on the current
    stream, and the graph's op map (None where it has none) in the log."""
    torch.cuda._sleep(0)
    _log(op_map)


def close_replays() -> None:
    """After the last replay of a chunk under the profiler: the marker kernel
    on the current stream, and :data:`CLOSE` in the log."""
    torch.cuda._sleep(0)
    _log(CLOSE)


def log_eager() -> None:
    """An eager step of a graph-replaying runner under the profiler."""
    _log(EAGER)


def unprofiled_run() -> None:
    """A run starts without the profiler: the next entry starts :data:`LOG`
    anew, so that it holds the replays of one profiled stretch."""
    global _stale
    _stale = True
