"""What the per-layer metrics read from the program's own spans and op maps
(``repro_torch.core.spans``): device seconds a traced step by group of
scheduler ops, and the device's idle time matched to the host's spans.

The program emits, under the profiler, a marker kernel before each replay
of a captured step and after the last replay of a chunk, and logs the op
map of each replayed graph (its nodes by segment) and each closing marker
(``spans.LOG``, the latest profiled stretch's).  The attribution is done
here (:func:`op_device_seconds`), so that the program cannot change how its
own yardstick is computed.  A program without those spans (an older
checkout) gives nothing here, and its readers return None.
"""

from __future__ import annotations

import collections

from abm_bench.harness import trace as _trace

# The segments of a replayed step (:func:`op_device_seconds`) behind each
# ``<group>_op_ms`` metric; ``record`` takes the observables and the rows and
# commit a step writes, ``other`` every other segment (``op.fold_rng``,
# ``op.age``, a configuration's own ops).
GROUPS = {
    "grid": ("op.sort", "op.env_build"),
    "behaviors": ("op.behaviors",),
    "mechanics": ("op.forces", "op.boundary", "op.static_flags"),
    "diffusion": ("op.diffusion",),
    "health": ("op.health",),
    "outside_graph": ("outside_graph",),
}

RUN_SPANS = ("facade.run_jit", "batch.run_jit")


def group_of(segment: str) -> str:
    for group, names in GROUPS.items():
        if segment in names:
            return group
    if segment == "record" or segment.startswith("observe."):
        return "record"
    return "other"


def op_device_seconds(device_events, log, marker: str, close, eager):
    """Device seconds by segment of the replays that ``log`` holds (an op
    map, ``((segment, nodes), ...)``, a replay; ``close`` a chunk's closing
    marker; ``eager`` an eager step), and ``outside_graph`` for every other
    device event; the markers' own go nowhere.  ``device_events`` are
    ``(name, start µs, end µs)``, sorted here by start.  Each log entry but
    ``eager`` has one marker, in order; the events between a replay's marker
    and the next one are its op map's nodes, in order, and must be exactly
    as many: one that the profiler lost, or a graph node named as the
    marker, makes the count differ.  None where the attribution cannot be
    trusted: such a count, a replay with no marker after it, an empty log,
    an eager step or a graph without op map in the log, or markers and log
    entries that differ in number."""
    entries = list(log)
    if not entries or any(e is None or e == eager for e in entries):
        return None
    events = sorted(device_events, key=lambda e: (e[1], e[2]))
    marks = [i for i, e in enumerate(events) if marker in e[0]]
    if len(marks) != len(entries):
        return None
    secs = lambda evs: sum(e[2] - e[1] for e in evs) / 1e6
    out = collections.defaultdict(float)
    out["outside_graph"] = secs(events[:marks[0]] if marks else events)
    for j, (m, entry) in enumerate(zip(marks, entries)):
        end = marks[j + 1] if j + 1 < len(marks) else len(events)
        if entry == close:
            out["outside_graph"] += secs(events[m + 1:end])
            continue
        if j + 1 == len(marks) or end - m - 1 != sum(n for _, n in entry):
            return None
        k = m + 1
        for name, n in entry:
            out[name] += secs(events[k:k + n])
            k += n
    return dict(out)


def op_seconds(tr):
    """Device seconds of the traced stretch by segment (read once, from the
    program's log of the replays under the profiler), or None."""
    if tr is None:
        return None
    if "_op_seconds" not in tr.__dict__:
        try:
            from repro_torch.core.spans import CLOSE, EAGER, LOG, MARKER
            log = (LOG, MARKER, CLOSE, EAGER)
        except ImportError:
            log = None
        tr._op_seconds = (op_device_seconds(tr.device, *log)
                          if log is not None and tr.device else None)
    return tr._op_seconds


def group_ms(ctx, group: str):
    """Device milliseconds a traced step of the segments of ``group``."""
    tr = ctx.trace
    secs = op_seconds(tr)
    if secs is None or not tr.steps:
        return None
    return 1e3 * sum(v for k, v in secs.items() if group_of(k) == group) / tr.steps


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(tr, names, inside: bool):
    """The share of the traced wall with the device idle while the host is
    inside (or outside every one) of the spans named ``names``; outside
    counts from the stretch's first event to its last."""
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    spans = _trace.merged((s, e) for n, s, e in tr.host if n in names)
    if not spans:
        return None
    if inside:
        region = spans
    else:
        every = tr.host + tr.device
        lo, hi = min(s for _, s, _ in every), max(e for _, _, e in every)
        cuts = [lo] + [x for s, e in spans for x in (s, e)] + [hi]
        region = [[a, b] for a, b in zip(cuts[::2], cuts[1::2]) if b > a]
    busy = _trace.merged((s, e) for _, s, e in tr.device)
    idle = sum(b - a for a, b in region) - _overlap(region, busy)
    return 100.0 * idle / (tr.window_s * 1e6)
