"""The device trace of a part of the window, and what is read from it.

``torch.profiler`` (CUPTI) records every kernel, copy and memset on the
card, also those a CUDA graph replays, with the host's operations beside
them.  The busy time is the union of the device intervals, a frozen copy of
``scripts/profile_torch_slice.py``'s ``busy_us`` (lines 65-75 there).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch


def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    """A traced stretch of the window: device and host events (name, start
    µs, end µs), its wall time on the host clock, the steps and kernel
    launches in it, and for every traced step the work view of its input,
    one a session (``counts.work_view``; ``Loop.count_traced`` fills it
    after the window)."""

    device: list
    host: list
    window_s: float
    steps: int
    launches: dict
    states: list

    @property
    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e in self.device) / 1e6

    def seconds(self, names) -> float:
        """Device seconds of the events whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names)) / 1e6

    def idle_gaps(self) -> list:
        """``(host op beside it, seconds)`` of each gap between device work."""
        busy = merged((s, e) for _, s, e in self.device)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for (_, a), (b, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, a) - 1
            name = "no host op"
            for j in range(i, max(i - 64, -1), -1):
                if host[j][2] >= a:
                    name = host[j][0]
                    break
            out.append((name, (b - a) / 1e6))
        return out

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for n, s, e in self.device:
            ops[n[:120]] += (e - s) / 1e6
        gaps = collections.Counter()
        for n, sec in self.idle_gaps():
            gaps[n[:120]] += sec
        return {"device_ops": [[n, v] for n, v in ops.most_common(10)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


def traced(fn, steps_of, launches_of):
    """Run ``fn()`` under the profiler; ``steps_of()`` and ``launches_of()``
    are read before and after it.  Returns ``(fn's result, Trace)`` with
    ``states`` left for the caller."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    steps0, launches0 = steps_of(), launches_of()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    launches1 = launches_of()
    tr = Trace(device=[], host=[], window_s=wall, steps=steps_of() - steps0,
               launches={k: launches1[k] - launches0.get(k, 0) for k in launches1}, states=[])
    tr.profile = prof
    return out, tr


def parse(tr: Trace) -> Trace:
    """Read the profiler's events into ``tr`` (after the window: reading
    them takes seconds)."""
    for e in tr.profile.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tr.device.append(item)
        else:
            tr.host.append(item)
    tr.profile = None
    return tr
