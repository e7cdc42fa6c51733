"""Reading a ``torch.profiler`` Chrome trace: device intervals, their
union, and the breakdown of where the device time and the idle time went.

A Chrome trace holds complete events (``"ph": "X"``) with a start
``ts`` and a duration ``dur`` in microseconds on one timeline for the
host and the card.  Device events are the categories in
:data:`DEVICE_CATS`; the host's are ``cpu_op`` and ``user_annotation``
(the harness's own ``record_function`` spans).
"""

from __future__ import annotations

import heapq
import json
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


class Event(NamedTuple):
    name: str
    cat: str
    ts: float     # us
    dur: float    # us

    @property
    def end(self) -> float:
        return self.ts + self.dur


def load(path: str) -> list[Event]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return parse(events)


def parse(events) -> list[Event]:
    """Complete events of the device and host categories, by start."""
    out = [Event(str(e.get("name", "")), e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0)))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + HOST_CATS]
    return sorted(out, key=lambda e: e.ts)


def device(events) -> list[Event]:
    return [e for e in events if e.cat in DEVICE_CATS]


def clip(events, lo: float, hi: float) -> list[Event]:
    """Events cut to the interval [lo, hi] (us); those outside it dropped."""
    out = []
    for e in events:
        a, b = max(e.ts, lo), min(e.end, hi)
        if b > a or (e.dur == 0 and lo <= e.ts <= hi):
            out.append(Event(e.name, e.cat, a, max(b - a, 0.0)))
    return out


def union(events) -> list[tuple[float, float]]:
    """Merged [start, end) intervals covered by ``events``."""
    merged: list[list[float]] = []
    for e in sorted(events, key=lambda e: e.ts):
        if merged and e.ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.ts, e.end])
    return [(a, b) for a, b in merged]


def busy_us(events) -> float:
    return sum(b - a for a, b in union(events))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between merged busy ``intervals``."""
    out, at = [], lo
    for a, b in intervals:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def top_device_ops(events, n: int = 10) -> list[list]:
    """[[name, seconds], ...]: device time summed by name, the largest first."""
    tot: dict[str, float] = {}
    for e in device(events):
        tot[e.name] = tot.get(e.name, 0.0) + e.dur
    return [[k, v / 1e6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(evts, times) -> list:
    """Name of the shortest event of ``evts`` covering each of the sorted
    ``times`` (None where none does): one sweep with a heap by duration,
    from which events that ended are dropped as they reach the top."""
    evts = sorted(evts, key=lambda e: e.ts)
    heap: list = []
    out, k = [], 0
    for t in times:
        while k < len(evts) and evts[k].ts <= t:
            heapq.heappush(heap, (evts[k].dur, k))
            k += 1
        while heap and evts[heap[0][1]].end <= t:
            heapq.heappop(heap)
        out.append(evts[heap[0][1]].name if heap else None)
    return out


def idle_by_host(events, lo: float, hi: float, n: int = 10) -> list[list]:
    """[[what the host was doing, seconds], ...]: the device's idle time in
    [lo, hi], each gap put under its midpoint's innermost harness span
    (``user_annotation``), else its innermost host op, else ``"none"``."""
    idle = gaps(union(device(events)), lo, hi)
    mids = [0.5 * (a + b) for a, b in idle]
    spans = _innermost([e for e in events if e.cat == "user_annotation"], mids)
    ops = _innermost([e for e in events if e.cat == "cpu_op"], mids)
    tot: dict[str, float] = {}
    for (a, b), s, o in zip(idle, spans, ops):
        name = s or o or "none"
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v / 1e6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def count(events, needle: str, cat: str = "kernel") -> int:
    return sum(1 for e in events if e.cat == cat and needle in e.name)
