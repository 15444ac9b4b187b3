"""Reading ``torch.profiler`` Chrome traces on one clock.

Kineto writes each event's ``ts`` in microseconds from the trace's
``baseTimeNanoseconds``, an epoch time, so traces of several processes
on one host merge on the wall clock.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    start: float   # epoch seconds
    end: float
    name: str
    cat: str


def load(path: Path) -> List[Event]:
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1000.0
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = (float(e["ts"]) + base_us) / 1e6
        out.append(Event(start, start + float(e["dur"]) / 1e6,
                         str(e.get("name", "")), str(e.get("cat", ""))))
    return out


def device(events: Iterable[Event]) -> List[Event]:
    return [e for e in events if e.cat in DEVICE_CATS]


def clip(events: Iterable[Event], a: float, b: float) -> List[Event]:
    return [Event(max(e.start, a), min(e.end, b), e.name, e.cat)
            for e in events if e.end > a and e.start < b]


def union(events: Iterable[Event]) -> List[Tuple[float, float]]:
    spans = sorted((e.start, e.end) for e in events)
    out: List[Tuple[float, float]] = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_seconds(events: Iterable[Event], a: float, b: float) -> float:
    return sum(t - s for s, t in union(clip(events, a, b)))


def gaps(events: Iterable[Event], a: float, b: float) -> List[Tuple[float, float]]:
    """The idle spans of [a, b] between the events' union."""
    out, cursor = [], a
    for s, t in union(clip(events, a, b)):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, t)
    if cursor < b:
        out.append((cursor, b))
    return out


def by_name(events: Iterable[Event]) -> Dict[str, float]:
    totals: Dict[str, float] = {}
    for e in events:
        totals[e.name] = totals.get(e.name, 0.0) + (e.end - e.start)
    return totals


def breakdown(dev: List[Event], marks: List[Tuple[float, str]], a: float,
              b: float, top: int = 10) -> dict:
    """The device ops that took most time in [a, b], and the longest idle
    gaps, each named by what the processes' hosts marked in it (a
    template refresh, a page fetched, a block committed), as
    (wall-clock time, what) pairs."""
    ops = sorted(by_name(clip(dev, a, b)).items(), key=lambda kv: -kv[1])
    idle = sorted(gaps(dev, a, b), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, t in idle:
        seen = sorted({what for at, what in marks if s - 0.005 <= at <= t + 0.005})
        named.append(["; ".join(seen) or "no host mark in the gap", t - s])
    return {"device_ops": [[n, v] for n, v in ops[:top]], "idle_gaps": named}


