"""Helpers the per-layer metric readers share."""

from __future__ import annotations

from typing import Optional, Tuple

from . import tracefile


def delta_mean(scrapes: Tuple[dict, dict], family: str) -> Optional[float]:
    """The mean of a histogram or summary ``family`` over the window:
    the change of its ``_sum`` over the change of its ``_count``, from
    the node's ``/metrics`` read as the window opened and closed."""
    before, after = scrapes

    def pick(sample, suffix):
        keys = [k for k in sample if k.split("{")[0] == family + suffix]
        return sum(sample[k] for k in keys) if keys else None

    s0, s1 = pick(before, "_sum") or 0.0, pick(after, "_sum")
    c0, c1 = pick(before, "_count") or 0.0, pick(after, "_count")
    if s1 is None or c1 is None or c1 - c0 <= 0:
        return None
    return (s1 - s0) / (c1 - c0)


def kernels(obs, proc: str, needle: str):
    """The device events of ``proc``'s capture whose name holds
    ``needle`` and that lie wholly in the traced span."""
    if obs.prof is None or proc not in obs.traces:
        return []
    a, b = obs.prof
    return [e for e in tracefile.device(obs.traces[proc])
            if needle in e.name and e.start >= a and e.end <= b]


def delta_quantile(scrapes: Tuple[dict, dict], family: str,
                   q: float) -> Optional[float]:
    """The ``q`` quantile of a histogram over the window, from its
    buckets' change between the two reads of ``/metrics``, interpolated
    linearly inside the bucket that holds it."""
    before, after = scrapes
    prefix = family + '_bucket{le="'
    bounds = []
    for key, value in after.items():
        if key.startswith(prefix):
            le = key[len(prefix):-2]
            upper = float("inf") if le == "+Inf" else float(le)
            bounds.append((upper, value - before.get(key, 0.0)))
    bounds.sort()
    if not bounds or bounds[-1][1] <= 0:
        return None
    want = q * bounds[-1][1]
    lower, below = 0.0, 0.0
    for upper, cum in bounds:
        if cum >= want:
            if upper == float("inf"):
                return lower
            inside = cum - below
            return lower + (upper - lower) * ((want - below) / inside if inside else 1.0)
        lower, below = upper, cum
    return None
