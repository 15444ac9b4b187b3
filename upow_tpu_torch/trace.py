"""Counters and durations for the block-accept path, kept in a dict.

The port's counterpart of the names the accept path calls in the JAX
package's ``trace.py`` (``span``, ``event``, ``inc``, ``observe``) and
``telemetry/device.py`` (``record_batch``, ``record_stage``).  It
records, it exports nothing: the Prometheus exposition, trace trees,
SLOs and the watchtower belong to the telemetry package, which is not
ported yet (ROADMAP.md).

    with span("block.sig_verify", n=8160):   # spans[name] -> count, seconds
        ...
    inc("verify.canary_pass")                # counters[name] += 1
    observe("kernel.p256_verify.dispatch_seconds", 0.02)
    snapshot()                               # a copy of everything above

Counters that a run should read as zero unless something went wrong:
``txid.sample_mismatch`` (a device txid batch disagreed with hashlib on
its integrity sample, ``crypto/sha256.py``) and ``sync.host_txid_retry``
(a sync page's device-seeded txids gave a merkle mismatch and the page
was hashed again on the host, ``node/app.py``).  ``snapshot_recommended``
counts syncs whose peer was further ahead than the reorg window, and
``kernel.sha256_txid.batches`` the batched-digest batches (one kernel
launch each on a card; the plain integer count of launches is
``crypto.sha256.BLOCKS_LAUNCHES``).

The resident UTXO index (``state/device_index.py``) records the JAX
package's names: ``index.probes``, ``index.probe_outpoints``,
``index.shadow_consults`` (zero on a collision-free block) and
``index.ambiguous_probes`` (:func:`record_index_probe`), the
``utxo_probe`` and ``utxo_apply`` (upload) batches, and the
``accept_probe`` stage of the fused accept scan; its kernel's launches
are ``state.device_index.PROBE_LAUNCHES``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_spans: Dict[str, Dict[str, float]] = {}
_observations: Dict[str, List[float]] = {}
_events: List[dict] = []
_MAX_SAMPLES = 4096  # per observed name and for the event list


def inc(name: str, value: float = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def observe(name: str, value: float) -> None:
    """Record one raw sample (the first 4,096 per name)."""
    with _lock:
        samples = _observations.setdefault(name, [])
        if len(samples) < _MAX_SAMPLES:
            samples.append(float(value))


def event(name: str, **fields) -> None:
    with _lock:
        if len(_events) < _MAX_SAMPLES:
            _events.append({"event": name, "t": time.time(), **fields})


@contextmanager
def span(name: str, **fields):
    """Time the block; ``fields`` name what it covered and are not
    stored."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _spans.setdefault(name, {"count": 0, "seconds": 0.0})
            s["count"] += 1
            s["seconds"] += dt


def record_batch(kernel: str, real: int, padded: int,
                 seconds: Optional[float] = None) -> None:
    """One batch dispatch of ``kernel``: ``real`` lanes of ``padded``."""
    inc("kernel.%s.batches" % kernel)
    inc("kernel.%s.lanes_real" % kernel, max(int(real), 0))
    inc("kernel.%s.lanes_padded" % kernel, max(int(padded), 1))
    if seconds is not None:
        observe("kernel.%s.dispatch_seconds" % kernel, seconds)


def record_index_probe(outpoints: int, shadow_consults: int,
                       ambiguous: int = 0) -> None:
    """One resident-index probe of ``outpoints``, ``shadow_consults`` of
    them answered by the host's shadow map."""
    inc("index.probes")
    inc("index.probe_outpoints", max(int(outpoints), 0))
    if shadow_consults:
        inc("index.shadow_consults", int(shadow_consults))
    if ambiguous:
        inc("index.ambiguous_probes", int(ambiguous))


def record_stage(stage: str, seconds: float, items: Optional[int] = None,
                 wall: Optional[float] = None) -> None:
    """One pass of a pipeline stage: busy ``seconds`` out of ``wall``."""
    observe("pipeline.%s.seconds" % stage, max(seconds, 0.0))
    if items:
        inc("pipeline.%s.items" % stage, items)
    if wall:
        observe("pipeline.%s.occupancy" % stage,
                min(max(seconds, 0.0) / wall, 1.0))


def snapshot() -> dict:
    with _lock:
        return {
            "counters": dict(_counters),
            "spans": {k: dict(v) for k, v in _spans.items()},
            "observations": {k: list(v) for k, v in _observations.items()},
            "events": list(_events),
        }


def reset() -> None:
    with _lock:
        _counters.clear()
        _spans.clear()
        _observations.clear()
        _events.clear()
