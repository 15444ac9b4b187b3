"""Opt-in kernel profiling: ``torch.profiler`` capture + work counts.

The port's copy of the JAX package's ``profiling`` package.  Two
capabilities, both off unless asked for (``UPOW_PROFILE_*`` /
``ProfilingConfig``), both safe to call when the profiler fails —
profiling must never take the node down:

* :func:`start` / :func:`stop` / :func:`status` — one process-wide
  ``torch.profiler.profile`` session (CPU activities, and CUDA ones
  where a card is visible; with ``spans``, the CPU events of every
  thread and the program's spans as user annotations), driven by the
  ``/debug/profile?action=start|stop|status`` endpoint.  :func:`stop`
  writes a Chrome trace (``<trace_dir>/upow-<pid>-<n>.pt.trace.json``):
  CUPTI's kernel activity is process-wide, so the kernels launched from
  the device runtime's drainer thread are in it under their own names.
  One capture at a time; a capture left running past
  ``max_capture_seconds`` is auto-closed on the next touch.  The
  profiler is started and stopped on one owner thread whatever thread
  calls (the node calls from executor threads); Kineto, the profiler's
  library, must first be initialised on the thread that imported torch
  (:func:`prime`, which the node calls when ``profile.enabled``).
* :func:`analyze_cost` — the port's own count of a kernel's work (the
  figures PERF.md's bounds divide: ``crypto.p256.mul_ops_needed`` and
  ``bytes_needed``, the sha256 kernels' integer operations), recorded
  through :func:`telemetry.device.record_cost` and exported as
  ``kernel_<k>_cost_<key>`` gauges.  The JAX package records XLA's
  ``compiled.cost_analysis()`` there.  The kernels' wrappers call it
  while :data:`COST_ANALYSIS` is on (``profile.cost_analysis``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..logger import get_logger
from ..telemetry import device as _device
from ..telemetry import event as _event
from ..telemetry import tracing as _tracing

log = get_logger("profiling")

#: record each kernel batch's work counts (``profile.cost_analysis``)
COST_ANALYSIS = False

_lock = threading.Lock()
_session: dict = {}  # {trace_dir, started_at, max_seconds, prof} while active
_owner: Optional[ThreadPoolExecutor] = None
_seq = itertools.count(1)


def _on_owner(fn, *args):
    """Run ``fn`` on the profiler's one owner thread and wait for it."""
    global _owner
    if _owner is None:
        _owner = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="upow-profiler")
    return _owner.submit(fn, *args).result()


def _activities() -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    # DR001: the profiler is a dev tool outside the runtime's hot path;
    # it asks only whether there is CUDA activity to trace
    if torch.cuda.is_available():  # upowlint: disable=DR001
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def prime() -> None:
    """Initialise the profiler on the calling thread with an empty
    capture: Kineto refuses a first start from another thread than the
    one that registered it (the thread that imported torch)."""
    import torch

    with torch.profiler.profile(activities=_activities()):
        pass


def _all_threads():
    """The profiler's setting that records every thread's CPU events (by
    default only the thread that started it, here the owner thread)."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def open_session(spans: bool = False):
    """Start a ``torch.profiler.profile`` (CPU, and CUDA where a card is
    visible) on the owner thread; returns it.  With ``spans`` it records
    every thread's CPU events, and while it runs ``telemetry.span`` also
    opens a ``record_function`` of its name (``tracing.ANNOTATE``), so
    the program's spans lie beside the kernels on the capture's clock.
    The miner's endpoint asks for that; the node's ``/debug/profile``
    does not, which keeps its capture light on a node serving
    requests."""
    def _open():
        import torch

        extra = {"experimental_config": _all_threads()} if spans else {}
        prof = torch.profiler.profile(activities=_activities(), **extra)
        prof.__enter__()
        return prof

    prof = _on_owner(_open)
    _tracing.ANNOTATE = spans
    return prof


def close_session(prof, trace_dir: str) -> str:
    """Stop ``prof`` on the owner thread and write its Chrome trace into
    ``trace_dir``; returns the file's path."""
    _tracing.ANNOTATE = False

    def _close():
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "upow-%d-%d.pt.trace.json"
                            % (os.getpid(), next(_seq)))
        prof.export_chrome_trace(path)
        return path

    return _on_owner(_close)


def _expire_locked(now: float) -> None:
    """Close an over-deadline capture (caller holds ``_lock``)."""
    if not _session:
        return
    limit = _session.get("max_seconds") or 0
    if limit and now - _session["started_at"] > limit:
        log.warning("profiler capture exceeded %.0fs; auto-stopping", limit)
        _stop_locked(reason="max_capture_seconds")


def _stop_locked(reason: str = "requested") -> dict:
    info = {"trace_dir": _session.get("trace_dir"),
            "seconds": round(time.monotonic()
                             - _session.get("started_at", 0.0), 3),
            "reason": reason}
    try:
        info["trace_file"] = close_session(_session["prof"],
                                           _session["trace_dir"])
    except Exception as e:  # teardown must not propagate to the endpoint
        log.warning("torch profiler stop failed: %s", e)
        info["error"] = f"{type(e).__name__}: {e}"[:200]
    _session.clear()
    _event("profile_capture_stopped", **info)
    return info


def start(trace_dir: str, max_seconds: float = 0.0,
          spans: bool = False) -> dict:
    """Begin a capture into ``trace_dir`` (``spans``: see
    :func:`open_session`).  Returns a status dict; on failure
    ``{"error": ...}`` rather than raising."""
    with _lock:
        _expire_locked(time.monotonic())
        if _session:
            return {"error": "capture already active",
                    "trace_dir": _session["trace_dir"]}
        try:
            prof = open_session(spans)
        except Exception as e:
            log.warning("torch profiler start failed: %s", e)
            return {"error": f"{type(e).__name__}: {e}"[:200]}
        _session.update(trace_dir=trace_dir, prof=prof,
                        started_at=time.monotonic(),
                        max_seconds=max_seconds)
        _event("profile_capture_started", trace_dir=trace_dir)
        return {"active": True, "trace_dir": trace_dir}


def stop() -> dict:
    """End the active capture; {"error": ...} when none is running."""
    with _lock:
        if not _session:
            return {"error": "no capture active"}
        return _stop_locked()


def status() -> dict:
    with _lock:
        _expire_locked(time.monotonic())
        if not _session:
            return {"active": False}
        return {"active": True, "trace_dir": _session["trace_dir"],
                "seconds": round(time.monotonic()
                                 - _session["started_at"], 3)}


def reset() -> None:
    """Forget any active session without stopping it (tests)."""
    with _lock:
        _session.clear()


def analyze_cost(kernel: str, fn, *args, **kwargs) -> Optional[dict]:
    """Record ``fn(*args, **kwargs)`` — a dict of the port's counts of
    one batch of ``kernel``'s work — via
    :func:`telemetry.device.record_cost`, and return its numeric
    entries; any failure returns None (counts are observability, never
    correctness)."""
    try:
        analysis = fn(*args, **kwargs)
        clean = {k: float(v) for k, v in analysis.items()
                 if isinstance(v, (int, float))
                 and not isinstance(v, bool)}
        if not clean:
            return None
        _device.record_cost(kernel, clean)
        return clean
    except Exception as e:
        log.debug("cost analysis for %s failed: %s", kernel, e)
        return None
