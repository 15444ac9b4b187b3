"""Request-scoped trace trees over a contextvar trace context.

The port's copy of the JAX package's ``telemetry/tracing.py``, unchanged
in what it records and renders; the port adds :data:`ANNOTATE`, which
puts spans into a running ``torch.profiler`` capture.

``request_trace()`` opens a root span bound to the current async
context; every ``span()`` entered underneath (same task, or any task
spawned while the context is active — ``ensure_future`` copies
contextvars) nests into a tree.  Completed roots land in a bounded
ring buffer retaining the most recent N and the N slowest traces,
served as JSON by ``/debug/traces``.

Trace IDs are 32-hex-char strings.  Inbound HTTP requests adopt a
well-formed ``X-Upow-Trace`` header; outbound gossip RPCs attach the
current ID (see node/peers.py), so one push_tx or block propagation
can be followed across nodes.

Cross-task spans: the intake drainer processes requests submitted
from *other* tasks, so ambient context alone cannot attribute its
per-request work.  ``current_span()`` captured at submit time plus
``child_span()`` / ``add_span()`` / ``attached()`` let the drainer
record against each submitter's tree explicitly.

Every span also feeds the flat ``metrics`` aggregates, so the
pre-existing ``trace.stats()`` consumers see identical numbers.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from ..logger import get_logger
from . import metrics, scope as _scope

log = get_logger("telemetry")

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")

_current: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("upow_trace_span", default=None)

_LEVELS = {"debug": 10, "info": 20}

#: True while a ``profiling`` session that asked for the program's spans
#: runs in this process (``profiling.open_session(spans=True)``, which
#: the miner's endpoint opens): every :func:`span` and
#: :func:`request_trace` then also opens a
#: ``torch.profiler.record_function`` of its name, so the capture holds
#: the program's spans beside the kernels on the profiler's clock.  Off,
#: a span pays this check and a shared null context.
ANNOTATE = False

_NO_ANNOTATION = contextlib.nullcontext()


def annotation(name: str):
    """A ``torch.profiler.record_function`` of ``name`` while
    :data:`ANNOTATE`; a null context otherwise."""
    if not ANNOTATE:
        return _NO_ANNOTATION
    from torch.profiler import record_function

    return record_function(name)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def valid_trace_id(value: Optional[str]) -> bool:
    """True for IDs we are willing to adopt from a peer's header."""
    return bool(value) and _TRACE_ID_RE.match(value) is not None


class Span:
    """One node of a trace tree.

    ``start_ts`` is wall-clock (operator display); durations come from
    ``perf_counter``.  Children are appended at creation; a per-root
    span budget (``max_spans``) stops a pathological request from
    growing its tree without bound — excess spans still feed the flat
    aggregates, they just don't attach.
    """

    __slots__ = ("name", "trace_id", "fields", "start_ts", "_t0",
                 "duration_s", "children", "root", "done", "error")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 root: Optional["Span"] = None, **fields: Any):
        self.name = name
        self.trace_id = trace_id
        self.fields = fields
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.children: List[Span] = []
        self.root = root if root is not None else self
        self.done = False
        self.error: Optional[str] = None

    def finish(self, **fields: Any) -> float:
        if fields:
            self.fields.update(fields)
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self._t0
        self.done = True
        return self.duration_s

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "name": self.name,
            "start_ts": round(self.start_ts, 6),
            "duration_ms": round((self.duration_s or 0.0) * 1000.0, 3),
        }
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.fields:
            d["fields"] = {k: _jsonable(v) for k, v in self.fields.items()}
        if self.error:
            d["error"] = self.error
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class TraceBuffer:
    """Bounded retention of completed traces: recent ring + slowest top-N.

    Also tracks the roots currently *in flight* (opened by
    ``request_trace`` but not yet recorded), so a flight recorder can
    snapshot what a node was doing at the moment of a failure."""

    _OPEN_CAP = 256

    def __init__(self, recent: int = 32, slowest: int = 16):
        self._lock = threading.Lock()
        self._open: Dict[int, Span] = {}
        self.configure(recent, slowest)

    def configure(self, recent: int, slowest: int) -> None:
        with self._lock:
            self._recent: deque = deque(maxlen=max(1, int(recent)))
            self._slowest: List[dict] = []
            self._slow_cap = max(1, int(slowest))

    def record_open(self, root: Span) -> None:
        with self._lock:
            if len(self._open) < self._OPEN_CAP:
                self._open[id(root)] = root

    def discard_open(self, root: Span) -> None:
        with self._lock:
            self._open.pop(id(root), None)

    def open_snapshot(self) -> List[dict]:
        """In-flight (not yet recorded) trace roots, oldest first."""
        with self._lock:
            roots = list(self._open.values())
        out = [r.to_dict() for r in roots if not r.done]
        out.sort(key=lambda d: d["start_ts"])
        return out

    def record(self, root: Span) -> None:
        snap = root.to_dict()
        with self._lock:
            self._open.pop(id(root), None)
            self._recent.append(snap)
            self._slowest.append(snap)
            self._slowest.sort(key=lambda t: t["duration_ms"], reverse=True)
            del self._slowest[self._slow_cap:]

    def snapshot(self) -> dict:
        with self._lock:
            return {"recent": list(self._recent),
                    "slowest": list(self._slowest)}

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slowest.clear()
            self._open.clear()


_buffer = TraceBuffer()
_max_spans = 512


def _buf() -> TraceBuffer:
    sc = _scope.current()
    return sc.traces if sc is not None else _buffer


def _span_budget() -> int:
    sc = _scope.current()
    return sc.max_trace_spans if sc is not None else _max_spans


def configure(recent: int = 32, slowest: int = 16,
              max_spans: int = 512) -> None:
    global _max_spans
    _max_spans = max(1, int(max_spans))
    _buffer.configure(recent, slowest)


def traces() -> dict:
    return _buf().snapshot()


def open_traces() -> List[dict]:
    """In-flight trace roots of the active scope (or the globals)."""
    return _buf().open_snapshot()


def current_span() -> Optional[Span]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    sp = _current.get()
    return sp.root.trace_id if sp is not None else None


def _attach(parent: Span, child: Span) -> bool:
    root = parent.root
    if root.done:
        return False  # late child of an already-recorded trace
    # per-root span budget lives in the root's field dict (kept out of
    # Span.__slots__; stripped before the tree is recorded)
    used = root.fields.get("_spans", 0)
    if used >= _span_budget():
        return False
    root.fields["_spans"] = used + 1
    parent.children.append(child)
    return True


@contextlib.contextmanager
def request_trace(name: str, trace_id: Optional[str] = None,
                  **fields: Any):
    """Open a root span; on exit record the tree into the ring buffer."""
    tid = trace_id if valid_trace_id(trace_id) else new_trace_id()
    root = Span(name, trace_id=tid, **fields)
    buf = _buf()  # pin the buffer so open/record hit the same scope
    buf.record_open(root)
    token = _current.set(root)
    try:
        with annotation(name):
            yield root
    except BaseException as e:
        root.error = type(e).__name__
        raise
    finally:
        _current.reset(token)
        root.finish()
        root.fields.pop("_spans", None)
        metrics.record_span(name, root.duration_s)
        buf.record(root)


@contextlib.contextmanager
def span(name: str, level: str = "debug", **fields: Any):
    """Time a section: flat aggregate always, tree node when traced."""
    parent = _current.get()
    node: Optional[Span] = None
    token = None
    if parent is not None and not parent.root.done:
        node = Span(name, root=parent.root, **fields)
        if _attach(parent, node):
            token = _current.set(node)
        else:
            node = None
    t0 = time.perf_counter()
    try:
        with annotation(name):
            yield node
    except BaseException as e:
        if node is not None:
            node.error = type(e).__name__
        raise
    finally:
        dt = time.perf_counter() - t0
        if token is not None:
            _current.reset(token)
        if node is not None:
            node.duration_s = dt
            node.done = True
        metrics.record_span(name, dt)
        lvl = _LEVELS.get(level, 10)
        if log.isEnabledFor(lvl):
            extra = "".join(f" {k}={v}" for k, v in fields.items())
            log.log(lvl, "%s took %.3fs%s", name, dt, extra)


def child_span(parent: Optional[Span], name: str,
               **fields: Any) -> Optional[Span]:
    """Explicitly start a span under ``parent`` (cross-task attribution).

    Returns the started Span (caller must ``finish()`` it) or None when
    there is no parent / the trace is already recorded.  The flat
    aggregate is fed by ``finish_child``.
    """
    if parent is None:
        return None
    node = Span(name, root=parent.root, **fields)
    if not _attach(parent, node):
        return None
    return node


def finish_child(node: Optional[Span], name: Optional[str] = None,
                 **fields: Any) -> None:
    if node is None:
        return
    dt = node.finish(**fields)
    metrics.record_span(name or node.name, dt)


def add_span(parent: Optional[Span], name: str, t0: float, t1: float,
             **fields: Any) -> None:
    """Attach an already-timed section (perf_counter endpoints) under
    ``parent``.  Used for work shared by many requests (one coalesced
    sig dispatch) that must appear in each requester's tree."""
    if parent is None:
        return
    node = Span(name, root=parent.root, **fields)
    node.start_ts = time.time() - (time.perf_counter() - t0)
    node.duration_s = max(0.0, t1 - t0)
    node.done = True
    _attach(parent, node)


@contextlib.contextmanager
def attached(sp: Optional[Span]):
    """Make ``sp`` the ambient span for the duration of the block.

    The intake drainer runs in its own context; entering a submitter's
    captured span here routes nested ``span()`` calls — and contextvars
    copied into tasks spawned inside (ws publish, gossip propagate) —
    to that submitter's trace.  A None span is a no-op."""
    if sp is None or sp.root.done:
        yield
        return
    token = _current.set(sp)
    try:
        yield
    finally:
        _current.reset(token)


def reset() -> None:
    _buf().reset()
