"""Per-process device runtime: one owner for each device the port runs on.

The port of the JAX package's ``device/runtime.py``.  Every device
dispatch of the port's node, miner and index goes through a runtime's
single drainer thread:

* **One arm.**  The drainer arms its device once, before it serves its
  first item.  On a card it makes the card current on the drainer
  thread, builds every kernel library with nvcc in parallel
  (``_build.py``), loads each, and warms the production set with one
  launch each under the arm's deadline (``p256_verify`` at the
  configured kernel and window, ``sha256_search``, ``sha256_blocks``,
  ``utxo_probe``, and ``sha256_search_mesh`` where two or more cards
  exist), checking each warm result.  ``device="cpu"``, which is
  explicit, arms as the CPU with nothing to build.
* **One queue, many sources.**  Subsystems submit typed items:
  signature batches (:meth:`DeviceRuntime.submit_sig_checks`), boxed
  calls (:meth:`DeviceRuntime.run_boxed`) and dispatch closures
  (:meth:`DeviceRuntime.submit_call`), each tagged with a *source*
  (``block``, ``mempool``, ``verify``, ``mine``, ``index``, ``bench``,
  ...).  Per-source FIFO queues are drained by weighted fair share
  (stride: a served item charges ``cost / weight`` to its source's
  virtual pass), so a saturating miner cannot starve block verify past
  a bounded wait.
* **Cross-source coalescing.**  When a signature batch is served, every
  queued batch with the same dispatch key, from any source, rides in the
  same ``txverify.run_sig_checks`` call.  The verdicts are those of the
  serial path: the runtime changes who shares a dispatch, never what is
  computed.
* **One choke point.**  The degrade state (``resilience/degrade.py``) is
  read when an item executes, not when it is queued.  The
  ``device.runtime`` fault site fires before every dispatch; an injected
  fault on a signature group records a degrade failure and fails the
  group on a card (on the CPU the native host batch serves it).

Where the JAX runtime differs, by design:

* **A failed arm raises.**  The JAX runtime arms without a backend and
  serves every source on the CPU when its probe fails.  Here a failed
  build, load or warm launch on a card raises :class:`ArmError` out of
  :meth:`DeviceRuntime.arm`, and every pending and later item fails with
  it; ``arm_failure_reason`` keeps the reason for the miner's watchdog,
  and an ``arm_failed`` event (one of the kinds the watchtower's
  arm-flap rule counts) follows the ``device_runtime_armed`` one.
* **A kept box thread.**  A boxed call (a device verify, under its
  deadline) runs on one daemon thread the runtime keeps from call to
  call, where the JAX runtime starts a thread a call; a call past its
  deadline abandons that thread and the next one starts afresh.
* **One runtime per device.**  :func:`get_runtime` keeps one runtime for
  each card (``cuda:<index>``; None is ``cuda:0``) and one for the CPU,
  since the port's entry points name their device.
* **No PJRT.**  The JAX runtime's environment scrub of a plugin's
  variables (``_SCRUB_PREFIXES``), its backend-cache reset
  (``_clear_jax_backends``) and its persistent compile cache have no
  counterpart: nvcc's libraries are rebuilt only when their sources
  change.
* **A span a dispatch.**  Each drained item adds a ``runtime.dispatch``
  span (its source, kernel, the group's size and its queue wait) to the
  trace of the request that submitted it, a span the JAX runtime does
  not record: it splits a request's wall into queueing and the card.

Telemetry (``telemetry/device.py``), under the JAX names: counters
``runtime.submissions``, ``runtime.source.<source>`` and
``runtime.faults``; every drain's ``record_runtime_dispatch``
(``runtime.dispatches``, the ``runtime.coalesced``, ``runtime.queue_depth``
and ``runtime.queue_wait.<source>`` histograms and the ``device_runtime``
kernel series); and a ``device_runtime_armed`` event (platform, attempt,
reason) after every arm, which here also carries ``probe_seconds`` and
the warm launches (``warmed``).  The arm info itself stays on
:meth:`DeviceRuntime.stats`.  A drain runs in the submitter's
contextvars, so the spans recorded inside it join the submitting
request's trace tree.

A launch through ctypes uses the calling thread's current device and
stream.  The drainer makes its card current once; everything it runs
(the index's uploads among them) goes to that card's current stream, so
one dispatch's tensors are ordered before the next one's launch.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..telemetry import device as ktel
from ..telemetry import events, metrics, tracing
from . import DeviceLike

log = logging.getLogger("upow_tpu_torch.device.runtime")

#: every kernel library the card's paths launch
KERNELS = ("p256_verify", "p256_verify_wide", "p256_complete",
           "sha256_search", "sha256_blocks", "utxo_probe")

_WAITS_CAP = 8192  # per-source queue-wait samples kept for stats()


class ArmError(RuntimeError):
    """The runtime could not arm its card: a build, load or warm launch
    failed.  Every item of that runtime fails with it."""


def boxed_call(fn: Callable[[], Any], timeout: float):
    """Run ``fn`` on a daemon thread of its own with a deadline.

    Returns ("ok", result) | ("err", exception) | ("timeout", None).  A
    call stuck inside a launch can be neither interrupted nor joined:
    the daemon thread is abandoned and the caller decides what that
    means (the verify path poisons its device path).  A runtime keeps
    one such thread for its boxed calls (:class:`_Box`).
    """
    box = _Box()
    try:
        return box.call(fn, timeout)
    finally:
        box.stop()  # after a timeout, queued behind the stuck call


class _Box:
    """One daemon thread that runs a runtime's boxed calls, kept from call
    to call: a fresh thread a call costs its start and its first CUDA
    work on every device verify (``runtime_cost`` in PERF.md).  The
    contract is :func:`boxed_call`'s; a call past its deadline abandons
    the thread, which may be stuck in a launch, and the next call starts
    a fresh one.  Only the drainer calls it, one call at a time."""

    def __init__(self, device: Optional[torch.device] = None):
        self._device = device  # a card to make current on the thread
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"upow-device-box-{device}")
        self.thread.start()

    def _run(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, ctx, box, done = job
            try:
                box["ok"] = ctx.run(fn)
            except Exception as e:
                box["err"] = e
            done.set()

    def call(self, fn: Callable[[], Any], timeout: float):
        box: dict = {}
        done = threading.Event()
        self._jobs.put((fn, contextvars.copy_context(), box, done))
        if not done.wait(timeout):
            return "timeout", None
        if "ok" in box:
            return "ok", box["ok"]
        return "err", box["err"]

    def stop(self) -> None:
        self._jobs.put(None)


class _Item:
    __slots__ = ("kind", "key", "checks", "precomputed", "fn", "timeout",
                 "kernel", "source", "fut", "t0", "ctx", "span")

    def __init__(self, kind, *, key=None, checks=None, precomputed=None,
                 fn=None, timeout=None, kernel="call", source="other"):
        self.kind = kind            # "sig" | "call"
        self.key = key              # sig coalescing key
        self.checks = checks
        self.precomputed = precomputed
        self.fn = fn
        self.timeout = timeout      # not None -> boxed execution
        self.kernel = kernel
        self.source = source
        self.fut: Future = Future()
        self.t0 = time.perf_counter()
        # the drainer executes in the submitter's contextvars
        self.ctx = contextvars.copy_context()
        self.span = tracing.current_span()

    @property
    def cost(self) -> int:
        return max(1, len(self.checks)) if self.kind == "sig" else 1


def _resolve(fut: Future, value) -> None:
    try:
        fut.set_result(value)
    except InvalidStateError:  # cancelled by an abandoning awaiter
        pass


def _fail(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


def runtime_key(device: DeviceLike = None) -> str:
    """``"cpu"`` or ``"cuda:<index>"`` (None and ``"cuda"`` are card 0)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return f"cuda:{dev.index or 0}"


class DeviceRuntime:
    """The per-process owner of one device: queues in, results out."""

    def __init__(self, cfg=None, device: DeviceLike = None):
        if cfg is None:
            from ..config import DeviceRuntimeConfig

            cfg = DeviceRuntimeConfig.from_env()
        self.cfg = cfg
        self.device = torch.device(runtime_key(device))
        self._weights = cfg.parsed_weights()
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._passes: Dict[str, float] = {}
        self._vtime = 0.0
        self._holds = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._box: Optional[_Box] = None
        self._arm_lock = threading.Lock()
        self._arm_done = threading.Event()
        self._arm_error: Optional[ArmError] = None
        self._arm_info: Dict[str, Any] = {
            "armed": False, "platform": None, "device": str(self.device),
            "card": None, "attempt": None, "arm_failure_reason": None,
            "probe_seconds": None, "warmed": [],
        }
        # introspection for tests and chip_smoke.py
        self.submissions = 0
        self.dispatches = 0
        self.source_submissions: Dict[str, int] = {}
        self._waits: Dict[str, List[float]] = {}

    # ------------------------------------------------------------ arming --

    def arm(self, deadline: Optional[float] = None,
            attempt: str = "runtime") -> dict:
        """Arm the device once, under a deadline; returns the arm info
        (platform, card, ``probe_seconds``, and each warm launch's
        status and seconds).  Raises :class:`ArmError` when a build,
        load or warm launch fails, now and at every later call.  The
        drainer calls this before it serves its first item."""
        with self._arm_lock:
            info = self._arm_info
            if info["armed"]:
                if self._arm_error is not None:
                    raise self._arm_error
                return dict(info)
            timeout = self.cfg.arm_timeout if deadline is None else deadline
            t0 = time.perf_counter()
            info.update(attempt=attempt, warmed=[], armed=True)
            try:
                if self.device.type == "cuda":
                    self._arm_card(info, timeout, t0)
                else:
                    info.update(platform="cpu", card=None)
            except Exception as e:
                reason = f"{type(e).__name__}: {e}"
                info.update(platform=None, arm_failure_reason=reason,
                            probe_seconds=round(time.perf_counter() - t0, 3))
                self._arm_error = ArmError(
                    f"device runtime failed to arm {self.device}: {reason}")
                self._arm_error.__cause__ = e
                log.warning("%s", self._arm_error)
                self._armed_event(info)
                # the kind the watchtower's arm-flap rule counts: on the
                # port a failed arm is fatal to the device path
                events.emit("arm_failed", device=str(self.device),
                            attempt=attempt, reason=reason)
                raise self._arm_error
            finally:
                self._arm_done.set()
            info.update(arm_failure_reason=None,
                        probe_seconds=round(time.perf_counter() - t0, 3))
            self._arm_error = None
            self._armed_event(info)
            return dict(info)

    @staticmethod
    def _armed_event(info: dict) -> None:
        events.emit("device_runtime_armed",
                    platform=info["platform"] or "none",
                    attempt=info["attempt"],
                    reason=info["arm_failure_reason"] or "",
                    probe_seconds=info["probe_seconds"],
                    warmed=json.dumps(info["warmed"]))

    def _arm_card(self, info: dict, timeout: float, t0: float) -> None:
        from .. import _build
        from . import resolve

        dev = resolve(self.device)  # raises without a card
        info["build_seconds"] = {k: round(v, 3) for k, v in
                                 _build.build_all(KERNELS).items()}
        for name in KERNELS:
            _build.load(name)
        torch.cuda.set_device(dev)
        info.update(platform="cuda", card=torch.cuda.get_device_name(dev))
        if not self.cfg.aot_warm:
            return
        budget = max(5.0, timeout - (time.perf_counter() - t0))
        end = time.perf_counter() + budget
        for name, fn in _warm_set(dev):
            t1 = time.perf_counter()
            status, value = boxed_call(
                fn, max(1.0, end - time.perf_counter()))
            entry = {"kernel": name, "status": status,
                     "seconds": round(time.perf_counter() - t1, 3)}
            if status == "err":
                entry["error"] = repr(value)
            info["warmed"].append(entry)
            log.info("warm launch %s: %s (%.3fs)", name, status,
                     entry["seconds"])
            if status != "ok":
                raise RuntimeError(f"warm launch of {name}: {status} "
                                   f"{value!r}")

    def platform(self) -> str:
        """``"cuda"`` or ``"cpu"`` once armed; blocks until the drainer's
        arm resolves (at once on the drainer itself).  Raises
        :class:`ArmError` when the arm failed."""
        self._ensure_thread()
        if threading.current_thread() is not self._thread:
            self._arm_done.wait(timeout=self.cfg.arm_timeout + 30.0)
        if self._arm_error is not None:
            raise self._arm_error
        return self._arm_info["platform"]

    def devices(self) -> List[torch.device]:
        """The devices this runtime's platform exposes: every visible
        card for ``cuda``, the host for ``cpu``."""
        if self.platform() == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device("cpu")]

    # -------------------------------------------------------- submission --

    def submit_sig_checks(self, checks: Sequence[tuple], *,
                          backend: str = "auto", pad_block: int = 128,
                          device_timeout: float = 240.0,
                          mesh_devices: int = 1,
                          precomputed: Optional[dict] = None,
                          source: str = "other") -> Future:
        """Queue one P-256 signature batch; the Future resolves to its
        verdict list (``txverify.run_sig_checks``'s).  Batches sharing
        (backend, pad_block, device_timeout, mesh_devices, precomputed
        identity) coalesce into one dispatch across ALL sources."""
        if not checks:
            fut: Future = Future()
            fut.set_result([])
            return fut
        key = (backend, pad_block, device_timeout, mesh_devices,
               id(precomputed) if precomputed is not None else None)
        item = _Item("sig", key=key, checks=list(checks),
                     precomputed=precomputed, source=source)
        self._enqueue(item)
        return item.fut

    def submit_call(self, fn: Callable[[], Any], *, kernel: str = "call",
                    source: str = "other",
                    timeout: Optional[float] = None) -> Future:
        """Queue a dispatch closure.  With ``timeout`` the call is boxed
        and the Future resolves to :func:`boxed_call`'s (status, value);
        without it, to ``fn()``'s result (or exception).  Called from the
        drainer itself (a dispatch nested in a dispatch) it runs inline:
        queueing would deadlock the one drainer."""
        if threading.current_thread() is self._thread:
            fut: Future = Future()
            try:
                if timeout is not None:
                    fut.set_result(self._boxed(fn, timeout))
                else:
                    fut.set_result(fn())
            # the exception travels to the caller inside the future
            except Exception as e:
                fut.set_exception(e)
            return fut
        item = _Item("call", fn=fn, timeout=timeout, kernel=kernel,
                     source=source)
        self._enqueue(item)
        return item.fut

    def run_boxed(self, fn: Callable[[], Any], timeout: float, *,
                  kernel: str = "call", source: str = "other"):
        """Blocking boxed dispatch through the queue: ("ok", result) |
        ("err", exc) | ("timeout", None) as :func:`boxed_call` gives
        them.  The outer wait's margin covers the arm and the queue; a
        failed arm raises :class:`ArmError`."""
        fut = self.submit_call(fn, kernel=kernel, source=source,
                               timeout=timeout)
        try:
            return fut.result(timeout=timeout + self.cfg.arm_timeout + 60.0)
        except FutureTimeoutError:
            return "timeout", None

    @contextlib.contextmanager
    def hold(self):
        """Pause draining (tests and chip_smoke.py build a coalescing
        window this way).  Items queue while held; release drains."""
        with self._cv:
            self._holds += 1
        try:
            yield self
        finally:
            with self._cv:
                self._holds -= 1
                self._cv.notify_all()

    def stats(self) -> dict:
        """Queue and dispatch counts, queue waits and the arm info."""
        with self._cv:
            depths = {s: len(q) for s, q in self._queues.items() if q}
            waits = {s: list(w) for s, w in self._waits.items()}
        return {
            "device": str(self.device),
            "submissions": self.submissions,
            "dispatches": self.dispatches,
            "per_source": dict(self.source_submissions),
            "queue_depth": depths,
            "queue_waits": waits,
            "arm": dict(self._arm_info),
        }

    # ----------------------------------------------------------- drainer --

    def _enqueue(self, item: _Item) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("device runtime stopped")
            q = self._queues.setdefault(item.source, deque())
            if len(q) >= self.cfg.queue_max:
                raise RuntimeError(
                    "device runtime queue overflow for source %r "
                    "(max %d)" % (item.source, self.cfg.queue_max))
            if not q:
                # a source waking from idle starts at the current virtual
                # time: banked idleness must not let it monopolise the
                # device once it bursts
                self._passes[item.source] = max(
                    self._passes.get(item.source, 0.0), self._vtime)
            q.append(item)
            self.submissions += 1
            self.source_submissions[item.source] = \
                self.source_submissions.get(item.source, 0) + 1
            metrics.inc("runtime.submissions")
            metrics.inc("runtime.source.%s" % item.source)
            self._cv.notify_all()
        self._ensure_thread()

    def _ensure_thread(self) -> None:
        with self._cv:
            if self._stop or (self._thread is not None
                              and self._thread.is_alive()):
                return
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True,
                name=f"upow-device-runtime-{self.device}")
            self._thread.start()

    def _drain_loop(self) -> None:
        try:
            self.arm()
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)  # this thread's card
        except ArmError as e:
            self._arm_error = self._arm_error or e  # every item fails with it
        while True:
            with self._cv:
                while not self._stop and (
                        self._holds > 0
                        or not any(self._queues.values())):
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
                depth = sum(len(q) for q in self._queues.values())
                group = self._pop_group_locked()
            if not group:
                continue
            if self._arm_error is not None:
                for m in group:
                    _fail(m.fut, self._arm_error)
                continue
            try:
                self._execute(group, depth)
            except Exception as e:  # belt: futures already failed below
                log.warning("device runtime dispatch raised: %s", e)
                for m in group:
                    _fail(m.fut, e)

    def _pop_group_locked(self) -> List[_Item]:
        active = [s for s, q in self._queues.items() if q]
        if not active:
            return []
        # weighted fair share (stride): serve the source with the least
        # virtual pass; ties break on the source's name
        src = min(active, key=lambda s: (self._passes.get(s, 0.0), s))
        head = self._queues[src].popleft()
        group = [head]
        if head.kind == "sig":
            # cross-source coalescing: every queued sig batch with the
            # head's key joins this dispatch, in a fixed scan order
            for s in sorted(self._queues):
                q = self._queues[s]
                if not q:
                    continue
                keep: deque = deque()
                while q:
                    cand = q.popleft()
                    if (len(group) < self.cfg.max_coalesce
                            and cand.kind == "sig"
                            and cand.key == head.key):
                        group.append(cand)
                    else:
                        keep.append(cand)
                self._queues[s] = keep
        for m in group:
            w = self._weights.get(m.source,
                                  self._weights.get("other", 1))
            self._passes[m.source] = self._passes.get(m.source, 0.0) \
                + m.cost / max(w, 1)
        self._vtime = self._passes.get(src, 0.0)
        return group

    def _record_waits(self, group: List[_Item], now: float) -> None:
        with self._cv:
            for m in group:
                wait = max(0.0, now - m.t0)
                lst = self._waits.setdefault(m.source, [])
                if len(lst) >= _WAITS_CAP:
                    del lst[: _WAITS_CAP // 2]
                lst.append(wait)

    def _execute(self, group: List[_Item], depth: int) -> None:
        """Run one group, record its telemetry, then settle its futures
        (recorded first, as in the JAX runtime: a caller woken by its
        result reads counts that include its own dispatch)."""
        now = time.perf_counter()
        self._record_waits(group, now)
        self.dispatches += 1
        waits: Dict[str, float] = {}
        for m in group:
            waits[m.source] = now - m.t0
        real = sum(len(m.checks) for m in group) \
            if group[0].kind == "sig" else 1
        try:
            outcomes = self._execute_sig(group) if group[0].kind == "sig" \
                else self._execute_call(group[0])
        # the exception travels to every submitter inside the futures
        except Exception as e:
            outcomes = [(m.fut, False, e) for m in group]
        end = time.perf_counter()
        # the port's kernels pad nothing: padded == real
        ktel.record_runtime_dispatch(
            n_submissions=len(group), waits_by_source=waits,
            depth=depth, real=real, padded=real, seconds=end - now)
        for m in group:
            tracing.add_span(m.span, "runtime.dispatch", now, end,
                             source=m.source, kernel=m.kernel,
                             coalesced=len(group),
                             queue_wait_ms=round((now - m.t0) * 1e3, 3))
        for fut, ok, value in outcomes:
            (_resolve if ok else _fail)(fut, value)

    def _execute_sig(self, group: List[_Item]) -> list:
        """The group's shared verify: (future, ok, verdicts or error)
        for each item."""
        flat: List[tuple] = []
        slices: List[Tuple[int, int]] = []
        for m in group:
            slices.append((len(flat), len(flat) + len(m.checks)))
            flat.extend(m.checks)
        backend, pad_block, device_timeout, mesh_devices, _ = group[0].key
        # looked up on the module, so a test's patch of
        # txverify.run_sig_checks intercepts the shared dispatch too
        from ..resilience.faultinject import FaultInjected
        from ..verify import txverify

        try:
            group[0].ctx.run(self._fire_fault, "sig:" + ",".join(
                sorted({m.source for m in group})))
        except FaultInjected as e:
            # the choke point: an injected dispatch fault degrades the
            # device path; the host serves the group only on the CPU
            txverify.DEGRADE.record_failure(e)
            metrics.inc("runtime.faults")
            if not txverify.host_may_serve(self.device):
                return [(m.fut, False, e) for m in group]
            log.warning("device.runtime fault injected; a group of %d "
                        "served on the host", len(group))
            backend = "host"
        verdicts = group[0].ctx.run(
            txverify.run_sig_checks, flat, backend=backend,
            device=self.device, pad_block=pad_block,
            device_timeout=device_timeout,
            precomputed=group[0].precomputed, mesh_devices=mesh_devices)
        return [(m.fut, True, verdicts[lo:hi])
                for m, (lo, hi) in zip(group, slices)]

    def _execute_call(self, item: _Item) -> list:
        """The call: [(future, ok, result or error)]."""
        def wrapped():
            self._fire_fault("call:%s" % item.kernel)
            return item.fn()

        if item.timeout is not None:
            # boxed: a fault or a hang becomes the status tuple and the
            # caller applies its own degrade policy
            return [(item.fut, True,
                     item.ctx.run(self._boxed, wrapped, item.timeout))]
        return [(item.fut, True, item.ctx.run(wrapped))]

    def _boxed(self, fn: Callable[[], Any], timeout: float):
        """:func:`boxed_call` on the runtime's kept box thread (the
        drainer's alone); a timeout abandons that thread."""
        if self._box is None:
            self._box = _Box(self.device)
        status, value = self._box.call(fn, timeout)
        if status == "timeout":
            self._box = None  # stuck, perhaps in a launch: never reused
        return status, value

    @staticmethod
    def _fire_fault(key: str) -> None:
        from ..resilience.faultinject import get_injector

        injector = get_injector()
        if injector is not None:
            injector.fire_sync("device.runtime", key=key)

    def close(self) -> None:
        """Stop the drainer and fail anything still queued."""
        with self._cv:
            self._stop = True
            pending = [m for q in self._queues.values() for m in q]
            self._queues.clear()
            self._cv.notify_all()
        for m in pending:
            _fail(m.fut, RuntimeError("device runtime stopped"))
        if self._box is not None:
            self._box.stop()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)


def _warm_set(dev: torch.device) -> List[Tuple[str, Callable[[], Any]]]:
    """One launch of each production kernel on ``dev``, each checked
    against its known answer.  They call the wrappers directly: they run
    beside the arming drainer, where a nested submission would wait on
    the drainer itself."""
    import hashlib

    import numpy as np

    def check(name: str, got, want) -> bool:
        if got != want:
            raise RuntimeError(f"{name} warm launch gave {got!r}, not "
                               f"{want!r}")
        return True

    def warm_p256():
        from ..crypto import p256
        from ..verify.txverify import _canary_checks

        good, bad = _canary_checks()
        out = p256.verify_batch_prehashed(
            [good[0], bad[0]], [good[2], bad[2]], [good[3], bad[3]],
            device=dev)
        return check("p256_verify", [bool(v) for v in out], [True, False])

    def warm_search():
        from ..crypto import sha256 as tsha

        template = tsha.make_template(bytes(104))
        hit = int(tsha.pow_search(template, np.zeros(7, dtype=np.uint32),
                                  0, 1, device=dev))
        return check("sha256_search", hit, int(tsha.SENTINEL))

    def warm_blocks():
        from ..crypto import sha256 as tsha

        msgs = [b"abc", bytes(range(120))]
        got = tsha._digest_array(msgs, dev).tobytes()
        return check("sha256_blocks", got,
                     b"".join(hashlib.sha256(m).digest() for m in msgs))

    def warm_probe():
        from ..state import device_index as di

        index = di.DeviceUtxoIndex(
            [("ab" * 32, i) for i in range(4)],
            values=[(i + 1, "warm", 0) for i in range(4)], device=dev)
        ops = [("ab" * 32, 0), ("cd" * 32, 9)]
        present, _maybe, _amounts, _c = index._probe_eval(
            ops, di.fingerprint_batch(ops), di.check_batch(ops))
        return check("utxo_probe", [bool(v) for v in present],
                     [True, False])

    def warm_mesh():
        from ..mine.mesh_engine import warm_resident_search

        warm_resident_search(dev)
        return True

    warm = [("p256_verify", warm_p256), ("sha256_search", warm_search),
            ("sha256_blocks", warm_blocks), ("utxo_probe", warm_probe)]
    if torch.cuda.device_count() >= 2:
        warm.append(("sha256_search_mesh", warm_mesh))
    return warm


_RUNTIMES: Dict[str, DeviceRuntime] = {}
_RUNTIME_LOCK = threading.Lock()


def get_runtime(device: DeviceLike = None) -> DeviceRuntime:
    """The process-wide runtime of ``device`` (None: the first card),
    made at first use; its drainer starts at the first submission."""
    key = runtime_key(device)
    with _RUNTIME_LOCK:
        rt = _RUNTIMES.get(key)
        if rt is None:
            rt = _RUNTIMES[key] = DeviceRuntime(device=key)
        return rt


def reset_runtime() -> None:
    """Tear every runtime down (tests, and chip_smoke.py between its
    phases): stops the drainers, fails queued futures, and lets the next
    :func:`get_runtime` build a fresh one."""
    with _RUNTIME_LOCK:
        runtimes = list(_RUNTIMES.values())
        _RUNTIMES.clear()
    for rt in runtimes:
        rt.close()


def armed_cards() -> List[int]:
    """The indices of the cards this process's runtimes armed
    (``telemetry.device.device_memory`` reads their memory)."""
    with _RUNTIME_LOCK:
        runtimes = list(_RUNTIMES.values())
    return sorted(rt.device.index or 0 for rt in runtimes
                  if rt.device.type == "cuda" and rt._arm_error is None
                  and rt._arm_info["platform"] == "cuda")


def arm_failure_reason() -> Optional[str]:
    """The first recorded arm failure of this process's runtimes, read
    without blocking (the miner's watchdog fires exactly when dispatches
    are stuck)."""
    with _RUNTIME_LOCK:
        runtimes = list(_RUNTIMES.values())
    for rt in runtimes:
        reason = rt._arm_info.get("arm_failure_reason")
        if reason:
            return reason
    return None
