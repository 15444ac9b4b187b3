"""Shared batched-dispatch front for P-256 signature verification.

The port of the JAX package's ``verify/dispatch.py``: a thin client of
the process-wide device runtime (``device/runtime.py``).  Every caller
that needs signature verdicts (block verify's micro-batches,
:mod:`.block`; the mempool intake's batches, ``mempool/intake.py``)
submits its checks HERE.  Submissions queue; a per-event-loop drainer
flattens every queued submission with compatible dispatch parameters
into one group and hands it to the runtime
(``submit_sig_checks(..., source=...)``), where it may share one device
dispatch with groups of other event loops and subsystems.  While one
group is in flight, new submissions pile up and form the next one.

Verdict semantics are exactly :func:`txverify.run_sig_checks`'s: the
front only changes WHO shares a dispatch, never what is computed.  The
coalescing key is the JAX front's (backend, pad block, device timeout,
mesh size, identity of the chain-sync page verdicts) and the device,
whose runtime the group goes to.  The JAX front's injected
``dispatch_fn`` is left out: every group takes the one path through the
runtime, and a test that fakes the verify patches
``txverify.run_sig_checks``, which the runtime looks up on its module.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..device import DeviceLike
from ..device.runtime import get_runtime
from ..telemetry import device as ktel
from ..telemetry import metrics

log = logging.getLogger("upow_tpu_torch.verify.dispatch")

COALESCE_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


class _Submission:
    __slots__ = ("checks", "key", "precomputed", "fut", "source")

    def __init__(self, checks, key, precomputed, fut, source):
        self.checks = checks
        self.key = key
        self.precomputed = precomputed
        self.fut = fut
        self.source = source


class SigDispatchFront:
    """Per-event-loop coalescing queue in front of the device runtime."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._queue: List[_Submission] = []
        self._drainer: Optional[asyncio.Task] = None
        # introspection for tests: groups dispatched and the submissions
        # coalesced into them
        self.dispatches = 0
        self.submissions = 0

    async def submit(self, checks: Sequence[tuple], *,
                     backend: str = "auto",
                     device: DeviceLike = None,
                     pad_block: int = 128,
                     device_timeout: float = 240.0,
                     mesh_devices: int = 1,
                     precomputed: Optional[dict] = None,
                     source: str = "other") -> List[bool]:
        """Queue one batch of sig checks; resolves to its verdict list.

        Submissions sharing the key coalesce into one dispatch;
        incompatible ones dispatch separately in arrival order.
        ``precomputed`` (a sync page's verdicts) answers the checks it
        holds (:func:`txverify.run_sig_checks`).
        """
        if not checks:
            return []
        key = (backend, pad_block, device_timeout, mesh_devices,
               id(precomputed) if precomputed is not None else None,
               device)
        fut: asyncio.Future = self._loop.create_future()
        self._queue.append(_Submission(list(checks), key, precomputed, fut,
                                       source))
        self.submissions += 1
        metrics.inc("pipeline.front.submissions")
        metrics.inc("pipeline.front.source.%s" % source)
        self._ensure_drainer()
        return await fut

    def _ensure_drainer(self) -> None:
        if self._drainer is not None and not self._drainer.done():
            return
        self._drainer = self._loop.create_task(self._drain())

    async def _drain(self) -> None:
        while self._queue:
            head_key = self._queue[0].key
            group = [s for s in self._queue if s.key == head_key]
            self._queue = [s for s in self._queue if s.key != head_key]
            await self._dispatch_group(group)

    async def _dispatch_group(self, group: List[_Submission]) -> None:
        flat: List[tuple] = []
        slices: List[Tuple[int, int]] = []
        for s in group:
            slices.append((len(flat), len(flat) + len(s.checks)))
            flat.extend(s.checks)
        (backend, pad_block, device_timeout, mesh_devices, _,
         device) = group[0].key
        self.dispatches += 1
        metrics.inc("pipeline.front.dispatches")
        metrics.observe("pipeline.front.coalesced", len(group),
                        buckets=COALESCE_BUCKETS)
        t0 = time.perf_counter()
        try:
            verdicts = await asyncio.wrap_future(
                get_runtime(device).submit_sig_checks(
                    flat, backend=backend, pad_block=pad_block,
                    device_timeout=device_timeout,
                    mesh_devices=mesh_devices,
                    precomputed=group[0].precomputed,
                    source=group[0].source))
        except Exception as e:
            # not swallowed: every submitter in the group re-raises it
            log.debug("coalesced sig dispatch failed (%d submissions): %s",
                      len(group), e)
            for s in group:
                if not s.fut.done():
                    s.fut.set_exception(e)
            return
        finally:
            # the port's kernels pad nothing: padded == real
            ktel.record_batch("sig_front", real=len(flat), padded=len(flat),
                              seconds=time.perf_counter() - t0)
        for s, (lo, hi) in zip(group, slices):
            if not s.fut.done():
                s.fut.set_result(verdicts[lo:hi])


_FRONTS: Dict[int, SigDispatchFront] = {}
_MAX_FRONTS = 32  # dead test loops accumulate; keep the map bounded


def get_front() -> SigDispatchFront:
    """The calling event loop's dispatch front (one per loop: futures
    and the drainer task are loop-bound; tests spin up fresh loops)."""
    loop = asyncio.get_running_loop()
    front = _FRONTS.get(id(loop))
    if front is None or front._loop is not loop or loop.is_closed():
        if len(_FRONTS) >= _MAX_FRONTS:
            for key in [k for k, f in _FRONTS.items()
                        if f._loop.is_closed()]:
                del _FRONTS[key]
            if len(_FRONTS) >= _MAX_FRONTS:
                _FRONTS.clear()
        front = SigDispatchFront(loop)
        _FRONTS[id(loop)] = front
    return front


def preregister() -> None:
    """Export the front's metric families before the first dispatch."""
    ktel.preregister("sig_front")
    metrics.ensure_histogram("pipeline.front.coalesced", COALESCE_BUCKETS)
    for c in ("submissions", "dispatches"):
        metrics.ensure_counter("pipeline.front.%s" % c)
