"""Kernel telemetry: dispatch latency, compile hit/miss, occupancy.

The port's copy of the JAX package's ``telemetry/device.py``.  The
batch kernels (P-256 verify, sha256 txid) report every batch;
``record_batch`` feeds, per kernel:

- ``kernel.<name>.dispatch_seconds``   latency histogram
- ``kernel.<name>.occupancy``          real/padded-lane ratio histogram
- ``kernel.<name>.lanes_real``         counters (padding waste =
  ``kernel.<name>.lanes_padded``       padded - real)
- ``kernel.<name>.compile_cache_hits`` build-and-load proxy: the
  ``kernel.<name>.compile_cache_misses``  first launch of a kernel for
  each compile key (the port's callers pass (library, window)) after
  its build is the miss, later launches are hits.

Where the port departs (each for a reader the JAX package lacks):

- ``kernel.<name>.batches`` counts every ``record_batch`` call: one
  launch a batch for the kernel rows, what ``chip_smoke.py`` counts a
  node's launches by.
- :func:`device_memory` reads ``torch.cuda`` (see its docstring), not
  a JAX device's ``memory_stats()``.
- :func:`record_cost` holds the port's own counts of a kernel's work
  (``profiling.analyze_cost``), where the JAX package holds XLA's
  ``cost_analysis()``.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Hashable, Optional, Set

from ..logger import get_logger
from . import metrics

log = get_logger("telemetry")

OCCUPANCY_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
DISPATCH_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)

_lock = threading.Lock()
_seen_keys: Dict[str, Set[Hashable]] = {}
_costs: Dict[str, Dict[str, float]] = {}
_MAX_KEYS_PER_KERNEL = 4096
_MAX_COST_KERNELS = 64
_MAX_COST_KEYS = 16


def preregister(kernel: str) -> None:
    """Create the kernel's metric families so /metrics exports them
    (all-zero) before the first dispatch."""
    metrics.ensure_histogram("kernel.%s.occupancy" % kernel,
                             OCCUPANCY_BUCKETS)
    metrics.ensure_histogram("kernel.%s.dispatch_seconds" % kernel,
                             DISPATCH_BUCKETS)
    for c in ("lanes_real", "lanes_padded",
              "compile_cache_hits", "compile_cache_misses"):
        metrics.ensure_counter("kernel.%s.%s" % (kernel, c))


def record_batch(kernel: str, real: int, padded: int,
                 seconds: Optional[float] = None,
                 compile_key: Optional[Hashable] = None) -> None:
    """Record one batch dispatch. ``real`` lanes of ``padded`` total."""
    padded = max(int(padded), 1)
    real = min(max(int(real), 0), padded)
    metrics.inc("kernel.%s.batches" % kernel)
    metrics.inc("kernel.%s.lanes_real" % kernel, real)
    metrics.inc("kernel.%s.lanes_padded" % kernel, padded)
    metrics.observe("kernel.%s.occupancy" % kernel, real / padded,
                    buckets=OCCUPANCY_BUCKETS)
    if seconds is not None:
        metrics.observe("kernel.%s.dispatch_seconds" % kernel, seconds,
                        buckets=DISPATCH_BUCKETS)
    if compile_key is not None:
        with _lock:
            seen = _seen_keys.setdefault(kernel, set())
            hit = compile_key in seen
            if not hit and len(seen) < _MAX_KEYS_PER_KERNEL:
                seen.add(compile_key)
        metrics.inc("kernel.%s.compile_cache_%s"
                    % (kernel, "hits" if hit else "misses"))


def preregister_stage(stage: str) -> None:
    """Create a pipeline stage's metric families (all-zero) so /metrics
    exports them before the first block flows through the pipeline."""
    metrics.ensure_histogram("pipeline.%s.seconds" % stage,
                             DISPATCH_BUCKETS)
    metrics.ensure_histogram("pipeline.%s.occupancy" % stage,
                             OCCUPANCY_BUCKETS)
    metrics.ensure_counter("pipeline.%s.items" % stage)


def record_stage(stage: str, seconds: float, items: Optional[int] = None,
                 wall: Optional[float] = None) -> None:
    """Record one pipeline stage pass (ISSUE 7: pipelined block verify).

    ``seconds`` is the stage's busy time; ``wall`` (when given) is the
    whole pipeline's wall time for the same pass, making
    ``pipeline.<stage>.occupancy`` the fraction of the pipeline the
    stage kept busy — overlap shows up as stage occupancies summing
    past 1.0, a serialized pipeline as fractions that add to ~1.0.
    """
    metrics.observe("pipeline.%s.seconds" % stage, max(seconds, 0.0),
                    buckets=DISPATCH_BUCKETS)
    if items:
        metrics.inc("pipeline.%s.items" % stage, items)
    if wall is not None and wall > 0:
        metrics.observe("pipeline.%s.occupancy" % stage,
                        min(max(seconds, 0.0) / wall, 1.0),
                        buckets=OCCUPANCY_BUCKETS)


RUNTIME_SOURCES = ("block", "mempool", "mine", "index", "verify",
                   "bench", "other")
RUNTIME_QUEUE_DEPTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024,
                               4096)
RUNTIME_COALESCE_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64)


def preregister_runtime(sources=RUNTIME_SOURCES) -> None:
    """Create the device-runtime queue families (device/runtime.py) so
    /metrics exports them before the first submission: per-source
    queue-wait histograms and submission counters, the queue-depth and
    submissions-per-dispatch histograms, and a ``device_runtime``
    kernel occupancy series for the shared dispatches."""
    metrics.ensure_histogram("runtime.queue_depth",
                             RUNTIME_QUEUE_DEPTH_BUCKETS)
    metrics.ensure_histogram("runtime.coalesced", RUNTIME_COALESCE_BUCKETS)
    for c in ("submissions", "dispatches", "faults"):
        metrics.ensure_counter("runtime.%s" % c)
    for s in sources:
        metrics.ensure_histogram("runtime.queue_wait.%s" % s,
                                 DISPATCH_BUCKETS)
        metrics.ensure_counter("runtime.source.%s" % s)
    preregister("device_runtime")


def record_runtime_dispatch(n_submissions: int,
                            waits_by_source: Dict[str, float],
                            depth: int, real: int, padded: int,
                            seconds: float) -> None:
    """Record one device-runtime drain: how many submissions shared the
    dispatch, how long each source's items queued, the queue depth seen
    at pop time, and the occupancy of the padded batch."""
    metrics.inc("runtime.dispatches")
    metrics.observe("runtime.coalesced", n_submissions,
                    buckets=RUNTIME_COALESCE_BUCKETS)
    metrics.observe("runtime.queue_depth", max(depth, 1),
                    buckets=RUNTIME_QUEUE_DEPTH_BUCKETS)
    for source, wait in waits_by_source.items():
        metrics.observe("runtime.queue_wait.%s" % source,
                        max(wait, 0.0), buckets=DISPATCH_BUCKETS)
    record_batch("device_runtime", real=real, padded=padded,
                 seconds=seconds)


INDEX_KERNELS = ("utxo_probe", "utxo_apply", "accept_fused")


def preregister_index() -> None:
    """Create the HBM-resident UTXO index families (state/device_index.py)
    so /metrics exports them before the first probe: the probe/apply/
    fused kernel series plus the probe counters — ``shadow_consults``
    is the accept path's zero-host-round-trip acceptance signal (it
    stays 0 on collision-free blocks)."""
    for kernel in INDEX_KERNELS:
        preregister(kernel)
    for c in ("probes", "probe_outpoints", "shadow_consults",
              "ambiguous_probes"):
        metrics.ensure_counter("index.%s" % c)


def record_index_probe(outpoints: int, shadow_consults: int,
                       ambiguous: int = 0) -> None:
    """Record one resident-index probe batch: how many outpoints it
    answered, and how many needed the host shadow map (fingerprint
    ambiguity — the steady-state target is zero)."""
    metrics.inc("index.probes")
    metrics.inc("index.probe_outpoints", max(int(outpoints), 0))
    if shadow_consults:
        metrics.inc("index.shadow_consults", int(shadow_consults))
    if ambiguous:
        metrics.inc("index.ambiguous_probes", int(ambiguous))


HIT_LATENCY_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 90.0)


def preregister_mine() -> None:
    """Create the mesh mining families (mine/mesh_engine.py) so /metrics
    exports them before the first round: the ``mine_mesh`` kernel series
    (occupancy = real nonces vs shard capacity; compile-cache counters
    are the no-recompile-job-swap signal) plus the per-shard range
    occupancy and time-to-hit histograms."""
    preregister("mine_mesh")
    metrics.ensure_histogram("mine.shard_occupancy", OCCUPANCY_BUCKETS)
    metrics.ensure_histogram("mine.hit_latency", HIT_LATENCY_BUCKETS)


def record_mine_round(shard_spans, batch_per_device: int,
                      seconds: Optional[float] = None,
                      compile_key: Optional[Hashable] = None) -> None:
    """Record one mesh search round: ``shard_spans`` is the per-shard
    planned nonce count; capacity per shard is ``batch_per_device``.
    The compile key is (batch, n_shards, nonce_spec) — job fields are
    deliberately absent, so a chain-tip change that recompiles would
    surface as a new key = a ``compile_cache_misses`` increment."""
    spans = [max(int(s), 0) for s in shard_spans]
    cap = max(int(batch_per_device), 1)
    record_batch("mine_mesh", real=sum(spans), padded=cap * len(spans),
                 seconds=seconds, compile_key=compile_key)
    for span in spans:
        metrics.observe("mine.shard_occupancy", min(span / cap, 1.0),
                        buckets=OCCUPANCY_BUCKETS)


def record_mine_hit(latency_seconds: float) -> None:
    """Record time from job load to winning nonce (mine.hit_latency)."""
    metrics.observe("mine.hit_latency", max(float(latency_seconds), 0.0),
                    buckets=HIT_LATENCY_BUCKETS)


def record_cost(kernel: str, analysis: dict) -> None:
    """Store a count of ``kernel``'s work (``profiling.analyze_cost``):
    numeric entries only, keys sanitized to
    metric-name charset, bounded per kernel and overall so a pathological
    analysis dict cannot grow /metrics without limit."""
    clean: Dict[str, float] = {}
    for key in sorted(analysis):
        value = analysis[key]
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        clean[key.replace(" ", "_").replace("-", "_")] = float(value)
        if len(clean) >= _MAX_COST_KEYS:
            break
    if not clean:
        return
    with _lock:
        if kernel not in _costs and len(_costs) >= _MAX_COST_KERNELS:
            return
        _costs[kernel] = clean


def cost_estimates() -> Dict[str, Dict[str, float]]:
    """Snapshot of recorded per-compile cost analyses, keyed by kernel."""
    with _lock:
        return {k: dict(v) for k, v in _costs.items()}


#: torch.cuda.memory_stats() key -> the key XLA's memory_stats() gives
#: on a GPU, so the exported families match a JAX node's on a GPU
_TORCH_TO_XLA = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("reserved_bytes.all.current", "bytes_reserved"),
    ("reserved_bytes.all.peak", "peak_bytes_reserved"),
    ("allocation.all.allocated", "num_allocs"),
)


def device_memory() -> Dict[str, dict]:
    """Memory of each card this process's device runtime armed, keyed
    ``gpu_<index>`` (the label a JAX node on a GPU gives):

    ======================  =========================================
    key                     torch source
    ======================  =========================================
    ``bytes_in_use``        ``memory_stats()["allocated_bytes.all.current"]``
    ``peak_bytes_in_use``   ``memory_stats()["allocated_bytes.all.peak"]``
    ``bytes_reserved``      ``memory_stats()["reserved_bytes.all.current"]``
    ``peak_bytes_reserved`` ``memory_stats()["reserved_bytes.all.peak"]``
    ``num_allocs``          ``memory_stats()["allocation.all.allocated"]``
    ``bytes_limit``         ``mem_get_info()[1]`` (the card's total)
    ======================  =========================================

    A scrape never initialises CUDA: {} unless torch is loaded, CUDA is
    initialised and a runtime armed a card (a CPU node returns {}, as a
    JAX node does without jax loaded)."""
    torch = sys.modules.get("torch")
    runtime = sys.modules.get("upow_tpu_torch.device.runtime")
    if torch is None or runtime is None or not torch.cuda.is_initialized():
        return {}
    out: Dict[str, dict] = {}
    try:
        for index in runtime.armed_cards():
            stats = torch.cuda.memory_stats(index)
            row = {xla: stats[key] for key, xla in _TORCH_TO_XLA
                   if isinstance(stats.get(key), (int, float))}
            row["bytes_limit"] = torch.cuda.mem_get_info(index)[1]
            out["gpu_%d" % index] = row
    except Exception as e:
        log.debug("device memory stats unavailable: %s", e)
    return out


def reset() -> None:
    with _lock:
        _seen_keys.clear()
        _costs.clear()
