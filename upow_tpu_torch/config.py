"""Typed configuration: the part of the JAX package's ``config.py`` that
the port's node and miner read.

``Config.load(path, **overrides)`` reads, later winning: the defaults, a
JSON config file, ``UPOW_<SECTION>_<FIELD>`` environment variables
(``UPOW_NODE_PORT=3007``, ``UPOW_DEVICE_VERIFY_KERNEL=complete``) and
``section__field`` keyword overrides (``node__port=3007``): the JAX
package's names and precedence, so a config file or environment that the
JAX node reads configures the port's node the same way.  Sections and
fields the port does not read yet (the ``miner`` and ``archive``
sections, ``device.device``, ``device.search_backend`` and
``device_runtime.compile_cache_dir``) come with the slices that read
them (ROADMAP.md); a config file naming them is read, and they are
skipped.  So is
``mempool.enabled``: the port's node always admits through the
coalescing intake, whose replies are byte for byte those of the JAX
node's serial path.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("upow_tpu_torch.config")

DEFAULT_SEED_URL = "https://api.upow.ai/"

# every section and field of the JAX package's Config (upow_tpu/config.py)
JAX_SCHEMA = {
    "device": ("device", "search_backend", "sig_backend", "search_batch",
               "verify_pad_block", "verify_device_timeout", "mesh_devices",
               "utxo_index", "verify_kernel", "verify_window",
               "txid_backend", "txid_min_batch", "verify_microbatch"),
    "device_runtime": ("arm_timeout", "aot_warm", "compile_cache_dir",
                       "weights", "queue_max", "max_coalesce"),
    "node": ("host", "port", "db_backend", "db_path", "pg_dsn", "seed_url",
             "peers_file", "ip_config_file", "self_url",
             "trust_proxy_headers", "max_peers", "active_within",
             "prune_after", "propagate_sample", "response_cap",
             "http_timeout", "sync_reorg_window", "sync_page",
             "sync_fetch_interval", "mempool_clean_interval",
             "rate_limits_enabled"),
    "ws": ("enabled", "max_connections", "max_per_user", "max_message_bytes",
           "rate_limit_per_minute", "heartbeat_interval", "connection_expiry",
           "cleanup_interval", "send_queue_max", "channels"),
    "miner": ("address", "node_url", "workers", "ttl", "refresh"),
    "log": ("path", "level", "max_bytes", "backups", "console",
            "json_format"),
    "resilience": ("rpc_attempts", "rpc_backoff_base", "rpc_backoff_max",
                   "rpc_backoff_multiplier", "rpc_jitter", "rpc_deadline",
                   "propagate_deadline", "breaker_failure_threshold",
                   "breaker_open_secs", "breaker_half_open_max",
                   "device_failure_limit", "device_cooldown", "faults",
                   "faults_seed"),
    "mempool": ("enabled", "coalesce_window_ms", "max_intake_batch",
                "max_pool_bytes_hex", "tx_ttl", "tx_cache_size",
                "tx_cache_ttl", "allow_rbf", "reinject_on_reorg"),
    "cache": ("enabled", "class_cap_bytes", "class_caps", "max_entry_bytes",
              "revalidate_interval"),
    "snapshot": ("dir", "chunk_bytes", "blocks_tail", "keep",
                 "chunk_retries", "max_chunks", "max_chunk_bytes",
                 "max_payload_bytes", "rebuild_interval_blocks",
                 "rebuild_jitter_blocks"),
    "archive": ("dir", "segment_blocks", "safety_window",
                "reader_cache_segments", "max_segment_bytes", "max_segments"),
    "telemetry": ("trace_requests", "trace_recent", "trace_slowest",
                  "max_trace_spans", "events_buffer", "max_metric_names",
                  "debug_endpoints", "instance_scope"),
    "watchtower": ("enabled", "interval", "slo_target", "fast_burn",
                   "slow_burn", "window_scale", "for_fast", "for_slow",
                   "verify_min_rate", "verify_z", "mempool_spike_ratio",
                   "mempool_spike_floor", "sync_lag_limit",
                   "breaker_storm_window", "breaker_storm_opens",
                   "ws_drop_limit", "arm_flap_window", "arm_flaps",
                   "stuck_height_deadline", "history", "bench_events"),
    "profile": ("enabled", "trace_dir", "max_capture_seconds",
                "cost_analysis"),
}


@dataclass
class DeviceConfig:
    """Compute settings of the node's verify path and the miner."""

    sig_backend: str = "auto"       # auto | device | host ("tpu", the JAX
                                    # package's name, means the device)
    verify_pad_block: int = 128     # part of the signature dispatch's
                                    # coalescing key, as in the JAX
                                    # package; the port's kernels take
                                    # any lane count and pad nothing
    verify_device_timeout: float = 240.0  # seconds a boxed device verify
                                    # may take before the degrade
                                    # poisons the device path
    search_batch: int = 1 << 24     # nonces per device dispatch
    verify_kernel: str = ""         # "" = default (jac) | jac | complete
    verify_window: int = 0          # 0 = default (4) | 2 .. 13: the jac
                                    # ladder's window, the JAX package's
                                    # [2, 13] range; every window has its
                                    # kernel (2-5 csrc/p256_verify.cu, 5
                                    # being B7; 6-13 p256_verify_wide.cu)
    mesh_devices: int = 0           # cards the mesh verify and the mesh
                                    # miner span: 0 = all visible, N =
                                    # the first N (parallel/mesh.py)
    verify_microbatch: int = 1024   # txs per check_block micro-batch:
                                    # digest prep of batch N overlaps the
                                    # in-flight sig verify of batch N-1
                                    # (verify/block.py); 0 = whole block
    txid_backend: str = "auto"      # auto | device | host: the txid
                                    # batch of a sync page and the txid
                                    # and signing-digest batch of a
                                    # check_block micro-batch
                                    # (crypto/sha256.txid_batch); auto
                                    # takes the device from a batch size
                                    # (sha256.TXID_AUTO_DEVICE_MIN)
    txid_min_batch: int = 256       # below this many payloads, hashlib
    utxo_index: bool = False        # the resident UTXO index on the
                                    # node's device: membership on block
                                    # accept and tx intake
                                    # (state/device_index.py)

    def apply_kernel_overrides(self) -> None:
        """Push ``verify_kernel`` and ``verify_window`` into
        ``crypto.p256.VERIFY_KERNEL`` and ``VERIFY_WINDOW`` (module-level,
        so node, tests and chip_smoke.py see one value).  No-op at the
        defaults.  Validation is the JAX package's: every window in
        [2, 13] has its kernel."""
        if not (self.verify_kernel or self.verify_window):
            return
        if self.verify_kernel and self.verify_kernel not in ("jac",
                                                             "complete"):
            raise ValueError(
                f"device.verify_kernel must be 'jac' or 'complete', "
                f"not {self.verify_kernel!r}")
        window = self.verify_window
        if window and (not isinstance(window, int) or isinstance(window, bool)
                       or not 2 <= window <= 13):
            raise ValueError(
                f"device.verify_window must be an int in [2, 13], "
                f"not {window!r}")
        from .crypto import p256

        if self.verify_kernel:
            p256.VERIFY_KERNEL = self.verify_kernel
        if window:
            p256.VERIFY_WINDOW = window


@dataclass
class DeviceRuntimeConfig:
    """The per-process device runtime (``device/runtime.py``).
    Operational only: the runtime changes who shares a dispatch, never
    what is computed.  Every field is overridable as
    ``UPOW_DEVICE_RUNTIME_<FIELD>``.  The JAX package's
    ``compile_cache_dir`` (its persistent XLA cache) has no counterpart
    and is skipped."""

    arm_timeout: float = 90.0       # the arm's deadline: the kernels'
                                    # build, load and warm launches
    aot_warm: bool = True           # one warm launch of each kernel at
                                    # arm time (on a card only)
    weights: str = ("block=4,index=3,mempool=2,verify=2,"
                    "mine=1,bench=1,other=1")
                                    # fair-share weights per source; a
                                    # served item charges cost/weight to
                                    # its source's virtual pass, so
                                    # block verify outruns a saturating
                                    # miner stream 4:1
    queue_max: int = 8192           # per-source pending-item cap;
                                    # overflow raises (backpressure)
    max_coalesce: int = 64          # sig submissions merged into one
                                    # shared dispatch

    def parsed_weights(self) -> dict:
        weights = {}
        for part in self.weights.split(","):
            name, _, raw = part.strip().partition("=")
            name, raw = name.strip(), raw.strip()
            if name and raw:
                try:
                    weights[name] = max(1, int(raw))
                except ValueError:
                    raise ValueError(
                        f"device_runtime.weights entry {part!r}: weight "
                        f"must be an integer") from None
        return weights

    @classmethod
    def from_env(cls) -> "DeviceRuntimeConfig":
        """Defaults and ``UPOW_DEVICE_RUNTIME_*`` overrides: the runtime
        arms before any Config exists, so it reads the environment
        itself."""
        cfg = cls()
        _apply_env_fields(cfg, "device_runtime")
        return cfg


@dataclass
class MempoolConfig:
    """Micro-batched mempool subsystem (upow_tpu_torch/mempool/).

    All operational policy: nodes with different mempool settings stay
    bit-identical on chain state, and push_tx keeps the reference wire
    shape (error strings / status codes) regardless of these knobs.
    """

    coalesce_window_ms: float = 2.0  # admission-queue drain window: how
                                    # long the first waiter of a batch
                                    # holds the door for stragglers
    max_intake_batch: int = 128     # txs per micro-batch (one P-256
                                    # device dispatch per batch)
    max_pool_bytes_hex: int = 64 * 1024 * 1024  # pool byte cap (hex
                                    # chars, 16 reference blocks);
                                    # overflow evicts lowest fee-rate
    tx_ttl: float = 7200.0          # seconds before an un-mined pooled
                                    # tx expires (0 = never)
    tx_cache_size: int = 1 << 16    # push_tx dedup set capacity
                                    # (replaces the 100-entry deque)
    tx_cache_ttl: float = 600.0     # seconds a dedup entry stays live
    allow_rbf: bool = False         # pool replace-by-fee on a journal
                                    # sync (push_tx keeps the reference
                                    # reject either way)
    reinject_on_reorg: bool = True  # re-queue txs from rolled-back
                                    # blocks into the journal and pool


@dataclass
class SnapshotConfig:
    """Block-hash-anchored UTXO snapshots (``snapshot/``, docs/SNAPSHOT.md).
    Operational only: a snapshot-restored node and a full-replay node end
    on byte-identical UTXO fingerprints, so none of these knobs touch
    consensus.  All overridable as ``UPOW_SNAPSHOT_<FIELD>``."""

    dir: str = ""                   # snapshot root directory; '' disables
                                    # both building and serving
    chunk_bytes: int = 1 << 20      # fixed chunk size the payload is
                                    # split into (each chunk sha256'd
                                    # into the manifest)
    blocks_tail: int = 64           # recent block rows carried in the
                                    # payload, so a restored node has a
                                    # tip and fork-detection history
    keep: int = 2                   # on-disk generations retained; older
                                    # ones and stale staging dirs are
                                    # pruned (never raising)
    chunk_retries: int = 2          # per-chunk integrity retries against
                                    # ONE source before failing over
    max_chunks: int = 1 << 14       # restore-side ceilings on what a
    max_chunk_bytes: int = 16 << 20  # peer manifest may declare; an
    max_payload_bytes: int = 1 << 30  # oversize manifest is rejected
                                    # before any chunk is fetched
    rebuild_interval_blocks: int = 0  # rebuild the generation every N
                                    # accepted blocks (0: operator-driven
                                    # only)
    rebuild_jitter_blocks: int = 0  # per-node deterministic offset (from
                                    # the node's identity, 0..jitter)
                                    # added to the cadence, so a fleet
                                    # does not rebuild in lockstep


@dataclass
class CacheConfig:
    """Generation-anchored hot-state read cache (``state/hotcache.py``).
    Operational only: the cache serves byte-identical responses, so
    nodes with different cache settings stay bit-identical on the wire.
    All overridable as ``UPOW_CACHE_<FIELD>``."""

    enabled: bool = True
    class_cap_bytes: int = 8 * 1024 * 1024  # default LRU byte cap per
                                    # entry class (address/blocks/tx/...)
    class_caps: str = ""            # per-class overrides, e.g.
                                    # "address=16777216,blocks=4194304"
    max_entry_bytes: int = 1 * 1024 * 1024  # bodies above this are
                                    # served but never stored (one giant
                                    # page must not flush a whole class)
    revalidate_interval: float = 0.25  # seconds between re-anchoring the
                                    # generation against the shared DB
                                    # (tip hash + journal stamp) to catch
                                    # OTHER workers' writes; 0 = every
                                    # read, negative = never (sole-writer
                                    # process)

    def parsed_class_caps(self) -> dict:
        caps = {}
        for part in self.class_caps.split(","):
            name, _, raw = part.strip().partition("=")
            if name and raw:
                try:
                    caps[name] = int(raw)
                except ValueError:
                    raise ValueError(
                        f"cache.class_caps entry {part!r}: cap must be an"
                        f" integer byte count") from None
        return caps


@dataclass
class WsConfig:
    """The ``/ws`` push hub's limits (``ws/hub.py``); overridable as
    ``UPOW_WS_<FIELD>``."""

    enabled: bool = True
    max_connections: int = 1000
    max_per_user: int = 5
    max_message_bytes: int = 64 * 1024
    rate_limit_per_minute: int = 60
    heartbeat_interval: float = 30.0
    connection_expiry: float = 300.0
    cleanup_interval: float = 60.0  # idle-expiry sweep period
    send_queue_max: int = 256       # bounded per-subscriber send queue;
                                    # overflow sheds that subscriber's
                                    # oldest pending message
                                    # (drop-slowest) and counts it as
                                    # upow_ws_dropped_messages; 0 =
                                    # unbounded (never shed)
    channels: tuple = ("block", "transaction")


@dataclass
class ResilienceConfig:
    """Retries, deadlines and per-peer circuit breakers of outbound RPC,
    the device path's degrade (resilience/), and fault injection.
    Operational only: nodes with different settings stay bit-identical
    on chain state."""

    rpc_attempts: int = 3           # total tries per logical call
    rpc_backoff_base: float = 0.25  # first retry delay (seconds)
    rpc_backoff_max: float = 2.0    # per-retry delay ceiling
    rpc_backoff_multiplier: float = 2.0
    rpc_jitter: float = 0.5         # +/- fraction of each delay
    rpc_deadline: float = 45.0      # total budget per logical call
                                    # (attempts + backoffs); 0 = none
    propagate_deadline: float = 10.0  # per-peer bound on gossip sends
    breaker_failure_threshold: int = 5   # consecutive failures -> open
    breaker_open_secs: float = 30.0      # open -> half-open probe delay
    breaker_half_open_max: int = 1       # trial calls while half-open
    device_failure_limit: int = 3   # consecutive device verify errors
                                    # -> degraded (resilience/degrade.py)
    device_cooldown: float = 60.0   # degraded -> re-probe interval
    faults: str = ""                # fault spec (resilience/faultinject.py);
                                    # empty = no injection
    faults_seed: int = 0


@dataclass
class NodeConfig:
    host: str = "0.0.0.0"
    port: int = 3006                # reference run_node.py port
    db_backend: str = "sqlite"      # sqlite | postgres
    db_path: str = "upow_tpu.db"    # sqlite file ('' -> in-memory)
    pg_dsn: str = ""                # postgres DSN (db_backend=postgres):
                                    # an existing uPow database
                                    # (schema.sql); needs asyncpg
    seed_url: str = DEFAULT_SEED_URL  # the peer a fresh book starts from
    peers_file: str = "nodes.json"  # the peer book ('' -> not saved)
    ip_config_file: str = "ip_config.json"
    self_url: str = ""              # this node's URL: the Sender-Node of
                                    # its RPC; from the first request's
                                    # Host when empty
    trust_proxy_headers: bool = False  # take the client IP from
                                    # X-Forwarded-For / X-Real-IP
    max_peers: int = 100            # nodes_manager.py:26
    active_within: int = 7 * 86400  # a peer that messaged us this recently
                                    # is active (nodes_manager.py:24)
    prune_after: int = 90 * 86400   # forget peers silent this long (:25)
    propagate_sample: int = 10      # gossip sample per class (:144-149)
    response_cap: int = 20 * 1024 * 1024  # request body cap, and the
                                    # cap on a peer's response
    http_timeout: float = 30.0      # seconds for one request to a peer
    sync_reorg_window: int = 500    # main.py:167-185
    sync_page: int = 1000           # block download page (main.py:188-192)
    sync_fetch_interval: float = 1.7  # least seconds between get_blocks
                                    # fetches: the peer allows 40/min,
                                    # and the next page is prefetched
    mempool_clean_interval: int = 600  # main.py:678-683
    rate_limits_enabled: bool = True   # slowapi parity (main.py:55)


@dataclass
class LogConfig:
    """The logger (``logger.py``); overridable as ``UPOW_LOG_<FIELD>``."""

    path: str = "logs/app.log"
    level: str = "INFO"
    max_bytes: int = 5 * 1024 * 1024   # my_logger.py rotation size
    backups: int = 100
    console: bool = True
    json_format: bool = False       # JSONL records carrying trace_id


@dataclass
class TelemetryConfig:
    """Observability knobs (upow_tpu_torch/telemetry/): operational
    only, never consensus.  All overridable as
    ``UPOW_TELEMETRY_<FIELD>``."""

    trace_requests: bool = True     # root span per inbound HTTP request
    trace_recent: int = 32          # completed traces kept, recency ring
    trace_slowest: int = 16         # completed traces kept, slowest top-N
    max_trace_spans: int = 512      # span budget per trace tree
    events_buffer: int = 256        # /debug/events ring size
    max_metric_names: int = 1024    # cardinality cap per registry kind
    debug_endpoints: bool = True    # serve /debug/traces, /debug/events,
                                    # /debug/breakers
    instance_scope: bool = False    # per-node registries (several nodes
                                    # in one process); default keeps the
                                    # process globals


@dataclass
class WatchtowerConfig:
    """Streaming alerting engine (``watchtower/``): operational only,
    never consensus.  Overridable as ``UPOW_WATCHTOWER_<FIELD>``.

    Defaults describe the standing rule pack: verify-throughput
    collapse, mempool depth spike, sync lag, breaker flip storm, ws drop
    rate, device arm flaps, stuck block height, and per-route SLO burn
    rates.  Thresholds are deliberately conservative: a clean run fires
    no alert."""

    enabled: bool = False           # run the evaluation task on this node
    interval: float = 5.0           # evaluation cadence, seconds
    # SLO burn-rate (burnrate.py): canonical 5m/1h + 30m/6h pairs,
    # compressible for scenarios via window_scale.
    slo_target: float = 0.999
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    window_scale: float = 1.0
    # for-durations: fast rules page quickly, slow rules must sustain.
    for_fast: float = 15.0
    for_slow: float = 60.0
    # rule thresholds
    verify_min_rate: float = 1.0    # submissions/s EWMA floor before the
                                    # collapse rule may judge a drop
    verify_z: float = 6.0           # z-score magnitude for rate anomalies
    mempool_spike_ratio: float = 8.0
    mempool_spike_floor: float = 1000.0
    sync_lag_limit: float = 600.0   # seconds behind tip timestamp
    breaker_storm_window: float = 60.0
    breaker_storm_opens: int = 6    # breaker open transitions in window
    ws_drop_limit: float = 50.0     # dropped ws messages per second
    arm_flap_window: float = 600.0
    arm_flaps: int = 3              # degrade/arm-failure events in window
    stuck_height_deadline: float = 300.0
    history: int = 64               # firing/resolved transition ring
    bench_events: str = ""          # append alert_fired JSONL records to
                                    # this path


@dataclass
class ProfilingConfig:
    """Opt-in performance capture (upow_tpu_torch/profiling/): all off
    by default; overridable as ``UPOW_PROFILE_<FIELD>``."""

    enabled: bool = False           # serve /debug/profile (also requires
                                    # telemetry.debug_endpoints)
    trace_dir: str = "logs/jax_traces"  # capture output directory (the
                                    # JAX package's default; a
                                    # torch.profiler Chrome trace here)
    max_capture_seconds: float = 120.0  # auto-stop: a capture left
                                    # running past this is closed on the
                                    # next /debug/profile touch
    cost_analysis: bool = False     # record each kernel's counted work
                                    # (profiling.analyze_cost) next to
                                    # the compile-cache counters


@dataclass
class Config:
    device: DeviceConfig = field(default_factory=DeviceConfig)
    device_runtime: DeviceRuntimeConfig = field(
        default_factory=DeviceRuntimeConfig)
    node: NodeConfig = field(default_factory=NodeConfig)
    ws: WsConfig = field(default_factory=WsConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    snapshot: SnapshotConfig = field(default_factory=SnapshotConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    log: LogConfig = field(default_factory=LogConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    watchtower: WatchtowerConfig = field(default_factory=WatchtowerConfig)
    profile: ProfilingConfig = field(default_factory=ProfilingConfig)

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides) -> "Config":
        """File -> env -> kwargs, later wins (``node__port=3007``)."""
        cfg = cls()
        if path and os.path.exists(path):
            with open(path) as f:
                _merge_dict(cfg, json.load(f))
        for f in dataclasses.fields(cfg):
            _apply_env_fields(getattr(cfg, f.name), f.name)
        for key, value in overrides.items():
            section, _, fname = key.partition("__")
            if _unread(section, fname):
                continue
            if section not in JAX_SCHEMA:  # the JAX package's getattr
                raise AttributeError(
                    f"'Config' object has no attribute '{section}'")
            if fname not in JAX_SCHEMA[section]:
                raise KeyError(f"unknown config field {key}")
            setattr(getattr(cfg, section), fname, value)
        return cfg


def _unread(section: str, fname: str) -> bool:
    """A key of the JAX schema that the port does not read yet."""
    if fname not in JAX_SCHEMA.get(section, ()):
        return False
    sub = _SECTIONS.get(section)
    return sub is None or fname not in {f.name for f in dataclasses.fields(sub)}


_SECTIONS = {"device": DeviceConfig, "device_runtime": DeviceRuntimeConfig,
             "node": NodeConfig, "ws": WsConfig,
             "mempool": MempoolConfig, "cache": CacheConfig,
             "snapshot": SnapshotConfig,
             "resilience": ResilienceConfig, "log": LogConfig,
             "telemetry": TelemetryConfig, "watchtower": WatchtowerConfig,
             "profile": ProfilingConfig}


def _merge_dict(cfg: Config, data: dict) -> None:
    for section, values in data.items():
        if section not in JAX_SCHEMA:
            raise KeyError(f"unknown config section {section}")
        for fname, value in values.items():
            if fname not in JAX_SCHEMA[section]:
                raise KeyError(f"unknown config field {section}.{fname}")
            if _unread(section, fname):
                log.info("config field %s.%s is not read by the port yet",
                         section, fname)
                continue
            setattr(getattr(cfg, section), fname, value)


def _apply_env_fields(sub, section: str) -> None:
    """Apply ``UPOW_<SECTION>_<FIELD>`` env overrides onto one config
    dataclass instance (its fields are ints, floats, bools and strings)."""
    for f in dataclasses.fields(sub):
        env = f"UPOW_{section.upper()}_{f.name.upper()}"
        if env in os.environ:
            raw = os.environ[env]
            if f.type in ("int", int):
                value = int(raw)
            elif f.type in ("float", float):
                value = float(raw)
            elif f.type in ("bool", bool):
                value = raw.lower() in ("1", "true", "yes")
            else:
                value = raw
            setattr(sub, f.name, value)
