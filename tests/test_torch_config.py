"""``Config.load`` of the port against the JAX package's.

The same files, environments and keyword overrides go into both
packages' ``Config.load``; each must give the same values in every field
the port reads, or raise the same error with the same text.  A key of
the JAX schema that the port does not read yet is skipped; any other key
raises the JAX package's ``KeyError`` (``unknown config section <s>``,
``unknown config field <s>.<f>``), in a file and in an override alike.
The peer, gossip, resilience, degrade, device-runtime, log, telemetry,
profiling, read-cache, ``/ws``, watchtower, replace-by-fee, snapshot and
archive fields of the port's ``NodeConfig``, ``ResilienceConfig``,
``DeviceConfig``, ``DeviceRuntimeConfig``, ``LogConfig``,
``TelemetryConfig``, ``ProfilingConfig``, ``CacheConfig``, ``WsConfig``,
``WatchtowerConfig``, ``MempoolConfig``, ``SnapshotConfig`` and
``ArchiveConfig`` are held one by one, from a file and from
``UPOW_<SECTION>_<FIELD>``.
"""

import dataclasses
import json

import pytest

import upow_tpu.config as jconfig
import upow_tpu_torch.config as tconfig

NEW_FIELDS = [
    # section, field, a value that is not the default, its UPOW_* text
    ("node", "seed_url", "http://10.1.2.3:3006", "http://10.1.2.3:3006"),
    ("node", "peers_file", "peers/book.json", "peers/book.json"),
    ("node", "self_url", "http://10.0.0.9:3006", "http://10.0.0.9:3006"),
    ("node", "trust_proxy_headers", True, "true"),
    ("node", "max_peers", 7, "7"),
    ("node", "active_within", 3600, "3600"),
    ("node", "prune_after", 7200, "7200"),
    ("node", "propagate_sample", 3, "3"),
    ("resilience", "rpc_attempts", 5, "5"),
    ("resilience", "rpc_backoff_base", 0.5, "0.5"),
    ("resilience", "rpc_backoff_max", 4.0, "4.0"),
    ("resilience", "rpc_backoff_multiplier", 3.0, "3"),
    ("resilience", "rpc_jitter", 0.1, "0.1"),
    ("resilience", "rpc_deadline", 12.5, "12.5"),
    ("resilience", "propagate_deadline", 2.0, "2"),
    ("resilience", "breaker_failure_threshold", 2, "2"),
    ("resilience", "breaker_open_secs", 1.5, "1.5"),
    ("resilience", "breaker_half_open_max", 3, "3"),
    ("resilience", "faults", "rpc:error:p=0.5;rpc.push_tx:latency:delay=0.1",
     "rpc:error:p=0.5;rpc.push_tx:latency:delay=0.1"),
    ("resilience", "faults_seed", 9, "9"),
    ("resilience", "device_failure_limit", 9, "9"),
    ("resilience", "device_cooldown", 1.0, "1.0"),
    ("device", "verify_pad_block", 64, "64"),
    ("device", "verify_device_timeout", 30.0, "30"),
    ("device_runtime", "arm_timeout", 5.0, "5"),
    ("device_runtime", "aot_warm", False, "0"),
    ("device_runtime", "weights", "block=8,mine=1", "block=8,mine=1"),
    ("device_runtime", "queue_max", 16, "16"),
    ("device_runtime", "max_coalesce", 4, "4"),
    ("log", "path", "", ""),
    ("log", "level", "DEBUG", "DEBUG"),
    ("log", "max_bytes", 1024, "1024"),
    ("log", "backups", 2, "2"),
    ("log", "console", False, "0"),
    ("log", "json_format", True, "true"),
    ("telemetry", "trace_requests", False, "0"),
    ("telemetry", "trace_recent", 4, "4"),
    ("telemetry", "trace_slowest", 3, "3"),
    ("telemetry", "max_trace_spans", 64, "64"),
    ("telemetry", "events_buffer", 8, "8"),
    ("telemetry", "max_metric_names", 99, "99"),
    ("telemetry", "debug_endpoints", False, "false"),
    ("telemetry", "instance_scope", True, "1"),
    ("profile", "enabled", True, "1"),
    ("profile", "trace_dir", "prof/out", "prof/out"),
    ("profile", "max_capture_seconds", 5.0, "5"),
    ("profile", "cost_analysis", True, "yes"),
    ("cache", "enabled", False, "0"),
    ("cache", "class_cap_bytes", 4096, "4096"),
    ("cache", "class_caps", "address=100,blocks=200", "address=100,blocks=200"),
    ("cache", "max_entry_bytes", 512, "512"),
    ("cache", "revalidate_interval", -1.0, "-1"),
    ("ws", "enabled", False, "false"),
    ("ws", "max_connections", 3, "3"),
    ("ws", "max_per_user", 2, "2"),
    ("ws", "max_message_bytes", 1024, "1024"),
    ("ws", "rate_limit_per_minute", 7, "7"),
    ("ws", "heartbeat_interval", 2.5, "2.5"),
    ("ws", "connection_expiry", 9.0, "9"),
    ("ws", "cleanup_interval", 0.5, "0.5"),
    ("ws", "send_queue_max", 0, "0"),
    ("watchtower", "enabled", True, "1"),
    ("watchtower", "interval", 0.5, "0.5"),
    ("watchtower", "slo_target", 0.99, "0.99"),
    ("watchtower", "fast_burn", 10.0, "10"),
    ("watchtower", "slow_burn", 3.0, "3"),
    ("watchtower", "window_scale", 0.01, "0.01"),
    ("watchtower", "for_fast", 1.0, "1"),
    ("watchtower", "for_slow", 2.0, "2"),
    ("watchtower", "verify_min_rate", 5.0, "5"),
    ("watchtower", "verify_z", 3.0, "3"),
    ("watchtower", "mempool_spike_ratio", 4.0, "4"),
    ("watchtower", "mempool_spike_floor", 10.0, "10"),
    ("watchtower", "sync_lag_limit", 60.0, "60"),
    ("watchtower", "breaker_storm_window", 30.0, "30"),
    ("watchtower", "breaker_storm_opens", 2, "2"),
    ("watchtower", "ws_drop_limit", 5.0, "5"),
    ("watchtower", "arm_flap_window", 60.0, "60"),
    ("watchtower", "arm_flaps", 1, "1"),
    ("watchtower", "stuck_height_deadline", 30.0, "30"),
    ("watchtower", "history", 8, "8"),
    ("watchtower", "bench_events", "events.jsonl", "events.jsonl"),
    ("mempool", "allow_rbf", True, "1"),
    ("snapshot", "dir", "snapshots", "snapshots"),
    ("snapshot", "chunk_bytes", 4096, "4096"),
    ("snapshot", "blocks_tail", 8, "8"),
    ("snapshot", "keep", 3, "3"),
    ("snapshot", "chunk_retries", 0, "0"),
    ("snapshot", "max_chunks", 64, "64"),
    ("snapshot", "max_chunk_bytes", 1024, "1024"),
    ("snapshot", "max_payload_bytes", 65536, "65536"),
    ("snapshot", "rebuild_interval_blocks", 10, "10"),
    ("snapshot", "rebuild_jitter_blocks", 4, "4"),
    ("archive", "dir", "archive", "archive"),
    ("archive", "segment_blocks", 5, "5"),
    ("archive", "safety_window", 8, "8"),
    ("archive", "reader_cache_segments", 2, "2"),
    ("archive", "max_segment_bytes", 1 << 20, "1048576"),
    ("archive", "max_segments", 16, "16"),
]


def _load(pkg, path=None, **overrides):
    """("ok", every port-read field's value) or (error type, text)."""
    try:
        cfg = pkg.Config.load(path, **overrides)
    except (KeyError, AttributeError) as e:
        return type(e).__name__, str(e)
    return "ok", {(s.name, f.name): getattr(getattr(cfg, s.name), f.name)
                  for s in dataclasses.fields(tconfig.Config)
                  for f in dataclasses.fields(getattr(cfg, s.name))}


def _both(tmp_path, data=None, **overrides):
    path = None
    if data is not None:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(data))
        path = str(path)
    got = _load(tconfig, path, **overrides)
    want = _load(jconfig, path, **overrides)
    assert got[0] == want[0]
    if got[0] == "ok":
        diff = {k: (v, want[1][k]) for k, v in got[1].items()
                if v != want[1][k]}
        assert not diff
    else:
        assert got == want
    return got


@pytest.mark.parametrize("data, error", [
    ({"node": {"prot": 3007}}, "'unknown config field node.prot'"),
    ({"bogus": {"x": 1}}, "'unknown config section bogus'"),
    ({"node": {"port": 3007}, "mempool": {"nope": 1}},
     "'unknown config field mempool.nope'"),
    ({"snapshot": {"dir": "s", "nope": 1}},
     "'unknown config field snapshot.nope'"),
])
def test_unknown_key_in_a_file_raises_the_jax_error(tmp_path, data, error):
    assert _both(tmp_path, data) == ("KeyError", error)


@pytest.mark.parametrize("overrides, want", [
    ({"node__prot": 3007}, ("KeyError", "'unknown config field node__prot'")),
    ({"snapshot__nope": 1},
     ("KeyError", "'unknown config field snapshot__nope'")),
    ({"bogus__x": 1},
     ("AttributeError", "'Config' object has no attribute 'bogus'")),
])
def test_unknown_override_raises_the_jax_error(tmp_path, overrides, want):
    assert _both(tmp_path, **overrides) == want


@pytest.mark.parametrize("how", ["file", "override"])
@pytest.mark.parametrize("section, field, value", [
    ("miner", "workers", 2),
    ("miner", "ttl", 30),
    ("device", "device", "cpu"),
    ("mempool", "enabled", False),
    ("device_runtime", "compile_cache_dir", "cache"),
    ("device", "search_backend", "jnp"),
    ("miner", "node_url", "http://127.0.0.1:3006"),
])
def test_known_key_the_port_does_not_read_is_skipped(tmp_path, how, section,
                                                     field, value):
    if how == "file":
        status, values = _both(tmp_path, {section: {field: value},
                                          "node": {"port": 3111}})
        assert values[("node", "port")] == 3111
    else:
        status, values = _both(tmp_path, **{f"{section}__{field}": value})
    assert status == "ok" and (section, field) not in values


@pytest.mark.parametrize("section, field, value, raw", NEW_FIELDS,
                         ids=[f"{s}.{f}" for s, f, _v, _r in NEW_FIELDS])
def test_new_field_from_a_file(tmp_path, section, field, value, raw):
    status, values = _both(tmp_path, {section: {field: value}})
    assert status == "ok" and values[(section, field)] == value


@pytest.mark.parametrize("section, field, value, raw", NEW_FIELDS,
                         ids=[f"{s}.{f}" for s, f, _v, _r in NEW_FIELDS])
def test_new_field_from_the_environment(tmp_path, monkeypatch, section,
                                        field, value, raw):
    monkeypatch.setenv(f"UPOW_{section.upper()}_{field.upper()}", raw)
    status, values = _both(tmp_path)
    assert status == "ok" and values[(section, field)] == value


def test_defaults_are_the_jax_defaults(tmp_path):
    status, values = _both(tmp_path)
    assert status == "ok"
    assert values[("node", "seed_url")] == jconfig.DEFAULT_SEED_URL
    assert tconfig.DEFAULT_SEED_URL == jconfig.DEFAULT_SEED_URL


def test_schema_is_the_jax_schema():
    """The port's copy of the JAX section and field names."""
    jax = jconfig.Config()
    want = {s.name: tuple(f.name for f in dataclasses.fields(
        getattr(jax, s.name))) for s in dataclasses.fields(jax)}
    assert tconfig.JAX_SCHEMA == want


def test_runtime_weights_parse_as_the_jax_ones():
    for text in ("block=4, mine = 1,bad", tconfig.DeviceRuntimeConfig.weights,
                 "a=0,b=-3,c=7"):
        got = tconfig.DeviceRuntimeConfig(weights=text).parsed_weights()
        assert got == jconfig.DeviceRuntimeConfig(
            weights=text).parsed_weights()
    with pytest.raises(ValueError, match="must be an integer"):
        tconfig.DeviceRuntimeConfig(weights="block=x").parsed_weights()
