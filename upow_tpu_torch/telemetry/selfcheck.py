"""``python -m upow_tpu_torch.telemetry.selfcheck [--device cuda|cpu]``:
boot the port's node on a loopback port, scrape ``/metrics`` and run the
exposition validator — then boot a 3-node swarm, merge its per-node
scrapes into the ``upow_fleet_*`` families and validate those too.

The port's copy of the JAX package's ``telemetry/selfcheck.py``: it
fails when any exported name is illegal, any histogram's cumulative
buckets regress, the content type drifts from 0.0.4, a required metric
family disappears (single-node or fleet), or a /debug endpoint stops
returning well-formed JSON.  The node runs on the standard-library
server (``node/http.py``) on a free 127.0.0.1 port, where the JAX check
uses aiohttp's ``TestClient``, against an in-memory chain with no seed
and no peers; the swarm runs on the loopback hub.  Both run on
``--device``: the card by default, as every port entry point (without
one the check fails naming the missing card, and runs nothing on the
host); ``cpu`` runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile

from . import exposition

#: families the JAX check pins (substring match on /metrics)
REQUIRED = (
    "upow_kernel_p256_verify_occupancy_bucket",
    "upow_kernel_sha256_txid_occupancy_bucket",
    "upow_kernel_p256_verify_compile_cache_hits_total",
    "upow_kernel_p256_verify_compile_cache_misses_total",
    "upow_block_height",
    "upow_mempool_transactions",
    # the archive and alert families: zeros while those tiers are off,
    # so a bare node still carries them
    "upow_archive_segments",
    "upow_archive_archived_blocks",
    "upow_archive_archived_txs",
    "upow_archive_hot_rows_pruned",
    "upow_archive_fallthrough_reads",
    "upow_alert_firing",
    "upow_alert_pending",
    "upow_alert_silenced",
    "upow_alert_exemplars_firing",
    "upow_alert_eval_lag_seconds",
    "upow_alert_evaluations_total",
    "upow_alert_fired_total",
    "upow_alert_resolved_total",
    # incremental /debug/events cursor-loss counter (telemetry/events.py)
    "upow_telemetry_events_rotated_unseen_total",
)


#: families the merged fleet rendering must always carry
#: (substring match on the render_fleet output)
REQUIRED_FLEET = (
    "upow_fleet_nodes",
    "upow_fleet_height_spread",
    "upow_fleet_events_total",
    "upow_fleet_traces_total",
    "upow_fleet_block_propagation_p95_ms",
    "upow_fleet_block_propagation_seconds_bucket",
    "upow_fleet_tx_propagation_seconds_bucket",
)


async def _run(device) -> int:
    from ..config import Config
    from ..node.app import Node
    from ..node.http import fetch

    scratch = tempfile.mkdtemp(prefix="upow-metrics-check-")
    cfg = Config.load(
        node__db_path="",                 # in-memory chain
        node__seed_url="",                # no external seed
        node__peers_file=f"{scratch}/nodes.json",
        node__ip_config_file="",
        ws__enabled=False,
        device__sig_backend="host",
        log__console=False, log__path="")
    node = Node(cfg, device=device)
    server = await node.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    failures = []
    try:
        headers: dict = {}
        _status, body = await fetch(base + "/metrics",
                                    response_headers=headers)
        text = body.decode()
        ctype = headers.get("content-type", "")
        if ctype != exposition.CONTENT_TYPE:
            failures.append(
                f"content type {ctype!r} != {exposition.CONTENT_TYPE!r}")
        failures.extend(exposition.validate(text))
        for name in REQUIRED:
            if name not in text:
                failures.append(f"required metric missing: {name}")
        for path in ("/debug/traces", "/debug/events"):
            dstatus, dbody = await fetch(base + path)
            payload = json.loads(dbody)
            if dstatus != 200 or not payload.get("ok"):
                failures.append(f"{path} unhealthy: {payload}")
    finally:
        await node.close()
    if failures:
        for f in failures:
            print(f"metrics-check: FAIL {f}")
        return 1
    print(f"metrics-check: OK ({len(text.splitlines())} exposition lines,"
          f" {len(REQUIRED)} required families present)")
    return 0


async def _run_fleet(device) -> int:
    """Fleet half of the gate: 3 scoped nodes, one gossiped block, the
    merged ``upow_fleet_*`` rendering through the same validator."""
    from ..fleet import scrape
    from ..swarm.harness import Swarm
    from ..swarm.scenarios import _wallet, deterministic_world

    failures = []
    with deterministic_world(0):
        async def drive():
            swarm = await Swarm(3, seed=0, device=device).start()
            try:
                _, addr = _wallet(0, "metrics_check")
                res = await swarm.mine(0, addr)
                if not res.get("ok"):
                    failures.append(f"fleet bootstrap mine failed: {res}")
                await swarm.wait_converged()
                await swarm.settle()
                return await scrape.scrape(swarm)
            finally:
                await swarm.close()

        snapshot = await drive()
    for label, rec in snapshot["nodes"].items():
        if rec["metrics_status"] != 200:
            failures.append(f"{label} /metrics -> {rec['metrics_status']}")
        failures.extend(f"{label}: {v}"
                        for v in exposition.validate(rec["metrics_text"]))
    text = scrape.render_fleet(snapshot)
    failures.extend(f"fleet: {v}" for v in exposition.validate(text))
    for name in REQUIRED_FLEET:
        if name not in text:
            failures.append(f"required fleet metric missing: {name}")
    if failures:
        for f in failures:
            print(f"metrics-check: FAIL {f}")
        return 1
    print(f"metrics-check: OK fleet ({len(snapshot['nodes'])} nodes "
          f"merged, {len(text.splitlines())} exposition lines, "
          f"{len(REQUIRED_FLEET)} required fleet families present)")
    return 0


def main(argv=None) -> int:
    from ..device import resolve

    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.telemetry.selfcheck",
        description="exposition check of one node's /metrics and of "
                    "a 3-node swarm's merged fleet families")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the nodes run (default cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve(args.device)
    except RuntimeError as e:
        print(f"metrics-check: FAIL {e}")
        return 1
    rc = asyncio.run(_run(device))
    return rc or asyncio.run(_run_fleet(device))


if __name__ == "__main__":
    sys.exit(main())
