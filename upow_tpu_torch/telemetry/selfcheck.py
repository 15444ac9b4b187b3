"""``python -m upow_tpu_torch.telemetry.selfcheck``: boot the port's
node on a loopback port, scrape ``/metrics`` and run the exposition
validator.

The port's copy of the single-node half of the JAX package's
``telemetry/selfcheck.py`` (its ``_run``): it fails when any exported
name is illegal, any histogram's cumulative buckets regress, the content
type drifts from 0.0.4, a required metric family disappears, or a
/debug endpoint stops returning well-formed JSON.  The node runs on the
standard-library server (``node/http.py``) on a free 127.0.0.1 port,
where the JAX check uses aiohttp's ``TestClient``, against an in-memory
chain on the CPU with no seed and no peers.  The fleet half
(``_run_fleet``: three nodes, one gossiped block, the merged
``upow_fleet_*`` families) waits for ``fleet/``'s scraper, which comes
with the swarm's scenarios (ROADMAP.md, A13f).
"""

from __future__ import annotations

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


async def _run() -> int:
    from ..config import Config
    from ..node.app import Node
    from ..node.http import fetch

    scratch = tempfile.mkdtemp(prefix="upow-metrics-check-")
    cfg = Config.load(
        node__db_path="",                 # in-memory chain
        node__seed_url="",                # no external seed
        node__peers_file=f"{scratch}/nodes.json",
        node__ip_config_file="",
        device__sig_backend="host",
        log__console=False, log__path="")
    node = Node(cfg, device="cpu")
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


def main() -> int:
    return asyncio.run(_run())


if __name__ == "__main__":
    sys.exit(main())
