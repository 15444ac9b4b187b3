"""Mining client CLI — wire-compatible with the reference miner.

Usage:
    python -m upow_tpu_torch.mine.miner <address> [--device cuda|cpu|mesh|...]
                                        [--node URL] [--batch N] [--ttl S]
                                        [--shard i/k] [--once]
                                        [--metrics-port N]

Protocol (miner.py:126-156): GET {node}/get_mining_info → build a template
(merkle over ALL pending tx hashes, miner.py:15-18,68), search nonces, POST
{node}/push_block {block_content, txs, block_no}.  The ``--shard i/k`` flag
assigns this process the i-th of k disjoint nonce ranges — the multi-GPU /
multi-host scale-out story (each shard is one device or one host; no
communication needed until a hit).

``--device cuda`` (the default) searches with the hand-written kernel on
the card and raises without one; ``--device cpu`` runs the C++ host loop
(``native``), or the kernel's plain PyTorch version (``torch``) where no
g++ builds the native library; ``--device mesh`` splits each round over
``device.mesh_devices`` cards (``UPOW_DEVICE_MESH_DEVICES``, 0 = all
visible).  With
``UPOW_COORDINATOR_ADDRESS`` (and ``WORLD_SIZE``, ``RANK``) set and no
``--shard``, the process joins a ``torch.distributed`` run and mines its
slot of the plan.

``--metrics-port N`` (default 0: off, no socket and no thread) serves the
miner's telemetry on port N (``endpoint.py``): ``/metrics``,
``/debug/traces`` and, with ``UPOW_PROFILE_ENABLED=1``,
``/debug/profile?action=start|stop|status``.  A rig's Prometheus scrapes
the card's rate (``upow_mine_hashes_total``), the dry hand-offs
(``upow_mine_rounds_dry_total`` against ``upow_mine_rounds_total``), the
card's idle time between rounds on the device clock
(``upow_mine_round_gap_handoff`` and ``_refresh``, seconds), the host's
time a dispatch (``upow_mine_round_dispatch``) and the runtime's queue
wait (``upow_runtime_queue_wait_mine``), the templates (mined and
expired, the fetch's and the build's spans) and the blocks pushed and
accepted.  Workers (``<address> <N>``) serve on N + i, one port a worker.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

from .. import telemetry
from ..core.clock import timestamp
from ..core.merkle import miner_merkle_root
from .engine import MiningJob, check_search_backend, mine, preregister

GENESIS_PREV_HASH = (18_884_643).to_bytes(32, "little").hex()  # miner.py:37-40
# backends whose rounds are tensor dispatches: watched and supervised
TENSOR_BACKENDS = ("cuda", "torch", "mesh")


def _http_json(url: str, payload: Optional[dict] = None, timeout: float = 20.0) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json"} if payload is not None else {},
        method="POST" if payload is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def fetch_mining_info(node: str) -> dict:
    res = _http_json(node + "get_mining_info")
    if "result" not in res:  # readable node error, not KeyError
        raise RuntimeError(f"node error: {res.get('error', res)!s:.200}")
    return res["result"]


def build_job(info: dict, address: str) -> tuple:
    last_block = dict(info["last_block"])
    last_block.setdefault("hash", GENESIS_PREV_HASH)
    last_block.setdefault("id", 0)
    pending_hashes = info["pending_transactions_hashes"]
    job = MiningJob.from_header_fields(
        previous_hash=last_block["hash"],
        address=address,
        merkle_root=miner_merkle_root(pending_hashes),
        timestamp=timestamp(),
        difficulty=info["difficulty"],
    )
    return job, pending_hashes, last_block["id"] + 1


def push_block(node: str, block_content: str, txs: list, block_no: int) -> dict:
    return _http_json(
        node + "push_block",
        {"block_content": block_content, "txs": txs, "block_no": block_no},
        timeout=20 + len(txs) // 3,
    )


def select_backend(device: str) -> str:
    """``--device`` -> search backend: ``cuda``/``gpu`` the kernel,
    ``cpu`` the native C++ loop (its plain PyTorch version where the
    native library does not build), or an explicit backend name
    (``cuda|torch|mesh|native|python``)."""
    if device == "gpu":
        return "cuda"
    if device == "cpu":
        from .. import native

        return "native" if native.load() is not None else "torch"
    try:
        return check_search_backend(device)
    except ValueError:
        raise SystemExit(f"unknown device {device!r}") from None


def _runtime_arm_reason() -> Optional[str]:
    """The device runtime's recorded ``arm_failure_reason``, read WITHOUT
    blocking: the watchdog fires exactly when dispatches are stuck, so it
    must not wait on an arm.  None when no runtime recorded one."""
    from ..device import runtime

    return runtime.arm_failure_reason()


#: watchdog exit codes the supervisor decodes in its respawn log
RC_HANG = 3        # stale heartbeat, backend had armed (device hang)
RC_ARM_FAILED = 4  # stale heartbeat AND the runtime recorded an arm failure


def _start_hang_watchdog(heartbeat: dict, limit: float, _exit=None):
    """A device dispatch that never returns (a wedged card) hangs, so
    the in-loop TTL check can never fire.  This thread hard-exits the
    process when the heartbeat goes stale; the supervisor (reference
    miner.py:149-156's outer watchdog) respawns a fresh process — the
    only reliable recovery once a thread is stuck inside a CUDA call.

    When the device runtime recorded a structured arm failure, the exit
    message carries that actual reason (and the exit status becomes
    ``RC_ARM_FAILED``) instead of the generic device-hang guess.

    ``heartbeat['limit']`` (optional) overrides ``limit`` — the caller
    raises it for the first round (the kernel's first build can exceed
    the steady-state budget) and drops it once progress ticks.
    """
    import os
    import threading

    _exit = _exit or os._exit

    def watch():
        while True:
            time.sleep(min(5.0, limit / 4))
            lim = heartbeat.get("limit", limit)
            if time.monotonic() - heartbeat["t"] > lim:
                reason = _runtime_arm_reason()
                if reason:
                    print(f"no mining progress for {lim:.0f}s — backend "
                          f"arm failure: {reason}; exiting for respawn",
                          file=sys.stderr, flush=True)
                    _exit(RC_ARM_FAILED)
                else:
                    print(f"no mining progress for {lim:.0f}s — device "
                          "hang? exiting for respawn",
                          file=sys.stderr, flush=True)
                    _exit(RC_HANG)
                # os._exit never returns; a test's substitute does — stop
                # so the thread doesn't keep printing for the rest of the
                # process lifetime
                return

    t = threading.Thread(target=watch, daemon=True, name="miner-watchdog")
    t.start()
    return t


def run(address: str, node: str, device: str = "cuda", batch: int = 1 << 24,
        ttl: float = 90.0, shard: tuple = (0, 1), once: bool = False,
        mesh_devices: int = 0, hang_grace: float = 90.0,
        first_round_grace: float = 240.0, metrics_port: int = 0) -> int:
    backend = select_backend(device)
    i, k = shard
    from ..parallel.multihost import plan_nonce_ranges

    lo, hi = plan_nonce_ranges(k)[i]
    print(f"upow_tpu_torch miner: backend={backend} shard={i}/{k} "
          f"nonces=[{lo}, {hi}) node={node}")
    preregister()
    endpoint = None
    if metrics_port:  # 0 opens nothing
        from ..config import Config
        from .endpoint import MinerEndpoint

        cfg = Config.load()
        endpoint = MinerEndpoint(metrics_port, cfg.telemetry, cfg.profile)
    # first round gets extra headroom: the kernel's first nvcc build can
    # legitimately exceed the steady-state ttl+grace budget
    heartbeat = {"t": time.monotonic(),
                 "limit": ttl + hang_grace + first_round_grace}
    if backend in TENSOR_BACKENDS and not once:
        _start_hang_watchdog(heartbeat, ttl + hang_grace)
    try:
        while True:
            heartbeat["t"] = time.monotonic()
            rc = _mine_template(address, node, backend, lo, hi, batch, ttl,
                                mesh_devices, heartbeat, ttl + hang_grace)
            if rc is not None and once:
                return rc
    finally:
        if endpoint is not None:
            endpoint.close()


def _mine_template(address: str, node: str, backend: str, lo: int, hi: int,
                   batch: int, ttl: float, mesh_devices: int,
                   heartbeat: dict, steady_limit: float) -> Optional[int]:
    """One template: fetch, build, mine, and push a found block.  None
    when the node could not be reached; else what ``--once`` exits
    with (0 for an accepted block).  The fetch and the build are one
    ``mine.template`` trace and a push is a ``mine.push_block`` trace;
    the rounds between belong to none (a tree would take one
    ``runtime.dispatch`` span a round)."""
    with telemetry.request_trace("mine.template"):
        try:
            with telemetry.span("mine.template_fetch"):
                info = fetch_mining_info(node)
        except (urllib.error.URLError, OSError, ValueError,
                RuntimeError) as e:
            # RuntimeError carries a node error envelope (syncing,
            # rate-limited) — transient, retry like unreachable
            print(f"node unreachable: {e}; retrying", file=sys.stderr)
            time.sleep(1)
            return None
        with telemetry.span("mine.template_build"):
            job, pending_hashes, block_no = build_job(info, address)
    telemetry.inc("mine.templates")
    print(f"difficulty: {info['difficulty']}  block: {block_no}  "
          f"confirming {len(pending_hashes)} transactions")

    def progress(tried, elapsed):
        heartbeat["t"] = time.monotonic()
        heartbeat["limit"] = steady_limit  # built: steady budget
        print(f"{tried / elapsed / 1e6:.2f} MH/s ({tried} hashes)")

    result = mine(job, backend, start=lo, stride_end=hi, batch=batch,
                  ttl=ttl, progress=progress, mesh_devices=mesh_devices)
    if result.nonce is None:
        telemetry.inc("mine.templates_expired")
        print(f"template expired after {result.hashes_tried} hashes; refreshing")
        return 1
    content = job.block_content(result.nonce)
    print(f"found nonce {result.nonce} at {result.hashrate / 1e6:.2f} MH/s")
    telemetry.inc("mine.blocks_pushed")
    try:
        with telemetry.request_trace("mine.push_block"):
            reply = push_block(node, content, pending_hashes, block_no)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"push_block failed: {e}", file=sys.stderr)
        reply = {"ok": False}
    print(reply)
    if reply.get("ok"):
        telemetry.inc("mine.blocks_accepted")
        print("BLOCK MINED\n")
    return 0 if reply.get("ok") else 1


def _reap(procs, timeout: float = 5.0) -> None:
    import subprocess

    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _child_cmd(args, metrics_port: int = 0) -> list:
    """Base child command shared by the supervisor and the worker fan-out
    (one home so new flags cannot silently diverge), serving its
    endpoint on ``metrics_port`` (0: none).  The child is this package's
    miner, never the JAX package's."""
    cmd = [sys.executable, "-m", "upow_tpu_torch.mine.miner", args.address,
           "--node", args.node, "--device", args.device,
           "--batch", str(args.batch), "--ttl", str(args.ttl)]
    if metrics_port:
        cmd += ["--metrics-port", str(metrics_port)]
    return cmd


def _supervise(args) -> int:
    """Respawn loop for tensor-backend miners (reference miner.py:149-156):
    restart the mining child whenever it exits — watchdog hang-exit (rc 3),
    crash, or backend failure — with a short backoff."""
    import os
    import subprocess

    env = dict(os.environ, UPOW_MINER_CHILD="1")
    cmd = _child_cmd(args, args.metrics_port) + ["--shard", args.shard]
    child = None
    rc_meaning = {
        RC_HANG: "watchdog: device hang (backend had armed)",
        RC_ARM_FAILED: "watchdog: backend arm failure — the child's "
                       "stderr above has the structured reason",
    }
    try:
        while True:
            child = subprocess.Popen(cmd, env=env)
            rc = child.wait()
            if rc == 0:
                return 0
            detail = rc_meaning.get(rc, "crash or backend failure")
            print(f"miner child exited rc={rc} ({detail}); "
                  "respawning in 5s", file=sys.stderr, flush=True)
            child = None
            time.sleep(5)
    except KeyboardInterrupt:
        if child is not None:
            child.terminate()
            try:
                child.wait(timeout=5)
            except subprocess.TimeoutExpired:
                child.kill()
        return 130


def _run_workers(args) -> int:
    """Reference-style multi-process fan-out (miner.py:126-156): worker i
    takes contiguous shard i/N.  CPU path only — one process drives a
    whole card, so fanning out there would just contend for it."""
    import subprocess

    if args.device in ("cuda", "gpu", "mesh"):
        print("workers>1 with --device cuda or mesh would have every "
              "process fight over the cards; use --device cpu, or give each "
              "card or host its own --shard i/k (or UPOW_COORDINATOR_"
              "ADDRESS)", file=sys.stderr)
        return 2
    import os

    procs = []
    # workers are leaf miners: the child marker stops each one becoming a
    # nested supervisor (which would mask failures and orphan grandchildren)
    env = dict(os.environ, UPOW_MINER_CHILD="1")
    for i in range(args.workers):
        # one endpoint a worker: N + i
        cmd = _child_cmd(args, args.metrics_port + i
                         if args.metrics_port else 0)
        if args.once:
            cmd.append("--once")
        procs.append(subprocess.Popen(
            cmd + ["--shard", f"{i}/{args.workers}"], env=env))
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c == 0 for c in codes):
                _reap(procs)  # first finder wins; stop the losers
                return 0
            if all(c is not None for c in codes):
                return max(codes)
            time.sleep(0.2)
    except KeyboardInterrupt:
        _reap(procs)
        return 130


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="uPow miner on an NVIDIA card")
    ap.add_argument("address")
    ap.add_argument("workers", nargs="?", type=int, default=0,
                    help="reference-compatible positional: spawn N host "
                         "processes on disjoint nonce shards "
                         "(miner.py:126-156); 0 = single process")
    ap.add_argument("node_pos", nargs="?", default=None,
                    help="reference-compatible positional node URL")
    ap.add_argument("--node", default="http://localhost:3006/")
    ap.add_argument("--device", default="cuda",
                    help="cuda|gpu|cpu or explicit backend "
                         "cuda|torch|mesh|native|python")
    ap.add_argument("--batch", type=int, default=0,
                    help="nonces per dispatch (0 = config device.search_batch)")
    ap.add_argument("--ttl", type=float, default=90.0)
    ap.add_argument("--shard", default="0/1", help="i/k disjoint nonce-range shard")
    ap.add_argument("--once", action="store_true", help="mine a single template and exit")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics, /debug/traces and (profile."
                         "enabled) /debug/profile on this port; 0 = off")
    args = ap.parse_args(argv)
    from ..config import Config

    cfg = Config.load()
    if args.batch <= 0:
        args.batch = cfg.device.search_batch
    if args.node_pos:
        args.node = args.node_pos
    if args.workers > 1:
        return _run_workers(args)
    import os

    if (not args.once and select_backend(args.device) in TENSOR_BACKENDS
            and not os.environ.get("UPOW_MINER_CHILD")):
        # tensor backends run supervised: the hang watchdog hard-exits a
        # child stuck in a dispatch, and this loop respawns it (the
        # reference's outer watchdog, miner.py:149-156)
        return _supervise(args)
    i, k = (int(x) for x in args.shard.split("/"))
    if not 0 <= i < k:
        raise SystemExit("--shard must be i/k with 0 <= i < k")
    if (i, k) == (0, 1):
        # multi-host run (UPOW_COORDINATOR_ADDRESS set): each process
        # takes its slot in the deterministic nonce plan
        from ..parallel import multihost

        if multihost.initialize():
            i, k = multihost.process_slot()
            print(f"distributed mining: process {i}/{k}")
    node = args.node.rstrip("/") + "/"
    return run(args.address, node, args.device, args.batch, args.ttl,
               shard=(i, k), once=args.once,
               mesh_devices=cfg.device.mesh_devices,
               metrics_port=args.metrics_port)


if __name__ == "__main__":
    raise SystemExit(main())
