"""A solo miner and its node on one card (``kind: solo_miner``).

The configuration gives the chain (``height``, ``difficulty``, the
wallets' fan-out) and the miner's round (``miner_batch``); the node is
the port's ``node.run --device cuda`` on the generated chain, the miner
the port's CLI in ``miner_shim``.  Set-up ends when the miner begins its
second template, or, where the mix sends wallets' transactions
(``rate``), ``warmup_s`` after they begin; the window is the next
``--seconds``.  Once it has closed, the miner mines a sample of the
window's rounds again at a lower difficulty (``common.close_window``).
"""

from __future__ import annotations

import time
from decimal import Decimal

import math
import sys

from .. import chain, minerlog, procs, reference, wallets
from ..harness import Obs, Run
from . import common


def run(run: Run) -> Obs:
    cfg = run.cfg
    obs = Obs()
    solo = chain.solo_chain(run.seed, cfg["height"], Decimal(cfg["difficulty"]),
                            cfg["n_fan"], cfg["per_fan"], cfg["wallets"])
    blocks, key = solo.blocks, solo.miner
    db = run.work / "chain.db"
    chain.write_db(db, blocks)
    env = common.node_env(run, "node")
    if run.traffic.get("node_variant"):
        env["PORTBENCH_VARIANT"] = run.traffic["node_variant"]
    node, url = procs.start_node("node", run.root, run.work, db, run.device, env)
    miner = sender = None
    mix = run.traffic
    if mix.get("rate"):
        requests = wallets.schedule(solo, mix, mix["warmup_s"] + run.seconds,
                                    run.seed)
        sender = wallets.Sender(url, requests, mix["connections"])
    captures = common.Captures(run, {"node": url})
    final_tip = None
    try:
        procs.wait_ready(node, url, time.monotonic() + common.BUILD_GRACE)
        if run.trace:
            captures.prime()
        miner = common.start_miner(run, key.address, url,
                                   run.traffic.get("miner_variant", ""))
        obs.t0 = common.wait_templates(miner, 2, time.monotonic()
                                       + common.BUILD_GRACE)
        if sender is not None:
            start_at = time.monotonic()
            obs.t0 = start_at + mix["warmup_s"]
            sender.start(start_at, obs.t0 + run.seconds)
            time.sleep(max(0.0, obs.t0 - time.monotonic()))
        obs.e2e["setup_s"] = obs.t0 - run.t_entry
        before = procs.scrape(url) if run.trace else {}
        if run.trace:
            captures.start()
        obs.t1 = obs.t0 + run.seconds
        time.sleep(max(0.0, obs.t1 - time.monotonic()))
        if run.trace:
            obs.scrapes["node"] = (before, procs.scrape(url))
            captures.stop()
        obs.card = run.sampler.summary(obs.t0, obs.t1)
        if run.trace:
            captures.wait_miner(miner)
        if sender is not None:
            sender.join(obs.t1 + 60.0)
        plan = common.close_window(obs, run, miner, {"node": node})
    finally:
        if miner is not None:
            miner.stop()
        try:
            final_tip = procs.get_json(url + "get_mining_info", timeout=30)[
                "result"]["last_block"]
        except (OSError, ValueError, KeyError):
            final_tip = None
        node.stop()
    log = minerlog.parse(miner.lines, cfg["miner_batch"])
    obs.e2e["hash_rate"] = (minerlog.hashes_between(log, obs.t0, obs.t1)
                            / (obs.t1 - obs.t0) / 1e6)
    obs.extra["miner_log"] = log
    tip = blocks[-1]
    by_height = {b.height: {"id": b.height, "hash": b.hash,
                            "timestamp": b.timestamp,
                            "difficulty": b.difficulty} for b in blocks}
    pool = None
    if sender is not None:
        def pool(tpl, mined):
            a, b = tpl.fetch or (tpl.t, tpl.t)
            return wallets.pool_at(sender.requests, a, b, mined)
    t_ref = time.monotonic()
    obs.attempted = reference.judge_miner(
        log, obs.t0, obs.t1, by_height[tip.height], key.address, pool,
        final_tip, cfg["miner_batch"], run.device, obs.checks, by_height)
    reference.judge_rechecks(plan, log.rechecks, run.device, obs.checks)
    print(f"portbench: the reference judged {len(log.templates)} templates "
          f"and {len(plan['rounds'])} rounds mined again in "
          f"{time.monotonic() - t_ref:.3f} s", file=sys.stderr)
    obs.failed = sum(obs.t0 <= t <= obs.t1 for t, _l in log.errors)
    if sender is not None:
        lat = wallets.latencies(sender.requests, sender.start_at, obs.t0, obs.t1)
        p95 = wallets.p95(lat)
        if p95 is not None and math.isfinite(p95):
            obs.e2e["admit_p95_ms"] = 1000.0 * p95
        wallets.judge(sender.requests, sender.start_at, obs.t1, obs.checks)
        obs.attempted += len(lat)
        obs.failed += sum(not math.isfinite(v) for v in lat)
        late = wallets.lateness(sender.requests, sender.start_at)
        obs.extra["wallets"] = {"requests": len(lat), "late": late}
        obs.extra["sender"], obs.extra["start_at"] = sender.requests, sender.start_at
        print(f"portbench: wallets: {len(lat)} requests due in the window, "
              f"admit p95 {p95}, the senders ran late by {late}",
              file=sys.stderr)
    if run.trace:
        in_window = [tpl for tpl in log.templates if tpl.t >= obs.t0]
        tpl = (in_window or log.templates)[-1]
        head = reference.uformat.split_header(tpl.prefix.hex() + "00" * 4)
        common.traced(obs, run, captures.load(),
                      common.profile_span(miner.lines),
                      common.miner_marks(miner.lines), tpl.prefix,
                      head["prev"], head["difficulty"])
    return obs
