"""A mining rig whose node catches up full blocks (``kind: mining_rig``).

The rig's miner (the port's CLI in ``miner_shim``) sweeps templates at
the configuration's difficulty from the stub, which stands in for its
pool and for the node's peer.  Node C (the port's ``node.run``) starts
on the chain's fan-out prefix and syncs the full blocks from the stub.

The first full block is served tampered once, alone in its page (one
signature changed): C must refuse it, and its sync, asked again, takes
the honest chain.  Set-up runs through C's first honest page: the window
opens when C commits that page's last block, on a page boundary in
every run, and runs ``--seconds``.  Commits are read from C's chain file, which
sqlite lets the harness read while C writes.
"""

from __future__ import annotations

import random
import sys
import sqlite3
import threading
import time
from decimal import Decimal
from typing import List, Optional, Tuple

from .. import chain, minerlog, procs, reference, stub, uformat
from ..harness import Obs, Run
from . import common


class TipWatch:
    """C's committed height as it moves, from a read-only connection."""

    def __init__(self, db_path, period: float = 0.02):
        self.path, self.period = db_path, period
        self.commits: List[Tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> "TipWatch":
        self._thread.start()
        return self

    def _watch(self) -> None:
        db = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True,
                             timeout=1.0)
        last = None
        try:
            while not self._stop.is_set():
                try:
                    (tip,) = db.execute("SELECT MAX(id) FROM blocks").fetchone()
                except sqlite3.OperationalError:
                    tip = last
                if tip is not None and tip != last:
                    now = time.monotonic()
                    for h in range((last or tip - 1) + 1, tip + 1):
                        self.commits.append((now, h))
                    last = tip
                self._stop.wait(self.period)
        finally:
            db.close()

    def committed(self, height: int) -> Optional[float]:
        return next((t for t, h in self.commits if h == height), None)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class Syncer:
    """Asks C to sync from the stub, again after each failed attempt,
    until it syncs to the end or is stopped."""

    def __init__(self, c_url: str, peer: str):
        self.url = f"{c_url}sync_blockchain?node_url={peer}"
        self.replies: List[Tuple[float, dict]] = []
        self.done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "Syncer":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self.done.is_set():
            try:
                reply = procs.get_json(self.url, timeout=3600)
            except (OSError, ValueError) as e:
                reply = {"ok": False, "error": f"request: {e}"}
            self.replies.append((time.monotonic(), reply))
            if reply.get("ok") or len(self.replies) >= 5:
                self.done.set()
            elif self.done.wait(0.2):
                break


def _read_c(path) -> dict:
    db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        blocks = dict(db.execute("SELECT id, hash FROM blocks"))
        txs = {}
        for bh, th in db.execute("SELECT block_hash, tx_hash FROM transactions"):
            txs.setdefault(bh, set()).add(th)
        utxo = set(db.execute(
            "SELECT tx_hash, idx, address, amount FROM unspent_outputs"))
    finally:
        db.close()
    return {"blocks": blocks, "txs": txs, "utxo": utxo}


def run(run: Run) -> Obs:
    cfg = run.cfg
    obs = Obs()
    diff = Decimal(cfg["difficulty"])
    chain_diff = Decimal(cfg["chain_difficulty"])
    t = time.monotonic()
    blocks, prefix = chain.rig_chain(
        run.seed, cfg["full_blocks"], cfg["per_fan"], cfg["n_fan"],
        cfg["wallets"], run.device, cfg["pow_chunk"], chain_diff)
    print(f"portbench: {len(blocks)} blocks generated in "
          f"{time.monotonic() - t:.3f} s", file=sys.stderr)
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    db = run.work / "c.db"
    chain.write_db(db, blocks[:prefix])
    per_block = cfg["n_fan"] * cfg["per_fan"]
    tamper_at = prefix + 1
    tamper_tx = random.Random(run.seed).randrange(per_block)
    peer = stub.Stub(blocks, diff, {tamper_at: tamper_tx})
    peer_url = peer.start()
    env = {**cfg["node_env"], **common.node_env(run, "c")}
    if chain_diff != uformat.START_DIFFICULTY:
        env["PORTBENCH_START_DIFFICULTY"] = str(chain_diff)
    if run.traffic.get("node_variant"):
        env["PORTBENCH_VARIANT"] = run.traffic["node_variant"]
    c, c_url = procs.start_node("c", run.root, run.work, db, run.device, env)
    miner = syncer = watch = None
    captures = common.Captures(run, {"c": c_url})
    try:
        procs.wait_ready(c, c_url, time.monotonic() + common.BUILD_GRACE)
        if run.trace:
            captures.prime()
        miner = common.start_miner(run, peer.tip.address, peer_url,
                                   run.traffic.get("miner_variant", ""))
        common.wait_templates(miner, 2, time.monotonic() + common.BUILD_GRACE)
        watch = TipWatch(db).start()
        syncer = Syncer(c_url, peer_url).start()
        obs.t0 = _first_page_done(peer, watch, syncer, c, tamper_at)
        obs.e2e["setup_s"] = obs.t0 - run.t_entry
        before = procs.scrape(c_url) if run.trace else {}
        if run.trace:
            captures.start()
        obs.t1 = obs.t0 + run.seconds
        time.sleep(max(0.0, obs.t1 - time.monotonic()))
        if run.trace:
            obs.scrapes["c"] = (before, procs.scrape(c_url))
            captures.stop()
        obs.card = run.sampler.summary(obs.t0, obs.t1)
        if run.trace:
            captures.wait_miner(miner)
        plan = common.close_window(obs, run, miner, {"c": c})
    finally:
        if syncer is not None:
            syncer.done.set()
        if miner is not None:
            miner.stop()
        c.stop()
        if watch is not None:
            watch.stop()
        peer.stop()
    in_window = [h for t, h in watch.commits if obs.t0 < t <= obs.t1]
    obs.e2e["catchup_rate"] = (
        sum(len(blocks[h - 1].txs) - 1 for h in in_window) / run.seconds)
    log = minerlog.parse(miner.lines, cfg["miner_batch"])
    obs.e2e["hash_rate"] = (minerlog.hashes_between(log, obs.t0, obs.t1)
                            / run.seconds / 1e6)
    tip = peer.tip
    tip_info = {"id": tip.height, "hash": tip.hash,
                "timestamp": tip.timestamp, "difficulty": diff}
    templates = reference.judge_miner(
        log, obs.t0, obs.t1, tip_info, tip.address, None, tip_info,
        cfg["miner_batch"], run.device, obs.checks, {}, difficulty=diff,
        extend=False)
    reference.judge_rechecks(plan, log.rechecks, run.device, obs.checks)
    ran_out = any(r.get("ok") and t <= obs.t1 for t, r in syncer.replies)
    replies = [(t, r) for t, r in syncer.replies if t <= obs.t1]
    errors = reference.judge_sync(
        blocks, prefix, _read_c(db), replies, tamper_at,
        peer.served_tampered, obs.checks)
    obs.attempted = len(in_window) + templates
    obs.failed = (errors + int(ran_out)
                  + sum(obs.t0 <= t <= obs.t1 for t, _l in log.errors))
    rel = [(round(t - obs.t0, 3), h) for t, h in watch.commits]
    print(f"portbench: pages (s from the window's start, offset, first, "
          f"last) {[(round(p[0] - obs.t0, 3),) + p[1:] for p in peer.pages]}",
          file=sys.stderr)
    print(f"portbench: commits (s from the window's start, height) {rel}",
          file=sys.stderr)
    obs.extra["sync"] = {"pages": peer.pages, "replies": syncer.replies,
                         "ran_out": ran_out, "blocks_in_window": len(in_window)}
    if run.trace:
        marks = common.miner_marks(miner.lines)
        marks += [(common.wall(t), "c commits a block") for t, _h in watch.commits]
        marks += [(common.wall(p[0]), "c fetches a page") for p in peer.pages]
        pre = [tpl for tpl in log.templates if tpl.t >= obs.t0] or log.templates
        common.traced(obs, run, captures.load(), common.profile_span(miner.lines),
                      marks, pre[-1].prefix, tip.hash, diff)
    return obs


def _first_page_done(peer: stub.Stub, watch: TipWatch, syncer: Syncer,
                     c: procs.Proc, tamper_at: int) -> float:
    """When C commits the last block of the page it is served from the
    tampered height after refusing the tampered block: the window's
    start."""
    deadline = time.monotonic() + common.BUILD_GRACE
    while time.monotonic() < deadline:
        if syncer.replies:
            refused = syncer.replies[0][0]
            honest = [p for p in list(peer.pages)
                      if p[0] > refused and p[2] == tamper_at]
            if honest:
                t = watch.committed(honest[0][3])
                if t is not None:
                    return t
        if syncer.done.is_set() or not c.alive():
            break  # C gave up on the honest chain: the checks say so
        time.sleep(0.05)
    return time.monotonic()
