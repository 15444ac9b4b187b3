"""Seeded swarm scenarios + the deterministic artifact contract.

Every scenario runs inside :func:`deterministic_world`: the consensus
clock is frozen (advanced only by the mining helper), START_DIFFICULTY
drops to 1.0 so the python searcher solves in microseconds, the global
``random`` is seeded (peer sampling), telemetry rings are cleared and
fault injection is uninstalled afterwards.  Wallet keys derive from
``(seed, tag)``, so every address — and therefore every block hash —
is a pure function of the seed.

The artifact splits in two:

* ``core`` — values that are a function of (scenario, seed) ONLY:
  convergence flags, heights, tip hashes, governance ballots, shed
  counts.  ``fingerprint`` is the sha256 of core's canonical JSON —
  same seed, byte-identical fingerprint (pinned by tests).
* ``observed`` — anything timing may wiggle: breaker snapshots, link
  counters, retry/round counts, wall-clock.  Diagnostics, not
  contract.

``slo.endpoints`` carries per-node client-side latency quantiles in the
exact shape the observatory gate's ``flatten()`` consumes, so swarm
artifacts merge into the perf pipeline unchanged.

See docs/SWARM.md for the catalog and determinism contract.  The port's
copy of the JAX package's ``swarm/scenarios.py``: the same scenarios,
registry and runner, each core and fingerprint equal to the JAX one per
seed.  The nodes run where ``device`` says (None: the card, as every
port entry point); a card swarm verifies through the device runtime
when a ``cfg_hook`` sets ``device.sig_backend = "device"``, and its
cores must not move.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Callable, Dict, List, Optional, Tuple

from .. import telemetry
from ..fleet import recorder as fleet_recorder
from ..fleet import scrape as fleet_scrape
from ..logger import get_logger
from ..resilience import faultinject
from .harness import Swarm

log = get_logger("swarm")

#: Frozen consensus-clock epoch every scenario starts from.
GENESIS_EPOCH = 1_753_791_000

#: Real-time pause after a heal so tripped breakers can reach half-open
#: (swarm_config pins breaker_open_secs=0.25; breakers run on monotonic
#: wall time, not the frozen consensus clock).
BREAKER_REOPEN_PAUSE = 0.35


def _wallet(seed: int, tag: str) -> Tuple[int, str]:
    """Deterministic (privkey, address) from (seed, tag)."""
    from ..core import curve, point_to_string

    digest = hashlib.sha256(f"swarm:{seed}:{tag}".encode()).digest()
    d, pub = curve.keygen(rng=int.from_bytes(digest[:8], "big") | 1)
    return d, point_to_string(pub)


@contextlib.contextmanager
def deterministic_world(seed: int):
    """Pin every nondeterminism source a scenario touches."""
    import random

    from ..core import clock, difficulty

    prev_difficulty = difficulty.START_DIFFICULTY
    difficulty.START_DIFFICULTY = Decimal("1.0")
    clock.freeze(GENESIS_EPOCH)
    random.seed(seed)
    telemetry.reset()
    try:
        yield
    finally:
        difficulty.START_DIFFICULTY = prev_difficulty
        clock.reset()
        faultinject.uninstall()


# ------------------------------------------------------------- helpers ----

async def _sync_from(swarm: Swarm, i: int, winner: int,
                     tries: int = 50) -> dict:
    """Drive node ``i`` to sync from ``winner``, absorbing the transient
    'already syncing' race with background gossip-triggered syncs."""
    res: dict = {}
    for _ in range(tries):
        res = await swarm.get(i, "sync_blockchain",
                              {"node_url": swarm.urls[winner]})
        if res.get("ok"):
            return res
        await asyncio.sleep(0.02)
    return res


def _breaker_flips(swarm: Swarm) -> int:
    return sum(peer["flips"]
               for snap in swarm.breaker_summary().values()
               for peer in snap.values())


def _roots_for(swarm: Swarm, trace_id: str) -> List[dict]:
    """Trace roots for one id across the whole fleet: with per-node
    registries the driver's buffer only holds driver-opened roots, so
    cross-node assertions must read the merged view."""
    return fleet_scrape.merged_trace_roots(swarm, trace_id=trace_id)


def core_ok(core: dict) -> bool:
    """True when every boolean assertion in a core dict held."""
    return all(v for v in core.values() if isinstance(v, bool))


# ----------------------------------------------------------- scenarios ----

async def scenario_partition_heal(swarm: Swarm, seed: int):
    """2-way split mines divergent chains; heal; everyone converges on
    the longer side; reorg + breaker evidence carries ONE trace id."""
    n = swarm.n
    everyone = list(range(n))
    half = n // 2
    a_idx, b_idx = everyone[:half], everyone[half:]
    # the genesis-key rule (verify/block.py emission gate): with no
    # inode ballot formed, ONLY block 1's miner address may mine — so
    # both halves mine to the same key; the chains still diverge
    # because the halves extend the fork at different (advancing)
    # consensus timestamps
    _, addr_shared = _wallet(seed, "shared")
    addr_a = addr_b = addr_shared

    # shared prefix deep enough for fork detection (window=4, tip>4)
    for _ in range(4):
        assert (await swarm.mine(0, addr_shared, push_to=everyone))["ok"]
    await swarm.settle()
    assert await swarm.converged(), "shared prefix did not converge"

    swarm.matrix.partition([[swarm.urls[i] for i in a_idx],
                            [swarm.urls[i] for i in b_idx]])
    for _ in range(3):
        assert (await swarm.mine(0, addr_a, push_to=a_idx))["ok"]
    for _ in range(2):
        assert (await swarm.mine(half, addr_b, push_to=b_idx))["ok"]
    await swarm.settle()
    tips = await swarm.tips()
    diverged = len({t["hash"] for t in tips}) == 2
    flips_during_partition = _breaker_flips(swarm)

    # warm every loser's hot-state read cache with fork-B answers: the
    # post-heal reads below must come back reorged, proving the
    # remove_blocks -> cache-generation hook fired (swarm nodes run
    # with foreign revalidation off, so ONLY the hook can invalidate)
    stale_balances = {}
    for i in b_idx:
        supply = await swarm.get(i, "get_supply_info", {})
        info = await swarm.get(i, "get_address_info",
                               {"address": addr_shared})
        stale_balances[i] = (supply["result"]["last_block"].get("hash"),
                             info["result"]["balance"])

    swarm.matrix.heal()
    await asyncio.sleep(BREAKER_REOPEN_PAUSE)
    heal_results = []
    with telemetry.request_trace("swarm.heal") as root:
        heal_tid = root.trace_id
        for i in b_idx:
            heal_results.append(await _sync_from(swarm, i, winner=0))
    await swarm.settle()
    converged = await swarm.wait_converged()
    tips = await swarm.tips()

    # same queries again, same (warm) caches: a loser still serving its
    # fork-B tip or balance here means its reorg never invalidated the
    # read cache — the exact stale-balance bug the generation anchor
    # exists to prevent
    winner_info = await swarm.get(0, "get_address_info",
                                  {"address": addr_shared})
    winner_balance = winner_info["result"]["balance"]
    healed_reads_fresh = True
    stale_differed = False
    for i in b_idx:
        supply = await swarm.get(i, "get_supply_info", {})
        info = await swarm.get(i, "get_address_info",
                               {"address": addr_shared})
        if supply["result"]["last_block"].get("hash") != tips[0]["hash"] \
                or info["result"]["balance"] != winner_balance:
            healed_reads_fresh = False
        if stale_balances[i][1] != winner_balance:
            stale_differed = True

    reorgs = fleet_scrape.merged_events(swarm, kind="reorg")
    roots = _roots_for(swarm, heal_tid)
    root_names = {t.get("name") for t in roots}
    core = {
        "diverged_during_partition": diverged,
        "converged_after_heal": converged,
        "final_height": tips[0]["id"],
        "final_tip": tips[0]["hash"],
        "losers_reorged": len(reorgs) >= len(b_idx),
        "reorgs_share_heal_trace": bool(reorgs) and all(
            e.get("trace_id") == heal_tid for e in reorgs),
        # loser-side sync roots AND winner-side block-serving roots
        # under one id: the trace crossed the swarm
        "trace_spans_nodes": ("http.sync_blockchain" in root_names
                              and "http.get_blocks" in root_names),
        "breakers_flipped_during_partition": flips_during_partition > 0,
        # both legs matter: the pre-heal answers really were different
        # (the check bites) AND the post-heal cached reads are fresh
        "loser_caches_invalidated": stale_differed and healed_reads_fresh,
    }
    observed = {
        "heal_trace_id": heal_tid,
        "heal_results": heal_results,
        "reorg_events": len(reorgs),
        "heal_trace_roots": len(roots),
        "breaker_flips": _breaker_flips(swarm),
        "winner_balance": winner_balance,
        "loser_cache_stats": {
            str(i): swarm.nodes[i].hotcache.stats()["foreign_bumps"]
            for i in b_idx},
    }
    return core, observed


async def scenario_reorg_storm(swarm: Swarm, seed: int):
    """Repeated partition/mine/heal cycles with the winning side
    alternating — every cycle forces the previous winners to reorg."""
    n = swarm.n
    everyone = list(range(n))
    half = n // 2
    a_idx, b_idx = everyone[:half], everyone[half:]
    a_urls = [swarm.urls[i] for i in a_idx]
    b_urls = [swarm.urls[i] for i in b_idx]
    _, addr_shared = _wallet(seed, "storm_base")

    for _ in range(4):
        assert (await swarm.mine(0, addr_shared, push_to=everyone))["ok"]
    await swarm.settle()

    cycles = []
    for c in range(2):
        a_wins = c % 2 == 0
        # same genesis-key constraint as partition_heal: every block
        # pays the block-1 miner until an inode ballot exists
        addr_a = addr_b = addr_shared
        swarm.matrix.partition([a_urls, b_urls])
        for _ in range(3 if a_wins else 2):
            assert (await swarm.mine(0, addr_a, push_to=a_idx))["ok"]
        for _ in range(2 if a_wins else 3):
            assert (await swarm.mine(half, addr_b, push_to=b_idx))["ok"]
        await swarm.settle()
        swarm.matrix.heal()
        await asyncio.sleep(BREAKER_REOPEN_PAUSE)
        winner = 0 if a_wins else half
        for i in (b_idx if a_wins else a_idx):
            await _sync_from(swarm, i, winner)
        await swarm.settle()
        converged = await swarm.wait_converged()
        tips = await swarm.tips()
        cycles.append({"cycle": c, "winner": "a" if a_wins else "b",
                       "converged": converged,
                       "height": tips[0]["id"], "tip": tips[0]["hash"]})

    core = {
        "cycles": cycles,
        "all_converged": all(c["converged"] for c in cycles),
        "reorged_every_cycle":
            len(fleet_scrape.merged_events(swarm, kind="reorg"))
            >= len(b_idx) * 2,
    }
    observed = {
        "reorg_events": len(fleet_scrape.merged_events(swarm,
                                                       kind="reorg")),
        "breaker_flips": _breaker_flips(swarm),
    }
    return core, observed


async def scenario_eclipse(swarm: Swarm, seed: int):
    """An adversary clique monopolises the victim's peer view; after the
    unmask, breaker health resurfaces the honest peer and the victim
    catches up — recovery earned through scores, not URL luck."""
    from .adversary import EclipseAdversary

    n = swarm.n
    victim, honest_idx = 0, list(range(1, n))
    honest_url = swarm.urls[1]
    adv = EclipseAdversary(swarm.hub, count=3)
    _, addr = _wallet(seed, "eclipse_miner")

    # peer views: honest nodes mesh among themselves (no victim); the
    # victim knows the clique plus ONE honest peer
    for i in honest_idx:
        for j in honest_idx:
            if i != j:
                swarm.nodes[i].peers.add(swarm.urls[j])
    for url in adv.urls:
        swarm.nodes[victim].peers.add(url)
    swarm.nodes[victim].peers.add(honest_url)

    for _ in range(2):
        assert (await swarm.mine(1, addr,
                                 push_to=list(range(n))))["ok"]
    await swarm.settle()
    assert await swarm.converged(), "pre-eclipse prefix did not converge"

    # eclipse on: victim + clique on one side, honest on the other
    swarm.matrix.partition([[swarm.urls[victim]] + adv.urls,
                            [swarm.urls[i] for i in honest_idx]])
    for _ in range(2):
        assert (await swarm.mine(1, addr, push_to=honest_idx))["ok"]
    await swarm.settle()
    eclipse_syncs = []
    for _ in range(3):
        eclipse_syncs.append(await swarm.get(victim, "sync_blockchain"))
    tips = await swarm.tips()
    eclipsed = tips[victim]["id"] < tips[1]["id"]

    # the attack ends: clique goes dark, links restore
    adv.unmask()
    swarm.matrix.heal()
    await asyncio.sleep(BREAKER_REOPEN_PAUSE)
    recovery_rounds = 0
    for _ in range(12):
        recovery_rounds += 1
        await swarm.get(victim, "sync_blockchain")
        tips = await swarm.tips()
        if tips[victim]["hash"] == tips[1]["hash"]:
            break
        await asyncio.sleep(0.05)
    recovered = tips[victim]["hash"] == tips[1]["hash"]

    # keep syncing until health ranking surfaces the honest peer first
    # (each round adds an honest success or an adversary failure, so
    # the ordering is monotone toward honest-first)
    peers = swarm.nodes[victim].peers
    ranked_rounds = 0
    for _ in range(20):
        if peers.ranked(peers.all_nodes())[0] == honest_url:
            break
        ranked_rounds += 1
        await swarm.get(victim, "sync_blockchain")
        await asyncio.sleep(0.02)
    ranked_first = peers.ranked(peers.all_nodes())[0]
    breakers = swarm.nodes[victim].breakers
    core = {
        "eclipsed": eclipsed,
        "recovered": recovered,
        "victim_height": tips[victim]["id"],
        "victim_tip": tips[victim]["hash"],
        "honest_ranked_first": ranked_first == honest_url,
        "adversaries_scored_below_honest": all(
            breakers.score(u) < breakers.score(honest_url)
            for u in adv.urls),
        "adversary_served_calls": adv.calls - adv.calls_after_unmask > 0,
    }
    observed = {
        "eclipse_syncs": eclipse_syncs,
        "recovery_rounds": recovery_rounds,
        "ranked_rounds": ranked_rounds,
        "adversary_calls": adv.calls,
        "adversary_calls_after_unmask": adv.calls_after_unmask,
        "victim_breakers": breakers.snapshot(),
    }
    return core, observed


async def scenario_spam(swarm: Swarm, seed: int):
    """A flooder pushes garbage + duplicate transactions at every node;
    pools stay clean (one honest tx), mining and convergence survive."""
    from ..wallet.builders import WalletBuilder
    from .adversary import SpamAdversary

    n = swarm.n
    everyone = list(range(n))
    d_f, addr_f = _wallet(seed, "spam_funder")
    _, addr_t = _wallet(seed, "spam_target")

    assert (await swarm.mine(0, addr_f, push_to=everyone))["ok"]
    await swarm.settle()
    builder = WalletBuilder(swarm.nodes[0].state)
    tx = await builder.create_transaction(d_f, addr_t, "1")

    spam = SpamAdversary(swarm.hub)
    await spam.flood_garbage(swarm.urls, 40)
    res = await swarm.get(0, "push_tx", {"tx_hex": tx.hex()})
    assert res.get("ok"), res
    await swarm.settle()  # gossip carries the honest tx everywhere
    await spam.flood_duplicates(swarm.urls, tx.hex(), 24)
    await swarm.settle()

    pools = []
    for i in everyone:
        res = await swarm.get(i, "get_pending_transactions")
        pools.append(res["result"])
    assert (await swarm.mine(0, addr_f, push_to=everyone))["ok"]
    await swarm.settle()
    converged = await swarm.wait_converged()
    confirm = await swarm.get(n - 1, "get_transaction",
                              {"tx_hash": tx.hash()})
    tips = await swarm.tips()
    core = {
        "spam_sent": spam.sent,
        "spam_accepted": spam.accepted,
        "pools_clean": all(p == [tx.hex()] for p in pools),
        "tx_confirmed_everywhere": bool(
            confirm.get("ok") and confirm["result"]["is_confirm"]),
        "converged": converged,
        "final_height": tips[0]["id"],
        "final_tip": tips[0]["hash"],
    }
    observed = {
        "spam_rejected": spam.rejected,
        "pool_depths": [len(p) for p in pools],
    }
    return core, observed


async def scenario_dpos_governance(swarm: Swarm, seed: int):
    """The full DPoS flow through the node API: stake → delegate vote →
    validator registration → inode registration → validator vote →
    a mined block whose coinbase splits 50/50 miner/inode — then a
    fresh node syncs the whole governance history."""
    from ..core.rewards import get_block_reward_decimal
    from ..wallet.builders import WalletBuilder

    d_g, a_g = _wallet(seed, "gov_validator")
    d_o, a_o = _wallet(seed, "gov_delegate")
    d_i, a_i = _wallet(seed, "gov_inode")
    builder = WalletBuilder(swarm.nodes[0].state)

    async def push(tx) -> None:
        res = await swarm.get(0, "push_tx", {"tx_hex": tx.hex()})
        assert res.get("ok"), res

    async def mine() -> None:
        assert (await swarm.mine(0, a_g))["ok"]

    for _ in range(22):            # validator registration needs 100
        await mine()
    await push(await builder.create_stake_transaction(d_g, "3"))
    await mine()
    await push(await builder.create_validator_registration_transaction(d_g))
    await mine()
    await push(await builder.create_transaction(d_g, a_o, "20"))
    await mine()
    await push(await builder.create_stake_transaction(d_o, "1"))
    await mine()
    await push(await builder.vote_as_delegate(d_o, 10, a_g))
    await mine()

    for _ in range(170):           # inode registration needs 1000
        await mine()
    for chunk in ("400", "400", "210"):   # <256 inputs per send
        await push(await builder.create_transaction(d_g, a_i, chunk))
        await mine()
    await push(await builder.create_stake_transaction(d_i, "1"))
    await mine()
    await push(await builder.create_inode_registration_transaction(d_i))
    await mine()
    await push(await builder.vote_as_validator(d_g, 10, a_i))
    await mine()

    validators = await swarm.get(0, "get_validators_info")
    delegates = await swarm.get(0, "get_delegates_info")
    dobby = await swarm.get(0, "dobby_info")

    # the reward-split block: empty mempool, so the only balance change
    # on the inode address is its coinbase share
    before = Decimal((await swarm.get(
        0, "get_address_info", {"address": a_i}))["result"]["balance"])
    await mine()
    after = Decimal((await swarm.get(
        0, "get_address_info", {"address": a_i}))["result"]["balance"])
    tips = await swarm.tips()
    height = tips[0]["id"]
    reward = get_block_reward_decimal(height)
    inode_share = after - before
    split_ok = inode_share == reward * Decimal("0.5")

    # a blank node replays the whole governance history from genesis
    sync = await _sync_from(swarm, 1, winner=0)
    converged = await swarm.converged()
    utxo_match = (await swarm.nodes[0].state.get_unspent_outputs_hash()
                  == await swarm.nodes[1].state.get_unspent_outputs_hash())
    core = {
        "validator": a_g,
        "delegate_votes": [
            {"delegate": d["delegate"],
             "voted_for": [v["wallet"] for v in d["vote"]],
             "total_stake": str(d["totalStake"])}
            for d in delegates],
        "inode_ballot": [
            {"validator": v["validator"],
             "voted_for": [x["wallet"] for x in v["vote"]]}
            for v in validators],
        "dobby_emissions": dobby.get("result"),
        "final_height": height,
        "final_tip": tips[0]["hash"],
        "block_reward": str(reward),
        "inode_coinbase_share": str(inode_share),
        "split_50_50": split_ok,
        "fresh_node_synced": bool(sync.get("ok")) and converged,
        "utxo_fingerprints_match": utxo_match,
    }
    observed = {"sync_result": sync}
    return core, observed


async def scenario_ws_churn(swarm: Swarm, seed: int):
    """A stalled WS subscriber must not block fan-out: the live client
    sees every block while the stalled one's bounded queue sheds oldest
    — counted and exported as upow_ws_dropped_messages."""
    from .transport import LoopbackWsClient

    _, addr = _wallet(seed, "ws_miner")
    hub = swarm.nodes[0].ws_hub
    assert hub is not None, "ws_churn needs ws=True"
    live = LoopbackWsClient()
    slow = LoopbackWsClient()
    hub.connect_local(live, ip="10.99.0.1", channels=("block",))
    hub.connect_local(slow, ip="10.99.0.2", channels=("block",))
    slow.stall()

    for _ in range(8):
        assert (await swarm.mine(0, addr,
                                 push_to=list(range(swarm.n))))["ok"]
        # the broadcast is a spawned task: drain it (and give the
        # writer a real suspension point) per block, as a socket would
        await swarm.settle()
        await asyncio.sleep(0.005)
    for _ in range(200):           # writer task drains asynchronously
        if len(live.of_type("new_block")) >= 8:
            break
        await asyncio.sleep(0.01)
    slow.resume()
    for _ in range(200):
        if hub.get_stats()["dropped_messages"] >= 3 and \
                len(slow.of_type("new_block")) >= 5:
            break
        await asyncio.sleep(0.01)

    status, body = await swarm.hub.request(
        swarm.driver, swarm.urls[0], "GET", "/metrics")
    text = body.decode()
    dropped = hub.get_stats()["dropped_messages"]
    metric_line = next(
        (ln for ln in text.splitlines()
         if ln.startswith("upow_ws_dropped_messages_total ")), "")
    tips = await swarm.tips()
    core = {
        "blocks_broadcast": 8,
        "live_client_delivered": len(live.of_type("new_block")),
        "slow_client_delivered": len(slow.of_type("new_block")),
        "dropped_messages": dropped,
        "metrics_export_dropped": bool(metric_line) and
            float(metric_line.split()[1]) == dropped,
        "final_height": tips[0]["id"],
        "final_tip": tips[0]["hash"],
    }
    observed = {"metrics_status": status,
                "ws_stats": hub.get_stats()}
    return core, observed


def _snapshot_churn_cfg(i: int, cfg) -> None:
    """One-block sync pages: full replay pays one RPC per block, so the
    snapshot-vs-replay RPC comparison bites at swarm chain lengths."""
    cfg.node.sync_page = 1


def _joiner_rpcs(swarm: Swarm, i: int) -> int:
    """Outbound RPC attempts node ``i`` has made (delivered + shed) —
    the per-ordered-link matrix counters, driver traffic excluded."""
    prefix = swarm.urls[i] + "->"
    return sum(row["delivered"] + row["dropped"] + row["blocked"]
               for link, row in swarm.matrix.per_link.items()
               if link.startswith(prefix))


async def scenario_snapshot_churn(swarm: Swarm, seed: int):
    """Crash-safe onboarding (docs/SNAPSHOT.md): a blank node restores
    from a snapshot while its serving peer is corrupted mid-chunk and
    then partitioned mid-transfer — it must fail over to the second
    source, resume from journaled chunks, and land on the byte-exact
    UTXO fingerprint; a second blank node measures the full-replay RPC
    baseline; a third faces permanently-poisoned chunks and must fall
    back to full replay with a structured reason instead of failing
    the join."""
    assert swarm.n >= 5, "snapshot_churn needs 5 nodes"
    urls = swarm.urls
    _, addr = _wallet(seed, "shared")
    tmp = tempfile.mkdtemp(prefix="snapshot-churn-")
    try:
        # nodes 0/1: servers; 2: snapshot joiner; 3: replay baseline;
        # 4: forced-integrity-failure joiner (isolated topology: only
        # the peers a phase names below exist for each node)
        for i in (0, 1, 2, 4):
            scfg = swarm.nodes[i].config.snapshot
            scfg.dir = os.path.join(tmp, f"n{i}")
            scfg.chunk_bytes = 2048  # multi-chunk transfers at swarm scale
            scfg.blocks_tail = 8
        swarm.nodes[4].peers.add(urls[1])  # replay-fallback source

        for _ in range(24):
            assert (await swarm.mine(0, addr, push_to=[0, 1]))["ok"]
        m0 = await swarm.nodes[0].build_snapshot()
        m1 = await swarm.nodes[1].build_snapshot()
        assert m0 is not None and m1 is not None

        # phase A — snapshot onboarding under fire: node 0 serves chunk
        # 1 corrupted twice (integrity retries must absorb it) and every
        # node-0 fetch is slowed so the transfer is still mid-flight
        # when the partition cuts node 0 away
        faultinject.install(
            "snapshot.serve:corrupt:times=2,key=chunk/1;"
            "snapshot.fetch:latency:delay=0.02,key=10.77.0.1", seed)
        base2 = _joiner_rpcs(swarm, 2)
        with swarm.nodes[2].telemetry_scope.activate():
            boot2 = asyncio.ensure_future(
                swarm.nodes[2].bootstrap_from_snapshot(
                    sources=[urls[0], urls[1]]))
        progress = swarm.nodes[2].snapshot_restore
        for _ in range(2000):
            if progress.get("verified", 0) >= 3:
                break
            await asyncio.sleep(0.002)
        partitioned_mid_transfer = \
            0 < progress.get("verified", 0) < progress.get("total", 0)
        swarm.matrix.partition([[urls[0]], urls[1:]])
        res2 = await boot2
        rpcs2 = _joiner_rpcs(swarm, 2) - base2
        faultinject.uninstall()

        # phase B — the same onboarding, the old way: full block replay
        base3 = _joiner_rpcs(swarm, 3)
        res3 = await _sync_from(swarm, 3, winner=1)
        rpcs3 = _joiner_rpcs(swarm, 3) - base3

        # phase C — every chunk from every source poisoned: the join
        # must degrade to replay with a structured reason, not fail
        faultinject.install("snapshot.serve:corrupt", seed + 1)
        with swarm.nodes[4].telemetry_scope.activate():
            res4 = await swarm.nodes[4].bootstrap_from_snapshot(
                sources=[urls[1]])
        faultinject.uninstall()

        fp0 = await swarm.nodes[0].state.get_unspent_outputs_hash()
        full0 = await swarm.nodes[0].state.get_full_state_hash()
        fp2 = await swarm.nodes[2].state.get_unspent_outputs_hash()
        full2 = await swarm.nodes[2].state.get_full_state_hash()
        tips = await swarm.tips()
        corrupt_events = fleet_scrape.merged_events(
            swarm, kind="snapshot_chunk_corrupt")
        fallback_events = fleet_scrape.merged_events(
            swarm, kind="snapshot_fallback")
        recommended = fleet_scrape.merged_events(
            swarm, kind="snapshot_recommended")
        core = {
            "servers_published_identical":
                m0["payload_sha256"] == m1["payload_sha256"],
            "snapshot_joiner_ok": bool(res2.get("ok"))
                and res2.get("method") == "snapshot",
            "partitioned_mid_transfer": partitioned_mid_transfer,
            "failed_over_to_second_source":
                res2.get("source") == urls[1],
            "resumed_journaled_chunks": res2.get("chunks_reused", 0) > 0,
            "corruption_caught_by_integrity": len(corrupt_events) >= 1,
            "joiner_fingerprint_exact": fp2 == fp0 and full2 == full0,
            "snapshot_fewer_rpcs_than_replay": rpcs2 < rpcs3,
            "replay_joiner_ok": bool(res3.get("ok")),
            "poisoned_join_fell_back": res4.get("method")
                == "replay_fallback" and bool(res4.get("ok")),
            "fallback_reason_structured": res4.get("reason")
                == "sources_exhausted" and len(fallback_events) >= 1,
            "snapshot_recommended_emitted": len(recommended) >= 1,
            "all_converged": len({t["hash"] for t in tips}) == 1,
            "final_height": tips[0]["id"],
            "final_tip": tips[0]["hash"],
            "utxo_fingerprint": fp0,
        }
        observed = {
            "snapshot_rpcs": rpcs2,
            "replay_rpcs": rpcs3,
            "snapshot_result": res2,
            "replay_result": {k: res3.get(k) for k in ("ok", "error")},
            "fallback_result": {k: res4.get(k)
                                for k in ("ok", "method", "reason")},
            "manifest_chunks": len(m0["chunks"]),
            "corrupt_events": len(corrupt_events),
            "restore_progress": dict(swarm.nodes[2].snapshot_restore),
        }
        return core, observed
    finally:
        faultinject.uninstall()
        # scenario nodes are still serving on this loop; a blocking
        # rmtree here would distort the very timings being measured
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: shutil.rmtree(tmp, ignore_errors=True))


def _archive_prune_cfg(i: int, cfg) -> None:
    """Tiny segments and a short safety window so a swarm-length chain
    spans several archive segments and the compactor actually prunes."""
    cfg.node.sync_page = 1
    cfg.archive.segment_blocks = 4
    cfg.archive.safety_window = 4


async def scenario_archive_prune(swarm: Swarm, seed: int):
    """Cold-block archival tier (docs/ARCHIVE.md): node 0 mines, builds
    a snapshot, and compacts its hot store into the content-addressed
    archive while node 1 keeps the full hot chain as an unpruned twin.
    Every read the archive now backs — get_block, get_blocks_details
    pages spanning the hot/archive seam, get_transaction, address
    history — must answer byte-identically on both nodes (canonical
    JSON fingerprints), before AND after a reorg inside the safety
    window.  Node 2 then mirrors the archive over /archive/* and the
    twin independently compacts its own copy to prove segments are a
    pure function of chain content."""
    assert swarm.n >= 3, "archive_prune needs 3 nodes"
    from ..archive import ArchiveReader
    from ..wallet.builders import WalletBuilder

    urls = swarm.urls
    d, addr = _wallet(seed, "shared")
    _, addr_sink = _wallet(seed, "archive_sink")
    tmp = tempfile.mkdtemp(prefix="archive-prune-")
    try:
        # node 0: pruned node; node 1: unpruned twin; node 2: mirror
        n0, n1, n2 = swarm.nodes[0], swarm.nodes[1], swarm.nodes[2]
        n0.config.snapshot.dir = os.path.join(tmp, "snap0")
        n0.config.snapshot.blocks_tail = 4
        for node, name in ((n0, "archive0"), (n2, "archive2")):
            acfg = node.config.archive
            acfg.dir = os.path.join(tmp, name)
            node.state.archive = ArchiveReader(
                acfg.dir, cache_segments=acfg.reader_cache_segments)

        for _ in range(20):
            assert (await swarm.mine(0, addr, push_to=[0, 1]))["ok"]
        # spend every early coinbase into a sink: those txs leave the
        # UTXO set, so their blocks fall out of the witness closure and
        # become prunable — a pure-coinbase chain keeps every block hot
        from ..core.constants import SMALLEST
        outputs = await n0.state.get_spendable_outputs(addr)
        balance = Decimal(sum(o.amount for o in outputs)) / SMALLEST
        tx = await WalletBuilder(n0.state).create_transaction(
            d, addr_sink, balance)
        for i in (0, 1):   # push_block ships tx HASHES; both mempools
            res = await swarm.get(i, "push_tx", {"tx_hex": tx.hex()})
            assert res.get("ok"), res
        for _ in range(8):
            assert (await swarm.mine(0, addr, push_to=[0, 1]))["ok"]

        hot_before = await n0.state.archive_hot_row_counts()
        assert (await n0.build_snapshot()) is not None
        with n0.telemetry_scope.activate():
            stats = await n0.compact_archive()
        hot_after = await n0.state.archive_hot_row_counts()
        through = stats.get("archived_through", 0)

        # the parity probe set: every archived block by height, pages
        # that straddle the hot/archive seam, every archived tx, and
        # the miner's full address history
        tx_hashes = []
        for h in range(1, through + 1):
            blk = await n1.state.get_block_by_id(h)
            tx_hashes.extend(
                await n1.state.get_block_transaction_hashes(blk["hash"]))
        probes = [("get_block", {"block": str(h),
                                 "full_transactions": "true"})
                  for h in range(1, through + 1)]
        probes += [("get_blocks_details",
                    {"offset": str(off), "limit": "8"})
                   for off in range(1, 28, 8)]
        probes += [("get_transaction", {"tx_hash": h}) for h in tx_hashes]
        probes += [("get_address_transactions",
                    {"address": addr, "page": str(p), "limit": "15"})
                   for p in (1, 2)]

        async def parity() -> bool:
            for path, params in probes:
                a = await swarm.get(0, path, params)
                b = await swarm.get(1, path, params)
                if not a.get("ok") or \
                        artifact_fingerprint(a) != artifact_fingerprint(b):
                    log.error("archive parity diverged on %s %s", path,
                              params)
                    return False
            return True

        parity_before_reorg = await parity()

        # reorg INSIDE the safety window: node 0 mines a private block,
        # the twin mines two, node 0 syncs over and must drop its own —
        # every row touched is above archived_through, so the archive
        # stays valid and parity must hold afterwards
        pre_reorg = (await swarm.tips())[0]
        assert (await swarm.mine(0, addr, push_to=[0]))["ok"]
        for _ in range(2):
            assert (await swarm.mine(1, addr, push_to=[1]))["ok"]
        res_sync = await _sync_from(swarm, 0, winner=1)
        tips = await swarm.tips()
        reorged = bool(res_sync.get("ok")) and \
            tips[0]["hash"] == tips[1]["hash"] and \
            tips[0]["hash"] != pre_reorg["hash"]
        parity_after_reorg = await parity()

        # a second cycle against the same snapshot generation must be a
        # no-op: nothing new to build, closure predicate matches nothing
        stats2 = await n0.compact_archive()

        # node 2 (blank hot store) mirrors the archive over /archive/*
        fetch = await n2.fetch_archive_from_peer(urls[0])
        cov2 = await n2.state.archive.coverage()

        # the twin compacts its OWN copy: overlapping segments must be
        # byte-identical (content-addressing is a pure function of
        # chain content).  Runs after every parity probe — it prunes.
        n1.config.snapshot.dir = os.path.join(tmp, "snap1")
        n1.config.snapshot.blocks_tail = 4
        n1.config.archive.dir = os.path.join(tmp, "archive1")
        n1.state.archive = ArchiveReader(
            n1.config.archive.dir,
            cache_segments=n1.config.archive.reader_cache_segments)
        assert (await n1.build_snapshot()) is not None
        stats_twin = await n1.compact_archive()
        m0 = await n0._archive_manifest()
        m1 = await n1._archive_manifest()
        shared = min(len(m0["segments"]), len(m1["segments"]))
        twin_segments_identical = shared > 0 and all(
            m0["segments"][k]["payload_sha256"]
            == m1["segments"][k]["payload_sha256"]
            and m0["segments"][k]["index_sha256"]
            == m1["segments"][k]["index_sha256"]
            for k in range(shared))

        compact_events = fleet_scrape.merged_events(
            swarm, kind="archive_compact_complete")
        core = {
            "compaction_ok": bool(stats.get("ok")),
            "archived_through": through,
            "segments_published": stats.get("segments", 0),
            "hot_blocks_before": hot_before["blocks"],
            "hot_blocks_after": hot_after["blocks"],
            "hot_txs_before": hot_before["txs"],
            "hot_txs_after": hot_after["txs"],
            "hot_rows_reduced":
                hot_after["blocks"] < hot_before["blocks"]
                and hot_after["txs"] < hot_before["txs"],
            "parity_before_reorg": parity_before_reorg,
            "reorg_inside_safety_window": reorged,
            "parity_after_reorg": parity_after_reorg,
            "recompaction_noop": bool(stats2.get("ok"))
                and stats2.get("segments_built") == 0
                and stats2.get("pruned_blocks") == 0,
            "mirror_fetch_ok": bool(fetch.get("ok"))
                and fetch.get("fetched", 0) > 0,
            "mirror_coverage_exact": cov2 == (1, through),
            "twin_segments_identical": twin_segments_identical,
            "fallthrough_reads_counted":
                n0.state.archive.fallthrough_reads > 0,
            "compact_event_emitted": len(compact_events) >= 1,
            "final_height": tips[1]["id"],
            "final_tip": tips[1]["hash"],
        }
        observed = {
            "compaction": stats,
            "recompaction": stats2,
            "twin_compaction": {k: stats_twin.get(k)
                                for k in ("ok", "archived_through",
                                          "segments_built")},
            "mirror_fetch": fetch,
            "reader_stats": n0.state.archive.stats(),
            "probes": len(probes),
            "sync_result": {k: res_sync.get(k) for k in ("ok", "error")},
        }
        return core, observed
    finally:
        faultinject.uninstall()
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: shutil.rmtree(tmp, ignore_errors=True))


def _watchtower_storm_cfg(i: int, cfg) -> None:
    """Arm the watchtower on every node with the evaluation cadence
    parked (the scenario pumps ``evaluate_once`` itself, so firing
    order is a function of the seed, not the event loop) and the storm
    rule tightened to swarm scale: 4 breaker opens page immediately."""
    wt = cfg.watchtower
    wt.enabled = True
    wt.interval = 3600.0          # background loop never ticks
    wt.for_fast = 0.0             # storm pages on the evaluation tick
    wt.breaker_storm_opens = 4
    wt.breaker_storm_window = 120.0


async def scenario_watchtower_storm(swarm: Swarm, seed: int):
    """Fault → alert → exemplar: every gossip RPC toward node 2 errors,
    so node 0's breaker trips and then re-trips on each half-open
    trial; the watchtower's ``breaker_flip_storm`` rule must reach
    *firing* with an exemplar trace id that stitches across >= 2 nodes
    (the guilty push propagated to node 1 fine), the flight recorder
    must dump with the alert — not the raw fault — as the trigger, and
    once the fault lifts and the event window ages out the alert must
    resolve.  docs/ALERTING.md walks this exact incident."""
    from ..wallet.builders import WalletBuilder

    assert swarm.n >= 3, "watchtower_storm needs 3 nodes"
    engine = swarm.nodes[0].watchtower
    assert engine is not None, "cfg hook did not enable the watchtower"

    d_f, addr_f = _wallet(seed, "storm_funder")
    _, addr_t = _wallet(seed, "storm_target")
    everyone = list(range(swarm.n))
    for _ in range(8):            # one coinbase per later push
        assert (await swarm.mine(0, addr_f, push_to=everyone))["ok"]
    await swarm.settle()

    # prime the streaming detectors: a clean tick must not page
    baseline = await engine.evaluate_once(now=time.time())
    baseline_clean = (baseline["firing"] == 0
                      and baseline["pending"] == 0)

    # every RPC whose peer key contains node 2's address errors; the
    # driver's own requests bypass the resilience wrapper, so only
    # node-to-node gossip feels it
    faultinject.install(f"rpc:error:key={swarm.ips[2]}", seed)
    builder = WalletBuilder(swarm.nodes[0].state)
    rounds = 0
    for k in range(7):
        tx = await builder.create_transaction(d_f, addr_t, "1")
        res = await swarm.get(0, "push_tx", {"tx_hex": tx.hex()})
        assert res.get("ok"), res
        rounds += 1
        # outlive breaker_open_secs (0.25) so the next push lands on a
        # half-open breaker and the failed trial re-opens it — each
        # round past the failure threshold is one more "open" event
        await asyncio.sleep(BREAKER_REOPEN_PAUSE)

    storm_now = time.time()
    counts = await engine.evaluate_once(now=storm_now)
    active = {a.rule.name: a for a in engine.alerts.active()}
    alert = active.get("breaker_flip_storm")
    # Alert objects mutate in place on later ticks — freeze the storm-
    # time view before the resolve leg flips it
    storm_state = alert.state if alert else None
    storm_opens = alert.value if alert else 0.0
    exemplar = alert.exemplars[0] if alert and alert.exemplars else None
    stitched_nodes = sorted({r["node"]
                             for r in _roots_for(swarm, exemplar)}) \
        if exemplar else []
    node0_events = swarm.nodes[0].telemetry_scope.events.snapshot()

    # lift the fault; aging the evaluation clock past the storm window
    # empties the open-event window and the alert must resolve
    faultinject.uninstall()
    fired_before = engine.stats()["fired_total"]
    await engine.evaluate_once(
        now=storm_now + engine.cfg.breaker_storm_window + 1.0)
    resolved = engine.stats()["resolved_total"] >= 1 and not any(
        a.rule.name == "breaker_flip_storm" for a in engine.alerts.active())

    await asyncio.sleep(BREAKER_REOPEN_PAUSE)  # node 2's breakers heal
    assert (await swarm.mine(0, addr_f, push_to=everyone))["ok"]
    await swarm.settle()
    converged = await swarm.wait_converged()
    tips = await swarm.tips()
    core = {
        "baseline_clean": baseline_clean,
        "storm_alert_fired": storm_state == "firing",
        "storm_rule": alert.rule.name if alert else None,
        "storm_severity": alert.rule.severity if alert else None,
        "exemplar_present": exemplar is not None,
        "exemplar_stitched": len(stitched_nodes) >= 2,
        "alert_event_emitted": any(
            e.get("kind") == "alert" and e.get("state") == "firing"
            and e.get("rule") == "breaker_flip_storm"
            for e in node0_events),
        "fault_events_seen": any(e.get("kind") == "fault_injected"
                                 for e in node0_events),
        "alert_resolved": resolved,
        "converged": converged,
        "final_height": tips[0]["id"],
        "final_tip": tips[0]["hash"],
    }
    observed = {
        "rounds": rounds,
        "firing_counts": counts,
        "breaker_opens_windowed": storm_opens,
        "exemplar": exemplar,
        "stitched_nodes": stitched_nodes,
        "fired_total": fired_before,
        "watchtower_stats": engine.stats(),
    }
    return core, observed


# ------------------------------------------------------------- registry ----

@dataclass(frozen=True)
class ScenarioSpec:
    fn: Callable
    nodes: int                # default swarm size
    fast: bool                # member of the CI fast matrix
    topology: str = "mesh"
    swarm_kwargs: dict = field(default_factory=dict)
    # flight-recorder SLO trigger: a per-node p99 above this dumps the
    # black box into the artifact (None = no latency trigger)
    p99_budget_ms: Optional[float] = None


SCENARIOS: Dict[str, ScenarioSpec] = {
    "partition_heal": ScenarioSpec(
        scenario_partition_heal, nodes=6, fast=True,
        swarm_kwargs={"reorg_window": 4}),
    "reorg_storm": ScenarioSpec(
        scenario_reorg_storm, nodes=6, fast=True,
        swarm_kwargs={"reorg_window": 4}),
    "eclipse": ScenarioSpec(
        scenario_eclipse, nodes=4, fast=True, topology="isolated"),
    "spam": ScenarioSpec(scenario_spam, nodes=4, fast=True),
    "dpos_governance": ScenarioSpec(
        scenario_dpos_governance, nodes=2, fast=True,
        topology="isolated"),
    "ws_churn": ScenarioSpec(
        scenario_ws_churn, nodes=2, fast=True,
        swarm_kwargs={"ws": True, "ws_queue_max": 4}),
    "snapshot_churn": ScenarioSpec(
        scenario_snapshot_churn, nodes=5, fast=True,
        topology="isolated",
        swarm_kwargs={"reorg_window": 4,
                      "cfg_hook": _snapshot_churn_cfg}),
    "archive_prune": ScenarioSpec(
        scenario_archive_prune, nodes=3, fast=True,
        topology="isolated",
        swarm_kwargs={"reorg_window": 4,
                      "cfg_hook": _archive_prune_cfg}),
    "watchtower_storm": ScenarioSpec(
        scenario_watchtower_storm, nodes=3, fast=True,
        swarm_kwargs={"cfg_hook": _watchtower_storm_cfg}),
}

# The geo soak lives in the fleet package (fleet/geosoak.py: continent
# latency matrix + churn + propagation quantiles) but registers here so
# the matrix/CLI/artifact machinery treats it like any other scenario.
# Import placed AFTER the registry: geosoak defers every swarm import
# to call time, so this is the only edge and cannot cycle.
from ..fleet.geosoak import geo_soak_cfg, scenario_geo_soak  # noqa: E402

SCENARIOS["geo_soak"] = ScenarioSpec(
    scenario_geo_soak, nodes=6, fast=True,
    swarm_kwargs={"reorg_window": 4, "cfg_hook": geo_soak_cfg},
    p99_budget_ms=2000.0)


# ------------------------------------------------------------- artifact ----

def artifact_fingerprint(core: dict) -> str:
    """sha256 over core's canonical JSON — THE determinism contract."""
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


async def _drive(spec: ScenarioSpec, n: int, seed: int, device=None):
    swarm = Swarm(n, seed=seed, device=device, **spec.swarm_kwargs)
    await swarm.start(topology=spec.topology)
    swarm.recorder.mark(swarm, label="start")
    try:
        core, observed = await spec.fn(swarm, seed)
        observed = dict(observed)
        observed["links"] = swarm.matrix.stats()
        observed["breakers"] = swarm.breaker_summary()
        slo = swarm.slo_summary()
        # black-box capture happens while the node scopes are live;
        # whether the dump lands in the artifact is decided later
        swarm.recorder.mark(swarm, label="final")
        fleet_events = fleet_scrape.merged_events(swarm)
    finally:
        await swarm.close()
    return core, observed, slo, {"events": fleet_events,
                                 "recorder": swarm.recorder}


def run_scenario(name: str, nodes: Optional[int] = None,
                 seed: int = 7, device=None) -> dict:
    """Run one scenario inside a deterministic world; return the
    artifact (core + fingerprint + observed + gate-shaped slo).  Its
    nodes run on ``device`` (None: the card; raises without one)."""
    spec = SCENARIOS[name]
    n = nodes or spec.nodes
    t0 = time.perf_counter()
    with deterministic_world(seed):
        core, observed, slo, blackbox = asyncio.run(_drive(spec, n, seed,
                                                          device))
    elapsed = time.perf_counter() - t0
    core = {"scenario": name, "seed": seed, "nodes": n, **core}
    observed["elapsed_s"] = round(elapsed, 3)
    log.info("scenario %s (n=%d seed=%d) done in %.2fs", name, n, seed,
             elapsed)
    slo_rows = {f"swarm.{name}.{node}": row for node, row in slo.items()}
    artifact = {
        "kind": "swarm_scenario",
        "scenario": name,
        "seed": seed,
        "nodes": n,
        "core": core,
        "fingerprint": artifact_fingerprint(core),
        "observed": observed,
        "slo": {"endpoints": slo_rows},
    }
    # flight recorder: core failure / injected fault / SLO breach ⇒
    # the black box (per-node frames) lands next to the failure
    reason = fleet_recorder.trigger_reason(
        core_ok(core), blackbox["events"], slo_rows=slo_rows,
        p99_budget_ms=spec.p99_budget_ms)
    if reason is not None:
        artifact["flight_recorder"] = blackbox["recorder"].dump(reason)
        log.warning("scenario %s: flight recorder dumped (%s)", name,
                    reason)
    return artifact


def run_matrix(which: str = "fast", seed: int = 7, device=None) -> dict:
    """Run every (fast) scenario at its default size; the matrix
    fingerprint chains the per-scenario fingerprints in name order."""
    runs = []
    for name in sorted(SCENARIOS):
        if which != "all" and not SCENARIOS[name].fast:
            continue
        runs.append(run_scenario(name, seed=seed, device=device))
    chained = hashlib.sha256(
        "".join(r["fingerprint"] for r in runs).encode()).hexdigest()
    return {"kind": "swarm_matrix", "which": which, "seed": seed,
            "scenarios": [r["scenario"] for r in runs],
            "fingerprint": chained, "runs": runs}
