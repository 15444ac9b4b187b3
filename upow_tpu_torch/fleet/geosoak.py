"""Geo soak: asymmetric-latency continent topology + churn (ROADMAP 5).

Six (by default) nodes split across three "continents" with realistic
asymmetric link latencies; blocks are mined WITHOUT direct push so the
shaped gossip links carry them — the propagation tracker then measures
real fleet spread.  The scenario then soaks through node churn (an
isolated node catches up via sync), a continent partition + heal, and
a traced push_tx crossing the fleet (stitched into one fleet trace).

The deterministic core carries only seed-functions: continent map,
convergence/coverage booleans, final height/tip.  All timing — the
propagation quantiles, per-node SLO rows, the stitched trace — goes to
``observed``/``slo``, from where :func:`observatory_section` folds it
into the committed ``observatory.json`` with explicit gate directions
(``fleet_core_ok`` zeroes on any correctness break, so the ENFORCED
perf gate also trips on broken distribution semantics, not just on
slow propagation).

Import discipline: swarm/scenarios.py registers this scenario at the
bottom of its module, so imports from scenarios here are deferred to
call time.  The port's copy of the JAX package's ``fleet/geosoak.py``;
the runners take the swarm's ``device`` (None: the card).
"""

from __future__ import annotations

import asyncio
import math
from typing import Dict, List, Optional

from .. import telemetry
from ..logger import get_logger
from . import propagation, scrape, stitch

log = get_logger("fleet")

#: canonical fleet shape used by `make fleet`, CI and the observatory —
#: keep smoke and full identical so gate rows stay comparable.
GEO_NODES = 6
GEO_SEED = 7

CONTINENTS = ("am", "eu", "ap")

#: one-way latency seconds, (src continent, dst continent) — asymmetric
#: on purpose (return routes differ in the real world).
_LATENCY = {
    ("am", "am"): 0.002, ("eu", "eu"): 0.002, ("ap", "ap"): 0.002,
    ("am", "eu"): 0.008, ("eu", "am"): 0.010,
    ("am", "ap"): 0.014, ("ap", "am"): 0.016,
    ("eu", "ap"): 0.011, ("ap", "eu"): 0.013,
}
_JITTER = 0.001


def continent_of(i: int) -> str:
    return CONTINENTS[i % len(CONTINENTS)]


def geo_soak_cfg(i: int, cfg) -> None:
    """Arm the watchtower on every soak node with the PRODUCTION rule
    pack — default thresholds, real background cadence (tightened to
    1s so a ~15s soak still gets a dozen ticks).  The clean-run gate
    (``watchtower_clean_ok``) is adversarial in the other direction:
    a healthy fleet doing churn, partitions and reorgs must not page,
    or the rule pack is too twitchy to ship."""
    cfg.watchtower.enabled = True
    cfg.watchtower.interval = 1.0


def _shape_links(swarm) -> Dict[str, str]:
    """Apply the continent latency matrix; returns {node label: continent}.

    No drop probability: the soak's determinism contract (byte-identical
    core per seed) must not hinge on retry races; churn and partition
    supply the failure pressure instead."""
    from ..swarm.links import LinkPolicy

    assign = {f"node{i}": continent_of(i) for i in range(swarm.n)}
    for i in range(swarm.n):
        for j in range(swarm.n):
            if i == j:
                continue
            pol = LinkPolicy(
                latency=_LATENCY[(continent_of(i), continent_of(j))],
                jitter=_JITTER)
            swarm.matrix.set_link(swarm.urls[i], swarm.urls[j], pol,
                                  symmetric=False)
    return assign


async def _wait_heights(swarm, height: int, rounds: int = 400,
                        delay: float = 0.01,
                        exclude: tuple = ()) -> bool:
    for _ in range(rounds):
        tips = await swarm.tips()
        if all(t["id"] >= height
               for i, t in enumerate(tips) if i not in exclude):
            return True
        await asyncio.sleep(delay)
    tips = await swarm.tips()
    return all(t["id"] >= height
               for i, t in enumerate(tips) if i not in exclude)


async def scenario_geo_soak(swarm, seed: int):
    from ..swarm.scenarios import (BREAKER_REOPEN_PAUSE, _sync_from,
                                   _wallet)
    from ..wallet.builders import WalletBuilder

    n = swarm.n
    everyone = list(range(n))
    continents = _shape_links(swarm)
    eu_idx = [i for i in everyone if continent_of(i) == "eu"]
    rest_idx = [i for i in everyone if continent_of(i) != "eu"]
    d_miner, addr = _wallet(seed, "geo_miner")
    _, addr_target = _wallet(seed, "geo_target")
    rec = swarm.recorder

    # ---- bootstrap: shared prefix, pushed directly (not under test)
    for _ in range(2):
        assert (await swarm.mine(0, addr, push_to=everyone))["ok"]
    await swarm.settle()
    bootstrap_converged = await swarm.wait_converged()
    height = (await swarm.tips())[0]["id"]
    rec.mark(swarm, label="bootstrap")

    # ---- gossip waves: rotating miners, NO direct push — the shaped
    # links carry every block; this is the propagation measurement
    waves = 4
    waves_propagated = 0
    for w in range(waves):
        miner = (w * 2 + 1) % n      # rotate across continents
        assert (await swarm.mine(miner, addr))["ok"]
        height += 1
        if await _wait_heights(swarm, height):
            waves_propagated += 1
    await swarm.settle()
    rec.mark(swarm, label="gossip_waves")

    # ---- churn: one AP node drops out, misses blocks, catches up
    victim = n - 1
    swarm.matrix.isolate(swarm.urls[victim])
    for _ in range(2):
        assert (await swarm.mine(0, addr))["ok"]
        height += 1
    gossip_sans_victim = await _wait_heights(swarm, height,
                                             exclude=(victim,))
    swarm.matrix.restore(swarm.urls[victim])
    await asyncio.sleep(BREAKER_REOPEN_PAUSE)
    await _sync_from(swarm, victim, winner=0)
    churn_caught_up = await swarm.wait_converged()
    rec.mark(swarm, label="churn")

    # ---- continent partition: EU forks off, loses, reorgs back
    swarm.matrix.partition([[swarm.urls[i] for i in eu_idx],
                            [swarm.urls[i] for i in rest_idx]])
    for _ in range(2):
        assert (await swarm.mine(0, addr))["ok"]
    assert (await swarm.mine(eu_idx[0], addr))["ok"]
    await swarm.settle()
    tips = await swarm.tips()
    partition_diverged = len({t["hash"] for t in tips}) == 2
    swarm.matrix.heal()
    await asyncio.sleep(BREAKER_REOPEN_PAUSE)
    for i in eu_idx:
        await _sync_from(swarm, i, winner=0)
    height += 2
    healed_converged = await swarm.wait_converged()
    rec.mark(swarm, label="partition_heal")

    # ---- traced push_tx across the fleet (stitch target)
    builder = WalletBuilder(swarm.nodes[0].state)
    tx = await builder.create_transaction(d_miner, addr_target, "1")
    with telemetry.request_trace("fleet.push_tx") as root:
        push_tid = root.trace_id
        res = await swarm.get(0, "push_tx", {"tx_hex": tx.hex()})
    assert res.get("ok"), res
    await swarm.settle()
    tx_nodes = 0
    for _ in range(200):
        pools = [await swarm.get(i, "get_pending_transactions")
                 for i in everyone]
        tx_nodes = sum(1 for p in pools
                       if tx.hex() in (p.get("result") or []))
        if tx_nodes == n:
            break
        await asyncio.sleep(0.01)
    stitched = stitch.stitch_one(scrape.traces_by_node(swarm), push_tid)
    stitched_nodes = [x for x in (stitched or {}).get("nodes", [])
                      if x != "driver"]

    # ---- confirm the tx, settle the world
    assert (await swarm.mine(0, addr))["ok"]
    height += 1
    final_converged = await _wait_heights(swarm, height) \
        and await swarm.wait_converged()
    await swarm.settle()          # drain gossip before teardown
    rec.mark(swarm, label="confirm")

    # ---- watchtower quiet check: the live cadence loops ran the whole
    # soak; a healthy fleet must end it without a single fired alert
    wt_stats = {f"node{i}": node.watchtower.stats()
                for i, node in enumerate(swarm.nodes)
                if getattr(node, "watchtower", None) is not None}
    wt_ticks = sum(s["evaluations"] for s in wt_stats.values())
    wt_fired = sum(s["fired_total"] for s in wt_stats.values())

    tips = await swarm.tips()
    prop = propagation.report(scrape.events_by_node(swarm), n_nodes=n)
    # blocks that must reach EVERY node: 2 bootstrap + 4 waves +
    # 2 churn + 2 partition winners + 1 confirm (the EU fork block
    # legitimately stays at 1/3 of the fleet)
    covered_expected = 11
    core = {
        "continents": continents,
        "bootstrap_converged": bootstrap_converged,
        "gossip_waves": waves,
        "waves_all_propagated": waves_propagated == waves,
        "gossip_reached_all_but_victim": gossip_sans_victim,
        "churn_victim_caught_up": churn_caught_up,
        "partition_diverged": partition_diverged,
        "healed_converged": healed_converged,
        "tx_reached_90pct_nodes": tx_nodes >= math.ceil(0.9 * n),
        "push_tx_trace_crossed_3_nodes": len(stitched_nodes) >= 3,
        "blocks_covered_90pct": prop["blocks"]["covered"]
        >= covered_expected,
        "final_converged": final_converged,
        "watchtower_armed_all_nodes": len(wt_stats) == n,
        "watchtower_ticked": wt_ticks >= 1,
        "watchtower_zero_alerts": wt_fired == 0,
        "final_height": tips[0]["id"],
        "final_tip": tips[0]["hash"],
    }
    observed = {
        "propagation": prop,
        "stitched_push_tx": stitched,
        "push_tx_trace_id": push_tid,
        "tx_pool_nodes": tx_nodes,
        "waves_propagated": waves_propagated,
        "watchtower": {"ticks": wt_ticks, "fired": wt_fired,
                       "stats": wt_stats},
    }
    return core, observed


# ------------------------------------------------- observatory bridge ----

def _num(v: float) -> float:
    return 0.0 if (v is None or (isinstance(v, float) and math.isnan(v))) \
        else float(v)


def run_geo_artifact(nodes: int = GEO_NODES, seed: int = GEO_SEED,
                     device=None) -> dict:
    from ..swarm.scenarios import run_scenario
    return run_scenario("geo_soak", nodes=nodes, seed=seed, device=device)


def fleet_rows(art: dict) -> dict:
    """Gate-facing rows from a geo-soak artifact.

    * ``kernels`` — direction-annotated entries in the observatory
      kernel table shape.  ``fleet_core_ok`` is the correctness trip:
      any failed core boolean zeroes it, and a zero against a baseline
      of 1.0 fails the ENFORCED gate regardless of tolerance (the
      divergence-zeroing idiom the other enforced kernels use).
    * ``slo_endpoints`` — per-node latency rows plus the propagation
      quantile rows, all in gate.flatten's endpoint shape.
    """
    from ..swarm.scenarios import core_ok

    prop = art["observed"]["propagation"]
    ok = core_ok(art["core"])
    wt_clean = bool(
        art["core"].get("watchtower_armed_all_nodes")
        and art["core"].get("watchtower_ticked")
        and art["core"].get("watchtower_zero_alerts"))
    kernels = {
        "fleet_core_ok": {
            "value": 1.0 if ok else 0.0, "unit": "bool",
            "direction": "higher",
            "desc": "geo-soak core assertions all held (0 = broken)"},
        "watchtower_clean_ok": {
            "value": 1.0 if wt_clean else 0.0, "unit": "bool",
            "direction": "higher",
            "desc": "default rule pack armed + ticking on every soak "
                    "node and ZERO alerts fired on the clean run"},
        "fleet_block_prop_p50_ms": {
            "value": _num(prop["blocks"]["p50_ms"]), "unit": "ms",
            "direction": "lower",
            "desc": "block first-commit -> 90% of nodes, median"},
        "fleet_block_prop_p95_ms": {
            "value": _num(prop["blocks"]["p95_ms"]), "unit": "ms",
            "direction": "lower",
            "desc": "block first-commit -> 90% of nodes, p95"},
        "fleet_tx_prop_p50_ms": {
            "value": _num(prop["txs"]["p50_ms"]), "unit": "ms",
            "direction": "lower",
            "desc": "tx first-accept -> mempool fan-out, median"},
        "fleet_tx_prop_p95_ms": {
            "value": _num(prop["txs"]["p95_ms"]), "unit": "ms",
            "direction": "lower",
            "desc": "tx first-accept -> mempool fan-out, p95"},
    }
    slo_endpoints = {
        k.replace("swarm.", "fleet.", 1): v
        for k, v in art["slo"]["endpoints"].items()}
    slo_endpoints.update(
        propagation.gate_rows(prop, prefix="fleet.geo_soak"))
    return {"kernels": kernels, "slo_endpoints": slo_endpoints}


def observatory_section(nodes: int = GEO_NODES,
                        seed: int = GEO_SEED, device=None) -> dict:
    """Run the geo soak and shape it for the observatory artifact."""
    art = run_geo_artifact(nodes=nodes, seed=seed, device=device)
    rows = fleet_rows(art)
    prop = art["observed"]["propagation"]
    stitched = art["observed"].get("stitched_push_tx") or {}
    section = {
        "scenario": "geo_soak",
        "nodes": nodes,
        "seed": seed,
        "fingerprint": art["fingerprint"],
        "core_ok": rows["kernels"]["fleet_core_ok"]["value"] == 1.0,
        "propagation": {
            kind: {k: prop[kind][k] for k in
                   ("hashes", "covered", "p50_ms", "p95_ms", "p99_ms")}
            for kind in ("blocks", "txs")},
        "stitched_push_tx_nodes": stitched.get("node_count", 0),
        "watchtower": art["observed"].get("watchtower", {}),
        "flight_recorder": art.get("flight_recorder", {}).get("reason"),
    }
    return {"section": section, "kernels": rows["kernels"],
            "slo_endpoints": rows["slo_endpoints"], "artifact": art}


def merge_into_observatory(path: str, nodes: int = GEO_NODES,
                           seed: int = GEO_SEED, device=None) -> dict:
    """Surgically merge fresh fleet rows into a committed observatory
    artifact (leaves every CI-measured kernel untouched)."""
    import json
    import os

    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    out = observatory_section(nodes=nodes, seed=seed, device=device)
    doc.setdefault("kernels", {}).update(out["kernels"])
    doc.setdefault("slo", {}).setdefault("endpoints", {}).update(
        out["slo_endpoints"])
    doc["fleet"] = out["section"]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    os.replace(tmp, path)
    log.info("merged fleet rows into %s", path)
    return out
