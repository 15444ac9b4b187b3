"""Pruned-vs-twin parity: the archive tier's correctness contract (the
port's copy of the JAX package's ``archive/parity.py``).

:func:`storage_differential` is a storage-level deep read of a
synthetic multi-thousand-block chain: one state is compacted
(archive-commit + witness-closure prune), its twin keeps every hot
row, and every read the archive now backs — block by id/hash, block
pages across the hot/archive seam, transaction lookups, address
history — must answer byte-identically (canonical JSON fingerprints).
This is what ``python -m upow_tpu_torch.archive`` drives, including the
kill -9 resume leg.  :func:`observatory_section` runs the swarm
``archive_prune`` scenario (full HTTP surface, reorg inside the safety
window, peer mirror) and shapes it into observatory gate rows;
``archive_parity_ok`` zeroes on ANY failed core assertion, so a baseline
of 1.0 fails the enforced gate regardless of tolerance — the same
divergence-zeroing idiom as ``fleet_core_ok``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import shutil
import tempfile
from typing import List, Optional

from ..logger import get_logger

log = get_logger("archive")

#: Consensus-plausible constants for the synthetic chain (frozen-clock
#: epoch shared with the swarm scenarios; one block every 3 minutes).
_EPOCH = 1_753_791_000
_BLOCK_SPACING = 180


def _fp(doc) -> str:
    """Canonical-JSON fingerprint — byte parity, not just equality."""
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def _addresses(n: int = 5) -> List[str]:
    from ..core import curve, point_to_string

    out = []
    for k in range(n):
        digest = hashlib.sha256(f"archive-parity:{k}".encode()).digest()
        _, pub = curve.keygen(rng=int.from_bytes(digest[:8], "big") | 1)
        out.append(point_to_string(pub))
    return out


def build_synthetic_chain(state, blocks: int, *, seed: int = 0,
                          witness_from: Optional[int] = None) -> None:
    """Insert a deterministic synthetic chain straight into a sqlite
    :class:`~..state.storage.ChainState`: one real (parseable)
    coinbase per block.  Coinbases at heights >= ``witness_from`` keep
    an ``unspent_outputs`` row — the witness closure — while everything
    below is spent history the compactor may retire."""
    from ..core.tx import CoinbaseTx

    if witness_from is None:
        witness_from = blocks + 1
    addrs = _addresses()
    db = state.db
    for h in range(1, blocks + 1):
        bhash = hashlib.sha256(
            f"parity:{seed}:block:{h}".encode()).hexdigest()
        addr = addrs[h % len(addrs)]
        cb = CoinbaseTx(bhash, addr, 100_000_000 + h)
        db.execute(
            "INSERT INTO blocks (id, hash, content, address, random,"
            " difficulty, reward, timestamp) VALUES (?,?,?,?,?,?,?,?)",
            (h, bhash, f"content-{seed}-{h}", addr, h * 7, "1.0",
             cb.amount, _EPOCH + h * _BLOCK_SPACING))
        db.execute(
            "INSERT INTO transactions (block_hash, tx_hash, tx_hex,"
            " inputs_addresses, outputs_addresses, outputs_amounts,"
            " fees) VALUES (?,?,?,?,?,?,?)",
            (bhash, cb.hash(), cb.hex(), json.dumps([]),
             json.dumps([addr]), json.dumps([cb.amount]), 0))
        if h >= witness_from:
            db.execute(
                "INSERT INTO unspent_outputs (tx_hash, idx, address,"
                " amount) VALUES (?,?,?,?)",
                (cb.hash(), 0, addr, cb.amount))
    db.commit()


def publish_fake_snapshot(root: str, anchor_height: int,
                          anchor_hash: str) -> None:
    """Publish a minimal snapshot generation carrying just the anchor —
    all the compactor reads from a manifest."""
    from ..snapshot import layout as snap_layout

    name = snap_layout.gen_name(anchor_height, anchor_hash)
    gen = os.path.join(root, name)
    os.makedirs(gen, exist_ok=True)
    snap_layout.write_manifest(
        os.path.join(gen, snap_layout.MANIFEST_NAME),
        {"version": snap_layout.MANIFEST_VERSION,
         "anchor_height": anchor_height, "anchor_hash": anchor_hash,
         "chunks": []})
    snap_layout.publish_current(root, name)


async def storage_differential(blocks: int = 2400, *, seed: int = 0,
                               segment_blocks: int = 256,
                               safety_window: int = 64,
                               workdir: Optional[str] = None,
                               page: int = 100) -> dict:
    """Compact a synthetic chain and deep-read it against an untouched
    twin.  Returns ``{"ok": bool, ...stats}``; ``mismatches`` carries
    the first few diverging probes for diagnosis."""
    from ..config import ArchiveConfig
    from ..state.storage import ChainState
    from . import compactor
    from .reader import ArchiveReader

    tmp = workdir or tempfile.mkdtemp(prefix="archive-parity-")
    owns_tmp = workdir is None
    try:
        arch_dir = os.path.join(tmp, "archive")
        snap_dir = os.path.join(tmp, "snapshot")
        os.makedirs(snap_dir, exist_ok=True)
        pruned, twin = ChainState(), ChainState()
        witness_from = blocks - safety_window - segment_blocks
        for st in (pruned, twin):
            build_synthetic_chain(st, blocks, seed=seed,
                                  witness_from=witness_from)
        tip = await twin.get_block_by_id(blocks)
        publish_fake_snapshot(snap_dir, blocks, tip["hash"])

        cfg = ArchiveConfig(dir=arch_dir, segment_blocks=segment_blocks,
                            safety_window=safety_window)
        pruned.archive = ArchiveReader(arch_dir)
        hot_before = await pruned.archive_hot_row_counts()
        stats = await compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                        reader=pruned.archive)
        hot_after = await pruned.archive_hot_row_counts()

        mismatches: List[str] = []
        probes = 0

        def check(label: str, a, b) -> None:
            nonlocal probes
            probes += 1
            if _fp(a) != _fp(b):
                mismatches.append(label)

        tx_hashes: List[str] = []
        for h in range(1, blocks + 1):
            a = await pruned.get_block_by_id(h)
            b = await twin.get_block_by_id(h)
            check(f"get_block_by_id({h})", a, b)
            if b is not None:
                check(f"get_block({b['hash']})",
                      await pruned.get_block(b["hash"]),
                      await twin.get_block(b["hash"]))
                tx_hashes.extend(
                    await twin.get_block_transaction_hashes(b["hash"]))
        for off in range(1, blocks + 1, page):
            check(f"get_blocks({off},{page})",
                  await pruned.get_blocks(off, page, tx_details=True),
                  await twin.get_blocks(off, page, tx_details=True))
        for th in tx_hashes:
            check(f"get_transaction_info({th})",
                  await pruned.get_transaction_info(th),
                  await twin.get_transaction_info(th))
            check(f"get_nice_transaction({th})",
                  await pruned.get_nice_transaction(th),
                  await twin.get_nice_transaction(th))
            check(f"get_transaction_block_timestamp({th})",
                  await pruned.get_transaction_block_timestamp(th),
                  await twin.get_transaction_block_timestamp(th))
            ta = await pruned.get_transaction(th)
            tb = await twin.get_transaction(th)
            check(f"get_transaction({th})",
                  ta.hex() if ta else None, tb.hex() if tb else None)
        for addr in _addresses():
            for off in range(0, blocks, 500):
                a = await pruned.get_address_transactions(
                    addr, limit=500, offset=off)
                b = await twin.get_address_transactions(
                    addr, limit=500, offset=off)
                check(f"get_address_transactions({addr[:12]},{off})",
                      [r["tx_hash"] for r in a],
                      [r["tx_hash"] for r in b])
        result = {
            "ok": not mismatches and bool(stats.get("ok")),
            "blocks": blocks,
            "compaction": stats,
            "hot_before": hot_before,
            "hot_after": hot_after,
            "probes": probes,
            "reader": pruned.archive.stats(),
            "mismatches": mismatches[:20],
        }
        if mismatches:
            log.error("archive differential diverged on %d/%d probes: %s",
                      len(mismatches), probes, mismatches[:5])
        return result
    finally:
        if owns_tmp:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: shutil.rmtree(tmp, ignore_errors=True))


# ------------------------------------------------------- observatory ----

def archive_rows(art: dict) -> dict:
    """Gate-facing rows from an ``archive_prune`` scenario artifact."""
    from ..swarm.scenarios import core_ok

    core = art["core"]
    ok = core_ok(core)
    kernels = {
        "archive_parity_ok": {
            "value": 1.0 if ok else 0.0, "unit": "bool",
            "direction": "higher",
            "desc": "pruned node answered every archived read "
                    "byte-identically to its unpruned twin "
                    "(0 = divergence)"},
        "archive_hot_blocks_pruned": {
            "value": float(core.get("hot_blocks_before", 0)
                           - core.get("hot_blocks_after", 0)),
            "unit": "blocks", "direction": "higher",
            "desc": "hot-tier block rows retired to the cold archive "
                    "by the scenario's compaction"},
    }
    slo_endpoints = {
        k.replace("swarm.", "archive.", 1): v
        for k, v in art["slo"]["endpoints"].items()}
    return {"kernels": kernels, "slo_endpoints": slo_endpoints}


def observatory_section(seed: int = 7, device=None) -> dict:
    """Run the archive_prune scenario and shape it for the observatory
    artifact (the ``fleet`` section's idiom); its swarm runs on
    ``device`` (None: the card)."""
    from ..swarm.scenarios import run_scenario

    art = run_scenario("archive_prune", seed=seed, device=device)
    rows = archive_rows(art)
    core = art["core"]
    section = {
        "scenario": "archive_prune",
        "nodes": art["nodes"],
        "seed": seed,
        "fingerprint": art["fingerprint"],
        "core_ok": rows["kernels"]["archive_parity_ok"]["value"] == 1.0,
        "archived_through": core.get("archived_through", 0),
        "hot_blocks": {"before": core.get("hot_blocks_before", 0),
                       "after": core.get("hot_blocks_after", 0)},
        "hot_txs": {"before": core.get("hot_txs_before", 0),
                    "after": core.get("hot_txs_after", 0)},
        "flight_recorder": art.get("flight_recorder", {}).get("reason"),
    }
    return {"section": section, "kernels": rows["kernels"],
            "slo_endpoints": rows["slo_endpoints"], "artifact": art}
