"""The port's cold-block archive (``upow_tpu_torch.archive``) against the
JAX package's.

JAX ``tests/test_archive.py``'s cases that need no swarm scenario run once
on each package (the store, the compactor, the reader and both storage
backends of that package, the two swarm cases on that package's own
``Swarm``): each case records its outcome (the error, the archive
directory's listing, the stats dicts, the hot row counts, the bodies the
node served) and the two records must be equal.  Cross-package: the
port's segment payload, ``index.json`` and manifest bytes equal the JAX
store's for the same rows, on sqlite and on pg over each package's
``MockPgDriver``; the storage differential's segment digests equal the
JAX run's; a JAX node and a port node on one chain, compacted alike,
answer the same bodies on the archive routes and the block, transaction
and address reads across the seam, with the same ``archive_*`` families;
each mirrors the other's archive to byte-identical files; a reorg inside
the safety window whose rollback restores outputs of pruned blocks gives
both packages the same UTXO hash on both backends; and a compaction
leaves an armed resident index (on the CPU) equal to SQL without
re-arming it.  The ``archive_prune`` scenario runs on both packages with
equal fingerprints, and so do ``archive_rows`` and
``observatory_section``.  The port's CLI prints the JAX CLI's lines for
all three legs with ``--device cpu``; without it and without a card,
leg 3 fails naming the missing card.
"""

import asyncio
import functools
import hashlib
import json
import os
import re
import shutil
import sqlite3
import subprocess
import sys
from decimal import Decimal
from types import SimpleNamespace

import aiohttp
import pytest
import torch
from aiohttp.test_utils import TestServer

import upow_tpu.archive.compactor as jcompactor
import upow_tpu.archive.parity as jparity
import upow_tpu.archive.reader as jreader
import upow_tpu.archive.store as jstore
import upow_tpu.config as jconfig
import upow_tpu.node.app as japp
import upow_tpu.node.ratelimit as jratelimit
import upow_tpu.resilience.faultinject as jfaultinject
import upow_tpu.snapshot.builder as jbuilder
import upow_tpu.snapshot.client as jclient
import upow_tpu.snapshot.layout as jlayout
import upow_tpu.state.pg as jpg
import upow_tpu.state.pgdriver as jdrv
import upow_tpu.swarm as jswarm
import upow_tpu.swarm.scenarios as jscenarios
import upow_tpu_torch.archive.__main__ as tarchive_main
import upow_tpu_torch.archive.compactor as tcompactor
import upow_tpu_torch.archive.parity as tparity
import upow_tpu_torch.archive.reader as treader
import upow_tpu_torch.archive.store as tstore
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.node.ratelimit as tratelimit
import upow_tpu_torch.resilience.faultinject as tfaultinject
import upow_tpu_torch.snapshot.builder as tbuilder
import upow_tpu_torch.snapshot.client as tclient
import upow_tpu_torch.snapshot.layout as tlayout
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.pgdriver as tdrv
import upow_tpu_torch.state.storage as tstorage
import upow_tpu_torch.swarm as tswarm
import upow_tpu_torch.swarm.scenarios as tscenarios
from test_torch_block import JAX, PORT, T0
from test_torch_gossip import _jcfg, _tcfg
from test_torch_snapshot import _hashes, _sql_exists
from test_torch_wallet import Run, easy_chain  # noqa: F401  (fixture)
from test_wallet import make_actors

A = {
    "jax": SimpleNamespace(
        pkg=JAX, compactor=jcompactor, parity=jparity, reader=jreader,
        store=jstore, ArchiveConfig=jconfig.ArchiveConfig, app=japp,
        RateLimiter=jratelimit.RateLimiter, faultinject=jfaultinject,
        builder=jbuilder, client=jclient, layout=jlayout, pg=jpg, drv=jdrv,
        swarm=jswarm, scenarios=jscenarios),
    "port": SimpleNamespace(
        pkg=PORT, compactor=tcompactor, parity=tparity, reader=treader,
        store=tstore, ArchiveConfig=tconfig.ArchiveConfig, app=tapp,
        RateLimiter=tratelimit.RateLimiter, faultinject=tfaultinject,
        builder=tbuilder, client=tclient, layout=tlayout, pg=tpg, drv=tdrv,
        swarm=SimpleNamespace(Swarm=functools.partial(tswarm.Swarm,
                                                      device="cpu")),
        scenarios=tscenarios),
}
ACTORS = make_actors()
GENESIS = ACTORS["genesis"]
SINK = ACTORS["outsider"][1]


def run(coro):
    return asyncio.run(coro)


def _both(case, tmp_path=None):
    """Run ``case(a, tmp)`` for each package (in a directory of its own
    when ``tmp_path`` is given); the two records must be equal."""
    out = {}
    for name in ("jax", "port"):
        tmp = None
        if tmp_path is not None:
            tmp = tmp_path / name
            tmp.mkdir()
        out[name] = case(A[name], tmp)
    assert out["port"] == out["jax"]
    return out["port"]


def _listing(root) -> list:
    """Every file under ``root`` with its bytes' sha256."""
    out = []
    for base, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out.append((os.path.relpath(path, root),
                            hashlib.sha256(fh.read()).hexdigest()))
    return sorted(out)


def _twins(a, tmp, blocks=96, *, seed=0, segment_blocks=8,
           safety_window=8):
    """JAX ``_twins`` on package ``a``: identical synthetic chains, a
    published snapshot anchored at the tip, the archive dir wired to the
    first state."""
    arch_dir = os.path.join(tmp, "archive")
    snap_dir = os.path.join(tmp, "snapshot")
    os.makedirs(snap_dir, exist_ok=True)
    pruned, twin = a.pkg.ChainState(), a.pkg.ChainState()
    for st in (pruned, twin):
        a.parity.build_synthetic_chain(st, blocks, seed=seed,
                                       witness_from=blocks - safety_window)
    tip_hash = pruned.db.execute(
        "SELECT hash FROM blocks WHERE id = ?", (blocks,)).fetchone()[0]
    a.parity.publish_fake_snapshot(snap_dir, blocks, tip_hash)
    cfg = a.ArchiveConfig(dir=arch_dir, segment_blocks=segment_blocks,
                          safety_window=safety_window)
    pruned.archive = a.reader.ArchiveReader(arch_dir)
    return pruned, twin, cfg, (arch_dir, snap_dir)


# ------------------------------------------------------------- store ----

def test_segment_encode_is_deterministic_and_roundtrips(tmp_path):
    def case(a, tmp):
        async def main():
            st = a.pkg.ChainState()
            a.parity.build_synthetic_chain(st, 8, seed=3)
            blocks, txs = await st.archive_export_span(1, 8)
            p1, i1 = a.store.encode_segment(1, 8, blocks, txs)
            p2, i2 = a.store.encode_segment(1, 8, blocks, txs)
            decoded = a.store.decode_segment(p1)
            s = a.store.ArchiveStore(str(tmp), 8)
            r1 = s.write_segment(1, 8, blocks, txs)
            r2 = s.write_segment(1, 8, blocks, txs)
            return (p1 == p2, i1 == i2, sorted(decoded),
                    decoded[3][0] == blocks[2],
                    decoded[3][1] == txs[blocks[2][1]], r1 == r2,
                    s.verify_segment(r1), p1, i1, r1, _listing(tmp))
        return run(main())
    got = _both(case, tmp_path)
    assert got[:7] == (True, True, list(range(1, 9)), True, True, True,
                       True)


def test_store_rejects_malformed_current_and_payload(tmp_path):
    def case(a, tmp):
        s = a.store.ArchiveStore(str(tmp), 8)
        out = [s.current_manifest()]
        for hostile in ("../etc/passwd", ".hidden", "a/b"):
            with open(os.path.join(str(tmp), "CURRENT"), "w") as fh:
                fh.write(hostile + "\n")
            out.append(s.current_manifest())
        try:
            a.store.decode_segment(b"not json lines\n")
        except ValueError as e:
            out.append(type(e).__name__)
        return out
    assert _both(case, tmp_path) == [None] * 4 + ["JSONDecodeError"]


def test_fetched_segment_rejects_lying_peer(tmp_path):
    def case(a, tmp):
        async def main():
            st = a.pkg.ChainState()
            a.parity.build_synthetic_chain(st, 8, seed=5)
            blocks, txs = await st.archive_export_span(1, 8)
            src = a.store.ArchiveStore(str(tmp / "src"), 8)
            record = src.write_segment(1, 8, blocks, txs)
            payload = src.read_payload(record["name"])
            dst = a.store.ArchiveStore(str(tmp / "dst"), 8)
            errors = []
            evil = bytearray(payload)
            evil[5] ^= 0xFF
            forged = dict(record, index_sha256="0" * 64)
            for rec, data in ((record, bytes(evil)), (forged, payload)):
                try:
                    dst.write_fetched_segment(rec, data)
                    errors.append(None)
                except ValueError as e:
                    errors.append(type(e).__name__)
            listing = _listing(tmp / "dst")
            dst.write_fetched_segment(record, payload)
            return errors, listing, dst.verify_segment(record), \
                _listing(tmp / "dst")
        return run(main())
    errors, before, ok, after = _both(case, tmp_path)
    # a flipped byte no longer decodes; a forged index digest is refused
    assert errors == ["UnicodeDecodeError", "ValueError"]
    assert before == [] and ok and len(after) == 2


# ------------------------------------------------------------ ratelimit ----

def test_archive_segment_indexes_share_one_ratelimit_bucket():
    def case(a, _tmp):
        rl = a.RateLimiter()
        allowed = sum(rl.allow("1.2.3.4", f"/archive/segment/{i}")
                      for i in range(15))
        return (allowed, rl.allow("1.2.3.4", "/archive/manifest"),
                rl.allow("5.6.7.8", "/archive/segment/0"))
    assert _both(case) == (10, True, True)


# ------------------------------------------------------- crash + resume ----

def test_kill_between_commit_and_prune_resumes_lossless(tmp_path):
    def case(a, tmp):
        async def main():
            pruned, twin, cfg, (arch_dir, snap_dir) = _twins(a, str(tmp))
            a.faultinject.install("archive.compact:error:key=prune", 1)
            try:
                await a.compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                          reader=pruned.archive)
                raised = None
            except a.faultinject.FaultInjected as e:
                raised = str(e)
            finally:
                a.faultinject.uninstall()
            store = a.store.ArchiveStore(arch_dir, cfg.segment_blocks)
            mid = (store.read_journal(), store.current_manifest(),
                   await pruned.archive_hot_row_counts(),
                   _listing(arch_dir))
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            journal = store.read_journal()
            again = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            same = [await pruned.get_block_by_id(h)
                    == await twin.get_block_by_id(h) for h in range(1, 97)]
            return (raised, mid, stats, journal, again, same,
                    await pruned.archive_hot_row_counts(),
                    _listing(arch_dir))
        return run(main())
    raised, mid, stats, journal, again, same, hot, _ = _both(case, tmp_path)
    assert raised is not None and mid[0] is not None and mid[1] is not None
    assert mid[2]["blocks"] == 96
    assert stats["ok"] and stats["resumed"] and stats["pruned_blocks"] > 0
    assert journal is None
    assert again["ok"] and again["segments_built"] == 0 \
        and again["pruned_blocks"] == 0
    assert all(same) and hot["blocks"] < 96


def test_kill_before_publish_deletes_nothing(tmp_path):
    def case(a, tmp):
        async def main():
            pruned, _twin, cfg, (arch_dir, snap_dir) = _twins(a, str(tmp))
            a.faultinject.install("archive.compact:error:key=publish", 1)
            try:
                await a.compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                          reader=pruned.archive)
                raised = False
            except a.faultinject.FaultInjected:
                raised = True
            finally:
                a.faultinject.uninstall()
            store = a.store.ArchiveStore(arch_dir, cfg.segment_blocks)
            mid = (store.current_manifest(), store.read_journal(),
                   await pruned.archive_hot_row_counts(),
                   _listing(arch_dir))
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            return raised, mid, stats, _listing(arch_dir)
        return run(main())
    raised, mid, stats, _ = _both(case, tmp_path)
    assert raised and mid[0] is None and mid[1] is None
    assert mid[2]["blocks"] == 96 and len(mid[3]) > 0  # staged segments
    assert stats["ok"] and stats["pruned_blocks"] > 0


def test_export_gap_aborts_instead_of_publishing_a_hole(tmp_path):
    def case(a, tmp):
        async def main():
            pruned, _twin, cfg, (arch_dir, snap_dir) = _twins(a, str(tmp))
            pruned.db.execute("DELETE FROM blocks WHERE id = 5")
            pruned.db.commit()
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            return stats, a.store.ArchiveStore(
                arch_dir, cfg.segment_blocks).current_manifest()
        return run(main())
    stats, manifest = _both(case, tmp_path)
    assert not stats["ok"] and stats["reason"] == "export_gap"
    assert manifest is None


@pytest.mark.parametrize("reason, blocks, window, snapshot", [
    ("no_snapshot", 16, 4, False),
    ("below_safety_window", 4, 4, True),
    ("nothing_archived", 16, 4, True),
])
def test_compaction_refusals_give_the_jax_reason(tmp_path, reason, blocks,
                                                 window, snapshot):
    """The stats dict of each ``ok: False`` cycle (``nothing_archived``:
    the cutoff leaves no full segment of 32)."""
    def case(a, tmp):
        async def main():
            arch_dir, snap_dir = str(tmp / "archive"), str(tmp / "snap")
            os.makedirs(snap_dir)
            st = a.pkg.ChainState()
            a.parity.build_synthetic_chain(st, blocks)
            if snapshot:
                tip = await st.get_block_by_id(blocks)
                a.parity.publish_fake_snapshot(snap_dir, blocks, tip["hash"])
            cfg = a.ArchiveConfig(dir=arch_dir, segment_blocks=32,
                                  safety_window=window)
            stats = await a.compactor.compact(st, arch_dir, snap_dir, cfg)
            return stats, await st.archive_hot_row_counts(), \
                _listing(arch_dir)
        return run(main())
    stats, hot, _ = _both(case, tmp_path)
    assert stats["reason"] == reason and hot["blocks"] == blocks


# ---------------------------------------------------------- differential ----

def test_pruned_reads_match_unpruned_twin():
    def case(a, _tmp):
        res = run(a.parity.storage_differential(
            320, seed=11, segment_blocks=32, safety_window=16))
        res["reader"].pop("root")
        return res
    res = _both(case)
    assert res["ok"], res["mismatches"]
    assert res["compaction"]["pruned_blocks"] > 0
    assert res["hot_after"]["blocks"] < res["hot_before"]["blocks"]
    assert res["reader"]["fallthrough_reads"] > 0


def test_storage_differential_segments_equal_the_jax_runs(tmp_path):
    """The same differential in a kept work directory: the published
    manifest and every segment file are the JAX run's, byte for byte."""
    def case(a, tmp):
        res = run(a.parity.storage_differential(
            320, seed=11, segment_blocks=32, safety_window=16,
            workdir=str(tmp)))
        manifest = a.store.ArchiveStore(
            str(tmp / "archive")).current_manifest()
        return (res["ok"], res["compaction"]["pruned_blocks"],
                res["reader"]["fallthrough_reads"],
                [(s["payload_sha256"], s["index_sha256"])
                 for s in manifest["segments"]],
                _listing(str(tmp / "archive")))
    ok, pruned, reads, digests, listing = _both(case, tmp_path)
    assert ok and pruned > 0 and reads > 0 and len(digests) == 9
    assert len(listing) == 2 * 9 + 2  # payload + index a segment, CURRENT


def test_witness_blocks_stay_hot_and_unsplit(tmp_path):
    def case(a, tmp):
        async def main():
            pruned, _twin, cfg, (arch_dir, snap_dir) = _twins(
                a, str(tmp), blocks=64, segment_blocks=8, safety_window=8)
            r = pruned.db.execute(
                "SELECT t.tx_hash, t.outputs_addresses FROM transactions t"
                " JOIN blocks b ON b.hash = t.block_hash WHERE b.id = 10"
            ).fetchone()
            pruned.db.execute(
                "INSERT INTO unspent_outputs (tx_hash, idx, address, amount)"
                " VALUES (?,?,?,?)",
                (r["tx_hash"], 0, json.loads(r["outputs_addresses"])[0], 1))
            pruned.db.commit()
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            blk = pruned.db.execute(
                "SELECT hash FROM blocks WHERE id = 10").fetchone()
            txs = pruned.db.execute(
                "SELECT COUNT(*) AS n FROM transactions WHERE block_hash = ?",
                (blk["hash"],)).fetchone()["n"] if blk else 0
            neighbours = pruned.db.execute(
                "SELECT COUNT(*) AS n FROM blocks WHERE id IN (9, 11)"
            ).fetchone()["n"]
            return stats, blk is not None, txs, neighbours
        return run(main())
    stats, kept, txs, neighbours = _both(case, tmp_path)
    assert stats["ok"] and kept and txs == 1 and neighbours == 0


async def _spent_chain(pkg, backend, tip=28, spend_at=None):
    """``tip`` blocks to the genesis actor, one of them (``spend_at``,
    the tip by default) carrying a tx that spends every coinbase before
    it to the sink: those blocks leave the witness closure."""
    spend_at = spend_at or tip
    r = Run(pkg, backend)
    d, addr = GENESIS
    for h in range(1, tip + 1):
        if h == spend_at:
            outs = await r.state.get_spendable_outputs(addr)
            amount = Decimal(sum(o.amount for o in outs)) / 10 ** 8
            await r.push(r.builder.create_transaction(d, SINK, amount))
            await r.mine(addr, include_pending=True)
        else:
            await r.mine(addr)
    return r.state


def test_pg_backend_archive_parity(tmp_path):
    """JAX's pg case on each package: two pg states restored from the
    package's own snapshot payload, one compacted; every read matches
    the unpruned pg twin."""
    def case(a, tmp):
        async def main():
            src = await _spent_chain(a.pkg, "sqlite", tip=24, spend_at=17)
            payload, _ = await a.builder.serialize_payload(src,
                                                          blocks_tail=24)
            tables, txs, blocks = a.client.parse_payload(payload)
            pruned = a.pg.PgChainState(driver=a.drv.MockPgDriver())
            twin = a.pg.PgChainState(driver=a.drv.MockPgDriver())
            for pg in (pruned, twin):
                await pg.restore_snapshot(tables, txs, blocks)
            arch_dir, snap_dir = str(tmp / "archive"), str(tmp / "snap")
            os.makedirs(snap_dir)
            tip = await twin.get_block_by_id(24)
            a.parity.publish_fake_snapshot(snap_dir, 24, tip["hash"])
            cfg = a.ArchiveConfig(dir=arch_dir, segment_blocks=4,
                                  safety_window=4)
            pruned.archive = a.reader.ArchiveReader(arch_dir)
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            same = []
            for h in range(1, 25):
                b = await twin.get_block_by_id(h)
                same.append(await pruned.get_block_by_id(h) == b)
                same.append(await pruned.get_block(b["hash"]) == b)
                for th in await twin.get_block_transaction_hashes(b["hash"]):
                    same.append(await pruned.get_transaction_info(th)
                                == await twin.get_transaction_info(th))
                    same.append((await pruned.get_transaction(th)).hex()
                                == (await twin.get_transaction(th)).hex())
            same.append(await pruned.get_blocks(1, 24, tx_details=True)
                        == await twin.get_blocks(1, 24, tx_details=True))
            hist = [[r["tx_hash"] for r in await st.get_address_transactions(
                GENESIS[1], limit=50)] for st in (pruned, twin)]
            out = (stats, same, hist[0] == hist[1],
                   await pruned.archive_hot_row_counts(),
                   pruned.archive.stats()["fallthrough_reads"] > 0)
            src.close()
            return out
        return run(main())
    stats, same, hist, hot, reads = _both(case, tmp_path)
    assert stats["ok"] and stats["archived_through"] == 16
    assert stats["pruned_blocks"] > 0 and all(same) and hist and reads


# ------------------------------------------------------------- endpoints ----

def _swarm_case(a, tmp, seed, drive, hook=None):
    """``drive(a, swarm, node, addr, tmp)`` on a one-node swarm of the
    package, inside its own deterministic world."""
    async def main():
        swarm = await a.swarm.Swarm(1, seed=seed, cfg_hook=hook).start(
            topology="isolated")
        try:
            _, addr = a.scenarios._wallet(seed, "shared")
            return await drive(a, swarm, swarm.nodes[0], addr, tmp)
        finally:
            await swarm.close()
    with a.scenarios.deterministic_world(seed):
        return run(main())


def test_archive_endpoints_serve_fresh_without_cache_bypass(tmp_path):
    """JAX's case on each package's swarm: ``/archive/*`` are never
    read-cache entries, ``/debug/archive`` reports the seam and the
    ``archive_*`` families render once each; the bodies are the same."""
    async def drive(a, swarm, node, addr, tmp):
        node.config.snapshot.dir = os.path.join(tmp, "snap")
        node.config.snapshot.blocks_tail = 2
        acfg = node.config.archive
        acfg.dir = os.path.join(tmp, "archive")
        acfg.segment_blocks = 2
        acfg.safety_window = 2
        node.state.archive = a.reader.ArchiveReader(acfg.dir)
        out = [await swarm.get(0, "archive/manifest")]
        for _ in range(8):
            out.append((await swarm.mine(0, addr, push_to=[0]))["ok"])
        out.append((await node.build_snapshot())["anchor_height"])
        out.append(await node.compact_archive())
        m1 = await swarm.get(0, "archive/manifest")
        out.append(m1)
        seg = await swarm.get(0, "archive/segment/0")
        out.append(seg)
        data = bytes.fromhex(seg["result"]["data"])
        out.append(hashlib.sha256(data).hexdigest()
                   == m1["result"]["segments"][0]["payload_sha256"])
        out.append(await swarm.get(0, "archive/segment/zzz"))
        out.append(await swarm.get(
            0, f"archive/segment/{len(m1['result']['segments'])}"))
        for _ in range(4):
            out.append((await swarm.mine(0, addr, push_to=[0]))["ok"])
        await node.build_snapshot()
        out.append(await node.compact_archive())
        out.append(await swarm.get(0, "archive/manifest"))
        dbg = (await swarm.get(0, "debug/archive"))["result"]
        dbg["reader"].pop("root")
        out.append(dbg)
        _, body = await swarm.hub.request(swarm.driver, swarm.urls[0],
                                          "GET", "/metrics")
        names = [ln.split(" ")[0] for ln in body.decode().splitlines()
                 if ln.startswith("upow_archive")]
        out.append((len(names) == len(set(names)), sorted(names)))
        return out

    def case(a, tmp):
        return _swarm_case(a, tmp, 3, drive)
    out = _both(case, tmp_path)
    assert out[0] == {"ok": False, "error": "no archive available"}
    assert out[10]["archived_through"] == 4 and out[13] is True
    assert out[14] == {"ok": False,
                       "error": "segment index must be an integer"}
    assert out[15] == {"ok": False, "error": "no such segment"}
    assert out[20]["archived_through"] > out[10]["archived_through"]
    assert out[21]["result"]["archived_through"] == \
        out[20]["archived_through"]
    assert out[22]["last_compaction"]["ok"] and out[23][0]


def test_snapshot_rebuild_arms_compactor_on_block_cadence(tmp_path):
    def hook_for(tmp):
        def hook(i, cfg):
            cfg.snapshot.dir = os.path.join(tmp, f"snap{i}")
            cfg.snapshot.blocks_tail = 2
            cfg.snapshot.rebuild_interval_blocks = 4
            cfg.snapshot.rebuild_jitter_blocks = 0
            cfg.archive.dir = os.path.join(tmp, f"archive{i}")
            cfg.archive.segment_blocks = 2
            cfg.archive.safety_window = 2
        return hook

    async def drive(a, swarm, node, addr, tmp):
        target = node._rebuild_target
        for _ in range(9):
            assert (await swarm.mine(0, addr, push_to=[0]))["ok"]
        for _ in range(200):
            await swarm.settle()
            if node.archive_compact.get("ok"):
                break
            await asyncio.sleep(0.01)
        cov = await node.state.archive.coverage()
        return (target, node.archive_compact, cov,
                a.layout.current_manifest(node.config.snapshot.dir)
                is not None)

    def case(a, tmp):
        return _swarm_case(a, tmp, 5, drive, hook=hook_for(str(tmp)))
    target, compact, cov, published = _both(case, tmp_path)
    assert target == 4 and compact.get("ok") and published
    assert cov is not None and cov[0] == 1


def test_rebuild_jitter_varies_by_identity(tmp_path):
    """The port node's cadence target is JAX's function of its identity."""
    def target(ident, interval=64, jitter=16):
        return interval + int.from_bytes(
            hashlib.sha256(ident.encode()).digest()[:4], "big") % (
                jitter + 1)

    got = {}
    for i in range(4):
        cfg = _tcfg(tmp_path, f"n{i}")
        cfg.snapshot.dir = str(tmp_path / f"snap{i}")
        cfg.snapshot.rebuild_interval_blocks = 64
        cfg.snapshot.rebuild_jitter_blocks = 16
        cfg.node.self_url = f"127.0.0.1:{3000 + i}"
        node = tapp.Node(cfg, device="cpu")
        got[cfg.node.self_url] = node._rebuild_target
        run(node.close())
    assert got == {u: target(u) for u in got}
    assert len(set(got.values())) > 1
    assert all(64 <= t <= 80 for t in got.values())


# ------------------------------------------------------ across packages ----

@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_segment_bytes_equal_the_jax_stores(tmp_path, backend):
    """Each package's chain on the backend (a send among coinbases, the
    difficulty column as each writes it) exported, encoded, written and
    published by each package's store: the payload, ``index.json`` and
    manifest bytes are the same.  On sqlite the port's state also
    exports the JAX-written file to the same rows."""
    out = {}
    for name in ("jax", "port"):
        a = A[name]

        async def main():
            st = await _spent_chain(a.pkg, backend, tip=12, spend_at=6)
            rows = [await st.archive_export_span(lo, lo + 3)
                    for lo in (1, 5, 9)]
            if backend == "sqlite" and name == "jax":
                path = str(tmp_path / "jax.db")
                dst = sqlite3.connect(path)
                st.db.backup(dst)
                dst.close()
                other = PORT.ChainState(path)
                out["port_reads_jax_file"] = [
                    await other.archive_export_span(lo, lo + 3)
                    for lo in (1, 5, 9)]
                other.close()
            st.close()
            return rows
        rows = run(main())
        root = tmp_path / name
        store = a.store.ArchiveStore(str(root), 4)
        records = [store.write_segment(lo, lo + 3, *r)
                   for lo, r in zip((1, 5, 9), rows)]
        store.publish(records)
        encoded = [a.store.encode_segment(lo, lo + 3, *r)
                   for lo, r in zip((1, 5, 9), rows)]
        out[name] = (rows, [p for p, _i in encoded],
                     [a.layout.canonical_json(i) for _p, i in encoded],
                     records, _listing(str(root)))
    assert out["port"] == out["jax"]
    rows = out["port"][0]
    assert [b[5] for r in rows for b in r[0]] == ["1.0"] * 12
    if backend == "sqlite":
        assert out["port_reads_jax_file"] == rows


def _spent_file(path):
    """The JAX package's 28-block chain (the coinbases of 1-20 spent in
    block 21) in a sqlite file."""
    async def main():
        st = await _spent_chain(JAX, "sqlite", tip=28, spend_at=21)
        dst = sqlite3.connect(path)
        st.db.backup(dst)
        dst.close()
        st.close()
    run(main())


def _archive_cfg(cfg, tmp_path, name):
    cfg.snapshot.dir = str(tmp_path / f"{name}.snap")
    cfg.snapshot.blocks_tail = 4
    cfg.archive.dir = str(tmp_path / f"{name}.archive")
    cfg.archive.segment_blocks = 4
    cfg.archive.safety_window = 4
    return cfg


async def _serve_pair(tmp_path, names):
    """A JAX node (aiohttp ``TestServer``) or a port node (its own
    server) for each name, on copies of the chain file."""
    nodes, urls, servers = {}, {}, []
    for name in names:
        if name.startswith("jax"):
            node = japp.Node(_archive_cfg(_jcfg(tmp_path, name), tmp_path,
                                          name))
            server = TestServer(node.app, host="127.0.0.1")
            await server.start_server()
            servers.append(server)
            port = server.port
        else:
            node = tapp.Node(_archive_cfg(_tcfg(tmp_path, name), tmp_path,
                                          name), device="cpu")
            port = (await node.serve("127.0.0.1", 0)).port
        node.started = True
        node.self_url = urls[name] = f"http://127.0.0.1:{port}"
        nodes[name] = node
    return nodes, urls, servers


async def _close_pair(nodes, servers):
    for name, node in nodes.items():
        if not name.startswith("jax"):
            await node.close()
    for server in servers:
        await server.close()
    for name, node in nodes.items():
        if name.startswith("jax"):
            await node.close()


ROUTE_PROBES = [
    "archive/manifest", "archive/segment/0", "archive/segment/4",
    "archive/segment/5", "archive/segment/-1", "archive/segment/zzz",
    "archive/segment/%7Bi%7D", "archive/segment/", "archive/segment/1/2",
    "archive/segment/+1", "archive/segment/%201",
]


def _read_probes(hashes):
    """The reads a pruned node answers from segments and hot rows."""
    probes = []
    for h in (1, 2, 20, 21, 24, 28):
        probes.append(f"get_block?block={h}&full_transactions=true")
        probes.append(f"get_block_details?block={h}")
    probes += [f"get_block?block={hashes['block1']}",
               f"get_block_details?block={hashes['block21']}",
               "get_blocks?offset=1&limit=30",
               "get_blocks?offset=18&limit=6",
               "get_blocks_details?offset=1&limit=30",
               f"get_transaction?tx_hash={hashes['coinbase1']}",
               f"get_transaction?tx_hash={hashes['spend']}",
               f"get_address_info?address={GENESIS[1]}",
               f"get_address_info?address={SINK}",
               f"get_address_transactions?address={GENESIS[1]}"
               "&page=1&limit=15",
               f"get_address_transactions?address={GENESIS[1]}"
               "&page=2&limit=15"]
    return probes


ARCHIVE_FAMILIES = ("upow_archive_segments", "upow_archive_archived_blocks",
                    "upow_archive_archived_txs",
                    "upow_archive_hot_rows_pruned_total",
                    "upow_archive_fallthrough_reads_total")


def _families(text):
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name in ARCHIVE_FAMILIES:
            out[name] = value
    return out


def test_jax_and_port_nodes_serve_the_same_pruned_chain(tmp_path):
    """A JAX node and a port node on copies of one chain, each with the
    same archive config, build a snapshot and compact: the same stats,
    and the same bodies on the archive routes (bad indexes included) and
    on block, page, transaction and address reads of pruned and hot
    heights, as a third port node on an unpruned copy answers the reads;
    then the same ``archive_*`` family values."""
    _spent_file(str(tmp_path / "chain.db"))
    for name in ("jax", "port", "twin"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 10 ** 6)

    async def main():
        nodes, urls, servers = await _serve_pair(
            tmp_path, ("jax", "port", "twin"))
        try:
            stats = {}
            for name in ("jax", "port"):
                await nodes[name].build_snapshot()
                stats[name] = await nodes[name].compact_archive()
            twin = nodes["twin"].state
            b1 = await twin.get_block_by_id(1)
            b21 = await twin.get_block_by_id(21)
            hashes = {
                "block1": b1["hash"], "block21": b21["hash"],
                "coinbase1": (await twin.get_block_transaction_hashes(
                    b1["hash"]))[0],
                "spend": (await twin.get_block_transaction_hashes(
                    b21["hash"]))[1]}
            bodies, twin_same = [], []
            async with aiohttp.ClientSession() as s:
                for path in ROUTE_PROBES + _read_probes(hashes):
                    got = {}
                    for name in ("jax", "port", "twin"):
                        async with s.get(f"{urls[name]}/{path}",
                                         allow_redirects=False) as resp:
                            got[name] = (resp.status, await resp.read())
                    assert got["port"] == got["jax"], (path, got)
                    bodies.append(got["port"])
                    if not path.startswith("archive"):
                        twin_same.append(got["twin"] == got["port"])
                async with s.post(f"{urls['port']}/archive/segment/0") as r:
                    posted = r.status
                metrics = {}
                for name in ("jax", "port"):
                    async with s.get(f"{urls[name]}/metrics") as resp:
                        metrics[name] = _families(await resp.text())
            hot = await nodes["port"].state.archive_hot_row_counts()
        finally:
            await _close_pair(nodes, servers)
        return stats, bodies, twin_same, posted, metrics, hot

    stats, bodies, twin_same, posted, metrics, hot = run(main())
    assert stats["port"] == stats["jax"]
    assert stats["port"]["ok"] and stats["port"]["archived_through"] == 20
    assert stats["port"]["pruned_blocks"] == 20 and hot["blocks"] == 8
    assert [b[0] for b in bodies[:len(ROUTE_PROBES)]] == [
        200, 200, 200, 404, 404, 422, 404, 404, 404, 200, 200]
    assert all(b[0] == 200 for b in bodies[len(ROUTE_PROBES):])
    assert all(twin_same) and posted == 405
    assert metrics["port"] == metrics["jax"]
    assert metrics["port"]["upow_archive_hot_rows_pruned_total"] == "40"
    assert float(metrics["port"]["upow_archive_fallthrough_reads_total"]) > 0


def test_nodes_mirror_each_others_archives(tmp_path):
    """A blank port node mirrors a JAX node's archive over
    ``/archive/*`` and a blank JAX node a port node's: every file the
    same bytes as the source's; a second fetch reuses every segment."""
    _spent_file(str(tmp_path / "chain.db"))
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 10 ** 6)

    async def main():
        nodes, urls, servers = await _serve_pair(
            tmp_path, ("jax", "port", "jax_mirror", "port_mirror"))
        try:
            for name in ("jax", "port"):
                await nodes[name].build_snapshot()
                await nodes[name].compact_archive()
            fetched = {
                "port_mirror": await nodes["port_mirror"]
                .fetch_archive_from_peer(urls["jax"]),
                "jax_mirror": await nodes["jax_mirror"]
                .fetch_archive_from_peer(urls["port"])}
            again = await nodes["port_mirror"].fetch_archive_from_peer(
                urls["jax"])
            cov = await nodes["port_mirror"].state.archive.coverage()
            block = await nodes["port_mirror"].state.archive.block_by_height(
                3)
        finally:
            await _close_pair(nodes, servers)
        return fetched, again, cov, block

    fetched, again, cov, block = run(main())
    for res in fetched.values():
        assert res == {"ok": True, "segments": 5, "fetched": 5,
                       "reused": 0, "archived_through": 20}, res
    assert again["reused"] == 5 and again["fetched"] == 0
    assert cov == (1, 20) and block[0] == 3

    def files(name):
        return [f for f in _listing(str(tmp_path / f"{name}.archive"))
                if f[0] != "compact-journal.json"]
    assert files("port_mirror") == files("jax") == files("port") \
        == files("jax_mirror")


# ------------------------------------------------- reorg and the index ----

async def _table_rows(state, backend, table) -> list:
    """The table's outpoints straight from SQL (pg's snapshot export
    joins ``transactions`` for amounts, so it leaves out outputs whose
    source tx is archived)."""
    if backend == "pg":
        return [(r["tx_hash"], r["index"]) for r in await state.drv.afetch(
            f'SELECT tx_hash, "index" FROM {table}')]
    return [tuple(r) for r in state.db.execute(
        f"SELECT tx_hash, idx FROM {table}").fetchall()]


async def _index_matches_sql(state, backend, extra=()):
    """Every table's index answers membership as the backend's SQL."""
    index = state.resident_indexes()
    out = []
    for table in ("unspent_outputs",) + tstorage._GOV_TABLES:
        rows = await _table_rows(state, backend, table)
        sample = rows + list(extra) + [("ee" * 32, k) for k in range(4)]
        sql = await _sql_exists(state, backend, table, sample)
        out.append([bool(v) for v in index[table].contains_batch(sample)]
                   == sql and index[table].stats()["entries"] == len(rows))
    return all(out)


@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_reorg_inside_the_safety_window_restores_pruned_outputs(tmp_path,
                                                                 backend):
    """Block 28 spends the coinbases of blocks 1-27; blocks 1-20 are
    pruned into segments; removing block 28 (a reorg inside the safety
    window) restores those outputs from the archive's copy of their
    source txs.  Both packages end on the same UTXO hash as an unpruned
    twin; the port's index, armed on the CPU, equals its SQL."""
    out = {}
    for name in ("jax", "port"):
        a = A[name]

        async def main():
            pruned = await _spent_chain(a.pkg, backend)
            twin = await _spent_chain(a.pkg, backend)
            spent = [(i.tx_hash, i.index) for i in (await pruned.get_block_transactions(
                (await pruned.get_block_by_id(28))["hash"]))[1].inputs]
            if name == "port":
                pruned.device = "cpu"
                pruned.enable_device_index()
            root = tmp_path / name / backend
            arch_dir, snap_dir = str(root / "archive"), str(root / "snap")
            os.makedirs(snap_dir)
            tip = await twin.get_block_by_id(28)
            a.parity.publish_fake_snapshot(snap_dir, 28, tip["hash"])
            cfg = a.ArchiveConfig(dir=arch_dir, segment_blocks=4,
                                  safety_window=4)
            pruned.archive = a.reader.ArchiveReader(arch_dir)
            stats = await a.compactor.compact(pruned, arch_dir, snap_dir,
                                              cfg, reader=pruned.archive)
            before = await _hashes(pruned)
            for st in (pruned, twin):
                await st.remove_blocks(28)
            res = (stats, before, await _hashes(pruned), await _hashes(twin),
                   await pruned.archive_hot_row_counts(),
                   pruned.archive.stats()["fallthrough_reads"] > 0)
            index_ok = None
            if name == "port":
                index_ok = await _index_matches_sql(pruned, backend, spent)
            pruned.close()
            twin.close()
            return res, index_ok
        out[name] = run(main())
    (jres, _), (pres, index_ok) = out["jax"], out["port"]
    assert pres == jres
    stats, before, after, twin_after, hot, reads = pres
    assert stats["ok"] and stats["archived_through"] == 20
    assert stats["pruned_blocks"] == 20 and hot["blocks"] == 7
    assert after == twin_after and after != before and reads
    assert index_ok


@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_compaction_leaves_the_armed_index_alone(tmp_path, backend,
                                                 monkeypatch):
    """A prune deletes block and tx rows only: the armed index keeps its
    objects (nothing rebuilt or re-armed) and still equals SQL."""
    async def main():
        st = await _spent_chain(PORT, backend, tip=28, spend_at=21)
        st.device = "cpu"
        st.enable_device_index()
        index = st.resident_indexes()
        objects = dict(index)
        rebuilds = []
        name = "_build_index" if backend == "sqlite" else "_aindex_fresh"
        real = getattr(st, name)

        def spy(*args, **kw):
            rebuilds.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(st, name, spy)
        arch_dir, snap_dir = str(tmp_path / "archive"), str(tmp_path / "s")
        os.makedirs(snap_dir)
        tip = await st.get_block_by_id(28)
        tparity.publish_fake_snapshot(snap_dir, 28, tip["hash"])
        st.archive = treader.ArchiveReader(arch_dir)
        stats = await tcompactor.compact(
            st, arch_dir, snap_dir,
            tconfig.ArchiveConfig(dir=arch_dir, segment_blocks=4,
                                  safety_window=4), reader=st.archive)
        same = st.resident_indexes() is index and all(
            st.resident_indexes()[t] is objects[t] for t in objects)
        ok = await _index_matches_sql(st, backend)
        st.close()
        return stats, rebuilds, same, ok
    stats, rebuilds, same, ok = run(main())
    assert stats["ok"] and stats["pruned_blocks"] == 20
    assert rebuilds == [] and same and ok


# ------------------------------------------------------------------ CLI ----

def test_cli_legs_print_the_jax_lines_and_leg_3_names_a13f(tmp_path):
    """``python -m upow_tpu_torch.archive --check-determinism --device
    cpu`` exits 0 with the JAX CLI's lines for all three legs (the
    scenario's wall time apart): the differential, the resume, the
    ``archive_prune`` scenario and its determinism.  Without a card and
    without ``--device`` it runs legs 1 and 2, then fails leg 3 naming
    the missing card (it named ROADMAP A13f before the scenario came)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    runs = {
        "jax": ["upow_tpu.archive", "--check-determinism"],
        "port": ["upow_tpu_torch.archive", "--check-determinism",
                 "--device", "cpu"],
        "port_all": ["upow_tpu_torch.archive"],
    }
    procs = {k: subprocess.Popen([sys.executable, "-m", *argv], cwd=tmp_path,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, argv in runs.items()}
    out = {k: p.communicate(timeout=300) + (p.returncode,)
           for k, p in procs.items()}
    assert out["jax"][2] == out["port"][2] == 0, out
    lines = {k: re.sub(r" \d+\.\d\ds fp=", " Xs fp=", out[k][0]).splitlines()
             for k in ("jax", "port")}
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == 5
    assert lines["port"][0].startswith("ok   differential blocks=2400 ")
    assert lines["port"][2].startswith("ok      archive_prune n=3 seed=7 ")
    assert lines["port"][4].startswith("ok   determinism fp1=")
    if not torch.cuda.is_available():
        assert out["port_all"][2] == 1
        assert out["port_all"][0].splitlines() == \
            out["port"][0].splitlines()[:2]
        assert "no CUDA device is available" in out["port_all"][1]


@pytest.mark.parametrize("args, missing", [
    (["--differential-only"], []),
    ([], ["scenario"]),
    (["--differential-only", "--check-determinism"], []),
    (["--check-determinism"], ["scenario", "scenario"]),
])
def test_cli_never_passes_a_scenario_check_it_cannot_run(args, missing,
                                                         monkeypatch,
                                                         capsys):
    """With legs 1 and 2 green, leg 3 runs the scenario (``missing``
    lists the runs each flag set asks for; ``--check-determinism``
    reruns it) and the CLI exits 0 only when every run's core held and
    the two fingerprints agree: a failed core flag or a fingerprint
    that moved makes it exit 1.  ``--differential-only`` runs no
    scenario, ``--check-determinism`` with it included."""
    monkeypatch.setattr(tarchive_main, "_differential", lambda *a: True)

    async def resumed(*a):
        return []
    monkeypatch.setattr(tarchive_main, "_drive_resume", resumed)
    for core, fps, rc in (({"held": True}, ["a", "a"], 0),
                          ({"held": False}, ["a", "a"], 1),
                          ({"held": True}, ["a", "b"], 1)):
        calls = []

        def run(name, seed=7, device=None, _core=core, _fps=fps):
            calls.append((name, seed, device))
            return {"scenario": name, "nodes": 3, "seed": seed,
                    "core": _core, "fingerprint": _fps[len(calls) - 1],
                    "observed": {"elapsed_s": 1.0, "probes": 5}}
        monkeypatch.setattr(tarchive_main, "run_scenario", run)
        got = tarchive_main.main(args + ["--device", "cpu"])
        capsys.readouterr()
        assert calls == [("archive_prune", 7, "cpu")] * len(missing)
        if not missing:
            assert got == 0
        elif len(missing) == 1:
            assert got == (0 if core["held"] else 1)
        else:
            assert got == rc


def test_archive_prune_scenario_green_and_deterministic():
    """JAX ``tests/test_archive.py``'s scenario case, on both packages,
    with equal fingerprints; and the observatory rows it shapes."""
    arts = {}
    for name, mod, kw in (("jax", jscenarios, {}),
                          ("port", tscenarios, {"device": "cpu"})):
        a = mod.run_scenario("archive_prune", seed=7, **kw)
        assert mod.core_ok(a["core"]), {
            k: v for k, v in a["core"].items()
            if isinstance(v, bool) and not v}
        assert a["core"]["hot_blocks_after"] < a["core"]["hot_blocks_before"]
        b = mod.run_scenario("archive_prune", seed=7, **kw)
        assert a["fingerprint"] == b["fingerprint"]
        arts[name] = a
    assert arts["port"]["core"] == arts["jax"]["core"]
    assert arts["port"]["fingerprint"] == arts["jax"]["fingerprint"]
    rows = tparity.archive_rows(arts["port"])
    assert rows["kernels"] == jparity.archive_rows(arts["jax"])["kernels"]
    assert rows["kernels"]["archive_parity_ok"]["value"] == 1.0
    assert set(rows["slo_endpoints"]) == \
        set(jparity.archive_rows(arts["jax"])["slo_endpoints"])
    broken = {**arts["port"], "core": {**arts["port"]["core"],
                                      "parity_after_reorg": False}}
    assert tparity.archive_rows(broken)["kernels"]["archive_parity_ok"][
        "value"] == 0.0
    sec = tparity.observatory_section(seed=7, device="cpu")
    jsec = jparity.observatory_section(seed=7)
    assert sec["section"] == jsec["section"]
    assert sec["kernels"] == jsec["kernels"]
