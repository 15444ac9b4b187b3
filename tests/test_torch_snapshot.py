"""The port's UTXO snapshots (``upow_tpu_torch.snapshot``) against the JAX
package's.

JAX ``tests/test_snapshot.py``'s cases that need no ``swarm/`` run once
on each package, on the same chain built by each package's own code
(same keys, same frozen clock): each case records its outcome (the
client's ``SnapshotError`` reason and detail, the RPCs the fake source
served, the state the joiner is left in, the journal directory's
listing) and the two records must be equal.  Cross-package: the port's
manifest and chunk bytes equal the JAX builder's, on sqlite and on pg
over each package's ``MockPgDriver``; a port node restores from a JAX
node's ``/snapshot/*`` and a JAX node from a port node's, both serving
the same bodies (bad chunk indexes included); after a restore with the
resident index armed on the CPU the index answers as its own backend's
SQL, and an index that cannot be rebuilt rolls the restore back and
raises through the node's bootstrap, never replaying.  The two swarm
cases run on two port nodes on ``chip_smoke.NodeThread``s.  The
``snapshot_churn`` scenario runs on both packages with equal
fingerprints, and ``python -m upow_tpu_torch.snapshot --device cpu``
prints the JAX CLI's lines (the round trip and the scenario).
"""

import asyncio
import os
import re
import shutil
import sqlite3
import subprocess
import sys
from types import SimpleNamespace

import aiohttp
import pytest
import torch
from aiohttp.test_utils import TestServer

import chip_smoke
import upow_tpu.node.app as japp
import upow_tpu.snapshot.builder as jbuilder
import upow_tpu.snapshot.client as jclient
import upow_tpu.snapshot.layout as jlayout
import upow_tpu.swarm.scenarios as jsc
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.snapshot.builder as tbuilder
import upow_tpu_torch.snapshot.client as tclient
import upow_tpu_torch.snapshot.layout as tlayout
import upow_tpu_torch.state.device_index as tdi
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.pgdriver as tdrv
import upow_tpu_torch.state.storage as tstorage
import upow_tpu_torch.swarm.scenarios as tsc
from test_torch_block import JAX, PORT, T0
from test_torch_gossip import _jcfg, _tcfg
from test_torch_wallet import Run, easy_chain  # noqa: F401  (fixture)
from test_wallet import make_actors

S = {"jax": SimpleNamespace(builder=jbuilder, client=jclient, layout=jlayout),
     "port": SimpleNamespace(builder=tbuilder, client=tclient,
                             layout=tlayout)}
GENESIS = make_actors()["genesis"]


def run(coro):
    return asyncio.run(coro)


async def _populated(pkg, blocks=6, backend="sqlite", governance=False):
    """A chain of ``blocks`` coinbase blocks to the genesis actor, built
    by the package's own code; with ``governance`` a send, two stakes, a
    validator registration and a vote too (every UTXO-class table
    populated, witness txs older than the tail)."""
    r = Run(pkg, backend)
    d_g, a_g = GENESIS
    for _ in range(blocks):
        await r.mine(a_g)
    if governance:
        a = make_actors()
        (d_v, a_v), (d_d, a_d) = a["validator"], a["delegate"]
        await r.push(r.builder.create_transaction_to_send_multiple_wallet(
            d_g, [a_v, a_d], ["111", "21"]))
        await r.mine(a_g, include_pending=True)
        for d in (d_v, d_d):
            await r.push(r.builder.create_stake_transaction(d, "10"))
        await r.mine(a_g, include_pending=True)
        await r.push(r.builder.create_validator_registration_transaction(d_v))
        await r.mine(a_g, include_pending=True)
        await r.push(r.builder.create_voting_transaction(d_d, 10, a_v))
        await r.mine(a_g, include_pending=True)
        await r.push(r.builder.create_transaction(d_g, a_d, "3"))
    return r.state


async def _hashes(state) -> tuple:
    return (await state.get_unspent_outputs_hash(),
            await state.get_full_state_hash())


class DiskSource:
    """A fake peer serving the published generation from disk, counting
    every RPC; ``fail_after`` severs the link after that many chunks."""

    def __init__(self, layout, root, fail_after=None):
        self.base_url = "http://disk.local"
        self.layout = layout
        self.gen = layout.current_gen_dir(root)
        self.manifest = layout.read_manifest(
            os.path.join(self.gen, layout.MANIFEST_NAME))
        self.fail_after = fail_after
        self.chunk_rpcs = 0

    async def snapshot_manifest(self):
        return self.manifest

    async def close(self):
        pass

    async def snapshot_chunk(self, i):
        if self.fail_after is not None and self.chunk_rpcs >= self.fail_after:
            raise ConnectionError("link severed")
        self.chunk_rpcs += 1
        with open(os.path.join(self.gen, self.layout.chunk_name(i)),
                  "rb") as fh:
            return fh.read()


class RawSource:
    """A fake peer serving crafted payload bytes under a manifest whose
    hashes are consistent; only the rows are hostile."""

    def __init__(self, layout, payload):
        self.base_url = "http://raw.local"
        self._chunks = [payload[i:i + 512]
                        for i in range(0, len(payload), 512)] or [b""]
        self.manifest = {
            "version": layout.MANIFEST_VERSION, "anchor_height": 1,
            "anchor_hash": "b" * 64, "utxo_fingerprint": "c" * 64,
            "full_state_fingerprint": "d" * 64, "chunk_bytes": 512,
            "payload_bytes": len(payload),
            "payload_sha256": layout.sha256_hex(payload),
            "chunks": [{"i": i, "sha256": layout.sha256_hex(c),
                        "size": len(c)} for i, c in enumerate(self._chunks)],
            "counts": {}}

    async def snapshot_manifest(self):
        return self.manifest

    async def snapshot_chunk(self, i):
        return self._chunks[i]


async def _attempt(s, joiner, sources, jroot):
    """("ok", result) or ("error", reason, detail) of one bootstrap."""
    try:
        res = await s.client.bootstrap_from_snapshot(joiner, sources, jroot)
    except s.client.SnapshotError as e:
        return ("error", e.reason, e.detail)
    return ("ok", res)


def _listing(jroot) -> list:
    restore = os.path.join(jroot, "restore")
    if not os.path.isdir(restore):
        return []
    return sorted((d, sorted(os.listdir(os.path.join(restore, d))))
                  for d in os.listdir(restore))


def _both(tmp_path, case):
    """Run ``case(pkg, s, tmp)`` for each package in a directory of its
    own; the two records must be equal."""
    out = {}
    for pkg in (JAX, PORT):
        tmp = tmp_path / pkg.name
        tmp.mkdir()
        out[pkg.name] = run(case(pkg, S[pkg.name], str(tmp)))
        pkg.clear()
    assert out["port"] == out["jax"]
    return out["port"]


# -------------------------------------------------------------- builder ----

def test_builder_manifest_is_deterministic(tmp_path):
    async def case(pkg, s, tmp):
        state = await _populated(pkg)
        a = await s.builder.build_snapshot(state, tmp + "/a", chunk_bytes=512)
        b = await s.builder.build_snapshot(state, tmp + "/b", chunk_bytes=512)
        assert s.layout.canonical_json(a) == s.layout.canonical_json(b)
        assert len(a["chunks"]) >= 4
        assert a["payload_bytes"] == sum(c["size"] for c in a["chunks"])
        state.close()
        return a
    _both(tmp_path, case)


def test_builder_empty_chain_yields_no_generation(tmp_path):
    async def case(pkg, s, tmp):
        state = pkg.ChainState()
        out = (await s.builder.build_snapshot(state, tmp),
               s.layout.current_manifest(tmp))
        state.close()
        return out
    assert _both(tmp_path, case) == (None, None)


@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_manifest_and_chunks_equal_the_jax_builders(tmp_path, backend):
    """The same chain (every UTXO-class table populated, a pending tx in
    the journal) built by each package: the same manifest, byte for byte,
    and the same chunk files; the blocks tail is cut short of the chain
    so witness txs from older blocks are carried."""
    async def case(pkg, s, tmp):
        state = await _populated(pkg, blocks=40, backend=backend,
                                 governance=True)
        m = await s.builder.build_snapshot(state, tmp, chunk_bytes=700,
                                           blocks_tail=8)
        gen = s.layout.current_gen_dir(tmp)
        chunks = [open(os.path.join(gen, s.layout.chunk_name(i)), "rb").read()
                  for i in range(len(m["chunks"]))]
        payload, counts = await s.builder.serialize_payload(state, 8)
        state.close()
        return (s.layout.canonical_json(m), chunks, os.path.basename(gen),
                payload, counts)
    manifest, chunks, gen, payload, counts = _both(tmp_path, case)
    assert b"".join(chunks) == payload and len(chunks) > 5
    assert all(counts[t] for t in ("unspent_outputs", "tx", "block",
                                   "validators_ballot",
                                   "validator_registration_output"))


def test_generation_rotation_keeps_newest_two(tmp_path):
    async def case(pkg, s, root):
        def fake_gen(height):
            name = s.layout.gen_name(height, f"{height:064x}")
            os.makedirs(os.path.join(root, name))
            s.layout.write_manifest(os.path.join(
                root, name, s.layout.MANIFEST_NAME), {"anchor_height": height})
            s.layout.publish_current(root, name)
            return name

        names = [fake_gen(h) for h in (10, 20, 30)]
        os.makedirs(os.path.join(root, ".staging-leak"))
        out = [s.layout.prune_generations(root, keep=2),
               s.layout.list_generations(root),
               os.path.exists(os.path.join(root, ".staging-leak"))]
        s.layout.publish_current(root, names[1])
        out += [s.layout.prune_generations(root, keep=1),
                s.layout.list_generations(root),
                s.layout.prune_generations(root + "/nope")]
        return out
    out = _both(tmp_path, case)
    assert out[0] == 2 and len(out[1]) == 2 and out[2] is False
    assert out[5] == 0


def test_current_pointer_rejects_traversal(tmp_path):
    async def case(pkg, s, root):
        os.makedirs(os.path.join(root, "gen-000000001-aa"))
        got = []
        for evil in ("../escape", ".hidden", "", "gen-000000001-aa"):
            with open(os.path.join(root, s.layout.CURRENT_NAME), "w") as fh:
                fh.write(evil + "\n")
            gen = s.layout.current_gen_dir(root)
            got.append(gen and os.path.basename(gen))
        return got
    assert _both(tmp_path, case) == [None, None, None, "gen-000000001-aa"]


# ------------------------------------------------------- crash + resume ----

@pytest.mark.parametrize("plant", ["none", "torn_part", "tampered"])
def test_resume_reuses_verified_chunks(tmp_path, plant):
    """The link dies after 3 committed chunks (kill -9 between chunks);
    then, as planted: nothing, a torn ``.part`` of the next chunk (kill
    -9 mid-write), or chunk 1 overwritten (a tampered journal).  The
    resumed restore re-downloads only what is missing or fails
    re-verification, and lands on the source's fingerprints."""
    async def case(pkg, s, tmp):
        state = await _populated(pkg)
        root = tmp + "/server"
        await s.builder.build_snapshot(state, root, chunk_bytes=512)
        manifest = s.layout.current_manifest(root)
        joiner = pkg.ChainState()
        jroot = tmp + "/joiner"
        first = await _attempt(s, joiner, [DiskSource(s.layout, root, 3)],
                               jroot)
        jdir = os.path.join(jroot, "restore",
                            manifest["payload_sha256"][:16])
        if plant == "torn_part":
            with open(os.path.join(jdir, s.layout.chunk_name(3) + ".part"),
                      "wb") as fh:
                fh.write(b"torn")
        elif plant == "tampered":
            with open(os.path.join(jdir, s.layout.chunk_name(1)), "wb") as fh:
                fh.write(b"\x00" * 64)
        listing = _listing(jroot)
        src = DiskSource(s.layout, root)
        second = await _attempt(s, joiner, [src], jroot)
        out = (first[:2], listing, second, src.chunk_rpcs,
               len(manifest["chunks"]), await _hashes(joiner),
               await _hashes(state), _listing(jroot))
        state.close()
        joiner.close()
        return out
    first, _listing_, second, rpcs, total, got, want, after = \
        _both(tmp_path, case)
    assert first == ("error", "sources_exhausted")
    reused = 2 if plant == "tampered" else 3
    assert second[0] == "ok" and second[1]["chunks_reused"] == reused
    assert rpcs == total - reused and got == want
    assert after == []


# ------------------------------------------------------------- integrity ----

def _integrity_case(mutate, sources=None, blocks=6):
    """A case: build, let ``mutate(good DiskSource)`` return the list of
    sources to try, restore into a blank joiner; record the outcome,
    the joiner's tip and fingerprints and the journal listing."""
    async def case(pkg, s, tmp):
        state = await _populated(pkg, blocks=blocks)
        root = tmp + "/server"
        await s.builder.build_snapshot(state, root, chunk_bytes=512)
        joiner = pkg.ChainState()
        jroot = tmp + "/joiner"
        srcs = mutate(s, DiskSource(s.layout, root))
        res = await _attempt(s, joiner, srcs, jroot)
        out = (res, await joiner.get_last_block(), await _hashes(joiner),
               await _hashes(state), _listing(jroot))
        state.close()
        joiner.close()
        return out
    return case


def test_poisoned_fingerprint_never_reaches_the_database(tmp_path):
    def mutate(s, good):
        good.manifest = dict(good.manifest, utxo_fingerprint="f" * 64)
        return [good]
    res, tip, _got, _want, listing = _both(tmp_path, _integrity_case(mutate))
    assert res[:2] == ("error", "fingerprint_mismatch")
    assert tip is None and listing == []


def test_malformed_manifest_skips_to_next_source(tmp_path):
    def mutate(s, good):
        bad = DiskSource(s.layout, os.path.dirname(good.gen))
        bad.manifest = {"version": 99}
        return [bad, good]
    res, tip, got, want, _ = _both(tmp_path, _integrity_case(mutate, blocks=3))
    assert res[0] == "ok" and got == want and tip["id"] == 3


def test_hostile_manifests_fail_over_without_touching_disk(tmp_path):
    def mutate(s, good):
        root = os.path.dirname(good.gen)
        evil, huge, nokey = (DiskSource(s.layout, root) for _ in range(3))
        evil.manifest = dict(good.manifest,
                             payload_sha256="../../../../etc/x")
        huge.manifest = dict(
            good.manifest, chunks=[{"i": i, "sha256": "a" * 64, "size": 1024}
                                   for i in range(100_000)],
            payload_bytes=1024 * 100_000)
        nokey.manifest = {k: v for k, v in good.manifest.items()
                          if k != "payload_sha256"}
        return [evil, huge, nokey, good]
    res, _tip, got, want, listing = _both(
        tmp_path, _integrity_case(mutate, blocks=3))
    assert res[0] == "ok" and got == want and listing == []


def test_chunk_size_lie_is_an_integrity_failure(tmp_path):
    def mutate(s, liar):
        chunks = [dict(c) for c in liar.manifest["chunks"]]
        delta = chunks[0]["size"] - 1
        chunks[0]["size"] = 1
        liar.manifest = dict(liar.manifest, chunks=chunks,
                             payload_bytes=liar.manifest["payload_bytes"]
                             - delta)
        return [liar]
    res, tip, _got, _want, _ = _both(tmp_path, _integrity_case(mutate,
                                                               blocks=3))
    assert res[:2] == ("error", "sources_exhausted")
    assert "chunk 0" in res[2] and tip is None


@pytest.mark.parametrize("line", [
    b'{"t":"unspent_outputs","r":5}\n', b'{"t":"block","r":[1,"x"]}\n',
    b'{"t":"tx","r":{"a":1}}\n', b'not json\n', b'{"t":"nope","r":[]}\n'])
def test_malformed_payload_rows_stay_inside_the_error_ladder(tmp_path, line):
    async def case(pkg, s, tmp):
        joiner = pkg.ChainState()
        res = await _attempt(s, joiner, [RawSource(s.layout, line)], tmp)
        out = (res, await joiner.get_last_block(), _listing(tmp))
        joiner.close()
        return out
    res, tip, listing = _both(tmp_path, case)
    assert res[:2] == ("error", "payload_malformed")
    assert tip is None and listing == []


def test_superseded_journal_dirs_are_pruned(tmp_path):
    async def case(pkg, s, tmp):
        r = Run(pkg)
        for _ in range(6):
            await r.mine(GENESIS[1])
        root = tmp + "/server"
        await s.builder.build_snapshot(r.state, root, chunk_bytes=512)
        joiner = pkg.ChainState()
        jroot = tmp + "/joiner"
        first = await _attempt(s, joiner, [DiskSource(s.layout, root, 1)],
                               jroot)
        before = _listing(jroot)
        await r.mine(GENESIS[1])
        await s.builder.build_snapshot(r.state, root, chunk_bytes=512)
        second = await _attempt(s, joiner, [DiskSource(s.layout, root)],
                                jroot)
        out = (first[:2], before, second, _listing(jroot),
               await _hashes(joiner), await _hashes(r.state))
        r.state.close()
        joiner.close()
        return out
    first, before, second, after, got, want = _both(tmp_path, case)
    assert len(before) == 1 and second[0] == "ok" and after == []
    assert got == want


def test_restored_state_mismatch_resets_to_blank_state(tmp_path):
    async def case(pkg, s, tmp):
        state = await _populated(pkg)
        root = tmp + "/server"
        await s.builder.build_snapshot(state, root, chunk_bytes=512)
        joiner = pkg.ChainState()

        async def lying_hash():
            return "0" * 64
        joiner.get_unspent_outputs_hash = lying_hash
        res = await _attempt(s, joiner, [DiskSource(s.layout, root)],
                             tmp + "/joiner")
        out = (res, await joiner.get_last_block(),
               await joiner.get_full_state_hash(), _listing(tmp + "/joiner"))
        state.close()
        joiner.close()
        return out
    res, tip, _full, listing = _both(tmp_path, case)
    assert res[:2] == ("error", "restored_state_mismatch")
    assert tip is None and listing == []


def test_pg_backend_payload_parity(tmp_path):
    """A payload exported from the port's sqlite state, restored into
    the port's pg backend, re-exports byte for byte, with the same
    fingerprints; and the JAX pg backend, fed the same payload, agrees."""
    import upow_tpu.state.pg as jpg
    import upow_tpu.state.pgdriver as jdrv

    async def main():
        state = await _populated(PORT, blocks=30, governance=True)
        payload, _ = await tbuilder.serialize_payload(state, blocks_tail=8)
        tables, txs, blocks = tclient.parse_payload(payload)
        out = {}
        for name, pg in (("port", tpg.PgChainState(driver=tdrv.MockPgDriver())),
                         ("jax", jpg.PgChainState(driver=jdrv.MockPgDriver()))):
            await pg.restore_snapshot(tables, txs, blocks)
            builder = tbuilder if name == "port" else jbuilder
            out[name] = (await _hashes(pg),
                         (await builder.serialize_payload(pg, 8))[0])
            pg.close()
        want = await _hashes(state)
        state.close()
        return payload, want, out
    payload, want, out = run(main())
    assert out["port"] == out["jax"] == (want, payload)


# ---------------------------------------------------------- the index ----

@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_restore_rearms_the_index_to_match_sql(tmp_path, backend):
    """A joiner with its resident index armed on the CPU (a few rows of
    its own first, which the restore replaces): after the restore every
    table's index answers membership as the backend's own SQL does, on
    the restored outpoints, the replaced ones and absent ones."""
    async def main():
        src = await _populated(PORT, blocks=30, governance=True)
        root = str(tmp_path / "server")
        await tbuilder.build_snapshot(src, root, chunk_bytes=2048,
                                      blocks_tail=4)
        PORT.clock.freeze(T0 + 10 ** 6)
        if backend == "sqlite":
            joiner = PORT.ChainState(device_index=True, device="cpu")
        else:
            joiner = tpg.PgChainState(driver=tdrv.MockPgDriver(),
                                      device="cpu")
            joiner.enable_device_index()
        await Run(PORT, state=joiner).mine(make_actors()["outsider"][1])
        replaced = [(r[0], r[1]) for r in
                    await joiner.export_snapshot_rows("unspent_outputs")]
        res = await tclient.bootstrap_from_snapshot(
            joiner, [DiskSource(tlayout, root)], str(tmp_path / "joiner"))
        assert res["method"] == "snapshot"
        assert await _hashes(joiner) == await _hashes(src)
        index = joiner.resident_indexes()
        for table in ("unspent_outputs",) + tstorage._GOV_TABLES:
            rows = [(r[0], r[1]) for r in
                    await joiner.export_snapshot_rows(table)]
            sample = rows + replaced + [("ee" * 32, k) for k in range(4)]
            sql = await _sql_exists(joiner, backend, table, sample)
            assert [bool(v) for v in index[table].contains_batch(sample)] \
                == sql, table
            assert index[table].stats()["entries"] == len(rows), table
        src.close()
        joiner.close()
    run(main())


async def _sql_exists(state, backend, table, sample) -> list:
    if backend == "pg":
        return [bool(v) for v in await state._outpoints_exist_sql(
            sample, table)]
    have = {tuple(r) for r in state.db.execute(
        f"SELECT tx_hash, idx FROM {table}").fetchall()}
    return [tuple(o) in have for o in sample]


@pytest.mark.parametrize("backend", ["sqlite", "pg"])
def test_index_that_cannot_rearm_rolls_back_and_raises(tmp_path, backend,
                                                       monkeypatch):
    """The index cannot be rebuilt (the device refuses, as a card that
    cannot arm would): the restore raises ``IndexRearmError``, the
    tables and the index are the pre-restore pair, the verified journal
    stays, and the node's bootstrap raises it too: no replay, no SQL."""
    async def main():
        src = await _populated(PORT, blocks=8)
        root = str(tmp_path / "server")
        await tbuilder.build_snapshot(src, root, chunk_bytes=512)
        if backend == "sqlite":
            joiner = PORT.ChainState(device_index=True, device="cpu")
        else:
            joiner = tpg.PgChainState(driver=tdrv.MockPgDriver(),
                                      device="cpu")
            joiner.enable_device_index()
        before_index = joiner.resident_indexes()
        before = await _hashes(joiner)
        module = tstorage if backend == "sqlite" else tpg

        def refuse(*a, **k):
            raise RuntimeError("the card cannot arm")
        monkeypatch.setattr(module, "DeviceUtxoIndex", refuse)
        with pytest.raises(tdi.IndexRearmError, match="cannot arm"):
            await tclient.bootstrap_from_snapshot(
                joiner, [DiskSource(tlayout, root)], str(tmp_path / "j"))
        assert joiner.resident_indexes() is before_index
        assert await _hashes(joiner) == before
        assert await joiner.get_last_block() is None
        assert len(_listing(str(tmp_path / "j"))) == 1
        src.close()
        joiner.close()
    run(main())


def test_node_bootstrap_raises_when_the_index_cannot_rearm(tmp_path,
                                                          monkeypatch):
    cfg = _tcfg(tmp_path, "joiner")
    cfg.snapshot.dir = str(tmp_path / "snap")
    cfg.device.utxo_index = True

    async def main():
        src = await _populated(PORT, blocks=8)
        root = str(tmp_path / "server")
        await tbuilder.build_snapshot(src, root, chunk_bytes=512)
        node = tapp.Node(cfg, device="cpu")
        node.iface_factory = lambda url, *a, **k: DiskSource(tlayout, root)
        synced = []

        async def no_replay():
            synced.append(1)
            return {"ok": True}
        node.sync_blockchain = no_replay
        monkeypatch.setattr(tstorage, "DeviceUtxoIndex",
                            lambda *a, **k: 1 / 0)
        try:
            with pytest.raises(tdi.IndexRearmError):
                await node.bootstrap_from_snapshot(sources=["http://x"])
            assert synced == []
            assert await node.state.get_last_block() is None
        finally:
            await node.close()
            src.close()
    run(main())


# ------------------------------------------------- across the packages ----

def test_nodes_restore_from_each_other(tmp_path):
    """A JAX node and a port node serve copies of one chain, each having
    built its generation (the same manifest); a blank port node restores
    from the JAX node over HTTP and a blank JAX node from the port node,
    each ending on the source's fingerprints.  ``/snapshot/*`` answers
    alike on both, bad chunk indexes and methods included."""
    PORT.clock.freeze(T0)
    src = run(_populated(JAX, blocks=30, governance=True))
    path = str(tmp_path / "chain.db")
    _copy_state(src, path)
    src.close()
    for name in ("jax", "port", "jax_joiner", "port_joiner"):
        if not name.endswith("joiner"):
            shutil.copyfile(path, tmp_path / f"{name}.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 10 ** 6)
    cfgs = {}
    for name in ("jax", "port", "jax_joiner", "port_joiner"):
        cfg = (_jcfg if name.startswith("jax") else _tcfg)(tmp_path, name)
        cfg.snapshot.dir = str(tmp_path / f"{name}.snap")
        cfg.snapshot.chunk_bytes = 1500
        cfg.snapshot.blocks_tail = 6
        cfgs[name] = cfg

    async def main():
        nodes = {"jax": japp.Node(cfgs["jax"]),
                 "jax_joiner": japp.Node(cfgs["jax_joiner"]),
                 "port": tapp.Node(cfgs["port"], device="cpu"),
                 "port_joiner": tapp.Node(cfgs["port_joiner"], device="cpu")}
        servers, urls = [], {}
        for name, node in nodes.items():
            if name.startswith("jax"):
                node.started = True
                server = TestServer(node.app, host="127.0.0.1")
                await server.start_server()
                servers.append(server)
                urls[name] = f"http://127.0.0.1:{server.port}"
            else:
                node.started = True
                server = await node.serve("127.0.0.1", 0)
                urls[name] = f"http://127.0.0.1:{server.port}"
        try:
            async with aiohttp.ClientSession() as s:
                bodies = []
                for path in ("snapshot/manifest", "snapshot/chunk/0"):
                    bodies.append(await _get_both(s, urls, path))
                m = {n: await nodes[n].build_snapshot()
                     for n in ("jax", "port")}
                assert m["jax"] == m["port"]
                n_chunks = len(m["port"]["chunks"])
                for path in ("snapshot/manifest", "snapshot/chunk/0",
                             f"snapshot/chunk/{n_chunks - 1}",
                             f"snapshot/chunk/{n_chunks}",
                             "snapshot/chunk/-1", "snapshot/chunk/zzz",
                             "snapshot/chunk/%7Bi%7D", "snapshot/chunk/",
                             "snapshot/chunk/1/2", "snapshot/chunk/+1",
                             "snapshot/chunk/%201"):
                    bodies.append(await _get_both(s, urls, path))
                bodies.append(await _get_both(s, urls, "snapshot/chunk/0",
                                              method="POST"))
            restored = {
                "port_joiner": await nodes["port_joiner"]
                .bootstrap_from_snapshot(sources=[urls["jax"]]),
                "jax_joiner": await nodes["jax_joiner"]
                .bootstrap_from_snapshot(sources=[urls["port"]])}
            hashes = {n: await _hashes(node.state)
                      for n, node in nodes.items()}
            metrics = {}
            async with aiohttp.ClientSession() as s:
                for name in ("jax", "port", "jax_joiner", "port_joiner"):
                    async with s.get(urls[name] + "/metrics") as resp:
                        metrics[name] = await resp.text()
        finally:
            for name, node in nodes.items():
                if name.startswith("port"):
                    await node.close()
            for server in servers:
                await server.close()
            for name, node in nodes.items():
                if name.startswith("jax"):
                    await node.close()
        return bodies, restored, hashes, metrics

    bodies, restored, hashes, metrics = run(main())
    assert [b[0] for b in bodies] == [404, 404, 200, 200, 200, 404, 404,
                                      422, 404, 404, 404, 200, 200, 405]
    for name, res in restored.items():
        assert res["ok"] and res["method"] == "snapshot", res
    assert hashes["port_joiner"] == hashes["jax_joiner"] == hashes["jax"] \
        == hashes["port"]
    for name in ("jax", "port"):
        assert "upow_snapshot_published_chunks" in metrics[name]
        assert "upow_snapshot_restore_chunks_verified" in \
            metrics[name + "_joiner"]


def _copy_state(state, path):
    """The JAX chain's rows into a sqlite file (the JAX ChainState on an
    in-memory database, backed up)."""
    dst = sqlite3.connect(path)
    state.db.backup(dst)
    dst.close()


async def _get_both(session, urls, path, method="GET"):
    """(status, body, Allow) from the JAX and the port source, equal."""
    out = []
    for name in ("jax", "port"):
        async with session.request(method, f"{urls[name]}/{path}",
                                   allow_redirects=False) as resp:
            out.append((resp.status, await resp.read(),
                        resp.headers.get("Allow")))
    assert out[1] == out[0], (path, out)
    return out[1]


# ------------------------------------------------- on NodeThreads ----

def _mine_on(thread, address):
    async def mine():
        PORT.clock.advance(60)
        manager = thread.node.manager
        diff, last = await manager.calculate_difficulty()
        prev = last["hash"] if last else chip_smoke.GENESIS_PREV
        h = PORT.header.BlockHeader(
            previous_hash=prev, address=address,
            merkle_root=PORT.merkle.merkle_root([]),
            timestamp=PORT.clock.timestamp(),
            difficulty_x10=int(diff * 10), nonce=0)
        while last and not PORT.difficulty.check_pow(h.hex(), prev, diff):
            h.nonce += 1
        assert await manager.create_block(h.hex(), [])
    thread.call(mine())


def test_snapshot_endpoints_serve_fresh_without_cache_bypass(tmp_path):
    """JAX's swarm case on a port node on a NodeThread: no generation ->
    404; a build is served on the next request with no bypass header,
    and a rebuild at a later height is visible at once."""
    PORT.clock.freeze(T0)
    node = chip_smoke.NodeThread(
        torch.device("cpu"), str(tmp_path / "n0.db"), "jac",
        snapshot__dir=str(tmp_path / "n0"), snapshot__chunk_bytes=1024,
        snapshot__blocks_tail=4)
    try:
        assert node.request("snapshot/manifest") == {
            "ok": False, "error": "no snapshot available"}
        for _ in range(4):
            _mine_on(node, GENESIS[1])
        m1 = node.call(node.node.build_snapshot())
        assert node.request("snapshot/manifest") == {"ok": True, "result": m1}
        chunk = node.request("snapshot/chunk/0")
        data = bytes.fromhex(chunk["result"]["data"])
        assert tlayout.sha256_hex(data) == m1["chunks"][0]["sha256"]
        assert not node.request("snapshot/chunk/zzz")["ok"]
        assert node.request(f"snapshot/chunk/{len(m1['chunks'])}") == {
            "ok": False, "error": "no such chunk"}
        _mine_on(node, GENESIS[1])
        m2 = node.call(node.node.build_snapshot())
        assert m2["anchor_height"] == m1["anchor_height"] + 1
        assert node.request("snapshot/manifest")["result"][
            "anchor_height"] == m2["anchor_height"]
    finally:
        node.close()


def test_sync_far_behind_emits_snapshot_recommended(tmp_path):
    """JAX's swarm case on two port nodes on NodeThreads: node 1, with a
    reorg window of 4, syncs 8 blocks from node 0 and records a
    ``snapshot_recommended`` event with the lag and the remote height."""
    PORT.clock.freeze(T0)
    kw = {"node__sync_fetch_interval": 0, "node__sync_reorg_window": 4,
          "node__rate_limits_enabled": False}
    nodes = [chip_smoke.NodeThread(torch.device("cpu"),
                                   str(tmp_path / f"n{i}.db"), "jac", **kw)
             for i in range(2)]
    try:
        for _ in range(8):
            _mine_on(nodes[0], GENESIS[1])
        res = nodes[1].request("sync_blockchain?node_url="
                               + nodes[0].url.rstrip("/"))
        assert res["ok"], res
        events = nodes[1].request(
            "debug/events?kind=snapshot_recommended")["result"]
        assert events, "no snapshot_recommended event on /debug/events"
        ev = events[-1]
        assert ev["lag"] > 4 and ev["remote_height"] == 8
        assert ev["local_height"] == 0
    finally:
        for node in nodes:
            node.close()


def test_rebuild_cadence_and_startup_prune_match_jax(tmp_path):
    """Both nodes pick the same rebuild target from the same identity and
    jitter, and prune a crashed build's staging dir at start; the port's
    node then publishes a generation on its own after that many accepted
    blocks, anchored at the block that armed it."""
    cfgs = {}
    for name, make in (("jax", _jcfg), ("port", _tcfg)):
        cfg = make(tmp_path, name)
        cfg.node.self_url = "http://10.0.0.7:3006"
        cfg.snapshot.dir = str(tmp_path / f"{name}.snap")
        cfg.snapshot.rebuild_interval_blocks = 3
        cfg.snapshot.rebuild_jitter_blocks = 5
        cfg.snapshot.chunk_bytes = 4096
        os.makedirs(os.path.join(cfg.snapshot.dir, ".staging-crashed"))
        cfgs[name] = cfg

    async def main():
        jnode = japp.Node(cfgs["jax"])
        tnode = tapp.Node(cfgs["port"], device="cpu")
        try:
            targets = (jnode._rebuild_target, tnode._rebuild_target)
            staging = [os.listdir(c.snapshot.dir) for c in cfgs.values()]
            r = Run(PORT, state=tnode.state)
            r.manager = tnode.manager
            PORT.clock.freeze(T0)
            for _ in range(targets[1]):
                await r.mine(GENESIS[1])
            await asyncio.gather(*list(tnode._background))
            published = tlayout.current_manifest(cfgs["port"].snapshot.dir)
        finally:
            await tnode.close()
            await jnode.close()
        return targets, staging, published

    targets, staging, published = run(main())
    assert targets[0] == targets[1] and 3 <= targets[1] <= 8
    assert staging == [[], []]
    assert published["anchor_height"] == targets[1]


def test_fire_mutate_matches_jax():
    """The ``corrupt`` kind flips the same byte under the same seed, only
    at ``fire_mutate``, and counts as the JAX injector does."""
    import upow_tpu.resilience.faultinject as jfi
    import upow_tpu_torch.resilience.faultinject as tfi

    spec = "snapshot.serve:corrupt:key=chunk/1,times=2;rpc:corrupt"
    data = bytes(range(256)) * 3
    got = []
    for fi in (jfi, tfi):
        inj = fi.FaultInjector(spec, seed=42)
        out = [inj.fire_mutate("snapshot.serve", f"chunk/{i}", data)
               for i in (0, 1, 1, 1)]
        out.append(inj.fire_mutate("snapshot.serve", "chunk/1", b""))
        out.append(inj.fire_mutate("rpc.get_blocks", "http://x", b"ab"))
        run(inj.fire("snapshot.serve", "chunk/1"))  # corrupt never raises
        got.append((out, inj.snapshot()))
    assert got[0] == got[1]
    assert got[1][0][1] != data and got[1][0][3] == data


def test_corrupt_served_chunk_is_refetched(tmp_path):
    """A port node serving under ``snapshot.serve:corrupt`` on one chunk:
    the restoring client sees the hash mismatch, fetches the chunk again
    and restores; the integrity failure is counted."""
    from upow_tpu_torch import trace
    from upow_tpu_torch.resilience import faultinject

    cfgs = {}
    for name in ("server", "joiner"):
        cfg = _tcfg(tmp_path, name)
        cfg.snapshot.dir = str(tmp_path / f"{name}.snap")
        cfg.snapshot.chunk_bytes = 512
        cfgs[name] = cfg
    cfgs["server"].resilience.faults = \
        "snapshot.serve:corrupt:key=chunk/2,times=1"

    async def main():
        src = await _populated(PORT, blocks=6)
        _copy_state(src, cfgs["server"].node.db_path)
        src.close()
        server = tapp.Node(cfgs["server"], device="cpu")
        joiner = tapp.Node(cfgs["joiner"], device="cpu")
        try:
            base = await server.serve("127.0.0.1", 0)
            manifest = await server.build_snapshot()
            before = trace.counters().get("snapshot.chunk_integrity_failures",
                                          0)
            res = await joiner.bootstrap_from_snapshot(
                sources=[f"http://127.0.0.1:{base.port}"])
            failures = trace.counters().get(
                "snapshot.chunk_integrity_failures", 0) - before
            same = await _hashes(joiner.state) == await _hashes(server.state)
        finally:
            faultinject.uninstall()
            await joiner.close()
            await server.close()
        return manifest, res, failures, same

    manifest, res, failures, same = run(main())
    assert res["ok"] and res["method"] == "snapshot" and same
    assert res["rpcs"] == len(manifest["chunks"]) + 2 and failures == 1


def test_snapshot_fetch_faults_restore_traffic_alone(tmp_path):
    """``snapshot.fetch`` is the bootstrap's own fault site, keyed by
    source and document: with every ``rpc.*`` call faulted and one chunk
    fetch failing once, a JAX and a port joiner both restore from a port
    server (the retry policy absorbs the one failure) and their
    injectors record the same firings."""
    import upow_tpu.resilience.faultinject as jfi
    from upow_tpu_torch.resilience import faultinject as tfi

    spec = "rpc:error;snapshot.fetch:error:key=#chunk/1,times=1"
    cfgs = {"server": _tcfg(tmp_path, "server")}
    for name, make in (("jax", _jcfg), ("port", _tcfg)):
        cfg = make(tmp_path, name)
        cfg.resilience.faults = spec
        cfgs[name] = cfg
    for name, cfg in cfgs.items():
        cfg.snapshot.dir = str(tmp_path / f"{name}.snap")
        cfg.snapshot.chunk_bytes = 1024
    cfgs["server"].resilience.faults = ""

    async def main():
        src = await _populated(PORT, blocks=6)
        _copy_state(src, cfgs["server"].node.db_path)
        src.close()
        server = tapp.Node(cfgs["server"], device="cpu")
        base = await server.serve("127.0.0.1", 0)
        url = f"http://127.0.0.1:{base.port}"
        await server.build_snapshot()
        out = {}
        try:
            for name, node_cls, fi in (("jax", japp.Node, jfi),
                                       ("port", tapp.Node, tfi)):
                kw = {} if name == "jax" else {"device": "cpu"}
                node = node_cls(cfgs[name], **kw)
                try:
                    res = await node.bootstrap_from_snapshot(sources=[url])
                    out[name] = (res["method"], res["chunks"],
                                 fi.get_injector().snapshot(),
                                 await _hashes(node.state))
                finally:
                    fi.uninstall()
                    await node.close()
            out["server"] = await _hashes(server.state)
        finally:
            await server.close()
        return out

    out = run(main())
    assert out["jax"] == out["port"]
    method, _chunks, fired, hashes = out["port"]
    assert method == "snapshot" and hashes == out["server"]
    assert [f["fired"] for f in fired] == [0, 1]


# -------------------------------------------------------------- scenario ----

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_snapshot_churn_scenario_green_and_deterministic(pkg):
    """JAX ``tests/test_snapshot.py``'s scenario case, on each package;
    the port's fingerprint equals the JAX one."""
    mod, kw = (jsc, {}) if pkg == "jax" else (tsc, {"device": "cpu"})
    a = mod.run_scenario("snapshot_churn", seed=7, **kw)
    assert mod.core_ok(a["core"]), {
        k: v for k, v in a["core"].items()
        if isinstance(v, bool) and not v}
    assert a["observed"]["snapshot_rpcs"] < a["observed"]["replay_rpcs"]
    b = mod.run_scenario("snapshot_churn", seed=7, **kw)
    assert a["fingerprint"] == b["fingerprint"]
    if pkg == "port":
        j = jsc.run_scenario("snapshot_churn", seed=7)
        assert a["core"] == j["core"]
        assert a["fingerprint"] == j["fingerprint"]
        assert a["flight_recorder"]["reason"] == \
            j["flight_recorder"]["reason"] == "fault_injected"


def test_cli_prints_the_jax_lines():
    """``python -m upow_tpu_torch.snapshot --check-determinism --device
    cpu``: the round trip, the scenario and its determinism, the JAX
    CLI's lines (the scenario's wall time apart); exit 0 on both."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in (["upow_tpu.snapshot", "--check-determinism"],
                          ["upow_tpu_torch.snapshot", "--check-determinism",
                           "--device", "cpu"])]
    outs = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    assert outs[0][2] == outs[1][2] == 0, outs[1][1]
    jlines, tlines = ([re.sub(r" \d+\.\d\ds fp=", " Xs fp=", ln)
                       for ln in o[0].splitlines()] for o in outs)
    assert tlines == jlines
    assert len(tlines) == 4
    assert tlines[0].startswith("ok   round-trip height=8 ")
    assert tlines[1].startswith("ok     snapshot_churn n=5 seed=7 ")

