"""The generator and the stub: the same seed gives the same chain and
the same pages, the chain is one the port accepts, and the stub pages
as a port node with default settings does."""

import json
import time
from decimal import Decimal
from pathlib import Path

import pytest

from portbench import chain, procs, stub, uformat


@pytest.fixture(scope="module")
def small_rig(tmp_path_factory):
    """Five full blocks of 32 transactions, mined at difficulty 1.0."""
    return chain.rig_chain(2**40 + 9, 5, 4, 8, 8, "cpu", chunk=1024,
                           difficulty=Decimal("1.0"))


def test_same_seed_same_chain_and_pages(small_rig):
    blocks, prefix = small_rig
    again, prefix2 = chain.rig_chain(2**40 + 9, 5, 4, 8, 8, "cpu", chunk=1024,
                                     difficulty=Decimal("1.0"))
    assert prefix == prefix2 == 3
    assert [b.json() for b in blocks] == [b.json() for b in again]
    other, _ = chain.rig_chain(2**40 + 10, 5, 4, 8, 8, "cpu", chunk=1024,
                               difficulty=Decimal("1.0"))
    assert blocks[-1].hash != other[-1].hash
    assert [len(b.txs) for b in blocks] == [len(b.txs) for b in other]
    a, b = stub.Stub(blocks, Decimal("9.9")), stub.Stub(again, Decimal("9.9"))
    assert json.dumps(a.page(4, 1000)) == json.dumps(b.page(4, 1000))
    s1 = chain.solo_chain(7, 150, Decimal("9.9"), 8, 4, 5)
    s2 = chain.solo_chain(7, 150, Decimal("9.9"), 8, 4, 5)
    assert [b.json() for b in s1.blocks] == [b.json() for b in s2.blocks]
    assert s1.slots == s2.slots and len(s1.slots) == 32


def test_the_chain_is_one_the_port_reads_and_verifies(small_rig):
    from upow_tpu_torch.core import curve
    from upow_tpu_torch.core.codecs import string_to_point
    from upow_tpu_torch.core.difficulty import check_pow
    from upow_tpu_torch.core.header import parse_header
    from upow_tpu_torch.core.merkle import merkle_root
    from upow_tpu_torch.core.tx import tx_from_hex

    blocks, _prefix = small_rig
    prev, owner = uformat.GENESIS_PREV_HASH, {}
    for b in blocks:
        txs = [tx_from_hex(t.hex()) for t in b.txs]
        assert txs[0].is_coinbase and [t.hex() for t in txs] == [
            t.hex() for t in b.txs]
        assert merkle_root(txs[1:]) == parse_header(b.content).merkle_root
        assert check_pow(b.content, prev, Decimal("1.0"))
        for tx in txs:
            for i in tx.inputs:
                assert curve.verify(i.signature, bytes.fromhex(tx.hex(False)),
                                    string_to_point(owner.pop(i.outpoint)))
            for k, o in enumerate(tx.outputs):
                owner[(tx.hash(), k)] = o.address
        prev = b.hash


def test_a_tampered_block_fails_its_signature(small_rig):
    from upow_tpu_torch.core import curve
    from upow_tpu_torch.core.tx import tx_from_hex

    blocks, prefix = small_rig
    body = stub.tampered(blocks[prefix], 3)
    honest, bad = blocks[prefix].txs[4].hex(), body["transactions"][4]
    assert honest != bad and body["transactions"][:4] == [
        t.hex() for t in blocks[prefix].txs[:4]]
    owner = {}
    for raw in blocks[prefix - 1].txs:
        tx = tx_from_hex(raw.hex())
        for k, o in enumerate(tx.outputs):
            owner[(tx.hash(), k)] = o.address
    from upow_tpu_torch.core.codecs import string_to_point
    tx = tx_from_hex(bad)
    i = tx.inputs[0]
    assert not curve.verify(i.signature, bytes.fromhex(tx.hex(False)),
                            string_to_point(owner[i.outpoint]))


def test_stub_pages_match_a_port_node(tmp_path):
    """Sixteen blocks of 8,160 transactions: the node's size cap ends
    its pages, and the stub's pages must be the node's."""
    blocks, _prefix = chain.rig_chain(2**40 + 11, 16, 32, 255, 64, "cpu",
                                      chunk=1024, difficulty=Decimal("1.0"))
    (tmp_path / "logs").mkdir()
    db = tmp_path / "chain.db"
    chain.write_db(db, blocks)
    node, url = procs.start_node("node", cells_root(), tmp_path, db, "cpu")
    peer = stub.Stub(blocks, Decimal("9.9"))
    peer_url = peer.start()
    try:
        procs.wait_ready(node, url, time.monotonic() + 120)
        for offset, limit in [(1, 1000), (4, 1000), (5, 3), (19, 10), (30, 5)]:
            q = f"get_blocks?offset={offset}&limit={limit}"
            assert procs.get_json(url + q) == procs.get_json(peer_url + q)
        for h in (1, 5, 19):
            q = f"get_block?block={h}"
            assert procs.get_json(url + q) == procs.get_json(peer_url + q)
        page = procs.get_json(peer_url + "get_blocks?offset=4&limit=1000")
        assert len(page["result"]) == 14   # eight blocks' worth of hex at most
    finally:
        node.stop()
        peer.stop()


def cells_root() -> Path:
    return Path(__file__).resolve().parents[2]
