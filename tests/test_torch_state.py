"""State carried across: a chain database written by the JAX package's
``ChainState(path)`` opens in the port's, which accepts the next block
on it with the same result as the JAX package accepting it on a copy.

This is what a node operator relies on when switching packages: same
sqlite schema, same rows, same UTXO and full-state fingerprints.
"""

import asyncio
import shutil

import pytest
import torch

from test_torch_block import (JAX, PORT, T0, Chain,  # noqa: F401
                              easy_chain, grow)
from upow_tpu_torch.state import storage


def test_port_accepts_next_block_on_a_jax_written_database(tmp_path):
    src = tmp_path / "jax_chain.db"

    async def build():
        chain = Chain(JAX, JAX.ChainState(str(src)))
        _log, leaves = await grow(chain)
        tip = await chain.state.get_last_block()
        chain.state.close()  # checkpoints the WAL into the file
        return leaves, tip

    leaves, tip = asyncio.run(build())
    copies = {}
    for name in ("port", "jax"):
        copies[name] = tmp_path / f"{name}.db"
        shutil.copyfile(src, copies[name])

    async def accept_next(pkg, path):
        chain = Chain(pkg, pkg.ChainState(str(path)))
        before = (await chain.state.get_last_block())["hash"]
        pkg.clock.freeze(T0 + 600)  # both packages mine at one time
        txs = [chain.spend([leaf]) for leaf in leaves]
        ok, errors, utxo = await chain.submit(txs)
        out = (before, ok, errors, utxo,
               await chain.state.get_full_state_hash(),
               (await chain.state.get_last_block())["id"],
               await chain.state.get_address_balance(chain.addr))
        chain.state.close()
        return out

    got = asyncio.run(accept_next(PORT, copies["port"]))
    want = asyncio.run(accept_next(JAX, copies["jax"]))
    assert got[0] == tip["hash"]
    assert got[1], got[2]
    assert got == want
    assert got[5] == 4


def test_device_index_is_not_ported_yet():
    """Asking for the resident UTXO index never silently takes the SQL
    path: on the card without one it raises and leaves no index; on the
    CPU, named, it arms one index per UTXO-class table."""
    state = PORT.ChainState()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            state.enable_device_index()
    assert state.resident_indexes() is None
    state.close()
    state = PORT.ChainState(device_index=True, device="cpu")
    assert sorted(state.resident_indexes()) == sorted(
        ("unspent_outputs",) + storage._GOV_TABLES)
    assert state.index_stats()["entries"] == 0
    state.close()
