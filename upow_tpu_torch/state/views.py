"""Chain-state views over the storage primitives.

The consensus-critical read logic — the active-inode vote cascade,
stake aggregation, fee math, UTXO fingerprints — is identical whatever
engine holds the tables.  :class:`StateViews` keeps that logic in ONE
place over a small set of storage primitives, which each backend
implements in its own dialect, as in the JAX package:

* :class:`.storage.ChainState` — sqlite (denormalized amounts, JSON
  address arrays),
* :class:`.pg.PgChainState` — PostgreSQL, byte-exact to the reference's
  ``schema.sql``.

The views here are the ones block acceptance, its rule checks and the
node's explorer, address and governance routes call.

Primitives the storage class provides:
    get_transaction_info, get_output_amount, get_registered,
    _all_ballot_rows, get_multiple_address_stakes, get_spendable_outputs,
    get_delegates_voting_power, get_pending_spent_outpoints,
    _pending_decoded, get_transaction_block_timestamp,
    get_table_outpoints_hash, resolve_output_address, add_transactions,
    get_stake_outputs, get_ballot_by_recipient, get_nice_transaction,
    get_block_transaction_hashes.

Every method cites its reference counterpart.
"""

from __future__ import annotations

import json
import os
from decimal import Decimal
from typing import Dict, Iterable, List, Union

from ..core.clock import timestamp as now_ts
from ..core.codecs import OutputType, TransactionType
from ..core.constants import SMALLEST
from ..core.rewards import round_up_decimal
from ..core.tx import CoinbaseTx, Tx

AnyTx = Union[Tx, CoinbaseTx]


class StateViews:
    """Shared pure logic over the storage primitives (see module doc)."""

    # ------------------------------------------------------------- fees ---

    async def tx_fees(self, tx: AnyTx) -> int:
        """fee = Σ input amounts − Σ output amounts (int smallest units).

        Memoized on the tx object: source amounts are content-addressed
        by (tx_hash, index) and therefore immutable for a given input
        set, so a tx's fee never changes — and block accept computes it
        three times per tx (rules check, reward sum, storage row)."""
        if tx.is_coinbase:
            return 0
        # scoped by the state's fees generation (bumped on reorg, like
        # _amount_cache_drop): a tx object held across a remove_blocks
        # must not keep a fee whose source tx no longer exists — the
        # gone-source -> fee=0 decision is consensus (storage.py note)
        gen = getattr(self, "_fees_gen", 0)
        memo = getattr(tx, "_fees_units", None)
        if memo is not None and memo[0] == gen:
            return memo[1]
        total_in = 0
        for i in tx.inputs:
            amount = await self.get_output_amount(i.tx_hash, i.index)
            if amount is None:
                return 0  # unresolvable input: not memoized (may appear)
            total_in += amount
        fee = tx.fees(total_in)
        tx._fees_units = (gen, fee)
        return fee

    def _bump_fees_gen(self) -> None:
        """Invalidate every outstanding per-object fee memo (reorg)."""
        self._fees_gen = getattr(self, "_fees_gen", 0) + 1

    # ----------------------------------------------------- transactions ---

    async def add_transaction(self, tx: AnyTx, block_hash: str) -> None:
        await self.add_transactions([tx], block_hash)

    # ------------------------------------------------------ fingerprints --

    async def get_transactions_info(self, tx_hashes: Iterable[str]) -> Dict[str, dict]:
        out = {}
        for h in tx_hashes:
            info = await self.get_transaction_info(h)
            if info is not None:
                out[h] = info
        return out

    async def get_unspent_outputs_hash(self) -> str:
        """UTXO-set fingerprint: sha256 over the sorted outpoint list —
        the cross-node state-equality oracle (reference database.py:827-830,
        logged every 10 blocks, exposed at GET /)."""
        return await self.get_table_outpoints_hash("unspent_outputs")

    async def get_full_state_hash(self) -> str:
        """Fingerprint over ALL UTXO-class tables (governance included) —
        what replay checks must compare: a divergence confined to e.g.
        the validator ballot leaves the wire-visible unspent_outputs
        fingerprint untouched."""
        import hashlib

        from .storage import _GOV_TABLES

        h = hashlib.sha256()
        for table in ("unspent_outputs",) + _GOV_TABLES:
            h.update(table.encode())
            h.update((await self.get_table_outpoints_hash(table)).encode())
        return h.hexdigest()

    # --------------------------------------------------- address views ----

    async def get_address_balance(self, address: str,
                                  check_pending_txs: bool = False) -> int:
        """Spendable balance in smallest units; ``check_pending_txs`` adds
        unconfirmed incoming REGULAR outputs (reference database.py:1138-1186)."""
        balance = sum(i.amount for i in await self.get_spendable_outputs(
            address, check_pending_txs=check_pending_txs))
        if check_pending_txs:
            for tx in (await self._pending_decoded()).values():
                for out in tx.outputs:
                    if out.address == address and out.output_type == OutputType.REGULAR:
                        balance += out.amount
        return balance

    async def get_address_stake(self, address: str,
                                check_pending_txs: bool = False) -> Decimal:
        """Staked coins as Decimal (reference database.py:1189-1205)."""
        stake = sum(i.amount for i in await self.get_stake_outputs(
            address, check_pending_txs=check_pending_txs))
        stake = Decimal(stake) / SMALLEST
        if check_pending_txs:
            for tx in (await self._pending_decoded()).values():
                for out in tx.outputs:
                    if out.address == address and out.is_stake:
                        stake += Decimal(out.amount) / SMALLEST
        return stake

    # ------------------------------------------------------- governance ---

    async def is_inode_registered(self, address: str,
                                  check_pending_txs: bool = False) -> bool:
        return any(a == address for a, _ in await self.get_registered(
            "inode_registration_output", check_pending_txs))

    async def is_validator_registered(self, address: str,
                                      check_pending_txs: bool = False) -> bool:
        return any(a == address for a, _ in await self.get_registered(
            "validator_registration_output", check_pending_txs))

    async def get_votes_by_voter(self, table: str, voter: str,
                                 check_pending_txs: bool = False) -> List[dict]:
        """Standing votes cast BY ``voter`` (reference database.py:1557-1581
        get_delegates_spent_votes shape) — a filter over
        :meth:`_all_ballot_rows`, the single home of the voter rule."""
        rows = await self._all_ballot_rows(table, check_pending_txs)
        return [
            {"tx_hash": r["tx_hash"], "index": r["index"],
             "recipient": r["recipient"], "vote": r["vote"]}
            for r in rows if r["voter"] == voter
        ]

    async def get_validators_stake(self, validator: str,
                                   check_pending_txs: bool = False) -> Decimal:
        """Sum of vote x delegate stake / 10 over the validator's ballot
        (reference database.py:1127-1136)."""
        ballot = await self.get_ballot_by_recipient(
            "validators_ballot", validator, check_pending_txs)
        total = Decimal(0)
        for entry in ballot:
            if entry["voter"] is None:
                continue
            stake = await self.get_address_stake(entry["voter"], check_pending_txs)
            total += entry["vote"] * stake / 10
        return round_up_decimal(total)

    async def get_inode_vote_ratio_by_address(self, inode: str,
                                              check_pending_txs: bool = False) -> Decimal:
        """Sum of vote x validator stake / 10 over the votes FOR this
        inode (reference database.py:1390-1418)."""
        ballot = await self.get_ballot_by_recipient(
            "inodes_ballot", inode, check_pending_txs)
        total = Decimal(0)
        for entry in ballot:
            if entry["voter"] is None:
                continue
            stake = await self.get_validators_stake(entry["voter"], check_pending_txs)
            total += entry["vote"] * stake / 10
        return round_up_decimal(total)

    async def get_active_inodes(self, check_pending_txs: bool = False) -> List[dict]:
        """Registered inodes with power/emission; active = emission >= 1% or
        registered within 48 h (reference database.py:1377-1388).

        The reference computes this through an O(inodes x votes x
        ballots) SQL cascade per block accept (database.py:1390-1426,
        SURVEY §3 hot loop #3).  Here it is three bulk reads + one
        batched stake query; the per-level round_up_decimal calls mirror
        the cascade's rounding exactly (per-validator stake rounded,
        then per-inode power rounded)."""
        pending = (await self.get_pending_spent_outpoints()) \
            if check_pending_txs else set()
        registered = await self.get_registered(
            "inode_registration_output", check_pending_txs, pending=pending)
        vrows = await self._all_ballot_rows(
            "validators_ballot", check_pending_txs, pending=pending)
        stakes = await self.get_multiple_address_stakes(
            {r["voter"] for r in vrows if r["voter"]}, check_pending_txs,
            pending=pending)
        vstake_raw: Dict[str, Decimal] = {}
        for r in vrows:
            if r["voter"] is None:
                continue
            vstake_raw[r["recipient"]] = vstake_raw.get(
                r["recipient"], Decimal(0)) \
                + r["vote"] * stakes.get(r["voter"], Decimal(0)) / 10
        validators_stake = {k: round_up_decimal(v)
                            for k, v in vstake_raw.items()}
        irows = await self._all_ballot_rows(
            "inodes_ballot", check_pending_txs, pending=pending)
        power_raw: Dict[str, Decimal] = {}
        for r in irows:
            if r["voter"] is None:
                continue
            power_raw[r["recipient"]] = power_raw.get(
                r["recipient"], Decimal(0)) \
                + r["vote"] * validators_stake.get(r["voter"], Decimal(0)) / 10
        details = []
        for address, registered_at in registered:
            details.append({
                "wallet": address,
                "power": round_up_decimal(power_raw.get(address, Decimal(0))),
                "registered_at": registered_at,
            })
        total_power = sum(d["power"] for d in details)
        active = []
        for d in details:
            emission = (
                d["power"] / total_power * 100 if total_power > 0 else d["power"]
            )
            d["emission"] = round_up_decimal(emission, round_up_length="0.01")
            is_active = d["emission"] >= 1 or (now_ts() - d["registered_at"]) <= 48 * 3600
            if is_active:
                active.append(d)
        return active

    async def is_revoke_valid(self, tx_hash: str) -> bool:
        """A vote can be revoked 48 h after the block that recorded it
        (reference database.py:1073-1076)."""
        ts = await self.get_transaction_block_timestamp(tx_hash)
        return ts is not None and now_ts() - ts >= 48 * 3600

    async def get_delegates_spent_votes(self, address: str,
                                        check_pending_txs: bool = False) -> List[dict]:
        """Standing delegate votes by this address (reference
        database.py:1557-1581) — unstake requires these released."""
        return await self.get_votes_by_voter(
            "validators_ballot", address, check_pending_txs)

    async def get_delegates_all_power(self, address: str,
                                      check_pending_txs: bool = False) -> list:
        """Unspent voting power plus standing votes (database.py:1583-1587)."""
        power = list(await self.get_delegates_voting_power(address, check_pending_txs))
        power.extend(
            (v["tx_hash"], v["index"])
            for v in await self.get_delegates_spent_votes(address, check_pending_txs))
        return power

    async def get_validators_spent_votes(self, address: str,
                                         check_pending_txs: bool = False) -> List[dict]:
        """Standing inode votes cast by this validator."""
        return await self.get_votes_by_voter(
            "inodes_ballot", address, check_pending_txs)

    async def get_pending_stake_transactions(self, address: str) -> List[Tx]:
        """Pending txs that stake for this address (database.py:1157-1172)."""
        return [tx for tx in (await self._pending_decoded()).values()
                if any(o.address == address and o.is_stake for o in tx.outputs)]

    async def get_pending_vote_as_delegate_transactions(self, address: str) -> List[Tx]:
        """Pending VOTE_AS_DELEGATE txs whose first input is this address
        (database.py:1174-1187)."""
        out = []
        for tx in (await self._pending_decoded()).values():
            if tx.transaction_type != TransactionType.VOTE_AS_DELEGATE or tx.is_coinbase:
                continue
            if not tx.inputs:
                continue
            first = await self.resolve_output_address(
                tx.inputs[0].tx_hash, tx.inputs[0].index)
            if first == address:
                out.append(tx)
        return out

    # ---------------------------------------------------- explorer views --

    async def get_block_nice_transactions(self, block_hash: str) -> List[dict]:
        # a tx can vanish between the hash listing and the per-tx lookup
        # under a concurrent reorg: drop the None, never embed null
        nice = [
            await self.get_nice_transaction(h)
            for h in await self.get_block_transaction_hashes(block_hash)
        ]
        return [t for t in nice if t is not None]

    # ---------------------------------------------------------- emission --

    def record_emission(self, block_no: int, details: dict) -> None:
        """Per-block reward audit sidecar (reference emission_details.json)."""
        if self.emission_path is None:
            return
        data = {}
        if os.path.exists(self.emission_path):
            with open(self.emission_path) as f:
                data = json.load(f)
        data[str(block_no)] = details
        tmp = self.emission_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.emission_path)
