"""The ten transaction builders (reference upow/upow_wallet/utils.py:11-604):
the port's copy of the JAX package's ``wallet/builders.py``.

Construction rules replicated exactly — greedy coin selection (smallest
single sufficient input, else largest-first fill), the stake builder's
automatic 10-power delegate grant, registration amounts (1000 inode /
100 validator), vote range caps, the 48-hour revoke rule — built
against either of the port's backends (:class:`~..state.storage.ChainState`
or :class:`~..state.pg.PgChainState`) with int smallest-unit amounts and
the pure ``Tx`` codec.

All builders take ``check_pending_txs=True`` views like the reference, so
outputs already referenced by mempool txs are never double-selected.
"""

from __future__ import annotations

from decimal import Decimal
from typing import List, Optional, Sequence, Tuple

from ..core import curve
from ..core.codecs import OutputType, TransactionType, point_to_string
from ..core.constants import MAX_INODES, SMALLEST
from ..core.tx import Tx, TxInput, TxOutput
from ..state.storage import ChainState


def _to_units(amount) -> int:
    units = Decimal(str(amount)) * SMALLEST
    if units != int(units):
        raise ValueError(f"amount {amount} has more than 8 decimals")
    return int(units)


def _type_message(tx_type: TransactionType) -> bytes:
    """Tx type is carried in the free-form message bytes
    (reference helpers.py:97-112 / utils.py string_to_bytes(str(value)))."""
    return str(int(tx_type)).encode()


def select_transaction_inputs(inputs: List[TxInput], amount: int) -> List[TxInput]:
    """Greedy selection (utils.py:594-604): smallest input that covers the
    whole amount, else fill largest-first."""
    chosen: List[TxInput] = []
    for tx_input in sorted(inputs, key=lambda i: i.amount):
        if tx_input.amount >= amount:
            chosen.append(tx_input)
            break
    for tx_input in sorted(inputs, key=lambda i: i.amount, reverse=True):
        if sum(i.amount for i in chosen) >= amount:
            break
        chosen.append(tx_input)
    return chosen


class WalletBuilder:
    """Builders over one chain state, sqlite or PostgreSQL (direct-DB
    wallet mode)."""

    def __init__(self, state: ChainState):
        self.state = state

    # ------------------------------------------------------------ helpers --
    @staticmethod
    def _address_of(private_key: int) -> Tuple[str, tuple]:
        pub = curve.point_mul(private_key, curve.G)
        return point_to_string(pub), pub

    def _signer(self, pub):
        return lambda tx_input: pub

    async def _power_inputs(self, table: str, address: str) -> List[TxInput]:
        """Voting-power / registration outputs as spendable TxInputs."""
        rows = await self.state.get_outputs_by_address(
            table, address, check_pending_txs=True)
        out = []
        for r in rows:
            i = TxInput(r["tx_hash"], r["index"])
            i.amount = r["amount"]
            out.append(i)
        return out

    async def _ballot_inputs(self, table: str, voter: str,
                             recipient: str) -> List[TxInput]:
        """Standing votes by ``voter`` for ``recipient`` as TxInputs."""
        votes = await self.state.get_votes_by_voter(
            table, voter, check_pending_txs=True)
        out = []
        for v in votes:
            if v["recipient"] != recipient:
                continue
            i = TxInput(v["tx_hash"], v["index"])
            i.amount = int(v["vote"] * SMALLEST)
            out.append(i)
        return out

    # ------------------------------------------------------------- send ----
    async def create_transaction(self, private_key: int, receiving_address: str,
                                 amount, message: Optional[bytes] = None,
                                 send_back_address: Optional[str] = None) -> Tx:
        """Plain send with greedy selection + change (utils.py:11-60)."""
        units = _to_units(amount)
        sender, pub = self._address_of(private_key)
        send_back_address = send_back_address or sender
        inputs = await self.state.get_spendable_outputs(
            sender, check_pending_txs=True)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough funds")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen, [TxOutput(receiving_address, units)], message)
        if total > units:
            tx.outputs.append(TxOutput(send_back_address, total - units))
        return tx.sign([private_key], self._signer(pub))

    async def create_transaction_to_send_multiple_wallet(
            self, private_key: int, receiving_addresses: Sequence[str],
            amounts: Sequence, message: Optional[bytes] = None,
            send_back_address: Optional[str] = None) -> Tx:
        """Multi-recipient send (utils.py:63-120; largest-first selection)."""
        if len(receiving_addresses) != len(amounts):
            raise ValueError(
                "Receiving addresses length is different from amounts length")
        units = [_to_units(a) for a in amounts]
        total_amount = sum(units)
        sender, pub = self._address_of(private_key)
        send_back_address = send_back_address or sender
        inputs = await self.state.get_spendable_outputs(
            sender, check_pending_txs=True)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < total_amount:
            raise ValueError("Error: You don't have enough funds")
        chosen: List[TxInput] = []
        input_amount = 0
        for tx_input in sorted(inputs, key=lambda i: i.amount, reverse=True):
            chosen.append(tx_input)
            input_amount += tx_input.amount
            if input_amount >= total_amount:
                break
        outputs = [TxOutput(addr, a)
                   for addr, a in zip(receiving_addresses, units)]
        change = input_amount - total_amount
        if change > 0:
            outputs.append(TxOutput(send_back_address, change))
        tx = Tx(chosen, outputs, message)
        return tx.sign([private_key], self._signer(pub))

    # ------------------------------------------------------------ staking --
    async def create_stake_transaction(self, private_key: int, amount,
                                       send_back_address: Optional[str] = None) -> Tx:
        """Stake + automatic first-time 10-power delegate grant
        (utils.py:123-192)."""
        units = _to_units(amount)
        sender, pub = self._address_of(private_key)
        send_back_address = send_back_address or sender
        inputs = await self.state.get_spendable_outputs(
            sender, check_pending_txs=True)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough funds")
        if await self.state.get_stake_outputs(sender):
            raise ValueError("Already staked")
        if await self.state.get_pending_stake_transactions(sender):
            raise ValueError("Already staked. Transaction is in pending")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen, [TxOutput(sender, units, OutputType.STAKE)])
        if total > units:
            tx.outputs.append(TxOutput(send_back_address, total - units))
        if not await self.state.get_delegates_all_power(
                sender, check_pending_txs=True):
            tx.outputs.append(TxOutput(
                sender, 10 * SMALLEST, OutputType.DELEGATE_VOTING_POWER))
        return tx.sign([private_key], self._signer(pub))

    async def create_unstake_transaction(self, private_key: int) -> Tx:
        """Unstake the (single) stake output (utils.py:195-222)."""
        sender, pub = self._address_of(private_key)
        stake_inputs = await self.state.get_stake_outputs(
            sender, check_pending_txs=True)
        if not stake_inputs:
            raise ValueError("Error: There is nothing staked")
        if await self.state.get_delegates_spent_votes(sender):
            raise ValueError("Kindly release the votes.")
        if await self.state.get_pending_vote_as_delegate_transactions(sender):
            raise ValueError(
                "Kindly release the votes. Vote transaction is in pending")
        amount = stake_inputs[0].amount
        tx = Tx([stake_inputs[0]],
                [TxOutput(sender, amount, OutputType.UN_STAKE)])
        return tx.sign([private_key], self._signer(pub))

    # ----------------------------------------------------------- registry --
    async def create_inode_registration_transaction(self, private_key: int) -> Tx:
        """1000-coin inode registration (utils.py:225-287)."""
        units = 1000 * SMALLEST
        address, pub = self._address_of(private_key)
        inputs = await self.state.get_spendable_outputs(
            address, check_pending_txs=True)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough funds")
        if not await self.state.get_stake_outputs(address, check_pending_txs=True):
            raise ValueError("You are not a delegate. Become a delegate by staking.")
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            raise ValueError("This address is already registered as inode.")
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            raise ValueError("This address is registered as validator and a "
                             "validator cannot be an inode.")
        if len(await self.state.get_active_inodes(check_pending_txs=True)) >= MAX_INODES:
            raise ValueError(f"{MAX_INODES} inodes are already registered.")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen, [TxOutput(address, units, OutputType.INODE_REGISTRATION)])
        if total > units:
            tx.outputs.append(TxOutput(address, total - units))
        return tx.sign([private_key], self._signer(pub))

    async def create_inode_de_registration_transaction(self, private_key: int) -> Tx:
        """Spend the registration output back (utils.py:290-313)."""
        address, pub = self._address_of(private_key)
        inputs = await self._power_inputs("inode_registration_output", address)
        if not inputs:
            raise ValueError("This address is not registered as an inode.")
        active = await self.state.get_active_inodes(check_pending_txs=True)
        if any(e.get("wallet") == address for e in active):
            raise ValueError("This address is an active inode. Cannot de-register.")
        amount = inputs[0].amount
        tx = Tx(inputs, [TxOutput(address, amount)],
                _type_message(TransactionType.INODE_DE_REGISTRATION))
        return tx.sign([private_key], self._signer(pub))

    async def create_validator_registration_transaction(self, private_key: int) -> Tx:
        """100-coin validator registration + 10 voting power
        (utils.py:316-377)."""
        units = 100 * SMALLEST
        address, pub = self._address_of(private_key)
        inputs = await self.state.get_spendable_outputs(
            address, check_pending_txs=True)
        if not inputs:
            raise ValueError("No spendable outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough funds")
        if not await self.state.get_stake_outputs(address, check_pending_txs=True):
            raise ValueError("You are not a delegate. Become a delegate by staking.")
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            raise ValueError("This address is already registered as validator.")
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            raise ValueError("This address is registered as inode and an inode "
                             "cannot be a validator.")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen,
                [TxOutput(address, units, OutputType.VALIDATOR_REGISTRATION)],
                _type_message(TransactionType.VALIDATOR_REGISTRATION))
        tx.outputs.append(TxOutput(
            address, 10 * SMALLEST, OutputType.VALIDATOR_VOTING_POWER))
        if total > units:
            tx.outputs.append(TxOutput(address, total - units))
        return tx.sign([private_key], self._signer(pub))

    # ------------------------------------------------------------- voting --
    async def create_voting_transaction(self, private_key: int, vote_range,
                                        vote_receiving_address: str) -> Tx:
        """Dispatch by eligibility (utils.py:380-406)."""
        try:
            vote_int = int(vote_range)
        except (TypeError, ValueError):
            raise ValueError("Invalid voting range")
        if vote_int > 10:
            raise ValueError("Voting should be in range of 10")
        if vote_int <= 0:
            raise ValueError("Invalid voting range")
        address, _ = self._address_of(private_key)
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            raise ValueError("This address is registered as inode. Cannot vote.")
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            return await self.vote_as_validator(
                private_key, vote_int, vote_receiving_address)
        if await self.state.get_stake_outputs(address, check_pending_txs=True):
            return await self.vote_as_delegate(
                private_key, vote_int, vote_receiving_address)
        raise ValueError("Not eligible to vote")

    async def vote_as_validator(self, private_key: int, vote_range: int,
                                recipient: str) -> Tx:
        """Spend validator voting power into the inode ballot
        (utils.py:409-457)."""
        units = vote_range * SMALLEST
        address, pub = self._address_of(private_key)
        inputs = await self._power_inputs("validators_voting_power", address)
        if not inputs:
            raise ValueError("No voting outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough voting power left. "
                             "Kindly revoke some voting power.")
        if not await self.state.is_inode_registered(recipient, check_pending_txs=True):
            raise ValueError("Vote recipient is not registered as an inode.")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen,
                [TxOutput(recipient, units, OutputType.VOTE_AS_VALIDATOR)],
                _type_message(TransactionType.VOTE_AS_VALIDATOR))
        if total > units:
            tx.outputs.append(TxOutput(
                address, total - units, OutputType.VALIDATOR_VOTING_POWER))
        return tx.sign([private_key], self._signer(pub))

    async def vote_as_delegate(self, private_key: int, vote_range: int,
                               recipient: str) -> Tx:
        """Spend delegate voting power into the validator ballot
        (utils.py:460-507)."""
        units = vote_range * SMALLEST
        address, pub = self._address_of(private_key)
        inputs = await self._power_inputs("delegates_voting_power", address)
        if not inputs:
            raise ValueError("No voting outputs")
        if sum(i.amount for i in inputs) < units:
            raise ValueError("Error: You don't have enough voting power left. "
                             "Kindly release some voting power.")
        if not await self.state.is_validator_registered(
                recipient, check_pending_txs=True):
            raise ValueError("Vote recipient is not registered as a validator.")
        chosen = select_transaction_inputs(inputs, units)
        total = sum(i.amount for i in chosen)
        tx = Tx(chosen,
                [TxOutput(recipient, units, OutputType.VOTE_AS_DELEGATE)],
                _type_message(TransactionType.VOTE_AS_DELEGATE))
        if total > units:
            tx.outputs.append(TxOutput(
                address, total - units, OutputType.DELEGATE_VOTING_POWER))
        return tx.sign([private_key], self._signer(pub))

    # ------------------------------------------------------------- revoke --
    async def create_revoke_transaction(self, private_key: int,
                                        revoke_from_address: str) -> Tx:
        """Dispatch by role (utils.py:510-522)."""
        address, _ = self._address_of(private_key)
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            return await self.revoke_vote_as_validator(
                private_key, revoke_from_address)
        if await self.state.get_stake_outputs(address, check_pending_txs=True):
            return await self.revoke_vote_as_delegate(
                private_key, revoke_from_address)
        raise ValueError("Not eligible to revoke")

    async def revoke_vote_as_validator(self, private_key: int,
                                       inode_address: str) -> Tx:
        """Reclaim voting power from the inode ballot after 48 h
        (utils.py:525-557)."""
        address, pub = self._address_of(private_key)
        ballot_inputs = await self._ballot_inputs(
            "inodes_ballot", address, inode_address)
        if not ballot_inputs:
            raise ValueError("You have not voted.")
        valid = [await self.state.is_revoke_valid(i.tx_hash)
                 for i in ballot_inputs]
        if not any(valid):
            raise ValueError("You can revoke after 48 hrs of voting")
        total = sum(i.amount for i in ballot_inputs)
        tx = Tx(ballot_inputs,
                [TxOutput(address, total, OutputType.VALIDATOR_VOTING_POWER)],
                _type_message(TransactionType.REVOKE_AS_VALIDATOR))
        return tx.sign([private_key], self._signer(pub))

    async def revoke_vote_as_delegate(self, private_key: int,
                                      validator_address: str) -> Tx:
        """Reclaim delegate voting power from the validator ballot
        (utils.py:560-591)."""
        address, pub = self._address_of(private_key)
        ballot_inputs = await self._ballot_inputs(
            "validators_ballot", address, validator_address)
        if not ballot_inputs:
            raise ValueError("You have not voted.")
        valid = [await self.state.is_revoke_valid(i.tx_hash)
                 for i in ballot_inputs]
        if not any(valid):
            raise ValueError("You can revoke after 48 hrs of voting")
        total = sum(i.amount for i in ballot_inputs)
        tx = Tx(ballot_inputs,
                [TxOutput(address, total, OutputType.DELEGATE_VOTING_POWER)],
                _type_message(TransactionType.REVOKE_AS_DELEGATE))
        return tx.sign([private_key], self._signer(pub))
