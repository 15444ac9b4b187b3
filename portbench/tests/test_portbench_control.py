"""The controls and the faults must come out as not correct.

The miner's control searches for the integer part of the difficulty:
its target without the fractional charset, the step that would tempt a
faster miner.  Its faults keep mining the first template (a step that
returns its state unchanged), push the found nonce plus one (an
answer altered where it is produced), or search the first half of each
round and answer for all of it (half of the batch left out).  The node's control takes every
signature as valid (the guarantee its configuration states, skipped);
its faults leave spent outputs unspent, or turn the first verdict of
every batch.  On the card the miner's control runs at the cell's own
size; on the host every variant runs at the small sizes of
``SOLO_CPU`` and ``RIG_CPU``.
"""

import os

import pytest

from portbench.tests import cells


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.mark.parametrize("variant", ["control", "stale_template",
                                     "altered_nonce", "half_round"])
def test_variant_is_not_correct_on_the_host(tmp_path, variant):
    result, _obs = cells.run_cell(
        tmp_path, "solo_miner_d9.9", cells.SOLO_CPU, {"miner_variant": variant},
        seconds=8, seed=2**33 + 17, device="cpu")
    print(variant, _checks(result))
    assert result["correct"] is False


def test_sound_miner_is_correct_on_the_host(tmp_path):
    result, _obs = cells.run_cell(
        tmp_path, "solo_miner_d9.9", cells.SOLO_CPU, {}, seconds=8,
        seed=2**33 + 17, device="cpu")
    print(_checks(result))
    assert result["correct"] is True
    assert result["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 101, 2**33 + 102, 2**33 + 103])
@pytest.mark.parametrize("variant", ["control", "half_round"])
def test_miner_variant_is_not_correct_on_the_card(card, tmp_path, variant,
                                                  seed):
    """At the cell's own size: the control, and the miner that leaves
    half of each round out (whose rate doubles)."""
    from portbench import registry

    seconds = float(os.environ.get("PORTBENCH_CONTROL_SECONDS", "10"))
    traffic = dict(registry.traffic("trickle"), miner_variant=variant)
    result, obs = cells.run_cell(
        tmp_path, "solo_miner_d9.9", {}, traffic, seconds=seconds, seed=seed,
        device="cuda", sm_count=132, name="solo_miner.trickle")
    print(variant, seed, _checks(result), result["attempted"],
          round(obs.e2e["hash_rate"], 3))
    assert result["correct"] is False


def _rig(tmp_path, node_variant=""):
    traffic = {"node_variant": node_variant} if node_variant else {}
    result, obs = cells.run_cell(
        tmp_path, "mining_rig_d9.9", cells.RIG_CPU, traffic, seconds=4,
        seed=2**40 + 3, device="cpu")
    print(node_variant, _checks(result))
    return result


def test_sound_rig_is_correct_on_the_host(tmp_path):
    assert _rig(tmp_path)["correct"] is True


@pytest.mark.parametrize("variant", ["control", "utxo_unchanged",
                                     "flipped_verdict"])
def test_rig_variant_is_not_correct_on_the_host(tmp_path, variant):
    """The control (a node that takes every signature as valid) commits
    the tampered block; a node that leaves spent outputs unspent keeps
    a wrong UTXO set; one that turns a verdict refuses honest blocks."""
    assert _rig(tmp_path, variant)["correct"] is False


WALLETS_CPU = {"rate": 20, "warmup_s": 2, "connections": 16,
               "bad_signature": 0.05, "double_spend": 0.05,
               "double_spend_gap_s": 1.0}


def _wallets(tmp_path, node_variant=""):
    mix = dict(WALLETS_CPU, node_variant=node_variant) if node_variant \
        else WALLETS_CPU
    result, obs = cells.run_cell(
        tmp_path, "solo_miner_d9.9", dict(cells.SOLO_CPU, per_fan=8), mix,
        seconds=6, seed=2**40 + 5, device="cpu")
    print(node_variant, _checks(result), obs.extra["wallets"])
    return result


def test_sound_wallets_are_correct_on_the_host(tmp_path):
    assert _wallets(tmp_path)["correct"] is True


@pytest.mark.parametrize("variant", ["control", "altered_reply"])
def test_wallets_variant_is_not_correct_on_the_host(tmp_path, variant):
    """The control admits the changed signatures; an altered reply
    refuses a valid transaction.  (A turned signature verdict is no
    fault here: the intake checks a refused transaction again, and the
    verdict cache answers it.)"""
    assert _wallets(tmp_path, variant)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**33 + 201, 2**33 + 202, 2**33 + 203])
@pytest.mark.parametrize("config,mix", [("mining_rig_d9.9", "catchup"),
                                        ("solo_miner_d11.9", "wallets")])
def test_node_control_is_not_correct_on_the_card(card, tmp_path, config, mix,
                                                 seed):
    """The node that takes every signature as valid, at the cell's own
    size: the rig's node commits no tampered block only because its
    merkle check refuses it (with another error than the signature
    rule's), and the wallets' node admits the changed signatures."""
    from portbench import registry

    traffic = dict(registry.traffic(mix), node_variant="control")
    seconds = float(os.environ.get("PORTBENCH_CONTROL_SECONDS", "51"))
    result, _obs = cells.run_cell(
        tmp_path, config, {}, traffic, seconds=seconds, seed=seed,
        device="cuda", sm_count=132)
    print("control", config, mix, seed, _checks(result), result["attempted"])
    assert result["correct"] is False
