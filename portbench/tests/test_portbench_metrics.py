"""The metric arithmetic: rates over the whole window, shares of the
roofline and of the window, means over the window's change."""

import hashlib

import pytest

from portbench import harness, minerlog, readers, registry, sha, tracefile


def _lines(times, batch=1 << 24):
    """A miner that began one template and finished a round at each of
    ``times``."""
    out = [(0.0, "portbench-template " + "02" + "00" * 103),
           (0.0, "difficulty: 9.9  block: 251  confirming 0 transactions")]
    for k, t in enumerate(times, 1):
        out.append((t, f"10000.00 MH/s ({k * batch} hashes)"))
    return out


def test_hash_rate_is_all_hashes_over_the_whole_window():
    steady = [0.5 + 0.01 * k for k in range(1000)]          # 100 rounds a s
    log = minerlog.parse(_lines(steady), 1 << 24)
    assert minerlog.hashes_between(log, 1.0, 6.0) == 500 * (1 << 24)
    # a stall of 2 s inside the window: the rounds after it come later,
    # and the window holds 200 fewer of them
    stalled = [t if t < 3.0 else t + 2.0 for t in steady]
    log = minerlog.parse(_lines(stalled), 1 << 24)
    assert minerlog.hashes_between(log, 1.0, 6.0) == 300 * (1 << 24)


def test_a_repeated_header_adds_no_hashes():
    """A template whose header repeats the last one's (the same second,
    the same pool) sweeps hashes already tried: the rate counts each
    round once, the first time it was mined."""
    head = "portbench-template " + "02" + "00" * 103
    lines = [(0.0, head), (0.5, f"1.00 MH/s ({1 << 24} hashes)"),
             (0.6, f"1.00 MH/s ({2 << 24} hashes)"),
             (1.0, head), (1.5, f"1.00 MH/s ({1 << 24} hashes)"),
             (1.6, f"1.00 MH/s ({2 << 24} hashes)"),
             (1.7, f"1.00 MH/s ({3 << 24} hashes)"),
             (2.0, "portbench-template " + "02" + "00" * 102 + "01"),
             (2.5, f"1.00 MH/s ({1 << 24} hashes)")]
    log = minerlog.parse(lines, 1 << 24)
    assert minerlog.hashes_between(log, 0.0, 3.0) == 4 * (1 << 24)
    # inside a window that opens after the first sweep, its rounds are
    # still not new
    assert minerlog.hashes_between(log, 1.0, 3.0) == 2 * (1 << 24)


def test_the_templates_fetch_times_are_read():
    lines = [(5.0, "portbench-template " + "02" + "00" * 103
              + " 4.250000 4.260000")]
    assert minerlog.parse(lines, 1 << 24).templates[0].fetch == (4.25, 4.26)


def test_the_pool_at_a_fetch_counts_what_was_in_flight():
    from portbench import wallets
    from portbench.reference import _pool_match

    def req(tx, sent, done, ok=True):
        return wallets.Request(0.0, tx, "valid", ("00", 0), sent=sent,
                               done=done, reply={"ok": ok})

    reqs = [req("aa", 1.0, 1.1), req("bb", 1.9, 2.2), req("cc", 2.05, None),
            req("dd", 2.5, 2.6), req("ee", 1.0, 1.2, ok=False)]
    certain, in_flight = wallets.pool_at(reqs, 2.0, 2.1, set())
    assert certain == ["aa"] and in_flight == ["bb", "cc"]
    assert wallets.pool_at(reqs, 2.0, 2.1, {"aa"})[0] == []

    def root(txs):
        from portbench import uformat
        return uformat.miner_merkle([hashlib.sha256(bytes.fromhex(t)).hexdigest()
                                     for t in sorted(txs)])

    assert _pool_match(root(["aa", "cc"]), certain, in_flight) == (
        ["aa", "cc"], True)
    assert _pool_match(root(["bb"]), certain, in_flight) == (None, True)


def test_the_recheck_difficulty_holds_two_hits_a_round():
    from decimal import Decimal

    from portbench import reference, uformat

    for batch in (1 << 20, 1 << 24):
        d = reference.recheck_difficulty(batch)
        hits = batch * 16.0 ** -int(d) * uformat.charset(d) / 16
        assert hits == 2.0
    assert reference.recheck_difficulty(1 << 24) == Decimal("5.9")


def test_a_found_nonce_counts_its_unprinted_round():
    lines = _lines([1.0, 1.1]) + [(1.2, "found nonce 33554433 at 1.00 MH/s"),
                                  (1.3, "{'ok': True}")]
    log = minerlog.parse(lines, 1 << 24)
    assert minerlog.hashes_between(log, 0.0, 2.0) == 3 * (1 << 24)
    tpl = log.templates[0]
    assert tpl.reply == {"ok": True}
    assert minerlog.claimed_rounds(tpl, 1 << 24) == [
        (0, 1 << 24, None), (1 << 24, 1 << 24, None),
        (1 << 25, 1 << 24, 33554433)]


def test_an_expired_sweep_claims_every_round():
    lines = _lines([1.0]) + [(2.0, "template expired after 4294967295 hashes; refreshing")]
    rounds = minerlog.claimed_rounds(minerlog.parse(lines, 1 << 24).templates[0], 1 << 24)
    assert len(rounds) == 256 and rounds[-1] == (255 << 24, (1 << 24) - 1, None)


def test_ops_per_nonce_of_a_v2_template():
    """The count is the template's: a 104-byte prefix leaves the nonce in
    word 10 of the last block; a 9.9 target reads digest words 0, 1 and
    the nibble's word 1."""
    prefix = bytes(range(104))
    prev = hashlib.sha256(b"tip").hexdigest()
    alu, add = sha.ops_per_nonce(prefix, prev, "9.9")
    assert (alu, add) == (825, 289)
    assert sha.clocks_per_nonce(prefix, prev, "9.9") == pytest.approx(825 / 64)
    # an integer difficulty has no nibble test: fewer operations
    assert sha.ops_per_nonce(prefix, prev, "9.0")[0] < alu


def test_the_search_is_the_least_hit():
    prefix = bytes(range(104))
    prev = hashlib.sha256(b"tip").hexdigest()
    hit = sha.search(prefix, prev, "2.5", 0, 1 << 14, "cpu", chunk=1 << 12)
    from portbench import uformat
    ok = [uformat.pow_ok(hashlib.sha256(prefix + n.to_bytes(4, "little")).hexdigest(),
                         prev, uformat.Decimal("2.5")) for n in range(hit + 1)]
    assert ok[-1] and not any(ok[:-1])


def _ev(a, b, name="sha256_search_kernel(SearchArgs, unsigned int*)", cat="kernel"):
    return tracefile.Event(a, b, name, cat)


def test_b2_roofline_is_least_time_over_kernel_time():
    obs = harness.Obs(prof=(0.0, 1.0))
    obs.traces = {"miner": [_ev(0.1, 0.1015), _ev(0.2, 0.2015), _ev(0.95, 1.05)]}
    obs.extra["b2"] = {"clocks_per_nonce": 12.890625, "batch": 1 << 24,
                       "sm_clock_mhz": 1980.0, "sm_count": 132,
                       "kernel": "sha256_search_kernel"}
    least = 2 * (1 << 24) * 12.890625 / (132 * 1980e6)
    value = registry.metric_reader("b2_roofline").read(obs)
    assert value == pytest.approx(100 * least / 0.003)   # the cut launch is out
    assert 0 < value <= 100


def test_card_idle_merges_processes_on_one_clock():
    dev = [_ev(0.0, 0.4), _ev(0.3, 0.5, "p256_verify_kernel"), _ev(0.7, 0.8)]
    assert tracefile.busy_seconds(dev, 0.0, 1.0) == pytest.approx(0.6)
    assert tracefile.gaps(dev, 0.0, 1.0) == [(0.5, 0.7), (0.8, 1.0)]
    obs = harness.Obs(extra={"busy_s": 0.6, "window_s": 1.0})
    assert registry.metric_reader("card_idle").read(obs) == pytest.approx(40.0)
    assert registry.metric_reader("card_idle").read(harness.Obs()) is None
    marks = [(0.69, "miner fetches and builds a template"),
             (0.95, "c commits a block")]
    b = tracefile.breakdown(dev, marks, 0.0, 1.0)
    assert b["idle_gaps"] == [
        ["miner fetches and builds a template", pytest.approx(0.2)],
        ["c commits a block", pytest.approx(0.2)]]
    assert b["device_ops"][0][0] == "sha256_search_kernel(SearchArgs, unsigned int*)"


def test_window_means_come_from_the_change_of_sum_and_count():
    before = {"upow_slo_http_get_mining_info_latency_seconds_sum": 1.0,
              "upow_slo_http_get_mining_info_latency_seconds_count": 10}
    after = {"upow_slo_http_get_mining_info_latency_seconds_sum": 1.5,
             "upow_slo_http_get_mining_info_latency_seconds_count": 110}
    obs = harness.Obs(scrapes={"node": (before, after)})
    assert registry.metric_reader("mining_info_ms").read(obs) == pytest.approx(5.0)
    assert readers.delta_mean((after, after),
                              "upow_slo_http_get_mining_info_latency_seconds") is None


def _requests(stall_at=None, stall=0.0):
    """Requests due every 10 ms for 10 s, each answered 5 ms after it was
    due; a stall holds every answer due in it until it ends."""
    from portbench import wallets

    out = []
    for k in range(1000):
        due = 0.01 * k
        done = due + 0.005
        if stall_at is not None and stall_at <= due < stall_at + stall:
            done = stall_at + stall + 0.005
        r = wallets.Request(due, "", "valid", ("", k), sent=due, done=done,
                            reply={"ok": True})
        out.append(r)
    return out


def test_p95_is_over_every_request_due_in_the_window():
    from portbench import wallets

    lat = wallets.latencies(_requests(), 0.0, 1.0, 9.0)
    assert len(lat) == 801 and wallets.p95(lat) == pytest.approx(0.005)
    # a 1 s stall inside the window: the 100 requests due in it wait for
    # its end, from 1.005 s down to 0.015 s; the 41st latest of the 801
    # is the 95th percentile
    stalled = wallets.latencies(_requests(4.0, 1.0), 0.0, 1.0, 9.0)
    assert wallets.p95(stalled) == pytest.approx(0.605)
    # a reply that never comes is infinitely late
    missing = _requests()
    for r in missing[100:200]:
        r.done = None
    assert wallets.p95(wallets.latencies(missing, 0.0, 0.0, 9.99)) == float("inf")


def test_the_kernels_target_is_read_and_held_to_the_header():
    """The shim prints the seven words the search kernel is handed; the
    reference's own target for the header's difficulty must equal them,
    and the control's (the integer part of 9.9) does not."""
    prev = hashlib.sha256(b"tip").hexdigest()
    words = sha.target(prev, "9.9")
    lines = _lines([1.0]) + [(0.5, "portbench-target " + " ".join(map(str, words)))]
    lines.sort(key=lambda tl: tl[0])
    tpl = minerlog.parse(lines, 1 << 24).templates[0]
    assert tpl.target == words
    assert sha.target(prev, "9.0") != words
    assert words[4:] == (1, 24, 2)   # the nibble: word 1, bits 27-24, 2 of 16
