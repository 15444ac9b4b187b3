"""B2's share of its roofline (kernel B2, ``csrc/sha256_search.cu``).

The least time for the nonces B2 searched in the traced span, over B2's
own time on the card in the miner's capture.  The least time is the
nonces (one round of ``miner_batch`` a launch) times the SM clocks one
nonce needs at the least (``sha.clocks_per_nonce``: 64 ALU-pipe and 128
integer operations an SM a clock, compute capability 9.0), over the
card's SMs at the highest SM clock ``nvidia-smi`` read in the window.
"""

from portbench import readers


def read(obs):
    b2 = obs.extra.get("b2")
    if not b2 or not b2["sm_clock_mhz"]:
        return None
    launches = readers.kernels(obs, "miner", b2["kernel"])
    if not launches:
        return None
    busy = sum(e.end - e.start for e in launches)
    least = (len(launches) * b2["batch"] * b2["clocks_per_nonce"]
             / (b2["sm_count"] * b2["sm_clock_mhz"] * 1e6))
    return 100.0 * least / busy
