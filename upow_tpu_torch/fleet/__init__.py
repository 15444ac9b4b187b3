"""Fleet tooling over a swarm (the part of the JAX package's ``fleet/``
the port has so far): :mod:`.recorder`, the per-node flight recorder the
swarm harness builds.  The scraper, the stitcher, the propagation
analysis and the geo-soak come with the swarm's scenarios (ROADMAP
A13f).
"""
