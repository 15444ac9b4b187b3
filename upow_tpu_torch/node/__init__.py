"""The port's node: the HTTP write path (push_tx through the coalescing
intake, push_block through BlockManager) and the reads a miner needs,
on a standard-library HTTP server."""
