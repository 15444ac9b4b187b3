"""upow-tpu ported to PyTorch and CUDA on an NVIDIA H100.

A package beside the JAX one (``upow_tpu/``, the reference it is held
against).  It imports ``torch`` and never ``jax``, and nothing of the JAX
package: the modules it needs are its own copies.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a CUDA kernel written by
hand for sm_90a (``csrc/``), built with nvcc at first use (``_build.py``).

The node's write path, with the reads a miner needs:

    node.run -> node.app.Node (node.http: a standard-library HTTP server)
      push_tx -> mempool.intake.IntakeCoordinator (coalesced batches)
      push_block -> verify.block.BlockManager.check_block / create_block
      -> verify.dispatch.SigDispatchFront (micro-batch coalescing)
      -> device.runtime.DeviceRuntime (one owner a card: its arm,
         weighted fair share of sources, cross-source coalescing)
      -> verify.txverify.run_sig_checks (verdict cache, canaries, retry;
         the degrade, and the native C++ batch as the host path)
      -> crypto.p256.verify_batch_prehashed (VERIFY_KERNEL)
      -> csrc/p256_verify.cu (scalar prep + Jacobian ladder, one launch)
         or csrc/p256_complete.cu (scalar prep + RCB16 complete ladder)

over ``state.storage.ChainState`` (sqlite, same schema as the JAX
package).  The miner:

    mine.miner (CLI: get_mining_info, build_job, push_block)
      -> mine.engine.mine (depth-2 pipelined rounds, TTL, hashlib check)
      -> device.runtime.DeviceRuntime (source "mine")
      -> crypto.sha256.pow_search
      -> csrc/sha256_search.cu (one compression per nonce, least hit)

Entry points run on the card unless given ``device="cpu"``.
"""
