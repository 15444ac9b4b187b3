"""Scale-out: the device mesh of the search and the batch verify
(``mesh``) and the multi-process nonce plan with its ``torch.distributed``
bring-up (``multihost``); the JAX package's ``parallel/``."""

from .mesh import (
    make_mesh,
    pow_search_resident,
    pow_search_sharded,
    shard_batch_arrays,
    shard_bounds,
    verify_packed_sharded,
)
from .multihost import (initialize, my_nonce_range, plan_nonce_ranges,
                        process_slot)
