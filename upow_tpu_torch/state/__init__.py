"""Chain state: sqlite-backed storage and the resident UTXO index (the
port's copies).  The PostgreSQL backend, ``state.pg``, is not imported
here: the node imports it when ``node.db_backend`` asks for it."""

from .device_index import DeviceUtxoIndex
from .storage import ChainState
