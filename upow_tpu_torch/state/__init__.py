"""Chain state: sqlite-backed storage and the resident UTXO index (the
port's copies)."""

from .device_index import DeviceUtxoIndex
from .storage import ChainState
