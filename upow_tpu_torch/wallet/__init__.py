"""Wallet and client SDK (reference upow/upow_wallet/): the port's copy
of the JAX package's ``wallet/``.

The wallet does no device work: it signs on the host (RFC 6979, so the
same key and chain give the same tx bytes in both packages) and never
initialises CUDA, so its CLI and the nodeless wallet run beside a node
that owns the card.
"""

from .builders import WalletBuilder  # noqa: F401
from .keystore import KeyStore  # noqa: F401
