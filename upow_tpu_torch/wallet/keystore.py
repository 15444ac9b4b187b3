"""Wallet key storage: ``key_pair_list.json`` (reference wallet.py:75-88).

Same on-disk shape as the reference's pickledb file and the JAX
package's keystore, ``{"keys": [{"private_key": <int>, "public_key":
<address>}]}``, so an existing uPow wallet file drops in unchanged.  The
default path is ``key_pair_list.json`` in the working directory.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..core import curve
from ..core.codecs import point_to_string


class KeyStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.path.join(os.getcwd(), "key_pair_list.json")
        self._data: dict = {"keys": []}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, OSError):
                pass
        self._data.setdefault("keys", [])

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)

    def create_key(self) -> Tuple[int, str]:
        """Generate, store, return (private_key, address)."""
        d, pub = curve.keygen()
        address = point_to_string(pub)
        self._data["keys"].append({"private_key": d, "public_key": address})
        self.save()
        return d, address

    def keys(self) -> List[dict]:
        return list(self._data["keys"])

    def addresses(self) -> List[str]:
        return [k["public_key"] for k in self._data["keys"]]

    def private_key_for_public(self, address: Optional[str]) -> Optional[int]:
        for k in self._data["keys"]:
            if k.get("public_key") == address:
                return int(k["private_key"])
        return None
