"""The port imports with ``jax`` and the JAX package out of reach.

A subprocess puts a finder on ``sys.meta_path`` that refuses ``jax``,
``jaxlib`` and ``upow_tpu`` (but not ``upow_tpu_torch``), then imports
every module of the port, and ``chip_smoke.py`` with it.
"""

import os
import pkgutil
import subprocess
import sys

import upow_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "upow_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked for the port: " + name)
        return None


sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def _port_modules():
    names = [upow_tpu_torch.__name__]
    for info in pkgutil.walk_packages(upow_tpu_torch.__path__,
                                      upow_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    names = _port_modules()
    # the slice's modules are all there
    for must in ("core.tx", "crypto.fp", "crypto.p256", "verify.block",
                 "verify.dispatch", "verify.txverify", "state.storage",
                 "state.views", "trace", "device", "_build",
                 "crypto.sha256", "config", "parallel.multihost",
                 "mine.engine", "mine.miner"):
        assert "upow_tpu_torch." + must in names, must
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *names, "chip_smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(names) + 1}" in out.stdout


def test_port_sources_name_no_jax_import():
    """No ``import jax`` / ``from upow_tpu`` line anywhere in the port."""
    bad = []
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "upow_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import jax", "from jax", "from upow_tpu ",
                             "from upow_tpu.", "import upow_tpu ",
                             "import upow_tpu.")):
                bad.append((path, s))
    assert len(sources) > 20 and not bad, bad
