"""Nothing the benchmark runs may load JAX or the JAX package, compared
by whole top-level names: the port's name begins with the JAX
package's."""

import subprocess
import sys

from portbench import guard
from portbench.tests import cells


def test_top_level_names_are_compared_whole():
    assert guard.forbidden(["upow_tpu_torch", "upow_tpu_torch.node.app",
                            "upow_tpu_torchx", "jaxtyping", "flax_like",
                            "portbench.sha"]) == []
    assert guard.forbidden(["upow_tpu", "upow_tpu.core.tx", "jax.numpy",
                            "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "upow_tpu", "upow_tpu.core.tx"]


def test_the_harness_and_its_reference_load_no_jax():
    """Every module of the benchmark, the reference's checks and the
    program's node and miner entry points, imported in a fresh process,
    leave nothing forbidden in sys.modules."""
    code = (
        "import portbench.harness, portbench.drivers.solo_miner, "
        "portbench.drivers.mining_rig, portbench.reference, portbench.stub, "
        "portbench.miner_shim, portbench.node_shim, portbench.tracefile\n"
        "import upow_tpu_torch.node.run, upow_tpu_torch.mine.miner\n"
        "from portbench import guard\n"
        "print(guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_loaded_jax_package_module_is_found():
    code = ("import sys, types\n"
            "sys.modules['upow_tpu'] = types.ModuleType('upow_tpu')\n"
            "from portbench import guard\n"
            "print(guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "['upow_tpu']"


def test_a_checkout_without_the_program_exits_without_a_result(tmp_path):
    """A folder holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "solo_miner.trickle",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "solo_miner.trickle",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True,
        env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_miner_that_holds_the_jax_package_refuses_the_result(
        tmp_path, capsys):
    """The miner's process reports what it holds when the window closes;
    where it holds ``upow_tpu``, the harness prints no result and exits
    4, naming it."""
    from portbench import harness

    result, obs = cells.run_cell(
        tmp_path, "solo_miner_d9.9", cells.SOLO_CPU,
        {"miner_variant": "jax_package"}, seconds=3, seed=2**33 + 19,
        device="cpu")
    assert obs.extra["modules"] == {"node": [], "miner": ["upow_tpu"]}
    capsys.readouterr()
    assert harness.report(result, obs) == 4
    out = capsys.readouterr()
    assert out.out == "" and "upow_tpu" in out.err


def test_a_process_that_does_not_report_refuses_the_result(capsys):
    from portbench import harness

    obs = harness.Obs(extra={"modules": {"node": None, "miner": []}})
    assert harness.report({"correct": True}, obs) == 4
    assert capsys.readouterr().out == ""
