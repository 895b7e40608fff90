"""The run's guards: JAX and the JAX package never load, compared by whole
top-level names, and a machine without a CUDA card gets no result."""
import subprocess
import sys

import pytest

from trainbench import run as runmod
from trainbench.tests.tiny import ROOT


@pytest.mark.parametrize("name,flagged", [
    ("repro_torch", False), ("repro_torch.core.sync", False),
    ("reproduce", False), ("repro", True), ("repro.core.sync", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jaxtyping", False)])
def test_foreign_modules_compare_whole_top_level_names(monkeypatch, name,
                                                       flagged):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in runmod.foreign_modules()) == flagged


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "trainbench/run.py", "--workload",
         "granite8b-asgdga-int8", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from trainbench import harness, run\n"
        "from trainbench.tests.tiny import tiny_cell\n"
        "harness.run(tiny_cell('qwen3moe-asgdga-int8'), 1, 0.0, True,\n"
        "            time.perf_counter(), device='cpu')\n"
        "print(run.foreign_modules())\n" % (str(ROOT), str(ROOT / "src")))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
