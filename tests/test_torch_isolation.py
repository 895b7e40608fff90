"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor anything of the JAX package ``repro``.  Checked in a fresh
interpreter, since this test process has both loaded already."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(",".join(names))
print(",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    names, bad = lines[0].split(","), (lines[1] if len(lines) > 1 else "")
    assert len(names) >= 20
    # the mesh and sharding modules and the dry run are among those
    # imported
    assert {"repro_torch.sharding.rules", "repro_torch.launch.mesh",
            "repro_torch.launch.shapes", "repro_torch.launch.context",
            "repro_torch.launch.dryrun"} <= set(names)
    assert bad == "", f"repro_torch pulled in: {bad}"
