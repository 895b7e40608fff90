"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles with one
``nvcc`` call into ``build/torch_ext/`` at the repository root (listed in
``.gitignore``), named by a hash of its source and flags so that an edited
source rebuilds.  The flags pin the float rounding the codec's bit-exactness
rests on: ``-fmad=false`` and no fast math.  A failed build raises; nothing
falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           f"build only where the CUDA toolkit is installed")
    return path


def _target(name: str, flags: tuple) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named ``csrc/*.cu`` sources (default: all of them) that
    are not built yet, one ``nvcc`` each, all started together.  Returns
    name -> .so path; raises with the compiler's output if any fails."""
    names = tuple(names) or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    flags = NVCC_FLAGS
    out = {n: _target(n, flags) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode})"
                          f":\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the .so."""
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
