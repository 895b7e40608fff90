"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles with one
``nvcc`` call into ``build/torch_ext/`` at the repository root (listed in
``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and its flags, so that an edit of any of them rebuilds.
Each source's flags come from one table, :data:`SOURCE_FLAGS`: the sources
whose results are held bit-equal to their plain versions (the codec, the
top-k) pin the float rounding with ``-fmad=false``; the attention and SSD
kernels, held to a tolerance, let the compiler contract their
multiply-adds.  None uses fast math.  A failed build raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
# the flags each csrc/<name>.cu adds to NVCC_FLAGS
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "wan_codec": ("-fmad=false",),
    "topk_compress": ("-fmad=false",),
    "flash_attention": (),
    "ssd_scan": (),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}: the CUDA kernels "
                           f"build only where the CUDA toolkit is installed")
    return path


def flags_for(name: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``; raises for a source the table
    does not list."""
    if name not in SOURCE_FLAGS:
        raise KeyError(f"csrc/{name}.cu has no entry in SOURCE_FLAGS")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def _target(name: str, flags: tuple) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named ``csrc/*.cu`` sources (default: all of them) that
    are not built yet, one ``nvcc`` each, all started together.  Returns
    name -> .so path; raises with the compiler's output if any fails."""
    names = tuple(names) or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    out = {n: _target(n, flags_for(n)) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *flags_for(n), "-o", str(tmp), str(CSRC / f"{n}.cu")],
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
