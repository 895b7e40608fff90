"""Run one benchmark cell on this machine's card and print its result.

    python3 trainbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository.  ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics; either way
the last line of standard output is one JSON object, and the numbers the
comparison with the reference read, each beside its limit, are the last
lines of standard error.  Exits non-zero, printing no result, without a
CUDA card, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# whole top-level module names that must never load in a run: JAX and the
# JAX package (``repro``; the port, ``repro_torch``, is another name)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (Linux:
    from ``/proc``, to 10 ms), else at this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _T_START


def foreign_modules() -> list:
    """The loaded modules whose top-level name is one of ``FOREIGN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def main(argv=None) -> int:
    t_start = min(process_start(), _T_START)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("trainbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    from trainbench import harness

    cell = harness.load_cell(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    bad = foreign_modules()
    if bad:
        print(f"trainbench: modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    print("set-up s: " + ", ".join(f"{n} {s:.3f}" for n, s in out.setup),
          file=sys.stderr)
    for name, (value, limit) in out.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
