"""Readings that a cell's limits are set from, at the cell's own size.

    python3 trainbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--out FILE]

For each seed: the program's numbers (a run of the cell with a one-cycle
window: set-up, the checked steps and the comparison).  For each control
seed: the control (the reference at fp8 in the program's place) and each
planted fault (half the batch, the exchange between pods left out), each
compared with the reference as the program is.  A state left unchanged
reads 1 by construction and is not run.  One JSON line a reading goes to
``--out`` and to standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def detail(got: dict, ref: dict) -> dict:
    """Where each number's worst reading sits: the loss gap of each step
    and pod, and the worst leaf of each by-leaf number."""
    import statistics

    out = {"loss": [[abs(a - r) / abs(r) for a, r in zip(ga, ra)]
                    for ga, ra in zip(got["loss"], ref["loss"])]}
    for key in ("grad", "change", "ef"):
        if got.get(key) is None or ref.get(key) is None:
            continue
        worst = []
        for g, r in zip(got[key], ref[key]):
            med = statistics.median(r.values())
            gaps = {k: abs(g[k] - v) / max(v, med, 1e-30)
                    for k, v in r.items()}
            k = max(gaps, key=gaps.get)
            worst.append([k, gaps[k], g[k], r[k], med])
        out[key] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from trainbench import harness, traffic, weights
    from trainbench.check import compare
    from trainbench.reference.model import fp8_mm_fn, no_tf32
    from trainbench.reference.train import Reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    cell.limits = {}
    spec, mix = cell.spec, cell.mix
    pdt = getattr(torch, cell.config["torch_dtype"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in (args.first_seed + 7919 * i for i in range(args.seeds)):
        t0 = time.perf_counter()
        res = harness.run(cell, seed, 0.0, False, t0)
        emit({"cell": cell.name, "kind": "program", "seed": seed,
              "numbers": {k: v["value"] for k, v in
                          res.result["checks"].items()},
              "detail": detail(res.got, res.ref),
              "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    for i in range(args.control_seeds):
        seed = args.first_seed + 104729 * (i + 1)
        p0 = weights.make(spec, seed, "cuda", pdt)
        batches = traffic.ring(mix, spec.vocab, seed + 1, "cuda")[:3]
        with no_tf32():
            ref = Reference(spec, mix).run(p0, batches)
            arms = {"control_fp8": Reference(spec, mix, mm=fp8_mm_fn())}
            arms.update({f"fault_{f}": Reference(spec, mix, fault=f)
                         for f in ("half_batch", "no_exchange")})
            for kind, arm in arms.items():
                t0 = time.perf_counter()
                got = arm.run(p0, batches)
                emit({"cell": cell.name, "kind": kind, "seed": seed,
                      "numbers": compare(got, ref),
                      "detail": detail(got, ref),
                      "s": time.perf_counter() - t0})
        del p0, batches, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
