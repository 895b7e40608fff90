#!/usr/bin/env python3
"""How deep qwen2-vl-2b trains on one CUDA card under each ``remat``
policy: the depth cut of ``chip_smoke.py`` phase 6f.

For each ``--layers`` depth and each ``--remat`` policy, runs phase 6f's
training arm (``chip_smoke.vl_train_arm``: full width, 2 pods, global batch
8, seq 1024, patch embeddings, ASGD-GA interval 2 through the int8 codec
with error feedback) for ``--steps`` steps and prints its peak device
memory and step times; a depth that runs out of memory is reported as
such and the next one is tried.  The last line is one JSON object with all
of it.  Phase 6f trains at the most layers whose ``"none"`` arm peaks under
``chip_smoke.VL_PEAK_GB``.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=src python tools/remat_depth.py [--layers 8,10,12]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="8,10,12,14",
                    help="comma-separated depths (of 28)")
    ap.add_argument("--remat", default="none",
                    help="comma-separated policies: none, full, dots")
    ap.add_argument("--steps", type=int, default=2,
                    help="steps per run (2: one codec round)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("remat_depth: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.phase_device(torch)         # the card's name and power limit
    runs = []
    for layers in (int(x) for x in args.layers.split(",")):
        for remat in args.remat.split(","):
            try:
                arm = chip_smoke.vl_train_arm(torch, layers, remat,
                                              args.steps)
            except torch.cuda.OutOfMemoryError as e:
                arm, why = None, str(e).splitlines()[0]
            if arm is None:                # the failed run's frames are gone
                torch.cuda.empty_cache()
                print(f"[remat] {layers} layers, remat {remat}: out of "
                      f"memory ({why})")
                runs.append({"layers": layers, "remat": remat,
                             "peak_gb": None})
                continue
            print(f"[remat] {layers} layers ({arm['n_params']:,} "
                  f"params/pod), remat {remat}: peak {arm['peak_gb']:.2f} "
                  f"GB (first step {arm['step_peak_gb']:.2f} GB), step s "
                  f"{[round(t, 4) for t in arm['step_s']]}, "
                  f"sync-round s {[round(t, 4) for t in arm['sync_s']]}")
            runs.append({"layers": layers, "remat": remat,
                         "n_params": arm["n_params"],
                         "peak_gb": arm["peak_gb"],
                         "step_peak_gb": arm["step_peak_gb"],
                         "step_s": arm["step_s"],
                         "sync_s": arm["sync_s"]})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
