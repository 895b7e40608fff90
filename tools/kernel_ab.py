#!/usr/bin/env python3
"""Time the flash-attention and SSD kernels of several checkouts of the port
on one CUDA card, so that two versions compare within one run.

Each DIR is the root of a checkout (it holds ``src/repro_torch``).  Each is
run in a process of its own, in the order given (e.g. parent, change,
change, parent), which builds that checkout's kernels from its own sources
into its own ``build/torch_ext/``, holds each kernel to that checkout's
plain version, and times it at its main-path shape with ``chip_smoke.py``'s
``time_ms`` (CUDA-event medians of calls made back to back), so every
checkout is timed the same way:

- flash attention at the serving prefill: B 1, S 2048, H 32, K 8, Dh 128,
  bf16, causal;
- the SSD scan at the mamba2-1.3b prefill: B 1, S 2048, H 64, P 64, N 128,
  chunk 256, x and a f32, B and C bf16 as a stride-0 view over heads.

Run from the repository root on a machine with a CUDA card:

    python3 tools/kernel_ab.py DIR [DIR ...]

It prints the card's name and power limit, one JSON line per run and, last,
one JSON object with every run and each checkout's median times.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_one(root: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this repository's src first on the path
    # the checkout under test comes before it
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import repro_torch
    from repro_torch.kernels import ops, ref

    module = os.path.dirname(os.path.abspath(repro_torch.__file__))
    cs.require(module == os.path.join(root, "src", "repro_torch"),
               f"repro_torch imported from {root} (got {module})")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    bf16 = torch.bfloat16
    S, H, K, Dh = cs.SERVE_PROMPT_LEN, 32, 8, 128
    q, k, v = (randn(1, S, n, Dh).to(bf16) for n in (H, K, K))
    flash_err = cs.flash_close(torch, ops.flash_attention(q, k, v),
                               ref.sdpa(q, k, v), "main-path shape")
    flash_ms = cs.time_ms(torch, lambda: ops.flash_attention(q, k, v),
                          reps=50)
    del q, k, v

    H, P, N, L = 64, 64, 128, cs.MAMBA_CHUNK
    x = randn(1, S, H, P)
    a = -randn(1, S, H).abs() * 0.1
    Bm = randn(1, S, 1, N).to(bf16).expand(1, S, H, N)
    Cm = randn(1, S, 1, N).to(bf16).expand(1, S, H, N)
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=L)
    ssd_err = cs.ssd_close(torch, y, f, *ref.ssd(x, a, Bm, Cm, chunk=L),
                           "main-path shape")[0]
    ssd_ms = cs.time_ms(torch, lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=L),
                        reps=20)
    return {"root": root, "flash_ms": flash_ms, "flash_err": flash_err,
            "ssd_ms": ssd_ms, "ssd_err": ssd_err}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", metavar="DIR")
    ap.add_argument("--one", metavar="DIR",
                    help="time one checkout in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one))))
        return 0
    if not args.roots:
        ap.error("give at least one DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    runs = []
    for root in args.roots:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    median = {}
    for root in dict.fromkeys(r["root"] for r in runs):
        mine = [r for r in runs if r["root"] == root]
        median[root] = {key: statistics.median(r[key] for r in mine)
                        for key in ("flash_ms", "ssd_ms")}
    print(json.dumps({"runs": runs, "median": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
