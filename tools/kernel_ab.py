#!/usr/bin/env python3
"""Time the port's redesigned kernels in several checkouts on one CUDA card,
so that two versions compare within one run.

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
  chunk 256, x and a f32, B and C bf16 as a stride-0 view over heads;
- the codec encode at the training path's size: 2 pods x 838,881,280 f32
  values, block 4096, k_block 41, int8;
- a sparse round's 12 top-k launches: granite-8b's 12 leaves at 2 layers,
  2 pods, f32, cut as ``_ship_ring`` cuts them (chunks of 2**26 values,
  block 1024, top-k 0.01).

Run from the repository root on a machine with a CUDA card:

    python3 tools/kernel_ab.py DIR [DIR ...]

It prints the card's name and power limit, one JSON line per run and, last,
one JSON object with every run and each checkout's median times.

    python3 tools/kernel_ab.py --split

splits the time of this checkout's encode and top-k kernels instead: it
builds each source three times, with ``-DKERNEL_SPLIT=0`` (the full
kernel), ``1`` (its loads only, ending in a checksum) and ``2`` (loads and
selection, without the output writes), prints ``nvcc -Xptxas -v``'s
registers, shared memory and spills for each, and times the three
variants on the inputs above.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMED = ("flash_ms", "ssd_ms", "encode_ms", "topk_round_ms")
# -DKERNEL_SPLIT values of --split
SPLIT_MODES = {0: "full", 1: "loads only", 2: "no output writes"}


def _setup(root: str):
    """Import chip_smoke and the checkout under ``root``; returns
    (chip_smoke, torch, generator)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this repository's src first on the path
    # the checkout under test comes before it
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import repro_torch

    module = os.path.dirname(os.path.abspath(repro_torch.__file__))
    cs.require(module == os.path.join(root, "src", "repro_torch"),
               f"repro_torch imported from {root} (got {module})")
    torch.backends.cuda.matmul.allow_tf32 = False
    return cs, torch, torch.Generator(device="cuda").manual_seed(cs.SEED)


def encode_case(cs, torch, gen):
    """The training path's encode: its input and the call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wan_codec import k_per_block

    k = k_per_block(cs.BLOCK, cs.TOPK)
    x = torch.randn(cs.PODS, cs.N_MAIN, generator=gen, device="cuda")
    return x, lambda use_kernel=True: ops.wan_encode(
        x, k, block=cs.BLOCK, use_kernel=use_kernel)


def topk_round_case(cs, torch, gen):
    """A sparse round's 12 top-k launches: the leaves and the call."""
    from repro_torch.kernels import ops

    sizes = cs.granite_leaf_sizes(torch)
    torch.cuda.empty_cache()
    xs = [torch.randn(cs.PODS, m, generator=gen, device="cuda")
          for m in sizes]
    args = [cs.ship_args(m) for m in sizes]
    return xs, lambda use_kernel=True: [
        ops.topk_compress_chunked(x, c, k, block=cs.TOPK_BLOCK,
                                  use_kernel=use_kernel)
        for x, (c, k) in zip(xs, args)]


def run_one(root: str) -> dict:
    cs, torch, gen = _setup(root)
    from repro_torch.kernels import ops, ref

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
    del x, a, Bm, Cm, y, f

    x, encode = encode_case(cs, torch, gen)
    cs.require(cs.same(encode(), encode(use_kernel=False)),
               "encode bit-equal to plain")
    encode_ms = cs.time_ms(torch, encode, reps=20)
    del x, encode
    torch.cuda.empty_cache()

    xs, topk_round = topk_round_case(cs, torch, gen)
    for (vk, ik), (vp, ip) in zip(topk_round(), topk_round(False)):
        cs.require(torch.equal(ik, ip) and torch.equal(
            vk.view(torch.int32), vp.view(torch.int32)),
            "top-k bit-equal to plain")
    topk_round_ms = cs.time_ms(torch, topk_round, reps=10)
    return {"root": root, "flash_ms": flash_ms, "flash_err": flash_err,
            "ssd_ms": ssd_ms, "ssd_err": ssd_err, "encode_ms": encode_ms,
            "topk_round_ms": topk_round_ms}


def run_split() -> dict:
    """Build the encode and top-k sources in their three split modes and
    time each variant in this process."""
    cs, torch, gen = _setup(ROOT)
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("wan_codec", "topk_compress"):
        for mode in SPLIT_MODES:
            so = out_dir / f"lib{name}_split{mode}.so"
            procs[name, mode] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.flags_for(name), "-Xptxas", "-v",
                 f"-DKERNEL_SPLIT={mode}", "-o", str(so),
                 str(_build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
        ptxas[f"{key[0]}/{key[1]}"] = [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line]
    for key, lines in ptxas.items():
        print(f"[ptxas] {key}:", *lines, sep="\n  ", flush=True)

    times = {}
    x, encode = encode_case(cs, torch, gen)
    for mode in SPLIT_MODES:
        _build._LOADED["wan_codec"] = libs["wan_codec", mode]
        times[f"encode/{SPLIT_MODES[mode]}"] = cs.time_ms(torch, encode,
                                                          reps=20)
    del x, encode
    torch.cuda.empty_cache()
    xs, topk_round = topk_round_case(cs, torch, gen)
    for mode in SPLIT_MODES:
        _build._LOADED["topk_compress"] = libs["topk_compress", mode]
        times[f"topk_round/{SPLIT_MODES[mode]}"] = cs.time_ms(
            torch, topk_round, reps=10)
    return {"root": ROOT, "split_ms": times}


def _smi() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", metavar="DIR")
    ap.add_argument("--one", metavar="DIR",
                    help="time one checkout in this process")
    ap.add_argument("--split", action="store_true",
                    help="split this checkout's encode and top-k times")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one))))
        return 0
    if args.split:
        _smi()
        print(json.dumps(run_split()))
        return 0
    if not args.roots:
        ap.error("give at least one DIR")
    _smi()
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
                        for key in TIMED}
    print(json.dumps({"runs": runs, "median": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
