#!/usr/bin/env python3
"""Where the port's serving path spends its time on one CUDA card.

Builds ``--arch`` at its published size (random weights from a seed, bf16):
granite-8b (the default: 36 layers, ``attention_impl="pallas"``, so every
prefill layer runs the flash kernel), mamba2-1.3b (48 SSM layers, every
prefill layer runs the SSD kernel; ``--prompt-len`` must then be at most
256 or a multiple of it), qwen3-moe-30b-a3b (48 MoE layers, flash in
every prefill layer) or jamba-1.5-large-398b at one period with d_ff cut
to 8192 (7 SSD and 1 flash launch a prefill; prompts as mamba2's).  One
4-slot ``ContinuousEngine`` is profiled,
with ``torch.profiler`` over CPU and CUDA activity:

- one insert (the solo prefill of a ``--prompt-len`` prompt plus the cache
  copy into its slot);
- ``--steps`` pool decode steps with all 4 slots live.

Each window runs twice, after a warm-up: first on the host clock alone
(ending in the engine's own host sync; before any profiling, since launches
stay slower once the profiler has attached), then under the profiler, whose
CUDA kernel events give the device time, the launches, the kernels that
took the most device time and the port's own kernels summed per ``ops``
entry point (one SSD call is three launches).  The busy share is device
time over the unprofiled wall time (the rest is the card waiting on the
host).  The last line is one JSON object with all of it.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=src python tools/serving_breakdown.py [--arch mamba2-1.3b]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import (granite_8b, jamba_1_5_large_398b,
                                 mamba2_1_3b, qwen3_moe_30b_a3b)
from repro_torch.models import transformer
from repro_torch.serving.engine import ContinuousEngine


CONFIGS = {"granite-8b": granite_8b.CONFIG.replace(attention_impl="pallas"),
           "mamba2-1.3b": mamba2_1_3b.CONFIG,
           "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG.replace(
               attention_impl="pallas"),
           "jamba-1.5-large-398b": jamba_1_5_large_398b.CONFIG.replace(
               n_layers=8, d_ff=8192, attention_impl="pallas")}
# the port's own kernels, by the names of their CUDA functions: one call of
# ops.ssd_scan is three launches, and their sum is the SSD's share
PORT_KERNELS = {"flash_attention": ("flash_mma_kernel", "flash_f32_kernel"),
                "ssd_scan": ("chunk_state_kernel", "state_pass_kernel",
                             "chunk_scan_kernel")}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _window(prof, wall_s: float, per: int, top: int) -> dict:
    """Device time, busy share, launches and top kernels of one profiled
    window of ``per`` repetitions, against ``wall_s`` per repetition."""
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    device_s = sum(_device_us(e) for e in evts) / 1e6
    launches = sum(e.count for e in evts)
    evts.sort(key=_device_us, reverse=True)
    port = {}
    for name, fns in PORT_KERNELS.items():
        mine = [e for e in evts if any(f in e.key for f in fns)]
        if mine:
            us = sum(_device_us(e) for e in mine)
            port[name] = {"ms": us / 1e3 / per, "share": us / 1e6 / device_s,
                          "launches": sum(e.count for e in mine) / per}
    return {
        "wall_s": wall_s,
        "device_s": device_s / per,
        "busy_share": device_s / per / wall_s,
        "launches": launches / per,
        "port_kernels": port,
        "top": [{"name": e.key[:80], "ms": _device_us(e) / 1e3 / per,
                 "share": _device_us(e) / 1e6 / device_s,
                 "count": e.count / per} for e in evts[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(CONFIGS), default="granite-8b")
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving_breakdown: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    cfg = CONFIGS[args.arch]
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    n_slots = 4
    eng = ContinuousEngine(None, params, n_slots=n_slots,
                           cache_len=args.prompt_len + 4 * args.steps,
                           cfg=cfg, module="transformer")
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, cfg.vocab_size, args.prompt_len
                            ).astype(np.int32)

    max_new = 4 * args.steps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng.insert(prompt(), max_new, rid=0)    # warm-up
    eng.step()
    for rid in range(1, n_slots):
        eng.insert(prompt(), max_new, rid=rid)
    prefill_wall = eng.prefill_seconds[-1]
    if eng.live_slots != list(range(n_slots)):
        raise RuntimeError(f"live slots {eng.live_slots}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    decode_wall = (time.perf_counter() - t0) / args.steps

    eng.evict(n_slots - 1)
    with profile(activities=acts) as prof:
        eng.insert(prompt(), max_new, rid=n_slots)
    out = {"card": card, "prompt_len": args.prompt_len,
           "prefill": _window(prof, prefill_wall, 1, args.top)}
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
    out["decode_step"] = _window(prof, decode_wall, args.steps, args.top)
    out["decode_step"]["slots_live"] = n_slots
    for name in ("prefill", "decode_step"):
        w = out[name]
        print(f"[{name}] {w['wall_s']:.4f} s wall, {w['device_s']:.4f} s "
              f"on the device ({100 * w['busy_share']:.1f}% busy), "
              f"{w['launches']:.0f} launches")
        for t in w["top"]:
            print(f"    {t['ms']:9.3f} ms {100 * t['share']:5.1f}%  "
                  f"x{t['count']:.0f}  {t['name']}")
        for name, t in w["port_kernels"].items():
            print(f"    {t['ms']:9.3f} ms {100 * t['share']:5.1f}%  "
                  f"x{t['launches']:.0f}  all launches of ops.{name}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
