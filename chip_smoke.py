#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name and power limit, torch and CUDA versions.
2. Kernels: build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a; hold
   ``wan_encode`` and ``wan_decode`` bit-equal to their plain versions on
   every tier (int8, fp8, int4) at 64M values per pod x 2 pods and on edge
   cases; then time both at the main path's size (the whole granite-8b
   2-layer gradient, 838,881,280 values per pod x 2 pods) beside their
   bound, their plain version and the one PyTorch call that computes the
   same function, where there is one.
3. Main path: granite-8b at full width (depth cut to 2 layers, bf16,
   random weights from a seed), 2 pods, global batch 8, seq 512, sgd, an
   ASGD-GA sync every 2 steps through the int8 codec with error feedback,
   4 steps through ``Trainer.fit``.  Each round's EF residual must equal
   ``flat - local`` and the kernel's decode of the shipped payload must
   equal the plain decode, bit for bit.  The launch counts of this run
   show that the rounds went through the kernels.
4. Entry point: ``repro_torch.launch.train.main`` on the tiny preset.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and non-tensor-core f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SEED = 0
N_MAIN = 838_881_280           # granite-8b, 2 layers: values per pod
PODS = 2
BLOCK = 4096
TOPK = 0.01


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def same(a, b) -> bool:
    """Equal dtypes, shapes and values, element for element."""
    import torch
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi runs")
    print(smi.stdout.strip().splitlines()[0])
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    # f32 matmuls in full f32, as the reference's parity assumes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.wan_codec import k_per_block

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = k_per_block(BLOCK, TOPK)

    def check(x, k_block, block, tier):
        kern = ops.wan_encode(x, k_block, block=block, value_dtype=tier)
        plain = ops.wan_encode(x, k_block, block=block, value_dtype=tier,
                               use_kernel=False)
        require(same(kern, plain), f"encode {tier} {tuple(x.shape)} "
                f"k={k_block} block={block} bit-equal to plain")
        n = x.shape[-1]
        dk = ops.wan_decode(*kern, n, block=block, value_dtype=tier)
        dp = ops.wan_decode(*plain, n, block=block, value_dtype=tier,
                            use_kernel=False)
        torch.cuda.synchronize()
        require(torch.equal(dk, dp), f"decode {tier} {tuple(x.shape)} "
                f"bit-equal to plain")

    big = torch.randn(PODS, 64 << 20, generator=gen, device="cuda")
    edge = torch.randn(PODS, 777_777, generator=gen, device="cuda")
    edge[:, :5000] = 0.25                    # ties
    edge[:, 9000:20000] = 0.0                # all-zero blocks
    for tier in ("int8", "fp8", "int4"):
        check(big, k, BLOCK, tier)
        check(edge, k, BLOCK, tier)          # ragged n, odd k (41)
        check(edge[:, 1000:500_000], 7, 128, tier)   # column slice
        check(edge, 655, 65536, tier)        # largest block: 128 KB smem
        check(torch.zeros(3000, device="cuda"), 5, 1024, tier)
        print(f"[kernels] {tier}: encode and decode bit-equal to plain on "
              f"{PODS} x {64 << 20} values and the edge cases")
    del big, edge

    # time both at the main path's size (int8, the main path's tier)
    x = torch.randn(PODS, N_MAIN, generator=gen, device="cuda")
    kern = ops.wan_encode(x, k)
    plain = ops.wan_encode(x, k, use_kernel=False)
    require(same(kern, plain), "encode at main-path size bit-equal")
    dk = ops.wan_decode(*kern, N_MAIN)
    dp = ops.wan_decode(*plain, N_MAIN, use_kernel=False)
    torch.cuda.synchronize()
    dec_err = float((dk - dp).abs().max())
    enc_err = float((ops.wan_decode(*kern, N_MAIN, use_kernel=False)
                     - dp).abs().max())
    del dk, dp, plain
    q, idx, scales = kern
    enc_ms = time_ms(torch, lambda: ops.wan_encode(x, k), reps=20)
    enc_plain_ms = time_ms(torch, lambda: ops.wan_encode(
        x, k, use_kernel=False), reps=5, warm=1)
    dec_ms = time_ms(torch, lambda: ops.wan_decode(q, idx, scales, N_MAIN),
                     reps=20)
    dec_plain_ms = time_ms(torch, lambda: ops.wan_decode(
        q, idx, scales, N_MAIN, use_kernel=False), reps=5, warm=1)
    nb = scales.shape[1]
    vals = (q.float().reshape(PODS, nb, k) * scales[..., None])
    il = idx.reshape(PODS, nb, k).long()
    dec_lib_ms = time_ms(torch, lambda: torch.zeros(
        PODS, nb, BLOCK, device="cuda").scatter_(2, il, vals), reps=20)
    payload = q.numel() + idx.numel() * 4 + scales.numel() * 4
    dense = PODS * N_MAIN * 4
    winners = PODS * nb * k

    def bound(nbytes, flops):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / F32_FLOP_PER_S * 1e3
        return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")

    # encode: |x| and the max per value, a divide and a round per winner
    enc_bound, enc_by = bound(dense + payload, 2 * PODS * N_MAIN + 2 * winners)
    # decode: one multiply per winner
    dec_bound, dec_by = bound(dense + payload, winners)
    del x, q, idx, scales, kern, vals, il
    torch.cuda.empty_cache()
    print(f"[kernels] wan_encode {PODS} x {N_MAIN}: {enc_ms:.3f} ms "
          f"(bound {enc_bound:.3f} ms by {enc_by}, plain {enc_plain_ms:.1f} "
          f"ms, no single PyTorch call)")
    print(f"[kernels] wan_decode {PODS} x {N_MAIN}: {dec_ms:.3f} ms "
          f"(bound {dec_bound:.3f} ms by {dec_by}, plain {dec_plain_ms:.1f} "
          f"ms, zeros().scatter_() {dec_lib_ms:.3f} ms)")
    src = "src/repro_torch/kernels/csrc/wan_codec.cu"
    return {
        "wan_encode": {"name": "wan_encode", "route": "cuda", "source": src,
                       "replaces": "src/repro/kernels/wan_codec.py:196",
                       "max_abs_err": enc_err, "ms": enc_ms,
                       "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
                       "bound_by": enc_by, "library_ms": None},
        "wan_decode": {"name": "wan_decode", "route": "cuda", "source": src,
                       "replaces": "src/repro/kernels/wan_codec.py:219",
                       "max_abs_err": dec_err, "ms": dec_ms,
                       "plain_ms": dec_plain_ms, "bound_ms": dec_bound,
                       "bound_by": dec_by, "library_ms": dec_lib_ms},
    }


def phase_main_path(torch) -> dict:
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    sync = S.SyncConfig("asgd_ga", 2, compress_topk=TOPK, quantize_int8=True,
                        error_feedback=True)
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    plan = build_training_plan(TrainingRequest(
        model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
        global_batch=8))
    batches = make_batches(plan, cfg.vocab_size, 512, "cuda")
    rounds = []

    def check_round(state, payloads, shipped):
        """Hold the round to its definition; these compare launches are
        not the main path's and leave its counts as they were."""
        counts = dict(ops.LAUNCHES)
        ef = state.sync_state.ef_residual
        require(torch.equal(ef, payloads.flat - payloads.local),
                "EF residual == flat - local")
        n = payloads.flat.shape[1]
        bcfg = sync.for_bucket("all")
        kern = S._decode_bucket(bcfg, shipped["all"], n)
        widths = S._chunk_widths(bcfg, n)
        plain = S._cat([ops.wan_decode(
            c.q, c.idx.to(torch.int32), c.scales, m, block=BLOCK,
            use_kernel=False) for c, m in zip(shipped["all"], widths)])
        require(torch.equal(kern, plain), "peer decode kernel == plain")
        rounds.append(float(ef.norm()))
        ops.LAUNCHES.update(counts)

    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                      lambda g: transformer.init_params(g, cfg, "cuda"),
                      TrainerConfig(n_pods=PODS, optimizer="sgd", lr=0.02,
                                    sync=sync),
                      device="cuda", round_hook=check_round)
    state = trainer.init_state(SEED)
    leaves = T.leaves(state.params)
    n_params = sum(x.numel() for x in leaves) // PODS
    require(n_params == N_MAIN, f"{n_params} params per pod")
    model_mb = sum(x.numel() * x.element_size() for x in leaves) / PODS / 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, hist = trainer.fit(state, batches, 4, model_mb=model_mb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["loss_per_pod"]
    require(all(math.isfinite(v) for row in losses for v in row),
            f"finite losses {losses}")
    require(len(rounds) == 2, f"2 sync rounds checked, got {len(rounds)}")
    require(launches == {"wan_encode": 2, "wan_decode": 4},
            f"main path launches {launches}")
    for leaf in T.leaves(state.params):
        require(bool(torch.isfinite(leaf).all()), "finite params")
    print(f"[main] {cfg.name} x2 layers, {n_params:,} params/pod, {PODS} "
          f"pods, batch 8, seq 512: losses {losses}")
    print(f"[main] step s {[round(t, 4) for t in trainer.step_seconds]}, "
          f"sync-round s {[round(t, 4) for t in trainer.sync_seconds]}, "
          f"EF residual norms {rounds}, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    return launches


def phase_entry_point(torch) -> None:
    from repro_torch.launch import train

    summary = train.main(["--preset", "tiny", "--steps", "8", "--interval",
                          "4", "--compress-topk", "0.02", "--int8",
                          "--error-feedback", "--log-every", "4"])
    require(summary["device"] == "cuda", "launcher ran on the card")
    require(math.isfinite(summary["loss_last"]), "finite loss")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    device = phase_device(torch)
    kernels = phase_kernels(torch)
    launches = phase_main_path(torch)
    phase_entry_point(torch)
    for name, n in launches.items():
        kernels[name]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
