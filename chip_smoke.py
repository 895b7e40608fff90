#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name and power limit, torch and CUDA versions; f32
   matmuls and convolutions without TF32, cuDNN deterministic and not
   autotuned (``cudnn.deterministic``, no ``cudnn.benchmark``).
2. Codec kernels: build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a
   (one ``nvcc`` per source, all started together); hold
   ``wan_encode`` and ``wan_decode`` bit-equal to their plain versions on
   every tier (int8, fp8, int4) at 64M values per pod x 2 pods and on edge
   cases: ragged n, ties, all-zero blocks, column slices (one not 16-byte
   aligned), blocks 128 to 65536, every key in one high-byte bin, ties at
   the threshold over many threads, ``k_block`` 1, 300 and ``k_block ==
   block``; then time both at the main path's size (the whole granite-8b
   2-layer gradient, 838,881,280 values per pod x 2 pods) beside their
   bound, their plain version and the one PyTorch call that computes the
   same function, where there is one.
2b. Flash attention: hold the kernel to its plain version
   (``ref.sdpa``) within 2e-2 (bf16) or 2e-5 (f32) at the serving path's
   shape (B 1, S 2048, H 32, K 8, Dh 128, bf16, causal), a ragged S 1000,
   MQA, f32 inputs, non-causal, window 256 with softcap 50, Dh 256 and the
   reference's kernel-test cases, and on the bf16 tensor-core path at Dh
   32-256 causal and not, S 1-65, Sq != Sk both ways, windows, strided
   views; a misaligned bf16 view must be refused; then time it at the main
   path's shape (ms, TFLOP/s) beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` (timed only, never used by the port).
3. Training path: granite-8b at full width (depth cut to 2 layers, bf16,
   random weights from a seed), 2 pods, global batch 8, seq 512, sgd, an
   ASGD-GA sync every 2 steps through the int8 codec with error feedback,
   4 steps through ``Trainer.fit``.  Each round's EF residual must equal
   ``flat - local`` and the kernel's decode of the shipped payload must
   equal the plain decode, bit for bit.  The launch counts of this run
   show that the rounds went through the kernels.
3d. The control loop: phase 3's model and batch through
   ``repro_torch.launch.train.main`` with ``--bucket-policy layer-class
   --adaptive-sync --wan-trace ... --events ...`` (``CONTROL_*``): the
   ``BucketedSyncController`` retunes each bucket group's tier and top-k
   as a bandwidth collapse and recovery reach it over the ``EventBus``,
   the ``ElasticityController`` re-plans on a straggler and on pod1
   leaving and rejoining (2 -> 1 -> 2 pods, applied at sync barriers).
   Every round, at whatever tiers it runs, is held as phase 3's are, per
   bucket group; at least two retunes, a round at an fp8 or int4 rung and
   the 2 -> 1 -> 2 reconfig must happen.  Prints the decision stream, the
   applied reconfigs, launches by tier, round times by knobs (first round
   at new knobs apart), the reconfig barriers' times and peak memory.
4. Entry point: ``repro_torch.launch.train.main`` on the tiny preset.
2c. SSD scan: hold the kernel to its plain version (``ref.ssd``) within
   the reference's tolerance (``y / max|y|`` within 1e-5, the final state
   within 1e-3) at the reference's kernel-test shapes, S == chunk, S <
   chunk, a non-zero ``init_state``, bf16 B/C, B/C as a stride-0 view over
   heads, chunks 64-256, 16 chunks, the scoring forward's B 2 and the
   serving prefill's shape (B 1, S 2048, H 64, P 64, N 128, chunk 256, x
   and a f32, B and C bf16); then time it there (ms, TFLOP/s) beside its
   bound (the f32-operand products priced as 3xTF32) and its plain
   version (no single PyTorch call computes SSD).
5. Serving path: granite-8b at its published size (36 layers, bf16,
   random weights from a seed, ``attention_impl="pallas"``), two replicas
   (us-east, eu-west) sharing the parameters behind a balanced
   ``GeoRouter``, each a ``ContinuousScheduler`` over a
   ``ContinuousEngine(n_slots=4, cache_len=2080)``; 8 requests drawn as the
   serving launcher draws them with ``--prompt-len 2048``, 32 new tokens
   each.  Every request must finish with 32 tokens, the flash kernel must
   launch 36 times per prefill, every attention layer of the first prefill
   is held to ``ref.sdpa`` on the same q, k, v, and request 0 decoded alone
   in a fresh pool must give the tokens it got beside its neighbours.
6. Entry point: ``repro_torch.launch.serve.main`` on the smoke config.
5c. gemma3-12b at its published size (48 layers, d_model 3840, 16 heads,
   8 KV heads, head_dim 256, window 1024 on 5 of every 6 layers, vocab
   262,144 tied, bf16, random weights from a seed, ``attention_impl=
   "pallas"``): one ``ContinuousEngine`` prefill of a 2048-token prompt
   (48 flash launches; layers 0 and 5 held to ``ref.sdpa``) and 8 decode
   steps; prints the prefill time and the flash kernel's share of it.
7. Mamba2 serving: mamba2-1.3b at its published size (48 layers, bf16,
   random weights from a seed), two replicas as in phase 5; 8 requests
   whose prompt lengths are phase 5's rounded down to a multiple of 256
   (the SSD's chunk; the reference refuses other lengths above it), 32 new
   tokens each.  Every request must finish with 32 tokens, the SSD kernel
   must launch 48 times per prefill, every SSM layer of the first prefill
   is held to ``ref.ssd`` on the same inputs (within 5e-4) and to an f64
   evaluation of the same SSD (within the reference's 1e-5: at the
   model's real decays the f32 plain version is itself ~1e-4 from
   exact), request 0 alone in a fresh
   pool must give the same tokens, and the engine must refuse a 1895-token
   prompt as the reference does.
7b. Mamba2 scoring: ``forward(..., use_ssm_kernel=True)`` at B 2, S 2048
   (48 launches), held to the same forward through the plain SSD.
8. Entry point: ``repro_torch.launch.serve.main --arch mamba2-1.3b``.
2d. Block top-k: hold ``ops.topk_compress_chunked`` (the legacy sparse
   shipping's kernel) bit-equal to its plain version (vals, idx and the
   decompressed dense) on each of granite-8b's 12 leaf shapes at 2 layers
   as ``_ship_ring`` cuts them into chunks of 2**26 values, in f32 and
   bf16, and on ties, zeros, -0.0, pad winners (n 1027), ``k // nb == 0``,
   ``nb * k_block < k``, ``k_block`` 512, ``n < block`` and the inputs
   that split the kernel's branches (large values every 16, 32 or 128
   positions, all equal, a tie at the threshold split across lanes); then
   time it at the largest leaf (embed, 2 pods x 3 chunks) and over a whole
   round's 12 launches beside its bound, its plain version and the nearest
   PyTorch call (``torch.topk`` per block: no tie order, magnitudes), and
   the embed leaf once more with large values every 16 positions, which
   sends every tile down the kernel's general branch.
3b. Sync strategies at full width: phase 3's setup (granite-8b x2 layers,
   2 pods, batch 8, seq 512, sgd, interval 2, 4 steps) under sparse
   ``asgd_ga``, ``ama`` and ``asp`` (top-k 0.01, no codec), ``sma`` and
   ``asgd``; every top-k launch held bit-equal to the plain version
   (``TOPK_CHECK_HOOK``), 24 launches per sparse strategy, none for the
   others, no codec, flash or SSD launch; then sparse ``asgd_ga`` once
   more without the check, whose round times are unfenced (the check
   synchronizes the device after each launch).
3c. The paper's models (LeNet, ResNet, DeepFM) at their own sizes, 2 pods,
   Fig 11's ``asgd@1``, ``asgd_ga@8``, ``ama@8``, ``sma@8`` and ``ama@8``
   at top-k 0.01, 16 steps each; at 2 pods ``ama@8`` and ``sma@8`` must
   agree within 1e-6, step for step.
4b. Entry point: ``repro_torch.launch.train.main --sync ama
   --compress-topk 0.02``.

Every time is a CUDA-event median of calls made back to back, taken the
same way for a kernel, its plain version and the library call.  The line
before the last is a JSON object with one entry per kernel; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, non-tensor-core f32 rate
# and dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# calls timed back to back in each run of time_ms
TIMED_CALLS = 10

SEED = 0
N_MAIN = 838_881_280           # granite-8b, 2 layers: values per pod
PODS = 2
BLOCK = 4096
TOPK = 0.01
# the serving path: granite-8b at 36 layers, 2 replicas of 4 slots
SERVE_REGIONS = ("us-east", "eu-west")
SERVE_SLOTS = 4
SERVE_REQUESTS = 8
SERVE_PROMPT_LEN = 2048
SERVE_NEW_TOKENS = 32
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# the reference's SSD tolerance (tests/test_kernels.py): y / max|y|, and
# the final state absolute
SSD_Y_TOL, SSD_STATE_TOL = 1e-5, 1e-3
# the SSD of a real prefill (see ssd_serving_close): y / max|y| and
# state / max|state| against the plain f32 version, which is itself up to
# 1.4e-4 from the f64 evaluation there (on an H100: kernel vs plain at most
# 1.25e-4 (y) and 1.36e-4 (state) over the 48 layers); the kernel is held
# to the f64 evaluation within the reference's SSD_Y_TOL (measured 3.1e-7)
SERVE_SSD_TOL = 5e-4
# mamba2-1.3b serving: phase 5's prompt lengths rounded down to the chunk
MAMBA_CHUNK = 256
MAMBA_SCORE_BATCH = 2
# the scoring forward through the kernel against the same forward through
# the plain SSD, both bf16 over 48 layers: max |diff| / max|logit| (the two
# SSDs differ in f32 rounding, which flips bf16 roundings that 48 layers
# carry on; on an H100: 7.7e-3, every argmax equal)
MAMBA_LOGIT_TOL = 2e-2
# the paper's models at 2 pods: ama@8 and sma@8 take the same mean, so
# their losses must agree step for step (up to the last bits of the loss's
# own reduction)
PAPER_AMA_SMA_TOL = 1e-6
# the legacy sparse shipping: top-k block (the reference's default)
TOPK_BLOCK = 1024
# phase 3d, the control loop: 2 pods at interval 2, the codec at int8
# with top-k 0.05.  The elasticity controller's 100 Mbps reference puts its
# interval at 1 for every bandwidth of the run, so its first bandwidth
# event (step 1) re-plans once and later ones do not; a 250 Mbps collapse
# at step 3 pushes the per-bucket controller down the ladder (at
# granite-8b's 1.68 GB, to int4 rungs), the straggler's re-plan at 14
# resets the knobs and the controller walks again, pod1 leaves at 24 and
# rejoins at 28 (2 -> 1 -> 2 pods); a round every 4 steps, so each set of
# knobs runs warm rounds after its first
CONTROL_STEPS = 44
CONTROL_TRACE = "2000@0,1900@1,250@3,2000@20"
CONTROL_EVENTS = ("straggler:pod0x2.0@14,bandwidth:1800@19,"
                  "cloud_left:pod1@24,cloud_joined:pod1@28")
CONTROL_EF_GUARD = 0.98
# phase 5c: gemma3-12b's prefill, 2048 prompt tokens and 8 new ones
GEMMA_NEW_TOKENS = 8
GEMMA_CHECKED_LAYERS = (0, 5)       # a windowed layer and a global one
STRATEGIES_3B = (("asgd_ga", TOPK), ("ama", TOPK), ("asp", TOPK),
                 ("sma", 0.0), ("asgd", 0.0))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def clocked(torch, hook, spent: list):
    """``hook`` fenced by device syncs, its seconds added to ``spent[0]``.
    A check hook runs inside a timed serving run (all of it inside the
    first prefill); the run's prefill seconds and tok/s leave its time
    out."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hook(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
    return run


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Median device time of one ``fn`` call over ``reps`` runs (CUDA
    events), each of ``TIMED_CALLS`` calls back to back, so that the host's
    work for one call overlaps the device's for the one before, as on a
    model's path.  Kernels, plain versions and library calls alike."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMED_CALLS):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / TIMED_CALLS)
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
    # f32 matmuls and convolutions in full f32, as the reference's parity
    # assumes; cuDNN's deterministic algorithms and no autotuning, so that
    # two runs that must agree (phase 3c's ama@8 and sma@8 at 2 pods) do
    # not differ by the order of an atomic sum or by the algorithm chosen
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
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
    # every key in one high-byte bin; ties at the threshold over many
    # threads
    one_bin = torch.sign(edge) * (1 + torch.rand(
        PODS, edge.shape[1], generator=gen, device="cuda"))
    halves = torch.round(edge * 2) / 2
    for tier in ("int8", "fp8", "int4"):
        check(big, k, BLOCK, tier)
        check(edge, k, BLOCK, tier)          # ragged n, odd k (41)
        check(edge[:, 1000:500_000], 7, 128, tier)   # column slice
        check(edge[:, 3:500_003], k, BLOCK, tier)    # not 16-byte aligned
        check(edge, 655, 65536, tier)        # largest block: 128 KB smem
        check(torch.zeros(3000, device="cuda"), 5, 1024, tier)
        check(one_bin, k, BLOCK, tier)
        check(halves, k, BLOCK, tier)
        check(halves, 655, 65536, tier)
        check(edge, 1, BLOCK, tier)          # k_block 1
        check(edge, 300, BLOCK, tier)        # above 256: the general path
        check(edge[:, :5000], 128, 128, tier)        # k_block == block
        print(f"[kernels] {tier}: encode and decode bit-equal to plain on "
              f"{PODS} x {64 << 20} values and the edge cases")
    del big, edge, one_bin, halves

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


def flash_close(torch, out, expect, what: str) -> float:
    """Hold a flash output to its plain version at the dtype's tolerance;
    returns the largest absolute difference."""
    tol = FLASH_TOL[str(out.dtype)]
    diff = (out.float() - expect.float()).abs()
    bad = diff > tol + tol * expect.float().abs()
    require(not bool(bad.any()) and bool(torch.isfinite(out).all()),
            f"flash {what} within {tol} of ref.sdpa "
            f"(max |diff| {float(diff.max()):.3g})")
    return float(diff.max())


def phase_flash(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, H, K, Dh, dtype, Sk=None):
        return [torch.randn(B, n_s, n, Dh, generator=gen, device="cuda"
                            ).to(dtype)
                for n_s, n in ((S, H), (Sk or S, K), (Sk or S, K))]

    def check(B, S, H, K, Dh, dtype, causal=True, window=None,
              softcap=0.0, Sk=None):
        q, k, v = inputs(B, S, H, K, Dh, dtype, Sk)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        expect = ref.sdpa(q, k, v, causal=causal, window=window,
                          softcap=softcap)
        torch.cuda.synchronize()
        return flash_close(torch, out, expect, f"{(B, S, H, K, Dh)} {dtype} "
                           f"Sk={Sk or S} causal={causal} window={window} "
                           f"softcap={softcap}")

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((1, 2048, 32, 8, 128, bf16), {}),            # the serving prefill
        ((1, 1000, 32, 8, 128, bf16), {}),            # ragged S
        ((1, 2048, 32, 1, 128, bf16), {}),            # MQA
        ((1, 1024, 32, 8, 128, f32), {}),             # f32 inputs
        ((1, 1024, 32, 8, 128, bf16), {"causal": False}),
        ((1, 1024, 32, 16, 128, bf16), {"window": 256, "softcap": 50.0}),
        ((1, 1024, 16, 8, 256, bf16), {}),            # Dh 256
    ]
    # the reference's kernel tests (tests/test_kernels.py)
    for shape in ((2, 128, 4, 2, 64), (1, 256, 4, 4, 64), (2, 96, 6, 2, 32),
                  (1, 64, 8, 1, 128)):
        cases += [(shape + (f32,), {}), (shape + (bf16,), {})]
    cases += [((1, 128, 4, 2, 64, f32), {"window": w, "softcap": c})
              for w in (16, 64) for c in (0.0, 30.0)]
    cases.append(((2, 64, 2, 2, 32, f32), {"causal": False}))
    # the tensor-core (bf16) path: every head dim, less than one tile,
    # Sq != Sk both ways, MQA, non-causal, window and soft-cap
    cases += [((1, 1024, 16, 4, dh, bf16), {"causal": c})
              for dh in (32, 64, 128, 256) for c in (True, False)]
    cases += [((2, s, 8, 2, 128, bf16), {}) for s in (1, 5, 17, 65)]
    cases += [((2, sq, 8, 2, 128, bf16), {"Sk": sk, "causal": c})
              for sq, sk in ((100, 300), (300, 100), (17, 1000))
              for c in (True, False)]
    cases += [((1, 1000, 16, 1, 64, bf16), {}),
              ((1, 333, 4, 2, 64, bf16), {"window": 16, "softcap": 30.0}),
              ((1, 333, 4, 2, 64, bf16), {"window": 64}),
              ((1, 2048, 32, 8, 128, bf16), {"window": 700})]
    for shape, kw in cases:
        check(*shape, **kw)
    # strided views read in place, and a misaligned one refused
    qkv = torch.randn(2, 100, 8, 64, generator=gen, device="cuda").to(bf16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    flash_close(torch, ops.flash_attention(q, k, v), ref.sdpa(q, k, v),
                "bf16 strided views")
    before = ops.LAUNCHES["flash_attention"]
    wide = torch.randn(1, 64, 4, 72, generator=gen, device="cuda").to(bf16)
    try:
        ops.flash_attention(*([wide[..., 1:65]] * 3))
        refused = False
    except ValueError as e:
        refused = "aligned" in str(e)
    require(refused and ops.LAUNCHES["flash_attention"] == before,
            "a misaligned bf16 view is refused with ValueError, unlaunched")
    print(f"[flash] kernel within tolerance of ref.sdpa on {len(cases) + 1} "
          f"cases (the serving shape, ragged S, MQA, f32, non-causal, "
          f"window+softcap, Dh 32-256, S 1-65, Sq != Sk, strided views, "
          f"the reference's kernel tests); a misaligned view refused")

    B, S, H, K, Dh = 1, SERVE_PROMPT_LEN, 32, 8, 128
    q, k, v = inputs(B, S, H, K, Dh, bf16)
    out = ops.flash_attention(q, k, v)
    err = flash_close(torch, out, ref.sdpa(q, k, v), "main-path shape")
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v), reps=50)
    plain_ms = time_ms(torch, lambda: ref.sdpa(q, k, v), reps=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=50)
    flops = 2 * S * S * H * Dh                  # causal QK^T and PV
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    f_ms = flops / BF16_FLOP_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")
    print(f"[flash] {(B, S, H, K, Dh)} bf16 causal: {ms:.4f} ms = "
          f"{flops / ms / 1e9:.1f} TFLOP/s (bound {bound:.4f} ms by {by}, "
          f"plain {plain_ms:.3f} ms, F.scaled_dot_product_attention "
          f"{lib_ms:.4f} ms = {ms / lib_ms:.2f}x), max |err| {err:.3g}")
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}}


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

    def check_round(state, payloads, shipped, sync):
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
    require(launches == {"wan_encode": 2, "wan_decode": 4,
                         "flash_attention": 0, "ssd_scan": 0,
                         "topk_compress": 0},
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


def phase_control_loop(torch, device: str = "cuda", cfg=None,
                       seq: int = 512) -> dict:
    """Phase 3d: the launcher's control loop (``--events``, ``--wan-trace``,
    ``--adaptive-sync`` under ``--bucket-policy layer-class``) training
    granite-8b x2 layers at full width; every codec round held to its
    definition at the tiers it runs.  Returns the codec launches."""
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg = cfg or granite_8b.CONFIG.replace(n_layers=2)
    per_tier: dict = {}
    checked = []
    mark = {}

    def check_round(state, payloads, shipped, sync):
        """EF residual == flat - local; each bucket's kernel decode of the
        shipped payload == its plain decode, bit for bit, at the bucket's
        tier; the round's launches are one encode and two decodes per
        chunk.  The compare launches leave the counts as they were."""
        counts = dict(ops.LAUNCHES)
        enc = counts["wan_encode"] - mark["wan_encode"]
        dec = counts["wan_decode"] - mark["wan_decode"]
        require(torch.equal(state.sync_state.ef_residual,
                            payloads.flat - payloads.local),
                f"round {len(checked)}: EF residual == flat - local")
        layout = S.bucket_layout(sync, state.sync_state.ga_buffer)
        n_chunks = 0
        for g, name in enumerate(layout.names):
            size = layout.sizes[g]
            if not size:
                continue
            bcfg = sync.for_bucket(name)
            block = min(bcfg.codec_block, max(1, size))
            widths = S._chunk_widths(bcfg, size)
            kern = S._decode_bucket(bcfg, shipped[name], size)
            plain = S._cat([ops.wan_decode(
                c.q, c.idx.to(torch.int32), c.scales, m, block=block,
                value_dtype=bcfg.value_dtype, use_kernel=False)
                for c, m in zip(shipped[name], widths)])
            require(torch.equal(kern, plain),
                    f"round {len(checked)} {name} ({bcfg.value_dtype}@"
                    f"{bcfg.compress_topk}): peer decode kernel == plain")
            tier = per_tier.setdefault(bcfg.value_dtype,
                                       {"wan_encode": 0, "wan_decode": 0})
            tier["wan_encode"] += len(widths)
            tier["wan_decode"] += 2 * len(widths)
            n_chunks += len(widths)
        require(enc == n_chunks and dec == 2 * n_chunks,
                f"round {len(checked)}: {enc} encodes, {dec} decodes for "
                f"{n_chunks} chunks")
        ratios = (state.sync_state.resid_norm
                  / state.sync_state.msg_norm.clamp_min(1e-30)).amax(0)
        checked.append([round(float(r), 4) for r in ratios.cpu()])
        ops.LAUNCHES.update(counts)
        mark.update(counts)

    argv = ["--pods", str(PODS), "--steps", str(CONTROL_STEPS), "--batch",
            "8", "--seq", str(seq), "--interval", "2", "--compress-topk",
            "0.05", "--int8", "--error-feedback", "--bucket-policy",
            "layer-class", "--adaptive-sync", "--wan-trace", CONTROL_TRACE,
            "--ef-guard", str(CONTROL_EF_GUARD), "--events", CONTROL_EVENTS,
            "--log-every", "0", "--device", device]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mark.update(ops.LAUNCHES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train.main(argv, model_cfg=cfg, round_hook=check_round)
    launches = dict(ops.LAUNCHES)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else float("nan"))
    text = buf.getvalue()
    print("\n".join(line for line in text.splitlines()
                    if line.startswith(("[control-plane]", "[train]",
                                        "[autotune]", "[elasticity]"))))
    applied = [n for _, n, _ in summary["reconfigs_at"]]
    rounds = summary["rounds"]
    require(len(checked) == len(rounds) > 0,
            f"{len(checked)} of {len(rounds)} codec rounds checked")
    require(summary["retunes"] >= 2, f"{summary['retunes']} retunes")
    low = [r for r in rounds if "fp8" in r[1] or "int4" in r[1]]
    require(len(low) > 0, "a round ran at an fp8 or int4 rung")
    require(1 in applied and applied.index(1) < len(applied) - 1
            and applied[applied.index(1) + 1:].count(2) > 0
            and summary["final_pods"] == 2,
            f"pods 2 -> 1 -> 2 through applied reconfigs {applied}")
    require(math.isfinite(summary["loss_last"]), "finite loss")
    total = {k: sum(t[k] for t in per_tier.values())
             for k in ("wan_encode", "wan_decode")}
    require(launches == {"wan_encode": total["wan_encode"],
                         "wan_decode": total["wan_decode"],
                         "flash_attention": 0, "ssd_scan": 0,
                         "topk_compress": 0},
            f"control-loop launches {launches} == per-tier sums {total}")
    # a round's time by the knobs it ran at: the first round at new knobs
    # (after a retune or a reconfig) apart from the warm ones after it
    dec_steps = [d["step"] for d in summary["decisions"]]
    rc_steps = [s for s, _, _ in summary["reconfigs_at"]]
    first, warm, prev = [], {}, 0
    for i, (step, label, sec) in enumerate(rounds):
        if (i == 0 or label != rounds[i - 1][1]
                or any(prev < s <= step for s in dec_steps)
                or any(prev <= s < step for s in rc_steps)):
            first.append([step, label, round(sec, 4)])
        else:
            warm.setdefault(label, []).append(round(sec, 4))
        prev = step
    print(f"[control] {cfg.name} x{cfg.n_layers} layers, {PODS} pods, "
          f"batch 8, seq {seq}: {summary['retunes']} retunes, "
          f"{summary['reconfigs']} reconfigs applied (pods {applied}), "
          f"final pods {summary['final_pods']}, final tier "
          f"{summary['final_tier']}, max EF ratio {summary['max_ef_ratio']} "
          f"(per bucket {summary['max_ef_ratio_by_bucket']}, guard "
          f"{CONTROL_EF_GUARD})")
    for d in summary["decisions"]:
        print(f"[control] decision at step {d['step']}: {d['tiers']}, "
              f"interval {d['interval']}: {d['summary']}")
    print(f"[control] rounds (step, knobs, s): "
          f"{[[r[0], r[1], round(r[2], 4)] for r in rounds]}")
    print(f"[control] per-round worst-pod EF ratios by bucket: {checked}")
    print(f"[control] warm round s by knobs: "
          f"{warm}; first round at new knobs (retune or reconfig) {first}; "
          f"reconfig barriers (step, pods, s) "
          f"{[[a, b, round(t, 4)] for a, b, t in summary['reconfigs_at']]}"
          f"; launches by tier {per_tier}; peak memory {peak_gb:.2f} GB")
    return {k: launches[k] for k in ("wan_encode", "wan_decode")}


def phase_entry_point(torch) -> None:
    from repro_torch.launch import train

    summary = train.main(["--preset", "tiny", "--steps", "8", "--interval",
                          "4", "--compress-topk", "0.02", "--int8",
                          "--error-feedback", "--log-every", "4"])
    require(summary["device"] == "cuda", "launcher ran on the card")
    require(math.isfinite(summary["loss_last"]), "finite loss")


def topk_equal(torch, got, want, chunk: int, what: str) -> None:
    """Hold a top-k launch bit-equal to its plain version: vals (as bits,
    so -0.0 != +0.0), idx and the decompressed dense rows."""
    from repro_torch.kernels import ops

    (vk, ik), (vp, ip) = got, want
    bits = torch.int16 if vk.dtype == torch.bfloat16 else torch.int32
    require(vk.dtype == vp.dtype and vk.shape == vp.shape
            and torch.equal(ik, ip) and torch.equal(vk.view(bits),
                                                    vp.view(bits)),
            f"top-k {what}: vals and idx bit-equal to plain")
    dk = ops.topk_decompress(vk, ik, chunk)
    dp = ops.topk_decompress(vp, ip, chunk)
    require(torch.equal(dk.view(bits), dp.view(bits)),
            f"top-k {what}: decompressed dense bit-equal to plain")


def topk_bound(x_bytes: int, n_values: int, out_values: int,
               itemsize: int) -> tuple:
    """The least time of the top-k over inputs of ``x_bytes`` (read once)
    holding ``n_values`` values, writing ``out_values`` vals and int32 idx:
    the bytes over the memory rate, or one |x| compare per value at the f32
    rate, whichever is larger."""
    b_ms = (x_bytes + out_values * (itemsize + 4)) / HBM_BYTES_PER_S * 1e3
    f_ms = n_values / F32_FLOP_PER_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def granite_leaf_sizes(torch) -> list:
    """Per-pod values of each leaf of granite-8b at 2 layers."""
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.models import transformer

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    sizes = [x.numel() for x in T.leaves(params)]
    require(sum(sizes) == N_MAIN and len(sizes) == 12,
            f"granite leaves {sizes}")
    return sizes


def topk_adversarial(case: str, x):
    """``x`` ``(rows, n)`` (n a multiple of 1024 for ``tie_at_threshold``)
    made into an input that splits the top-k kernel's branches, in place:
    with large values every 16 positions two lanes of each 1024-value tile
    hold 64 of them, more than 32 keys above the lane-maxima bound, so
    every tile takes the general branch; every 32, one lane holds 32 (the
    general branch too); every 128, one lane holds 8 (the fast path)."""
    if case.startswith("stride"):
        x[:, ::int(case[6:])] *= 50
    elif case == "all_equal":
        x.fill_(0.75)
    elif case == "tie_at_threshold":
        # per tile five 3.0s and ten -2.0s in different lanes and register
        # slots: at k_block 10 the 10th key ties at 2.0, split across lanes
        x.clamp_(-0.9, 0.9)
        tiles = x.view(x.shape[0], -1, 1024)
        tiles[..., [33, 250, 511, 700, 1000]] = 3.0
        tiles[..., [7, 40, 100, 300, 301, 555, 703, 901, 1017, 1023]] = -2.0
    else:
        raise ValueError(case)
    return x


TOPK_ADVERSARIAL = ("stride16", "stride32", "stride128", "all_equal",
                    "tie_at_threshold")


def ship_args(n: int) -> tuple:
    """``(chunk, k)`` of a leaf of ``n`` values per pod, as ``_ship_ring``
    cuts it at top-k ``TOPK``."""
    from repro_torch.core.sync import CHUNK

    chunk = min(CHUNK, n)
    return chunk, max(1, int(chunk * TOPK))


def phase_topk(torch) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sizes = granite_leaf_sizes(torch)
    torch.cuda.empty_cache()

    def check(x, chunk, k, what):
        got = ops.topk_compress_chunked(x, chunk, k, block=TOPK_BLOCK)
        want = ops.topk_compress_chunked(x, chunk, k, block=TOPK_BLOCK,
                                         use_kernel=False)
        torch.cuda.synchronize()
        topk_equal(torch, got, want, chunk, what)

    for dtype in (torch.float32, torch.bfloat16):
        for n in sizes:
            x = torch.randn(PODS, n, generator=gen, device="cuda").to(dtype)
            check(x, *ship_args(n), f"leaf {n} {dtype}")
        base = torch.randn(3, 300_000, generator=gen, device="cuda")
        negz = torch.where(base > 0, -0.0, 0.0)
        negz[:, 5] = -0.25
        edge = [(torch.round(base * 2), 300_000, 3000, "ties"),
                (torch.zeros_like(base), 300_000, 3000, "zeros"),
                (negz, 300_000, 3000, "-0.0"),
                (base[:, :1027].clone(), 1027, 16, "pad wins (n 1027)"),
                (base, 5000, 3, "k // nb == 0"),
                (base[:, :8192].clone(), 8192, 81, "nb * k_block < k"),
                (base, 4096, 2048, "k_block 512"),
                (base[:, :300].clone(), 300, 20, "n < block")]
        edge += [(topk_adversarial(case, base[:, :299_008].clone()),
                  299_008, 2990, case) for case in TOPK_ADVERSARIAL]
        for x, chunk, k, what in edge:
            check(x.to(dtype), chunk, k, f"{what} {dtype}")
        print(f"[topk] {dtype}: kernel bit-equal to plain (vals, idx, "
              f"dense) on the 12 granite leaves as _ship_ring chunks them "
              f"and on {len(edge)} edge cases")
    del x, base, negz, edge
    torch.cuda.empty_cache()

    # the largest leaf (embed: 2 pods x 3 chunks of 2**26), f32 and bf16
    n = max(sizes)
    chunk, k = ship_args(n)
    k_block = max(1, k // (chunk // TOPK_BLOCK))
    x32 = torch.randn(PODS, n, generator=gen, device="cuda")
    rows = []
    for x in (x32, x32.bfloat16()):
        got = ops.topk_compress_chunked(x, chunk, k)
        err = float((got[0].float() - ref.topk_block_chunks(
            x, chunk, k, TOPK_BLOCK)[0].float()).abs().max())
        ms = time_ms(torch, lambda: ops.topk_compress_chunked(x, chunk, k),
                     reps=20)
        plain_ms = time_ms(torch, lambda: ops.topk_compress_chunked(
            x, chunk, k, use_kernel=False), reps=3, warm=1)
        lib_ms = time_ms(torch, lambda: torch.topk(
            x.abs().view(-1, TOPK_BLOCK), k_block, dim=1), reps=20)
        bound, by = topk_bound(x.numel() * x.element_size(), x.numel(),
                               got[0].numel(), x.element_size())
        rows.append((x.dtype, ms, plain_ms, lib_ms, bound, by, err))
        print(f"[topk] embed leaf {PODS} x {n} {x.dtype}, chunk {chunk}, "
              f"k {k}: {ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.2f} ms, nearest torch.topk per block "
              f"{lib_ms:.4f} ms: no tie order, magnitudes)")
    # the embed leaf with every tile on the general branch
    xg = topk_adversarial("stride16", x32)
    got = ops.topk_compress_chunked(xg, chunk, k)
    topk_equal(torch, got, ops.topk_compress_chunked(
        xg, chunk, k, use_kernel=False), chunk, "general branch, embed")
    general_ms = time_ms(torch, lambda: ops.topk_compress_chunked(
        xg, chunk, k), reps=10)
    print(f"[topk] embed leaf, large values every 16 positions (every tile "
          f"on the general branch), f32: {general_ms:.4f} ms")
    del x32, x, xg, got
    torch.cuda.empty_cache()

    # a whole round: the 12 leaves, one launch each
    round_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.randn(PODS, m, generator=gen, device="cuda").to(dtype)
              for m in sizes]
        args = [ship_args(m) for m in sizes]
        blocks = [min(TOPK_BLOCK, c) for c, _ in args]
        kbs = [max(1, k // -(-c // b)) for (c, k), b in zip(args, blocks)]

        def kernel_round():
            return [ops.topk_compress_chunked(x, c, k)
                    for x, (c, k) in zip(xs, args)]

        outs = kernel_round()
        ms = time_ms(torch, kernel_round, reps=10)
        plain_ms = time_ms(torch, lambda: [ops.topk_compress_chunked(
            x, c, k, use_kernel=False) for x, (c, k) in zip(xs, args)],
            reps=2, warm=1)
        lib_ms = time_ms(torch, lambda: [torch.topk(
            x.abs().view(-1, b), kb, dim=1)
            for x, b, kb in zip(xs, blocks, kbs)], reps=10)
        itemsize = xs[0].element_size()
        bound, by = topk_bound(sum(x.numel() for x in xs) * itemsize,
                               sum(x.numel() for x in xs),
                               sum(v.numel() for v, _ in outs), itemsize)
        round_rows[dtype] = (ms, plain_ms, lib_ms, bound, by)
        print(f"[topk] a round's 12 launches, {PODS} pods, {dtype}: "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {by}, plain "
              f"{plain_ms:.2f} ms, nearest torch.topk per block "
              f"{lib_ms:.4f} ms)")
        del xs, outs
        torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, bound, by = round_rows[torch.float32]
    return {"topk_compress": {
        "name": "topk_compress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
        "replaces": "src/repro/kernels/topk_compress.py:35",
        "max_abs_err": max(r[-1] for r in rows), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms,
        "library_call": "torch.topk(x.abs().view(-1, 1024), k_block) per "
                        "leaf: the nearest call, not the same function",
        "general_branch_ms": general_ms}}


def phase_strategies(torch) -> int:
    """Phase 3's setup under each sync strategy, every top-k launch held to
    the plain version, then sparse ``asgd_ga`` again unchecked (its rounds
    unfenced); returns the top-k launches of the checked sparse runs."""
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.core import sync as S
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import make_batches
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = granite_8b.CONFIG.replace(n_layers=2)
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0) for i in range(PODS))
    total, fenced_net = 0, {}
    runs = [(name, topk, True) for name, topk in STRATEGIES_3B]
    for strategy, topk, fenced in runs + [("asgd_ga", TOPK, False)]:
        sync = S.SyncConfig(strategy, 2, compress_topk=topk)
        plan = build_training_plan(TrainingRequest(
            model=cfg.name, clouds=clouds, sync=sync, n_iters=4,
            global_batch=8))
        batches = make_batches(plan, cfg.vocab_size, 512, "cuda")
        trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                          lambda g: transformer.init_params(g, cfg, "cuda"),
                          TrainerConfig(n_pods=PODS, optimizer="sgd",
                                        lr=0.02, sync=sync),
                          device="cuda")
        checked, check_s = [], {}

        def check_hook(x, vals, idx, *, chunk, k, block):
            """Hold each launch of the round to the plain version on the
            same input, outside the counts and the round's time (the
            round's queued work finishes before the clock starts)."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = dict(ops.LAUNCHES)
            want = ref.topk_block_chunks(x, chunk, k, block)
            topk_equal(torch, (vals, idx), want, chunk,
                       f"{strategy} launch {len(checked)}")
            checked.append(tuple(x.shape))
            ops.LAUNCHES.update(counts)
            torch.cuda.synchronize()
            r = len(trainer.sync_seconds)
            check_s[r] = check_s.get(r, 0.0) + time.perf_counter() - t0

        state = trainer.init_state(SEED)
        leaves = T.leaves(state.params)
        model_mb = sum(x.numel() * x.element_size()
                       for x in leaves) / PODS / 1e6
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.TOPK_CHECK_HOOK = check_hook if fenced else None
        ops.reset_launches()
        state, hist = trainer.fit(state, batches, 4, model_mb=model_mb)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        ops.TOPK_CHECK_HOOK = None
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expect = 12 * 2 if topk else 0
        require(launches == {"wan_encode": 0, "wan_decode": 0,
                             "flash_attention": 0, "ssd_scan": 0,
                             "topk_compress": expect},
                f"{strategy} launches {launches}")
        require(len(checked) == (expect if fenced else 0),
                f"{len(checked)} launches checked")
        losses = hist["loss_per_pod"]
        require(all(math.isfinite(v) for row in losses for v in row),
                f"{strategy}: finite losses {losses}")
        for leaf in T.leaves(state.params):
            require(bool(torch.isfinite(leaf).all()),
                    f"{strategy}: finite params")
        rounds = trainer.sync_seconds
        net = [t - check_s.get(i, 0.0) for i, t in enumerate(rounds)]
        require(len(rounds) == (0 if strategy == "asgd" else 2),
                f"{strategy}: {len(rounds)} sync rounds")
        frac = float(state.sync_state.significant_frac)
        steps = [round(t, 4) for t in trainer.step_seconds]
        if fenced:
            fenced_net[strategy] = [round(t, 4) for t in net]
            print(f"[strategies] {strategy}@2 top-k {topk}: losses {losses}; "
                  f"step s {steps}, sync-round s {fenced_net[strategy]} (net "
                  f"of the check's {[round(v, 4) for v in check_s.values()]}"
                  f"), peak memory {peak_gb:.2f} GB, launches {launches}"
                  + (f", significant_frac {frac:.4g}" if strategy == "asp"
                     else ""))
            total += launches["topk_compress"]
        else:
            print(f"[strategies] {strategy}@2 top-k {topk} unchecked: losses "
                  f"{losses}; step s {steps}, sync-round s "
                  f"{[round(t, 4) for t in rounds]} unfenced (checked and "
                  f"fenced: {fenced_net[strategy]}), launches {launches}")
        del trainer, state, leaves, batches
        torch.cuda.empty_cache()
    return total


def phase_paper_models(torch) -> None:
    from repro_torch import tree as T
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data.pipeline import GeoDataset, synthetic_classification
    from repro_torch.kernels import ops, ref
    from repro_torch.models.reference import PAPER_MODELS
    from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                              accuracy_eval,
                                              stack_pod_batches)

    runs = (("asgd", 1, 0.0), ("asgd_ga", 8, 0.0), ("ama", 8, 0.0),
            ("sma", 8, 0.0), ("ama", 8, TOPK))

    def check_hook(x, vals, idx, *, chunk, k, block):
        counts = dict(ops.LAUNCHES)
        topk_equal(torch, (vals, idx), ref.topk_block_chunks(
            x, chunk, k, block), chunk, f"paper model leaf {tuple(x.shape)}")
        ops.LAUNCHES.update(counts)

    for name in ("lenet", "resnet", "deepfm"):
        m = PAPER_MODELS[name]
        fv = 5400 if name == "deepfm" else None
        data = synthetic_classification(2000, m["input_shape"],
                                        m["n_classes"], seed=0,
                                        feature_vocab=fv)
        test = synthetic_classification(500, m["input_shape"],
                                        m["n_classes"], seed=1,
                                        feature_vocab=fv)
        geo = GeoDataset.partition(data, ["bj", "sh"], [1, 1])
        out, curves = {}, {}
        for strategy, interval, topk in runs:
            loaders = [geo.loader("bj", 32, seed=0),
                       geo.loader("sh", 32, seed=1)]
            trainer = Trainer(
                lambda p, b, m=m: (m["loss"](p, b), {}),
                lambda g, m=m: m["init"](g, "cuda"),
                TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                              sync=SyncConfig(strategy, interval,
                                              compress_topk=topk)),
                device="cuda")
            state = trainer.init_state(SEED)
            n_leaves = len(T.leaves(state.params))
            ops.TOPK_CHECK_HOOK = check_hook
            ops.reset_launches()
            state, hist = trainer.fit(
                state, lambda s: stack_pod_batches(
                    [next(ld) for ld in loaders], "cuda"), 16,
                eval_fn=accuracy_eval(m["apply"], test), eval_every=16)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            ops.TOPK_CHECK_HOOK = None
            expect = 2 * n_leaves if topk else 0
            require(launches == {"wan_encode": 0, "wan_decode": 0,
                                 "flash_attention": 0, "ssd_scan": 0,
                                 "topk_compress": expect},
                    f"{name} {strategy}@{interval} launches {launches}")
            require(all(math.isfinite(v) for v in hist["loss"]),
                    f"{name} {strategy}: finite losses")
            key = f"{strategy}@{interval}" + (f" top-k {topk}" if topk
                                              else "")
            curves[key] = hist["loss"]
            out[key] = {"loss_first": round(hist["loss"][0], 4),
                        "loss_last4": round(statistics.mean(
                            hist["loss"][-4:]), 4),
                        "acc": round(hist["eval"][-1][1], 4),
                        "step_s": round(statistics.median(
                            trainer.step_seconds), 5),
                        "topk_launches": launches["topk_compress"]}
        print(f"[paper] {name} ({n_leaves} leaves), 2 pods, batch 32, 16 "
              f"steps: {json.dumps(out)}")
        # at 2 pods the ring neighbour's copy is the other pod's, so ama's
        # (p + peer) / 2 is sma's mean: the two runs must agree step for
        # step (with cuDNN's deterministic algorithms, phase_device)
        gap = max(abs(x - y) for x, y in zip(curves["ama@8"],
                                              curves["sma@8"]))
        print(f"[paper] {name}: max |loss(ama@8) - loss(sma@8)| over 16 "
              f"steps {gap:.3g}")
        require(gap <= PAPER_AMA_SMA_TOL, f"{name}: ama@8 and sma@8 agree "
                f"within {PAPER_AMA_SMA_TOL} at 2 pods (gap {gap:.3g})")


def phase_entry_point_ama(torch) -> None:
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launches()
    summary = train.main(["--preset", "tiny", "--sync", "ama",
                          "--compress-topk", "0.02", "--interval", "4",
                          "--steps", "8", "--log-every", "4"])
    require(summary["device"] == "cuda", "launcher ran on the card")
    require(math.isfinite(summary["loss_last"]), "finite loss")
    require(ops.LAUNCHES["topk_compress"] > 0, "the sparse ama rounds "
            "launched the top-k kernel")


def phase_serving(torch) -> dict:
    from repro_torch import tree as T
    from repro_torch.configs import granite_8b
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import route_and_submit
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (ContinuousEngine,
                                            ContinuousScheduler)
    from repro_torch.serving.router import GeoRouter, ReplicaSpec

    cfg = granite_8b.CONFIG.replace(attention_impl="pallas")
    cache_len = SERVE_PROMPT_LEN + SERVE_NEW_TOKENS
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")

    def engine():
        return ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                                cache_len=cache_len, cfg=cfg,
                                module="transformer")

    # warm cuBLAS and the kernel's shared-memory attribute off the record
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    checked = []

    def check_hook(q, k, v, out, *, causal, window, softcap):
        """Hold each attention layer of the first prefill to ref.sdpa on the
        same q, k, v; the plain version launches no kernel of the port, and
        the counts are put back as they were all the same.  The hook takes
        itself off after the first prefill's last layer."""
        counts = dict(ops.LAUNCHES)
        expect = ref.sdpa(q, k, v, causal=causal, window=window,
                          softcap=softcap)
        checked.append(flash_close(torch, out, expect,
                                   f"prefill layer {len(checked)}"))
        ops.LAUNCHES.update(counts)
        if len(checked) == cfg.n_layers:
            ops.FLASH_CHECK_HOOK = None

    router = GeoRouter([ReplicaSpec(region=r, n_slots=SERVE_SLOTS)
                        for r in SERVE_REGIONS], mode="balanced")
    scheds = {r: ContinuousScheduler(engine()) for r in SERVE_REGIONS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.FLASH_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    placed = route_and_submit(router, scheds, SERVE_REGIONS, SERVE_REQUESTS,
                              SERVE_PROMPT_LEN, SERVE_NEW_TOKENS,
                              cfg.vocab_size, seed=0)
    by_region = {r: s.run() for r, s in scheds.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    launches = dict(ops.LAUNCHES)
    ops.FLASH_CHECK_HOOK = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    results = {}
    for rid, (region, local, _) in placed.items():
        results[rid] = by_region[region][local]
        router.complete(rid)

    engines = [s.engine for s in scheds.values()]
    prefill_s = [t for e in engines for t in e.prefill_seconds]
    prefill_s[0] -= check_s[0]    # the first prefill run held the check
    step_s = [t for e in engines for t in e.step_seconds]
    n_prefills = len(prefill_s)
    require(n_prefills == SERVE_REQUESTS, f"{n_prefills} prefills")
    require(all(len(t) == SERVE_NEW_TOKENS for t in results.values())
            and len(results) == SERVE_REQUESTS,
            f"every request finished with {SERVE_NEW_TOKENS} tokens")
    require(all(0 <= int(x) < cfg.vocab_size for t in results.values()
                for x in t), "tokens within the vocabulary")
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": cfg.n_layers * n_prefills,
                         "ssd_scan": 0, "topk_compress": 0},
            f"serving launches {launches}: {cfg.n_layers} flash launches "
            f"per prefill")
    require(len(checked) == cfg.n_layers,
            f"{len(checked)} prefill layers held to ref.sdpa")
    routes = {r: sum(1 for p in placed.values() if p[0] == r)
              for r in SERVE_REGIONS}

    # slot independence: request 0 went first into slot 0 of its replica
    # and its neighbours were inserted while it decoded; alone in a fresh
    # pool it must give the same tokens
    region0, local0, prompt0 = placed[0]
    hist = scheds[region0].history
    require(hist[0] == ("prefill", local0, 0), f"request 0 in slot 0: "
            f"{hist[0]}")
    done0 = hist.index(("finish", local0, "max_new"))
    require(any(h[0] == "prefill" for h in hist[1:done0]),
            "a neighbour was inserted while request 0 decoded")
    solo = engine()
    solo.insert(prompt0, SERVE_NEW_TOKENS, rid=0)
    alone = None
    while alone is None:
        for f in solo.step():
            alone = f.tokens
    require(solo.slots == [None] * SERVE_SLOTS, "solo pool drained")
    require(list(alone) == list(results[0]),
            "request 0 alone == request 0 beside inserted neighbours")

    total_new = sum(len(t) for t in results.values())
    print(f"[serve] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params, "
          f"{cfg.compute_dtype}, attention_impl=pallas; "
          f"{len(SERVE_REGIONS)} replicas x {SERVE_SLOTS} slots, cache_len "
          f"{cache_len}; routes {routes}")
    print(f"[serve] prompt lengths "
          f"{[len(p[2]) for _, p in sorted(placed.items())]}; every "
          f"request finished with {SERVE_NEW_TOKENS} tokens; launches "
          f"{launches}; first prefill's {len(checked)} layers within "
          f"{FLASH_TOL['torch.bfloat16']} of ref.sdpa (max |err| "
          f"{max(checked):.3g}); request 0 alone == beside neighbours")
    print(f"[serve] prefill s per request {[round(t, 4) for t in prefill_s]}"
          f" (median {statistics.median(prefill_s):.4f}; the first net of its check's {check_s[0]:.4f} s, left out of "
          f"tok/s too), median decode step {statistics.median(step_s):.4f} s over "
          f"{len(step_s)} pool steps, {total_new} tokens in {wall:.2f} s = "
          f"{total_new / wall:.1f} generated tok/s, peak memory "
          f"{peak_gb:.2f} GB")
    return launches


def phase_serve_entry_point(torch) -> None:
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(["--replicas", "2", "--requests", "6"])
    text = buf.getvalue()
    print(text, end="")
    summary, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    require(summary["device"] == "cuda", "serve launcher ran on the card")
    require(len(results) == 6 and sum(summary["routes"].values()) == 6,
            "6 requests served and routed")


def phase_gemma3_prefill(torch) -> dict:
    """Phase 5c: gemma3-12b at its published size, one prefill of a
    2048-token prompt through the flash kernel (48 launches: 40 windowed
    layers, 8 global) and 8 decode steps; layers 0 (window 1024) and 5
    (global) held to ``ref.sdpa`` on the same q, k, v."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import gemma3_12b
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ContinuousEngine

    cfg = gemma3_12b.CONFIG.replace(attention_impl="pallas")
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")
    weights_gb = sum(x.numel() * x.element_size()
                     for x in T.leaves(params)) / 1e9
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, 64, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    seen, checked = [0], {}

    def check_hook(q, k, v, out, *, causal, window, softcap):
        """Hold layers 0 and 5 of the prefill to ref.sdpa; the plain
        version launches no kernel of the port, and the counts are put
        back as they were all the same."""
        layer = seen[0]
        seen[0] += 1
        if layer in GEMMA_CHECKED_LAYERS:
            counts = dict(ops.LAUNCHES)
            expect = ref.sdpa(q, k, v, causal=causal, window=window,
                              softcap=softcap)
            checked[layer] = (window, flash_close(
                torch, out, expect, f"gemma3 prefill layer {layer}"))
            ops.LAUNCHES.update(counts)

    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, SERVE_PROMPT_LEN).astype(np.int32)
    engine = ContinuousEngine(None, params, n_slots=1,
                              cache_len=SERVE_PROMPT_LEN + GEMMA_NEW_TOKENS,
                              cfg=cfg, module="transformer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.FLASH_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    engine.insert(prompt, GEMMA_NEW_TOKENS, rid=0)
    ops.FLASH_CHECK_HOOK = None
    tokens = None
    while tokens is None:
        for f in engine.step():
            tokens = f.tokens
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": cfg.n_layers, "ssd_scan": 0,
                         "topk_compress": 0},
            f"gemma3 launches {launches}: {cfg.n_layers} flash launches "
            f"in one prefill")
    require(sorted(checked) == list(GEMMA_CHECKED_LAYERS)
            and checked[0][0] == 1024 and checked[5][0] is None,
            f"layers 0 (window 1024) and 5 (global) checked: {checked}")
    require(len(tokens) == GEMMA_NEW_TOKENS
            and all(0 <= int(t) < cfg.vocab_size for t in tokens),
            f"{len(tokens)} tokens within the vocabulary")
    prefill_s = engine.prefill_seconds[0] - check_s[0]
    step_s = statistics.median(engine.step_seconds)

    # the flash kernel's share of the prefill: its time at the prefill's
    # two layer shapes, as many times as the prefill launches each
    q, k, v = (torch.randn(1, SERVE_PROMPT_LEN, n, cfg.resolved_head_dim,
                           device="cuda", dtype=torch.bfloat16)
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    windows = [s.window for s in cfg.pattern] * cfg.n_groups
    ms = {w: time_ms(torch, lambda w=w: ops.flash_attention(
        q, k, v, window=w), reps=20) for w in set(windows)}
    flash_ms = sum(ms[w] for w in windows)
    print(f"[gemma3] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params "
          f"({weights_gb:.2f} GB bf16), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, window 1024 on "
          f"{windows.count(1024)} layers; prompt {SERVE_PROMPT_LEN} tokens, "
          f"{GEMMA_NEW_TOKENS} new: launches {launches}; layers 0 and 5 "
          f"within {FLASH_TOL['torch.bfloat16']} + "
          f"{FLASH_TOL['torch.bfloat16']}|ref| of ref.sdpa (max |err| "
          f"{ {l: round(e, 5) for l, (_, e) in checked.items()} })")
    print(f"[gemma3] prefill {prefill_s:.4f} s (net of its check's "
          f"{check_s[0]:.4f} s), median decode step {step_s:.4f} s over "
          f"{len(engine.step_seconds)} steps; flash at the prefill's shapes "
          f"{ {str(w): round(t, 4) for w, t in ms.items()} } ms a launch, "
          f"{flash_ms:.3f} ms a prefill = "
          f"{flash_ms / (prefill_s * 1e3):.1%} of it; peak memory "
          f"{peak_gb:.2f} GB")
    del params, engine, q, k, v
    return launches


def ssd_close(torch, y, final, y_ref, f_ref, what: str) -> tuple:
    """Hold an SSD output to its plain version at the reference's
    tolerance; returns the largest |diff| of y, absolute and over max|y|."""
    scale = float(y_ref.float().abs().max()) or 1.0
    y_abs = float((y.float() - y_ref.float()).abs().max())
    y_err = y_abs / scale
    s_err = float((final - f_ref).abs().max())
    require(y_err <= SSD_Y_TOL and s_err <= SSD_STATE_TOL
            and bool(torch.isfinite(y).all()),
            f"ssd {what} within {SSD_Y_TOL} (y / max|y|) and "
            f"{SSD_STATE_TOL} (state) of ref.ssd (got {y_err:.3g}, "
            f"{s_err:.3g})")
    return y_abs, y_err


def ssd_f64(torch, x, a, Bm, Cm, chunk, init_state):
    """The chunked SSD of ``ref.ssd`` evaluated in float64: the yardstick
    that the kernel and the plain f32 version are both measured against on
    a real prefill's inputs."""
    f64 = torch.float64
    Bsz, S, H, P = x.shape
    N, L = Bm.shape[-1], min(chunk, S)
    nc = S // L
    xc = x.reshape(Bsz, nc, L, H, P).to(f64)
    Bc = Bm.reshape(Bsz, nc, L, H, N).to(f64)
    Cc = Cm.reshape(Bsz, nc, L, H, N).to(f64)
    a_cum = torch.cumsum(a.reshape(Bsz, nc, L, H).to(f64).movedim(-1, -2),
                         dim=-1)                          # (B, nc, H, L)
    seg = a_cum[..., :, None] - a_cum[..., None, :]
    tril = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tril, seg, -torch.inf).exp()
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Lmat
    y = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    w = (a_cum[..., -1:] - a_cum).exp()
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, w, xc)
    st = (torch.zeros(Bsz, H, P, N, dtype=f64, device=x.device)
          if init_state is None else init_state.to(f64))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * a_cum[:, c, :, -1, None, None].exp() + states[:, c]
    y = y + torch.einsum("bclhn,bchpn,bchl->bclhp", Cc,
                         torch.stack(prev, 1), a_cum.exp())
    return y.reshape(Bsz, S, H, P), st


def ssd_serving_close(torch, x, a, Bm, Cm, y, final, chunk, init_state,
                      what: str) -> dict:
    """Hold a real prefill's SSD to the plain f32 version within
    SERVE_SSD_TOL (y / max|y|, state / max|state|) and to the f64
    evaluation within the reference's SSD_Y_TOL.  At the model's real
    decays (``max_abs_a``, up to a few hundred per step in the fast heads)
    the f32 plain version is itself ~1e-4
    from exact, mostly from rounding the f32 log-decay prefix, which the
    kernel keeps in f64; so the reference's tolerance is held against the
    f64 yardstick, and the looser one against the plain version."""
    from repro_torch.kernels import ref

    y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=init_state)
    y64, f64 = ssd_f64(torch, x, a, Bm, Cm, chunk, init_state)
    ys, fs = float(y64.abs().max()) or 1.0, float(f64.abs().max()) or 1.0

    def err(t, ref_t, scale):
        return float((t.double() - ref_t.double()).abs().max()) / scale

    e = {"y_vs_plain": err(y, y_ref, ys), "state_vs_plain": err(final, f_ref,
                                                                 fs),
         "y_vs_f64": err(y, y64, ys), "state_vs_f64": err(final, f64, fs),
         "plain_y_vs_f64": err(y_ref, y64, ys),
         "plain_state_vs_f64": err(f_ref, f64, fs),
         "max_abs_a": float(a.abs().max())}
    require(bool(torch.isfinite(y).all())
            and e["y_vs_plain"] <= SERVE_SSD_TOL
            and e["state_vs_plain"] <= SERVE_SSD_TOL
            and e["y_vs_f64"] <= SSD_Y_TOL and e["state_vs_f64"] <= SSD_Y_TOL,
            f"ssd {what} within {SERVE_SSD_TOL} of ref.ssd and {SSD_Y_TOL} "
            f"of the f64 SSD: {e}")
    return e


def ssd_flops(B, S, H, P, N, L) -> tuple:
    """The causal products of one SSD call: (C B^T over the L(L+1)/2 pairs
    of each chunk, the masked scores times x, and the two products that
    take B or C as one operand: the local state x^T (B w) and the
    carried-state term C state^T)."""
    blocks = B * H * (S // L)
    pairs = L * (L + 1) // 2
    return (blocks * 2 * pairs * N, blocks * 2 * pairs * P,
            blocks * 4 * L * N * P)


def ssd_bound(B, S, H, P, N, L, nbytes, bc_bf16: bool):
    """The least time for one SSD call: the causal products' FLOPs, each
    over the peak rate of the tensor-core arithmetic that keeps the spec's
    f32 accuracy, or the bytes over the memory rate, whichever is larger.
    C B^T with bf16 B and C runs at the bf16 rate (a product of two bf16
    values is exact in f32).  A product with an f32 operand runs as 3xTF32,
    hi*hi + hi*lo + lo*hi: three TF32 products where both operands are f32
    (the scores times x; every product when B and C are f32), two where the
    other is bf16, which is exact in TF32 and has no lo part (the local and
    carried-state products with bf16 B and C)."""
    cb, sx, state = ssd_flops(B, S, H, P, N, L)
    if bc_bf16:
        f_ms = (cb / BF16_FLOP_PER_S
                + (3 * sx + 2 * state) / TF32_FLOP_PER_S) * 1e3
    else:
        f_ms = 3 * (cb + sx + state) / TF32_FLOP_PER_S * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def phase_ssd(torch) -> dict:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, H, P, N, bc_dtype=torch.float32, init=False,
               expand=False):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        x = randn(B, S, H, P)
        a = -randn(B, S, H).abs() * 0.1
        if expand:
            Bm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
            Cm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
        else:
            Bm = randn(B, S, H, N).to(bc_dtype)
            Cm = randn(B, S, H, N).to(bc_dtype)
        return x, a, Bm, Cm, (randn(B, H, P, N) if init else None)

    def check(B, S, H, P, N, chunk, **kw):
        x, a, Bm, Cm, s0 = inputs(B, S, H, P, N, **kw)
        y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=chunk, init_state=s0)
        y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=s0)
        torch.cuda.synchronize()
        return ssd_close(torch, y, f, y_ref, f_ref,
                         f"{(B, S, H, P, N, chunk)} {kw}")

    bf16 = torch.bfloat16
    main = (1, SERVE_PROMPT_LEN, 64, 64, 128, MAMBA_CHUNK)
    cases = [((2, 128, 4, 16, 32, 32), {}),       # the reference's tests
             ((1, 256, 2, 64, 128, 64), {}),
             ((2, 64, 8, 8, 16, 64), {}),
             ((1, 256, 8, 64, 128, 256), {}),     # S == chunk
             ((2, 100, 8, 64, 128, 256), {}),     # S < chunk
             ((2, 512, 4, 64, 128, 256), {"init": True}),
             ((1, 512, 8, 64, 128, 256), {"bc_dtype": bf16}),
             ((1, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "expand": True}),
             (main, {"bc_dtype": bf16, "expand": True})]
    # chunks 64, 128 and 256 (f32 and bf16 B/C), 16 chunks, the scoring
    # shape (B 2), init_state with bf16 and stride-0 B/C
    cases += [((1, 1024, 8, 64, 128, c), {"bc_dtype": d, "expand": True,
                                          "init": True})
              for c in (64, 128, 256) for d in (torch.float32, bf16)]
    cases += [((1, 4096, 16, 64, 128, 256), {"bc_dtype": bf16,
                                              "expand": True}),
              ((MAMBA_SCORE_BATCH,) + main[1:], {"bc_dtype": bf16,
                                                  "expand": True}),
              ((2, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "init": True}),
              ((2, 512, 8, 64, 128, 256), {"bc_dtype": bf16, "init": True,
                                           "expand": True}),
              ((2, 192, 3, 80, 100, 96), {"bc_dtype": bf16, "init": True})]
    errs = [check(*shape, **kw)[1] for shape, kw in cases]
    print(f"[ssd] kernel within {SSD_Y_TOL} (y / max|y|) and "
          f"{SSD_STATE_TOL} (state) of ref.ssd on {len(cases)} cases (the "
          f"reference's kernel tests, S == chunk, S < chunk, init_state, "
          f"f32 and bf16 B/C, stride-0 B/C, chunks 64-256, 16 chunks, "
          f"ragged P-tiles, the serving prefill's and the scoring "
          f"forward's shapes); max y "
          f"err {max(errs):.3g}")

    B, S, H, P, N, L = main
    x, a, Bm, Cm, _ = inputs(B, S, H, P, N, bc_dtype=bf16, expand=True)
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=L)
    abs_err, err = ssd_close(torch, y, f, *ref.ssd(x, a, Bm, Cm, chunk=L),
                             "main-path shape")
    ms = time_ms(torch, lambda: ops.ssd_scan(x, a, Bm, Cm, chunk=L),
                 reps=20)
    plain_ms = time_ms(torch, lambda: ref.ssd(x, a, Bm, Cm, chunk=L),
                       reps=5)
    # inputs read once (B and C as their stride-0 storage), outputs once
    nbytes = (x.numel() * 4 + a.numel() * 4 + 2 * B * S * N * 2
              + y.numel() * 4 + f.numel() * 4)
    bound, by = ssd_bound(B, S, H, P, N, L, nbytes,
                          bc_bf16=Bm.dtype == torch.bfloat16)
    flops = sum(ssd_flops(B, S, H, P, N, L))
    print(f"[ssd] {(B, S, H, P, N)} chunk {L}, x/a f32, B/C bf16 stride-0: "
          f"{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s (bound {bound:.4f} "
          f"ms by {by}, the f32-operand products priced as 3xTF32; plain "
          f"{plain_ms:.3f} ms, no single PyTorch call), max |y err| "
          f"{abs_err:.3g} ({err:.3g} of max|y|)")
    return {"ssd_scan": {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:32",
        "max_abs_err": abs_err, "max_rel_err": err, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None}}


def mamba_requests(regions, vocab_size: int):
    """Phase 5's draws (the serving launcher's, numpy seed 0, prompt-len
    2048), each prompt cut to a multiple of the SSD chunk."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(SERVE_REQUESTS):
        plen = int(rng.integers(SERVE_PROMPT_LEN // 2, SERVE_PROMPT_LEN + 1))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        src = regions[int(rng.integers(len(regions)))]
        out.append((prompt, prompt[: plen // MAMBA_CHUNK * MAMBA_CHUNK], src))
    return out


def phase_mamba_serving(torch):
    from repro_torch import tree as T
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving.engine import (ContinuousEngine,
                                            ContinuousScheduler)
    from repro_torch.serving.router import GeoRouter, ReplicaSpec

    cfg = mamba2_1_3b.CONFIG
    cache_len = SERVE_PROMPT_LEN + SERVE_NEW_TOKENS
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    n_params = sum(x.numel() for x in T.leaves(params))
    require(n_params == cfg.param_count(), f"{n_params} params")

    def engine():
        return ContinuousEngine(None, params, n_slots=SERVE_SLOTS,
                                cache_len=cache_len, cfg=cfg,
                                module="transformer")

    # warm cuBLAS and the kernel's shared-memory attribute off the record
    with torch.no_grad():
        transformer.prefill(params, cfg, torch.zeros(
            1, MAMBA_CHUNK, dtype=torch.int32, device="cuda"), 96)
    torch.cuda.synchronize()

    checked = []

    def check_hook(x, a, Bm, Cm, y, final, *, chunk, init_state):
        """Hold each SSM layer of the first prefill to ref.ssd on the same
        inputs; the plain version launches no kernel of the port, and the
        counts are put back as they were all the same.  The hook takes
        itself off after the first prefill's last layer."""
        counts = dict(ops.LAUNCHES)
        checked.append(ssd_serving_close(
            torch, x, a, Bm, Cm, y, final, chunk, init_state,
            f"prefill layer {len(checked)}"))
        ops.LAUNCHES.update(counts)
        if len(checked) == cfg.n_layers:
            ops.SSD_CHECK_HOOK = None

    router = GeoRouter([ReplicaSpec(region=r, n_slots=SERVE_SLOTS)
                        for r in SERVE_REGIONS], mode="balanced")
    scheds = {r: ContinuousScheduler(engine()) for r in SERVE_REGIONS}
    requests = mamba_requests(SERVE_REGIONS, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check_s = [0.0]
    ops.SSD_CHECK_HOOK = clocked(torch, check_hook, check_s)
    ops.reset_launches()
    t0 = time.perf_counter()
    placed = {}
    for rid, (_, prompt, src) in enumerate(requests):
        region = router.route(rid, src, prompt.size, SERVE_NEW_TOKENS)
        placed[rid] = (region, scheds[region].submit(prompt,
                                                     SERVE_NEW_TOKENS),
                       prompt)
    by_region = {r: s.run() for r, s in scheds.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    launches = dict(ops.LAUNCHES)
    ops.SSD_CHECK_HOOK = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    results = {}
    for rid, (region, local, _) in placed.items():
        results[rid] = by_region[region][local]
        router.complete(rid)

    engines = [s.engine for s in scheds.values()]
    prefill_s = [t for e in engines for t in e.prefill_seconds]
    prefill_s[0] -= check_s[0]    # the first prefill run held the check
    step_s = [t for e in engines for t in e.step_seconds]
    n_prefills = len(prefill_s)
    require(n_prefills == SERVE_REQUESTS, f"{n_prefills} prefills")
    require(all(len(t) == SERVE_NEW_TOKENS for t in results.values())
            and len(results) == SERVE_REQUESTS,
            f"every request finished with {SERVE_NEW_TOKENS} tokens")
    require(all(0 <= int(x) < cfg.vocab_size for t in results.values()
                for x in t), "tokens within the vocabulary")
    require(launches == {"wan_encode": 0, "wan_decode": 0,
                         "flash_attention": 0,
                         "ssd_scan": cfg.n_layers * n_prefills,
                         "topk_compress": 0},
            f"mamba serving launches {launches}: {cfg.n_layers} SSD "
            f"launches per prefill")
    require(len(checked) == cfg.n_layers,
            f"{len(checked)} prefill layers held to ref.ssd")
    routes = {r: sum(1 for p in placed.values() if p[0] == r)
              for r in SERVE_REGIONS}

    # slot independence, as in phase 5
    region0, local0, prompt0 = placed[0]
    hist = scheds[region0].history
    require(hist[0] == ("prefill", local0, 0), f"request 0 in slot 0: "
            f"{hist[0]}")
    done0 = hist.index(("finish", local0, "max_new"))
    require(any(h[0] == "prefill" for h in hist[1:done0]),
            "a neighbour was inserted while request 0 decoded")
    solo = engine()
    solo.insert(prompt0, SERVE_NEW_TOKENS, rid=0)
    alone = None
    while alone is None:
        for f in solo.step():
            alone = f.tokens
    require(list(alone) == list(results[0]),
            "request 0 alone == request 0 beside inserted neighbours")

    # the reference refuses a prompt above the chunk that is not a
    # multiple of it (ssd_chunked's assert); so does the engine
    uncut = requests[0][0]
    require(uncut.size == 1895, f"uncut prompt 0 has {uncut.size} tokens")
    try:
        solo.insert(uncut, SERVE_NEW_TOKENS, rid=1)
        refused = False
    except ValueError as e:
        refused = "multiple of the chunk" in str(e)
    require(refused and solo.free_slots == list(range(SERVE_SLOTS)),
            "the engine refuses a 1895-token prompt and keeps its slots")

    total_new = sum(len(t) for t in results.values())
    print(f"[mamba] {cfg.name} x{cfg.n_layers} layers, {n_params:,} params, "
          f"{cfg.compute_dtype}; {len(SERVE_REGIONS)} replicas x "
          f"{SERVE_SLOTS} slots, cache_len {cache_len}; routes {routes}")
    worst = {k: max(e[k] for e in checked) for k in checked[0]}
    print(f"[mamba] first prefill's largest |a| (log decay per step): "
          f"{worst.pop('max_abs_a'):.4g}")
    print(f"[mamba] prompt lengths "
          f"{[len(p[2]) for _, p in sorted(placed.items())]}; every "
          f"request finished with {SERVE_NEW_TOKENS} tokens; launches "
          f"{launches}; request 0 alone == beside neighbours; a "
          f"{uncut.size}-token prompt refused")
    print(f"[mamba] first prefill's {len(checked)} SSM layers: kernel "
          f"within {SERVE_SSD_TOL} of ref.ssd and {SSD_Y_TOL} of the f64 "
          f"SSD; worst over layers (of max|y|, max|state|): "
          f"{json.dumps(worst)}")
    print(f"[mamba] prefill s per request {[round(t, 4) for t in prefill_s]}"
          f" (median {statistics.median(prefill_s):.4f}; the first net of its check's {check_s[0]:.4f} s, left out of "
          f"tok/s too), median decode step {statistics.median(step_s):.4f} s over "
          f"{len(step_s)} pool steps, {total_new} tokens in {wall:.2f} s = "
          f"{total_new / wall:.1f} generated tok/s, peak memory "
          f"{peak_gb:.2f} GB")
    return launches, params


def phase_mamba_scoring(torch, params) -> int:
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = mamba2_1_3b.CONFIG
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (MAMBA_SCORE_BATCH,
                                               SERVE_PROMPT_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, _ = transformer.forward(params, cfg, tokens,
                                        use_ssm_kernel=True)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        launches = ops.LAUNCHES["ssd_scan"]
        t0 = time.perf_counter()
        plain, _ = transformer.forward(params, cfg, tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    require(launches == cfg.n_layers,
            f"{launches} SSD launches in the scoring forward")
    V = cfg.vocab_size
    logits, plain = logits[..., :V], plain[..., :V]
    require(bool(torch.isfinite(logits).all()), "finite logits")
    scale = float(plain.abs().max())
    err = float((logits - plain).abs().max()) / scale
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[score] {cfg.name} forward B {MAMBA_SCORE_BATCH} S "
          f"{SERVE_PROMPT_LEN}: {launches} SSD launches; {kern_s:.4f} s "
          f"through the kernel, {plain_s:.4f} s through the plain SSD; "
          f"max |logit diff| / max|logit| {err:.3g}, argmax agreement "
          f"{agree:.4f}")
    require(err <= MAMBA_LOGIT_TOL, f"scoring logits within "
            f"{MAMBA_LOGIT_TOL} of the plain SSD's (got {err:.3g})")
    return launches


def phase_mamba_entry_point(torch) -> None:
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = serve.main(["--arch", "mamba2-1.3b", "--replicas", "2",
                              "--requests", "6"])
    text = buf.getvalue()
    print(text, end="")
    summary, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    require(summary["device"] == "cuda" and summary["arch"] == "mamba2-1.3b",
            "mamba serve launcher ran on the card")
    require(len(results) == 6 and sum(summary["routes"].values()) == 6,
            "6 mamba requests served and routed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    device = phase_device(torch)
    kernels = phase_kernels(torch)
    kernels.update(phase_flash(torch))
    kernels.update(phase_ssd(torch))
    torch.cuda.empty_cache()
    kernels.update(phase_topk(torch))
    torch.cuda.empty_cache()
    train_launches = phase_main_path(torch)
    torch.cuda.empty_cache()
    control_launches = phase_control_loop(torch)
    torch.cuda.empty_cache()
    topk_launches = phase_strategies(torch)
    phase_paper_models(torch)
    phase_entry_point(torch)
    phase_entry_point_ama(torch)
    torch.cuda.empty_cache()
    serve_launches = phase_serving(torch)
    torch.cuda.empty_cache()
    phase_serve_entry_point(torch)
    gemma_launches = phase_gemma3_prefill(torch)
    torch.cuda.empty_cache()
    mamba_launches, params = phase_mamba_serving(torch)
    phase_mamba_scoring(torch, params)
    del params
    torch.cuda.empty_cache()
    phase_mamba_entry_point(torch)
    for name in ("wan_encode", "wan_decode"):
        kernels[name]["launches"] = (train_launches[name]
                                     + control_launches[name])
    kernels["flash_attention"]["launches"] = (
        serve_launches["flash_attention"]
        + gemma_launches["flash_attention"])
    kernels["ssd_scan"]["launches"] = mamba_launches["ssd_scan"]
    kernels["topk_compress"]["launches"] = topk_launches
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
