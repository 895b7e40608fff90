"""End-to-end geo-distributed training driver of the port.

Counterpart of ``repro/launch/train.py`` for the training plane's main path:

1. **Control plane**: a ``TrainingRequest`` goes through the scheduler
   function (Algorithm 1), PS registration and the global communicator.
2. **Data plane**: per-pod synthetic token shards.
3. **Physical training plane**: the per-pod step with the selected sync
   strategy (``asgd``, ``asgd_ga``, ``ama``, ``sma``, ``asp``), sync rounds
   every ``--interval`` steps; on the codec path through the CUDA codec
   kernels on the card, and with ``--compress-topk F`` without ``--int8``
   through the CUDA top-k kernel (sparse fp32 or bf16 shipping).

The flags keep the reference's meanings and defaults; ``--device`` picks
the card (default) or the CPU.  The reference's elasticity, adaptive-sync,
transport, fault, topology, checkpoint and serving flags are not ported yet
(ROADMAP.md Queue 1 items 10-15).

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --steps 8 --interval 4 --compress-topk 0.02 --int8 --error-feedback
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --steps 8 --interval 4 --sync ama --compress-topk 0.02
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import dense
from repro_torch.core.control_plane import (TrainingRequest,
                                            build_training_plan)
from repro_torch.core.scheduler import CloudResources
from repro_torch.core.sync import VALUE_DTYPES, SyncConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.registry import get_model_fns
from repro_torch.training.trainer import Trainer, TrainerConfig


def preset_100m():
    """~100M-parameter dense decoder for the end-to-end driver."""
    return dense("dense-100m", n_layers=8, d_model=768, n_heads=12,
                 n_kv_heads=4, d_ff=3072, vocab=32_000, tie_embeddings=True,
                 vocab_multiple=128, param_dtype="float32",
                 compute_dtype="float32", remat="none")


def preset_tiny():
    """~1M-parameter decoder for fast system tests."""
    return dense("dense-tiny", n_layers=2, d_model=128, n_heads=4,
                 n_kv_heads=2, d_ff=512, vocab=512, tie_embeddings=True,
                 vocab_multiple=64, param_dtype="float32",
                 compute_dtype="float32", remat="none")


def make_batches(plan, vocab_size: int, seq: int, device):
    """Per-pod stacked batch closure: one token shard per pod, padding rows
    of trimmed pods masked out (the elastic batch split)."""
    n_pods = len(plan.resource_plans)
    per_pod = max(plan.batch_split)
    streams = [TokenStream(vocab_size=vocab_size, seq_len=seq,
                           batch_size=per_pod, seed=7, shard=i,
                           n_shards=n_pods) for i in range(n_pods)]
    mask = np.zeros((n_pods, per_pod, seq), np.float32)
    for i, b in enumerate(plan.batch_split):
        mask[i, :b] = 1.0

    def batches(step: int) -> Dict[str, torch.Tensor]:
        parts = [s.batch(step) for s in streams]
        stacked = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        stacked["mask"] = mask
        return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}

    return batches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--preset", choices=["100m", "tiny"],
                    help="built-in config instead of --arch")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync", default="asgd_ga",
                    choices=["asgd", "asgd_ga", "ama", "sma", "asp"])
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--compress-topk", type=float, default=0.0,
                    help="ship only this fraction of the synced entries "
                         "(top-k per block; 0 = dense)")
    ap.add_argument("--int8", action="store_true",
                    help="fused WAN codec: block-local top-k + quantized "
                         "payload (with --compress-topk; --value-dtype "
                         "picks the tier)")
    ap.add_argument("--value-dtype", default="int8", choices=VALUE_DTYPES,
                    help="codec payload tier: int8 (1 B), fp8 e4m3 (1 B, "
                         "relative rounding), int4 (0.5 B nibble-packed)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="EF-SGD: re-inject what the codec dropped at the "
                         "next sync (with --int8)")
    ap.add_argument("--overlap-chunks", type=int, default=1,
                    help=">1: split each bucket into this many chunks")
    ap.add_argument("--codec-block", type=int, default=4096)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the codec run")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")

    # ----------------------------------------------------------- model
    if args.preset or (not args.arch):
        cfg = preset_tiny() if args.preset == "tiny" else preset_100m()
        module = "transformer"
    else:
        arch = get_arch(args.arch)
        cfg = arch.smoke if args.smoke else arch.config
        module = arch.module
    name = cfg.name
    fns = get_model_fns(module)

    # ----------------------------------------------------- control plane
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=1.0)
                   for i in range(args.pods))
    sync_cfg = SyncConfig(args.sync, args.interval,
                          compress_topk=args.compress_topk,
                          quantize_int8=args.int8,
                          value_dtype=args.value_dtype,
                          error_feedback=args.error_feedback,
                          codec_block=args.codec_block,
                          overlap_chunks=args.overlap_chunks)
    request = TrainingRequest(model=name, clouds=clouds, sync=sync_cfg,
                              n_iters=args.steps, global_batch=args.batch)
    plan = build_training_plan(request)
    print(f"[control-plane] ring topology: {plan.topology}")
    print(f"[control-plane] PS identities: {plan.ps_identities}")
    print(f"[control-plane] batch split:   {plan.batch_split}")
    batches = make_batches(plan, cfg.vocab_size, args.seq, device)

    # ---------------------------------------------------------- trainer
    tcfg = TrainerConfig(n_pods=args.pods, optimizer=args.optimizer,
                         lr=args.lr, sync=sync_cfg)
    trainer = Trainer(lambda p, b: fns.loss_fn(p, cfg, b),
                      lambda g: fns.init_params(g, cfg, device), tcfg,
                      device=device)
    state = trainer.init_state(0)
    leaves = T.leaves(state.params)
    n_params = sum(x.numel() for x in leaves) // args.pods
    model_mb = sum(x.numel() * x.element_size()
                   for x in leaves) / args.pods / 1e6
    print(f"[train] {name}: {n_params:,} params/pod ({model_mb:.1f} MB), "
          f"{args.pods} pods, sync={args.sync}@{args.interval}, "
          f"device {device}")
    if sync_cfg.uses_codec:
        payload = sync_cfg.payload_mb(model_mb)
        print(f"[train] wan codec: top-k {sync_cfg.compress_topk} + "
              f"{sync_cfg.value_dtype}, block {sync_cfg.codec_block}, "
              f"ef={'on' if sync_cfg.error_feedback else 'off'}, "
              f"chunks {sync_cfg.overlap_chunks}, payload "
              f"{payload:.2f} MB/sync "
              f"({model_mb / max(payload, 1e-9):.0f}x below dense)")

    # ------------------------------------------------------------- loop
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        state, metrics = trainer.train_step(state, batches(step))
        state = trainer.maybe_sync(state, step, model_mb)
        losses.append(float(metrics["loss"]))
        if args.log_every and (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                  f"({dt / (step + 1):.2f} s/step)  "
                  f"wan-traffic {trainer.traffic_mb:.1f} MB")

    summary = {
        "model": name, "pods": args.pods, "sync": args.sync,
        "interval": args.interval, "steps": args.steps,
        "compress_topk": args.compress_topk, "int8": args.int8,
        "value_dtype": args.value_dtype,
        "error_feedback": args.error_feedback,
        "overlap_chunks": args.overlap_chunks,
        "codec_block": args.codec_block,
        "loss_first": losses[0], "loss_last": float(np.mean(losses[-5:])),
        "wan_traffic_mb": trainer.traffic_mb,
        "final_pods": trainer.cfg.n_pods,
        "final_interval": trainer.cfg.sync.interval,
        "final_tier": trainer.cfg.sync.tier,
        "device": str(device),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
