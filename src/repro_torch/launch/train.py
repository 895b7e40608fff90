"""End-to-end geo-distributed training driver of the port.

Counterpart of ``repro/launch/train.py``:

1. **Control plane**: a ``TrainingRequest`` goes through the scheduler
   function (Algorithm 1), PS registration and the global communicator.
2. **Data plane**: per-pod synthetic token shards (uneven distribution
   with ``--data-ratio``; padding rows of trimmed pods masked out).
3. **Physical training plane**: the per-pod step with the selected sync
   strategy (``asgd``, ``asgd_ga``, ``ama``, ``sma``, ``asp``), sync rounds
   every ``--interval`` steps; on the codec path through the CUDA codec
   kernels on the card (``--bucket-policy layer-class``: one encode per
   bucket group, each at its own tier), and with ``--compress-topk F``
   without ``--int8`` through the CUDA top-k kernel.
4. **The control loop**: ``--events`` and ``--wan-trace`` publish
   ``CloudEvent``s on one ``EventBus``; the ``ElasticityController``
   re-plans resources (applied at the next sync barrier by re-stacking the
   pod dimension) and, under ``--adaptive-sync``, the
   ``AdaptiveSyncController`` (one bucket) or ``BucketedSyncController``
   (``--bucket-policy layer-class``) retunes the codec's tier, top-k and
   interval at the top of each step.

The flags keep the reference's meanings, defaults and messages;
``--device`` picks the card (default) or the CPU.  The reference's
transport, fault, topology, streaming, checkpoint and serving flags
(``--transport``, ``--faults``, ``--no-tolerance``, ``--topology``,
``--stream-*``, ``--ckpt-*``, ``--async-checkpoint``, ``--snapshot-every``,
``--keep-snapshots``, ``--serve``) are not ported yet (ROADMAP.md Queue 1
items 11, 12 and 15a), and argparse refuses them.

Examples::

  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --steps 8 --interval 4 --compress-topk 0.02 --int8 --error-feedback
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --steps 8 --interval 4 --sync ama --compress-topk 0.02
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 2 --steps 24 --batch 8 --seq 32 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback --adaptive-sync \\
      --wan-trace 100@0,5@6,150@16 --ef-guard 0.98 \\
      --events cloud_left:pod1@9,cloud_joined:pod1@13 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import dense
from repro_torch.core.autotune import (AdaptiveSyncController, BucketStats,
                                       BucketedSyncController,
                                       bucket_stats_from_sync_state)
from repro_torch.core.control_plane import (CloudEvent, ElasticityController,
                                            EventBus, ReconfigPlan,
                                            TrainingRequest,
                                            build_training_plan)
from repro_torch.core.scheduler import CloudResources, diff_plans
from repro_torch.core.sync import (BUCKET_CLASSES, BUCKET_POLICIES,
                                   VALUE_DTYPES, BucketOverride, BucketSpec,
                                   SyncConfig, bucket_weights_of,
                                   is_sync_step)
from repro_torch.core.wan import BandwidthTrace
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.registry import get_model_fns
from repro_torch.training.trainer import (Trainer, TrainerConfig, _wait,
                                          apply_reconfig)


def parse_events(spec: str) -> Dict[int, list]:
    """Parse ``--events`` into step-indexed control-plane events.

    Comma-separated ``kind:arg@step`` entries:
      ``cloud_left:pod1@40``  ``bandwidth:25@60``  ``straggler:pod0x2.0@80``
      ``cloud_joined:pod7@100`` (joins with the default v5e x4 slice).
    """
    out: Dict[int, list] = {}
    if not spec:
        return out
    for entry in spec.split(","):
        body, step_s = entry.strip().rsplit("@", 1)
        kind, _, arg = body.partition(":")
        step = int(step_s)
        if kind == "cloud_left":
            ev = CloudEvent("cloud_left", region=arg, time_s=step)
        elif kind == "bandwidth":
            ev = CloudEvent("bandwidth_changed", bandwidth_mbps=float(arg),
                            time_s=step)
        elif kind == "straggler":
            region, _, factor = arg.partition("x")
            ev = CloudEvent("straggler_detected", region=region,
                            slowdown=float(factor or 2.0), time_s=step)
        elif kind == "cloud_joined":
            ev = CloudEvent("cloud_joined", time_s=step,
                            resources=CloudResources(
                                region=arg, devices=(("v5e", 4),),
                                data_size=1.0))
        else:
            raise ValueError(f"unknown event kind {kind!r} in {entry!r}")
        out.setdefault(step, []).append(ev)
    return out


def parse_wan_trace(spec: str, steps: int, step_time_s: float
                    ) -> Optional[BandwidthTrace]:
    """Parse ``--wan-trace`` into a :class:`BandwidthTrace`.

    Two forms:
      ``100@0,25@60,80@120``            — explicit mbps@step segments
      ``random:seed=3,base=100,sigma=0.6,period=20``
                                        — lognormal random walk (step units)
    Steps convert to seconds at ``step_time_s`` (the emulated per-step
    wall-clock the WAN timeline is measured in)."""
    if not spec:
        return None
    if spec.startswith("random:") or spec == "random":
        kw = {}
        for part in spec.partition(":")[2].split(","):
            if part:
                k, _, v = part.partition("=")
                kw[k.strip()] = float(v)
        return BandwidthTrace.fluctuating(
            base_mbps=kw.get("base", 100.0),
            duration_s=steps * step_time_s,
            period_s=kw.get("period", 20.0) * step_time_s,
            sigma=kw.get("sigma", 0.6),
            seed=int(kw.get("seed", 0)))
    times, mbps = [], []
    for entry in spec.split(","):
        b, _, at = entry.strip().partition("@")
        times.append(float(at) * step_time_s)
        mbps.append(float(b))
    return BandwidthTrace(times_s=tuple(times), mbps=tuple(mbps))


def parse_bucket_overrides(spec: str) -> tuple:
    """Parse ``--bucket-override`` into :class:`BucketOverride` entries.

    Comma-separated per-bucket entries, colon-separated ``key=value``
    knobs:  ``embed:topk=0.02:dtype=int4:block=1024,norm:dtype=int8``.
    Keys: ``topk`` (compress fraction), ``dtype`` (codec tier) and
    ``block`` (per-bucket top-k block size)."""
    out = []
    if not spec:
        return ()
    for entry in spec.split(","):
        name, _, rest = entry.strip().partition(":")
        kw = {}
        for part in rest.split(":"):
            if not part:
                continue
            k, _, v = part.partition("=")
            if k == "topk":
                kw["compress_topk"] = float(v)
            elif k == "dtype":
                kw["value_dtype"] = v
            elif k == "block":
                kw["codec_block"] = int(v)
            else:
                raise ValueError(
                    f"bucket {name!r}: unknown override key {k!r} in "
                    f"{entry!r} (keys: topk, dtype, block)")
        out.append(BucketOverride(name=name, **kw))
    return tuple(out)


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
    """Per-pod stacked batch closure for a plan: one token shard per pod,
    padding rows of trimmed pods masked out (the elastic batch split).
    Rebuilt after every applied reconfiguration, so the mask follows the
    live plan."""
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


def stats_reader(bucketed: bool) -> Callable:
    """``read(sync_state, names)`` -> the tuner's input.  The norms change
    only when a sync round (or a resize) replaces the tensors, so a device
    read happens once per new reading and every other step reuses it."""
    last = {"msg": None, "res": None, "names": None, "val": None}

    def read(sync_state, names):
        if not (sync_state.msg_norm is last["msg"]
                and sync_state.resid_norm is last["res"]
                and names == last["names"]):
            last.update(msg=sync_state.msg_norm, res=sync_state.resid_norm,
                        names=names,
                        val=(bucket_stats_from_sync_state(sync_state, names)
                             if bucketed
                             else BucketStats.from_sync_state(sync_state)))
        return last["val"]

    return read


def tier_label(sync: SyncConfig) -> str:
    """The codec knobs a round runs at: ``int8@0.05``, or one
    ``bucket=tier@topk`` per bucket group under ``layer-class``."""
    if sync.bucket_policy == "single":
        return f"{sync.value_dtype}@{sync.compress_topk}"
    return ",".join(f"{n}={d}@{f}" for n in sync.bucket_names
                    for f, d, _ in [sync.bucket_knobs(n)])


def main(argv=None, *, model_cfg=None, init_params=None, round_hook=None):
    """Run the driver on ``argv``.  ``model_cfg`` (a ``ModelConfig``) runs
    instead of ``--arch`` / ``--preset``, for a caller that cuts a published
    config to size; ``init_params`` (one pod's parameter tree) replaces the
    seeded random start, for a caller that must start from given numbers;
    ``round_hook`` goes to the ``Trainer`` (called after each codec
    round)."""
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
    ap.add_argument("--bucket-policy", default="single",
                    choices=list(BUCKET_POLICIES),
                    help="layer-class: partition the codec payload into "
                         f"{BUCKET_CLASSES} groups, each with its own "
                         "(top-k, dtype) knobs, EF telemetry and — under "
                         "--adaptive-sync — its own controller rung")
    ap.add_argument("--bucket-override", default="",
                    help="per-bucket knob overrides (with --bucket-policy "
                         "layer-class), e.g. "
                         "'embed:topk=0.02:dtype=int4:block=1024,"
                         "norm:dtype=int8'; unnamed groups inherit the "
                         "global knobs")
    ap.add_argument("--bucket-patterns", default="default",
                    help="layer-class pattern table: 'default' (four-class),"
                         " 'moe-router' (routers get their own group), or a"
                         " custom 'name=sub1|sub2;...' table "
                         "(see BucketSpec.parse)")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--data-ratio", default="1:1",
                    help="per-pod data distribution, e.g. 2:1")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--events", default="",
                    help="mid-run cloud events, e.g. "
                         "'cloud_left:pod1@40,bandwidth:25@60' "
                         "(see parse_events)")
    ap.add_argument("--adaptive-sync", action="store_true",
                    help="close the loop: AdaptiveSyncController retunes "
                         "compress_topk / value dtype / interval from EF "
                         "stats + WAN probes (needs --int8 "
                         "--error-feedback --compress-topk)")
    ap.add_argument("--wan-trace", default="",
                    help="emulated bandwidth trace, 'MBPS@step,...' or "
                         "'random:seed=3,base=100,sigma=0.6,period=20' "
                         "(see parse_wan_trace); drives the adaptive "
                         "controller's WAN probe")
    ap.add_argument("--step-time", type=float, default=0.5,
                    help="emulated seconds per training step for the WAN "
                         "trace timeline + controller comm-fraction math")
    ap.add_argument("--ef-guard", type=float, default=0.9,
                    help="adaptive sync: EF-residual ratio bound the "
                         "controller must never trade away")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the codec run")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")

    # ----------------------------------------------------------- model
    if model_cfg is not None:
        cfg, module = model_cfg, "transformer"
    elif args.preset or (not args.arch):
        cfg = preset_tiny() if args.preset == "tiny" else preset_100m()
        module = "transformer"
    else:
        arch = get_arch(args.arch)
        cfg = arch.smoke if args.smoke else arch.config
        module = arch.module
    name = cfg.name
    fns = get_model_fns(module)

    # ----------------------------------------------------- control plane
    ratio = [float(x) for x in args.data_ratio.split(":")]
    while len(ratio) < args.pods:
        ratio.append(ratio[-1])
    clouds = tuple(CloudResources(region=f"pod{i}", devices=(("v5e", 4),),
                                  data_size=ratio[i])
                   for i in range(args.pods))
    bucket_spec = BucketSpec.parse(args.bucket_patterns)
    if args.bucket_policy == "single" and \
            args.bucket_patterns.strip().lower() not in ("", "default"):
        raise SystemExit(
            "--bucket-patterns is inert without --bucket-policy "
            "layer-class: the single policy packs one unnamed bucket")
    sync_cfg = SyncConfig(args.sync, args.interval,
                          compress_topk=args.compress_topk,
                          quantize_int8=args.int8,
                          value_dtype=args.value_dtype,
                          error_feedback=args.error_feedback,
                          codec_block=args.codec_block,
                          overlap_chunks=args.overlap_chunks,
                          bucket_policy=args.bucket_policy,
                          buckets=parse_bucket_overrides(args.bucket_override),
                          bucket_spec=bucket_spec)
    request = TrainingRequest(model=name, clouds=clouds, sync=sync_cfg,
                              n_iters=args.steps, global_batch=args.batch)
    plan = build_training_plan(request)
    print(f"[control-plane] ring topology: {plan.topology}")
    print(f"[control-plane] PS identities: {plan.ps_identities}")
    print(f"[control-plane] batch split:   {plan.batch_split}")
    batches = make_batches(plan, cfg.vocab_size, args.seq, device)

    # ---------------------------------------------------------- trainer
    trace = parse_wan_trace(args.wan_trace, args.steps, args.step_time)
    tcfg = TrainerConfig(n_pods=args.pods, optimizer=args.optimizer,
                         lr=args.lr, sync=sync_cfg)
    trainer = Trainer(lambda p, b: fns.loss_fn(p, cfg, b),
                      (lambda g: fns.init_params(g, cfg, device))
                      if init_params is None else (lambda g: init_params),
                      tcfg, device=device, round_hook=round_hook)
    state = trainer.init_state(0)
    leaves = T.leaves(state.params)
    n_params = sum(x.numel() for x in leaves) // args.pods
    model_mb = sum(x.numel() * x.element_size()
                   for x in leaves) / args.pods / 1e6
    print(f"[train] {name}: {n_params:,} params/pod ({model_mb:.1f} MB), "
          f"{args.pods} pods, sync={args.sync}@{args.interval}, "
          f"device {device}")
    bweights = (bucket_weights_of(sync_cfg, state.params)
                if sync_cfg.bucket_policy != "single" else None)
    if sync_cfg.uses_codec:
        payload = sync_cfg.payload_mb(model_mb, bucket_weights=bweights)
        print(f"[train] wan codec: top-k {sync_cfg.compress_topk} + "
              f"{sync_cfg.value_dtype}, block {sync_cfg.codec_block}, "
              f"ef={'on' if sync_cfg.error_feedback else 'off'}, "
              f"chunks {sync_cfg.overlap_chunks}, payload "
              f"{payload:.2f} MB/sync "
              f"({model_mb / max(payload, 1e-9):.0f}x below dense)")
        if bweights is not None:
            knobs = {n: sync_cfg.bucket_knobs(n)
                     for n in sync_cfg.bucket_names if bweights.get(n, 0) > 0}
            print("[train] bucket groups: "
                  + ", ".join(f"{n} {bweights[n] * model_mb:.1f} MB "
                              f"(topk {f}, {d}, block {blk})"
                              for n, (f, d, blk) in knobs.items()))

    # -------------------------------------------------------- elasticity
    # one control plane: the EventBus carries bandwidth/cloud churn to BOTH
    # actuators — the ElasticityController (re-plan resources) and the
    # adaptive sync controller (retune the codec)
    bus = EventBus()
    events = parse_events(args.events)
    controller = (ElasticityController(plan, bus=bus) if events else None)
    tuner = None
    if args.adaptive_sync:
        if not (sync_cfg.uses_codec and sync_cfg.error_feedback):
            raise SystemExit(
                "--adaptive-sync requires the fused codec with error "
                "feedback: add --compress-topk F --int8 --error-feedback")
        if sync_cfg.bucket_policy == "layer-class":
            bucket_mb = {n: w * model_mb for n, w in bweights.items()}
            tuner = BucketedSyncController(
                sync_cfg, bucket_mb, args.step_time, ef_guard=args.ef_guard,
                bus=bus)
            print("[autotune] per-bucket rungs: "
                  + ", ".join(f"{n} ({b.model_mb:.1f} MB, "
                              f"{len(b.ladder)} rungs)"
                              for n, b in tuner.buckets.items())
                  + f", ef_guard {args.ef_guard}, "
                  f"budget {tuner.interval_budget}")
        else:
            tuner = AdaptiveSyncController(
                sync_cfg, model_mb, args.step_time, ef_guard=args.ef_guard,
                bus=bus)
            print(f"[autotune] ladder: "
                  f"{[f'{c.value_dtype}@{c.compress_topk}' for c in tuner.ladder]}"
                  f", ef_guard {args.ef_guard}, budget {tuner.interval_budget}")
        if trace is not None:
            tuner.observe_wan(trace.at(0.0))
    read_stats = stats_reader(isinstance(tuner, BucketedSyncController))
    last_bw = trace.at(0.0) if trace is not None else None
    # several events may fire between two barriers: the reconfig applied at
    # the barrier is composed against the plan that is actually live on the
    # trainer (pending_base), not against the latest event's predecessor
    pending_base = None     # live plan when the first un-applied event fired
    pending_event = None
    n_reconfigs = 0
    n_retunes = 0
    decisions, rounds, reconfigs_at = [], [], []

    # ------------------------------------------------------------- loop
    t0 = time.time()
    losses = []

    def fire_event(ev):
        """Publish a control-plane event on the shared bus and book any
        resulting reconfig for application at the next sync barrier."""
        nonlocal pending_base, pending_event
        rc = next((r for r in bus.publish(ev)
                   if isinstance(r, ReconfigPlan)), None)
        if rc is not None:
            if pending_base is None:
                pending_base = rc.old
            pending_event = ev
            print(f"[elasticity] {ev.kind} at step {step}: "
                  f"diff {rc.diff.summary()}, "
                  f"batch split {rc.new.batch_split}, "
                  f"interval {rc.new.request.sync.interval}")

    for step in range(args.steps):
        # WAN trace: segment changes surface as bandwidth_changed events on
        # the shared bus — the elasticity controller AND the codec autotuner
        # both hear them at the TOP of the step, before this step's
        # transfer is paid
        if trace is not None:
            bw = trace.at_step(step, args.step_time)
            if bw != last_bw:
                fire_event(CloudEvent("bandwidth_changed", bandwidth_mbps=bw,
                                      time_s=step * args.step_time))
                last_bw = bw

        # adaptive sync: the controller decides at the TOP of the step from
        # the freshest WAN probe + the last sync's bucket stats (they persist
        # in SyncState; read from the device once per new reading)
        if tuner is not None and trainer.cfg.n_pods > 1:
            upd = tuner.update(step, read_stats(
                state.sync_state, trainer.cfg.sync.bucket_names))
            if upd is not None:
                trainer, state = trainer.retune(state, upd.sync)
                n_retunes += 1
                detail = (f", ef_ratio {upd.stats.ef_ratio:.3f}"
                          if getattr(upd, "stats", None) else "")
                print(f"[autotune] step {step + 1}: {upd.summary()} "
                      f"(payload "
                      f"{upd.sync.payload_mb(model_mb, bucket_weights=bweights):.3f}"
                      f" MB{detail})")
                decisions.append({"step": step + 1,
                                  "tiers": tier_label(upd.sync),
                                  "interval": upd.sync.interval,
                                  "summary": upd.summary()})

        state, metrics = trainer.train_step(state, batches(step))
        n_before = len(trainer.sync_seconds)
        state = trainer.maybe_sync(state, step, model_mb)
        if len(trainer.sync_seconds) > n_before:
            rounds.append([step + 1, tier_label(trainer.cfg.sync),
                           trainer.sync_seconds[-1]])
        losses.append(float(metrics["loss"]))

        # control-plane events fire now; the reconfiguration they produce is
        # applied at the next sync barrier by re-stacking the pod dimension
        if controller is not None:
            for ev in events.pop(step, ()):
                fire_event(ev)
            at_barrier = (trainer.cfg.sync.strategy == "asgd"
                          or is_sync_step(trainer.cfg.sync, step))
            if pending_base is not None and at_barrier:
                pending = ReconfigPlan(
                    event=pending_event, old=pending_base,
                    new=controller.plan,
                    diff=diff_plans(pending_base.resource_plans,
                                    controller.plan.resource_plans))
                _wait(device)
                tb = time.perf_counter()
                trainer, state, applied = apply_reconfig(trainer, state,
                                                         pending)
                _wait(device)
                if applied:
                    reconfigs_at.append([step + 1, trainer.cfg.n_pods,
                                         time.perf_counter() - tb])
                    n_reconfigs += 1
                    plan = pending.new
                    batches = make_batches(plan, cfg.vocab_size, args.seq,
                                           device)
                    if tuner is not None:
                        # the reconfig rewrote the live sync settings:
                        # re-anchor the autotuner's belief so its next
                        # update reasons about the knobs actually running
                        tuner.resync(trainer.cfg.sync)
                    print(f"[elasticity] reconfig applied at barrier "
                          f"step {step + 1}: {trainer.cfg.n_pods} pods, "
                          f"sync interval "
                          f"{trainer.cfg.sync.interval}")
                else:
                    print(f"[elasticity] empty diff at step {step + 1}: "
                          f"no-op, state untouched")
                pending_base = pending_event = None

        if args.log_every and (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                  f"({dt / (step + 1):.2f} s/step)  "
                  f"wan-traffic {trainer.traffic_mb:.1f} MB")

    final = trainer.cfg.sync
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
        "reconfigs": n_reconfigs,
        "retunes": n_retunes,
        "final_pods": trainer.cfg.n_pods,
        "final_interval": final.interval,
        "final_tier": final.tier,
        "final_compress_topk": final.compress_topk,
        "final_value_dtype": final.value_dtype,
        "bucket_policy": args.bucket_policy,
        "final_buckets": {
            n: {"compress_topk": f, "value_dtype": d, "codec_block": blk}
            for n in final.bucket_names
            for f, d, blk in [final.bucket_knobs(n)]
        } if args.bucket_policy != "single" else None,
        "max_ef_ratio": round(tuner.max_ef_ratio, 4) if tuner else None,
        "max_ef_ratio_by_bucket": (
            {n: round(r, 4)
             for n, r in tuner.max_ef_ratio_by_bucket.items()}
            if isinstance(tuner, BucketedSyncController) else None),
        "bucket_patterns": args.bucket_patterns,
        "decisions": decisions,
        "rounds": rounds,
        "reconfigs_at": reconfigs_at,
        "device": str(device),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
