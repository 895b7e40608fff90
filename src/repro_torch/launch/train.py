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
5. **The transport** (``--transport``): who ships the codec payloads.
   ``sim`` bills each round against ``--wan-trace``, ``mesh`` times each
   bucket's ship on the host; both feed a measured probe, and under
   ``--adaptive-sync`` the controllers then read only that probe
   (measured mode: no trace wired to them).
6. **Faults** (``--faults``, ``--no-tolerance``): a seeded chaos plan wraps
   the transport in a ``ChaosTransport``: failed and timed-out transfers
   retry, corrupted ones fail their checksums and re-ship, a crashed pod
   degrades rounds until the ``ElasticityController`` removes it, and a
   rollback-mode crash restores the full train state saved at the last
   sync barrier (``fault_barrier/`` under ``--ckpt-dir``).  ``--ckpt-dir``
   also keeps the parameters before each applied reconfig and, with
   ``--ckpt-every``, every N steps.
7. **Topology** (``--topology tree|auto``, with ``--wan-trace``): a
   ``HierarchicalTransport`` bills each round over the plan's regions
   (intra-region reduce, gather and broadcast through the best-connected
   root, auxiliary routes around collapsed links); ``auto`` lets the
   ``TopologyPlanner`` switch tree and ring from the measured link
   beliefs, under ``--adaptive-sync``.  The bytes are the ring's either
   way.
8. **Streaming rounds** (``--stream-retune``, ``--stream-cliff``,
   ``--stream-hysteresis``): codec rounds ship chunk by chunk over a
   streaming transport (sim, mesh, or the topology's), and a chunk whose
   achieved bandwidth falls ``--stream-cliff`` below the belief re-encodes
   the round's unsent tail one rung cheaper; the EF residual carries what
   the tail dropped.
9. **Snapshots and live migration** (``--async-checkpoint``,
   ``--snapshot-every``, ``--keep-snapshots``): an
   ``AsyncCheckpointEngine`` snapshots the full train state at step 0, at
   every sync barrier (and every N steps) off the step; a reconfiguration
   stages its new pod count from the last durable snapshot in the
   background (``LiveMigrator``) and reconciles at the barrier; a
   rollback-mode crash restores the last durable snapshot; the blocking
   barrier checkpoint of 6 is then not written.  Snapshots go to
   ``snapshots/`` under ``--ckpt-dir``, else to a temporary directory
   removed when the run ends (the reference keeps its ``mkdtemp``): a run
   at granite-8b width on the card writes ~20 GB a snapshot.
10. **Serving smoke** (``--serve``): a 4-slot ``ContinuousEngine`` serves
    6 requests, 8 new tokens each, on pod 0's final parameters
    (encoder-decoder modules print a skip).

The flags keep the reference's meanings, defaults and messages;
``--device`` picks the card (default) or the CPU.

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
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 2 --steps 20 --batch 4 --seq 16 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback --adaptive-sync \\
      --wan-trace 100@0,0.5@3,100@10 --transport sim:fluct=0.25 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 2 --steps 8 --batch 4 --seq 16 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback --wan-trace 100@0 \\
      --transport sim --faults fail:x1@1,crash:pod1@3:rollback \\
      --ckpt-dir /tmp/run --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 2 --steps 12 --batch 4 --seq 16 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback \\
      --bucket-policy layer-class --wan-trace 100@0,0.5@5 \\
      --transport sim:fluct=0,latency=0 --stream-retune --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 3 --steps 12 --batch 6 --seq 16 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback --adaptive-sync \\
      --wan-trace 100@0,0.5@5 --topology auto --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --pods 2 --steps 8 --batch 4 --seq 16 --interval 2 \\
      --compress-topk 0.05 --int8 --error-feedback --async-checkpoint \\
      --events cloud_left:pod1@2 --serve --device cpu
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import dense
from repro_torch.core.autotune import (AdaptiveSyncController, BucketStats,
                                       BucketedSyncController,
                                       StreamingShipController,
                                       bucket_stats_from_sync_state)
from repro_torch.core.control_plane import (CloudEvent, ElasticityController,
                                            EventBus, ReconfigPlan,
                                            TrainingRequest,
                                            build_training_plan)
from repro_torch.core.faults import (FAULT_KINDS, ChaosTransport,
                                     FaultEvent, FaultPlan)
from repro_torch.core.scheduler import CloudResources, diff_plans
from repro_torch.core.sync import (BUCKET_CLASSES, BUCKET_POLICIES,
                                   VALUE_DTYPES, BucketOverride, BucketSpec,
                                   PodUnreachableError, SyncConfig,
                                   bucket_weights_of, is_sync_step)
from repro_torch.core.topology import (HierarchicalTransport,
                                       TopologyPlanner, TopologySpec)
from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                        SimTransport)
from repro_torch.core.wan import BandwidthTrace, WANConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.models.registry import get_model_fns
from repro_torch.training.trainer import (LiveMigrator, Trainer,
                                          TrainerConfig, _wait,
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


def parse_transport(spec: str, trace: Optional[BandwidthTrace],
                    sync_cfg: SyncConfig):
    """Parse ``--transport`` into a WAN transport (or ``None`` = inline).

    Forms: ``inline`` (the in-process ring, no timing), ``sim`` /
    ``sim:fluct=0.2,latency=0.05,seed=3`` (trace-driven billing; needs
    ``--wan-trace``), ``mesh`` / ``mesh:mbps=5`` (a host-timed ship of
    each bucket; ``mbps`` adds an emulated WAN hop so measured times are
    WAN-scale).  Sim and mesh both feed a
    :class:`~repro_torch.core.transport.MeasuredWanProbe`: under
    ``--adaptive-sync`` the controller then runs from measured transfer
    times only, with no trace wired to it."""
    kind, _, rest = spec.partition(":")
    known = {"sim": ("fluct", "latency", "seed"), "mesh": ("mbps",),
             "inline": (), "": ()}
    if kind not in known:
        raise ValueError(f"unknown --transport {spec!r} (inline, sim, mesh)")
    kw = {}
    for part in rest.split(","):
        if part:
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in known.get(kind, ()):
                raise ValueError(
                    f"--transport {kind}: unknown option {k!r} in {spec!r} "
                    f"(options: {known.get(kind, ())}) — a dropped knob "
                    f"would run with its default silently")
            kw[k] = float(v)
    if kind in ("", "inline"):
        return None
    if kind == "sim":
        if trace is None:
            raise ValueError("--transport sim needs --wan-trace: the sim "
                             "transport bills transfers against a "
                             "bandwidth trace")
        wan = WANConfig(bandwidth_mbps=trace.mbps[0],
                        fluctuation=kw.get("fluct", 0.25),
                        latency_s=kw.get("latency", 0.05),
                        seed=int(kw.get("seed", 0)))
        return SimTransport(trace, wan, probe=MeasuredWanProbe())
    # kind == "mesh" (kind membership was validated above)
    if not sync_cfg.uses_codec:
        raise ValueError(
            "--transport mesh requires the fused codec (the host-seam "
            "ship times codec payloads): add --compress-topk F --int8")
    return MeshTransport(probe=MeasuredWanProbe(),
                         emulate_mbps=kw.get("mbps"))


def parse_faults(spec: str) -> Optional[FaultPlan]:
    """Parse ``--faults`` into a :class:`FaultPlan` (``None`` when empty).

    Comma-separated fault entries keyed to the sync step they first bite
    at, plus an optional plan seed:
      ``fail:x2@39``       — 2 failed attempts, then success (retried)
      ``timeout:x6@67``    — transfer 6x slower than the bandwidth belief
                             (>= the retry policy's timeout_factor means
                             the attempt is declared failed and retried)
      ``corrupt@95``       — wire bit-flip on the shipped payload (caught
                             by the per-chunk checksums, then re-shipped)
      ``flap:x8@119+6``    — link 8x slower for a 6-round window
      ``crash:pod1@183``   — pod 1 dies; rounds degrade over the
                             surviving membership until it is removed
      ``crash:pod1@183:rollback`` — mid-round crash: the run first rolls
                             back to the last sync-barrier snapshot
      ``seed=3``           — seed of the plan's deterministic stream
    """
    if not spec:
        return None
    events, seed = [], 0
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            val = entry.partition("=")[2]
            try:
                seed = int(val)
            except ValueError:
                raise ValueError(
                    f"--faults: seed must be an integer, got {val!r}"
                ) from None
            continue
        body, at_sep, tail = entry.partition("@")
        if not at_sep:
            raise ValueError(
                f"--faults entry {entry!r}: missing '@step' — every fault "
                f"is keyed to the sync step it first bites at")
        kind, _, arg = body.partition(":")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"--faults entry {entry!r}: unknown kind {kind!r} "
                f"(kinds: {', '.join(FAULT_KINDS)})")
        step_part, _, mode = tail.partition(":")
        step_s, plus, dur_s = step_part.partition("+")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"--faults entry {entry!r}: step must be an integer, "
                f"got {step_s!r}") from None
        kw = {}
        if plus:
            if kind != "flap":
                raise ValueError(
                    f"--faults entry {entry!r}: '+duration' only applies "
                    f"to flap (a window of slowed rounds)")
            try:
                kw["duration"] = int(dur_s)
            except ValueError:
                raise ValueError(
                    f"--faults entry {entry!r}: duration must be an "
                    f"integer number of rounds, got {dur_s!r}") from None
        if mode:
            if kind != "crash":
                raise ValueError(
                    f"--faults entry {entry!r}: trailing {':' + mode!r} — "
                    f"a recovery mode only applies to crash")
            kw["mode"] = mode       # FaultEvent validates the mode name
        if kind in ("timeout", "flap"):
            if not arg.startswith("x"):
                raise ValueError(
                    f"--faults entry {entry!r}: {kind} needs a slowdown "
                    f"factor 'xF' (e.g. {kind}:x6@{step}), got {arg!r}")
            try:
                kw["factor"] = float(arg[1:])
            except ValueError:
                raise ValueError(
                    f"--faults entry {entry!r}: factor must be a number, "
                    f"got {arg[1:]!r}") from None
        elif kind == "fail":
            if arg:
                if not arg.startswith("x"):
                    raise ValueError(
                        f"--faults entry {entry!r}: fail takes an attempt "
                        f"count 'xN' (e.g. fail:x2@{step}), got {arg!r}")
                try:
                    kw["attempts"] = int(arg[1:])
                except ValueError:
                    raise ValueError(
                        f"--faults entry {entry!r}: attempts must be an "
                        f"integer, got {arg[1:]!r}") from None
        elif kind == "crash":
            if not arg.startswith("pod"):
                raise ValueError(
                    f"--faults entry {entry!r}: crash needs the dying pod "
                    f"'podP' (e.g. crash:pod1@{step}), got {arg!r}")
            try:
                kw["pod"] = int(arg[3:])
            except ValueError:
                raise ValueError(
                    f"--faults entry {entry!r}: pod must be an integer "
                    f"index, got {arg[3:]!r}") from None
        elif arg:                   # corrupt takes no argument
            raise ValueError(
                f"--faults entry {entry!r}: corrupt takes no argument "
                f"(the bit-flip lands on the shipped payload itself)")
        events.append(FaultEvent(kind=kind, step=step, **kw))
    return FaultPlan(events=tuple(events), seed=seed)


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="stream snapshots off the training step: an "
                         "AsyncCheckpointEngine captures the full train "
                         "state at every sync barrier on a background "
                         "thread (atomic step-tagged dirs), and pod "
                         "reconfigurations migrate live from the last "
                         "durable snapshot instead of pausing to "
                         "checkpoint-restore")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="with --async-checkpoint: also snapshot every N "
                         "steps between barriers (0 = barriers only)")
    ap.add_argument("--keep-snapshots", type=int, default=2,
                    help="with --async-checkpoint: retention depth — the "
                         "engine prunes to the N newest durable snapshots")
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
    ap.add_argument("--stream-retune", action="store_true",
                    help="chunk-granular streaming rounds: ship sync "
                         "payloads chunk by chunk, compare each chunk's "
                         "achieved bandwidth against the measured belief, "
                         "and on a mid-round cliff abort the unsent "
                         "schedule and re-encode the tail one codec rung "
                         "cheaper (EF residual carries the fidelity "
                         "delta).  Needs the fused codec with error "
                         "feedback and a streaming-capable transport with "
                         "a measured probe (sim, mesh, or topology "
                         "tree/auto)")
    ap.add_argument("--stream-cliff", type=float, default=4.0,
                    help="with --stream-retune: a chunk's achieved "
                         "bandwidth must fall this factor below the "
                         "believed bandwidth to count as a cliff "
                         "(same scale as the probe's cliff-snap)")
    ap.add_argument("--stream-hysteresis", type=int, default=1,
                    help="with --stream-retune: consecutive cliff chunks "
                         "required before the mid-round retune fires "
                         "(1 = react to the first chunk)")
    ap.add_argument("--transport", default="inline",
                    help="who ships sync payloads: 'inline' (the in-process "
                         "ring), 'sim[:fluct=F,latency=L,seed=S]' (billed "
                         "against --wan-trace; feeds the measured probe), "
                         "'mesh[:mbps=B]' (a host-timed ship of each "
                         "bucket, optional emulated WAN hop).  With "
                         "--adaptive-sync + sim/mesh the controller runs "
                         "from measured transfer times only — no trace is "
                         "wired to it")
    ap.add_argument("--faults", default="",
                    help="seeded chaos schedule keyed to sync steps, e.g. "
                         "'fail:x2@39,timeout:x6@67,corrupt@95,"
                         "flap:x8@119+6,crash:pod1@183,seed=0' "
                         "(see parse_faults); wraps the transport in a "
                         "ChaosTransport with bounded retry/backoff, "
                         "per-chunk checksum verification and degraded "
                         "rounds over the surviving membership")
    ap.add_argument("--no-tolerance", action="store_true",
                    help="with --faults: disable checksums, retries and "
                         "degraded rounds — the baseline the fault-"
                         "tolerant path is measured against (corruption "
                         "decodes into the parameters; a crashed peer "
                         "hangs every round)")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "tree", "auto"],
                    help="aggregation topology over the plan's regions: "
                         "'ring' (flat pod ring, legacy billing), 'tree' "
                         "(hierarchical transport: intra-region reduce + "
                         "gather/broadcast through the best-connected "
                         "root, auxiliary routes around collapsed links; "
                         "needs --wan-trace), 'auto' (tree/ring chosen by "
                         "the TopologyPlanner from measured link beliefs "
                         "— the third actuator; needs --adaptive-sync).  "
                         "Numerics are identical either way; topology "
                         "changes the billing and the traffic accounting")
    ap.add_argument("--serve", action="store_true",
                    help="after training, run a short continuous-batching "
                         "serving smoke on pod-0's final parameters "
                         "(prefill -> slot insert -> generate over a "
                         "4-slot pool); decoder-only modules only — "
                         "encoder-decoder modules print a skip")
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
    transport = parse_transport(args.transport, trace, sync_cfg)
    if args.topology != "ring":
        if transport is not None:
            raise SystemExit(
                "--topology tree/auto builds its own hierarchical "
                "transport; it composes with --transport inline only")
        if trace is None:
            raise SystemExit(
                "--topology tree/auto needs --wan-trace: the hierarchical "
                "transport bills the schedule against per-link bandwidth")
        topo_spec = TopologySpec.from_plan(
            plan, kind="tree" if args.topology == "tree" else "ring")
        transport = HierarchicalTransport(
            topo_spec, trace,
            wan=WANConfig(bandwidth_mbps=trace.mbps[0]),
            probe=MeasuredWanProbe())
        print(f"[topology] {args.topology}: regions "
              f"{list(topo_spec.regions)}, start kind {topo_spec.kind}, "
              f"{transport.wan_transfers_per_round} WAN transfers/round")
    if transport is not None:
        mesh = ""
        if isinstance(transport, MeshTransport):
            sharded = transport.sharding(args.pods, device.type) is not None
            mesh = (f", {len(transport.devices(device.type))} devices, "
                    f"{'sharded' if sharded else 'unsharded'}")
        print(f"[transport] {args.transport}: "
              f"{type(transport).__name__}{mesh}")
    if not args.async_checkpoint:
        if args.snapshot_every:
            raise SystemExit(
                "--snapshot-every tunes the async snapshot engine's "
                "cadence: it needs --async-checkpoint")
        if args.keep_snapshots != 2:
            raise SystemExit(
                "--keep-snapshots tunes the async snapshot engine's "
                "retention: it needs --async-checkpoint")
    elif args.keep_snapshots < 1:
        raise SystemExit(
            "--keep-snapshots must keep at least the one snapshot the "
            "rollback/migration paths recover from")
    fault_plan = parse_faults(args.faults)
    if args.no_tolerance and fault_plan is None:
        raise SystemExit(
            "--no-tolerance is a --faults baseline switch: it picks how "
            "injected faults are (not) handled, so it needs --faults")
    if fault_plan is not None:
        if transport is None:
            raise SystemExit(
                "--faults needs a billing transport to inject into: add "
                "--transport sim (with --wan-trace) or --transport mesh")
        if fault_plan.needs_host_seam and not sync_cfg.uses_codec:
            raise SystemExit(
                "--faults with fail/timeout/corrupt/crash events injects "
                "at the host-seam codec ship: add --compress-topk F --int8")
        bad = next((ev for ev in fault_plan.events
                    if ev.kind == "crash" and ev.pod >= args.pods), None)
        if bad is not None:
            raise SystemExit(
                f"--faults: crash pod {bad.pod} is out of range for "
                f"--pods {args.pods} (pods are 0..{args.pods - 1})")
        transport = ChaosTransport(transport, fault_plan,
                                   tolerate=not args.no_tolerance)
        print(f"[faults] {len(fault_plan.events)} scheduled events, seed "
              f"{fault_plan.seed}, "
              f"{'tolerant' if transport.tolerate else 'NO-TOLERANCE'}: "
              f"retry budget {transport.retry_policy.max_retries}, "
              f"timeout {transport.retry_policy.timeout_factor}x belief")
    tcfg = TrainerConfig(n_pods=args.pods, optimizer=args.optimizer,
                         lr=args.lr, sync=sync_cfg)
    trainer = Trainer(lambda p, b: fns.loss_fn(p, cfg, b),
                      (lambda g: fns.init_params(g, cfg, device))
                      if init_params is None else (lambda g: init_params),
                      tcfg, device=device, round_hook=round_hook,
                      transport=transport)
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

    # ------------------------------------------------- streaming retune
    # the chunk-level control loop: first-chunk feedback, at most one
    # mid-round retune, the EF residual carries the unsent tail's
    # fidelity delta
    stream_ctl = None
    if args.stream_retune:
        if not (sync_cfg.uses_codec and sync_cfg.error_feedback):
            raise SystemExit(
                "--stream-retune re-encodes the unsent tail against the "
                "carried residual: add --compress-topk F --int8 "
                "--error-feedback")
        if transport is None or not getattr(transport,
                                            "supports_streaming", False):
            raise SystemExit(
                "--stream-retune needs a streaming-capable transport: "
                "--transport sim/mesh or --topology tree/auto "
                "(the inline ring has no chunk barrier to observe)")
        if transport.probe is None:
            raise SystemExit(
                "--stream-retune compares achieved vs believed bandwidth: "
                "the transport must carry a measured probe")
        stream_ctl = StreamingShipController(
            sync_cfg, model_mb, cliff_ratio=args.stream_cliff,
            hysteresis=args.stream_hysteresis, ef_guard=args.ef_guard,
            probe_est=transport.probe.estimator)
        trainer.stream = stream_ctl
        print(f"[stream] chunk-granular rounds: cliff {args.stream_cliff}x "
              f"below belief, hysteresis {args.stream_hysteresis}, "
              f"{len(stream_ctl.ladder)} retune rungs")
    else:
        if args.stream_cliff != 4.0:
            raise SystemExit(
                "--stream-cliff tunes the streaming retune's cliff "
                "threshold: it needs --stream-retune")
        if args.stream_hysteresis != 1:
            raise SystemExit(
                "--stream-hysteresis tunes the streaming retune's "
                "debounce: it needs --stream-retune")

    # -------------------------------------------------------- elasticity
    # one control plane: the EventBus carries bandwidth/cloud churn to BOTH
    # actuators — the ElasticityController (re-plan resources) and the
    # adaptive sync controller (retune the codec)
    bus = EventBus()
    events = parse_events(args.events)
    # crashes are involuntary cloud_left events: the elasticity controller
    # must be live to re-match the surviving pods when one dies
    chaos = transport if isinstance(transport, ChaosTransport) else None
    need_elastic = bool(events) or (chaos is not None and chaos.tolerate
                                    and chaos.plan.has_crashes)
    # measured mode: the transport's probe owns the bandwidth belief —
    # the controllers read it and nothing else (no trace, no bus events)
    measured = transport is not None and transport.probe is not None
    controller = (ElasticityController(
        plan, bus=bus,
        # the elasticity replan reads the same measured belief the sync
        # controllers act on
        probe_est=transport.probe.estimator if measured else None)
        if need_elastic else None)
    tuner = None
    if args.topology == "auto" and not args.adaptive_sync:
        raise SystemExit(
            "--topology auto is the controller's third actuator: it needs "
            "--adaptive-sync (use --topology tree for a fixed hierarchy)")
    if args.adaptive_sync:
        if not (sync_cfg.uses_codec and sync_cfg.error_feedback):
            raise SystemExit(
                "--adaptive-sync requires the fused codec with error "
                "feedback: add --compress-topk F --int8 --error-feedback")
        probe_kw = (dict(probe_est=transport.probe.estimator, bus=None)
                    if measured else dict(bus=bus))
        if args.topology == "auto":
            # the planner shares the transport's link beliefs and actuates
            # through its set_kind: the controller decides, the transport
            # reshapes
            probe_kw["topology"] = TopologyPlanner(
                transport.spec, transport.beliefs, apply=transport.set_kind)
        if sync_cfg.bucket_policy == "layer-class":
            bucket_mb = {n: w * model_mb for n, w in bweights.items()}
            tuner = BucketedSyncController(
                sync_cfg, bucket_mb, args.step_time, ef_guard=args.ef_guard,
                **probe_kw)
            print("[autotune] per-bucket rungs: "
                  + ", ".join(f"{n} ({b.model_mb:.1f} MB, "
                              f"{len(b.ladder)} rungs)"
                              for n, b in tuner.buckets.items())
                  + f", ef_guard {args.ef_guard}, "
                  f"budget {tuner.interval_budget}")
        else:
            tuner = AdaptiveSyncController(
                sync_cfg, model_mb, args.step_time, ef_guard=args.ef_guard,
                **probe_kw)
            print(f"[autotune] ladder: "
                  f"{[f'{c.value_dtype}@{c.compress_topk}' for c in tuner.ladder]}"
                  f", ef_guard {args.ef_guard}, budget {tuner.interval_budget}")
        if measured:
            print("[autotune] probe: measured transfer times from the "
                  "transport (no trace wired to the controller)")
        elif trace is not None:
            tuner.observe_wan(trace.at(0.0))
    read_stats = stats_reader(isinstance(tuner, BucketedSyncController))
    last_bw = trace.at(0.0) if trace is not None else None
    # several events may fire between two barriers: the reconfig applied at
    # the barrier is composed against the plan that is actually live on the
    # trainer (pending_base), not against the latest event's predecessor
    pending_base = None     # live plan when the first un-applied event fired
    pending_event = None
    pending_crashes = []    # crashed pods awaiting removal at a barrier
    n_reconfigs = 0
    n_retunes = 0
    n_rollbacks = 0
    decisions, rounds, reconfigs_at = [], [], []

    # async snapshot engine: full-train-state snapshots streamed off the
    # step at every sync barrier; reconfigurations migrate live from the
    # last durable snapshot and crashes roll back to it.  Without
    # --ckpt-dir the snapshots live in a temporary directory, removed when
    # the run ends (or, if it raises, when the object is collected)
    engine = migrator = snap_tmp = None
    if args.async_checkpoint:
        if args.ckpt_dir:
            snap_root = f"{args.ckpt_dir}/snapshots"
        else:
            snap_tmp = tempfile.TemporaryDirectory(prefix="snapshots_")
            snap_root = snap_tmp.name
        engine = AsyncCheckpointEngine(snap_root, keep=args.keep_snapshots)
        migrator = LiveMigrator(engine)
        engine.snapshot(state, 0,
                        metadata={"model": name, "pods": trainer.cfg.n_pods})
        print(f"[ckpt] async snapshot engine at {snap_root}: keep "
              f"{args.keep_snapshots}, cadence "
              f"{'every ' + str(args.snapshot_every) + ' steps + ' if args.snapshot_every else ''}"
              f"sync barriers")

    # mid-round crash recovery: keep a checkpoint of the full train state
    # at the last completed sync barrier; a rollback-mode crash unwinds to
    # it (the async engine's durable snapshots subsume this blocking
    # path).  Without --ckpt-dir it lives in a temporary directory, as the
    # snapshots do
    barrier_dir = barrier_tmp = None
    if engine is None and chaos is not None and chaos.tolerate \
            and chaos.plan.has_crashes:
        if args.ckpt_dir:
            barrier_dir = f"{args.ckpt_dir}/fault_barrier"
        else:
            barrier_tmp = tempfile.TemporaryDirectory(prefix="fault_barrier_")
            barrier_dir = barrier_tmp.name
        ckpt.save(barrier_dir, state, step=0,
                  metadata={"model": name, "pods": trainer.cfg.n_pods})

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
            if migrator is not None and not rc.diff.is_empty:
                # live migration: pre-move the target-pod-count state from
                # the last durable snapshot off the step path; surviving
                # pods keep stepping until the barrier reconciles
                keep_pods, n_new = rc.pod_transition()
                migrator.stage(state, n_new, keep=keep_pods)
                print(f"[elasticity] staging {n_new}-pod migration from "
                      f"the last durable snapshot (background)")

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
        crashed = None
        try:
            state = trainer.maybe_sync(state, step, model_mb)
        except PodUnreachableError as crash:
            crashed = crash.pod
        if crashed is not None:
            # mid-round crash: progress since the barrier includes the dead
            # pod's replica and cannot be re-stacked; restore the barrier
            # (the crash then degrades rounds until the pod is removed).
            # Out of the handler, whose traceback holds the round's buffers
            if engine is not None:
                state, _ = engine.restore_last(like=state)
            else:
                state, _ = ckpt.restore(barrier_dir, like=state)
            n_rollbacks += 1
            print(f"[faults] pod {crashed} unreachable mid-round at "
                  f"step {step + 1}: rolled back to the last sync barrier")
        else:
            at_sync = trainer.cfg.n_pods > 1 and \
                is_sync_step(trainer.cfg.sync, step)
            if engine is not None and (
                    at_sync or (args.snapshot_every and
                                (step + 1) % args.snapshot_every == 0)):
                engine.snapshot(state, step + 1,
                                metadata={"model": name,
                                          "pods": trainer.cfg.n_pods})
            elif barrier_dir is not None and at_sync:
                ckpt.save(barrier_dir, state, step=step + 1,
                          metadata={"model": name,
                                    "pods": trainer.cfg.n_pods})
        if len(trainer.sync_seconds) > n_before:
            rounds.append([step + 1, tier_label(trainer.cfg.sync),
                           trainer.sync_seconds[-1]])
        losses.append(float(metrics["loss"]))
        if transport is not None and hasattr(transport, "tick"):
            # the sim transport's clock advances by emulated compute time;
            # its sync-round billing (and the measured probe) read it
            transport.tick(args.step_time)

        # control-plane events fire now; the reconfiguration they produce is
        # applied at the next sync barrier by re-stacking the pod dimension
        if controller is not None:
            if chaos is not None:
                # each crash surfaces on the shared bus exactly once; the
                # resulting reconfig removes the pod at the next barrier,
                # after which the transport stops degrading rounds for it
                for p in chaos.take_new_crashes():
                    pending_crashes.append(p)
                    fire_event(CloudEvent("pod_crashed", region=f"pod{p}",
                                          time_s=step * args.step_time))
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
                if args.ckpt_dir:
                    ckpt.save(f"{args.ckpt_dir}/pre_reconfig_{step + 1}",
                              state.params, step=step + 1,
                              metadata={"model": name,
                                        "pods": trainer.cfg.n_pods})
                _wait(device)
                tb = time.perf_counter()
                if migrator is not None:
                    # one barrier, not a pause: the staged migration joins
                    # here and the live state is re-stacked in place
                    trainer, state, applied = migrator.reconcile(
                        trainer, state, pending)
                else:
                    trainer, state, applied = apply_reconfig(
                        trainer, state, pending)
                _wait(device)
                if applied:
                    reconfigs_at.append([step + 1, trainer.cfg.n_pods,
                                         time.perf_counter() - tb])
                    n_reconfigs += 1
                    plan = pending.new
                    batches = make_batches(plan, cfg.vocab_size, args.seq,
                                           device)
                    if chaos is not None and pending_crashes:
                        for p in pending_crashes:
                            chaos.clear_crash(p)
                        pending_crashes.clear()
                    if tuner is not None:
                        # the reconfig rewrote the live sync settings:
                        # re-anchor the autotuner's belief so its next
                        # update reasons about the knobs actually running
                        tuner.resync(trainer.cfg.sync)
                    if engine is not None:
                        # re-anchor the durable base on the new membership
                        # (an old-pod-count snapshot cannot back a rollback)
                        engine.snapshot(state, step + 1,
                                        metadata={"model": name,
                                                  "pods": trainer.cfg.n_pods})
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
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, state.params, step=step + 1,
                      metadata={"model": name, "sync": args.sync})
    if barrier_tmp is not None:
        barrier_tmp.cleanup()
    last_durable = None
    if engine is not None:
        engine.wait()
        durable = engine.last_durable()
        last_durable = durable[0] if durable is not None else None
        engine.close()
        print(f"[ckpt] async engine: {engine.committed} snapshots "
              f"committed, last durable step {last_durable}")
        if snap_tmp is not None:
            snap_tmp.cleanup()

    # -------------------------------------------------- serving smoke
    serve_info = None
    if args.serve:
        if fns.prefill is None:
            print(f"[serve] module '{module}' has no prefill/decode-cache "
                  f"path (encoder-decoder) — skipping serving smoke")
            serve_info = {"skipped": module}
        else:
            from repro_torch.serving.engine import (ContinuousEngine,
                                                    ContinuousScheduler)
            pod0 = T.tree_map(lambda x: x[0], state.params)
            sched = ContinuousScheduler(ContinuousEngine(
                None, pod0, n_slots=4, cache_len=64, cfg=cfg,
                module=module))
            srng = np.random.default_rng(0)
            for _ in range(6):
                plen = int(srng.integers(4, 17))
                sched.submit(srng.integers(0, cfg.vocab_size, plen)
                             .astype(np.int32), max_new=8)
            outs = sched.run()
            serve_info = {
                "requests": len(outs),
                "new_tokens": sum(len(v) for v in outs.values()),
                "decode_steps": sched.engine.decode_steps,
            }
            print(f"[serve] continuous-batching smoke on pod-0 params: "
                  f"{serve_info['requests']} requests, "
                  f"{serve_info['new_tokens']} tokens in "
                  f"{serve_info['decode_steps']} pool decode steps")

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
        "transport": args.transport,
        "stream_retune": args.stream_retune,
        "stream_retunes": (trainer.stream_retunes
                           if stream_ctl is not None else None),
        "stream_rounds": (len(transport.stream_rounds)
                          if stream_ctl is not None else None),
        "stream_decisions": (len(stream_ctl.decisions)
                             if stream_ctl is not None else None),
        "topology": args.topology,
        "final_topology": (transport.spec.kind
                           if isinstance(transport, HierarchicalTransport)
                           else None),
        "topology_switches": (len(transport.switches)
                              if isinstance(transport, HierarchicalTransport)
                              else None),
        "topology_reroutes": (len(transport.reroutes)
                              if isinstance(transport, HierarchicalTransport)
                              else None),
        "wan_transfers_per_round": getattr(
            transport, "wan_transfers_per_round", None),
        "transfers": len(transport.records) if transport else None,
        "measured_bandwidth_mbps": (
            round(transport.probe.estimator.bandwidth_mbps, 3)
            if transport is not None and transport.probe is not None
            and transport.probe.estimator.bandwidth_mbps is not None
            else None),
        "bucket_patterns": args.bucket_patterns,
        "faults": args.faults or None,
        "fault_tolerant": (chaos.tolerate if chaos is not None else None),
        "retries": chaos.retries if chaos is not None else None,
        "retried_mb": (round(chaos.retried_mb, 3)
                       if chaos is not None else None),
        "degraded_rounds": (chaos.degraded_rounds
                            if chaos is not None else None),
        "crash_recoveries": (chaos.crash_recoveries
                             if chaos is not None else None),
        "rollbacks": n_rollbacks if chaos is not None else None,
        "async_checkpoint": args.async_checkpoint,
        "snapshots": engine.committed if engine is not None else None,
        "last_durable_step": last_durable,
        "migrations": migrator.migrations if migrator is not None else None,
        "staged_mb": (round(migrator.staged_mb, 3)
                      if migrator is not None else None),
        "serve": serve_info,
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
