"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

A cell of ``BENCHMARK.json`` names a configuration
(``trainbench/configs/<config>.json``) and a traffic mix
(``trainbench/traffic/<mix>.json``); its limits are
``trainbench/limits/<cell>.json`` and each per-layer metric is read by
``trainbench/metrics/<metric>.py``.  Nothing here names a cell, a
configuration or a metric.

The window drives the program's training plane as its launcher does:
``Trainer.train_step`` and then ``Trainer.maybe_sync`` a step, whole sync
intervals at a time.  Set-up makes the weights and a ring of batches from
the seed on the device, runs the first three steps through the same calls
(their losses, the first gradient, the change of the parameters and the
first round's residual are read for the comparison), completes a second
interval, and only then opens the window.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from trainbench import traffic, weights
from trainbench.check import compare
from trainbench.reference.model import Spec, no_tf32, path_str
from trainbench.reference.train import Reference, packing

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "trainbench"
CHECKED_STEPS = 3
# whole cycles the traced run profiles after its window
TRACE_CYCLES = 6


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: Dict[str, float]
    metrics: List[str] = field(default_factory=list)

    @property
    def spec(self) -> Spec:
        return Spec.from_file(self.config)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    per_layer = [m["name"] for m in bench.get("per_layer", [])
                 if name in m.get("workloads", [name])]
    return Cell(name=name,
                config=_json(HERE / "configs" / f"{w['config']}.json"),
                mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                metrics=per_layer)


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...],
                                                        torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


# ------------------------------------------------------------ the program


class Program:
    """The port's trainer for a cell, built as its launcher builds it."""

    def __init__(self, cell: Cell, device: str):
        from repro_torch.core.sync import BucketSpec, SyncConfig
        from repro_torch.models import transformer
        from repro_torch.models.config import MoEConfig
        from repro_torch.training.trainer import Trainer, TrainerConfig

        prog = cell.config["program"]
        base = importlib.import_module(f"repro_torch.configs.{prog['module']}")
        replace = dict(prog.get("replace", {}))
        if "moe" in replace:
            replace["moe"] = MoEConfig(**replace["moe"])
        self.cfg = base.CONFIG.replace(**replace)
        self._check_sizes(cell.spec, cell.config)
        mix, s = cell.mix, dict(cell.mix.get("sync", {}))
        buckets = s.pop("buckets", None)
        if buckets is not None:
            s["bucket_policy"] = "layer-class"
            s["bucket_spec"] = BucketSpec(
                names=tuple(buckets["names"]),
                patterns=tuple((n, tuple(p)) for n, p in buckets["patterns"]),
                vector_bucket=buckets["vector"],
                fallback=buckets["fallback"])
        self.sync = SyncConfig(mix["strategy"], int(mix["interval"]), **s)
        cfg = self.cfg

        def no_init(gen):
            raise RuntimeError("the benchmark hands the trainer its weights")

        self.trainer = Trainer(
            lambda p, b: transformer.loss_fn(p, cfg, b), no_init,
            TrainerConfig(n_pods=int(mix["pods"]),
                          optimizer=mix["optimizer"], lr=float(mix["lr"]),
                          sync=self.sync),
            device=device)

    def _check_sizes(self, spec: Spec, config: dict) -> None:
        """The configuration file describes what the program runs."""
        c = self.cfg
        got = {"n_layers": c.n_layers, "d_model": c.d_model,
               "n_heads": c.n_heads, "n_kv_heads": c.n_kv_heads,
               "head_dim": c.resolved_head_dim, "d_ff": c.d_ff,
               "vocab": c.vocab_size, "vocab_rows": c.padded_vocab,
               "rope_theta": c.rope_theta, "norm_eps": c.norm_eps,
               "param_dtype": c.param_dtype,
               "compute_dtype": c.compute_dtype}
        if spec.moe:
            got.update(num_experts=c.moe.num_experts, top_k=c.moe.top_k,
                       capacity_factor=c.moe.capacity_factor,
                       router_aux_weight=c.moe.router_aux_weight,
                       router_z_weight=c.moe.router_z_weight)
        stated = dict(vars(spec), param_dtype=config["torch_dtype"],
                      compute_dtype=config["port"]["compute_dtype"])
        bad = {k: (stated.get(k), v) for k, v in got.items()
               if stated.get(k) != v}
        if bad or len(c.pattern) != 1 or c.pattern[0].moe != spec.moe:
            raise SystemExit(f"the configuration file does not describe the "
                             f"program's model: (file, program) {bad}")


# ------------------------------------------------------------- readings


def _pod_norms(tree) -> List[Dict[str, float]]:
    flat = flatten(tree)
    pods = next(iter(flat.values())).shape[0]
    return [{path_str(k): float(v[p].float().norm())
             for k, v in flat.items()} for p in range(pods)]


def _diff_norms(tree, params0) -> List[Dict[str, float]]:
    flat = flatten(tree)
    pods = next(iter(flat.values())).shape[0]
    return [{path_str(k): float((v[p].float() - params0[k].float()).norm())
             for k, v in flat.items()} for p in range(pods)]


def _ef_norms(ef: torch.Tensor, spec: Spec, sync: dict
              ) -> List[Dict[str, float]]:
    out = []
    for p in range(ef.shape[0]):
        norms, off = {}, 0
        for _, leaves in packing(spec, sync):
            for k, size in leaves:
                norms[path_str(k)] = float(ef[p, off:off + size].norm())
                off += size
        out.append(norms)
    return out


# ------------------------------------------------------------------ run


@dataclass
class Outcome:
    result: dict
    checks: Dict[str, Tuple[float, Optional[float]]]
    got: dict
    ref: dict
    setup: List[Tuple[str, float]]


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda",
        program_hook: Optional[Callable[[Program], None]] = None) -> Outcome:
    """One run of ``cell``.  ``program_hook`` lets a test break the timed
    path underneath before set-up starts."""
    spec, mix = cell.spec, cell.mix
    marks = [("start", t_start), ("imported", time.perf_counter())]
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(("wan_codec", "topk_compress"))
    marks.append(("kernels built", time.perf_counter()))
    prog = Program(cell, device)
    if program_hook is not None:
        program_hook(prog)
    trainer = prog.trainer
    P, interval = int(mix["pods"]), int(mix["interval"])
    pdt = getattr(torch, cell.config["torch_dtype"])
    params0 = weights.make(spec, seed, device, pdt)
    model_mb = sum(v.numel() * v.element_size()
                   for v in params0.values()) / 1e6
    state = trainer.state_from_params(weights.stacked(params0, P))
    del params0
    ring = traffic.ring(mix, spec.vocab, seed + 1, device)
    _sync(device)
    marks.append(("weights and batches", time.perf_counter()))
    step = 0

    def one_step(state, timed: Optional[list] = None, rounds=None):
        nonlocal step
        batch = ring[step % len(ring)]
        if timed is not None:
            _sync(device)
            t0 = time.perf_counter()
        with torch.profiler.record_function("trainbench.train_step"):
            state, metrics = trainer.train_step(state, batch)
        if timed is not None:
            _sync(device)
            timed.append(time.perf_counter() - t0)
        if (step + 1) % interval == 0 and rounds is not None:
            _sync(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function("trainbench.round"):
                state = trainer.maybe_sync(state, step, model_mb)
            _sync(device)
            rounds.append(time.perf_counter() - t0)
        else:
            state = trainer.maybe_sync(state, step, model_mb)
        step += 1
        return state, metrics

    # the checked steps: the window's own calls on the ring's first rows
    got = {"loss": [], "grad": None, "change": None, "ef": None}
    for i in range(CHECKED_STEPS):
        state, metrics = one_step(state, rounds=[])
        got["loss"].append(metrics["loss_per_pod"].float().cpu().tolist())
        if i == 0:
            got["grad"] = _pod_norms(state.sync_state.ga_buffer)
        if (i + 1) % interval == 0 and got["ef"] is None \
                and mix["sync"].get("error_feedback"):
            got["ef"] = _ef_norms(state.sync_state.ef_residual, spec,
                                  mix["sync"])
    got["change"] = _diff_norms(state.params,
                                weights.make(spec, seed, device, pdt))
    marks.append(("checked steps", time.perf_counter()))
    # finish the warm-up on a whole interval; the peak counts from here
    while step % interval:
        state, _ = one_step(state, rounds=[])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(interval):
        state, _ = one_step(state, rounds=[])
    if trace:
        # the profiler's first start initialises its tracer: not in a
        # measured stretch
        with _profiler(device):
            for _ in range(interval):
                state, _ = one_step(state, rounds=[])
    _sync(device)

    # ----------------------------------------------------------- window
    steps_s: List[float] = []
    rounds_s: List[float] = []
    losses = []
    t_window = time.perf_counter()
    marks.append(("warm-up", t_window))
    setup_s = t_window - t_start
    n_steps = 0
    while True:
        for _ in range(interval):
            state, metrics = one_step(state, steps_s if trace else None,
                                      rounds_s)
            losses.append(metrics["loss_per_pod"])
            n_steps += 1
        if time.perf_counter() - t_window >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_window

    timeline = None
    if trace:
        from trainbench.trace import Timeline, events_of
        with _profiler(device) as prof:
            for _ in range(TRACE_CYCLES * interval):
                state, _ = one_step(state, rounds=[])
            _sync(device)
        dev_ev, host_ev = events_of(prof)
        spans = [e for e in host_ev if e[0].startswith("trainbench.")]
        start = min(a for _, a, _ in spans)
        end = max(b for _, _, b in spans)
        timeline = Timeline(dev_ev, host_ev, start, end)

    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(losses))).any(dim=1).sum())
    wire_mb = dict(trainer.wire_mb(state))
    transfers = getattr(trainer.transport, "wan_transfers_per_round",
                        None) or P
    del state, trainer, prog, losses, metrics
    checked = ring[:CHECKED_STEPS]
    del ring
    if device == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------ the comparison
    with no_tf32():
        ref = Reference(spec, mix).run(weights.make(spec, seed, device, pdt),
                                       checked)
    numbers = compare(got, ref)
    checks = {k: (v, cell.limits.get(k)) for k, v in numbers.items()}
    correct = all(lim is None or (math.isfinite(v) and v <= lim)
                  for v, lim in checks.values()) and failed == 0

    tokens = int(mix["global_batch"]) * int(mix["seq"])
    if trace:
        from trainbench import counts
        ctx = {"cell": cell, "spec": spec, "mix": mix, "steps_s": steps_s,
               "rounds_s": rounds_s, "window_s": window_s,
               "n_steps": n_steps, "timeline": timeline, "wire_mb": wire_mb,
               "transfers": transfers, "counts": counts,
               "param_bytes": pdt.itemsize}
        metrics_out = {}
        for name in cell.metrics:
            value, unit = read_metric(name, ctx)
            if value is not None:
                metrics_out[name] = {"value": value, "unit": unit}
    else:
        metrics_out = {
            "train_tokens_per_s": {"value": n_steps * tokens / window_s,
                                   "unit": "tokens/s"},
            "sync_round_ms_p90": {"value": p90(rounds_s) * 1e3,
                                  "unit": "ms"},
            "peak_device_gb": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result = {"correct": bool(correct), "attempted": n_steps,
              "failed": failed, "metrics": metrics_out,
              "device": device_info(device, peak)}
    if timeline is not None:
        from trainbench.trace import top
        result["device"]["busy_s"] = timeline.busy_s
        result["device"]["window_s"] = timeline.window_s
        result["breakdown"] = {"device_ops": top(timeline.op_seconds()),
                               "idle_gaps": top(timeline.idle_by_host())}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    setup = [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]
    return Outcome(result, checks, got, ref, setup)


def p90(values: List[float]) -> float:
    """The 90th percentile, as ``statistics.quantiles`` (exclusive) cuts."""
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=10)[-1]


def _profiler(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read_metric(name: str, ctx: dict):
    """``trainbench/metrics/<name>.py``'s ``read(ctx)`` and its ``UNIT``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"trainbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx), mod.UNIT


def device_info(device: str, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
