"""Adaptive WAN sync autotuner: per-bucket precision/sparsity controller.

The paper's headline speedup comes from *matching* the sync strategy to WAN
conditions — but its WAN exhibits "low bandwidth and high fluctuations", so a
launch-time choice of ``compress_topk`` / payload tier / ``interval`` is
wrong whenever the network moves.  This module closes the loop the ROADMAP
calls for ("per-bucket adaptive compress_topk from gradient statistics"):

  signals                        decision                      reconfig
  ───────                        ────────                      ────────
  BucketStats (EF-residual       AdaptiveSyncController        SyncPlanUpdate
  ratio + top-k energy capture,  walks a payload-aggression    -> Trainer.retune
  from SyncState.msg_norm /      ladder (compress_topk x       at the next sync
  resid_norm)                    value_dtype rungs, sorted     barrier (EF
  WanProbe (achieved bandwidth   by wire bytes) under a        residual carries
  EMA + fluctuation, from the    user-set convergence guard,   over — dense
  simulator / --wan-trace /      and sizes ``interval`` so     bucket coords
  EventBus bandwidth_changed —   per-step blocking comm        are tier-free)
  or, in measured mode, from     stays on target
  transport-reported transfer
  times via repro_torch.core
  .transport.MeasuredWanProbe feeding an
  injected ``probe_est``)

Control law (deterministic, hysteresis-damped):

- **Convergence guard** (the hard rule): the EF-residual ratio
  ``||resid|| / ||message||`` is ``sqrt(1 - energy_capture)`` of the last
  sync — structurally in [0, 1), rising toward 1 as the tier drops more
  than error feedback can re-ship per interval.  If it reaches ``ef_guard``
  the controller *immediately* de-escalates one rung, and it never
  escalates unless the ratio is below ``escalate_margin * ef_guard``.
  This is the invariant the property tests pin: under NO input sequence
  does the controller escalate while the guard is tripped.  (Scale note:
  with error feedback a ratio of ~0.85 is *healthy* — the codec benches
  hit 99.9% of dense loss reduction there, because everything dropped is
  re-shipped next interval — so guards live near 1 and the escalation
  margin is deliberately thin.)
- **WAN pressure**: from the bandwidth EMA the controller estimates the
  blocking sync time ``payload * 8 / bw`` and fits the smallest interval
  keeping its per-step share at ``target_comm_frac`` of compute.  The fit
  is bounded by a **staleness budget** (``interval_budget``, default the
  base config's interval x2): when the fitted interval busts the budget for
  ``hysteresis`` consecutive updates — i.e. only *more staleness* could
  absorb the bandwidth drop — the controller escalates, jumping straight
  to the least aggressive rung whose fit respects the budget (transit
  rungs would each pay a transfer on the slow link); when the fit falls
  far below budget for a 4x longer streak it de-escalates one rung to
  buy back fidelity.  Fluctuation (EMA coefficient of variation) inflates
  the pressure estimate the same way the paper observes fluctuations eat
  half the ideal reduction.  Only at the *last* rung may the interval
  exceed the budget (escape valve, capped at ``max_interval``).
- **Interval sizing** is the §III.C frequency knob driven by the same
  probe, so elasticity reconfigs (which also touch the interval via
  ``adapt_interval``) and codec retuning share one control plane: the
  controller subscribes to the PR-1 ``EventBus`` and consumes the exact
  ``bandwidth_changed`` events the :class:`ElasticityController` sees.

HeterPS (arXiv:2111.10635) frames this knob-tuning as feedback scheduling;
TAAR (arXiv:2404.11352) shows network-aware adaptation is where the
remaining WAN wins live.  ``benchmarks/autotune.py`` measures the payoff:
time-to-target-loss on a fluctuating-bandwidth trace vs the best *static*
codec config, guard never violated.

A copy of the whole of ``repro/core/autotune.py``.  The one change is where
the telemetry comes from: ``SyncState.msg_norm`` / ``resid_norm`` are
tensors on the trainer's device, and :func:`bucket_stats_from_sync_state`
reads both to the host in one copy per update, not one per bucket.  A
retune in the port is ``Trainer.retune`` (no compile: the next round runs
at the new rung).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sync import BucketOverride, CODEC_TIERS, SyncConfig

_EPS = 1e-12


@dataclass(frozen=True)
class BucketStats:
    """Per-bucket gradient statistics from the last codec sync round.

    Built from ``SyncState.msg_norm`` / ``resid_norm`` (the sync round
    computes both on the device; the host reads them once per update).
    A ``msg_norm`` of 0 means "no reading yet" (first interval, or right
    after a pod resize re-armed the telemetry) — the controller then holds
    its rung and only retunes the interval.
    """

    msg_norm: float
    resid_norm: float

    @property
    def ef_ratio(self) -> float:
        """||residual|| / ||message|| — sqrt(1 - energy captured), in [0, 1)."""
        return self.resid_norm / (self.msg_norm + _EPS)

    @property
    def energy_capture(self) -> float:
        """Fraction of message energy the codec shipped last sync."""
        return max(0.0, 1.0 - self.ef_ratio ** 2)

    @classmethod
    def from_sync_state(cls, sync_state,
                        bucket: Optional[int] = None) -> "BucketStats":
        """Worst-pod reading: the pod whose residual ratio is highest
        governs (its model replica is the one compression hurts most).

        ``SyncState`` telemetry is (n_pods, n_buckets); ``bucket`` selects
        one column, ``None`` takes the worst entry across all buckets (the
        single-controller view of a possibly-partitioned payload)."""
        return cls.from_norms(*_host_norms(sync_state), bucket=bucket)

    @classmethod
    def from_norms(cls, msg: np.ndarray, res: np.ndarray,
                   bucket: Optional[int] = None) -> "BucketStats":
        """:meth:`from_sync_state` on norms already on the host (f64)."""
        if bucket is not None and msg.ndim == 2:
            msg, res = msg[:, bucket], res[:, bucket]
        msg, res = msg.ravel(), res.ravel()
        keep = msg > 0.0          # empty buckets / no reading yet
        if msg.size == 0 or not keep.any():
            return cls(msg_norm=0.0, resid_norm=0.0)
        msg, res = msg[keep], res[keep]
        worst = int(np.argmax(res / (msg + _EPS)))
        return cls(msg_norm=float(msg[worst]), resid_norm=float(res[worst]))


def _host_norms(sync_state) -> Tuple[np.ndarray, np.ndarray]:
    """``(msg_norm, resid_norm)`` as f64 host arrays.  Device tensors come
    over in one copy (the two stacked, then one ``.cpu()``); the f32 ->
    f64 widening is exact, as the reference's ``np.asarray`` is."""
    msg, res = sync_state.msg_norm, sync_state.resid_norm
    if isinstance(msg, torch.Tensor):
        both = torch.stack([msg.detach().float(),
                            res.detach().float()]).cpu().double().numpy()
        return both[0], both[1]
    return (np.asarray(msg, dtype=np.float64),
            np.asarray(res, dtype=np.float64))


def bucket_stats_from_sync_state(sync_state, names: Sequence[str]
                                 ) -> Dict[str, BucketStats]:
    """One worst-pod :class:`BucketStats` per named bucket group — the
    :class:`BucketedSyncController`'s input (``names`` in segment order,
    i.e. ``SyncConfig.bucket_names``)."""
    msg, res = _host_norms(sync_state)
    return {name: BucketStats.from_norms(msg, res, bucket=g)
            for g, name in enumerate(names)}


class WanProbeEstimator:
    """Bandwidth EMA + fluctuation estimator, shareable across controllers.

    The per-bucket controller holds ONE of these for all bucket rungs (the
    WAN does not care which bucket's bytes it carries), and the single-
    bucket controller embeds its own; both consume the same achieved-
    bandwidth samples (simulator, ``--wan-trace``, or ``bandwidth_changed``
    events off the control-plane bus).

    ``cliff_snap`` (off at 0): when a sample comes in more than
    ``cliff_snap``x BELOW the EMA, the belief snaps to the sample instead
    of averaging toward it — smoothing exists for noise, and a bandwidth
    collapse is not noise.  The fluctuation estimate still absorbs the
    full deviation first (a cliff IS fluctuation), and recoveries stay
    smoothed (optimism is what the EMA protects against).  The
    multi-bucket controller enables this by default, so one observation
    of a crashed link reprices every bucket's escalation before the next
    transfer is paid."""

    def __init__(self, alpha: float = 0.5, cliff_snap: float = 0.0):
        self.alpha = alpha
        self.cliff_snap = cliff_snap
        self._ema: Optional[float] = None
        self._var: float = 0.0        # EMA of squared relative deviation

    def observe(self, bandwidth_mbps: float) -> "WanProbe":
        b = float(bandwidth_mbps)
        if self._ema is None:
            self._ema = b
        else:
            rel = (b - self._ema) / (self._ema + _EPS)
            self._var += self.alpha * (rel * rel - self._var)
            if self.cliff_snap > 0 and b * self.cliff_snap < self._ema:
                self._ema = b
            else:
                self._ema += self.alpha * (b - self._ema)
        return self.probe

    @property
    def bandwidth_mbps(self) -> Optional[float]:
        return self._ema

    @property
    def probe(self) -> "WanProbe":
        return WanProbe(
            bandwidth_mbps=self._ema if self._ema is not None else 0.0,
            fluctuation=self._var ** 0.5)


@dataclass(frozen=True)
class WanProbe:
    """Smoothed WAN picture: bandwidth EMA + fluctuation (EMA coefficient
    of variation), fed by the simulator, a ``--wan-trace``, or
    ``bandwidth_changed`` events off the control-plane ``EventBus``."""

    bandwidth_mbps: float
    fluctuation: float = 0.0


def trend_tripped(trend: Sequence[float], window: int, rise: float,
                  guard: float) -> bool:
    """The residual *growth-trend* guard predicate, shared by both
    controllers so the single- and multi-bucket control laws cannot drift:
    a full ``window`` of strictly rising fresh EF-ratio readings whose
    extrapolation (one more window at the observed rise) would cross the
    absolute ``guard``.  Catches a slowly diverging rung *before* the
    bound trips — by which point an interval's worth of gradient mass is
    already stuck in the residual — while staying quiet on noise (any dip
    resets the run) and on benign drift far below the guard (the
    extrapolation test)."""
    if len(trend) < window:
        return False
    win = list(trend[-window:])
    total = win[-1] - win[0]
    return (total >= rise
            and all(y > x for x, y in zip(win, win[1:]))
            and win[-1] + total >= guard)


@dataclass(frozen=True)
class SyncPlanUpdate:
    """Controller output: the retuned config plus why — applied through
    ``Trainer.retune`` at the next sync barrier, mirroring how the
    elasticity engine applies its ``ReconfigPlan``."""

    sync: SyncConfig
    step: int
    rung: int                      # index into the controller's ladder
    tier: int                      # index into sync.CODEC_TIERS
    reason: str
    probe: Optional[WanProbe] = None
    stats: Optional[BucketStats] = None
    topology: Optional[str] = None  # active aggregation shape, when a
    #   TopologyPlanner is wired in (the third actuator)

    def summary(self) -> str:
        s = self.sync
        out = (f"rung {self.rung} ({CODEC_TIERS[self.tier]}"
               f"@topk={s.compress_topk}), interval {s.interval} "
               f"[{self.reason}]")
        if self.topology is not None:
            out += f" topo={self.topology}"
        return out


def build_ladder(base: SyncConfig,
                 topk_ladder: Sequence[float],
                 dtype_ladder: Sequence[str]) -> Tuple[SyncConfig, ...]:
    """The aggression ladder: every (compress_topk, value_dtype) combination
    of the candidate lists, sorted by wire bytes descending (rung 0 ships
    the most, the last rung the least).  Payload breaks ties toward the
    higher-precision dtype so equal-byte rungs (int8 vs fp8) still order
    deterministically, int8 first — one rung is always a strict (or
    precision-equivalent) de-escalation from the next."""
    rungs = [replace(base, compress_topk=f, value_dtype=d)
             for f in topk_ladder for d in dtype_ladder]
    return tuple(sorted(
        rungs, key=lambda c: (-c.payload_mb(1.0),
                              CODEC_TIERS.index(c.value_dtype))))


class AdaptiveSyncController:
    """Closed-loop per-bucket codec tuner (see module docstring).

    The controller is host-side and pure-Python: it never touches device
    values, so a retune is a swap of the trainer's sync config at a
    barrier (``Trainer.retune``), as the elasticity engine swaps plans.
    """

    def __init__(self, base_sync: SyncConfig, model_mb: float,
                 compute_step_s: float, *,
                 ef_guard: float = 0.9,
                 escalate_margin: float = 0.95,
                 target_comm_frac: float = 0.25,
                 topk_ladder: Sequence[float] = (0.05, 0.02, 0.01),
                 dtype_ladder: Sequence[str] = ("int8", "fp8", "int4"),
                 min_interval: int = 1, interval_budget: Optional[int] = None,
                 max_interval: int = 64,
                 hysteresis: int = 2, probe_alpha: float = 0.5,
                 trend_window: int = 4, trend_rise: float = 0.02,
                 probe_est: Optional[WanProbeEstimator] = None,
                 topology=None, bus=None):
        if not base_sync.uses_codec:
            raise ValueError(
                "AdaptiveSyncController tunes the fused codec: base_sync "
                "must have strategy='asgd_ga', 0 < compress_topk < 1 and "
                "quantize_int8=True")
        if not base_sync.error_feedback:
            raise ValueError(
                "AdaptiveSyncController's convergence guard is defined on "
                "the EF residual: base_sync must set error_feedback=True")
        if not 0.0 < ef_guard < 1.0:
            raise ValueError("ef_guard is a bound on ||resid||/||msg|| — "
                             "structurally in (0, 1)")
        if not 0.0 < escalate_margin <= 1.0:
            raise ValueError("escalate_margin must be in (0, 1]")
        if trend_window < 2:
            raise ValueError("trend_window must be >= 2 (a slope needs at "
                             "least two readings)")
        self.model_mb = model_mb
        self.compute_step_s = compute_step_s
        self.ef_guard = ef_guard
        self.escalate_margin = escalate_margin
        self.target_comm_frac = target_comm_frac
        self.min_interval = min_interval
        self.interval_budget = (interval_budget if interval_budget is not None
                                else max(1, 2 * base_sync.interval))
        self.max_interval = max(max_interval, self.interval_budget)
        self.hysteresis = hysteresis
        self.probe_alpha = probe_alpha
        self.trend_window = trend_window
        self.trend_rise = trend_rise

        self.ladder = build_ladder(base_sync, topk_ladder, dtype_ladder)
        # start at the rung matching the base config (exact knob match if
        # present, else the closest payload), with the base interval
        self.rung = min(
            range(len(self.ladder)),
            key=lambda i: abs(self.ladder[i].payload_mb(1.0)
                              - base_sync.payload_mb(1.0)))
        self.interval = base_sync.interval
        self.current = replace(self.ladder[self.rung],
                               interval=self.interval)

        self._probe_est = (probe_est if probe_est is not None
                           else WanProbeEstimator(alpha=probe_alpha))
        # third actuator (duck-typed to avoid a core.topology import
        # cycle): anything with .kind and .decide(step, payload_mb) — in
        # practice a topology.TopologyPlanner sharing the transport's
        # LinkBeliefs
        self.topology = topology
        self._pressure_streak = 0
        self._calm_streak = 0
        self._last_stats: Optional[Tuple[float, float]] = None
        self._trend: List[float] = []  # fresh EF-ratio readings, newest last
        self.decisions: List[SyncPlanUpdate] = []
        self.max_ef_ratio = 0.0        # worst guard reading ever observed
        if bus is not None:
            bus.subscribe("bandwidth_changed", self.handle)

    # ------------------------------------------------------------- probes
    @property
    def _bw_ema(self) -> Optional[float]:
        return self._probe_est.bandwidth_mbps

    def observe_wan(self, bandwidth_mbps: float) -> WanProbe:
        """Fold an achieved-bandwidth sample into the EMA + fluctuation."""
        return self._probe_est.observe(bandwidth_mbps)

    def handle(self, event) -> None:
        """EventBus subscriber — same ``bandwidth_changed`` CloudEvents the
        ElasticityController consumes (one control plane, two actuators:
        it re-plans resources, this retunes the codec)."""
        if getattr(event, "bandwidth_mbps", None) is not None:
            self.observe_wan(event.bandwidth_mbps)

    @property
    def probe(self) -> WanProbe:
        return self._probe_est.probe

    # -------------------------------------------------- growth-trend guard
    def _trend_tripped(self) -> bool:
        """See :func:`trend_tripped` (shared with the bucketed law)."""
        return trend_tripped(self._trend, self.trend_window,
                             self.trend_rise, self.ef_guard)

    def resync(self, cfg: SyncConfig) -> None:
        """Re-anchor the belief state to an externally applied config.

        The elasticity engine shares the control plane and may rewrite the
        live sync settings (``adapt_interval`` in a reconfig); without
        re-anchoring, the controller would keep reasoning about knobs that
        are no longer the ones running — and emit no update because *its*
        state never changed."""
        self.rung = min(
            range(len(self.ladder)),
            key=lambda i: abs(self.ladder[i].payload_mb(1.0)
                              - cfg.payload_mb(1.0)))
        self.interval = cfg.interval
        self.current = replace(self.ladder[self.rung], interval=cfg.interval)
        self._pressure_streak = self._calm_streak = 0
        self._trend.clear()   # readings under the old knobs say nothing
        #   about the drift of the rung now running

    # ----------------------------------------------------------- decision
    def _comm_frac(self, cfg: SyncConfig) -> float:
        """Blocking share of one interval's wall clock under the current
        probe; fluctuation inflates it (a fluctuating link needs headroom —
        the paper: half the ideal reduction survives fluctuations)."""
        if self._bw_ema is None or self._bw_ema <= 0:
            return 0.0
        t_sync = cfg.payload_mb(self.model_mb) * 8.0 / self._bw_ema
        t_sync *= 1.0 + self.probe.fluctuation
        t_compute = max(cfg.interval, 1) * self.compute_step_s
        return t_sync / (t_sync + t_compute + _EPS)

    def _fit_interval(self, cfg: SyncConfig) -> int:
        """Smallest interval keeping the blocking share at/below target."""
        if self._bw_ema is None or self._bw_ema <= 0:
            return cfg.interval
        t_sync = (cfg.payload_mb(self.model_mb) * 8.0 / self._bw_ema
                  * (1.0 + self.probe.fluctuation))
        f = self.target_comm_frac
        want = t_sync * (1.0 - f) / (f * self.compute_step_s + _EPS)
        return max(self.min_interval,
                   min(self.max_interval, math.ceil(want)))

    def update(self, step: int, stats: BucketStats
               ) -> Optional[SyncPlanUpdate]:
        """One control step, called at a sync barrier with that round's
        bucket statistics.  Returns a plan update when any knob moved."""
        have_reading = stats.msg_norm > 0.0
        # consume-once: stats only change at sync rounds, but update() runs
        # every step — a reading may only *trigger* the guard the step it
        # arrives, or one bad sync would de-escalate a rung per step until
        # the next sync, punishing rungs that were never measured.  (It
        # still *gates* escalation while stale: absence of fresh evidence
        # is not evidence of calm.)
        fresh = (have_reading
                 and (stats.msg_norm, stats.resid_norm) != self._last_stats)
        if fresh:
            self._last_stats = (stats.msg_norm, stats.resid_norm)
        ratio = stats.ef_ratio if have_reading else 0.0
        if fresh:
            self.max_ef_ratio = max(self.max_ef_ratio, ratio)
            self._trend.append(ratio)
            if len(self._trend) > self.trend_window:
                del self._trend[0]

        rung, reason = self.rung, ""
        if fresh and ratio >= self.ef_guard:
            # convergence guard tripped: de-escalate NOW, no hysteresis —
            # never trade fidelity away while EF is drowning
            rung, reason = max(0, self.rung - 1), "ef-guard"
            self._pressure_streak = self._calm_streak = 0
        elif fresh and self.rung > 0 and self._trend_tripped():
            # growth-trend guard: the ratio is strictly rising toward the
            # bound — step back one rung while the residual is still
            # recoverable instead of waiting for the absolute trip
            rung, reason = self.rung - 1, "ef-trend"
            self._pressure_streak = self._calm_streak = 0
        else:
            fit = self._fit_interval(self.ladder[self.rung])
            if fit > self.interval_budget:
                # only more staleness could absorb the link: rung pressure
                self._pressure_streak += 1
                self._calm_streak = 0
            elif fit <= max(self.min_interval, self.interval_budget // 2):
                self._calm_streak += 1
                self._pressure_streak = 0
            else:
                self._pressure_streak = self._calm_streak = 0
            guard_calm = (have_reading
                          and ratio < self.escalate_margin * self.ef_guard)
            if (self._pressure_streak >= self.hysteresis and guard_calm
                    and self.rung + 1 < len(self.ladder)):
                # escalation is urgent (every sync at the stale rung pays
                # the slow link): jump straight to the least aggressive
                # rung whose fitted interval respects the staleness
                # budget, instead of paying a transfer per transit rung
                rung = next(
                    (i for i in range(self.rung + 1, len(self.ladder))
                     if self._fit_interval(self.ladder[i])
                     <= self.interval_budget),
                    len(self.ladder) - 1)
                reason = "wan-pressure"
                self._pressure_streak = 0
            elif (self._calm_streak >= 4 * self.hysteresis and self.rung > 0
                  and self._fit_interval(self.ladder[self.rung - 1])
                  <= self.interval_budget):
                # de-escalation is a luxury (fidelity, not survival): one
                # rung at a time, on a 4x longer streak — cheap insurance
                # against ping-ponging on a link that is merely twitchy
                rung, reason = self.rung - 1, "wan-headroom"
                self._calm_streak = 0

        # third actuator: consult the topology planner on fresh readings
        # only, and never while a guard is de-escalating — a tripped EF
        # guard means fidelity is the problem, and reshaping the network
        # in the same breath would blur which actuator fixed it
        topo = None
        if (self.topology is not None and fresh
                and reason not in ("ef-guard", "ef-trend")):
            topo = self.topology.decide(
                step, self.ladder[rung].payload_mb(self.model_mb))

        cfg = self.ladder[rung]
        # the staleness budget caps the interval at every rung but the
        # last, where it is the escape valve for a link no tier can absorb
        cap = (self.max_interval if rung == len(self.ladder) - 1
               else self.interval_budget)
        interval = min(self._fit_interval(cfg), cap)
        if rung == self.rung:
            # deadband: don't churn retunes on small EMA wiggle — retune
            # the interval alone only when it moves by >= 25%
            if interval == self.interval or (
                    not reason
                    and abs(interval - self.interval)
                    < max(1.0, 0.25 * self.interval)):
                if topo is None:
                    return None
                # topology-only move: the codec knobs stand as they are
                interval = self.interval
        if not reason:
            reason = f"topo-{topo}" if topo is not None else "interval-fit"
        if rung != self.rung:
            self._trend.clear()   # new rung, new drift regime
        self.rung = rung
        self.interval = interval
        self.current = replace(cfg, interval=interval)
        update = SyncPlanUpdate(
            sync=self.current, step=step, rung=rung,
            tier=self.current.tier, reason=reason,
            probe=self.probe, stats=stats if have_reading else None,
            topology=(self.topology.kind if self.topology is not None
                      else None))
        self.decisions.append(update)
        return update


# ---------------------------------------------------------------------------
# per-bucket control: one rung per layer-class bucket group
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BucketPlanUpdate:
    """Multi-bucket controller output: the combined retuned config (per-
    bucket overrides + shared interval) plus which bucket moved and why —
    applied through ``Trainer.retune`` exactly like a single-bucket
    :class:`SyncPlanUpdate`."""

    sync: SyncConfig
    step: int
    rungs: Tuple[Tuple[str, int, int], ...]   # (bucket, rung, tier) each
    reasons: Tuple[str, ...]
    probe: Optional[WanProbe] = None
    topology: Optional[str] = None  # active aggregation shape, when a
    #   TopologyPlanner is wired in (the third actuator)

    def summary(self) -> str:
        knobs = ", ".join(
            f"{name}={CODEC_TIERS[tier]}@r{rung}"
            for name, rung, tier in self.rungs)
        out = (f"[{knobs}], interval {self.sync.interval} "
               f"[{'; '.join(self.reasons)}]")
        if self.topology is not None:
            out += f" topo={self.topology}"
        return out


class _BucketRung:
    """One bucket group's ladder position + guard state (the per-bucket
    slice of what :class:`AdaptiveSyncController` tracks globally)."""

    def __init__(self, name: str, ladder: Tuple[SyncConfig, ...],
                 rung: int, model_mb: float):
        self.name = name
        self.ladder = ladder
        self.rung = rung
        self.model_mb = model_mb
        self.last_stats: Optional[Tuple[float, float]] = None
        self.trend: List[float] = []
        self.ratio = 0.0              # last observed EF ratio
        self.has_reading = False
        self.max_ef_ratio = 0.0

    def payload_mb(self, rung: Optional[int] = None) -> float:
        r = self.rung if rung is None else rung
        return self.ladder[r].payload_mb(self.model_mb)

    @property
    def cfg(self) -> SyncConfig:
        return self.ladder[self.rung]


class BucketedSyncController:
    """Per-bucket adaptive codec control: one aggression-ladder rung per
    layer-class bucket group, one shared WAN picture.

    The split follows the physics: gradient statistics (and therefore how
    much compression a tensor tolerates) are a property of the *layer
    class* — embeddings, norms, dense bulk, MoE experts — while bandwidth
    is a property of the *link*.  So EF statistics, ladders, trend state
    and guards are per bucket, and the bandwidth probe/EMA, pressure
    streaks and the sync interval are shared:

    - **Guards are per bucket and autonomous**: a bucket whose EF ratio
      trips ``ef_guard`` (or whose ratio is trending into it — the
      growth-trend guard) de-escalates *that bucket only*, immediately.
      Other buckets keep their aggression: the whole point is not paying
      embed-grade fidelity for norm-grade sensitivity.
    - **WAN pressure is shared and escalation is greedy-by-bytes**: when
      the fitted interval (from the summed per-bucket payloads) busts the
      staleness budget for ``hysteresis`` updates, the controller
      escalates guard-calm buckets one rung at a time in order of wire
      bytes saved, until the fit respects the budget — the cheapest
      fidelity is traded first, and a guard-stressed bucket is never
      escalated regardless of pressure.
    - **Headroom returns fidelity where it hurts most**: on a long calm
      streak the bucket with the highest observed EF ratio de-escalates
      first.
    - **One interval**: sync rounds are barriers, so the interval is fitted
      once from the total payload and capped by the staleness budget
      (escape valve only when every bucket sits at its last rung).

    The controller is host-side and deterministic; ``benchmarks/autotune``
    records its per-bucket signal stream so ``check_regression`` replays
    the multi-controller trace in CI.
    """

    def __init__(self, base_sync: SyncConfig, bucket_mb: Mapping[str, float],
                 compute_step_s: float, *,
                 ef_guard: float = 0.9,
                 escalate_margin: float = 0.95,
                 target_comm_frac: float = 0.25,
                 topk_ladder: Sequence[float] = (0.05, 0.02, 0.01),
                 dtype_ladder: Sequence[str] = ("int8", "fp8", "int4"),
                 min_interval: int = 1, interval_budget: Optional[int] = None,
                 max_interval: int = 64,
                 hysteresis: int = 2, probe_alpha: float = 0.5,
                 trend_window: int = 4, trend_rise: float = 0.02,
                 cliff_snap: float = 4.0,
                 probe_est: Optional[WanProbeEstimator] = None,
                 topology=None, bus=None):
        if base_sync.bucket_policy != "layer-class":
            raise ValueError(
                "BucketedSyncController drives the layer-class partition: "
                "base_sync must set bucket_policy='layer-class' (for one "
                "flat bucket use AdaptiveSyncController)")
        if not (base_sync.uses_codec and base_sync.error_feedback):
            raise ValueError(
                "BucketedSyncController tunes the fused codec under the EF "
                "guard: base_sync must have strategy='asgd_ga', "
                "0 < compress_topk < 1, quantize_int8=True and "
                "error_feedback=True")
        if not 0.0 < ef_guard < 1.0:
            raise ValueError("ef_guard is a bound on ||resid||/||msg|| — "
                             "structurally in (0, 1)")
        self.compute_step_s = compute_step_s
        self.ef_guard = ef_guard
        self.escalate_margin = escalate_margin
        self.target_comm_frac = target_comm_frac
        self.min_interval = min_interval
        self.interval_budget = (interval_budget if interval_budget is not None
                                else max(1, 2 * base_sync.interval))
        self.max_interval = max(max_interval, self.interval_budget)
        self.hysteresis = hysteresis
        self.trend_window = trend_window
        self.trend_rise = trend_rise
        self.base_sync = base_sync

        # controlled buckets: the groups that actually hold model bytes
        # (a dense-only model has empty embed/moe groups — nothing to tune)
        self.buckets: Dict[str, _BucketRung] = {}
        for name in base_sync.bucket_names:
            mb = float(bucket_mb.get(name, 0.0))
            if mb <= 0.0:
                continue
            ladder = build_ladder(base_sync.for_bucket(name),
                                  topk_ladder, dtype_ladder)
            start = base_sync.for_bucket(name)
            rung = min(range(len(ladder)),
                       key=lambda i: abs(ladder[i].payload_mb(1.0)
                                         - start.payload_mb(1.0)))
            self.buckets[name] = _BucketRung(name, ladder, rung, mb)
        if not self.buckets:
            raise ValueError("bucket_mb holds no positive-size bucket group")

        self.interval = base_sync.interval
        # an injected estimator (probe_est) is how measured-feedback mode
        # works: a transport's MeasuredWanProbe owns the estimator and
        # feeds it achieved-bandwidth samples derived from transfer times,
        # and this controller just reads the shared belief — no trace, no
        # bus events, same control law (mirrors AdaptiveSyncController)
        self._probe_est = (probe_est if probe_est is not None
                           else WanProbeEstimator(alpha=probe_alpha,
                                                  cliff_snap=cliff_snap))
        # third actuator (duck-typed to avoid a core.topology import
        # cycle, same seam as the single-bucket controller): anything with
        # .kind and .decide(step, payload_mb) — a topology.TopologyPlanner
        # sharing the transport's LinkBeliefs
        self.topology = topology
        self._pressure_streak = 0
        self._calm_streak = 0
        self.decisions: List[BucketPlanUpdate] = []
        if bus is not None:
            bus.subscribe("bandwidth_changed", self.handle)

    # ------------------------------------------------------------- probes
    def observe_wan(self, bandwidth_mbps: float) -> WanProbe:
        return self._probe_est.observe(bandwidth_mbps)

    def handle(self, event) -> None:
        if getattr(event, "bandwidth_mbps", None) is not None:
            self.observe_wan(event.bandwidth_mbps)

    @property
    def probe(self) -> WanProbe:
        return self._probe_est.probe

    @property
    def max_ef_ratio(self) -> float:
        """Worst guard reading ever observed across all buckets."""
        return max((b.max_ef_ratio for b in self.buckets.values()),
                   default=0.0)

    @property
    def max_ef_ratio_by_bucket(self) -> Dict[str, float]:
        return {n: b.max_ef_ratio for n, b in self.buckets.items()}

    # ------------------------------------------------------------ assembly
    def _total_payload_mb(self,
                          rungs: Optional[Mapping[str, int]] = None) -> float:
        return sum(b.payload_mb(None if rungs is None else rungs[n])
                   for n, b in self.buckets.items())

    @property
    def current(self) -> SyncConfig:
        """The combined live config: per-bucket overrides on the base."""
        overrides = tuple(
            BucketOverride(name=n,
                           compress_topk=b.cfg.compress_topk,
                           value_dtype=b.cfg.value_dtype)
            for n, b in self.buckets.items())
        return replace(self.base_sync, buckets=overrides,
                       interval=self.interval)

    def resync(self, cfg: SyncConfig) -> None:
        """Re-anchor to an externally applied config (elasticity reconfigs
        rewrite the live sync settings — same contract as the single-bucket
        controller's ``resync``)."""
        for n, b in self.buckets.items():
            eff = cfg.for_bucket(n)
            b.rung = min(range(len(b.ladder)),
                         key=lambda i: abs(b.ladder[i].payload_mb(1.0)
                                           - eff.payload_mb(1.0)))
            b.trend.clear()
        self.interval = cfg.interval
        self._pressure_streak = self._calm_streak = 0

    def _fit_interval(self, payload_mb: float) -> int:
        if self._probe_est.bandwidth_mbps is None \
                or self._probe_est.bandwidth_mbps <= 0:
            return self.interval
        t_sync = (payload_mb * 8.0 / self._probe_est.bandwidth_mbps
                  * (1.0 + self.probe.fluctuation))
        f = self.target_comm_frac
        want = t_sync * (1.0 - f) / (f * self.compute_step_s + _EPS)
        return max(self.min_interval,
                   min(self.max_interval, math.ceil(want)))

    # ----------------------------------------------------------- decision
    def _bucket_guards(self, stats: Mapping[str, BucketStats]) -> List[str]:
        """Per-bucket absolute + growth-trend guards; returns reasons."""
        reasons = []
        self._fresh_any = False   # did ANY bucket deliver a fresh reading
        #   this update — the topology planner's consultation gate
        for n, b in self.buckets.items():
            s = stats.get(n)
            if s is None or s.msg_norm <= 0.0:
                # no CURRENT reading (first interval, or a pod resize just
                # re-armed the telemetry): stale evidence of calm must not
                # license an escalation — same rule as the single-bucket
                # controller, which gates on the reading it was handed
                b.has_reading = False
                continue
            fresh = (s.msg_norm, s.resid_norm) != b.last_stats
            b.ratio, b.has_reading = s.ef_ratio, True
            if not fresh:
                continue
            self._fresh_any = True
            b.last_stats = (s.msg_norm, s.resid_norm)
            b.max_ef_ratio = max(b.max_ef_ratio, s.ef_ratio)
            b.trend.append(s.ef_ratio)
            if len(b.trend) > self.trend_window:
                del b.trend[0]
            if s.ef_ratio >= self.ef_guard:
                if b.rung > 0:
                    b.rung -= 1
                    b.trend.clear()
                reasons.append(f"ef-guard[{n}]")
            elif b.rung > 0 and self._trend_tripped(b):
                b.rung -= 1
                b.trend.clear()
                reasons.append(f"ef-trend[{n}]")
        return reasons

    def _trend_tripped(self, b: _BucketRung) -> bool:
        """See :func:`trend_tripped` (shared with the single-bucket law)."""
        return trend_tripped(b.trend, self.trend_window, self.trend_rise,
                             self.ef_guard)

    def _guard_calm(self, b: _BucketRung) -> bool:
        # absence of a reading gates escalation, exactly like the single-
        # bucket law: no fresh evidence is not evidence of calm
        return (b.has_reading
                and b.ratio < self.escalate_margin * self.ef_guard)

    def _ladder_exhausted(self) -> bool:
        """True when no bucket can shed another byte: each is at its byte
        floor or measured guard-stressed.  A bucket with NO reading and
        cheaper rungs left keeps this False — ignorance opens neither the
        escalation path nor the staleness escape valve."""
        for b in self.buckets.values():
            cur = b.payload_mb(b.rung)
            has_cheaper = any(b.payload_mb(i) < cur
                              for i in range(b.rung + 1, len(b.ladder)))
            if not has_cheaper:
                continue
            if b.has_reading and not self._guard_calm(b):
                continue
            return False
        return True

    def update(self, step: int, stats: Mapping[str, BucketStats]
               ) -> Optional[BucketPlanUpdate]:
        """One control step with this round's per-bucket statistics
        (``bucket_stats_from_sync_state``).  Returns a plan update when any
        bucket's rung or the shared interval moved."""
        before = {n: b.rung for n, b in self.buckets.items()}
        reasons = self._bucket_guards(stats)
        if reasons:
            self._pressure_streak = self._calm_streak = 0
        else:
            fit = self._fit_interval(self._total_payload_mb())
            if fit > self.interval_budget:
                self._pressure_streak += 1
                self._calm_streak = 0
            elif fit <= max(self.min_interval, self.interval_budget // 2):
                self._calm_streak += 1
                self._pressure_streak = 0
            else:
                self._pressure_streak = self._calm_streak = 0
            if self._pressure_streak >= self.hysteresis:
                # greedy escalation: trade the cheapest fidelity first —
                # each candidate bucket jumps to its next *strictly
                # cheaper* rung (byte-equal rungs are no relief on a slow
                # link), largest wire-byte saving wins — until the fit
                # respects the budget.  Guard-stressed buckets never move.
                moved = False
                while (self._fit_interval(self._total_payload_mb())
                       > self.interval_budget):
                    candidates = []
                    for b in self.buckets.values():
                        if not self._guard_calm(b):
                            continue
                        cur = b.payload_mb(b.rung)
                        target = next(
                            (i for i in range(b.rung + 1, len(b.ladder))
                             if b.payload_mb(i) < cur), None)
                        if target is not None:
                            candidates.append(
                                (cur - b.payload_mb(target), b, target))
                    if not candidates:
                        break
                    _, best, target = max(candidates, key=lambda t: t[0])
                    best.rung = target
                    best.trend.clear()
                    reasons.append(f"wan-pressure[{best.name}]")
                    moved = True
                if moved:
                    self._pressure_streak = 0
            elif self._calm_streak >= 4 * self.hysteresis:
                # headroom: one rung of fidelity back, to the bucket the
                # compression is hurting most, if the budget still fits
                candidates = [b for b in self.buckets.values() if b.rung > 0]
                candidates = [
                    b for b in candidates
                    if self._fit_interval(
                        self._total_payload_mb(
                            {n: (bb.rung - 1 if bb is b else bb.rung)
                             for n, bb in self.buckets.items()}))
                    <= self.interval_budget]
                if candidates:
                    worst = max(candidates, key=lambda b: b.ratio)
                    worst.rung -= 1
                    worst.trend.clear()
                    reasons.append(f"wan-headroom[{worst.name}]")
                    self._calm_streak = 0

        # the staleness budget caps the interval while fidelity remains to
        # trade; the escape valve opens when the ladder is EXHAUSTED — every
        # bucket is at its floor *or guard-blocked from escalating* (a
        # stressed bucket cannot compress harder, so only staleness can
        # absorb the link; the single-bucket law's "last rung" generalized)
        # third actuator: consult the topology planner on fresh readings
        # only, and never while an EF guard is de-escalating — the exact
        # consultation rule of the single-bucket controller (a tripped
        # guard means fidelity is the problem; reshaping the network in
        # the same breath would blur which actuator fixed it)
        topo = None
        if (self.topology is not None and self._fresh_any
                and not any(r.startswith("ef-") for r in reasons)):
            topo = self.topology.decide(step, self._total_payload_mb())

        fit = self._fit_interval(self._total_payload_mb())
        exhausted = fit > self.interval_budget and self._ladder_exhausted()
        cap = self.max_interval if exhausted else self.interval_budget
        interval = min(fit, cap)
        rung_moved = any(b.rung != before[n]
                         for n, b in self.buckets.items())
        if not rung_moved:
            if interval == self.interval or (
                    not reasons
                    and abs(interval - self.interval)
                    < max(1.0, 0.25 * self.interval)):
                if topo is None:
                    return None
                # topology-only move: the codec knobs stand as they are
                interval = self.interval
        if not reasons:
            reasons.append(f"topo-{topo}" if topo is not None
                           else "interval-fit")
        self.interval = interval
        update = BucketPlanUpdate(
            sync=self.current, step=step,
            rungs=tuple((n, b.rung, b.cfg.tier)
                        for n, b in self.buckets.items()),
            reasons=tuple(reasons), probe=self.probe,
            topology=(self.topology.kind if self.topology is not None
                      else None))
        self.decisions.append(update)
        return update


# ---------------------------------------------------------------------------
# chunk-level control: mid-round retune on first-chunk feedback
# ---------------------------------------------------------------------------


class StreamingShipController:
    """Mid-round retune law: the chunk, not the round, as the unit of WAN
    feedback.

    The round-level controllers above decide at the TOP of a step from the
    *previous* round's measurements — so a bandwidth cliff that lands
    after that decision costs one full stale transfer at the old
    (topk × dtype) tier.  This controller closes that gap: as each shipped
    chunk's measured transfer lands (``MeasuredWanProbe.observe_chunk``),
    it compares achieved vs believed bandwidth, and on a cliff —
    ``achieved * cliff_ratio < believed`` for ``hysteresis`` consecutive
    chunks (default 1: first-chunk feedback) — it picks a cheaper ladder
    rung for the round's *unsent* segments.  The trainer re-encodes only
    those segments (``sync.reencode_unsent``); the EF residual absorbs the
    fidelity delta exactly, so the convergence guards' contract holds.

    Interaction contract with the round-level controllers (the
    consume-once law, property-tested):

    - **Belief is read-only and pre-round**: ``believed`` is the shared
      ``WanProbeEstimator`` belief as it stood when the round opened; the
      estimator folds only at the round barrier, so the decision stream
      replays exactly from the recorded signals.
    - **At most ONE retune per round**, and the retune is *transient* —
      it re-encodes this round's unsent segments only.  The persistent
      ``SyncConfig`` stays owned by the round-level controllers; the
      retuned round's aggregate (shipped MB, seconds) observation
      cliff-snaps the shared belief, so they see the cliff at the next
      barrier and make the durable move.
    - **Guard-block**: no retune while the last observed EF ratio is at
      or above ``escalate_margin * ef_guard`` — a stressed residual gets
      no additional mid-round fidelity drop (same escalation gate as the
      round-level law).
    """

    def __init__(self, base_sync: SyncConfig, model_mb: float, *,
                 cliff_ratio: float = 4.0, hysteresis: int = 1,
                 ef_guard: float = 0.9, escalate_margin: float = 0.95,
                 topk_ladder: Sequence[float] = (0.05, 0.02, 0.01),
                 dtype_ladder: Sequence[str] = ("int8", "fp8", "int4"),
                 probe_est: Optional[WanProbeEstimator] = None):
        if not base_sync.uses_codec:
            raise ValueError(
                "StreamingShipController re-encodes through the fused "
                "codec: base_sync must have strategy='asgd_ga', "
                "0 < compress_topk < 1 and quantize_int8=True")
        if not base_sync.error_feedback:
            raise ValueError(
                "the mid-round retune's convergence story IS the EF "
                "residual (it absorbs the fidelity delta): base_sync must "
                "set error_feedback=True")
        if cliff_ratio <= 1.0:
            raise ValueError(
                f"cliff_ratio must be > 1 (a chunk at believed speed must "
                f"not read as a cliff), got {cliff_ratio}")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.model_mb = model_mb
        self.cliff_ratio = cliff_ratio
        self.hysteresis = hysteresis
        self.ef_guard = ef_guard
        self.escalate_margin = escalate_margin
        self.ladder = build_ladder(base_sync, topk_ladder, dtype_ladder)
        self._probe_est = probe_est
        self._last_ratio: Optional[float] = None
        self._round: Optional[Dict] = None
        self.n_retunes = 0
        self.n_rounds = 0
        self.decisions: List[Dict] = []   # one dict per observed chunk —
        #   the replayable decision stream the bench commits and
        #   check_regression re-runs

    # ------------------------------------------------------------- signals
    def note_stats(self, stats: BucketStats) -> None:
        """Feed the latest round's EF telemetry (guard-block input)."""
        if stats.msg_norm > 0.0:
            self._last_ratio = stats.ef_ratio

    @property
    def believed_mbps(self) -> Optional[float]:
        return (self._probe_est.bandwidth_mbps
                if self._probe_est is not None else None)

    # -------------------------------------------------------------- rounds
    def begin_round(self, step: int, cfg: SyncConfig) -> None:
        """Open a streaming round under the live config ``cfg``: snapshot
        the pre-round belief and locate the rung the round ships at."""
        rung = min(range(len(self.ladder)),
                   key=lambda i: abs(self.ladder[i].payload_mb(1.0)
                                     - cfg.payload_mb(1.0)))
        self._round = {"step": step, "cfg": cfg, "rung": rung,
                       "believed": self.believed_mbps, "streak": 0,
                       "retuned": False, "chunk": 0}
        self.n_rounds += 1

    def observe_chunk(self, bucket: str, chunk_mb: float,
                      seconds: float) -> Optional[SyncConfig]:
        """One landed chunk.  Returns the transient retune config for the
        round's unsent segments when the cliff law fires, else None."""
        rd = self._round
        achieved = (chunk_mb * 8.0 / seconds
                    if chunk_mb > 0.0 and seconds > 0.0 else None)
        believed = rd["believed"]
        action, cfg_to, rung_to = "ship", None, rd["rung"]
        if (not rd["retuned"] and achieved is not None
                and believed is not None
                and achieved * self.cliff_ratio < believed):
            rd["streak"] += 1
            if rd["streak"] < self.hysteresis:
                action = "hold"
            elif (self._last_ratio is not None
                  and self._last_ratio
                  >= self.escalate_margin * self.ef_guard):
                # the residual is already near the guard: shipping the
                # planned fidelity is the cheaper risk
                action = "guard-block"
            else:
                rung_to = self._target_rung(rd["rung"],
                                            achieved / believed)
                if rung_to > rd["rung"]:
                    cfg = rd["cfg"]
                    cheap = self.ladder[rung_to]
                    # transplant only the ladder knobs: buckets overrides,
                    # codec_block (chunk alignment!) and interval stay the
                    # round-level controllers' property
                    cfg_to = replace(cfg,
                                     compress_topk=cheap.compress_topk,
                                     value_dtype=cheap.value_dtype)
                    rd["retuned"] = True
                    rd["rung"] = rung_to
                    self.n_retunes += 1
                    action = "retune"
                else:
                    action = "hold"   # already at/below the needed rung
        elif not rd["retuned"] and achieved is not None:
            rd["streak"] = 0
        self.decisions.append({
            "step": rd["step"], "chunk": rd["chunk"], "bucket": bucket,
            "mb": chunk_mb, "s": seconds, "achieved": achieved,
            "believed": believed, "action": action, "rung": rung_to,
        })
        rd["chunk"] += 1
        return cfg_to

    def _target_rung(self, rung: int, ratio: float) -> int:
        """Least-aggressive rung whose wire bytes shrink at least as much
        as the bandwidth did (``payload_j / payload_i <= achieved /
        believed``), else the cheapest rung — mirrors the round-level
        law's jump-straight-to-the-fitting-rung escalation."""
        cur = self.ladder[rung].payload_mb(self.model_mb)
        for j in range(rung + 1, len(self.ladder)):
            if self.ladder[j].payload_mb(self.model_mb) <= cur * ratio:
                return j
        return len(self.ladder) - 1

    def end_round(self) -> bool:
        """Close the round; returns True when it retuned mid-round."""
        rd, self._round = self._round, None
        return bool(rd and rd["retuned"])
