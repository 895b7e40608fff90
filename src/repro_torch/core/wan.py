"""Event-driven WAN simulator for geo-distributed training timelines.

A copy of the whole of ``repro/core/wan.py`` (host-only: numpy and the
port's ``SyncConfig``), so that the port's controllers, cost model and
paper figures run without JAX and give the reference's numbers float for
float.

SPMD on TPU is bulk-synchronous, so the paper's *asynchronous* wall-clock
behaviour (per-cloud timelines, WAN fluctuation, barrier-vs-no-barrier) is
reproduced here as a discrete-event simulation.  It consumes the same
``SyncConfig`` as the SPMD implementation and the same load model as the
elastic scheduler, and it reproduces the paper's headline measurements
(Fig 3 comm fraction, Fig 8 waiting/cost reduction, Fig 10/11 speedups) from
the paper's own measured inputs (Table I iteration times, Table III gradient
sizes, 100 Mbps WAN).

Per-cloud timeline events per iteration:
  compute(iter) -> [local PS update] -> if sync point: pack + WAN transfer
Synchronous strategies barrier before the transfer; asynchronous strategies
overlap a configurable fraction of the transfer with subsequent compute
(``overlap``): the paper observes roughly half of the ideal reduction is
realized at frequency 4 due to fluctuations, which calibrates the default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sync import SyncConfig, traffic_per_step_mb


@dataclass(frozen=True)
class SimCloud:
    """One training partition (cloud region / pod)."""

    region: str
    iter_time_s: float            # local compute time per training iteration
    units: int = 12               # allocated resource units (cores / chips)
    cost_per_unit_hour: float = 1.0
    load_time_s: float = 0.0      # T_load component of T_process


@dataclass(frozen=True)
class WANConfig:
    bandwidth_mbps: float = 100.0     # paper: Tencent Cloud max inter-region
    latency_s: float = 0.05
    fluctuation: float = 0.25         # lognormal sigma on transfer time
    overlap: float = 0.55             # async strategies: fraction overlapped
    baseline_roundtrip: float = 2.0   # PS push+pull per baseline sync round
    traffic_cost_per_gb: float = 0.0  # optional WAN egress pricing
    seed: int = 0


@dataclass(frozen=True)
class BandwidthTrace:
    """Piecewise-constant WAN bandwidth over time — the fluctuating link the
    adaptive sync controller reacts to (paper: "low bandwidth and high
    fluctuations").

    ``times_s`` must be ascending and start at 0; ``mbps[i]`` holds on
    ``[times_s[i], times_s[i+1])``.  Usable three ways: direct lookup
    (:meth:`at`), injection into the discrete-event simulator
    (:meth:`to_events`), and step-indexed lookup for emulated training
    loops (:meth:`at_step`)."""

    times_s: Tuple[float, ...]
    mbps: Tuple[float, ...]

    def __post_init__(self):
        if len(self.times_s) != len(self.mbps) or not self.times_s:
            raise ValueError("times_s and mbps must be equal-length, non-empty")
        if self.times_s[0] != 0.0:
            raise ValueError("trace must start at t=0")
        if any(b <= 0 for b in self.mbps):
            raise ValueError("bandwidth must be positive")
        if any(a >= b for a, b in zip(self.times_s, self.times_s[1:])):
            raise ValueError("times_s must be strictly ascending")

    def at(self, t_s: float) -> float:
        """Bandwidth in effect at absolute time ``t_s``."""
        i = int(np.searchsorted(np.asarray(self.times_s), t_s, side="right"))
        return self.mbps[max(0, i - 1)]

    def at_step(self, step: int, step_time_s: float) -> float:
        """Bandwidth at the wall-clock of training step ``step``."""
        return self.at(step * step_time_s)

    def to_events(self) -> List[SimEvent]:
        """One ``bandwidth_changed`` SimEvent per segment after the first
        (the first segment is the simulator's starting bandwidth)."""
        return [SimEvent(time_s=t, kind="bandwidth_changed",
                         bandwidth_mbps=b)
                for t, b in zip(self.times_s[1:], self.mbps[1:])]

    @classmethod
    def fluctuating(cls, *, base_mbps: float = 100.0, duration_s: float = 600.0,
                    period_s: float = 30.0, sigma: float = 0.6,
                    floor_mbps: float = 2.0, seed: int = 0
                    ) -> "BandwidthTrace":
        """Lognormal random-walk trace: every ``period_s`` the bandwidth is
        re-drawn as ``base * lognormal(0, sigma)`` mean-reverted halfway to
        the base — fluctuation statistics matching the simulator's per-
        transfer lognormal model, but persistent enough (30 s segments)
        that a controller can react."""
        rng = np.random.default_rng(seed)
        times, vals = [0.0], [base_mbps]
        t = period_s
        while t < duration_s:
            drawn = base_mbps * float(rng.lognormal(0.0, sigma))
            # mean-revert halfway: geometric midpoint of last and drawn
            level = max(floor_mbps, float(np.sqrt(vals[-1] * drawn)))
            times.append(t)
            vals.append(round(level, 2))
            t += period_s
        return cls(times_s=tuple(times), mbps=tuple(vals))


@dataclass(frozen=True)
class SimEvent:
    """External event injected into the discrete-event timeline.

    Kinds: ``bandwidth_changed`` (new WAN bandwidth), ``cloud_left`` (region
    departs, resources released), ``cloud_joined`` (``cloud`` payload comes
    online), ``slowdown`` (region's iter time scaled by ``factor``),
    ``reconfig`` (elasticity engine output: swap in a new cloud set /
    ``SyncConfig`` after a ``pause_s`` reconfiguration stall — checkpoint
    re-stack + re-plan cost — charged to every active region; with
    ``migration=True`` the re-stack is a *live migration* staged from the
    async snapshot engine, so active regions pay only the barrier-aligned
    ``barrier_s`` reconcile and the staged ``migrate_mb`` snapshot bytes
    bill as overlapped background traffic, never as stall),
    ``link_failed`` (the WAN link drops transfers for ``duration_s``: each
    sync round inside the window pays ``n_failures`` failed attempts of
    retry/backoff wall-clock per :func:`retry_schedule`, and the retried
    bytes bill at full cost), and ``pod_crashed`` (region dies mid-run:
    departs like ``cloud_left``, and every survivor stalls ``pause_s`` for
    the barrier rollback + re-stack — billed as reconfig time)."""

    time_s: float
    kind: str                               # see docstring
    region: str = ""
    bandwidth_mbps: Optional[float] = None
    factor: float = 1.0
    cloud: Optional[SimCloud] = None
    clouds: Optional[Sequence[SimCloud]] = None   # reconfig payload
    sync: Optional[SyncConfig] = None             # reconfig payload
    pause_s: float = 0.0
    duration_s: float = 0.0                 # link_failed: outage window
    n_failures: int = 1                     # link_failed: attempts per round
    migration: bool = False                 # reconfig: live-migrated re-stack
    barrier_s: float = 0.0                  # migration: reconcile stall
    migrate_mb: float = 0.0                 # migration: staged snapshot bytes

    _KINDS = ("bandwidth_changed", "cloud_left", "cloud_joined",
              "slowdown", "reconfig", "link_failed", "pod_crashed")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown sim event kind {self.kind!r}")


@dataclass
class CloudTimeline:
    region: str
    compute_s: float = 0.0
    wait_s: float = 0.0               # barrier waiting (sync strategies / BSP)
    comm_s: float = 0.0               # WAN transfer time attributable to training
    comm_blocking_s: float = 0.0      # portion that blocked the critical path
    traffic_mb: float = 0.0
    reconfig_s: float = 0.0           # stall paying for re-plan + re-stacking
    total_s: float = 0.0
    cost: float = 0.0

    @property
    def comm_fraction(self) -> float:
        return self.comm_s / self.total_s if self.total_s else 0.0

    @property
    def wait_fraction(self) -> float:
        return self.wait_s / self.total_s if self.total_s else 0.0


@dataclass
class SimResult:
    clouds: List[CloudTimeline]
    sync_cfg: SyncConfig
    n_reconfigs: int = 0

    @property
    def makespan_s(self) -> float:
        return max(c.total_s for c in self.clouds)

    @property
    def total_cost(self) -> float:
        return sum(c.cost for c in self.clouds)

    @property
    def total_traffic_mb(self) -> float:
        return sum(c.traffic_mb for c in self.clouds)

    def speedup_over(self, other: "SimResult") -> float:
        return other.makespan_s / self.makespan_s


def _transfer_time(size_mb: float, bandwidth_mbps: float, wan: WANConfig,
                   rng: np.random.Generator) -> float:
    """One WAN transfer's wall-clock: bytes/bandwidth + latency, inflated
    by a lognormal fluctuation draw.  This is the simulator's *only*
    notion of transfer physics, shared verbatim by the reference's
    ``repro.core.transport.SimTransport`` (the simulator rehosted behind
    the transport seam) so sim-billed and DES-billed times agree."""
    base = size_mb * 8.0 / bandwidth_mbps + wan.latency_s
    if wan.fluctuation > 0:
        base *= float(rng.lognormal(mean=0.0, sigma=wan.fluctuation))
    return base


#: public alias — the transport layer bills with the simulator's law
transfer_time = _transfer_time


def stream_chunk_time(t_total: float, chunk_mb: float,
                      total_mb: float) -> float:
    """One chunk's share of a round transfer: the pro-rata slice of the
    round's single ``transfer_time`` draw.

    This is the streaming seam's *only* chunk-billing law, shared by
    ``transport.SimTransport`` (per-chunk streaming bills), the
    mid-round-cliff benchmark and the regression replay gate — so a
    recorded chunk-observation stream re-bills exactly from the recorded
    round draw.  Slicing the one draw (instead of drawing per chunk)
    keeps a zero-retune streaming round's wall-clock bit-identical to the
    classic once-per-round bill, and makes the first chunk's achieved
    bandwidth equal the round's achieved bandwidth — the signal the
    streaming controller compares against the belief."""
    if total_mb <= 0.0:
        return 0.0
    return t_total * chunk_mb / total_mb


def stream_chunk_plan(payload_mb: float, n_chunks: int) -> List[float]:
    """Equal-split chunk schedule for billing-only streaming (the DES /
    bench driver, which moves no real payloads): ``n_chunks`` chunks of
    ``payload_mb / n_chunks`` MB each.  The real trainer path derives its
    schedule from the codec's block-aligned ``_chunk_widths`` instead."""
    n = max(1, int(n_chunks))
    return [payload_mb / n] * n


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for one WAN transfer.

    The shared law between the fault-tolerant transports (the
    reference's ``repro.core.faults.ChaosTransport``), the host-seam ship
    loop (``sync.ship_sync_payloads``) and the DES failure events, so every
    layer bills a failed attempt identically.  A transfer running
    ``timeout_factor``× slower than the current bandwidth belief is
    declared failed and retried after an exponentially growing backoff;
    after ``max_retries`` failed retries the peer is declared
    unreachable and the round degrades to the surviving membership."""

    max_retries: int = 3
    timeout_factor: float = 4.0       # belief-relative per-link timeout
    backoff_s: float = 0.5            # first backoff pause
    backoff_base: float = 2.0         # growth per failed attempt
    assume_mbps: float = 100.0        # belief fallback before any sample

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.timeout_factor <= 1.0:
            raise ValueError(
                f"timeout_factor must be > 1 (a transfer at belief speed must "
                f"not time out), got {self.timeout_factor}")
        if self.backoff_s < 0 or self.backoff_base < 1.0:
            raise ValueError(
                f"backoff_s must be >= 0 and backoff_base >= 1, got "
                f"backoff_s={self.backoff_s}, backoff_base={self.backoff_base}")
        if self.assume_mbps <= 0:
            raise ValueError(f"assume_mbps must be > 0, got {self.assume_mbps}")

    def timeout_s(self, expected_s: float) -> float:
        """Per-link timeout budget for a transfer expected to take
        ``expected_s`` at the current belief."""
        return expected_s * self.timeout_factor


def retry_schedule(expected_s: float, policy: RetryPolicy,
                   n_failures: int) -> float:
    """Wall-clock burned by ``n_failures`` failed attempts of one transfer:
    each attempt hangs to its timeout budget
    (``expected_s * timeout_factor``) and then backs off exponentially
    before the next try.  Pure math over its inputs — the DES, the chaos
    transport and the regression replay all call this one function, so a
    recorded retry bill replays exactly after a JSON round-trip."""
    total = 0.0
    for attempt in range(max(0, int(n_failures))):
        total += policy.timeout_s(expected_s)
        total += policy.backoff_s * policy.backoff_base ** attempt
    return total


def _schedule(sync: SyncConfig, model_mb: float, wan: WANConfig):
    payload = sync.payload_mb(model_mb)
    if sync.strategy == "asgd":
        payload *= wan.baseline_roundtrip   # PS push + pull every iteration
    sync_every = 1 if sync.strategy == "asgd" else sync.interval
    # codec chunk-pipelining factor, capped at the number of codec blocks
    # exactly like the real path (sync._chunk_widths): a model smaller
    # than overlap_chunks blocks cannot pipeline more than nb ways
    chunks = 1
    if sync.uses_codec:
        nb = max(1, -(-int(model_mb * 1e6 / 4) // sync.codec_block))
        chunks = max(1, min(sync.overlap_chunks, nb))
    return payload, sync_every, sync.strategy == "sma", chunks


def simulate(
    clouds: Sequence[SimCloud],
    sync: SyncConfig,
    *,
    n_iters: int,
    model_mb: float,
    wan: WANConfig = WANConfig(),
    events: Sequence[SimEvent] = (),
    trace: Optional[BandwidthTrace] = None,
    topology=None,
    topology_links: Optional[Mapping[Tuple[str, str], float]] = None,
    retry: RetryPolicy = RetryPolicy(),
) -> SimResult:
    """Run the discrete-event timeline and return per-cloud accounting.

    ``events`` are external :class:`SimEvent`s (sorted internally) applied at
    iteration boundaries once the lagging active cloud's clock passes their
    ``time_s`` — this is how the elasticity engine's reconfigurations get a
    simulated wall-clock and cost.  With no events the timeline is identical
    to the static simulator.  ``trace`` is sugar for a fluctuating link: its
    segments merge into ``events`` as ``bandwidth_changed`` (its t=0 segment
    overrides ``wan.bandwidth_mbps`` as the starting bandwidth).

    ``topology`` (a ``repro_torch.core.topology.TopologySpec``, duck-typed to
    avoid an import cycle) replaces the flat per-cloud billing with the
    compiled hierarchical schedule: each sync round costs the schedule's
    phases — intra legs at ``topology.intra_mbps`` fabric speed, every WAN
    hop one :func:`transfer_time` draw at that link's bandwidth (the global
    ``bandwidth``, scaled per link by ``topology_links`` — a mapping from
    sorted ``(region_a, region_b)`` pairs to multipliers, links absent
    defaulting to 1.0; asymmetric inter-region networks in one dict).
    Traffic bills ``payload`` per WAN hop to the originating region — the
    exact accounting ``cost.adaptive_traffic_mb(wan_legs=...)`` mirrors.

    Failure events bill through ``retry`` (the same :class:`RetryPolicy`
    law the real fault-tolerant transports use): during a ``link_failed``
    window every flat sync round pays :func:`retry_schedule` of extra
    wall-clock per cloud and bills the retried bytes at full cost; a
    ``pod_crashed`` region departs like ``cloud_left`` and every survivor
    stalls ``pause_s`` (barrier rollback + re-stack), billed as reconfig
    time.  Failure billing models the flat ring only — hierarchical
    rounds reroute around dead links via the topology planner instead.
    """
    rng = np.random.default_rng(wan.seed)
    if trace is not None:
        events = list(events) + trace.to_events()
        wan = replace(wan, bandwidth_mbps=trace.mbps[0])
    active = list(clouds)
    iter_time = {c.region: c.iter_time_s for c in active}
    units = {c.region: c.units for c in active}
    rate = {c.region: c.cost_per_unit_hour for c in active}
    tl = {c.region: CloudTimeline(region=c.region) for c in active}
    clock = {c.region: c.load_time_s for c in active}   # absolute time per cloud
    born = {c.region: 0.0 for c in active}              # start of current life
    ended: Dict[str, float] = {}                        # region -> departure time
    life_s = {c.region: 0.0 for c in active}            # summed lifetimes
    cost_acc = {c.region: 0.0 for c in active}          # summed per-life cost
    for c in active:
        tl[c.region].compute_s += c.load_time_s  # model load counts as local work

    bandwidth = wan.bandwidth_mbps
    payload, sync_every, barrier, chunks = _schedule(sync, model_mb, wan)

    topo_links = {tuple(sorted(k)): float(v)
                  for k, v in (topology_links or {}).items()}

    def _link_bw(a: str, b: str) -> float:
        key = (a, b) if a < b else (b, a)
        return bandwidth * topo_links.get(key, 1.0)

    class _LinkView:
        """Duck-typed LinkBeliefs over the DES link state, so
        ``topology.compile`` sees the simulated network (recompiled each
        sync round — bandwidth events reroute the schedule here exactly
        like measured beliefs do in HierarchicalTransport)."""
        mbps = staticmethod(_link_bw)

    link_view = _LinkView()
    pending = sorted(events, key=lambda e: e.time_s)
    ev_i = 0
    n_reconfigs = 0
    fail_until = 0.0          # link_failed outage window end (absolute time)
    fail_n = 0                # failed attempts each round inside the window

    def _register(c: SimCloud) -> None:
        iter_time[c.region] = c.iter_time_s
        units[c.region] = c.units
        rate[c.region] = c.cost_per_unit_hour
        life_s.setdefault(c.region, 0.0)
        cost_acc.setdefault(c.region, 0.0)

    def _close_life(region: str, end: float) -> None:
        """A region departs (or the job ends): bill its current life."""
        life_s[region] += end - born[region]
        cost_acc[region] += units[region] * rate[region] \
            * (end - born[region]) / 3600.0

    for it in range(n_iters):
        # ---- external events due at this iteration boundary
        while (ev_i < len(pending) and active
               and pending[ev_i].time_s
               <= min(clock[c.region] for c in active)):
            e = pending[ev_i]
            ev_i += 1
            if e.kind == "bandwidth_changed":
                bandwidth = float(e.bandwidth_mbps)
            elif e.kind == "slowdown":
                if e.region in iter_time:
                    iter_time[e.region] *= e.factor
            elif e.kind == "cloud_left":
                for i, c in enumerate(active):
                    if c.region == e.region:
                        _close_life(c.region, clock[c.region])
                        ended[c.region] = clock[c.region]
                        del active[i]
                        break
            elif e.kind == "link_failed":
                fail_until = e.time_s + e.duration_s
                fail_n = max(1, int(e.n_failures))
            elif e.kind == "pod_crashed":
                for i, c in enumerate(active):
                    if c.region == e.region:
                        _close_life(c.region, clock[c.region])
                        ended[c.region] = clock[c.region]
                        del active[i]
                        break
                # survivors stall for the barrier rollback + re-stack
                for c in active:
                    tl[c.region].reconfig_s += e.pause_s
                    clock[c.region] += e.pause_s
            elif e.kind == "cloud_joined":
                c = e.cloud
                if any(x.region == c.region for x in active):
                    continue   # already running
                t_now = min(clock[x.region] for x in active)
                _register(c)
                ended.pop(c.region, None)
                if c.region not in tl:
                    tl[c.region] = CloudTimeline(region=c.region,
                                                 compute_s=c.load_time_s)
                else:   # rejoin: keep the earlier life's accounting
                    tl[c.region].compute_s += c.load_time_s
                born[c.region] = t_now
                clock[c.region] = t_now + c.load_time_s
                active.append(c)
            elif e.kind == "reconfig":
                n_reconfigs += 1
                # barrier to the slowest, then everyone stalls for the
                # re-stack: the full checkpointed pause (legacy), or — for
                # a live migration — only the barrier-aligned reconcile
                # (the snapshot staging and the re-plan overlapped with
                # compute, so their bytes bill as background traffic and
                # their time never reaches the clock)
                stall = e.barrier_s if e.migration else e.pause_s
                t_bar = max(clock[c.region] for c in active)
                for c in active:
                    tl[c.region].wait_s += t_bar - clock[c.region]
                    tl[c.region].reconfig_s += stall
                    clock[c.region] = t_bar + stall
                t_bar += stall
                if e.migration and e.migrate_mb > 0.0 and active:
                    # staged snapshot shipment: billed once, to the
                    # coordinating (first active) region's meter
                    tl[active[0].region].traffic_mb += e.migrate_mb
                if e.sync is not None:
                    sync = e.sync
                    payload, sync_every, barrier, chunks = \
                        _schedule(sync, model_mb, wan)
                if e.clouds is not None:
                    new = list(e.clouds)
                    keep = {c.region for c in new}
                    for c in active:
                        if c.region not in keep:
                            _close_life(c.region, t_bar)
                            ended[c.region] = t_bar
                    for c in new:
                        _register(c)
                        if c.region in ended:   # rejoin: a new billed life
                            ended.pop(c.region)
                            born[c.region] = t_bar
                            clock[c.region] = t_bar + c.load_time_s
                            tl[c.region].compute_s += c.load_time_s
                        elif c.region not in tl:
                            tl[c.region] = CloudTimeline(
                                region=c.region, compute_s=c.load_time_s)
                            born[c.region] = t_bar
                            clock[c.region] = t_bar + c.load_time_s
                        else:   # continuing region, life uninterrupted
                            clock[c.region] = t_bar
                    active = new
        if not active:
            break

        # local compute
        for c in active:
            clock[c.region] += iter_time[c.region]
            tl[c.region].compute_s += iter_time[c.region]

        if (it + 1) % sync_every:
            continue

        # ---- synchronization point
        if barrier:
            # all partitions align to the slowest before exchanging
            t_bar = max(clock[c.region] for c in active)
            for c in active:
                tl[c.region].wait_s += t_bar - clock[c.region]
                clock[c.region] = t_bar

        if topology is not None:
            # hierarchical round: the compiled schedule is the billing —
            # phases in sequence, legs within a phase in parallel (the
            # phase costs its slowest leg), every WAN hop one transfer
            # draw at its own link's bandwidth
            sched = topology.compile(link_view)
            t_round = 0.0
            for phase in sched.phases:
                if not phase.legs:
                    continue
                if not phase.wan:
                    t_round += payload * 8.0 / topology.intra_mbps
                    continue
                t_round += max(
                    sum(_transfer_time(payload, _link_bw(a, b), wan, rng)
                        for a, b in leg.hops)
                    for leg in phase.legs)
            # traffic: one payload per WAN hop, billed to the leg's
            # originating region (aux routes pay both hops); legs from
            # topology regions with no simulated cloud spread evenly
            share = {c.region: 0.0 for c in active}
            for ph in sched.phases:
                if not ph.wan:
                    continue
                for leg in ph.legs:
                    mb = payload * len(leg.hops)
                    if leg.src in share:
                        share[leg.src] += mb
                    else:
                        for c in active:
                            share[c.region] += mb / len(active)
            for c in active:
                tl[c.region].comm_s += t_round
                tl[c.region].traffic_mb += share[c.region]
                blocking = t_round if (barrier or sync.strategy == "asgd") \
                    else t_round * max(0.0, 1.0 - wan.overlap) / chunks
                tl[c.region].comm_blocking_s += blocking
                clock[c.region] += blocking
            continue

        for c in active:
            t = _transfer_time(payload, bandwidth, wan, rng)
            if clock[c.region] < fail_until and fail_n > 0:
                # failed attempts hang to the timeout budget and back off;
                # every retried transfer bills its bytes at full cost
                expected = payload * 8.0 / bandwidth + wan.latency_s
                t += retry_schedule(expected, retry, fail_n)
                tl[c.region].traffic_mb += payload * fail_n
            tl[c.region].comm_s += t
            tl[c.region].traffic_mb += payload
            # asynchronous strategies hide ``overlap`` of the transfer
            # behind subsequent compute; chunk-pipelining the codec
            # (SyncConfig.overlap_chunks, active only on the codec path,
            # capped at the block count in _schedule) additionally hides
            # the *unhidden* tail behind the next chunk's encode — only
            # ~1/C of it stays on the critical path (TAAR-style
            # transfer/compute overlap)
            blocking = t if (barrier or sync.strategy == "asgd") else \
                t * max(0.0, 1.0 - wan.overlap) / chunks
            tl[c.region].comm_blocking_s += blocking
            clock[c.region] += blocking

    # straggler wait at job end: resources stay allocated until every
    # partition finishes (the paper's waiting-time / cost-waste term);
    # departed clouds released their resources at their departure time
    t_end = max([*(clock[c.region] for c in active), *ended.values()]) \
        if (active or ended) else 0.0
    for region, timeline in tl.items():
        if region not in ended:
            if not barrier:
                timeline.wait_s += t_end - clock[region]
            _close_life(region, t_end)
        timeline.total_s = life_s[region]
        timeline.cost = (cost_acc[region]
                         + timeline.traffic_mb / 1024.0
                         * wan.traffic_cost_per_gb)
    return SimResult(clouds=list(tl.values()), sync_cfg=sync,
                     n_reconfigs=n_reconfigs)


# ---------------------------------------------------------------------------
# composed experiments (used by benchmarks)
# ---------------------------------------------------------------------------


def compare_strategies(
    clouds: Sequence[SimCloud],
    *,
    n_iters: int,
    model_mb: float,
    intervals: Sequence[int] = (4, 8),
    wan: WANConfig = WANConfig(),
) -> Dict[str, SimResult]:
    """Reproduce the Fig 10/11 grid: baseline ASGD vs ASGD-GA / AMA / SMA."""
    out: Dict[str, SimResult] = {
        "asgd": simulate(clouds, SyncConfig("asgd", 1), n_iters=n_iters,
                         model_mb=model_mb, wan=wan)}
    for k in intervals:
        for strat in ("asgd_ga", "ama", "sma"):
            cfgk = SyncConfig(strat, k)
            out[f"{strat}@{k}"] = simulate(
                clouds, cfgk, n_iters=n_iters, model_mb=model_mb, wan=wan)
    # Gaia-style ASP comparator (per-iteration sync of the significant ~30%)
    out["asp"] = simulate(clouds, SyncConfig("asp", 1), n_iters=n_iters,
                          model_mb=model_mb, wan=wan)
    return out
