"""Network-aware hierarchical aggregation topology (the third actuator).

Every sync so far crossed one flat pod ring, regardless of what the
measured WAN looked like.  This module makes the aggregation *topology* a
schedulable resource alongside tier and interval (HeterPS-style), following
the measured network the way the adaptive-tree literature does: reduce
inside each region first (cheap intra-region fabric), then exchange
between regions over the links the bandwidth beliefs say are worth using —
with an auxiliary two-hop route around a link whose belief has collapsed.

Three layers:

- :class:`TopologySpec` — *what could run*: the region grouping (from
  ``core/scheduler.py``'s plan / ``control_plane.TrainingPlan``) plus the
  shape family (``ring`` — one-peer exchange between region leaders;
  ``tree`` — gather-to-root + broadcast).  ``compile`` turns it into an
  :class:`AggregationSchedule` against the current :class:`LinkBeliefs`:
  ring orderings maximize the bottleneck link, trees root at the
  best-connected region, and a leaf whose direct link to the root has
  collapsed (belief ``collapse_ratio`` below the best relay's bottleneck)
  is routed ``leaf -> relay -> root`` instead.
- :class:`LinkBeliefs` — *what the network looks like*: one
  :class:`~repro_torch.core.autotune.WanProbeEstimator` per inter-region link
  (cliff-snap included, so one transfer on a collapsed link reprices it),
  fed by the transport's billed per-leg transfer times — the per-link
  generalization of the PR-5 :class:`~repro_torch.core.transport.MeasuredWanProbe`.
- :class:`HierarchicalTransport` — *who ships*: a
  :class:`~repro_torch.core.transport.WanTransport` behind the PR-5 seam.
  Shipping delegates to the inline ring of the bound pod axis
  (``WanTransport.bind``; point to point when the axis is split over
  processes) — the SAME code path the flat ring ships, so flat-ring and
  hierarchical runs produce **bit-identical** averaged parameters by
  construction; what the topology changes is the *billing*: each sync
  round costs the compiled
  schedule's phase times (intra legs at fabric speed, WAN legs at their
  own link's traced bandwidth through the DES ``transfer_time`` law), and
  the billed per-leg times feed the link beliefs, which recompile the
  schedule for the next round — a collapse observed at round k is routed
  around at round k+1.

:class:`TopologyPlanner` is the actuator head: it prices every candidate
shape against the current beliefs (``estimate_round_s``) and switches with
hysteresis; ``AdaptiveSyncController(topology=planner)`` consults it under
the same EF-convergence guard as the tier/interval laws (a guard trip
defers topology moves — fidelity first).

The existing sync strategies map onto the hierarchy levels (paper
§III.C's inter-PS model averaging): intra-region reduction is an SMA
barrier mean, inter-region exchange is MA gossip —
:func:`repro_torch.core.sync.hierarchical_average` implements the mapping and
its degenerate equivalences (singleton groups == flat ``ama``, one group
== flat ``sma``).

Everything here is host arithmetic but the ship, which is the inline
ring's ``torch.roll`` over the pod dimension (its point-to-point ring on a
split pod axis; the billing and the recompiles stay on the host, the same
on every rank); the planner takes its actuator as ``apply=`` (a
transport's ``set_kind``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.autotune import WanProbeEstimator
from repro_torch.core.sync import ChunkPayload
from repro_torch.core.transport import (MeasuredWanProbe, TransferRecord,
                                        WanTransport, _close_billed_round,
                                        _StreamRound)
from repro_torch.core.wan import BandwidthTrace, WANConfig, transfer_time

_EPS = 1e-9

TOPOLOGY_KINDS = ("ring", "tree")

Link = Tuple[str, str]


def link_key(a: str, b: str) -> Link:
    """Canonical (sorted) key for the undirected inter-region link a<->b."""
    if a == b:
        raise ValueError(f"no WAN link from region {a!r} to itself")
    return (a, b) if a < b else (b, a)


class LinkBeliefs:
    """Per-link bandwidth beliefs: one cliff-snapping estimator per
    inter-region link, the per-link generalization of
    :class:`~repro_torch.core.transport.MeasuredWanProbe`.

    Links never observed report ``default_mbps`` — schedule compilation
    must be total even before the first transfer."""

    def __init__(self, default_mbps: float = 100.0, alpha: float = 0.5,
                 cliff_snap: float = 4.0):
        if default_mbps <= 0:
            raise ValueError("default_mbps must be positive")
        self.default_mbps = float(default_mbps)
        self.alpha = alpha
        self.cliff_snap = cliff_snap
        self._est: Dict[Link, WanProbeEstimator] = {}

    def observe(self, a: str, b: str, mbps: float) -> None:
        """Fold one achieved-bandwidth sample into the a<->b belief."""
        key = link_key(a, b)
        est = self._est.get(key)
        if est is None:
            est = self._est[key] = WanProbeEstimator(
                alpha=self.alpha, cliff_snap=self.cliff_snap)
        est.observe(float(mbps))

    def mbps(self, a: str, b: str) -> float:
        est = self._est.get(link_key(a, b))
        if est is None or est.bandwidth_mbps is None:
            return self.default_mbps
        return est.bandwidth_mbps

    def snapshot(self) -> Dict[str, float]:
        """``"a|b" -> belief`` for every observed link (bench recording)."""
        return {f"{a}|{b}": round(e.bandwidth_mbps, 6)
                for (a, b), e in sorted(self._est.items())
                if e.bandwidth_mbps is not None}


@dataclass(frozen=True)


class LinkLeg:
    """One directed transfer of an inter-region phase.  ``via`` marks the
    auxiliary route: the payload hops ``src -> via -> src's target`` —
    two sequential WAN transfers instead of one collapsed one."""

    src: str
    dst: str
    via: Optional[str] = None

    @property
    def hops(self) -> Tuple[Link, ...]:
        """The undirected link(s) this leg crosses, in transfer order."""
        if self.via is None:
            return (link_key(self.src, self.dst),)
        return (link_key(self.src, self.via), link_key(self.via, self.dst))


@dataclass(frozen=True)
class Phase:
    """One barrier-separated stage of the schedule.  Legs within a phase
    run in parallel (the phase costs its slowest leg); phases run in
    sequence.  ``wan=False`` phases move bytes on the intra-region fabric
    only."""

    kind: str                      # "intra-reduce" | "exchange" |
    #                                "gather" | "broadcast" | "intra-bcast"
    legs: Tuple[LinkLeg, ...]
    wan: bool = True


@dataclass(frozen=True)
class AggregationSchedule:
    """A compiled two-level aggregation round: which transfers happen, in
    which order, over which links.  This is the *billing and accounting*
    model of a sync round — the data movement itself stays the bit-exact
    inline ring (see :meth:`HierarchicalTransport.ship_bucket`)."""

    kind: str
    root: Optional[str]
    phases: Tuple[Phase, ...]

    @property
    def wan_legs(self) -> Tuple[LinkLeg, ...]:
        return tuple(leg for ph in self.phases if ph.wan for leg in ph.legs)

    @property
    def wan_transfers(self) -> int:
        """Payload-sized WAN transfers per sync round (aux legs pay two) —
        the multiplier topology-aware traffic accounting bills instead of
        the flat ring's ``n_pods``."""
        return sum(len(leg.hops) for leg in self.wan_legs)

    @property
    def uses_aux_route(self) -> bool:
        return any(leg.via is not None for leg in self.wan_legs)

    def round_s(self, payload_mb: float, bw_of: Callable[[str, str], float],
                *, intra_mbps: float, wan: Optional[WANConfig] = None,
                rng: Optional[np.random.Generator] = None,
                latency_s: float = 0.0) -> float:
        """Wall-clock of one round shipping ``payload_mb`` per leg.

        With ``wan``/``rng`` each hop is priced by the DES transfer law
        (:func:`repro_torch.core.wan.transfer_time`: latency + seeded lognormal
        fluctuation) at ``bw_of(src, dst)``; without them the estimate is
        deterministic (``payload*8/bw + latency_s`` per hop) — the form
        :class:`TopologyPlanner` compares candidates with.  Intra-region
        legs move at ``intra_mbps`` fabric speed, no WAN latency."""
        total = 0.0
        for phase in self.phases:
            if not phase.legs:
                continue
            if not phase.wan:
                total += payload_mb * 8.0 / intra_mbps
                continue
            slowest = 0.0
            for leg in phase.legs:
                t = 0.0
                for a, b in leg.hops:
                    bw = max(bw_of(a, b), _EPS)
                    if wan is not None:
                        t += transfer_time(payload_mb, bw, wan, rng)
                    else:
                        t += payload_mb * 8.0 / bw + latency_s
                slowest = max(slowest, t)
            total += slowest
        return total


@dataclass(frozen=True)
class TopologySpec:
    """Region grouping + shape family, compiled against link beliefs.

    ``groups`` maps each region to the pod indices it hosts (from the
    scheduler plan: pods sharing a ``CloudResources.region`` aggregate
    locally before anything crosses the WAN).  Singleton groups make the
    intra level a no-op — the schedule is then a pure inter-region ring or
    tree over all pods."""

    kind: str
    groups: Tuple[Tuple[str, Tuple[int, ...]], ...]
    intra_mbps: float = 10_000.0
    collapse_ratio: float = 4.0     # aux route wins when its bottleneck
    #   beats the direct link's belief by this factor — same scale as the
    #   estimator's cliff-snap, so one snapped observation is enough

    def __post_init__(self):
        if self.kind not in TOPOLOGY_KINDS:
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             f"expected one of {TOPOLOGY_KINDS}")
        if not self.groups:
            raise ValueError("TopologySpec needs at least one region group")
        names = [name for name, _ in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate region names in {names}")
        pods = [i for _, members in self.groups for i in members]
        if not pods or sorted(pods) != list(range(len(pods))):
            raise ValueError(
                f"group members must partition pods 0..n-1, got {pods}")
        if self.intra_mbps <= 0:
            raise ValueError("intra_mbps must be positive")
        if self.collapse_ratio < 1.0:
            raise ValueError("collapse_ratio must be >= 1")

    # ------------------------------------------------------------ factories
    @classmethod
    def from_regions(cls, regions: Sequence[str], kind: str = "tree",
                     **kw) -> "TopologySpec":
        """Group pod ``i`` under ``regions[i]``; pods sharing a region name
        form one intra-region group (order of first appearance)."""
        groups: Dict[str, List[int]] = {}
        for i, r in enumerate(regions):
            groups.setdefault(r, []).append(i)
        return cls(kind=kind,
                   groups=tuple((r, tuple(m)) for r, m in groups.items()),
                   **kw)

    @classmethod
    def from_plan(cls, plan, kind: str = "tree", **kw) -> "TopologySpec":
        """Region grouping from a ``control_plane.TrainingPlan`` (pod i is
        ``resource_plans[i]``; grouping key is its scheduler region)."""
        return cls.from_regions([p.region for p in plan.resource_plans],
                                kind=kind, **kw)

    def with_kind(self, kind: str) -> "TopologySpec":
        return self if kind == self.kind else replace(self, kind=kind)

    # ----------------------------------------------------------- structure
    @property
    def regions(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.groups)

    @property
    def n_pods(self) -> int:
        return sum(len(m) for _, m in self.groups)

    def links(self) -> Tuple[Link, ...]:
        """Every inter-region link, canonical order."""
        return tuple(link_key(a, b)
                     for a, b in itertools.combinations(sorted(self.regions),
                                                        2))

    # ------------------------------------------------------------- compile
    def compile(self, beliefs: LinkBeliefs) -> AggregationSchedule:
        """Two-level schedule against the current beliefs: intra-region
        reduce, inter-region exchange (ring ordered for the best
        bottleneck link / tree rooted at the best-connected region with
        auxiliary routes around collapsed links), intra-region broadcast.
        Deterministic: ties break lexicographically, so the same beliefs
        always compile the same schedule (the replay gate's contract)."""
        regions = self.regions
        intra = tuple(LinkLeg(name, name) for name, members in self.groups
                      if len(members) > 1)
        phases: List[Phase] = []
        if intra:
            phases.append(Phase("intra-reduce", intra, wan=False))
        root: Optional[str] = None
        if len(regions) > 1:
            if self.kind == "ring":
                order = self._ring_order(beliefs)
                legs = tuple(LinkLeg(order[i], order[(i + 1) % len(order)])
                             for i in range(len(order)))
                phases.append(Phase("exchange", legs))
            else:
                root = max(regions, key=lambda r: (
                    sum(beliefs.mbps(r, o) for o in regions if o != r), r))
                gather = tuple(self._route(r, root, regions, beliefs)
                               for r in regions if r != root)
                bcast = tuple(LinkLeg(leg.dst, leg.src, via=leg.via)
                              for leg in gather)
                phases.append(Phase("gather", gather))
                phases.append(Phase("broadcast", bcast))
        if intra:
            phases.append(Phase("intra-bcast", intra, wan=False))
        return AggregationSchedule(kind=self.kind, root=root,
                                   phases=tuple(phases))

    def _ring_order(self, beliefs: LinkBeliefs) -> Tuple[str, ...]:
        """Cyclic region order maximizing the slowest ring link (the whole
        ring waits on it).  Brute force over cycles — region counts are
        single-digit; beyond that the given order stands."""
        regions = self.regions
        if len(regions) <= 3 or len(regions) > 8:
            # 3 regions: every cycle crosses every link — nothing to choose
            return regions
        first = regions[0]
        best: Optional[Tuple[float, Tuple[str, ...]]] = None
        for rest in itertools.permutations(sorted(regions[1:])):
            order = (first,) + rest
            bottleneck = min(
                beliefs.mbps(order[i], order[(i + 1) % len(order)])
                for i in range(len(order)))
            if best is None or (bottleneck, order) > best:
                best = (bottleneck, order)
        return best[1]

    def _route(self, leaf: str, root: str, regions: Sequence[str],
               beliefs: LinkBeliefs) -> LinkLeg:
        """Direct leg leaf->root, or the auxiliary two-hop route when the
        direct link's belief has collapsed: the relay maximizing the
        bottleneck bandwidth wins iff that bottleneck beats the direct
        belief by ``collapse_ratio`` (routing around noise would thrash;
        routing around a cliff-snap is the point)."""
        direct = beliefs.mbps(leaf, root)
        best_via, best_bn = None, 0.0
        for via in sorted(regions):
            if via in (leaf, root):
                continue
            bn = min(beliefs.mbps(leaf, via), beliefs.mbps(via, root))
            if bn > best_bn:
                best_via, best_bn = via, bn
        if best_via is not None and best_bn > self.collapse_ratio * direct:
            return LinkLeg(leaf, root, via=best_via)
        return LinkLeg(leaf, root)

    def estimate_round_s(self, payload_mb: float, beliefs: LinkBeliefs,
                         *, latency_s: float = 0.0) -> float:
        """Deterministic per-round cost at the current beliefs — what the
        planner compares candidate shapes with (no rng, no fluctuation)."""
        return self.compile(beliefs).round_s(
            payload_mb, beliefs.mbps, intra_mbps=self.intra_mbps,
            latency_s=latency_s)


# ---------------------------------------------------------------------------
# the hierarchical transport: the inline ring's bytes, topology-aware billing
# ---------------------------------------------------------------------------


class HierarchicalTransport(WanTransport):
    """Hierarchical aggregation behind the transport seam.

    Shipping delegates to the inline ring, so flat-ring and hierarchical
    runs are bit-identical; the topology lives in the billing: each sync
    round costs the compiled schedule's phases, per leg at that link's
    traced bandwidth through the simulator's transfer law.  Billed per-leg
    times feed the link beliefs (cliff-snap per link), and the schedule
    recompiles after every round: a collapse observed at round k ships over
    the auxiliary route at round k+1.

    ``link_traces`` maps inter-region links (canonical ``link_key(a, b)``
    tuples) to their own :class:`BandwidthTrace`; ``trace`` is the default
    for unmapped links.  The caller owns the clock (``tick``), as with
    :class:`~repro_torch.core.transport.SimTransport`."""

    in_graph = True

    def __init__(self, spec: TopologySpec, trace: BandwidthTrace,
                 wan: Optional[WANConfig] = None,
                 link_traces: Optional[Mapping[Link, BandwidthTrace]] = None,
                 probe: Optional[MeasuredWanProbe] = None,
                 beliefs: Optional[LinkBeliefs] = None):
        super().__init__()
        self.spec = spec
        self.trace = trace
        self.link_traces = dict(link_traces or {})
        for key in self.link_traces:
            if link_key(*key) != key:
                raise ValueError(f"link_traces key {key} is not canonical; "
                                 f"use link_key(a, b)")
        self.wan = wan if wan is not None else WANConfig()
        self.probe = probe
        self.beliefs = (beliefs if beliefs is not None
                        else LinkBeliefs(default_mbps=trace.mbps[0]))
        self.clock_s = 0.0
        self._rng = np.random.default_rng(self.wan.seed)
        self.schedule = spec.compile(self.beliefs)
        self.reroutes: List[Tuple[Optional[int], str]] = []
        self.switches: List[Tuple[Optional[int], str, str]] = []

    # -------------------------------------------------------------- clock
    def tick(self, dt_s: float) -> None:
        self.clock_s += dt_s

    def link_mbps(self, a: str, b: str) -> float:
        """The link's physical bandwidth now (its trace at the clock): what
        billing draws from; the beliefs only see billed transfers."""
        return self.link_traces.get(link_key(a, b), self.trace).at(
            self.clock_s)

    # ----------------------------------------------------------- actuation
    def set_kind(self, kind: str, step: Optional[int] = None) -> None:
        """Adopt a new topology shape (the planner's actuator).  Takes
        effect at the next round's billing; the bytes are untouched."""
        if kind != self.spec.kind:
            self.switches.append((step, self.spec.kind, kind))
            self.spec = self.spec.with_kind(kind)
            self._recompile(step)

    def _recompile(self, step: Optional[int] = None) -> None:
        was_aux = self.schedule.uses_aux_route
        self.schedule = self.spec.compile(self.beliefs)
        if self.schedule.uses_aux_route and not was_aux:
            legs = [leg for leg in self.schedule.wan_legs
                    if leg.via is not None]
            self.reroutes.append(
                (step, ", ".join(f"{leg.src}->{leg.via}->{leg.dst}"
                                 for leg in legs)))

    @property
    def wan_transfers_per_round(self) -> int:
        """Payload-sized WAN transfers per sync round under the current
        schedule (the flat ring's is ``n_pods``): the traffic multiplier."""
        return self.schedule.wan_transfers

    # ------------------------------------------------------------ shipping
    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        # the hierarchy reshapes who pays for the bytes and when, never
        # the bytes: the bound pod axis's inline ring, bit for bit
        return self.pods.ring.ship_bucket(name, chunks, shift, payload_mb)

    def on_sync(self, wire_mb: Mapping[str, float],
                step: Optional[int] = None) -> float:
        """Bill one round at the current schedule (:meth:`_bill_round`),
        split across buckets proportionally for the records, then
        recompile the schedule against what the round measured."""
        total = sum(wire_mb.values())
        if total <= 0.0:
            return 0.0
        t = self._bill_round(total)
        for name, mb in wire_mb.items():
            self.records.append(TransferRecord(
                bucket=name, payload_mb=mb, seconds=t * mb / total,
                step=step))
        if self.probe is not None:
            self.probe.observe_transfer(total, t)
        self._recompile(step)
        return t

    def _bill_round(self, total_mb: float) -> float:
        """Price one traversal of the schedule for ``total_mb``: intra legs
        at fabric speed, each WAN hop one seeded ``transfer_time`` draw at
        its link's traced bandwidth (feeding that link's belief); legs
        within a phase take the slowest, phases add up.  Shared by
        ``on_sync`` and the streaming round (drawn once at
        ``begin_stream_round`` and, on a retune, once more for the tail)."""
        t = 0.0
        for phase in self.schedule.phases:
            if not phase.legs:
                continue
            if not phase.wan:
                t += total_mb * 8.0 / self.spec.intra_mbps
                continue
            slowest = 0.0
            for leg in phase.legs:
                leg_t = 0.0
                for a, b in leg.hops:
                    hop_t = transfer_time(total_mb, self.link_mbps(a, b),
                                          self.wan, self._rng)
                    self.beliefs.observe(a, b, total_mb * 8.0 / hop_t)
                    leg_t += hop_t
                slowest = max(slowest, leg_t)
            t += slowest
        return t

    # ------------------------------------------- streaming round protocol
    supports_streaming = True

    def begin_stream_round(self, wire_mb: Mapping[str, float],
                           step: Optional[int] = None) -> bool:
        """Arm a streaming round: bill the whole traversal now (the same rng
        draws and belief observations ``on_sync`` makes), so a zero-retune
        round is bit-identical to the classic one.  Nothing reads the
        beliefs mid-round, and the schedule recompiles only at
        ``end_stream_round``."""
        total = sum(wire_mb.values())
        if total <= 0.0:
            return False
        self._stream = _StreamRound(step, wire_mb, self._bill_round(total))
        return True

    def stream_chunk(self, name: str, chunk_mb: float) -> float:
        secs = self._stream.bill(name, chunk_mb)
        if self.probe is not None:
            self.probe.observe_chunk(chunk_mb, secs)
        return secs

    def stream_ship_chunk(self, name: str, chunk: ChunkPayload, shift: int,
                          chunk_mb: float) -> Tuple[ChunkPayload, float]:
        shipped = self.pods.ring.ship_bucket(name, (chunk,), shift,
                                             chunk_mb)[0]
        return shipped, self.stream_chunk(name, chunk_mb)

    def retune_stream(self, tail_mb: float) -> None:
        """Abort the unsent schedule: the re-encoded tail pays one fresh
        traversal at the links' current traced bandwidths (a second round
        of belief samples: the collapsed link is repriced twice)."""
        st = self._stream
        st.retuned = True
        st.tail_mb = float(tail_mb)
        st.t_tail = self._bill_round(tail_mb) if tail_mb > 0.0 else 0.0

    def end_stream_round(self) -> float:
        step = self._stream.step
        t = _close_billed_round(self)
        self._recompile(step)
        return t


# ---------------------------------------------------------------------------
# the actuator head: topology as a controller-schedulable knob
# ---------------------------------------------------------------------------


class TopologyPlanner:
    """Chooses the aggregation shape from the link beliefs — the third
    actuator next to tier and interval.

    Deterministic control law (the replay gate's contract): every
    candidate shape is priced with ``TopologySpec.estimate_round_s`` at
    the shared beliefs; a challenger must beat the incumbent's estimate by
    ``switch_margin`` for ``hysteresis`` consecutive decisions before the
    switch fires (same anti-flap discipline as the codec rungs).  Wire
    ``AdaptiveSyncController(topology=planner)`` to fold decisions into
    the controller's update stream, and give ``apply`` a transport's
    ``set_kind`` so a decision actuates."""

    def __init__(self, spec: TopologySpec, beliefs: LinkBeliefs, *,
                 candidates: Sequence[str] = TOPOLOGY_KINDS,
                 hysteresis: int = 2, switch_margin: float = 0.85,
                 latency_s: float = 0.0,
                 apply: Optional[Callable[[str, Optional[int]], None]] = None):
        for kind in candidates:
            if kind not in TOPOLOGY_KINDS:
                raise ValueError(f"unknown topology candidate {kind!r}")
        if not 0.0 < switch_margin <= 1.0:
            raise ValueError("switch_margin must be in (0, 1]")
        self.spec = spec
        self.beliefs = beliefs
        self.candidates = tuple(candidates)
        self.hysteresis = hysteresis
        self.switch_margin = switch_margin
        self.latency_s = latency_s
        self.apply = apply
        self.kind = spec.kind
        self._streak = 0
        self.decisions: List[Tuple[int, str, str, str]] = []
        #   (step, from_kind, to_kind, reason)

    def estimates(self, payload_mb: float) -> Dict[str, float]:
        return {k: self.spec.with_kind(k).estimate_round_s(
                    payload_mb, self.beliefs, latency_s=self.latency_s)
                for k in self.candidates}

    def decide(self, step: int, payload_mb: float) -> Optional[str]:
        """One planner step; returns the new kind when a switch fires."""
        est = self.estimates(payload_mb)
        best = min(self.candidates, key=lambda k: (est[k], k))
        if best == self.kind or not (
                est[best] < self.switch_margin * est[self.kind]):
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.hysteresis:
            return None
        old, self.kind, self._streak = self.kind, best, 0
        reason = (f"topo-cost:{old}->{best}"
                  f"@{est[best]:.4f}s<{est[old]:.4f}s")
        self.decisions.append((step, old, best, reason))
        if self.apply is not None:
            self.apply(best, step)
        return best
