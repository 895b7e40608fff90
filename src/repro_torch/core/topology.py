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
- ``HierarchicalTransport`` (the reference's; ROADMAP Queue 1 item 11,
  with the transports it subclasses) — *who ships*: a
  ``repro.core.transport.WanTransport`` behind the PR-5 seam.
  Shipping delegates to the inline ring (``sync._INLINE_RING``) — the SAME
  code path the legacy jit traces, so flat-ring and hierarchical runs
  produce **bit-identical** averaged parameters by construction; what the
  topology changes is the *billing*: each sync round costs the compiled
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

The port holds the whole module but ``HierarchicalTransport``, which
waits for the transports: the specs, schedules and the planner are
host-only, and the planner takes its actuator as ``apply=``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.autotune import WanProbeEstimator
from repro_torch.core.wan import WANConfig, transfer_time

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
    inline ring (see the reference's ``HierarchicalTransport.ship_bucket``)."""

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
