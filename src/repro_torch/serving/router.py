"""Geo-aware request routing for the serving plane (a copy of
``repro/serving/router.py``, importing the port's catalog and link beliefs).

The :class:`GeoRouter` places each incoming request on a regional replica
by scoring, per candidate, the same three quantities the training plane
already models:

- **network seconds** — request+response wire size over the *measured*
  belief of the client-region -> replica-region link
  (:class:`~repro_torch.core.topology.LinkBeliefs`, the per-link
  generalization of ``MeasuredWanProbe``: EMA with cliff-snap, so one
  observation of a collapsed link reroutes traffic before the next
  request pays for it);
- **compute + queue seconds** — tokens to generate over the replica's
  service rate, derived from the scheduler catalog's device power
  (``CATALOG[device].power()``, paper Table I), plus the tokens already
  queued on that replica at the same rate;
- **cost** — the catalog device's ``cost_per_unit_hour`` divided by its
  service rate: dollars per generated token.

Three modes pick the objective: ``nearest`` minimizes network seconds,
``cheapest`` minimizes cost per token, ``balanced`` minimizes total
request latency (network + queue + compute).  Every mode breaks ties
deterministically (score, then region name), and every placement is
recorded as a plain-dict :attr:`decisions` entry with the full score
table — `benchmarks/serving.py` commits the stream and
`check_regression.py` replays it through a fresh router via
:func:`replay_decisions`, the same recorded-decision discipline as the
topology planner and fault resolver.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.scheduler import CATALOG
from repro_torch.core.topology import LinkBeliefs

ROUTER_MODES = ("nearest", "cheapest", "balanced")


@dataclass(frozen=True)
class ReplicaSpec:
    """One serving replica: a pod in some region running one slot pool."""

    region: str
    device: str = "v5e"            # scheduler-catalog device type
    units: int = 1                 # device units backing the replica
    n_slots: int = 4               # slot-pool width of its engine
    cost_per_unit_hour: float = 1.0

    def __post_init__(self):
        if self.device not in CATALOG:
            raise ValueError(f"unknown device {self.device!r} "
                             f"(catalog: {sorted(CATALOG)})")
        if self.units < 1:
            raise ValueError("units must be >= 1")

    @property
    def service_rate(self) -> float:
        """Relative tokens/sec: catalog compute power x units (TN for
        devices without a measured iteration time, IN otherwise — the
        same normalization Algorithm 1 plans with)."""
        return CATALOG[self.device].power() * self.units

    @property
    def cost_per_token(self) -> float:
        """Relative $/token: unit-hours burned per unit of service rate."""
        return self.units * self.cost_per_unit_hour / self.service_rate


class GeoRouter:
    """Places requests on regional replicas; see module docstring.

    Determinism contract: identical (replicas, mode, knobs) + identical
    event sequence (``observe_transfer`` / ``route`` / ``complete`` calls
    in order) => identical decision stream.  All state is explicit — link
    beliefs and per-replica outstanding tokens — and scores are rounded
    before recording so JSON round-trips are exact."""

    def __init__(self, replicas: Sequence[ReplicaSpec], *,
                 mode: str = "balanced", default_mbps: float = 100.0,
                 alpha: float = 0.5, cliff_snap: float = 4.0,
                 mb_per_token: float = 0.004):
        if mode not in ROUTER_MODES:
            raise ValueError(f"mode must be one of {ROUTER_MODES}")
        if not replicas:
            raise ValueError("need at least one replica")
        regions = [r.region for r in replicas]
        if len(set(regions)) != len(regions):
            raise ValueError(f"duplicate replica regions in {regions}")
        self.replicas: Dict[str, ReplicaSpec] = {
            r.region: r for r in sorted(replicas, key=lambda r: r.region)}
        self.mode = mode
        self.mb_per_token = float(mb_per_token)
        self.links = LinkBeliefs(default_mbps=default_mbps, alpha=alpha,
                                 cliff_snap=cliff_snap)
        self.outstanding: Dict[str, int] = {r: 0 for r in self.replicas}
        self._placed: Dict[int, str] = {}      # rid -> region
        self.decisions: List[dict] = []

    # ----------------------------------------------------------- beliefs
    def observe_transfer(self, a: str, b: str, payload_mb: float,
                         seconds: float) -> None:
        """Fold one measured client<->replica transfer into the a<->b link
        belief (same degenerate-sample rule as ``MeasuredWanProbe``:
        zero-byte or zero-time samples are dropped, not folded)."""
        if payload_mb <= 0.0 or seconds <= 0.0:
            return
        self.links.observe(a, b, payload_mb * 8.0 / seconds)

    # ----------------------------------------------------------- scoring
    def _score(self, spec: ReplicaSpec, src: str, prompt_len: int,
               max_new: int) -> Dict[str, float]:
        wire_mb = (prompt_len + max_new) * self.mb_per_token
        if src == spec.region:
            net_s = 0.0
        else:
            net_s = wire_mb * 8.0 / self.links.mbps(src, spec.region)
        compute_s = max_new / spec.service_rate
        queue_s = self.outstanding[spec.region] / spec.service_rate
        return {
            "net_s": round(net_s, 9),
            "compute_s": round(compute_s, 9),
            "queue_s": round(queue_s, 9),
            "total_s": round(net_s + compute_s + queue_s, 9),
            "cost_per_token": round(spec.cost_per_token, 9),
        }

    def _objective(self, s: Dict[str, float]) -> tuple:
        if self.mode == "nearest":
            return (s["net_s"], s["queue_s"])
        if self.mode == "cheapest":
            return (s["cost_per_token"], s["net_s"], s["queue_s"])
        return (s["total_s"], s["cost_per_token"])

    # ----------------------------------------------------------- routing
    def route(self, rid: int, src: str, prompt_len: int, max_new: int
              ) -> str:
        """Place request ``rid`` from client region ``src``; returns the
        chosen replica region and records the full decision."""
        if rid in self._placed:
            raise ValueError(f"rid {rid} already routed")
        scores = {region: self._score(spec, src, prompt_len, max_new)
                  for region, spec in self.replicas.items()}
        chosen = min(scores,
                     key=lambda r: self._objective(scores[r]) + (r,))
        self.outstanding[chosen] += max_new
        self._placed[rid] = chosen
        s = scores[chosen]
        self.decisions.append({
            "rid": rid, "src": src, "mode": self.mode, "chosen": chosen,
            "prompt_len": int(prompt_len), "max_new": int(max_new),
            "scores": scores,
            "reason": (f"{self.mode}: {chosen} (net {s['net_s']:.4f}s + "
                       f"queue {s['queue_s']:.4f}s + compute "
                       f"{s['compute_s']:.4f}s, {s['cost_per_token']:.4f} "
                       f"$/tok)"),
        })
        return chosen

    def complete(self, rid: int) -> str:
        """Mark ``rid`` finished: release its queued tokens on the replica
        that served it."""
        region = self._placed.pop(rid, None)
        if region is None:
            raise KeyError(f"rid {rid} was never routed (or already "
                           f"completed)")
        spec_max = next(d["max_new"] for d in reversed(self.decisions)
                        if d["rid"] == rid)
        self.outstanding[region] = max(0, self.outstanding[region]
                                       - spec_max)
        return region

    # ------------------------------------------------------------ replay
    def snapshot(self) -> dict:
        """JSON-ready router state for bench baselines."""
        return {
            "mode": self.mode,
            "replicas": [{"region": r.region, "device": r.device,
                          "units": r.units, "n_slots": r.n_slots,
                          "cost_per_unit_hour": r.cost_per_unit_hour}
                         for r in self.replicas.values()],
            "outstanding": dict(self.outstanding),
            "links": {f"{a}<->{b}": est.bandwidth_mbps
                      for (a, b), est in sorted(self.links._est.items())},
        }


def replay_decisions(replicas: Sequence[ReplicaSpec], mode: str,
                     events: Iterable[dict], **router_kw) -> List[dict]:
    """Drive a fresh :class:`GeoRouter` through a recorded event stream
    and return its decision list — the serving plane's exact-replay gate.

    ``events`` entries: ``{"op": "observe", "a", "b", "payload_mb",
    "seconds"}``, ``{"op": "route", "rid", "src", "prompt_len",
    "max_new"}``, ``{"op": "complete", "rid"}``."""
    router = GeoRouter(replicas, mode=mode, **router_kw)
    for ev in events:
        op = ev["op"]
        if op == "observe":
            router.observe_transfer(ev["a"], ev["b"], ev["payload_mb"],
                                    ev["seconds"])
        elif op == "route":
            router.route(ev["rid"], ev["src"], ev["prompt_len"],
                         ev["max_new"])
        elif op == "complete":
            router.complete(ev["rid"])
        else:
            raise ValueError(f"unknown router event op {op!r}")
    return router.decisions
