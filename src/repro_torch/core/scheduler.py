"""Elastic scheduling strategy (paper §III.B).

Implements the load-power model (formula 1)

    LP_i = (Σ_m N_cpu,m · P_m + Σ_n N_gpu,n · P_n) / S_data,i

and the Optimal Matching Algorithm (Table II / Algorithm 1): find the cloud
with the smallest load power (the worst straggler), then trim every other
cloud's resource allocation by brute force so all LPs match the straggler's
as closely as possible — eliminating wait-time over-provisioning.

The device catalog reproduces paper Table I (TFLOPS, measured ResNet18
iteration time, TN/IN normalizations) and is extended with TPU v5e for the
TPU-cluster planning path used by the launcher.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Device catalog — paper Table I (+ TPU extension)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceType:
    name: str
    kind: str                 # "cpu" | "gpu" | "tpu"
    cores: int                # cores used in the Table I measurement
    tflops: float             # peak TFLOPS at that allocation
    iter_time_s: Optional[float] = None   # measured ResNet18 iter time (Table I)

    @property
    def tn(self) -> float:
        """TFLOPS normalization vs the Intel IceLake baseline (Table I)."""
        return self.tflops / CATALOG["icelake"].tflops

    @property
    def in_(self) -> Optional[float]:
        """Iteration-time normalization (baseline_time / time)."""
        if self.iter_time_s is None:
            return None
        return CATALOG["icelake"].iter_time_s / self.iter_time_s

    @property
    def in_tn_ratio(self) -> Optional[float]:
        return None if self.in_ is None else self.in_ / self.tn

    def power(self, prefer_measured: bool = True) -> float:
        """Per-allocation computing power P (paper: TN, or IN when measured)."""
        if prefer_measured and self.in_ is not None:
            return self.in_
        return self.tn


CATALOG: Dict[str, DeviceType] = {}
for _d in [
    DeviceType("icelake", "cpu", 2, 0.096, 3.697),      # baseline (Table I)
    DeviceType("cascade", "cpu", 2, 0.090, 5.549),      # TN .938, IN .666
    DeviceType("skylake", "cpu", 2, 0.112, 3.800),      # TN 1.167, IN .973
    DeviceType("t4", "gpu", 2560, 5.554, 0.062),
    DeviceType("v100", "gpu", 5120, 13.345, 0.024),
    DeviceType("v5e", "tpu", 1, 197.0, None),           # bf16 peak, per chip
]:
    CATALOG[_d.name] = _d
CATALOG["sky"] = CATALOG["skylake"]


# ---------------------------------------------------------------------------
# cloud resource description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CloudResources:
    """Resources available (reserved or real-time) in one cloud region."""

    region: str
    devices: Tuple[Tuple[str, int], ...]   # ((device_type, max_units), ...)
    data_size: float                        # S_data,i — local dataset size
    cost_per_unit_hour: float = 1.0         # monetary cost per device-unit-hour

    def max_allocation(self) -> Tuple[int, ...]:
        return tuple(n for _, n in self.devices)


@dataclass(frozen=True)
class ResourcePlan:
    region: str
    allocation: Tuple[Tuple[str, int], ...]  # ((device_type, units), ...)
    load_power: float

    @property
    def units(self) -> int:
        return sum(n for _, n in self.allocation)


def load_power(devices: Sequence[Tuple[str, int]], data_size: float,
               prefer_measured: bool = True) -> float:
    """Formula (1): LP = Σ N_d · P_d / S_data."""
    if data_size <= 0:
        return math.inf
    total = sum(n * CATALOG[d].power(prefer_measured) for d, n in devices)
    return total / data_size


# ---------------------------------------------------------------------------
# Algorithm 1 — Optimal Matching
# ---------------------------------------------------------------------------


def _allocations(res: CloudResources) -> List[Tuple[Tuple[str, int], ...]]:
    """All feasible (non-zero) allocations of each device type (brute force,
    per the paper's search_optimal_plan)."""
    ranges = [range(0, n + 1) for _, n in res.devices]
    out = []
    for combo in itertools.product(*ranges):
        if sum(combo) == 0:
            continue
        out.append(tuple((d, c) for (d, _), c in zip(res.devices, combo) if c > 0))
    return out


def optimal_matching(clouds: Sequence[CloudResources],
                     prefer_measured: bool = True) -> List[ResourcePlan]:
    """Algorithm 1: compute LP of each cloud at full allocation, take the
    minimum as the straggler reference, then for every cloud pick the
    cheapest allocation whose LP >= reference with minimal LP excess."""
    if not clouds:
        return []
    full_lp = [load_power(c.devices, c.data_size, prefer_measured) for c in clouds]
    min_lp = min(full_lp)

    return [_match_one(cloud, min_lp, prefer_measured) for cloud in clouds]


# ---------------------------------------------------------------------------
# plan diffing + incremental re-matching (elasticity engine)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanDiff:
    """Difference between two resource-plan sets, keyed by region.

    ``resized`` carries (region, old_allocation, new_allocation) for regions
    present in both plans whose allocation changed.  An all-empty diff means
    a reconfiguration would be a no-op and the trainer skips the barrier
    re-stacking entirely.
    """

    added: Tuple[str, ...] = ()
    removed: Tuple[str, ...] = ()
    resized: Tuple[Tuple[str, Tuple[Tuple[str, int], ...],
                         Tuple[Tuple[str, int], ...]], ...] = ()

    @property
    def is_empty(self) -> bool:
        return not (self.added or self.removed or self.resized)

    def summary(self) -> str:
        if self.is_empty:
            return "no-op"
        parts = []
        if self.added:
            parts.append("+" + ",".join(self.added))
        if self.removed:
            parts.append("-" + ",".join(self.removed))
        for region, old, new in self.resized:
            parts.append(f"{region}:{dict(old)}->{dict(new)}")
        return " ".join(parts)


def diff_plans(old: Sequence[ResourcePlan],
               new: Sequence[ResourcePlan]) -> PlanDiff:
    """Region-keyed structural diff of two Algorithm-1 outputs."""
    old_by = {p.region: p for p in old}
    new_by = {p.region: p for p in new}
    added = tuple(r for r in new_by if r not in old_by)
    removed = tuple(r for r in old_by if r not in new_by)
    resized = tuple(
        (r, old_by[r].allocation, new_by[r].allocation)
        for r in old_by
        if r in new_by and old_by[r].allocation != new_by[r].allocation)
    return PlanDiff(added=added, removed=removed, resized=resized)


def incremental_matching(
    clouds: Sequence[CloudResources],
    prev: Optional[Sequence[ResourcePlan]] = None,
    prefer_measured: bool = True,
) -> List[ResourcePlan]:
    """Incremental Algorithm 1 for the elasticity engine.

    Re-computes the straggler reference for the *new* resource picture, then
    reuses the previous allocation for every cloud whose resources are
    unchanged and whose previous allocation is still optimal against the new
    reference (exact same LP-excess bound), searching only the clouds the
    event actually perturbed.  Output is identical to a fresh
    ``optimal_matching`` call; only the work is incremental.
    """
    if not clouds:
        return []
    prev_by = {p.region: p for p in (prev or [])}
    full_lp = [load_power(c.devices, c.data_size, prefer_measured)
               for c in clouds]
    min_lp = min(full_lp)

    plans: List[ResourcePlan] = []
    for cloud, flp in zip(clouds, full_lp):
        old = prev_by.get(cloud.region)
        if old is not None and _reusable(cloud, old, min_lp, prefer_measured):
            lp = load_power(old.allocation, cloud.data_size, prefer_measured)
            plans.append(old if abs(lp - old.load_power) <= 1e-12 else
                         ResourcePlan(region=cloud.region,
                                      allocation=old.allocation,
                                      load_power=lp))
            continue
        if flp <= min_lp + 1e-12:
            # this cloud *is* the straggler: full allocation by construction
            plans.append(ResourcePlan(region=cloud.region,
                                      allocation=cloud.devices,
                                      load_power=flp))
            continue
        plans.append(_match_one(cloud, min_lp, prefer_measured))
    return plans


def _match_one(cloud: CloudResources, min_lp: float,
               prefer_measured: bool) -> ResourcePlan:
    """Single-cloud Algorithm-1 inner search against a fixed reference."""
    best: Optional[Tuple[float, int, Tuple[Tuple[str, int], ...], float]] = None
    for alloc in _allocations(cloud):
        lp = load_power(alloc, cloud.data_size, prefer_measured)
        if lp < min_lp - 1e-12:
            continue
        units = sum(n for _, n in alloc)
        key = (lp - min_lp, units)
        if best is None or key < (best[0], best[1]):
            best = (lp - min_lp, units, alloc, lp)
    assert best is not None
    return ResourcePlan(region=cloud.region, allocation=best[2],
                        load_power=best[3])


def _reusable(cloud: CloudResources, old: ResourcePlan, min_lp: float,
              prefer_measured: bool) -> bool:
    """Previous allocation still optimal: feasible, not below the new
    reference, and no strictly better (smaller-excess or cheaper) allocation
    exists — checked cheaply by re-running the inner search only when the old
    excess is non-zero."""
    avail = dict(cloud.devices)
    for dev, n in old.allocation:
        if dev not in avail or n > avail[dev]:
            return False
    lp = load_power(old.allocation, cloud.data_size, prefer_measured)
    if lp < min_lp - 1e-12:
        return False
    if abs(lp - min_lp) <= 1e-12:
        return True     # zero excess cannot be beaten
    fresh = _match_one(cloud, min_lp, prefer_measured)
    return fresh.allocation == old.allocation


# ---------------------------------------------------------------------------
# predicted effect (used by the WAN simulator & Fig 8 reproduction)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LoadPrediction:
    region: str
    t_train_rel: float     # relative local-training time for its shard


def predict_times(clouds: Sequence[CloudResources],
                  plans: Optional[Sequence[ResourcePlan]] = None,
                  prefer_measured: bool = True) -> List[LoadPrediction]:
    """T_train ∝ S_data / C_devices (paper §III.B): relative per-period local
    training times, before or after applying a resource plan."""
    out = []
    for i, c in enumerate(clouds):
        devices = plans[i].allocation if plans is not None else c.devices
        power = sum(n * CATALOG[d].power(prefer_measured) for d, n in devices)
        out.append(LoadPrediction(region=c.region, t_train_rel=c.data_size / power))
    return out


def waiting_fraction(preds: Sequence[LoadPrediction]) -> Dict[str, float]:
    """Fraction of each cloud's period spent waiting for the straggler."""
    tmax = max(p.t_train_rel for p in preds)
    return {p.region: 1.0 - p.t_train_rel / tmax for p in preds}


# ---------------------------------------------------------------------------
# TPU-cluster planning (hardware adaptation)
# ---------------------------------------------------------------------------


def plan_batch_split(global_batch: int, pod_powers: Sequence[float]) -> List[int]:
    """Split a global batch across pods proportional to compute power —
    the plan-time expression of the paper's elastic scaling on TPU, where
    allocation granularity is the per-pod microbatch rather than serverless
    worker count.  Largest-remainder rounding; every pod gets >= 1."""
    total = sum(pod_powers)
    raw = [global_batch * p / total for p in pod_powers]
    base = [max(1, int(x)) for x in raw]
    while sum(base) > global_batch:
        base[base.index(max(base))] -= 1
    rema = sorted(range(len(raw)), key=lambda i: raw[i] - base[i], reverse=True)
    i = 0
    while sum(base) < global_batch:
        base[rema[i % len(rema)]] += 1
        i += 1
    return base
