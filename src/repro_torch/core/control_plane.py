"""Control plane: the plan half and the serving plane's autoscaler.

Counterpart of ``repro/core/control_plane.py`` (its lines 182-268, 290-312
and 535-615): the scheduler function runs the elastic scheduling strategy
(Algorithm 1), each cloud's parameter server registers with the global
communicator, which assigns WAN identities and the one-peer-per-round ring;
:class:`CloudEvent` carries runtime changes, and the
:class:`ServingElasticityController` sizes the serving replica count from
``load_changed`` events.  The function registry, workflow engine, event bus
and the training elasticity controller are ROADMAP Queue 1 item 10 (the
autoscaler subscribes to any ``bus`` with ``subscribe(kind, fn)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import (CloudResources, ResourcePlan,
                                        optimal_matching, plan_batch_split)
from repro_torch.core.sync import SyncConfig


# the training-plane kinds drive Algorithm-1 re-matching; "load_changed"
# is the serving plane's kind (request-rate shift) and is consumed by the
# ServingElasticityController only — one bus, one event type, two planes
TRAINING_EVENT_KINDS = ("cloud_joined", "cloud_left", "bandwidth_changed",
                        "straggler_detected", "pod_crashed")
EVENT_KINDS = TRAINING_EVENT_KINDS + ("load_changed",)


@dataclass(frozen=True)
class CloudEvent:
    """A runtime change in the multi-cloud resource picture."""

    kind: str                                   # one of EVENT_KINDS
    region: str = ""                            # subject cloud (where relevant)
    time_s: float = 0.0                         # wall/sim time of the event
    resources: Optional[CloudResources] = None  # cloud_joined payload
    bandwidth_mbps: Optional[float] = None      # bandwidth_changed payload
    slowdown: float = 1.0                       # straggler_detected factor (>1)
    rps: Optional[float] = None                 # load_changed payload (req/s)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")


@dataclass(frozen=True)
class TrainingRequest:
    """User submission: model definition + training configuration."""

    model: str
    clouds: Tuple[CloudResources, ...]
    sync: SyncConfig = SyncConfig()
    n_iters: int = 100
    global_batch: int = 64


@dataclass(frozen=True)
class TrainingPlan:
    """Scheduler output: one sub-workflow deployment per cloud."""

    request: TrainingRequest
    resource_plans: Tuple[ResourcePlan, ...]
    batch_split: Tuple[int, ...]
    topology: Tuple[Tuple[int, int], ...]   # PS ring (sender -> receiver)
    ps_identities: Tuple[str, ...]          # assigned <IP, Port> per PS


class SchedulerFunction:
    """Responds first to a training request: loads the scheduling strategy
    and generates one training plan per cloud."""

    def __init__(self, strategy: str = "optimal_matching"):
        self.strategy = strategy

    def __call__(self, request: TrainingRequest) -> List[ResourcePlan]:
        if self.strategy == "optimal_matching":
            return optimal_matching(request.clouds)
        if self.strategy == "greedy":   # paper baseline: consume everything
            return [ResourcePlan(c.region, c.devices,
                                 load_power=0.0) for c in request.clouds]
        raise ValueError(self.strategy)


class CommunicatorFunction:
    """The global communicator: assigns WAN identities and plans the
    one-peer-per-round topology."""

    def __init__(self, base_port: int = 50_051):
        self.base_port = base_port
        self._registered: Dict[str, str] = {}   # region -> ps identity

    def register_ps(self, region: str, identity: str) -> None:
        self._registered[region] = identity

    def ready(self, regions: Sequence[str]) -> bool:
        return all(r in self._registered for r in regions)

    def assign(self, regions: Sequence[str]
               ) -> Tuple[Tuple[str, ...], Tuple[Tuple[int, int], ...]]:
        if not self.ready(regions):
            missing = [r for r in regions if r not in self._registered]
            raise RuntimeError(f"PS not ready in: {missing}")
        identities = tuple(
            f"10.0.{i}.1:{self.base_port + i}" for i, _ in enumerate(regions))
        n = len(regions)
        topology = tuple((i, (i + 1) % n) for i in range(n))
        return identities, topology


def build_training_plan(request: TrainingRequest) -> TrainingPlan:
    """Control-plane startup: scheduler -> PS registration -> communicator
    address + topology assignment."""
    plans = SchedulerFunction()(request)
    comm = CommunicatorFunction()
    regions = [c.region for c in request.clouds]
    for region in regions:
        comm.register_ps(region, f"{region}/ps#0")
    identities, topology = comm.assign(regions)
    powers = [p.load_power * c.data_size  # LP * S = raw compute power
              for p, c in zip(plans, request.clouds)]
    split = plan_batch_split(request.global_batch, powers)
    return TrainingPlan(request=request, resource_plans=tuple(plans),
                        batch_split=tuple(split), topology=topology,
                        ps_identities=identities)


@dataclass(frozen=True)
class ScaleDecision:
    """Serving-plane controller output: the replica-count transition and
    the observation that caused it (the serving analogue of
    :class:`ReconfigPlan`)."""

    event: CloudEvent
    old_replicas: int
    new_replicas: int
    reason: str

    @property
    def is_noop(self) -> bool:
        return self.new_replicas == self.old_replicas


class ServingElasticityController:
    """Replica autoscaler for the serving plane — the same controller
    family as :class:`ElasticityController`, consuming the same
    :class:`CloudEvent` stream off the same bus, but actuating replica
    count instead of Algorithm-1 allocations.

    Policy (mirrors the codec controllers' asymmetric streaks): scale *up*
    immediately when observed load exceeds what the current replicas can
    absorb — under-provisioning costs user latency now — and scale *down*
    only after ``hysteresis`` consecutive low-load observations, so a gap
    between bursts doesn't tear down replicas the next burst needs."""

    def __init__(self, *, replicas: int = 1, min_replicas: int = 1,
                 max_replicas: int = 8, target_rps_per_replica: float = 4.0,
                 hysteresis: int = 2, bus: Optional[Any] = None):
        if not (1 <= min_replicas <= replicas <= max_replicas):
            raise ValueError("need 1 <= min_replicas <= replicas "
                             "<= max_replicas")
        if target_rps_per_replica <= 0:
            raise ValueError("target_rps_per_replica must be positive")
        self.replicas = int(replicas)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.target_rps_per_replica = float(target_rps_per_replica)
        self.hysteresis = int(hysteresis)
        self._calm_streak = 0
        self.history: List[ScaleDecision] = []
        if bus is not None:
            bus.subscribe("load_changed", self.handle)

    def desired(self, rps: float) -> int:
        want = math.ceil(max(0.0, rps) / self.target_rps_per_replica)
        return max(self.min_replicas, min(self.max_replicas, max(1, want)))

    def handle(self, event: CloudEvent) -> ScaleDecision:
        if event.rps is None:
            raise ValueError("load_changed event needs rps")
        old = self.replicas
        want = self.desired(event.rps)
        if want > old:
            self._calm_streak = 0
            self.replicas = want
            reason = (f"scale-up {old}->{want}: rps={event.rps:.2f} > "
                      f"{old}x{self.target_rps_per_replica:g} rps capacity")
        elif want < old:
            self._calm_streak += 1
            if self._calm_streak >= self.hysteresis:
                self._calm_streak = 0
                self.replicas = want
                reason = (f"scale-down {old}->{want}: rps={event.rps:.2f} "
                          f"low for {self.hysteresis} consecutive "
                          f"observations")
            else:
                reason = (f"hold {old}: rps={event.rps:.2f} low "
                          f"({self._calm_streak}/{self.hysteresis} toward "
                          f"scale-down)")
        else:
            self._calm_streak = 0
            reason = f"hold {old}: rps={event.rps:.2f} within capacity"
        d = ScaleDecision(event=event, old_replicas=old,
                          new_replicas=self.replicas, reason=reason)
        self.history.append(d)
        return d
