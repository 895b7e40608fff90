"""Control plane, plan half: request -> scheduler -> communicator -> plan.

Counterpart of ``repro/core/control_plane.py`` (its lines 182-268): the
scheduler function runs the elastic scheduling strategy (Algorithm 1), each
cloud's parameter server registers with the global communicator, which
assigns WAN identities and the one-peer-per-round ring.  The function
registry, workflow engine and the elasticity controller are ROADMAP Queue 1
item 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.scheduler import (CloudResources, ResourcePlan,
                                        optimal_matching, plan_batch_split)
from repro_torch.core.sync import SyncConfig


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
