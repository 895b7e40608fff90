"""Control plane: the serverless orchestration layer (paper §III.A, §IV).

Reimplements the paper's OpenFaaS customizations as an in-process runtime:

- **FunctionRegistry / AddressTable** — the paper extends OpenFaaS with a
  function addressing table storing ``identity, name, namespace, endpoint``
  per replica, with *dynamic* endpoint updates.  Reproduced exactly,
  including re-registration (endpoint churn) semantics.
- **Workflow / WorkflowEngine** — OpenFaaS is extended with DAG workflows;
  the gateway recognizes workflow invocations and invokes internal
  functions.  Reproduced as a topological executor with per-function scale
  (replica) counts and lifecycle hooks (serverless scale-to-zero on finish).
- **SchedulerFunction** — the control-plane cloud function that loads the
  elastic scheduling strategy (Algorithm 1), generates per-cloud training
  plans and invokes the per-cloud sub-workflows.
- **CommunicatorFunction** — the *global communicator*: waits for every
  cloud's PS to register, assigns a unique WAN identity ``<IP, Port>`` per
  PS communicator, and plans the inter-PS communication topology (each PS
  sends to exactly one peer per round — a ring).

A copy of the whole of ``repro/core/control_plane.py`` (host-only): the
registry, workflow engine, scheduler and communicator functions, the
event bus and both elasticity controllers.  Its outputs (resource plans,
ring topology, sync schedule) parameterize the port's launcher
(``repro_torch.launch.train``); a ``ReconfigPlan`` reaches the trainer
through ``repro_torch.training.trainer.apply_reconfig``.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.scheduler import (CloudResources, PlanDiff,
                                        ResourcePlan, diff_plans,
                                        incremental_matching, load_power,
                                        optimal_matching, plan_batch_split)
from repro_torch.core.sync import SyncConfig

# ---------------------------------------------------------------------------
# function registry + addressing (OpenFaaS customization #2)
# ---------------------------------------------------------------------------


@dataclass
class FunctionReplica:
    identity: str                # unique replica identity
    name: str                    # function name
    namespace: str               # cloud/region namespace
    endpoint: str                # dynamic endpoint (host:port)
    state: str = "ready"         # ready | running | terminated


class AddressTable:
    """identity -> replica record, with real-time endpoint updates."""

    def __init__(self):
        self._by_identity: Dict[str, FunctionReplica] = {}

    def register(self, rep: FunctionReplica) -> None:
        self._by_identity[rep.identity] = rep

    def update_endpoint(self, identity: str, endpoint: str) -> None:
        self._by_identity[identity].endpoint = endpoint

    def resolve(self, identity: str) -> str:
        rep = self._by_identity[identity]
        if rep.state == "terminated":
            raise LookupError(f"replica {identity} terminated")
        return rep.endpoint

    def lookup(self, *, name: Optional[str] = None,
               namespace: Optional[str] = None) -> List[FunctionReplica]:
        out = []
        for rep in self._by_identity.values():
            if name is not None and rep.name != name:
                continue
            if namespace is not None and rep.namespace != namespace:
                continue
            out.append(rep)
        return out

    def terminate(self, identity: str) -> None:
        self._by_identity[identity].state = "terminated"

    def __len__(self):
        return sum(1 for r in self._by_identity.values() if r.state != "terminated")


class FunctionRegistry:
    """Deployable cloud functions (name -> callable) per namespace."""

    def __init__(self):
        self._fns: Dict[Tuple[str, str], Callable] = {}
        self.addresses = AddressTable()
        self._ids = itertools.count()

    def deploy(self, namespace: str, name: str, fn: Callable) -> str:
        self._fns[(namespace, name)] = fn
        identity = f"{namespace}/{name}#{next(self._ids)}"
        self.addresses.register(FunctionReplica(
            identity=identity, name=name, namespace=namespace,
            endpoint=f"{namespace}.faas:{8000 + len(self.addresses)}"))
        return identity

    def invoke(self, namespace: str, name: str, *args, **kw):
        key = (namespace, name)
        if key not in self._fns:
            raise LookupError(f"function {name!r} not deployed in {namespace!r}")
        return self._fns[key](*args, **kw)


# ---------------------------------------------------------------------------
# workflow DAG (OpenFaaS customization #1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkflowNode:
    name: str                      # function name to invoke
    deps: Tuple[str, ...] = ()     # upstream node names
    terminate_after: bool = False  # serverless scale-to-zero on completion


@dataclass
class Workflow:
    """A DAG of cloud functions within one namespace."""

    namespace: str
    nodes: Dict[str, WorkflowNode] = field(default_factory=dict)

    def add(self, name: str, deps: Sequence[str] = (),
            terminate_after: bool = False) -> "Workflow":
        self.nodes[name] = WorkflowNode(name, tuple(deps), terminate_after)
        return self

    def topo_order(self) -> List[str]:
        order, seen, temp = [], set(), set()

        def visit(n: str):
            if n in seen:
                return
            if n in temp:
                raise ValueError(f"workflow cycle at {n!r}")
            temp.add(n)
            for d in self.nodes[n].deps:
                visit(d)
            temp.discard(n)
            seen.add(n)
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order


class WorkflowEngine:
    """Gateway extension: recognizes workflow invocations and drives the DAG."""

    def __init__(self, registry: FunctionRegistry):
        self.registry = registry
        self.history: List[Tuple[str, str]] = []   # (namespace, fn) invocations

    def run(self, wf: Workflow, context: Optional[dict] = None) -> dict:
        ctx = dict(context or {})
        for name in wf.topo_order():
            node = wf.nodes[name]
            self.history.append((wf.namespace, name))
            result = self.registry.invoke(wf.namespace, name, ctx)
            if result is not None:
                ctx[name] = result
            if node.terminate_after:
                for rep in self.registry.addresses.lookup(
                        name=name, namespace=wf.namespace):
                    self.registry.addresses.terminate(rep.identity)
        return ctx


# ---------------------------------------------------------------------------
# control-plane functions
# ---------------------------------------------------------------------------


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
    """Responds first to a training request (paper: 'the scheduler function
    responds first, loads the scheduling strategy, generates training plans
    for each cloud, and invocates sub workflows in each cloud')."""

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
        self._registered: Dict[str, str] = {}   # region -> ps function identity

    def register_ps(self, region: str, identity: str) -> None:
        self._registered[region] = identity

    def ready(self, regions: Sequence[str]) -> bool:
        return all(r in self._registered for r in regions)

    def assign(self, regions: Sequence[str]) -> Tuple[Tuple[str, ...],
                                                      Tuple[Tuple[int, int], ...]]:
        if not self.ready(regions):
            missing = [r for r in regions if r not in self._registered]
            raise RuntimeError(f"PS not ready in: {missing}")
        identities = tuple(
            f"10.0.{i}.1:{self.base_port + i}" for i, _ in enumerate(regions))
        n = len(regions)
        topology = tuple((i, (i + 1) % n) for i in range(n))
        return identities, topology


def build_training_plan(request: TrainingRequest) -> TrainingPlan:
    """Full control-plane startup phase: scheduler -> PS registration ->
    communicator address + topology assignment."""
    scheduler = SchedulerFunction()
    plans = scheduler(request)

    comm = CommunicatorFunction()
    regions = [c.region for c in request.clouds]
    for region in regions:
        comm.register_ps(region, f"{region}/ps#0")
    identities, topology = comm.assign(regions)

    powers = [p.load_power * c.data_size  # LP * S = raw compute power
              for p, c in zip(plans, request.clouds)]
    split = plan_batch_split(request.global_batch, powers)

    return TrainingPlan(
        request=request,
        resource_plans=tuple(plans),
        batch_split=tuple(split),
        topology=topology,
        ps_identities=identities,
    )


def reschedule(plan: TrainingPlan,
               new_clouds: Tuple[CloudResources, ...]) -> TrainingPlan:
    """Rescheduling path (paper: the communicator must 'notify each PS in
    preparation or when rescheduling happens'): re-run Algorithm 1 against
    the new resource picture, re-assign WAN identities and re-plan the ring.
    Training state survives through the trainer's pod re-stacking
    (``repro_torch.training.trainer.resize_train_state``)."""
    request = TrainingRequest(
        model=plan.request.model, clouds=new_clouds, sync=plan.request.sync,
        n_iters=plan.request.n_iters, global_batch=plan.request.global_batch)
    return build_training_plan(request)


# ---------------------------------------------------------------------------
# elasticity engine (paper §III.B "elastic scheduling" made mid-training)
# ---------------------------------------------------------------------------


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


class EventDeliveryError(RuntimeError):
    """One or more subscribers raised during ``EventBus.publish``; every
    subscriber still saw the event first.  ``errors`` holds the
    ``(subscriber, exception)`` pairs in delivery order."""

    def __init__(self, event: "CloudEvent", errors: List[Tuple[Callable,
                                                               Exception]]):
        self.event = event
        self.errors = errors
        super().__init__(
            f"{len(errors)} subscriber(s) failed on {event.kind!r}: "
            + "; ".join(repr(e) for _, e in errors))


class EventBus:
    """Tiny in-process pub/sub: the WAN monitor / health checker side of the
    paper's communicator publishes, the ElasticityController subscribes."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self.history: List[CloudEvent] = []

    def subscribe(self, kind: str, fn: Callable) -> None:
        if kind != "*" and kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        self._subs.setdefault(kind, []).append(fn)

    def publish(self, event: CloudEvent) -> List:
        """Deliver ``event`` to every subscriber, then surface errors.

        Delivery is isolated: one raising subscriber no longer aborts
        delivery to every later one (on a ``pod_crashed`` that would mean
        part of the control plane never hears about the crash).  A single
        collected error re-raises as itself after the fan-out completes;
        multiple raise one :class:`EventDeliveryError` carrying them all."""
        self.history.append(event)
        out: List = []
        errors: List[Tuple[Callable, Exception]] = []
        for fn in self._subs.get(event.kind, []) + self._subs.get("*", []):
            try:
                out.append(fn(event))
            except Exception as e:   # noqa: BLE001 — isolation is the point
                errors.append((fn, e))
        if errors:
            if len(errors) == 1:
                raise errors[0][1]
            raise EventDeliveryError(event, errors)
        return out


@dataclass(frozen=True)
class ReconfigPlan:
    """Controller output: the old plan, the re-matched plan, and the diff the
    trainer needs to decide whether (and how) to re-stack pods."""

    event: CloudEvent
    old: TrainingPlan
    new: TrainingPlan
    diff: PlanDiff

    @property
    def is_noop(self) -> bool:
        return (self.diff.is_empty
                and self.new.batch_split == self.old.batch_split
                and self.new.request.sync == self.old.request.sync
                and self.new.topology == self.old.topology)

    def pod_transition(self) -> Tuple[Tuple[int, ...], int]:
        """(keep, n_new): old pod indices that survive, in new pod order, and
        the new pod count — the arguments of the trainer's re-stacking."""
        old_regions = [p.region for p in self.old.resource_plans]
        new_regions = [p.region for p in self.new.resource_plans]
        keep = tuple(old_regions.index(r) for r in new_regions
                     if r in old_regions)
        return keep, len(new_regions)

    def migration_bill(self, model_mb: float,
                       bandwidth_mbps: float) -> Dict[str, float]:
        """Cost of applying this plan as a *live migration* instead of a
        checkpointed full pause (the async snapshot engine's path).

        ``barrier_s`` is the only stall the active regions pay: one
        barrier-aligned payload transfer to reconcile the staged state
        against the live barrier state — at most one sync round; zero when
        the diff is structurally empty (an interval/batch-split move
        re-stacks nothing).  ``migrate_mb`` is the snapshot shipment the
        engine streamed in the background — one full model replica per
        joining or leaving region — billed as overlapped traffic, never
        as pause.  The re-plan itself also overlaps with compute."""
        structural = not self.diff.is_empty
        moved = len(self.diff.added) + len(self.diff.removed)
        return {
            "barrier_s": (model_mb * 8.0 / bandwidth_mbps) if structural
            else 0.0,
            "migrate_mb": float(model_mb * moved),
        }


def adapt_interval(sync: SyncConfig, base_interval: int,
                   ref_bandwidth_mbps: float, bandwidth_mbps: float,
                   max_interval: int = 64) -> SyncConfig:
    """Scale the sync interval inversely with available WAN bandwidth (the
    §III.C sync-frequency knob driven by the §III.B monitor): half the
    bandwidth -> double the interval, so per-step blocking communication time
    stays roughly constant.  ASGD (interval-free baseline) is left alone."""
    if sync.strategy == "asgd" or bandwidth_mbps <= 0:
        return sync
    k = round(base_interval * ref_bandwidth_mbps / bandwidth_mbps)
    k = max(1, min(max_interval, k))
    if k == sync.interval:
        return sync
    return replace(sync, interval=k)


class ElasticityController:
    """Long-lived control-plane loop (tentpole of the elasticity engine).

    Consumes ``CloudEvent``s — from an :class:`EventBus`, the WAN simulator,
    or the launcher's host loop — maintains the current resource picture
    (clouds, per-region straggler factors, WAN bandwidth estimate), re-runs
    Algorithm 1 *incrementally* against it, and emits a
    :class:`ReconfigPlan` whose diff the trainer applies at the next sync
    barrier via checkpointed pod re-stacking."""

    def __init__(self, plan: TrainingPlan, bus: Optional[EventBus] = None,
                 ref_bandwidth_mbps: float = 100.0, max_interval: int = 64,
                 probe_est=None):
        self.plan = plan
        self.clouds: Dict[str, CloudResources] = {
            c.region: c for c in plan.request.clouds}
        self.slowdowns: Dict[str, float] = {}
        self.ref_bandwidth_mbps = ref_bandwidth_mbps
        self.bandwidth_mbps = ref_bandwidth_mbps
        # measured-bandwidth source (duck-typed: anything with a
        # ``bandwidth_mbps`` attribute — a WanProbeEstimator, a
        # MeasuredWanProbe's estimator).  When set, every replan reads the
        # shared measured belief instead of trusting the last trace-driven
        # ``bandwidth_changed`` event — the control plane and the sync
        # controllers then act on ONE bandwidth picture.
        self.probe_est = probe_est
        self.base_interval = plan.request.sync.interval
        self.max_interval = max_interval
        self.history: List[ReconfigPlan] = []
        if bus is not None:
            for kind in TRAINING_EVENT_KINDS:
                bus.subscribe(kind, self.handle)

    # ------------------------------------------------------------ events
    def handle(self, event: CloudEvent) -> ReconfigPlan:
        if event.kind == "cloud_joined":
            if event.resources is None:
                raise ValueError("cloud_joined event needs resources")
            self.clouds[event.resources.region] = event.resources
        elif event.kind in ("cloud_left", "pod_crashed"):
            # a crash is an involuntary departure: same re-matching as a
            # graceful leave — the region's resources are gone either way
            if event.region not in self.clouds:
                raise KeyError(f"unknown region {event.region!r}")
            if len(self.clouds) == 1:
                raise ValueError("cannot remove the last cloud")
            del self.clouds[event.region]
            self.slowdowns.pop(event.region, None)
        elif event.kind == "bandwidth_changed":
            if event.bandwidth_mbps is None:
                raise ValueError("bandwidth_changed event needs bandwidth_mbps")
            self.bandwidth_mbps = event.bandwidth_mbps
        elif event.kind == "straggler_detected":
            self.slowdowns[event.region] = max(1.0, event.slowdown)
        if self.probe_est is not None:
            measured = getattr(self.probe_est, "bandwidth_mbps", None)
            if measured is not None:
                # measured belief wins over the event's claimed figure
                self.bandwidth_mbps = float(measured)
        reconfig = self._replan(event)
        self.history.append(reconfig)
        self.plan = reconfig.new
        return reconfig

    # ------------------------------------------------------------ replan
    def _effective_clouds(self) -> Tuple[CloudResources, ...]:
        """Straggler factors enter Algorithm 1 as inflated effective data
        sizes (same iterations take ``slowdown`` times longer per unit of
        computing power)."""
        out = []
        for c in self.clouds.values():
            f = self.slowdowns.get(c.region, 1.0)
            out.append(replace(c, data_size=c.data_size * f) if f != 1.0 else c)
        return tuple(out)

    def _replan(self, event: CloudEvent) -> ReconfigPlan:
        old = self.plan
        effective = self._effective_clouds()
        plans = incremental_matching(effective, prev=old.resource_plans)

        regions = [c.region for c in effective]
        comm = CommunicatorFunction()
        for region in regions:
            comm.register_ps(region, f"{region}/ps#0")
        identities, topology = comm.assign(regions)

        # slowdown-discounted raw compute power drives the batch re-split
        powers = [load_power(p.allocation, 1.0)
                  / self.slowdowns.get(p.region, 1.0) for p in plans]
        split = plan_batch_split(old.request.global_batch, powers)

        sync = adapt_interval(old.request.sync, self.base_interval,
                              self.ref_bandwidth_mbps, self.bandwidth_mbps,
                              self.max_interval)
        request = TrainingRequest(
            model=old.request.model,
            clouds=tuple(self.clouds.values()),
            sync=sync, n_iters=old.request.n_iters,
            global_batch=old.request.global_batch)
        new = TrainingPlan(request=request, resource_plans=tuple(plans),
                           batch_split=tuple(split), topology=topology,
                           ps_identities=identities)
        return ReconfigPlan(event=event, old=old, new=new,
                            diff=diff_plans(old.resource_plans, plans))


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
                 hysteresis: int = 2, bus: Optional[EventBus] = None):
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


def training_workflow(region: str) -> Workflow:
    """The per-cloud physical-training-plane workflow (paper Fig 4): data
    access -> worker training functions -> PS update -> PS communicator,
    with workers terminated immediately after local training finishes."""
    wf = Workflow(namespace=region)
    wf.add("load_data")
    wf.add("workers", deps=["load_data"], terminate_after=True)
    wf.add("ps_update", deps=["workers"])
    wf.add("ps_communicator", deps=["ps_update"])
    return wf
