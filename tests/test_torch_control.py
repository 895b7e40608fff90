"""Port parity: the control plane (``repro_torch.core.control_plane``) —
function registry, workflow engine, event bus, ``ReconfigPlan``,
``adapt_interval``, ``ElasticityController``, ``reschedule`` — and the
trainer's reconfiguration at a barrier, against the reference.

The reference's cases (``tests/test_elasticity.py``, ``tests/test_wan.py``)
run on the port; the controller's plans for the same event streams must
equal the reference's field for field; and the elasticity benchmark's
recorded decision stream and static/elastic accounting
(``experiments/bench/BENCH_elasticity.json``) replay through the port
exactly.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

from benchmarks import elasticity as jbench
from repro.core import control_plane as jcp
from repro.core import scheduler as jsched
from repro.core import sync as jsync
from repro_torch.core import control_plane as tcp
from repro_torch.core import scheduler as tsched
from repro_torch.core.control_plane import (
    TRAINING_EVENT_KINDS, AddressTable, CloudEvent, CommunicatorFunction,
    ElasticityController, EventBus, EventDeliveryError, FunctionRegistry,
    FunctionReplica, ReconfigPlan, TrainingRequest, Workflow,
    WorkflowEngine, adapt_interval, build_training_plan, reschedule,
    training_workflow)
from repro_torch.core.scheduler import CloudResources, load_power
from repro_torch.core.sync import SyncConfig
from repro_torch.core.wan import SimCloud, SimEvent, WANConfig, simulate
from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                          apply_reconfig, resize_train_state)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "experiments", "bench", "BENCH_elasticity.json")

_CLOUDS = (("sh", (("cascade", 6),), 2.0), ("cq", (("sky", 6),), 1.0),
           ("bj", (("sky", 3),), 1.0))
CLOUDS = tuple(CloudResources(r, d, data_size=s) for r, d, s in _CLOUDS)
JCLOUDS = tuple(jsched.CloudResources(r, d, data_size=s)
                for r, d, s in _CLOUDS)


def _plan(sync=SyncConfig("asgd_ga", 8), clouds=CLOUDS, batch=96):
    return build_training_plan(TrainingRequest(
        model="m", clouds=clouds, sync=sync, global_batch=batch))


def _jplan(sync=jsync.SyncConfig("asgd_ga", 8), clouds=JCLOUDS, batch=96):
    return jcp.build_training_plan(jcp.TrainingRequest(
        model="m", clouds=clouds, sync=sync, global_batch=batch))


def _flat(plan):
    """A TrainingPlan as plain values (either package's)."""
    s = plan.request.sync
    return (tuple((p.region, p.allocation, p.load_power)
                  for p in plan.resource_plans),
            plan.batch_split, plan.topology, plan.ps_identities,
            tuple((c.region, c.devices, c.data_size)
                  for c in plan.request.clouds),
            (s.strategy, s.interval), plan.request.global_batch)


# ---------------------------------------------- registry and workflows


def test_address_table_dynamic_endpoints():
    t = AddressTable()
    t.register(FunctionReplica("sh/ps#0", "ps", "sh", "10.0.0.1:50051"))
    assert t.resolve("sh/ps#0") == "10.0.0.1:50051"
    t.update_endpoint("sh/ps#0", "10.0.0.9:50051")
    assert t.resolve("sh/ps#0") == "10.0.0.9:50051"
    t.terminate("sh/ps#0")
    with pytest.raises(LookupError):
        t.resolve("sh/ps#0")


def test_workflow_topology_and_scale_to_zero():
    reg = FunctionRegistry()
    calls = []
    for name in ("load_data", "workers", "ps_update", "ps_communicator"):
        reg.deploy("sh", name, lambda ctx, n=name: calls.append(n))
    eng = WorkflowEngine(reg)
    eng.run(training_workflow("sh"))
    assert calls == ["load_data", "workers", "ps_update", "ps_communicator"]
    workers = reg.addresses.lookup(name="workers", namespace="sh")
    assert all(r.state == "terminated" for r in workers)
    jwf = jcp.training_workflow("sh")
    assert training_workflow("sh").topo_order() == jwf.topo_order()


def test_workflow_cycle_detection():
    wf = Workflow("x")
    wf.add("a", deps=["b"])
    wf.add("b", deps=["a"])
    with pytest.raises(ValueError):
        wf.topo_order()


def test_communicator_requires_all_ps():
    comm = CommunicatorFunction()
    comm.register_ps("sh", "sh/ps#0")
    with pytest.raises(RuntimeError):
        comm.assign(["sh", "cq"])
    comm.register_ps("cq", "cq/ps#0")
    ids, topo = comm.assign(["sh", "cq"])
    assert len(ids) == 2 and topo == ((0, 1), (1, 0))


def test_build_training_plan_and_reschedule_equal_the_reference():
    req = TrainingRequest(model="lenet", clouds=CLOUDS[:2],
                          sync=SyncConfig("ama", 8), global_batch=96)
    jreq = jcp.TrainingRequest(model="lenet", clouds=JCLOUDS[:2],
                               sync=jsync.SyncConfig("ama", 8),
                               global_batch=96)
    plan, jplan = build_training_plan(req), jcp.build_training_plan(jreq)
    assert _flat(plan) == _flat(jplan)
    assert sum(plan.batch_split) == 96
    assert plan.batch_split[0] > plan.batch_split[1]
    assert plan.topology == ((0, 1), (1, 0))
    plan2 = reschedule(plan, CLOUDS)
    assert _flat(plan2) == _flat(jcp.reschedule(jplan, JCLOUDS))
    assert len(plan2.ps_identities) == 3
    assert plan2.topology == ((0, 1), (1, 2), (2, 0))
    assert sum(plan2.batch_split) == 96


# ----------------------------------------------------------- event bus


def test_event_bus_routes_to_controller():
    bus = EventBus()
    ctl = ElasticityController(_plan(), bus=bus)
    out = bus.publish(CloudEvent("cloud_left", region="bj", time_s=1.0))
    assert len(out) == 1 and out[0].diff.removed == ("bj",)
    assert ctl.plan is out[0].new
    assert bus.history[0].kind == "cloud_left"
    with pytest.raises(ValueError):
        bus.subscribe("nope", lambda e: e)
    with pytest.raises(ValueError):
        CloudEvent("not_a_kind")


def test_event_bus_isolates_failing_subscribers():
    bus = EventBus()
    seen = []

    def boom(e):
        raise RuntimeError("boom")

    bus.subscribe("pod_crashed", boom)
    bus.subscribe("pod_crashed", seen.append)
    bus.subscribe("*", seen.append)
    with pytest.raises(RuntimeError, match="boom"):
        bus.publish(CloudEvent("pod_crashed", region="sh"))
    assert len(seen) == 2               # every subscriber saw it first
    bus.subscribe("pod_crashed", boom)
    with pytest.raises(EventDeliveryError) as err:
        bus.publish(CloudEvent("pod_crashed", region="sh"))
    assert len(err.value.errors) == 2 and len(seen) == 4


# --------------------------------------------------- controller re-planning


def test_cloud_left_replans_to_match_straggler():
    ctl = ElasticityController(_plan())
    rc = ctl.handle(CloudEvent("cloud_left", region="cq", time_s=10.0))
    plans = rc.new.resource_plans
    assert [p.region for p in plans] == ["sh", "bj"]
    ref = min(load_power(c.devices, c.data_size)
              for c in CLOUDS if c.region != "cq")
    for p in plans:
        assert p.load_power >= ref - 1e-9
        cloud = next(c for c in CLOUDS if c.region == p.region)
        for i, (dev, n) in enumerate(p.allocation):
            if n == 1 and len(p.allocation) == 1:
                continue
            trimmed = tuple((d, m - 1 if j == i else m)
                            for j, (d, m) in enumerate(p.allocation) if
                            (m - 1 if j == i else m) > 0)
            assert load_power(trimmed, cloud.data_size) < ref - 1e-12


def test_cloud_joined_extends_ring_and_split():
    ctl = ElasticityController(_plan(clouds=CLOUDS[:2]))
    rc = ctl.handle(CloudEvent("cloud_joined", time_s=5.0,
                               resources=CLOUDS[2]))
    assert rc.diff.added == ("bj",)
    assert len(rc.new.ps_identities) == 3
    assert rc.new.topology == ((0, 1), (1, 2), (2, 0))
    assert sum(rc.new.batch_split) == 96
    assert rc.pod_transition() == ((0, 1), 3)


def test_bandwidth_change_adapts_interval_not_plan():
    ctl = ElasticityController(_plan(), ref_bandwidth_mbps=100.0)
    rc = ctl.handle(CloudEvent("bandwidth_changed", bandwidth_mbps=25.0))
    assert rc.diff.is_empty
    assert rc.new.request.sync.interval == 32
    assert not rc.is_noop
    rc2 = ctl.handle(CloudEvent("bandwidth_changed", bandwidth_mbps=100.0))
    assert rc2.new.request.sync.interval == 8


def test_straggler_event_rebalances_split():
    ctl = ElasticityController(_plan())
    rc = ctl.handle(CloudEvent("straggler_detected", region="sh",
                               slowdown=2.0))
    sh_i = [p.region for p in rc.new.resource_plans].index("sh")
    assert rc.new.batch_split[sh_i] < rc.old.batch_split[sh_i]


def test_identical_event_is_noop():
    ctl = ElasticityController(_plan())
    rc = ctl.handle(CloudEvent("bandwidth_changed", bandwidth_mbps=100.0))
    assert rc.is_noop and rc.diff.is_empty


def test_controller_refuses_removing_last_cloud():
    ctl = ElasticityController(_plan(clouds=CLOUDS[:1]))
    with pytest.raises(ValueError):
        ctl.handle(CloudEvent("cloud_left", region="sh"))
    with pytest.raises(KeyError):
        ctl.handle(CloudEvent("cloud_left", region="nowhere"))


def test_adapt_interval_clamps():
    sync = SyncConfig("asgd_ga", 8)
    assert adapt_interval(sync, 8, 100.0, 1.0, max_interval=64).interval == 64
    assert adapt_interval(sync, 8, 100.0, 1e6).interval == 1
    assert adapt_interval(SyncConfig("asgd", 1), 1, 100.0, 25.0).interval == 1
    for bw in (0.3, 7.0, 33.0, 100.0, 250.0, 4e3):
        assert adapt_interval(sync, 8, 100.0, bw).interval == \
            jcp.adapt_interval(jsync.SyncConfig("asgd_ga", 8), 8, 100.0,
                               bw).interval


def _random_events(seed, mod, clouds_mod):
    rng = random.Random(seed)
    live = ["sh", "cq", "bj"]
    spare = ["eu", "us"]
    out = []
    for t in range(10):
        kind = rng.choice(["bw", "left", "join", "straggler", "crash"])
        if kind == "bw":
            out.append(mod.CloudEvent("bandwidth_changed", time_s=t,
                                      bandwidth_mbps=rng.choice(
                                          [5.0, 25.0, 60.0, 100.0, 400.0])))
        elif kind in ("left", "crash") and len(live) > 1:
            r = live.pop(rng.randrange(len(live)))
            out.append(mod.CloudEvent(
                "cloud_left" if kind == "left" else "pod_crashed",
                region=r, time_s=t))
        elif kind == "join" and spare:
            r = spare.pop()
            live.append(r)
            out.append(mod.CloudEvent("cloud_joined", time_s=t,
                                      resources=clouds_mod.CloudResources(
                                          r, (("v5e", 4),), data_size=1.5)))
        elif live:
            out.append(mod.CloudEvent("straggler_detected", time_s=t,
                                      region=rng.choice(live),
                                      slowdown=rng.choice([1.5, 2.0, 3.0])))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_controller_plans_equal_the_reference(seed):
    """The same event stream through both controllers: every plan, diff,
    pod transition and no-op flag agrees."""
    ctl = ElasticityController(_plan(), ref_bandwidth_mbps=100.0)
    jctl = jcp.ElasticityController(_jplan(), ref_bandwidth_mbps=100.0)
    tev = _random_events(seed, tcp, tsched)
    jev = _random_events(seed, jcp, jsched)
    for a, b in zip(tev, jev):
        ra, rb = ctl.handle(a), jctl.handle(b)
        assert _flat(ra.new) == _flat(rb.new)
        assert (ra.diff.summary(), ra.is_noop, ra.pod_transition()) == \
            (rb.diff.summary(), rb.is_noop, rb.pod_transition())
        assert ra.migration_bill(44.6, 25.0) == rb.migration_bill(44.6, 25.0)


def test_bus_feeds_both_actuators_one_event():
    """One bandwidth event on the shared bus reaches the elasticity
    controller and the codec autotuner, as in the launcher."""
    from repro_torch.core.autotune import AdaptiveSyncController

    bus = EventBus()
    sync = SyncConfig("asgd_ga", 8, compress_topk=0.05, quantize_int8=True,
                      error_feedback=True)
    ctl = ElasticityController(_plan(sync=sync), bus=bus)
    tuner = AdaptiveSyncController(sync, 44.6, 0.5, bus=bus)
    out = bus.publish(CloudEvent("bandwidth_changed", bandwidth_mbps=25.0))
    assert isinstance(out[0], ReconfigPlan)
    assert ctl.plan.request.sync.interval == 32
    assert tuner.probe.bandwidth_mbps == 25.0
    assert set(TRAINING_EVENT_KINDS) == set(jcp.TRAINING_EVENT_KINDS)


# ------------------------------------------------ trainer re-stacking


def _toy_trainer(n_pods, sync, optimizer="momentum"):
    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    def init_fn(gen):
        return {"w": torch.randn(4, 1, generator=gen) * 0.1}

    return Trainer(loss_fn, init_fn,
                   TrainerConfig(n_pods=n_pods, optimizer=optimizer,
                                 lr=0.05, sync=sync), device="cpu")


def test_apply_reconfig_noop_on_empty_diff():
    ctl = ElasticityController(_plan())
    rc = ctl.handle(CloudEvent("bandwidth_changed", bandwidth_mbps=100.0))
    trainer = _toy_trainer(3, SyncConfig("asgd_ga", 8))
    state = trainer.init_state(2)
    out_trainer, out_state, applied = apply_reconfig(trainer, state, rc)
    assert not applied and out_trainer is trainer and out_state is state


def test_apply_reconfig_cloud_left_restacks():
    ctl = ElasticityController(_plan())
    rc = ctl.handle(CloudEvent("cloud_left", region="cq", time_s=3.0))
    trainer = _toy_trainer(3, SyncConfig("asgd_ga", 8))
    state = trainer.init_state(3)
    state.params["w"].add_(torch.randn(3, 4, 1,
                                       generator=torch.Generator()
                                       .manual_seed(9)))
    mean_before = state.params["w"].mean(0).clone()
    out_trainer, out_state, applied = apply_reconfig(trainer, state, rc)
    assert applied and out_trainer.cfg.n_pods == 2
    torch.testing.assert_close(out_state.params["w"].mean(0), mean_before,
                               atol=1e-6, rtol=0)
    assert out_trainer.cfg.sync == rc.new.request.sync


def test_resize_train_state_rejects_bad_keep():
    trainer = _toy_trainer(3, SyncConfig("sma", 4))
    state = trainer.init_state(4)
    with pytest.raises(ValueError):
        resize_train_state(trainer.cfg.sync, state, 1, keep=(0, 1))


# ------------------------------------------------- WAN event injection


def _sim(events=()):
    clouds = [SimCloud("sh", iter_time_s=0.12, units=12),
              SimCloud("cq", iter_time_s=0.08, units=12)]
    return simulate(clouds, SyncConfig("asgd_ga", 8), n_iters=200,
                    model_mb=0.6, wan=WANConfig(seed=1), events=events)


def test_wan_events_as_the_reference_tests():
    base = _sim()
    assert base.makespan_s == _sim(events=()).makespan_s
    slow = _sim([SimEvent(5.0, "bandwidth_changed", bandwidth_mbps=5.0)])
    assert slow.makespan_s > base.makespan_s
    left = _sim([SimEvent(5.0, "cloud_left", region="cq")])
    assert left.total_cost < base.total_cost
    rec = _sim([SimEvent(5.0, "reconfig",
                         clouds=[SimCloud("sh", 0.06, units=24)],
                         sync=SyncConfig("asgd_ga", 16), pause_s=3.0)])
    assert rec.n_reconfigs == 1 and rec.sync_cfg.interval == 16
    joined = _sim([SimEvent(5.0, "cloud_joined",
                            cloud=SimCloud("bj", 0.1, units=6))])
    assert sorted(c.region for c in joined.clouds) == ["bj", "cq", "sh"]


# ------------------------------------------ BENCH_elasticity.json replay


def _paper_clouds():
    return tuple(CloudResources(c.region, c.devices, data_size=c.data_size)
                 for c in jbench.paper_clouds())


def _sim_clouds(plan):
    return [SimCloud(region=p.region,
                     iter_time_s=jbench.KAPPA * b / load_power(p.allocation,
                                                               1.0),
                     units=p.units)
            for p, b in zip(plan.resource_plans, plan.batch_split)]


def test_replay_elasticity_benchmark():
    """``benchmarks/elasticity.py``'s scenario through the port's control
    plane and simulator: the migration decision stream and the static /
    elastic accounting equal the committed baseline."""
    with open(BENCH) as f:
        base = json.load(f)
    E = jbench
    request = TrainingRequest(model="resnet18", clouds=_paper_clouds(),
                              sync=SyncConfig("asgd_ga", 8),
                              n_iters=E.N_ITERS,
                              global_batch=base["scenario"]["global_batch"])
    plan = build_training_plan(request)
    sims = _sim_clouds(plan)
    wan = WANConfig(bandwidth_mbps=100.0, seed=0)
    split = dict(zip((p.region for p in plan.resource_plans),
                     plan.batch_split))
    ring = dict((plan.resource_plans[b].region, plan.resource_plans[a].region)
                for a, b in plan.topology)
    absorber = ring["chongqing"]
    static = simulate(sims, request.sync, n_iters=E.N_ITERS,
                      model_mb=E.MODEL_MB, wan=wan, events=[
                          SimEvent(E.T_LEAVE, "cloud_left",
                                   region="chongqing"),
                          SimEvent(E.T_LEAVE, "slowdown", region=absorber,
                                   factor=(split[absorber]
                                           + split["chongqing"])
                                   / split[absorber]),
                          SimEvent(E.T_BANDWIDTH, "bandwidth_changed",
                                   bandwidth_mbps=E.NEW_BANDWIDTH)])
    controller = ElasticityController(plan, ref_bandwidth_mbps=100.0)
    rc_leave = controller.handle(CloudEvent("cloud_left", region="chongqing",
                                            time_s=E.T_LEAVE))
    rc_bw = controller.handle(CloudEvent(
        "bandwidth_changed", bandwidth_mbps=E.NEW_BANDWIDTH,
        time_s=E.T_BANDWIDTH))
    migrations = [E.migration_decision(rc_leave, E.MODEL_MB, 100.0),
                  E.migration_decision(rc_bw, E.MODEL_MB, E.NEW_BANDWIDTH)]
    assert migrations == base["migration"]["decisions"]
    events = []
    for t, rc, m in ((E.T_LEAVE, rc_leave, migrations[0]),
                     (E.T_BANDWIDTH, rc_bw, migrations[1])):
        if rc is rc_bw:
            events.append(SimEvent(t, "bandwidth_changed",
                                   bandwidth_mbps=E.NEW_BANDWIDTH))
        events.append(SimEvent(t, "reconfig", clouds=_sim_clouds(rc.new),
                               sync=rc.new.request.sync, migration=True,
                               barrier_s=m["barrier_s"],
                               migrate_mb=m["migrate_mb"],
                               pause_s=m["pause_replaced_s"]))
    elastic = simulate(sims, request.sync, n_iters=E.N_ITERS,
                       model_mb=E.MODEL_MB, wan=wan, events=events)
    assert E._accounting(static) == base["static"]
    assert E._accounting(elastic) == base["elastic"]
    assert round(static.makespan_s / elastic.makespan_s, 3) == \
        base["speedup"]
    assert round(1.0 - elastic.total_cost / static.total_cost, 3) == \
        base["cost_reduction"]
    assert round(1.0 - elastic.total_traffic_mb / static.total_traffic_mb,
                 3) == base["traffic_reduction"]
    assert [rc_leave.diff.summary(), rc_bw.diff.summary()] == \
        base["scenario"]["elastic_diffs"]
    assert list(rc_bw.new.batch_split) == \
        base["scenario"]["elastic_batch_split"]
    assert np.isfinite(base["speedup"]) and base["speedup"] > 1.0
