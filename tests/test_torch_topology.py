"""Port parity: the aggregation topology without transports
(``repro_torch.core.topology``: ``LinkLeg``, ``Phase``,
``AggregationSchedule``, ``TopologySpec``, ``TopologyPlanner``) against
``repro.core.topology``.

The reference's planner and schedule cases (``tests/test_topology.py``)
that need no ``HierarchicalTransport`` run on the port; the same beliefs
compile the same schedule and the same streams give the same planner and
controller decisions as the reference's, exactly; and the topology
scenario of ``experiments/bench/BENCH_autotune.json`` replays through a
fresh ``LinkBeliefs`` + ``TopologyPlanner`` decision for decision, reason
strings (with their cost estimates) included.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import sync as jsync
from repro.core import topology as jtopology
from repro_torch.core import autotune as tautotune
from repro_torch.core import sync as tsync
from repro_torch.core import topology as ttopology
from repro_torch.core.autotune import AdaptiveSyncController, BucketStats
from repro_torch.core.cost import adaptive_traffic_mb, bucket_payload_table
from repro_torch.core.sync import SyncConfig, hierarchical_average
from repro_torch.core.topology import (TOPOLOGY_KINDS, LinkBeliefs,
                                       TopologyPlanner, TopologySpec,
                                       link_key)
from repro_torch.core.wan import SimCloud, WANConfig, simulate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "experiments", "bench", "BENCH_autotune.json")


def _random_grouping(rng, n_pods):
    n_groups = int(rng.integers(1, n_pods + 1))
    assign = np.concatenate([np.arange(n_groups),
                             rng.integers(0, n_groups, n_pods - n_groups)])
    rng.shuffle(assign)
    return [f"r{assign[i]}" for i in range(n_pods)]


def _sched(s):
    """An AggregationSchedule as plain values (either package's)."""
    return (s.kind, s.root,
            tuple((p.kind, p.wan,
                   tuple((l.src, l.dst, l.via, l.hops if p.wan else None)
                         for l in p.legs))
                  for p in s.phases),
            s.wan_transfers, s.uses_aux_route)


# -------------------------------------------------------- schedule compile


def test_tree_schedule_structure_and_counts():
    spec = TopologySpec.from_regions(["sh", "sh", "cq", "gz"], kind="tree")
    sched = spec.compile(LinkBeliefs(default_mbps=100.0))
    assert [p.kind for p in sched.phases] == \
        ["intra-reduce", "gather", "broadcast", "intra-bcast"]
    assert sched.root in ("sh", "cq", "gz")
    assert sched.wan_transfers == 4
    assert not sched.uses_aux_route
    assert all(not p.wan for p in sched.phases
               if p.kind.startswith("intra"))
    assert TOPOLOGY_KINDS == jtopology.TOPOLOGY_KINDS


def test_singleton_ring_matches_flat_pod_count():
    for n in (2, 3, 5):
        spec = TopologySpec.from_regions([f"p{i}" for i in range(n)],
                                         kind="ring")
        assert spec.compile(LinkBeliefs()).wan_transfers == n


def test_ring_order_maximizes_bottleneck_link():
    spec = TopologySpec.from_regions(["a", "b", "c", "d"], kind="ring")
    b = LinkBeliefs(default_mbps=100.0)
    for x, y in (("a", "c"), ("c", "b"), ("b", "d"), ("d", "a")):
        b.observe(x, y, 100.0)
    b.observe("a", "b", 1.0)
    b.observe("c", "d", 1.0)
    sched = spec.compile(b)
    crossed = {hop for leg in sched.wan_legs for hop in leg.hops}
    assert link_key("a", "b") not in crossed
    assert link_key("c", "d") not in crossed
    assert sched.wan_transfers == 4


def test_aux_route_fires_only_past_collapse_ratio():
    spec = TopologySpec.from_regions(["root", "hub1", "hub2", "leaf"],
                                     kind="tree")
    b = LinkBeliefs(default_mbps=100.0)
    b.observe("root", "hub1", 1000.0)
    b.observe("root", "hub2", 1000.0)
    b.observe("leaf", "hub1", 100.0)
    b.observe("leaf", "hub2", 10.0)
    b.observe("root", "leaf", 50.0)
    sched = spec.compile(b)
    assert sched.root == "root" and not sched.uses_aux_route
    assert sched.wan_transfers == 2 * 3
    b.observe("root", "leaf", 5.0)
    sched = spec.compile(b)
    assert sched.root == "root"
    (leg,) = [l for l in sched.wan_legs
              if l.src == "leaf" and l.dst == "root"]
    assert leg.via == "hub1"
    assert leg.hops == (link_key("leaf", "hub1"), link_key("hub1", "root"))
    assert sched.wan_transfers == 2 * (2 + 1 + 1)


@pytest.mark.parametrize("seed", range(4))
def test_compile_is_deterministic_and_the_reference(seed):
    rng = np.random.default_rng(3 + seed)
    for _ in range(10):
        n = int(rng.integers(2, 7))
        regions = _random_grouping(rng, n)
        b = LinkBeliefs(default_mbps=100.0)
        jb = jtopology.LinkBeliefs(default_mbps=100.0)
        names = sorted(set(regions))
        for i, a_ in enumerate(names):
            for b_ in names[i + 1:]:
                for _ in range(int(rng.integers(1, 3))):
                    mbps = float(rng.uniform(1.0, 200.0))
                    b.observe(a_, b_, mbps)
                    jb.observe(a_, b_, mbps)
        assert b.snapshot() == jb.snapshot()
        for kind in ("tree", "ring"):
            spec = TopologySpec.from_regions(regions, kind=kind)
            jspec = jtopology.TopologySpec.from_regions(regions, kind=kind)
            assert spec.compile(b) == spec.compile(b)
            assert _sched(spec.compile(b)) == _sched(jspec.compile(jb))
            assert spec.estimate_round_s(3.7, b, latency_s=0.05) == \
                jspec.estimate_round_s(3.7, jb, latency_s=0.05)


def test_round_s_with_the_des_law_equals_the_reference():
    from repro.core import wan as jwan

    spec = TopologySpec.from_regions(["a", "a", "b", "c"], kind="tree")
    jspec = jtopology.TopologySpec.from_regions(["a", "a", "b", "c"],
                                                kind="tree")
    b, jb = LinkBeliefs(), jtopology.LinkBeliefs()
    for x, y, m in (("a", "b", 50.0), ("a", "c", 10.0), ("b", "c", 70.0)):
        b.observe(x, y, m)
        jb.observe(x, y, m)
    wan = WANConfig(fluctuation=0.3, latency_s=0.05, seed=11)
    jw = jwan.WANConfig(fluctuation=0.3, latency_s=0.05, seed=11)
    got = spec.compile(b).round_s(1.0, b.mbps, intra_mbps=spec.intra_mbps,
                                  wan=wan, rng=np.random.default_rng(11))
    want = jspec.compile(jb).round_s(1.0, jb.mbps,
                                     intra_mbps=jspec.intra_mbps, wan=jw,
                                     rng=np.random.default_rng(11))
    assert got == want > 0


def test_spec_validation():
    with pytest.raises(ValueError, match="unknown topology kind"):
        TopologySpec(kind="mesh", groups=(("a", (0,)),))
    with pytest.raises(ValueError, match="partition"):
        TopologySpec(kind="ring", groups=(("a", (0, 2)),))
    with pytest.raises(ValueError, match="duplicate region"):
        TopologySpec(kind="ring", groups=(("a", (0,)), ("a", (1,))))
    with pytest.raises(ValueError, match="intra_mbps"):
        TopologySpec(kind="ring", groups=(("a", (0,)),), intra_mbps=0.0)
    with pytest.raises(ValueError, match="collapse_ratio"):
        TopologySpec(kind="ring", groups=(("a", (0,)),), collapse_ratio=0.5)
    with pytest.raises(ValueError, match="itself"):
        link_key("a", "a")
    assert link_key("b", "a") == ("a", "b")
    with pytest.raises(ValueError, match="candidate"):
        TopologyPlanner(TopologySpec.from_regions(["a", "b"]), LinkBeliefs(),
                        candidates=("star",))


def test_from_plan_groups_pods_by_region():
    from repro_torch.core.control_plane import (TrainingRequest,
                                                build_training_plan)
    from repro_torch.core.scheduler import CloudResources

    plan = build_training_plan(TrainingRequest(
        model="m", clouds=tuple(CloudResources(r, (("v5e", 4),), 1.0)
                                for r in ("pod0", "pod1", "pod2"))))
    spec = TopologySpec.from_plan(plan, kind="ring")
    assert spec.regions == ("pod0", "pod1", "pod2") and spec.n_pods == 3
    assert len(spec.links()) == 3


# --------------------------------------------- hierarchical_average mapping


def test_hierarchical_average_singletons_is_flat_ama():
    rng = np.random.default_rng(0)
    for n, shift in ((2, 1), (4, 1), (5, 2)):
        tree = {"w": torch.from_numpy(rng.normal(size=(n, 6, 3))
                                      .astype(np.float32)),
                "b": torch.from_numpy(rng.normal(size=(n, 3))
                                      .astype(np.float16))}
        flat = {k: ((p.float() + torch.roll(p, shift, 0).float()) * 0.5)
                .to(p.dtype) for k, p in tree.items()}
        hier = hierarchical_average(tree, [(i,) for i in range(n)],
                                    inter="ama", shift=shift)
        for k in tree:
            assert torch.equal(flat[k], hier[k])


def test_hierarchical_average_two_level_semantics():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    groups = [(0, 1), (2, 3)]
    out = hierarchical_average({"w": w}, groups, inter="sma")["w"]
    for g in groups:
        assert torch.equal(out[g[0]], out[g[1]])
    torch.testing.assert_close(out.mean(0), w.mean(0), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="partition"):
        hierarchical_average({"w": w}, [(0, 1), (1, 2, 3)])
    with pytest.raises(ValueError, match="coprime"):
        hierarchical_average({"w": w}, [(0,), (1,), (2,), (3,)], shift=2)


# ------------------------------------ the planner as the third actuator


def _topology_streams(mod_autotune, mod_topology, mod_sync, seed):
    """test_topology's guard-with-actuator streams: every update, planner
    decision and guard reading of one seeded stream set."""
    base = mod_sync.SyncConfig("asgd_ga", 4, compress_topk=0.05,
                               quantize_int8=True, error_feedback=True)
    rng = np.random.default_rng(seed)
    out = []
    for stream in range(25):
        regions = [f"r{i}" for i in range(int(rng.integers(2, 5)))]
        spec = mod_topology.TopologySpec.from_regions(regions, kind="ring")
        beliefs = mod_topology.LinkBeliefs(
            default_mbps=float(rng.uniform(20.0, 200.0)))
        planner = mod_topology.TopologyPlanner(
            spec, beliefs, hysteresis=int(rng.integers(1, 3)))
        tuner = mod_autotune.AdaptiveSyncController(
            base, model_mb=44.6, compute_step_s=0.3,
            ef_guard=float(rng.uniform(0.5, 0.98)),
            hysteresis=int(rng.integers(1, 4)),
            interval_budget=int(rng.integers(4, 16)), topology=planner)
        for step in range(30):
            if rng.random() < 0.7:
                tuner.observe_wan(float(rng.uniform(0.5, 200.0)))
            if rng.random() < 0.3:
                a, b = rng.choice(len(regions), 2, replace=False)
                beliefs.observe(regions[a], regions[b],
                                float(rng.uniform(0.5, 200.0)))
            ratio = float(rng.uniform(0.0, 1.2))
            rung_before = tuner.rung
            n_before = len(planner.decisions)
            stats = mod_autotune.BucketStats(
                msg_norm=1.0 + step + stream,
                resid_norm=ratio * (1.0 + step + stream))
            upd = tuner.update(step, stats)
            out.append((stream, step, rung_before, n_before,
                        stats.ef_ratio >= tuner.ef_guard,
                        None if upd is None else
                        (upd.rung, upd.reason, upd.topology,
                         upd.sync.interval, upd.sync.compress_topk,
                         upd.sync.value_dtype)))
        out.append(("planner", list(planner.decisions), tuner.max_ef_ratio))
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_ef_guard_with_topology_actuator_equals_the_reference(seed):
    got = _topology_streams(tautotune, ttopology, tsync, seed)
    assert got == _topology_streams(jautotune, jtopology, jsync, seed)
    n_trips = n_moves = 0
    for row in got:
        if row[0] == "planner":
            continue
        _, _, rung_before, _, tripped, upd = row
        if tripped:
            n_trips += 1
            if rung_before > 0:
                assert upd is not None and upd[1] == "ef-guard"
                assert upd[0] == rung_before - 1
        if upd is not None and upd[1].startswith("topo-"):
            n_moves += 1
    assert n_trips > 10 and n_moves > 0


def test_topology_only_update_keeps_codec_knobs():
    spec = TopologySpec.from_regions(["a", "b", "c"], kind="ring")
    beliefs = LinkBeliefs(default_mbps=100.0)
    planner = TopologyPlanner(spec, beliefs, hysteresis=1)
    base = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                      error_feedback=True)
    tuner = AdaptiveSyncController(base, 44.6, 0.3, topology=planner,
                                   interval_budget=8)
    tuner.observe_wan(100.0)
    first = tuner.update(0, BucketStats(1.0, 0.1))
    rung0, interval0 = tuner.rung, tuner.interval
    beliefs.observe("a", "b", 100.0)
    beliefs.observe("a", "b", 2.0)
    upd = tuner.update(1, BucketStats(2.0, 0.2))
    assert upd is not None and upd.reason == "topo-tree"
    assert upd.topology == "tree"
    assert upd.rung == rung0 and upd.sync.interval == interval0
    assert upd.sync == dataclasses.replace(tuner.current,
                                           interval=upd.sync.interval)
    assert planner.decisions and planner.decisions[0][2] == "tree"
    assert first is None or first.topology == "ring"


def test_planner_hysteresis_and_margin():
    spec = TopologySpec.from_regions(["a", "b", "c"], kind="ring")
    beliefs = LinkBeliefs(default_mbps=100.0)
    applied = []
    planner = TopologyPlanner(spec, beliefs, hysteresis=2,
                              switch_margin=0.85,
                              apply=lambda k, s: applied.append((k, s)))
    for step in range(5):
        assert planner.decide(step, 10.0) is None
    assert planner.kind == "ring" and not applied
    beliefs.observe("a", "b", 100.0)
    beliefs.observe("a", "b", 2.0)
    assert planner.decide(5, 10.0) is None
    assert planner.decide(6, 10.0) == "tree"
    assert planner.kind == "tree" and applied == [("tree", 6)]
    step_, old, new, reason = planner.decisions[0]
    assert (step_, old, new) == (6, "ring", "tree")
    assert reason.startswith("topo-cost:ring->tree")
    beliefs.observe("a", "b", 100.0)
    beliefs.observe("a", "b", 100.0)
    assert planner.decide(7, 10.0) is None
    assert planner.decide(8, 10.0) == "ring"
    assert applied == [("tree", 6), ("ring", 8)]


def test_planner_is_deterministic_replay_and_the_reference():
    obs = [("a", "b", 100.0), ("a", "c", 80.0), ("b", "c", 90.0),
           ("a", "b", 3.0), ("a", "b", 3.0), ("b", "c", 85.0)]

    def drive(mod):
        spec = mod.TopologySpec.from_regions(["a", "b", "c"], kind="ring")
        beliefs = mod.LinkBeliefs(default_mbps=100.0)
        planner = mod.TopologyPlanner(spec, beliefs, hysteresis=2)
        out = []
        for step, (x, y, mbps) in enumerate(obs):
            beliefs.observe(x, y, mbps)
            planner.decide(step, 12.5)
            out.append((planner.kind, planner.estimates(12.5)))
        return out, list(planner.decisions)

    assert drive(ttopology) == drive(ttopology) == drive(jtopology)


# ------------------------------------------- exact accounting: cost vs DES


def test_des_topology_traffic_matches_cost_accounting():
    cfg = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                     error_feedback=True)
    clouds = [SimCloud(region=r, iter_time_s=0.3, units=4,
                       cost_per_unit_hour=1.0) for r in ("sh", "cq", "gz")]
    n_iters, model_mb = 40, 44.6
    n_syncs = n_iters // cfg.interval
    for kind in ("ring", "tree"):
        spec = TopologySpec.from_regions(["sh", "cq", "gz"], kind=kind)
        legs = spec.compile(LinkBeliefs()).wan_transfers
        res = simulate(clouds, cfg, n_iters=n_iters, model_mb=model_mb,
                       wan=WANConfig(bandwidth_mbps=100.0), topology=spec)
        assert res.total_traffic_mb == pytest.approx(
            cfg.payload_mb(model_mb) * legs * n_syncs)
        fake = type("U", (), {"sync": cfg})
        assert adaptive_traffic_mb([fake], [n_syncs], model_mb,
                                   n_pods=len(clouds), wan_legs=legs) == \
            pytest.approx(res.total_traffic_mb)


def test_des_flat_ring_backcompat_traffic():
    cfg = SyncConfig("asgd_ga", 4)
    clouds = [SimCloud(region=f"p{i}", iter_time_s=0.3, units=4,
                       cost_per_unit_hour=1.0) for i in range(3)]
    spec = TopologySpec.from_regions(["p0", "p1", "p2"], kind="ring")
    flat = simulate(clouds, cfg, n_iters=24, model_mb=10.0,
                    wan=WANConfig(bandwidth_mbps=100.0))
    topo = simulate(clouds, cfg, n_iters=24, model_mb=10.0,
                    wan=WANConfig(bandwidth_mbps=100.0), topology=spec)
    assert topo.total_traffic_mb == pytest.approx(flat.total_traffic_mb)


def test_des_asymmetric_tree_beats_ring_on_makespan():
    cfg = SyncConfig("asgd_ga", 4)
    clouds = [SimCloud(region=r, iter_time_s=0.3, units=4,
                       cost_per_unit_hour=1.0) for r in ("sh", "cq", "gz")]
    kw = dict(n_iters=60, model_mb=44.6,
              wan=WANConfig(bandwidth_mbps=100.0, fluctuation=0.0),
              topology_links={("gz", "sh"): 0.05})
    ring = simulate(clouds, cfg, topology=TopologySpec.from_regions(
        ["sh", "cq", "gz"], kind="ring"), **kw)
    tree = simulate(clouds, cfg, topology=TopologySpec.from_regions(
        ["sh", "cq", "gz"], kind="tree"), **kw)
    assert tree.makespan_s < ring.makespan_s


def test_bucket_payload_table_wire_column():
    cfg = SyncConfig("asgd_ga", 4, compress_topk=0.1, quantize_int8=True,
                     error_feedback=True, bucket_policy="layer-class")
    mb = {"embed": 4.0, "norm": 0.1, "dense": 30.0, "moe": 0.0}
    assert "wire_mb" not in bucket_payload_table(cfg, mb)["total"]
    for row in bucket_payload_table(cfg, mb, wan_legs=4).values():
        assert row["wire_mb"] == pytest.approx(row["payload_mb"] * 4,
                                               abs=1e-6)


# -------------------------------------------------- BENCH replay


def test_replay_topology_planner_decisions():
    """check_regression's topology gate on the port: the recorded
    interleaved (link observation, decide) stream reproduces the planner's
    decisions, reason strings with their cost estimates included."""
    with open(BENCH) as f:
        topo = json.load(f)["topology"]
    auto = topo["variants"]["auto"]
    spec = TopologySpec.from_regions(topo["regions"],
                                     kind=topo["initial_kind"])
    beliefs = LinkBeliefs(default_mbps=topo["default_mbps"],
                          **topo["beliefs"])
    planner = TopologyPlanner(spec, beliefs, **topo["planner"])
    n_obs = 0
    for ev in auto["events"]:
        if ev[0] == "obs":
            beliefs.observe(ev[1], ev[2], float(ev[3]))
            n_obs += 1
        elif ev[0] == "decide":
            planner.decide(int(ev[1]), float(ev[2]))
    assert [list(d) for d in planner.decisions] == \
        [list(d) for d in auto["planner_decisions"]]
    assert planner.kind == auto["final_kind"] and n_obs > 0
    assert len(planner.decisions) > 0
    fresh = LinkBeliefs(default_mbps=topo["default_mbps"])
    for kind, want in topo["wan_transfers"].items():
        assert spec.with_kind(kind).compile(fresh).wan_transfers == want
