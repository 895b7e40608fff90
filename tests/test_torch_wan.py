"""Port parity: the WAN simulator (``repro_torch.core.wan``), the cost
model (``repro_torch.core.cost``) and the paper's Fig 8 / Fig 10 figures
(``tools/torch_paper_control.py``) against the reference.

The simulator and the cost model are host arithmetic over the same
inputs and the same seeded numpy draws, so every timeline, cost and table
must equal the reference's float for float (``==``, no tolerance).  The
reference's own invariants (``tests/test_wan.py``) are run on the port as
well.
"""
import importlib.util
import os
from dataclasses import fields

import pytest

from benchmarks import paper_repro
from repro.core import cost as jcost
from repro.core import sync as jsync
from repro.core import topology as jtopology
from repro.core import wan as jwan
from repro_torch.core import cost as tcost
from repro_torch.core import sync as tsync
from repro_torch.core import topology as ttopology
from repro_torch.core import wan as twan
from repro_torch.core.cost import cost_report
from repro_torch.core.sync import SyncConfig
from repro_torch.core.wan import (RetryPolicy, SimCloud, WANConfig,
                                  compare_strategies, retry_schedule,
                                  simulate, stream_chunk_plan,
                                  stream_chunk_time)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUDS = [SimCloud("sh", iter_time_s=0.12, units=12),
          SimCloud("cq", iter_time_s=0.08, units=12)]
WAN = WANConfig(seed=1)


def _run(strategy, interval, **kw):
    return simulate(CLOUDS, SyncConfig(strategy, interval), n_iters=200,
                    model_mb=0.6, wan=WAN, **kw)


def _timeline(res):
    """Every number of a SimResult, in order (either package's)."""
    rows = [tuple(getattr(c, f.name) for f in fields(c))
            for c in res.clouds]
    return rows, res.n_reconfigs, res.makespan_s, res.total_cost, \
        res.total_traffic_mb


def _both(mod_wan, mod_sync, strategy, interval, events=(), trace=None,
          topology=None, **sync_kw):
    clouds = [mod_wan.SimCloud("sh", iter_time_s=0.12, units=12,
                               load_time_s=0.5),
              mod_wan.SimCloud("cq", iter_time_s=0.08, units=12,
                               cost_per_unit_hour=1.7),
              mod_wan.SimCloud("bj", iter_time_s=0.1, units=6)]
    kw = {}
    if topology is not None:
        kw["topology"] = topology
        kw["topology_links"] = {("bj", "sh"): 0.1}
    return mod_wan.simulate(
        clouds, mod_sync.SyncConfig(strategy, interval, **sync_kw),
        n_iters=150, model_mb=2.4,
        wan=mod_wan.WANConfig(bandwidth_mbps=80.0, fluctuation=0.3, seed=5),
        events=events, trace=trace, **kw)


def _events(mod_wan, mod_sync):
    E, C = mod_wan.SimEvent, mod_wan.SimCloud
    return {
        "none": [],
        "bandwidth": [E(3.0, "bandwidth_changed", bandwidth_mbps=5.0),
                      E(9.0, "bandwidth_changed", bandwidth_mbps=120.0)],
        "churn": [E(2.0, "cloud_left", region="cq"),
                  E(6.0, "cloud_joined", cloud=C("cq", 0.08, units=12)),
                  E(7.0, "slowdown", region="sh", factor=1.8)],
        "reconfig": [E(4.0, "reconfig", clouds=[C("sh", 0.06, units=24)],
                       sync=mod_sync.SyncConfig("asgd_ga", 16),
                       migration=True, barrier_s=0.4, migrate_mb=2.4,
                       pause_s=9.0)],
        "faults": [E(3.0, "link_failed", duration_s=4.0, n_failures=2),
                   E(8.0, "pod_crashed", region="bj", pause_s=1.5)],
    }


CASES = [(s, k) for s, k in (("asgd", 1), ("asgd_ga", 4), ("ama", 8),
                             ("sma", 4), ("asp", 1))]


@pytest.mark.parametrize("events", ["none", "bandwidth", "churn",
                                    "reconfig", "faults"])
@pytest.mark.parametrize("strategy,interval", CASES)
def test_simulate_equals_the_reference(strategy, interval, events):
    got = _both(twan, tsync, strategy, interval,
                events=_events(twan, tsync)[events])
    want = _both(jwan, jsync, strategy, interval,
                 events=_events(jwan, jsync)[events])
    assert _timeline(got) == _timeline(want)


@pytest.mark.parametrize("codec", [
    dict(compress_topk=0.02, quantize_int8=True, overlap_chunks=4),
    dict(compress_topk=0.05, quantize_int8=True, value_dtype="int4",
         error_feedback=True),
    dict(compress_topk=0.01)])
def test_simulate_codec_and_trace_equal_the_reference(codec):
    trace = dict(seed=7, duration_s=40.0, period_s=3.0, sigma=0.8)
    got = _both(twan, tsync, "asgd_ga", 4,
                trace=twan.BandwidthTrace.fluctuating(**trace), **codec)
    want = _both(jwan, jsync, "asgd_ga", 4,
                 trace=jwan.BandwidthTrace.fluctuating(**trace), **codec)
    assert _timeline(got) == _timeline(want)


@pytest.mark.parametrize("kind", ["ring", "tree"])
def test_simulate_topology_equals_the_reference(kind):
    regions = ("sh", "cq", "bj")
    got = _both(twan, tsync, "ama", 4, topology=ttopology.TopologySpec
                .from_regions(regions, kind=kind))
    want = _both(jwan, jsync, "ama", 4, topology=jtopology.TopologySpec
                 .from_regions(regions, kind=kind))
    assert _timeline(got) == _timeline(want)


def test_compare_strategies_and_cost_report_equal_the_reference():
    kw = dict(n_iters=120, model_mb=0.6, intervals=(2, 4, 8))
    got = compare_strategies(CLOUDS, wan=WAN, **kw)
    want = jwan.compare_strategies(
        [jwan.SimCloud("sh", iter_time_s=0.12, units=12),
         jwan.SimCloud("cq", iter_time_s=0.08, units=12)],
        wan=jwan.WANConfig(seed=1), **kw)
    assert list(got) == list(want)
    units, rates = {"sh": 12, "cq": 12}, {"sh": 1.0, "cq": 2.5}
    base_t = cost_report(got["asgd"], units, rates)
    base_j = jcost.cost_report(want["asgd"], units, rates)
    for key in got:
        assert _timeline(got[key]) == _timeline(want[key]), key
        rt = cost_report(got[key], units, rates)
        rj = jcost.cost_report(want[key], units, rates)
        assert vars(rt) == vars(rj)
        assert (rt.reduction_vs(base_t), rt.waiting_reduction_vs(base_t),
                rt.traffic_reduction_vs(base_t)) == \
            (rj.reduction_vs(base_j), rj.waiting_reduction_vs(base_j),
             rj.traffic_reduction_vs(base_j))


@pytest.mark.parametrize("frac,block,interval", [(0.01, 4096, 8),
                                                 (0.05, 1024, 4)])
def test_payload_tables_equal_the_reference(frac, block, interval):
    assert tcost.tier_payload_table(44.6, frac, block, interval) == \
        jcost.tier_payload_table(44.6, frac, block, interval)
    over = dict(name="embed", compress_topk=0.02, value_dtype="int4",
                codec_block=1024)
    tcfg = SyncConfig("asgd_ga", interval, compress_topk=frac,
                      quantize_int8=True, codec_block=block,
                      bucket_policy="layer-class",
                      buckets=(tsync.BucketOverride(**over),))
    jcfg = jsync.SyncConfig("asgd_ga", interval, compress_topk=frac,
                            quantize_int8=True, codec_block=block,
                            bucket_policy="layer-class",
                            buckets=(jsync.BucketOverride(**over),))
    mb = {"embed": 12.5, "norm": 0.05, "dense": 30.0}
    for legs in (None, 4):
        assert tcost.bucket_payload_table(tcfg, mb, legs) == \
            jcost.bucket_payload_table(jcfg, mb, legs)
    weights = {k: v / sum(mb.values()) for k, v in mb.items()}

    class _Upd:
        def __init__(self, sync):
            self.sync = sync

    for legs in (None, 6):
        assert tcost.adaptive_traffic_mb(
            [_Upd(tcfg), _Upd(tcfg.for_bucket("dense"))], [3, 5], 42.55,
            n_pods=3, bucket_weights=weights, wan_legs=legs) == \
            jcost.adaptive_traffic_mb(
                [_Upd(jcfg), _Upd(jcfg.for_bucket("dense"))], [3, 5],
                42.55, n_pods=3, bucket_weights=weights, wan_legs=legs)


def test_retry_and_stream_laws_equal_the_reference():
    for kw in ({}, dict(max_retries=5, timeout_factor=6.0, backoff_s=0.25,
                        backoff_base=3.0)):
        pt, pj = RetryPolicy(**kw), jwan.RetryPolicy(**kw)
        for n in range(5):
            assert retry_schedule(1.7, pt, n) == \
                jwan.retry_schedule(1.7, pj, n)
    for bad in (dict(timeout_factor=1.0), dict(max_retries=-1),
                dict(backoff_base=0.5), dict(assume_mbps=0.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
    assert stream_chunk_plan(10.0, 4) == jwan.stream_chunk_plan(10.0, 4)
    assert stream_chunk_time(3.3, 0.7, 2.9) == \
        jwan.stream_chunk_time(3.3, 0.7, 2.9)
    assert stream_chunk_time(3.3, 0.7, 0.0) == 0.0


# ------------------------------------------ the reference's own invariants


def test_makespan_at_least_compute():
    r = _run("asgd_ga", 8)
    for c in r.clouds:
        assert c.total_s >= c.compute_s - 1e-9


def test_frequency_reduction_cuts_traffic_and_comm():
    base, ga4, ga8 = _run("asgd", 1), _run("asgd_ga", 4), _run("asgd_ga", 8)
    assert ga4.total_traffic_mb < base.total_traffic_mb
    assert ga8.total_traffic_mb < ga4.total_traffic_mb
    assert ga8.clouds[0].comm_s < ga4.clouds[0].comm_s < base.clouds[0].comm_s
    assert base.makespan_s > ga4.makespan_s > 0


def test_sma_barrier_waits_more():
    sma, ama = _run("sma", 4), _run("ama", 4)
    assert sum(c.wait_s for c in sma.clouds) >= \
        sum(c.wait_s for c in ama.clouds) - 1e-9
    assert sma.makespan_s >= ama.makespan_s


def test_traffic_accounting_exact():
    r = _run("ama", 4)
    assert r.clouds[0].traffic_mb == pytest.approx(200 // 4 * 0.6)
    base = _run("asgd", 1)
    assert base.clouds[0].traffic_mb == pytest.approx(200 * 0.6 * 2)


def test_cost_report_reduction():
    base, fast = _run("asgd", 1), _run("asgd_ga", 8)
    units, rates = {"sh": 12, "cq": 12}, {"sh": 1.0, "cq": 1.0}
    rb, rf = cost_report(base, units, rates), cost_report(fast, units, rates)
    assert rf.reduction_vs(rb) > 0
    assert rf.traffic_mb == pytest.approx(rb.traffic_mb / 16)
    assert rf.traffic_reduction_vs(rb) == pytest.approx(1 - 1 / 16)


def test_compare_strategies_keys():
    res = compare_strategies(CLOUDS, n_iters=50, model_mb=0.6, wan=WAN)
    assert set(res) == {"asgd", "asgd_ga@4", "ama@4", "sma@4",
                        "asgd_ga@8", "ama@8", "sma@8", "asp"}
    assert res["asp"].total_traffic_mb < res["asgd"].total_traffic_mb
    assert res["asp"].total_traffic_mb > res["ama@8"].total_traffic_mb


def test_deterministic_given_seed():
    assert _run("asgd_ga", 4).makespan_s == _run("asgd_ga", 4).makespan_s


# ------------------------------------------------ the paper's figures


def _paper_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_paper_control",
        os.path.join(ROOT, "tools", "torch_paper_control.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig8_scheduling_equals_the_reference():
    got = _paper_tool().bench_scheduling()
    want = paper_repro.bench_scheduling()
    assert got == want
    # the paper's claim: elastic scheduling cuts cost and waiting time in
    # every case while the straggler keeps the makespan
    assert all(v["cost_reduction"] > 0 and v["wait_reduction"] > 0
               and abs(v["makespan_ratio"] - 1.0) < 0.01
               for v in got.values())


def test_fig10_sync_speedups_equal_the_reference():
    got = _paper_tool().bench_sync()
    assert got == paper_repro.bench_sync()
    for model, rows in got.items():
        assert rows["asgd_ga@8"]["speedup"] > 1.0, model
        assert rows["asgd_ga@8"]["comm_reduction"] > \
            rows["asgd_ga@4"]["comm_reduction"], model


def test_paper_tool_main_prints_the_figures(capsys):
    out = _paper_tool().main()
    text = capsys.readouterr().out
    assert "[fig8]" in text and "[fig10]" in text
    assert set(out) == {"bench_scheduling", "bench_sync"}
