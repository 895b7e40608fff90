"""Port parity: the adaptive sync controllers (``repro_torch.core.autotune``)
against ``repro.core.autotune``.

Three kinds of check:

- the reference's own cases (``tests/test_autotune.py``: ladder, control
  law, probes, bus, stats from a sync state, retune carry-over, traces,
  the EF-guard invariant) on the port's modules, the sync state on torch
  tensors;
- decision parity: the same random input streams through the reference's
  and the port's controllers give the same decisions, exactly (the
  controllers are host arithmetic over the same floats);
- replays of ``experiments/bench/BENCH_autotune.json``'s recorded streams
  (trace-fed, measured, per-bucket and streaming) through fresh port
  controllers, decision for decision, as ``benchmarks/check_regression.py``
  holds the reference to them.
"""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import sync as jsync
from repro.core import wan as jwan
from repro_torch.core import autotune as tautotune
from repro_torch.core.autotune import (AdaptiveSyncController, BucketStats,
                                       BucketedSyncController,
                                       StreamingShipController, WanProbe,
                                       bucket_stats_from_sync_state,
                                       build_ladder, trend_tripped)
from repro_torch.core.control_plane import CloudEvent, EventBus
from repro_torch.core.sync import (CODEC_TIERS, SyncConfig, apply_sync,
                                   init_sync_state, on_step_gradients,
                                   retune_sync_state)
from repro_torch.core.transport import MeasuredWanProbe
from repro_torch.core.wan import (BandwidthTrace, SimCloud, WANConfig,
                                  simulate, stream_chunk_time)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "experiments", "bench", "BENCH_autotune.json")

BASE = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                  error_feedback=True)
JBASE = jsync.SyncConfig("asgd_ga", 4, compress_topk=0.05,
                         quantize_int8=True, error_feedback=True)


def _ctrl(**kw):
    kw.setdefault("model_mb", 44.6)
    kw.setdefault("compute_step_s", 0.5)
    return AdaptiveSyncController(BASE, kw.pop("model_mb"),
                                  kw.pop("compute_step_s"), **kw)


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


# ------------------------------------------------------------------ ladder


def test_ladder_sorted_by_payload_descending():
    ladder = build_ladder(BASE, (0.05, 0.02, 0.01), ("int8", "fp8", "int4"))
    payloads = [c.payload_mb(1.0) for c in ladder]
    assert payloads == sorted(payloads, reverse=True)
    assert len(ladder) == 9
    for a, b in zip(ladder, ladder[1:]):
        if a.payload_mb(1.0) == b.payload_mb(1.0):
            assert (CODEC_TIERS.index(a.value_dtype)
                    < CODEC_TIERS.index(b.value_dtype))
    assert all(c.uses_codec and c.error_feedback for c in ladder)
    jladder = jautotune.build_ladder(JBASE, (0.05, 0.02, 0.01),
                                     ("int8", "fp8", "int4"))
    assert [(c.compress_topk, c.value_dtype) for c in ladder] == \
        [(c.compress_topk, c.value_dtype) for c in jladder]


def test_controller_requires_codec_with_ef():
    with pytest.raises(ValueError, match="asgd_ga"):
        AdaptiveSyncController(SyncConfig("asgd_ga", 4), 44.6, 0.5)
    with pytest.raises(ValueError, match="error_feedback"):
        AdaptiveSyncController(
            SyncConfig("asgd_ga", 4, compress_topk=0.05,
                       quantize_int8=True), 44.6, 0.5)
    with pytest.raises(ValueError, match="ef_guard"):
        _ctrl(ef_guard=1.5)
    with pytest.raises(ValueError, match="layer-class"):
        BucketedSyncController(BASE, {"all": 1.0}, 0.5)


# ------------------------------------------------------------- control law


def test_guard_trip_deescalates_immediately():
    c = _ctrl()
    c.rung = 3
    c.current = c.ladder[3]
    u = c.update(0, BucketStats(msg_norm=1.0, resid_norm=0.95))
    assert u is not None and u.reason == "ef-guard"
    assert c.rung == 2
    c.rung = 0
    for step in range(8):
        c.update(step, BucketStats(1.0, 0.95))
        assert c.rung == 0


def test_wan_pressure_escalates_with_hysteresis():
    c = _ctrl(hysteresis=2)
    for _ in range(6):
        c.observe_wan(5.0)
    calm = BucketStats(1.0, 0.3)
    r0 = c.rung
    c.update(0, calm)
    assert c.interval == c.interval_budget and c.rung == r0
    u = c.update(1, calm)
    assert u is not None and u.reason == "wan-pressure"
    assert c.rung > r0
    assert (c._fit_interval(c.ladder[c.rung]) <= c.interval_budget
            or c.rung == len(c.ladder) - 1)
    for r in range(r0 + 1, c.rung):
        assert c._fit_interval(c.ladder[r]) > c.interval_budget


def test_no_escalation_without_guard_calm():
    c = _ctrl(hysteresis=1, ef_guard=0.9, escalate_margin=0.8)
    for _ in range(6):
        c.observe_wan(2.0)
    stressed = BucketStats(1.0, 0.8)
    r0 = c.rung
    for step in range(6):
        c.update(step, stressed)
    assert c.rung == r0


def test_headroom_deescalates():
    c = _ctrl(hysteresis=2)
    c.rung = 4
    c.current = c.ladder[4]
    for _ in range(6):
        c.observe_wan(10_000.0)
    calm = BucketStats(1.0, 0.2)
    rungs = [c.rung]
    for step in range(10):
        c.update(step, calm)
        rungs.append(c.rung)
    assert c.rung < 4 and min(rungs) == c.rung


def test_interval_budget_caps_all_but_last_rung():
    c = _ctrl()
    for _ in range(6):
        c.observe_wan(0.5)
    c.update(0, BucketStats(1.0, 0.2))
    assert c.interval <= c.interval_budget
    c.rung = len(c.ladder) - 1
    c.current = c.ladder[-1]
    c._calm_streak = c._pressure_streak = 0
    c.update(1, BucketStats(1.0, 0.2))
    assert c.interval_budget < c.interval <= c.max_interval


def test_no_reading_holds_rung():
    c = _ctrl()
    r0 = c.rung
    for _ in range(4):
        c.observe_wan(1.0)
    for step in range(5):
        c.update(step, BucketStats(0.0, 0.0))
    assert c.rung == r0


@pytest.mark.parametrize("trend,want", [
    ([0.5, 0.6, 0.7, 0.8], True), ([0.5, 0.6, 0.55, 0.8], False),
    ([0.1, 0.11, 0.12, 0.13], False), ([0.5, 0.6, 0.7], False)])
def test_trend_tripped_matches_reference(trend, want):
    assert trend_tripped(trend, 4, 0.02, 0.9) is want
    assert jautotune.trend_tripped(trend, 4, 0.02, 0.9) is want


# ----------------------------------------------------------- probes / bus


def test_probe_ema_and_fluctuation():
    c = _ctrl(probe_alpha=0.5)
    c.observe_wan(100.0)
    assert c.probe == WanProbe(100.0, 0.0)
    c.observe_wan(100.0)
    assert c.probe.fluctuation == 0.0
    c.observe_wan(25.0)
    assert 25.0 < c.probe.bandwidth_mbps < 100.0
    assert c.probe.fluctuation > 0.2


def test_resync_reanchors_belief():
    c = _ctrl()
    ext = replace(BASE, compress_topk=0.01, value_dtype="int4", interval=64)
    c.resync(ext)
    assert c.interval == 64
    assert c.ladder[c.rung].compress_topk == 0.01
    assert c.ladder[c.rung].value_dtype == "int4"
    for _ in range(6):
        c.observe_wan(10_000.0)
    u = c.update(0, BucketStats(1.0, 0.3))
    assert u is not None and u.sync.interval < 64


def test_eventbus_feeds_probe():
    bus = EventBus()
    c = _ctrl(bus=bus)
    bus.publish(CloudEvent("bandwidth_changed", bandwidth_mbps=42.0))
    assert c.probe.bandwidth_mbps == 42.0


# ------------------------------------------------- stats from sync state


def _grads(n_pods=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(n_pods, 300, 40))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(n_pods, 77))
                                  .astype(np.float32))}


CFG8 = SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                  error_feedback=True, codec_block=512)


def _synced(cfg=CFG8):
    g = _grads()
    p = {k: torch.zeros_like(v) for k, v in g.items()}
    st = init_sync_state(cfg, p)
    assert BucketStats.from_sync_state(st).msg_norm == 0.0
    _, st = on_step_gradients(cfg, g, st)
    _, st = apply_sync(cfg, p, st, lr=1.0)
    return p, st


def test_bucket_stats_from_sync_state():
    _, st = _synced()
    stats = BucketStats.from_sync_state(st)
    assert stats.msg_norm > 0 and 0 < stats.ef_ratio < 1
    assert 0 < stats.energy_capture < 1
    ratios = st.resid_norm.numpy() / st.msg_norm.numpy()
    assert stats.ef_ratio == pytest.approx(float(ratios.max()), rel=1e-6)
    # the reference's reading of the same norms (numpy) is the same
    jstats = jautotune.BucketStats.from_sync_state(
        type("S", (), {"msg_norm": st.msg_norm.numpy(),
                       "resid_norm": st.resid_norm.numpy()}))
    assert (stats.msg_norm, stats.resid_norm) == \
        (jstats.msg_norm, jstats.resid_norm)


def test_bucket_stats_read_the_device_once(monkeypatch):
    cfg = replace(CFG8, bucket_policy="layer-class")
    _, st = _synced(cfg)
    calls = {"cpu": 0, "item": 0}
    cpu, item = torch.Tensor.cpu, torch.Tensor.item

    def counted_cpu(self, *a, **kw):
        calls["cpu"] += 1
        return cpu(self, *a, **kw)

    def counted_item(self, *a, **kw):
        calls["item"] += 1
        return item(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    per = bucket_stats_from_sync_state(st, cfg.bucket_names)
    assert calls == {"cpu": 1, "item": 0}
    monkeypatch.undo()
    assert list(per) == list(cfg.bucket_names)
    for g, name in enumerate(cfg.bucket_names):
        assert per[name] == BucketStats.from_sync_state(st, bucket=g)


def test_retune_preserves_ef_residual_across_tiers():
    p, st = _synced()
    cfg4 = SyncConfig("asgd_ga", 2, compress_topk=0.02, quantize_int8=True,
                      value_dtype="int4", error_feedback=True,
                      codec_block=512)
    st2 = retune_sync_state(cfg4, CFG8, st, p)
    assert torch.equal(st2.ef_residual, st.ef_residual)
    assert int(st2.tier[0]) == cfg4.tier
    cfg_no_ef = SyncConfig("asgd_ga", 2, compress_topk=0.02,
                           quantize_int8=True, codec_block=512)
    st3 = retune_sync_state(cfg_no_ef, cfg4, st2, p)
    assert st3.ef_residual.shape[1] == 0
    st4 = retune_sync_state(cfg4, cfg_no_ef, st3, p)
    assert st4.ef_residual.shape == st.ef_residual.shape
    assert float(st4.ef_residual.abs().max()) == 0.0
    with pytest.raises(ValueError, match="strategy"):
        retune_sync_state(SyncConfig("ama", 2), cfg4, st2, p)


def test_trainer_retune_keeps_training():
    from repro_torch.training.trainer import Trainer, TrainerConfig

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    def init_fn(gen):
        return {"w": torch.randn(8, 1, generator=gen) * 0.1}

    tr = Trainer(loss_fn, init_fn,
                 TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05, sync=BASE),
                 device="cpu")
    st = tr.init_state(0)
    rng = np.random.default_rng(0)

    def batch():
        x = rng.normal(size=(2, 16, 8)).astype(np.float32)
        y = (x.sum(-1, keepdims=True) * 0.3).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    for step in range(4):
        st, m = tr.train_step(st, batch())
        st = tr.maybe_sync(st, step)
    new_sync = SyncConfig("asgd_ga", 2, compress_topk=0.01,
                          quantize_int8=True, value_dtype="int4",
                          error_feedback=True)
    params_before = {k: v.clone() for k, v in st.params.items()}
    ef_before = st.sync_state.ef_residual.clone()
    tr2, st2 = tr.retune(st, new_sync)
    for k in params_before:
        assert torch.equal(params_before[k], st2.params[k])
    assert torch.equal(ef_before, st2.sync_state.ef_residual)
    assert int(st2.sync_state.tier[0]) == new_sync.tier
    # a retune to another rung must not reuse the old rung's wire cache
    assert tr2._wire_mb is None
    losses = []
    for step in range(4, 10):
        st2, m = tr2.train_step(st2, batch())
        st2 = tr2.maybe_sync(st2, step)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()


# ------------------------------------------------------- bandwidth traces


def test_bandwidth_trace_lookup_and_events():
    tr = BandwidthTrace(times_s=(0.0, 30.0, 60.0), mbps=(100.0, 10.0, 80.0))
    assert tr.at(0.0) == 100.0 and tr.at(29.9) == 100.0
    assert tr.at(30.0) == 10.0 and tr.at(1e9) == 80.0
    assert tr.at_step(7, 5.0) == 10.0
    evs = tr.to_events()
    assert [e.bandwidth_mbps for e in evs] == [10.0, 80.0]
    assert all(e.kind == "bandwidth_changed" for e in evs)
    with pytest.raises(ValueError):
        BandwidthTrace(times_s=(1.0,), mbps=(5.0,))
    with pytest.raises(ValueError):
        BandwidthTrace(times_s=(0.0, 0.0), mbps=(5.0, 6.0))


def test_fluctuating_trace_is_valid_seeded_and_the_reference():
    a = BandwidthTrace.fluctuating(seed=3, duration_s=300.0)
    b = BandwidthTrace.fluctuating(seed=3, duration_s=300.0)
    assert a == b
    assert len(a.mbps) >= 5 and all(m > 0 for m in a.mbps)
    assert len(set(a.mbps)) > 1
    j = jwan.BandwidthTrace.fluctuating(seed=3, duration_s=300.0)
    assert (a.times_s, a.mbps) == (j.times_s, j.mbps)


def test_simulate_accepts_trace():
    clouds = [SimCloud("sh", 1.0), SimCloud("cq", 1.2)]
    tr = BandwidthTrace(times_s=(0.0, 20.0), mbps=(100.0, 10.0))
    r1 = simulate(clouds, SyncConfig("asgd_ga", 4), n_iters=50,
                  model_mb=44.6, wan=WANConfig(fluctuation=0.0), trace=tr)
    r2 = simulate(clouds, SyncConfig("asgd_ga", 4), n_iters=50,
                  model_mb=44.6, wan=WANConfig(fluctuation=0.0))
    assert r1.makespan_s > r2.makespan_s


# ------------------------------------------------------- safety property


def _guard_case(seed):
    rng = np.random.default_rng(seed)
    c = _ctrl(hysteresis=int(rng.integers(1, 4)),
              ef_guard=float(rng.uniform(0.5, 0.95)))
    trace = BandwidthTrace.fluctuating(
        base_mbps=float(rng.uniform(5, 200)), seed=seed,
        duration_s=600.0, sigma=float(rng.uniform(0.2, 1.2)))
    t = 0.0
    for i in range(40):
        t += float(rng.uniform(1, 30))
        c.observe_wan(trace.at(t))
        ratio = float(rng.uniform(0.0, 1.0))
        before = c.rung
        c.update(i, BucketStats(msg_norm=1.0, resid_norm=ratio))
        if ratio >= c.ef_guard:
            assert c.rung == max(0, before - 1), \
                f"guard trip must de-escalate (seed {seed}, step {i})"
        elif ratio >= c.escalate_margin * c.ef_guard:
            assert c.rung <= before, \
                f"escalated under guard stress (seed {seed}, step {i})"
        assert 0 <= c.rung < len(c.ladder)
        assert c.min_interval <= c.interval <= c.max_interval


def test_guard_never_violated_on_random_traces():
    """The reference's EF-guard invariant on the port: under hypothesis
    with the reference's strategy and example count when it is installed,
    else the reference's seeded 1000-case fallback."""
    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st_
    except ImportError:
        for seed in range(1000):
            _guard_case(seed)
        return

    @settings(max_examples=200, deadline=None)
    @given(st_.integers(0, 2 ** 31 - 1))
    def prop(seed):
        _guard_case(seed)

    prop()


# ---------------------------------------------------- decision parity


def _random_stream(seed, n=60):
    rng = np.random.default_rng(seed)
    trace = jwan.BandwidthTrace.fluctuating(
        base_mbps=float(rng.uniform(5, 200)), seed=seed, duration_s=600.0,
        sigma=float(rng.uniform(0.2, 1.2)))
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.uniform(1, 30))
        msg = 0.0 if rng.uniform() < 0.1 else float(rng.uniform(0.5, 2.0))
        out.append((trace.at(t), msg, msg * float(rng.uniform(0.0, 1.0))))
    return out


def _adaptive_decisions(mod, base, stream, **kw):
    c = mod.AdaptiveSyncController(base, 44.6, 0.5, **kw)
    out = []
    for step, (bw, msg, res) in enumerate(stream):
        c.observe_wan(bw)
        u = c.update(step, mod.BucketStats(msg, res))
        if u is not None:
            out.append((step, u.rung, u.tier, u.sync.interval, u.reason,
                        u.sync.compress_topk, u.sync.value_dtype,
                        u.summary()))
    return out, c.max_ef_ratio


def _bucketed_decisions(mod, base, stream, **kw):
    mb = {"embed": 12.5, "norm": 0.05, "dense": 30.0}
    c = mod.BucketedSyncController(base, mb, 0.5, **kw)
    out = []
    for step, (bw, msg, res) in enumerate(stream):
        c.observe_wan(bw)
        stats = {n: mod.BucketStats(msg * (1 + g), res * (1 + 0.3 * g))
                 for g, n in enumerate(mb)}
        u = c.update(step, stats)
        if u is not None:
            out.append((step, u.rungs, u.sync.interval, u.reasons,
                        u.summary(), u.sync.buckets))
    return out, c.max_ef_ratio_by_bucket


@pytest.mark.parametrize("seed", range(8))
def test_adaptive_decisions_equal_the_reference(seed):
    stream = _random_stream(seed)
    kw = dict(ef_guard=0.9 if seed % 2 else 0.98, hysteresis=1 + seed % 3)
    got = _adaptive_decisions(tautotune, BASE, stream, **kw)
    want = _adaptive_decisions(jautotune, JBASE, stream, **kw)
    assert got == want and len(got[0]) > 0


@pytest.mark.parametrize("seed", range(8))
def test_bucketed_decisions_equal_the_reference(seed):
    stream = _random_stream(100 + seed)
    kw = dict(ef_guard=0.9 if seed % 2 else 0.98, hysteresis=1 + seed % 3,
              escalate_margin=0.99)
    got = _bucketed_decisions(
        tautotune, replace(BASE, bucket_policy="layer-class"), stream, **kw)
    jgot = _bucketed_decisions(
        jautotune, replace(JBASE, bucket_policy="layer-class"), stream,
        **kw)
    assert got[1] == jgot[1] and len(got[0]) > 0
    # the overrides are each package's own BucketOverride: compare fields
    assert [d[:5] for d in got[0]] == [d[:5] for d in jgot[0]]
    assert [[tuple(vars(o).values()) for o in d[5]] for d in got[0]] == \
        [[tuple(vars(o).values()) for o in d[5]] for d in jgot[0]]


# --------------------------------------------- BENCH_autotune.json replays


def _tuner_parts(tuner_rec, base_sync, **sync_extra):
    """benchmarks/check_regression.py ``_tuner_parts`` on the port."""
    knobs = dict(tuner_rec)
    knobs.pop("base_sync", None)
    knobs["topk_ladder"] = tuple(knobs["topk_ladder"])
    sync = SyncConfig(base_sync["strategy"], base_sync["interval"],
                      compress_topk=base_sync["compress_topk"],
                      quantize_int8=True, error_feedback=True, **sync_extra)
    return knobs, knobs["ef_guard"], sync


def test_replay_trace_fed_decisions(bench):
    adaptive = bench["variants"]["adaptive"]
    scen = bench["scenario"]
    knobs, guard, sync = _tuner_parts(scen["tuner"],
                                      scen["tuner"]["base_sync"])
    tuner = AdaptiveSyncController(sync, scen["model_mb"],
                                   scen["compute_step_s"], **knobs)
    tuner.observe_wan(scen["trace"][0][1])
    replayed = []
    for step, (sim_t, bw, msg, res) in enumerate(adaptive["signals"]):
        tuner.observe_wan(bw)
        upd = tuner.update(step, BucketStats(msg_norm=msg, resid_norm=res))
        if upd is not None:
            replayed.append((step, upd.rung, upd.sync.interval, upd.reason))
    recorded = [(d["step"], d["rung"], d["interval"], d["reason"])
                for d in adaptive["decisions"]]
    assert replayed == recorded and len(recorded) > 5
    assert tuner.max_ef_ratio <= guard


def test_replay_measured_decisions(bench):
    scen, meas = bench["scenario"], bench["measured"]
    run = meas["variant"]
    knobs, guard, sync = _tuner_parts(scen["tuner"],
                                      scen["tuner"]["base_sync"])
    probe = MeasuredWanProbe(**meas["probe"])
    tuner = AdaptiveSyncController(sync, scen["model_mb"],
                                   scen["compute_step_s"],
                                   probe_est=probe.estimator, **knobs)
    replayed = []
    for step, (sim_t, transfer, msg, res) in enumerate(run["signals"]):
        if transfer is not None:
            probe.observe_transfer(transfer[0], transfer[1])
        upd = tuner.update(step, BucketStats(msg_norm=msg, resid_norm=res))
        if upd is not None:
            replayed.append((step, upd.rung, upd.sync.interval, upd.reason))
    recorded = [(d["step"], d["rung"], d["interval"], d["reason"])
                for d in run["decisions"]]
    assert replayed == recorded and len(recorded) > 0
    assert tuner.max_ef_ratio <= guard
    assert probe.n_observations == sum(
        1 for s in run["signals"] if s[1] is not None) > 0


def test_replay_bucketed_decisions(bench):
    scen, bucketed = bench["scenario"], bench["bucketed"]
    run = bucketed["variants"]["bucketed"]
    knobs, guard, sync = _tuner_parts(bucketed["tuner"],
                                      scen["tuner"]["base_sync"],
                                      bucket_policy="layer-class")
    tuner = BucketedSyncController(sync, bucketed["bucket_mb"],
                                   scen["compute_step_s"], **knobs)
    tuner.observe_wan(scen["trace"][0][1])
    replayed = []
    for step, (sim_t, bw, per_bucket) in enumerate(run["signals"]):
        tuner.observe_wan(bw)
        stats = {n: BucketStats(msg_norm=m, resid_norm=r)
                 for n, (m, r) in per_bucket.items()}
        upd = tuner.update(step, stats)
        if upd is not None:
            replayed.append((step, {n: r for n, r, _ in upd.rungs},
                             upd.sync.interval, list(upd.reasons)))
    recorded = [(d["step"], d["rungs"], d["interval"], d["reasons"])
                for d in run["decisions"]]
    assert replayed == recorded and len(recorded) > 5
    assert all(r <= guard for r in tuner.max_ef_ratio_by_bucket.values())


def test_replay_streaming_decisions_and_billing(bench):
    """The chunk-level controller on its recorded streams: both coupled
    laws from one fresh probe estimator, round and chunk decisions field
    for field, and every chunk's seconds re-billed through
    ``stream_chunk_time``."""
    scen, sb = bench["scenario"], bench["streaming"]
    for vname in ("round_adaptive", "streaming"):
        run = sb["variants"][vname]
        knobs, guard, sync = _tuner_parts(scen["tuner"],
                                          scen["tuner"]["base_sync"],
                                          overlap_chunks=sb["chunks"])
        probe = MeasuredWanProbe(**sb["probe"])
        tuner = AdaptiveSyncController(sync, scen["model_mb"],
                                       scen["compute_step_s"],
                                       probe_est=probe.estimator, **knobs)
        stream = (StreamingShipController(sync, scen["model_mb"],
                                          probe_est=probe.estimator,
                                          **sb["stream"])
                  if vname == "streaming" else None)
        rounds = {r["step"]: r for r in run.get("stream_rounds", [])}
        cur, replayed = sync, []
        for step, (sim_t, transfer, msg, res) in enumerate(run["signals"]):
            if transfer is not None:
                probe.observe_transfer(transfer[0], transfer[1])
            stats = BucketStats(msg_norm=msg, resid_norm=res)
            upd = tuner.update(step, stats)
            if upd is not None:
                cur = upd.sync
                replayed.append((step, upd.rung, upd.sync.interval,
                                 upd.reason))
            rr = rounds.get(step)
            if rr is not None:
                stream.note_stats(stats)
                stream.begin_round(step, cur)
                for name, mb, secs in rr["chunks"]:
                    stream.observe_chunk(name, float(mb), float(secs))
                stream.end_round()
        recorded = [(d["step"], d["rung"], d["interval"], d["reason"])
                    for d in run["decisions"]]
        assert replayed == recorded, vname
        assert tuner.max_ef_ratio <= guard
        if stream is None:
            continue
        assert json.loads(json.dumps(stream.decisions)) == \
            run["stream_decisions"]
        assert (stream.n_retunes, stream.n_rounds) == \
            (run["n_stream_retunes"], run["n_stream_rounds"])
        assert stream.n_retunes > 0
    run = sb["variants"]["streaming"]
    cut_by_step = {d["step"]: d["chunk"] + 1
                   for d in run["stream_decisions"]
                   if d["action"] == "retune"}
    for rr in run["stream_rounds"]:
        cut = (cut_by_step[rr["step"]] if rr["retuned"]
               else len(rr["chunks"]))
        prefix = 0.0
        for i, (name, mb, secs) in enumerate(rr["chunks"]):
            if i < cut:
                want = stream_chunk_time(rr["t_round"], mb, rr["total_mb"])
                prefix += want
            else:
                want = stream_chunk_time(rr["t_tail"], mb, rr["tail_mb"])
            assert want == secs
        assert rr["t_s"] == (rr["t_round"] if not rr["retuned"]
                             else prefix + rr["t_tail"])


def test_streaming_controller_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="fused"):
        StreamingShipController(SyncConfig("asgd_ga", 4), 44.6)
    with pytest.raises(ValueError, match="error_feedback"):
        StreamingShipController(replace(BASE, error_feedback=False), 44.6)
    with pytest.raises(ValueError, match="cliff_ratio"):
        StreamingShipController(BASE, 44.6, cliff_ratio=1.0)
    with pytest.raises(ValueError, match="hysteresis"):
        StreamingShipController(BASE, 44.6, hysteresis=0)
