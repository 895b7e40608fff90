"""Port parity: the WAN transport seam (``repro_torch.core.transport`` and
``ship_sync_payloads``) against ``repro.core.transport`` and
``repro.core.sync``.

The first half mirrors ``tests/test_transport.py`` case for case, port
against port: every transport ships the inline ring's bytes, the EF
residual carries across a retune on each, the sim transport bills with the
simulator's law, the measured probe feeds the controllers, and the mesh
transport records each bucket and measures the overlap.  The second half
holds the port to the reference on inputs made from a seed with numpy:
the same converted ``SyncState`` shipped over each transport is bit-exact
against the reference's round over its own transport of the same kind;
billing, probe belief, decision streams, checksums and the retry loop are
host arithmetic and equal the reference's exactly; the launchers' billed
transfers and measured bandwidth are equal, their losses within
``LOSS_RTOL``.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import sync as jsync
from repro.core import transport as jtransport
from repro.core import wan as jwan
from repro.launch import train as jtrain
from repro.models.registry import get_model_fns
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.core import autotune as tautotune
from repro_torch.core import sync as tsync
from repro_torch.core import transport as ttransport
from repro_torch.core import wan as twan
from repro_torch.core.sync import BucketOverride, SyncConfig, _encode_bucket
from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                        SimTransport)
from repro_torch.core.wan import BandwidthTrace, WANConfig, transfer_time
from repro_torch.launch import train as ttrain
from repro_torch.training.trainer import Trainer, TrainerConfig, TrainState

torch.set_num_threads(2)

# tests/test_torch_trainer.py's loss tolerance: f32 on both sides, each
# framework's own gradients
LOSS_RTOL = 1e-4
# the per-bucket telemetry norms are f32 reductions summed in each
# framework's own order (tests/test_torch_sync.py)
NORM_RTOL = 1e-6

SYNC = SyncConfig("asgd_ga", 2, compress_topk=0.2, quantize_int8=True,
                  error_feedback=True, codec_block=128, overlap_chunks=2,
                  bucket_policy="layer-class",
                  buckets=(BucketOverride("norm", compress_topk=0.5),))
TRACE = BandwidthTrace(times_s=(0.0, 3.0), mbps=(100.0, 2.0))
CPU = torch.device("cpu")


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    reg = torch.mean(params["embed"] ** 2)
    return torch.mean((pred - batch["y"]) ** 2) + 0.01 * reg, {}


def _init(gen):
    return {"w": torch.randn(8, 4, generator=gen) * 0.1,
            "bias": torch.zeros(4),
            "embed": torch.randn(16, 4, generator=gen) * 0.1}


def _run(transport, n_steps=10, sync=SYNC, retune_at=None, retune_to=None):
    """Drive the trainer with the given transport; returns (state,
    trainer, per-step (msg_norm, ef_residual) snapshots)."""
    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                               sync=sync),
                 device="cpu", transport=transport)
    st = tr.init_state(0)
    rng = np.random.default_rng(7)
    snaps = []
    for step in range(n_steps):
        if retune_at is not None and step == retune_at:
            tr, st = tr.retune(st, retune_to)
        x = rng.normal(size=(2, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        st = tr.maybe_sync(st, step, model_mb=0.001)
        if transport is not None and hasattr(transport, "tick"):
            transport.tick(0.5)
        snaps.append((st.sync_state.msg_norm.clone(),
                      st.sync_state.ef_residual.clone()))
    return st, tr, snaps


def _assert_same_stream(a, b, label):
    """Bit-identical params and SyncState telemetry after the same
    stream, at every step."""
    st_a, _, snaps_a = a
    st_b, _, snaps_b = b
    for la, lb in zip(T.leaves(st_a.params), T.leaves(st_b.params)):
        assert torch.equal(la, lb), f"{label}: params"
    for field in ("ef_residual", "msg_norm", "resid_norm", "tier"):
        assert torch.equal(getattr(st_a.sync_state, field),
                           getattr(st_b.sync_state, field)), \
            f"{label}: {field}"
    assert len(snaps_a) == len(snaps_b)
    for i, ((ma, ra), (mb, rb)) in enumerate(zip(snaps_a, snaps_b)):
        assert torch.equal(ma, mb) and torch.equal(ra, rb), \
            f"{label}: step {i}"


def _same_chunks(a, b):
    for ca, cb in zip(a, b, strict=True):
        for pa, pb in zip(ca, cb, strict=True):
            assert pa.dtype == pb.dtype and torch.equal(pa, pb)


# ------------------------------------------------------------------ parity


def test_sim_and_mesh_bit_identical_to_inline():
    """For the same step stream every transport gives bit-identical
    params and SyncState telemetry, at every sync round."""
    inline = _run(None)
    sim = _run(SimTransport(TRACE, WANConfig(fluctuation=0.2, seed=3),
                            probe=MeasuredWanProbe()))
    mesh = _run(MeshTransport(probe=MeasuredWanProbe()))
    placed = _run(MeshTransport(devices=[CPU, CPU]))
    _assert_same_stream(inline, sim, "sim vs inline")
    _assert_same_stream(inline, mesh, "mesh vs inline")
    _assert_same_stream(sim, mesh, "sim vs mesh")
    _assert_same_stream(inline, placed, "mesh (rows placed) vs inline")


@pytest.mark.parametrize("n_pods,devices", [
    (3, None), (2, [CPU, CPU]), (3, [CPU] * 3), (3, [CPU] * 2)])
def test_ship_bucket_parity_unit(n_pods, devices):
    """ship_bucket alone: sim (the inline ring) and mesh (a local roll, or
    rows placed one per device and copied to their peer's) move the same
    chunks to the same bytes."""
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(n_pods, 512))
                            .astype(np.float32))
    cfg = SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                     codec_block=128, overlap_chunks=2)
    chunks, _ = _encode_bucket(cfg, flat, want_local=False)
    sim = SimTransport(TRACE)
    mesh = MeshTransport(devices=devices)
    assert (mesh.sharding(n_pods, "cpu") is not None) == \
        (devices is not None and len(devices) >= n_pods)
    out_sim = sim.ship_bucket("all", chunks, shift=1)
    out_mesh = mesh.ship_bucket("all", chunks, shift=1, payload_mb=0.01)
    _same_chunks(out_sim, out_mesh)
    _same_chunks(out_sim, tsync._INLINE_RING.ship_bucket("all", chunks, 1))
    assert out_mesh[0].idx.dtype == torch.uint16
    assert len(mesh.records) == 1
    assert mesh.records[0].seconds > 0.0
    assert mesh.records[0].payload_mb == 0.01


# ------------------------------- EF carry across a retune, per transport


@pytest.mark.parametrize("kind", ["inline", "sim", "mesh"])
def test_ef_residual_carries_across_retune_on_transport(kind):
    """A mid-run retune (tier and interval change) carries the residual,
    and the post-retune stream stays bit-identical to the inline path's."""
    retuned = dataclasses.replace(
        SYNC, interval=1,
        buckets=(BucketOverride("norm", compress_topk=0.5),
                 BucketOverride("dense", compress_topk=0.05,
                                value_dtype="int4")))

    def make(kind):
        if kind == "sim":
            return SimTransport(TRACE, WANConfig(fluctuation=0.0, seed=0),
                                probe=MeasuredWanProbe())
        if kind == "mesh":
            return MeshTransport(probe=MeasuredWanProbe())
        return None

    st_pre, _, _ = _run(make(kind), n_steps=6)
    assert float(st_pre.sync_state.ef_residual.norm()) > 0

    full = _run(make(kind), n_steps=12, retune_at=6, retune_to=retuned)
    inline_full = _run(None, n_steps=12, retune_at=6, retune_to=retuned)
    _assert_same_stream(inline_full, full, f"{kind} retune stream")
    assert tuple(full[0].sync_state.tier.tolist()) == retuned.bucket_tiers


def test_retune_and_reconfigure_keep_the_transport():
    """The reference re-jits a split (prepare, finish) pair and keeps it
    across interval-only retunes; the port runs no jit, so what a
    successor must keep is the transport (and the cached wire accounting
    of an interval-only retune)."""
    mesh = MeshTransport()
    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=2, optimizer="sgd", sync=SYNC),
                 device="cpu", transport=mesh)
    st = tr.init_state(0)
    wire = tr.wire_mb(st)
    tr2, st = tr.retune(st, dataclasses.replace(SYNC, interval=4))
    assert tr2.transport is mesh and tr2._wire_mb is wire
    tr3, st = tr2.retune(st, dataclasses.replace(SYNC, value_dtype="int4"))
    assert tr3.transport is mesh and tr3._wire_mb is None
    assert tr3.wire_mb(st) != wire
    tr4, st = tr3.reconfigure(st, 3)
    assert tr4.transport is mesh and tr4.cfg.n_pods == 3


# ------------------------------------------------------------- sim billing


def test_sim_billing_is_the_simulator_law():
    """One transfer_time draw per round on the round's total payload at
    the trace's bandwidth, from the transport's seeded generator."""
    wan = WANConfig(fluctuation=0.3, latency_s=0.05, seed=11)
    sim = SimTransport(TRACE, wan, probe=MeasuredWanProbe())
    wire = {"dense": 0.8, "norm": 0.2}
    t0 = sim.on_sync(wire, step=0)
    sim.tick(5.0)                      # past the 3 s segment edge -> 2 Mbps
    t1 = sim.on_sync(wire, step=1)
    rng = np.random.default_rng(11)
    assert t0 == transfer_time(1.0, 100.0, wan, rng)
    assert t1 == transfer_time(1.0, 2.0, wan, rng)
    by_round = {}
    for r in sim.records:
        by_round[r.step] = by_round.get(r.step, 0.0) + r.seconds
    assert by_round[0] == pytest.approx(t0)
    assert by_round[1] == pytest.approx(t1)
    assert sim.probe.n_observations == 2
    assert sim.probe.last_mbps == pytest.approx(1.0 * 8.0 / t1)


def test_sim_billing_is_deterministic():
    wan = WANConfig(fluctuation=0.3, seed=5)
    a = SimTransport(TRACE, wan)
    b = SimTransport(TRACE, wan)
    for t in (0.0, 1.0, 4.0):
        a.clock_s = b.clock_s = t
        assert a.on_sync({"all": 0.5}) == b.on_sync({"all": 0.5})


# ---------------------------------------------------------- measured probe


def test_measured_probe_math_and_cliff_snap():
    probe = MeasuredWanProbe(alpha=0.5, cliff_snap=4.0)
    p = probe.observe_transfer(1.0, 0.1)     # 1 MB in 0.1 s = 80 Mbps
    assert probe.last_mbps == pytest.approx(80.0)
    assert p.bandwidth_mbps == pytest.approx(80.0)
    # a collapse snaps the belief instead of EMA-averaging through it
    probe.observe_transfer(1.0, 8.0)         # 1 Mbps, > 4x below the EMA
    assert probe.estimator.bandwidth_mbps == pytest.approx(1.0)
    assert probe.n_observations == 2


def _measured_loop(autotune, transport, wan, Sync):
    """The acceptance loop in miniature: the controller's only bandwidth
    input is the transport's billed transfers (no trace, no bus).
    Returns (transport, tuner, per-step decision stream)."""
    trace = wan.BandwidthTrace(times_s=(0.0, 10.0), mbps=(100.0, 0.5))
    sim = transport.SimTransport(
        trace, wan.WANConfig(fluctuation=0.0, latency_s=0.0),
        probe=transport.MeasuredWanProbe())
    base = Sync("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                error_feedback=True)
    tuner = autotune.AdaptiveSyncController(
        base, 44.6, 0.3, probe_est=sim.probe.estimator, interval_budget=8,
        hysteresis=2)
    calm = autotune.BucketStats(1.0, 0.3)
    stream = []
    for step in range(40):
        upd = tuner.update(step, calm)
        if step % tuner.interval == tuner.interval - 1:
            sim.on_sync({"all": tuner.current.payload_mb(44.6)}, step=step)
        sim.tick(0.3)
        stream.append((step, tuner.rung, tuner.interval,
                       upd.summary() if upd is not None else None))
    return sim, tuner, stream


def test_measured_loop_reacts_to_crash_without_trace():
    """A link crash seen only through billed transfers still escalates the
    controller off its starting rung."""
    sim, tuner, stream = _measured_loop(tautotune, ttransport, twan,
                                        SyncConfig)
    assert sim.probe.n_observations > 0
    assert stream[-1][1] > stream[0][1] or tuner.interval > 4
    assert tuner._probe_est.bandwidth_mbps < 5.0


# ------------------------------------------------------------- mesh layer


def test_mesh_records_per_bucket_and_feeds_probe():
    mesh = MeshTransport(probe=MeasuredWanProbe())
    _run(mesh, n_steps=8)
    # interval 2 over 8 steps -> 4 sync rounds of 3 non-empty buckets
    assert {r.bucket for r in mesh.records} == {"norm", "dense", "embed"}
    assert len(mesh.records) == 12
    assert [r.step for r in mesh.records] == [1] * 3 + [3] * 3 + [5] * 3 \
        + [7] * 3
    assert all(r.seconds > 0 for r in mesh.records)
    assert all(r.payload_mb > 0 for r in mesh.records)
    assert mesh.probe.n_observations == 4
    assert mesh.probe.estimator.bandwidth_mbps is not None
    assert mesh.sharded == (torch.cuda.device_count() >= 2)


@pytest.mark.parametrize("devices", [None, [CPU, CPU]])
def test_mesh_overlap_measurement_structure(devices):
    """Both schedules' wall-clock and their ratio, over a local roll or
    rows placed one per device; both schedules decode to the same tensor
    (checked inside)."""
    cfg = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                     error_feedback=True, codec_block=1024,
                     overlap_chunks=4)
    mesh = MeshTransport(emulate_mbps=2.0, devices=devices)
    rep = mesh.measure_overlap(cfg, n_pods=2, n_elems=1 << 16, reps=1,
                               device="cpu")
    assert rep["chunks"] == 4
    assert rep["t_pipelined_s"] > 0 and rep["t_serialized_s"] > 0
    assert rep["overlap_speedup"] > 0
    assert rep["sharded"] == (devices is not None)
    assert rep["n_devices"] == (1 if devices is None else 2)
    # each chunk's hop pays at least its emulated transfer time
    for h, mb in zip(rep["chunk_transfer_s"]["serialized"], rep["chunk_mb"]):
        assert h >= mb * 8.0 / 2.0 * 0.99
    with pytest.raises(ValueError, match="codec path"):
        mesh.measure_overlap(SyncConfig("asgd_ga", 4), 2, 1024,
                             device="cpu")


def test_parse_transport_rejects_unknown_options():
    """A typoed sim/mesh knob refuses rather than running its default."""
    sync = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                      error_feedback=True)
    assert ttrain.parse_transport("inline", None, sync) is None
    t = ttrain.parse_transport("sim:fluct=0.1,latency=0,seed=3", TRACE, sync)
    assert t.wan.fluctuation == 0.1 and t.wan.latency_s == 0.0
    m = ttrain.parse_transport("mesh:mbps=5", TRACE, sync)
    assert m.emulate_mbps == 5.0
    with pytest.raises(ValueError, match="unknown option 'latencey'"):
        ttrain.parse_transport("sim:latencey=0", TRACE, sync)
    with pytest.raises(ValueError, match="unknown option 'fluct'"):
        ttrain.parse_transport("mesh:fluct=0.2", TRACE, sync)
    with pytest.raises(ValueError, match="needs --wan-trace"):
        ttrain.parse_transport("sim", None, sync)
    with pytest.raises(ValueError, match="unknown --transport"):
        ttrain.parse_transport("carrier-pigeon", TRACE, sync)
    with pytest.raises(ValueError, match="requires the fused codec"):
        ttrain.parse_transport("mesh", TRACE, SyncConfig("ama", 4))
    # the messages are the reference's
    for spec, trace, cfg in (("sim:latencey=0", TRACE, sync),
                             ("sim", None, sync), ("pigeon", TRACE, sync)):
        with pytest.raises(ValueError) as terr:
            ttrain.parse_transport(spec, trace, cfg)
        with pytest.raises(ValueError) as jerr:
            jtrain.parse_transport(spec, trace, jsync.SyncConfig(
                "asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                error_feedback=True))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.cuda
def test_mesh_overlap_speedup_on_multi_device_mesh():
    """On >= 4 cards MeshTransport places one pod row per card and reports
    a measured overlap speedup for overlap_chunks > 1."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs >= 4 CUDA devices")
    cfg = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                     error_feedback=True, overlap_chunks=8)
    mesh = MeshTransport(emulate_mbps=1.0)
    rep = mesh.measure_overlap(cfg, n_pods=4, n_elems=1 << 20, reps=2)
    assert rep["sharded"] and rep["n_devices"] >= 4
    assert rep["chunks"] == 8
    assert rep["overlap_speedup"] > 1.1, rep


# ======================================================= against the reference

N_PODS = 3
# a decoder-shaped tree with one leaf per bucket class, ragged codec blocks
SHAPES = {"attn": {"wq": (48, 40), "wo": (40, 48)},
          "ln1": {"scale": (48,)},
          "embed": {"tokens": (96, 48)}}
JSYNC_CFG = jsync.SyncConfig(
    "asgd_ga", 2, compress_topk=0.05, quantize_int8=True,
    error_feedback=True, codec_block=256, overlap_chunks=2,
    bucket_policy="layer-class",
    buckets=(jsync.BucketOverride("norm", compress_topk=0.5),
             jsync.BucketOverride("embed", value_dtype="int4")))


def _port_cfg(jcfg):
    return tsync.SyncConfig(
        jcfg.strategy, jcfg.interval, compress_topk=jcfg.compress_topk,
        quantize_int8=jcfg.quantize_int8, value_dtype=jcfg.value_dtype,
        error_feedback=jcfg.error_feedback,
        overlap_chunks=jcfg.overlap_chunks, codec_block=jcfg.codec_block,
        bucket_policy=jcfg.bucket_policy,
        buckets=tuple(tsync.BucketOverride(o.name, o.compress_topk,
                                           o.value_dtype, o.codec_block)
                      for o in jcfg.buckets))


@functools.lru_cache(maxsize=None)
def _jax_state(n_pods=N_PODS, seed=2):
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda shape: jnp.asarray(rng.normal(size=(n_pods,) + shape)
                                  .astype(np.float32)),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    st = jsync.init_sync_state(JSYNC_CFG, params)
    rng = np.random.default_rng(seed)
    buf = jax.tree.map(lambda b: jnp.asarray(
        rng.normal(size=b.shape).astype(np.float32)), st.ga_buffer)
    ef = jnp.asarray(0.1 * rng.normal(size=st.ef_residual.shape)
                     .astype(np.float32))
    return params, st._replace(ga_buffer=buf, ef_residual=ef,
                               steps_since_sync=jnp.int32(3))


def _to_port(params, state):
    tparams = T.tree_map(lambda a: convert.to_tensor(a, "cpu"),
                         jax.tree.map(np.asarray, params))
    tstate = convert.sync_state_from_jax(jax.tree.map(np.asarray, state),
                                         "cpu")
    return tparams, tstate


def _chunks_to_port(jchunks):
    return tuple(tsync.ChunkPayload(*(convert.to_tensor(np.asarray(p), "cpu")
                                      for p in c)) for c in jchunks)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.itemsize == 1:
        a, b = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(a, b)


def _transports(kind):
    """(reference transport, port transport) of one kind."""
    wan = dict(fluctuation=0.3, latency_s=0.05, seed=4)
    if kind == "sim":
        return (jtransport.SimTransport(jwan.BandwidthTrace(TRACE.times_s,
                                                            TRACE.mbps),
                                        jwan.WANConfig(**wan),
                                        probe=jtransport.MeasuredWanProbe()),
                SimTransport(TRACE, WANConfig(**wan),
                             probe=MeasuredWanProbe()))
    if kind == "mesh":
        return (jtransport.MeshTransport(probe=jtransport.MeasuredWanProbe()),
                MeshTransport(probe=MeasuredWanProbe()))
    if kind == "mesh-placed":
        return (jtransport.MeshTransport(probe=jtransport.MeasuredWanProbe()),
                MeshTransport(probe=MeasuredWanProbe(),
                              devices=[CPU] * N_PODS))
    return None, None


@pytest.mark.parametrize("kind", ["inline", "sim", "mesh", "mesh-placed"])
def test_same_state_round_over_each_transport_is_bit_exact(kind):
    """The same converted state shipped over each transport: wire chunks,
    new params, EF residual and tier equal the reference's round over its
    own transport of that kind, bit for bit; the records agree in bucket,
    MB and step, and sim's seconds float for float."""
    jcfg, tcfg = JSYNC_CFG, _port_cfg(JSYNC_CFG)
    params, state = _jax_state()
    tparams, tstate = _to_port(params, state)
    jt, tt = _transports(kind)
    lr = 0.05

    jpay = jax.jit(functools.partial(jsync.prepare_codec_sync, jcfg))(state)
    jwire = jsync.bucket_wire_mb(jcfg, jsync.bucket_layout(jcfg,
                                                           state.ga_buffer))
    jship = jsync.ship_sync_payloads(jcfg, jpay.chunks, jt, jwire)
    jp, js = jsync.finish_codec_sync(jcfg, params, state, jpay, jship, lr)

    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    twire = tsync.bucket_wire_mb(tcfg, tsync.bucket_layout(
        tcfg, tstate.ga_buffer))
    assert twire == jwire
    tship = tsync.ship_sync_payloads(tcfg, tpay.chunks, tt, twire)
    assert sorted(tship) == sorted(jship) == ["dense", "embed", "norm"]
    assert [len(tship[n]) for n in sorted(tship)] == [2, 2, 1]
    for name in jship:
        assert len(jship[name]) == len(tship[name])
        for jc, tc in zip(jship[name], tship[name]):
            assert tc.idx.dtype == torch.uint16
            for a, b in zip(jc, tc):
                _eq(a, b)
    tp, ts = tsync.finish_codec_sync(tcfg, tparams, tstate, tpay, tship, lr)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        _eq(a, b)
    _eq(js.ef_residual, ts.ef_residual)
    _eq(js.tier, ts.tier)
    for name in ("msg_norm", "resid_norm"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=NORM_RTOL, atol=0)
    if jt is None:
        return
    j_secs, t_secs = jt.on_sync(jwire, step=1), tt.on_sync(twire, step=1)
    assert t_secs > 0.0
    if kind == "sim":
        assert t_secs == j_secs
    # the reference's jitted prepare returns its chunks key-sorted, so its
    # host seam ships the buckets in name order; the port ships them in
    # layout order, as the reference's in-graph round does
    assert sorted((r.bucket, r.payload_mb, r.step) for r in tt.records) == \
        sorted((r.bucket, r.payload_mb, r.step) for r in jt.records)
    assert tt.probe.n_observations == jt.probe.n_observations == 1
    if kind == "sim":
        assert [r.seconds for r in tt.records] == \
            [r.seconds for r in jt.records]


def test_sim_billing_equals_the_reference():
    """A scripted sequence of wire dicts and ticks, an empty round and a
    trace edge among them: records, returned seconds and probe belief are
    the reference's, float for float."""
    wan = dict(bandwidth_mbps=100.0, fluctuation=0.25, latency_s=0.05,
               seed=9)
    trace = ((0.0, 1.5, 4.0, 7.0), (100.0, 40.0, 0.25, 80.0))
    jt = jtransport.SimTransport(jwan.BandwidthTrace(*trace),
                                 jwan.WANConfig(**wan),
                                 probe=jtransport.MeasuredWanProbe())
    tt = SimTransport(BandwidthTrace(*trace), WANConfig(**wan),
                      probe=MeasuredWanProbe())
    script = [({"embed": 0.31, "norm": 0.002, "dense": 1.9}, 0.5),
              ({"all": 2.2}, 1.25), ({}, 0.5), ({"a": 0.0}, 0.5),
              ({"embed": 0.07, "dense": 0.4}, 2.0),
              ({"dense": 0.4}, 0.5), ({"embed": 0.9, "dense": 4.1}, 3.0),
              ({"dense": 1e-4}, 0.0)]
    for step, (wire, dt) in enumerate(script):
        assert tt.on_sync(wire, step=step) == jt.on_sync(wire, step=step)
        tt.tick(dt)
        jt.tick(dt)
        assert tt.clock_s == jt.clock_s
        assert tt.probe.estimator.bandwidth_mbps == \
            jt.probe.estimator.bandwidth_mbps
        assert dataclasses.astuple(tt.probe.probe) == \
            dataclasses.astuple(jt.probe.probe)
    assert [dataclasses.astuple(r) for r in tt.records] == \
        [dataclasses.astuple(r) for r in jt.records]
    assert [r.mbps for r in tt.records] == [r.mbps for r in jt.records]
    assert tt.probe.n_observations == jt.probe.n_observations == 6
    assert tt.probe.last_mbps == jt.probe.last_mbps
    # classic rounds leave no streaming summary; both sims stream, an
    # empty round declines, and a streamed round bills as the reference's
    assert tt.stream_rounds == jt.stream_rounds == []
    assert tt.supports_streaming and jt.supports_streaming
    assert tt.begin_stream_round({}) is jt.begin_stream_round({}) is False
    assert tt.begin_stream_round({"all": 1.0}, step=8) is \
        jt.begin_stream_round({"all": 1.0}, step=8) is True
    assert [tt.stream_chunk("all", mb) for mb in (0.25, 0.75)] == \
        [jt.stream_chunk("all", mb) for mb in (0.25, 0.75)]
    assert tt.end_stream_round() == jt.end_stream_round()
    assert tt.stream_rounds == jt.stream_rounds


def test_measured_loop_decisions_equal_the_reference():
    tsim, ttuner, tstream = _measured_loop(tautotune, ttransport, twan,
                                           SyncConfig)
    jsim, jtuner, jstream = _measured_loop(jautotune, jtransport, jwan,
                                           jsync.SyncConfig)
    assert tstream == jstream
    assert [dataclasses.astuple(r) for r in tsim.records] == \
        [dataclasses.astuple(r) for r in jsim.records]
    assert ttuner._probe_est.bandwidth_mbps == \
        jtuner._probe_est.bandwidth_mbps


@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
def test_chunk_checksum_rows_equal_the_reference(value_dtype):
    """The CRC32 runs over the same wire bytes on both sides: q (fp8 and
    int4 as their bit patterns), u16 idx, f32 scales."""
    rng = np.random.default_rng(3)
    flat = rng.normal(size=(N_PODS, 3000)).astype(np.float32)
    jcfg = jsync.SyncConfig("asgd_ga", 1, compress_topk=0.05,
                            quantize_int8=True, value_dtype=value_dtype,
                            codec_block=512, overlap_chunks=3)
    jchunks, _ = jsync._encode_bucket(jcfg, jnp.asarray(flat),
                                      want_local=False)
    tchunks = _chunks_to_port(jchunks)
    tself, _ = tsync._encode_bucket(_port_cfg(jcfg), torch.from_numpy(flat),
                                    want_local=False)
    want = jsync.chunk_checksum_rows(jchunks)
    assert len(set(want)) == N_PODS
    assert tsync.chunk_checksum_rows(tchunks) == want
    assert tsync.chunk_checksum_rows(tself) == want
    shipped = tsync._INLINE_RING.ship_bucket("all", tchunks, 1)
    tsync.verify_shipment("all", want, shipped, 1)
    with pytest.raises(tsync.CorruptPayloadError, match="receiver row 0"):
        tsync.verify_shipment("all", want, tchunks, 1)


class _StubShip:
    """A host-seam transport that follows a plan per ship call: ``ok``,
    ``fail`` (raises ``TransferFailed`` naming pod 1) or ``corrupt`` (the
    ring's bytes with receiver row 0's scales bumped)."""

    in_graph = False

    def __init__(self, S, W, corrupt, plan, max_retries, verify):
        self.S, self.corrupt, self.plan = S, corrupt, list(plan)
        self.retry_policy = W.RetryPolicy(max_retries=max_retries)
        self.verify_checksums = verify
        self.calls, self.retries = [], []

    def ship_bucket(self, name, chunks, shift, payload_mb=0.0):
        act = self.plan[len(self.calls)] if len(self.calls) < len(
            self.plan) else "ok"
        self.calls.append((name, act))
        if act == "fail":
            raise self.S.TransferFailed(name, len(self.calls), "stub", pod=1)
        out = self.S._INLINE_RING.ship_bucket(name, chunks, shift)
        if act == "corrupt":
            c = out[0]
            out = (self.S.ChunkPayload(c.q, c.idx, self.corrupt(c.scales)),
                   ) + tuple(out[1:])
        return out

    def note_retry(self, name, attempt, err):
        self.retries.append((name, attempt, type(err).__name__, err.pod))


def _bump_jax(s):
    return s.at[0].add(1.0)


def _bump_torch(s):
    s = s.clone()
    s[0] += 1.0
    return s


def _ship_outcome(S, W, bump, chunks, cfg, plan, max_retries, verify):
    stub = _StubShip(S, W, bump, plan, max_retries, verify)
    try:
        out = S.ship_sync_payloads(cfg, chunks, stub, {"a": 1.0, "b": 2.0})
        err = None
    except S.PodUnreachableError as e:
        out, err = None, (type(e).__name__, e.pod, e.bucket, str(e),
                          type(e.__cause__).__name__, e.__cause__.pod,
                          str(e.__cause__))
    return out, err, stub.calls, stub.retries


@pytest.mark.parametrize("plan,max_retries,verify", [
    ([], 0, True), (["corrupt"], 3, True), (["ok", "fail"], 3, False),
    (["fail", "fail"], 1, False), (["corrupt", "corrupt"], 1, True),
    (["ok", "corrupt", "fail", "corrupt"], 3, True),
    (["corrupt"], 3, False), (["fail"], 0, True)])
def test_verify_and_retry_equal_the_reference(plan, max_retries, verify):
    """The retry loop and the checksum verification under stub transports
    that fail or corrupt: the same exception types at the same attempt,
    the same retries noted, the same bytes shipped."""
    rng = np.random.default_rng(5)
    jcfg = jsync.SyncConfig("asgd_ga", 1, compress_topk=0.1,
                            quantize_int8=True, codec_block=128,
                            overlap_chunks=2)
    jchunks = {name: jsync._encode_bucket(jcfg, jnp.asarray(
        rng.normal(size=(N_PODS, 700)).astype(np.float32)),
        want_local=False)[0] for name in ("a", "b")}
    tchunks = {n: _chunks_to_port(c) for n, c in jchunks.items()}
    jout, jerr, jcalls, jret = _ship_outcome(jsync, jwan, _bump_jax, jchunks,
                                             jcfg, plan, max_retries, verify)
    tout, terr, tcalls, tret = _ship_outcome(tsync, twan, _bump_torch,
                                             tchunks, _port_cfg(jcfg), plan,
                                             max_retries, verify)
    assert (terr, tcalls, tret) == (jerr, jcalls, jret)
    assert (tout is None) == (jout is None)
    if jout is not None:
        for name in jout:
            for jc, tc in zip(jout[name], tout[name]):
                for a, b in zip(jc, tc):
                    _eq(a, b)


def test_degraded_finish_equals_the_masked_finish():
    """The trainer's round under a transport reporting
    ``round_failed_pods=(1,)`` finishes over ``alive=[1, 0]``: the port's
    ``finish_codec_sync(..., alive=)`` and the reference's, bit for bit."""

    class Failing(tsync.InlineRingShip):
        round_failed_pods = (1,)

    jcfg = dataclasses.replace(JSYNC_CFG, interval=1)
    tcfg = _port_cfg(jcfg)
    params, state = _jax_state(n_pods=2, seed=6)
    lr = 0.05
    tparams, tstate = _to_port(params, state)
    tr = Trainer(None, None, TrainerConfig(n_pods=2, lr=lr, sync=tcfg),
                 device="cpu", transport=Failing())
    got, _ = tr._sync_round(TrainState(tparams, None, tstate, 0))

    alive = np.array([1.0, 0.0], np.float32)
    tparams, tstate = _to_port(params, state)
    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    tship = tsync.ship_sync_payloads(tcfg, tpay.chunks)
    tp, ts = tsync.finish_codec_sync(tcfg, tparams, tstate, tpay, tship, lr,
                                     alive=torch.from_numpy(alive))
    jpay = jax.jit(functools.partial(jsync.prepare_codec_sync, jcfg))(state)
    jship = jsync.ship_sync_payloads(jcfg, jpay.chunks)
    jp, js = jsync.finish_codec_sync(jcfg, params, state, jpay, jship, lr,
                                     jnp.asarray(alive))
    for a, b, c in zip(T.leaves(got.params), T.leaves(tp),
                       jax.tree.leaves(jp)):
        assert torch.equal(a, b)
        _eq(c, a)
    for name in ("ef_residual", "msg_norm", "resid_norm", "tier"):
        assert torch.equal(getattr(got.sync_state, name), getattr(ts, name))
    _eq(js.ef_residual, got.sync_state.ef_residual)
    # the dead pod's telemetry is zeroed and its message stays whole in
    # its residual
    assert float(got.sync_state.msg_norm[1].abs().sum()) == 0.0


class _Hooks:
    """A transport exposing the trainer's duck-typed hooks: its own WAN
    transfer count, a per-round ``begin_round`` and the ``on_sync``
    barrier, shipping over the inline ring of ``S``."""

    in_graph = True
    wan_transfers_per_round = 5

    def __init__(self, S):
        self.S, self.begun, self.synced = S, [], []

    def ship_bucket(self, name, chunks, shift, payload_mb=0.0):
        return self.S._INLINE_RING.ship_bucket(name, chunks, shift,
                                               payload_mb)

    def begin_round(self, step):
        self.begun.append(step)

    def on_sync(self, wire_mb, step=None):
        self.synced.append((step, dict(wire_mb)))
        return 0.0


@pytest.mark.parametrize("strategy", ["asgd_ga", "ama"])
def test_trainer_hooks_equal_the_reference(strategy):
    """``maybe_sync`` bills traffic at the transport's transfer count, arms
    each round with ``begin_round`` and closes it with ``on_sync`` (every
    strategy's rounds), as the reference trainer does."""
    from repro.training.trainer import Trainer as JTrainer
    from repro.training.trainer import TrainerConfig as JTrainerConfig

    jcfg = (jsync.SyncConfig("asgd_ga", 2, compress_topk=0.2,
                             quantize_int8=True, error_feedback=True,
                             codec_block=128, bucket_policy="layer-class")
            if strategy == "asgd_ga" else jsync.SyncConfig("ama", 2))
    tcfg = _port_cfg(jcfg)
    jhooks, thooks = _Hooks(jsync), _Hooks(tsync)

    def jloss(params, batch):
        pred = batch["x"] @ params["w"] + params["bias"]
        return jnp.mean((pred - batch["y"]) ** 2) + 0.01 * jnp.mean(
            params["embed"] ** 2), {}

    def jinit(key):
        return {"w": jnp.full((8, 4), 0.1), "bias": jnp.zeros((4,)),
                "embed": jnp.full((16, 4), 0.1)}

    jtr = JTrainer(jloss, jinit, JTrainerConfig(n_pods=2, sync=jcfg),
                   transport=jhooks)
    ttr = Trainer(_loss, _init, TrainerConfig(n_pods=2, sync=tcfg),
                  device="cpu", transport=thooks)
    jst, tst = jtr.init_state(jax.random.key(0)), ttr.init_state(0)
    rng = np.random.default_rng(2)
    for step in range(6):
        x = rng.normal(size=(2, 4, 8)).astype(np.float32)
        y = rng.normal(size=(2, 4, 4)).astype(np.float32)
        jst, _ = jtr.train_step(jst, {"x": jnp.asarray(x),
                                      "y": jnp.asarray(y)})
        jst = jtr.maybe_sync(jst, step, model_mb=0.25)
        tst, _ = ttr.train_step(tst, {"x": torch.from_numpy(x),
                                      "y": torch.from_numpy(y)})
        tst = ttr.maybe_sync(tst, step, model_mb=0.25)
    assert ttr.traffic_mb == jtr.traffic_mb
    assert thooks.begun == jhooks.begun == [1, 3, 5]
    assert thooks.synced == jhooks.synced
    assert len(thooks.synced) == 3


LAUNCH_FLAGS = ["--preset", "tiny", "--pods", "2", "--steps", "8",
                "--batch", "4", "--seq", "16", "--interval", "2",
                "--wan-trace", "100@0,5@3,40@6", "--log-every", "0"]
CODEC_FLAGS = ["--compress-topk", "0.05", "--int8", "--error-feedback",
               "--bucket-policy", "layer-class"]


@pytest.mark.parametrize("extra", [
    CODEC_FLAGS + ["--transport", "sim"],
    ["--sync", "ama", "--transport", "sim:fluct=0.1,latency=0.02,seed=2"],
    CODEC_FLAGS + ["--transport", "mesh:mbps=500"]],
    ids=["asgd_ga-sim", "ama-sim", "asgd_ga-mesh"])
def test_launcher_transport_equals_the_reference(extra):
    """Without retunes the billing depends only on shapes and the clock:
    ``transfers`` and sim's ``measured_bandwidth_mbps`` equal the
    reference launcher's exactly; mesh's records count equals, its
    bandwidth is measured."""
    flags = LAUNCH_FLAGS + extra
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(flags)
    jlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[transport]")]
    jparams = get_model_fns("transformer").init_params(
        jax.random.key(0), jtrain.preset_tiny())
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      ttrain.preset_tiny(), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(flags + ["--device", "cpu"], init_params=tparams)
    tlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[transport]")]
    mesh = "mesh" in extra[-1]
    if mesh:
        assert tlines == [f"[transport] {extra[-1]}: MeshTransport, "
                          f"1 devices, unsharded"]
    else:
        assert tlines == jlines
    assert ts["transport"] == js["transport"] == extra[-1]
    assert ts["wan_transfers_per_round"] is js["wan_transfers_per_round"] \
        is None
    assert ts["transfers"] == js["transfers"] == (
        12 if "--int8" in extra else 4)
    assert ts["wan_traffic_mb"] == js["wan_traffic_mb"]
    if mesh:
        assert ts["measured_bandwidth_mbps"] is not None
    else:
        assert ts["measured_bandwidth_mbps"] == js["measured_bandwidth_mbps"]
    assert ts["loss_first"] == pytest.approx(js["loss_first"],
                                             rel=LOSS_RTOL)
    assert ts["loss_last"] == pytest.approx(js["loss_last"], rel=LOSS_RTOL)
