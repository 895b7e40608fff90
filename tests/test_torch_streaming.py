"""Port parity: streaming chunk-granular rounds (``_StreamRound`` and the
transports' stream protocol, ``reencode_unsent`` /
``finish_codec_sync_split``, ``Trainer._stream_sync``) against
``repro.core.transport``, ``repro.core.sync`` and
``repro.training.trainer``.

The cases mirror ``tests/test_streaming.py`` one for one.  Each runs the
scenario through the port and, where the reference's side says something
the port's must equal, through the reference too, from the same inputs:
``SYNC``, ``TRACE``, the ``_loss`` / ``_init`` model (the reference draws
the parameters, which reach the port as numpy) and rng-7 batches.  The
port's own contracts hold bit for bit: a zero-retune streaming round is
the classic round (params, EF residual, norms, tier, billed records, probe
belief and rng stream) on the sim, mesh, hierarchical and clean-chaos
transports; a retuned round's EF residual is ``flat - spliced_local``; the
stream before the cliff is the classic stream.  The two packages agree
exactly where they see the same numbers: billing, chunk observations and
controller decisions come from shapes and the seeded clock, not from
gradients, and the tail re-encode of the same flat buffer is bit-equal.
Parameters trained from each framework's own gradients agree within
``PARAM_ATOL``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import faults as jfaults
from repro.core import sync as jsync
from repro.core import topology as jtopology
from repro.core import transport as jtransport
from repro.core import wan as jwan
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import tree as T
from repro_torch.core.autotune import BucketStats, StreamingShipController
from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
from repro_torch.core.sync import (BucketOverride, SyncConfig, _chunk_widths,
                                   bucket_layout, is_sync_step,
                                   prepare_codec_sync, reencode_unsent)
from repro_torch.core.topology import HierarchicalTransport, TopologySpec
from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                        SimTransport)
from repro_torch.core.wan import (BandwidthTrace, WANConfig,
                                  stream_chunk_plan, stream_chunk_time)
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

# tests/test_torch_faults.py's tolerance for parameters trained from each
# framework's own f32 gradients (the codec's 16-bit key can pick another
# winner now and then, which moves a value by one receiver update)
PARAM_ATOL = 2e-3

KNOBS = dict(compress_topk=0.2, quantize_int8=True, error_feedback=True,
             codec_block=128, overlap_chunks=2, bucket_policy="layer-class")
SYNC = SyncConfig("asgd_ga", 2, **KNOBS,
                  buckets=(BucketOverride("norm", compress_topk=0.5),))
JSYNC = jsync.SyncConfig("asgd_ga", 2, **KNOBS,
                         buckets=(jsync.BucketOverride("norm",
                                                       compress_topk=0.5),))
TRACE_ARGS = ((0.0, 3.0), (100.0, 2.0))
TRACE = BandwidthTrace(*TRACE_ARGS)
# zero latency + zero fluctuation: a chunk's billed seconds express the
# traced bandwidth exactly, so the cliff law sees the collapse undiluted
CLEAN = dict(latency_s=0.0, fluctuation=0.0)
CLEAN_WAN = WANConfig(**CLEAN)
FLUCT = dict(fluctuation=0.2, seed=3)


def _jloss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    reg = jnp.mean(params["embed"] ** 2)
    return jnp.mean((pred - batch["y"]) ** 2) + 0.01 * reg, {}


def _jinit(key):
    kw, ke = jax.random.split(key)
    return {"w": jax.random.normal(kw, (8, 4)) * 0.1,
            "bias": jnp.zeros((4,)),
            "embed": jax.random.normal(ke, (16, 4)) * 0.1}


@functools.lru_cache(maxsize=None)
def _init_np():
    return jax.tree.map(np.asarray, _jinit(jax.random.key(0)))


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    reg = torch.mean(params["embed"] ** 2)
    return torch.mean((pred - batch["y"]) ** 2) + 0.01 * reg, {}


def _init(gen):
    del gen
    return {k: torch.from_numpy(v.copy()) for k, v in _init_np().items()}


def _never_retuning(pkg="port", probe_est=None):
    """A live controller that can never fire (no belief to compare
    against): the whole streaming protocol with zero retunes."""
    mod = StreamingShipController if pkg == "port" else \
        jautotune.StreamingShipController
    return mod(SYNC if pkg == "port" else JSYNC, 0.001, probe_est=probe_est)


def _batches(n_steps, n_pods=2):
    rng = np.random.default_rng(7)
    for _ in range(n_steps):
        x = rng.normal(size=(n_pods, 16, 8)).astype(np.float32)
        yield x, (x[..., :4] * 0.5).astype(np.float32)


def _run(transport, stream=None, n_steps=10):
    """Drive the port's trainer; returns (state, trainer, per-step
    (msg_norm, ef_residual) copies)."""
    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                               sync=SYNC),
                 device="cpu", transport=transport, stream=stream)
    st = tr.init_state(0)
    snaps = []
    for step, (x, y) in enumerate(_batches(n_steps)):
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        st = tr.maybe_sync(st, step, model_mb=0.001)
        if transport is not None and hasattr(transport, "tick"):
            transport.tick(0.5)
        snaps.append((st.sync_state.msg_norm.clone(),
                      st.sync_state.ef_residual.clone()))
    return st, tr, snaps


def _jrun(transport, stream=None, n_steps=10):
    """The same drive through the reference's trainer."""
    tr = JTrainer(_jloss, _jinit,
                  JTrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                                 sync=JSYNC),
                  transport=transport, stream=stream)
    st = tr.init_state(jax.random.key(0))
    snaps = []
    for step, (x, y) in enumerate(_batches(n_steps)):
        st, _ = tr.train_step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        st = tr.maybe_sync(st, step, model_mb=0.001)
        if transport is not None and hasattr(transport, "tick"):
            transport.tick(0.5)
        snaps.append((np.asarray(st.sync_state.msg_norm).copy(),
                      np.asarray(st.sync_state.ef_residual).copy()))
    return st, tr, snaps


def _assert_same_stream(a, b, label):
    """Bit-identical params and SyncState telemetry, at every step."""
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


def _assert_near_reference(port, ref, label):
    """The port's run against the reference's: params within
    ``PARAM_ATOL`` (each framework's own gradients)."""
    for name, leaf in port[0].params.items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(ref[0].params[name]),
                                   atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{label}: {name}")


def _records(t):
    return [(r.bucket, r.payload_mb, r.seconds, r.step) for r in t.records]


def _sim(pkg, wan):
    if pkg == "port":
        return SimTransport(TRACE, WANConfig(**wan), probe=MeasuredWanProbe())
    return jtransport.SimTransport(jwan.BandwidthTrace(*TRACE_ARGS),
                                   jwan.WANConfig(**wan),
                                   probe=jtransport.MeasuredWanProbe())


# -------------------------------------------- zero-retune bit-exactness


def test_streaming_zero_retune_bit_identical_sim():
    """With the streaming protocol active but no retune fired, everything
    is the classic path's: params, telemetry, billed records, probe
    belief, rng stream.  The billing and the chunk stream are the
    reference's, float for float."""
    sim_c, sim_s = _sim("port", FLUCT), _sim("port", FLUCT)
    classic = _run(sim_c)
    ctl = _never_retuning()
    streamed = _run(sim_s, stream=ctl)
    _assert_same_stream(classic, streamed, "sim streaming vs classic")
    _assert_same_stream(_run(None), streamed, "sim streaming vs inline")
    assert _records(sim_s) == _records(sim_c)
    assert (sim_s.probe.estimator.bandwidth_mbps
            == sim_c.probe.estimator.bandwidth_mbps)
    assert sim_s.probe.n_observations == sim_c.probe.n_observations
    assert sim_s.on_sync({"all": 0.5}) == sim_c.on_sync({"all": 0.5})
    assert len(sim_s.stream_rounds) == 5
    assert not any(r["retuned"] for r in sim_s.stream_rounds)
    assert sim_s.probe.n_chunk_observations == len(ctl.decisions) > 0
    assert all(d["action"] == "ship" for d in ctl.decisions)

    jsim = _sim("ref", FLUCT)
    jctl = _never_retuning("ref")
    ref = _jrun(jsim, stream=jctl)
    # the next classic draw after the stream, too
    jsim.on_sync({"all": 0.5})
    assert _records(sim_s) == _records(jsim)
    assert sim_s.stream_rounds == jsim.stream_rounds
    assert ctl.decisions == jctl.decisions
    assert (sim_s.probe.estimator.bandwidth_mbps
            == jsim.probe.estimator.bandwidth_mbps)
    _assert_near_reference(streamed, ref, "sim streaming vs reference")


def _hier(pkg):
    mod, wan = ((None, WANConfig) if pkg == "port"
                else (jtopology, jwan.WANConfig))
    if pkg == "port":
        spec = TopologySpec.from_regions(["us", "eu"], kind="tree")
        return HierarchicalTransport(spec, TRACE, wan=wan(**FLUCT),
                                     probe=MeasuredWanProbe())
    spec = mod.TopologySpec.from_regions(["us", "eu"], kind="tree")
    return mod.HierarchicalTransport(
        spec, jwan.BandwidthTrace(*TRACE_ARGS), wan=wan(**FLUCT),
        probe=jtransport.MeasuredWanProbe())


def test_streaming_zero_retune_bit_identical_hierarchical():
    t_c, t_s = _hier("port"), _hier("port")
    classic = _run(t_c)
    streamed = _run(t_s, stream=_never_retuning())
    _assert_same_stream(classic, streamed, "hier streaming vs classic")
    assert _records(t_s) == _records(t_c)
    assert (t_s.probe.estimator.bandwidth_mbps
            == t_c.probe.estimator.bandwidth_mbps)
    # begin_stream_round observes exactly what on_sync does: the per-link
    # beliefs and the recompiled schedule are the classic run's
    assert t_s.beliefs.snapshot() == t_c.beliefs.snapshot()
    assert t_s.schedule == t_c.schedule
    assert len(t_s.stream_rounds) == 5

    jt = _hier("ref")
    ref = _jrun(jt, stream=_never_retuning("ref"))
    assert _records(t_s) == _records(jt)
    assert t_s.stream_rounds == jt.stream_rounds
    assert t_s.beliefs.snapshot() == jt.beliefs.snapshot()
    _assert_near_reference(streamed, ref, "hier streaming vs reference")


def test_streaming_zero_retune_bit_identical_mesh():
    """Mesh billing is wall-clock, but the shipped bytes are exact: params
    and telemetry equal the classic mesh run and the inline ring; the
    records keep the per-bucket structure and MB of the reference's."""
    mesh_c = MeshTransport(probe=MeasuredWanProbe())
    mesh_s = MeshTransport(probe=MeasuredWanProbe())
    classic = _run(mesh_c)
    streamed = _run(mesh_s, stream=_never_retuning())
    _assert_same_stream(classic, streamed, "mesh streaming vs classic")
    _assert_same_stream(_run(None), streamed, "mesh streaming vs inline")
    assert len(mesh_s.stream_rounds) == 5
    assert {r.bucket for r in mesh_s.records} == \
        {r.bucket for r in mesh_c.records}
    assert mesh_s.probe.n_observations == mesh_c.probe.n_observations == 5
    assert mesh_s.probe.n_chunk_observations > 0
    mb_c = sorted((r.bucket, round(r.payload_mb, 12)) for r in mesh_c.records)
    mb_s = sorted((r.bucket, round(r.payload_mb, 12)) for r in mesh_s.records)
    assert mb_s == mb_c

    jmesh = jtransport.MeshTransport(probe=jtransport.MeasuredWanProbe())
    ref = _jrun(jmesh, stream=_never_retuning("ref"))
    assert [(r.bucket, r.payload_mb, r.step) for r in mesh_s.records] == \
        [(r.bucket, r.payload_mb, r.step) for r in jmesh.records]
    assert [[(b, mb) for b, mb, _ in r["chunks"]]
            for r in mesh_s.stream_rounds] == \
        [[(b, mb) for b, mb, _ in r["chunks"]] for r in jmesh.stream_rounds]
    _assert_near_reference(streamed, ref, "mesh streaming vs reference")


# ------------------------------------------------- the mid-round retune


def _forced_cliff_run(n_steps=10):
    """Sim transport over the collapsing trace with the belief wired in:
    the first post-collapse chunk reads 2 Mbps against a ~100 Mbps belief
    and the cliff law fires.  Returns (transport, controller, trainer,
    final state, info): ``info`` holds the retuned round's step, its ship
    order and cut, the sync state just before it (cloned: the port's
    round consumes its state in place), the EF residual just after it and
    the round hook's view of it."""
    t = SimTransport(TRACE, CLEAN_WAN, probe=MeasuredWanProbe())
    ctl = StreamingShipController(SYNC, 0.001, cliff_ratio=2.0,
                                  ef_guard=0.999,
                                  probe_est=t.probe.estimator)
    ships, marks, hooked = [], [], []
    orig_ship, orig_retune = t.stream_ship_chunk, t.retune_stream

    def spy_ship(name, chunk, shift, mb):
        ships.append(name)
        return orig_ship(name, chunk, shift, mb)

    def spy_retune(tail_mb):
        marks.append(len(ships))
        return orig_retune(tail_mb)

    t.stream_ship_chunk, t.retune_stream = spy_ship, spy_retune
    info, pre = {}, {}

    def spy(step, st):
        pre["n"] = len(ships)
        if is_sync_step(SYNC, step):
            ss = st.sync_state
            pre["state"] = ss._replace(
                ga_buffer=T.tree_map(lambda x: x.clone(), ss.ga_buffer),
                ef_residual=ss.ef_residual.clone())

    def hook(state, payloads, shipped, sync, retune=None):
        hooked.append(retune)

    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=2, optimizer="sgd", lr=0.05,
                               sync=SYNC),
                 device="cpu", transport=t, stream=ctl, round_hook=hook)
    st = tr.init_state(0)
    for step, (x, y) in enumerate(_batches(n_steps)):
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        spy(step, st)
        st = tr.maybe_sync(st, step, model_mb=0.001)
        if tr.stream_retunes and "step" not in info:
            info.update(step=step, round_ships=ships[pre["n"]:],
                        cut=marks[0] - pre["n"], state=pre["state"],
                        resid_after=st.sync_state.ef_residual.clone(),
                        retune=hooked[-1])
        t.tick(0.5)
    return t, ctl, tr, st, info


@functools.lru_cache(maxsize=None)
def _jforced_cliff():
    """The reference's forced-cliff run: its transport and controller."""
    t = _sim("ref", CLEAN)
    ctl = jautotune.StreamingShipController(JSYNC, 0.001, cliff_ratio=2.0,
                                            ef_guard=0.999,
                                            probe_est=t.probe.estimator)
    st, tr, _ = _jrun(t, stream=ctl)
    return t, ctl, tr, st


def test_streaming_retune_fires_on_mid_round_cliff():
    t, ctl, tr, st, info = _forced_cliff_run()
    assert tr.stream_retunes == 1 and ctl.n_retunes == 1
    k = info["step"]
    rd = next(r for r in t.stream_rounds if r["step"] == k)
    assert rd["retuned"] and rd["tail_mb"] > 0.0 and rd["t_tail"] > 0.0
    retunes = [d for d in ctl.decisions if d["action"] == "retune"]
    assert len(retunes) == 1 and retunes[0]["step"] == k
    assert retunes[0]["achieved"] * ctl.cliff_ratio < retunes[0]["believed"]
    # the retuned round's aggregate cliff-snapped the shared belief
    assert t.probe.estimator.bandwidth_mbps == pytest.approx(2.0)
    assert sum(r["retuned"] for r in t.stream_rounds) == 1
    assert bool(torch.isfinite(st.sync_state.ef_residual).all())
    # the round hook saw the retune: the tail at the retune's rung
    rt = info["retune"]
    cheap = ctl.ladder[retunes[0]["rung"]]
    assert rt is not None and sorted(rt.tails) == sorted(rt.tail_shipped)
    assert (rt.cfg_to.compress_topk, rt.cfg_to.value_dtype) == \
        (cheap.compress_topk, cheap.value_dtype)

    # the reference fires at the same chunk of the same round: the chunk
    # stream, the tail's price and the decisions are its, float for float
    jt, jctl, jtr, _ = _jforced_cliff()
    assert jtr.stream_retunes == tr.stream_retunes == 1
    assert t.stream_rounds == jt.stream_rounds
    assert ctl.decisions == jctl.decisions
    assert _records(t) == _records(jt)
    assert t.probe.estimator.bandwidth_mbps == \
        jt.probe.estimator.bandwidth_mbps


def test_streaming_retune_ef_residual_is_exact_fidelity_delta():
    """Recompute ``flat - spliced_local`` for the retuned round through the
    public ``reencode_unsent`` seam, from the round's pre-round state, and
    require the trainer's EF residual to match it bit for bit; the
    reference's re-encode of the same flat buffer gives the same tails."""
    t, ctl, tr, _, info = _forced_cliff_run()
    cfg = SYNC
    payloads = prepare_codec_sync(cfg, info["state"])
    layout = bucket_layout(cfg, info["state"].ga_buffer)
    sent = {name: 0 for name in payloads.chunks}
    for name in info["round_ships"][:info["cut"]]:
        sent[name] += 1
    assert sent == info["retune"].sent
    rung = next(d for d in ctl.decisions if d["action"] == "retune")["rung"]
    cheap = ctl.ladder[rung]
    cfg_to = dataclasses.replace(cfg, compress_topk=cheap.compress_topk,
                                 value_dtype=cheap.value_dtype)
    tails, tail_local = reencode_unsent(cfg, cfg_to, payloads.flat, layout,
                                        sent)
    assert tails, "the forced cliff must leave an unsent tail"
    spliced = payloads.local.clone()
    for g, name in enumerate(layout.names):
        if name not in tails:
            continue
        off, size = layout.offsets[g], layout.sizes[g]
        widths = _chunk_widths(cfg.for_bucket(name), size)
        sw = int(sum(widths[:sent[name]]))
        spliced[:, off + sw:off + size] = tail_local[name]
    expected = payloads.flat - spliced
    assert torch.equal(info["resid_after"], expected), \
        "EF residual != flat - spliced_local after the retune"
    # the delta is real: the cheap tail dropped more than the planned
    # encoding would have
    no_retune = payloads.flat - payloads.local
    assert float(expected.norm()) > float(no_retune.norm())
    # the tails the round shipped are the ones re-encoded here
    for name, chunks in tails.items():
        for a, b in zip(chunks, info["retune"].tails[name], strict=True):
            assert all(torch.equal(x, y) for x, y in zip(a, b))

    jcfg_to = dataclasses.replace(JSYNC, compress_topk=cheap.compress_topk,
                                  value_dtype=cheap.value_dtype)
    jlayout = jsync.bucket_layout(JSYNC, jax.tree.map(
        lambda x: jnp.asarray(x.numpy()), info["state"].ga_buffer))
    jtails, jlocal = jsync.reencode_unsent(
        JSYNC, jcfg_to, jnp.asarray(payloads.flat.numpy()), jlayout, sent)
    assert sorted(jtails) == sorted(tails)
    for name in tails:
        np.testing.assert_array_equal(np.asarray(jlocal[name]),
                                      tail_local[name].numpy())
        for jc, tc in zip(jtails[name], tails[name], strict=True):
            for a, b in zip(jc, tc):
                a = np.asarray(a)
                b = b.numpy()
                if a.dtype.itemsize == 1:
                    a, b = a.view(np.uint8), b.view(np.uint8)
                np.testing.assert_array_equal(a, b.astype(a.dtype)
                                              if a.dtype != b.dtype else b)


def test_streaming_retune_stays_bit_exact_before_the_cliff():
    """Divergence starts at the retuned round, not before: the pre-cliff
    prefix of the streaming run matches the classic run bit for bit; the
    reference retunes at the same round."""
    _, _, _, _, info = _forced_cliff_run()
    k = info["step"]
    _, _, snaps_classic = _run(SimTransport(TRACE, CLEAN_WAN,
                                            probe=MeasuredWanProbe()))
    t3 = SimTransport(TRACE, CLEAN_WAN, probe=MeasuredWanProbe())
    ctl3 = StreamingShipController(SYNC, 0.001, cliff_ratio=2.0,
                                   ef_guard=0.999,
                                   probe_est=t3.probe.estimator)
    _, _, snaps_stream = _run(t3, stream=ctl3)
    for i in range(k):
        assert torch.equal(snaps_stream[i][0], snaps_classic[i][0])
        assert torch.equal(snaps_stream[i][1], snaps_classic[i][1])
    assert not torch.equal(snaps_stream[k][1], snaps_classic[k][1])
    jt, _, _, _ = _jforced_cliff()
    assert [r["step"] for r in jt.stream_rounds if r["retuned"]] == [k]


# ------------------------------------------------ controller law (units)


def _controller_law(pkg):
    """tests/test_streaming.py's hysteresis, guard-block and reset cases
    through one package's controller; returns the decision streams."""
    if pkg == "port":
        probe, ctl_cls, sync, stats = (MeasuredWanProbe(),
                                       StreamingShipController, SYNC,
                                       BucketStats)
    else:
        probe, ctl_cls, sync, stats = (jtransport.MeasuredWanProbe(),
                                       jautotune.StreamingShipController,
                                       JSYNC, jautotune.BucketStats)
    probe.observe_transfer(1.0, 0.08)          # belief 100 Mbps
    ctl = ctl_cls(sync, 1.0, cliff_ratio=4.0, hysteresis=2,
                  probe_est=probe.estimator)
    ctl.begin_round(0, sync)
    first = ctl.observe_chunk("dense", 0.1, 0.8)
    held = ctl.decisions[-1]["action"]
    fired = ctl.observe_chunk("dense", 0.1, 0.8)
    ended = ctl.end_round()
    ctl2 = ctl_cls(sync, 1.0, cliff_ratio=4.0, ef_guard=0.9,
                   probe_est=probe.estimator)
    ctl2.note_stats(stats(msg_norm=1.0, resid_norm=0.95))
    ctl2.begin_round(1, sync)
    blocked = ctl2.observe_chunk("dense", 0.1, 0.8)
    ctl3 = ctl_cls(sync, 1.0, cliff_ratio=4.0, hysteresis=2,
                   probe_est=probe.estimator)
    ctl3.begin_round(2, sync)
    ctl3.observe_chunk("dense", 0.1, 0.8)      # cliff -> streak 1
    ctl3.observe_chunk("dense", 0.1, 0.008)    # full speed -> reset
    reset = ctl3.observe_chunk("dense", 0.1, 0.8)
    return {"first": first, "held": held, "fired": fired, "ended": ended,
            "blocked": blocked, "ctl": ctl, "ctl2": ctl2, "ctl3": ctl3,
            "reset": reset}


def test_controller_hysteresis_and_guard_block():
    got = _controller_law("port")
    assert got["first"] is None and got["held"] == "hold"
    assert got["fired"] is not None
    assert got["ctl"].decisions[-1]["action"] == "retune"
    assert got["ended"]
    assert got["blocked"] is None
    assert got["ctl2"].decisions[-1]["action"] == "guard-block"
    assert got["ctl2"].n_retunes == 0 and not got["ctl2"].end_round()
    assert got["reset"] is None and got["ctl3"].n_retunes == 0
    ref = _controller_law("ref")
    for name in ("ctl", "ctl2", "ctl3"):
        assert got[name].decisions == ref[name].decisions, name
    assert (got["fired"].compress_topk, got["fired"].value_dtype) == \
        (ref["fired"].compress_topk, ref["fired"].value_dtype)


def test_stream_chunk_billing_law():
    """The shared chunk-billing law: chunks bill pro-rata slices of the
    round draw and sum back; float for float the reference's."""
    plan = stream_chunk_plan(1.0, 4)
    assert plan == [0.25] * 4 == jwan.stream_chunk_plan(1.0, 4)
    t_round = 3.7
    parts = [stream_chunk_time(t_round, mb, 1.0) for mb in plan]
    assert sum(parts) == pytest.approx(t_round)
    assert parts == [jwan.stream_chunk_time(t_round, mb, 1.0) for mb in plan]
    assert stream_chunk_time(t_round, 0.5, 0.0) == 0.0
    for n in (1, 3, 7):
        assert stream_chunk_plan(2.3, n) == jwan.stream_chunk_plan(2.3, n)


# --------------------------------------------------- chaos composition


def test_chaos_declines_streaming_on_faulted_rounds():
    plan = FaultPlan(events=(FaultEvent(kind="timeout", step=5, pod=1,
                                        factor=6.0, attempts=1),), seed=0)
    inner = SimTransport(TRACE, WANConfig(fluctuation=0.0),
                         probe=MeasuredWanProbe())
    chaos = ChaosTransport(inner, plan)
    assert chaos.supports_streaming            # delegates to the sim
    assert chaos.begin_stream_round({"all": 0.5}, step=5) is False
    assert chaos.begin_stream_round({"all": 0.5}, step=4) is True
    inner.end_stream_round()

    inner2 = SimTransport(TRACE, WANConfig(fluctuation=0.0),
                          probe=MeasuredWanProbe())
    chaos2 = ChaosTransport(inner2, plan)
    st, _, _ = _run(chaos2, stream=_never_retuning(), n_steps=12)
    # interval 2 over 12 steps -> 6 sync rounds; the step-5 fault round
    # went down the classic resolve_round path, the rest streamed
    assert len(inner2.stream_rounds) == 5
    assert [o["step"] for o in chaos2.outcomes] == [5]
    assert bool(torch.isfinite(st.sync_state.ef_residual).all())

    jinner = _sim("ref", dict(fluctuation=0.0))
    jplan = jfaults.FaultPlan(events=(jfaults.FaultEvent(
        kind="timeout", step=5, pod=1, factor=6.0, attempts=1),), seed=0)
    jchaos = jfaults.ChaosTransport(jinner, jplan)
    _jrun(jchaos, stream=_never_retuning("ref"), n_steps=12)
    assert chaos2.outcomes == jchaos.outcomes
    assert inner2.stream_rounds == jinner.stream_rounds
    assert _records(inner2) == _records(jinner)


def test_chaos_clean_plan_streaming_still_bit_exact():
    """An empty chaos plan is a bit-exact passthrough for streaming too."""
    empty = FaultPlan(events=(), seed=0)
    sim = _sim("port", FLUCT)
    inner = _sim("port", FLUCT)
    chaos = ChaosTransport(inner, empty)
    classic = _run(sim)
    streamed = _run(chaos, stream=_never_retuning())
    _assert_same_stream(classic, streamed, "chaos streaming vs classic")
    assert _records(inner) == _records(sim)
    assert len(inner.stream_rounds) == 5

    jinner = _sim("ref", FLUCT)
    _jrun(jfaults.ChaosTransport(jinner, jfaults.FaultPlan(events=(),
                                                           seed=0)),
          stream=_never_retuning("ref"))
    assert _records(inner) == _records(jinner)
    assert inner.stream_rounds == jinner.stream_rounds


# ------------------------------------------- mesh per-chunk observation


def test_mesh_measure_overlap_reports_per_chunk_timings():
    """measure_overlap reports each chunk's transfer seconds for both
    schedules; its chunk schedule is the reference's."""
    cfg = SyncConfig("asgd_ga", 4, compress_topk=0.05, quantize_int8=True,
                     error_feedback=True, codec_block=1024,
                     overlap_chunks=4)
    mesh = MeshTransport(emulate_mbps=2.0)
    rep = mesh.measure_overlap(cfg, n_pods=4, n_elems=1 << 16, reps=1,
                               device="cpu")
    assert rep["chunks"] == 4
    assert len(rep["chunk_mb"]) == 4
    hops = rep["chunk_transfer_s"]
    assert set(hops) == {"serialized", "pipelined"}
    assert len(hops["serialized"]) == len(hops["pipelined"]) == 4
    assert all(h > 0.0 for h in hops["serialized"])
    assert all(h > 0.0 for h in hops["pipelined"])
    assert sum(hops["serialized"]) <= rep["t_serialized_s"] + 1e-6
    jcfg = jsync.SyncConfig("asgd_ga", 4, compress_topk=0.05,
                            quantize_int8=True, error_feedback=True,
                            codec_block=1024, overlap_chunks=4)
    jmb = [jcfg.payload_mb(4 * m / 1e6)
           for m in jsync._chunk_widths(jcfg, 1 << 16)]
    assert rep["chunk_mb"] == [round(mb, 6) for mb in jmb]
    assert rep["wire_mb"] == round(sum(jmb), 4)


def test_mesh_streaming_chunk_observations_feed_probe():
    mesh = MeshTransport(probe=MeasuredWanProbe(), emulate_mbps=50.0)
    _run(mesh, stream=_never_retuning(), n_steps=4)
    assert len(mesh.stream_rounds) == 2
    assert mesh.probe.n_chunk_observations > 0
    assert mesh.probe.last_chunk_mbps is not None
    mb, s, mbps = mesh.probe.chunk_log[-1]
    assert mb > 0 and s > 0 and mbps == pytest.approx(mb * 8.0 / s)
    # every chunk's seconds hold at least its emulated hop
    assert all(s >= m * 8.0 / 50.0 for m, s, _ in mesh.probe.chunk_log)
    jmesh = jtransport.MeshTransport(probe=jtransport.MeasuredWanProbe(),
                                     emulate_mbps=50.0)
    _jrun(jmesh, stream=_never_retuning("ref"), n_steps=4)
    assert [m for m, _, _ in mesh.probe.chunk_log] == \
        [m for m, _, _ in jmesh.probe.chunk_log]
