"""Port parity: fault injection and tolerance (``repro_torch.core.faults``,
the launcher's ``--faults`` / ``--no-tolerance`` / ``--ckpt-dir``) against
``repro.core.faults`` and ``repro.launch.train``.

The cases mirror ``tests/test_faults.py`` one for one, the crash with an
async snapshot in flight through the port's ``AsyncCheckpointEngine``.
Each case runs the same scenario through both
packages from the same inputs: ``SYNC``, ``TRACE``, the ``_loss`` /
``_init`` model (the reference draws the parameters, which reach the port
as numpy) and rng-7 batches.  The port's own contract holds bit for bit
(an empty plan is the bare transport; a retried or re-shipped run is the
clean run), and the two packages agree where they see the same numbers:
the fault counters, every outcome of the decision stream (its floats come
from shapes and the seeded billing, not from gradients), and same-state
rounds, checksums and corruption bit for bit.  Parameters trained from
each framework's own gradients agree within ``PARAM_ATOL``.
``experiments/bench/BENCH_faults.json`` replays through the port's
``resolve_round`` float for float.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import autotune as jautotune
from repro.core import control_plane as jcp
from repro.core import faults as jfaults
from repro.core import sync as jsync
from repro.core import transport as jtransport
from repro.core import wan as jwan
from repro.launch import train as jtrain
from repro.models.registry import get_model_fns
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import restore as ckpt_restore
from repro_torch.core import control_plane as tcp
from repro_torch.core import faults as tfaults
from repro_torch.core import sync as tsync
from repro_torch.core import transport as ttransport
from repro_torch.core import wan as twan
from repro_torch.core.autotune import AdaptiveSyncController, BucketStats
from repro_torch.core.faults import (ChaosTransport, FaultEvent, FaultPlan,
                                     resolve_round)
from repro_torch.core.sync import (BucketOverride, PodUnreachableError,
                                   SyncConfig, TransferFailed, _encode_bucket,
                                   chunk_checksum_rows, ship_sync_payloads)
from repro_torch.core.transport import MeasuredWanProbe
from repro_torch.core.wan import RetryPolicy, SimEvent, retry_schedule
from repro_torch.launch import train as ttrain
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

# parameters after a few steps from each framework's own f32 gradients:
# the codec's 16-bit key can pick another winner now and then, which moves
# a value by one receiver update (lr 0.05 x a gradient of ~1e-2)
PARAM_ATOL = 2e-3
# tests/test_torch_trainer.py's loss tolerance
LOSS_RTOL = 1e-4

SYNC = dict(compress_topk=0.2, quantize_int8=True, error_feedback=True,
            codec_block=128, overlap_chunks=2, bucket_policy="layer-class")
TSYNC = SyncConfig("asgd_ga", 2, **SYNC,
                   buckets=(BucketOverride("norm", compress_topk=0.5),))
JSYNC = jsync.SyncConfig("asgd_ga", 2, **SYNC,
                         buckets=(jsync.BucketOverride("norm",
                                                       compress_topk=0.5),))
TRACE = ((0.0,), (100.0,))
CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))


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


def _port_sync(jcfg):
    return dataclasses.replace(
        TSYNC, interval=jcfg.interval, bucket_policy=jcfg.bucket_policy,
        buckets=tuple(BucketOverride(o.name, o.compress_topk, o.value_dtype,
                                     o.codec_block) for o in jcfg.buckets))


def _transport(pkg, plan=None, tolerate=True, policy=None):
    """(pkg's SimTransport, optionally wrapped in pkg's ChaosTransport).
    ``pkg`` is ``"port"`` or ``"ref"``."""
    tr_mod, wan, fl = ((ttransport, twan, tfaults) if pkg == "port"
                       else (jtransport, jwan, jfaults))
    inner = tr_mod.SimTransport(
        wan.BandwidthTrace(*TRACE),
        wan.WANConfig(fluctuation=0.0, latency_s=0.0, seed=0),
        probe=tr_mod.MeasuredWanProbe())
    if plan is None:
        return inner
    if pkg == "ref":
        plan = jfaults.FaultPlan(
            tuple(jfaults.FaultEvent(**dataclasses.asdict(ev))
                  for ev in plan.events), seed=plan.seed)
        if policy is not None:
            policy = jwan.RetryPolicy(**dataclasses.asdict(policy))
    return fl.ChaosTransport(inner, plan, policy=policy, tolerate=tolerate)


def _run(transport, n_steps=6, n_pods=2, sync=JSYNC, raises=False):
    """Drive the port's trainer; returns (state, trainer, per-step
    (msg_norm, ef_residual) copies, rollbacks raised as (step, pod))."""
    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=n_pods, optimizer="sgd", lr=0.05,
                               sync=_port_sync(sync)),
                 device="cpu", transport=transport)
    st = tr.init_state(0)
    rng = np.random.default_rng(7)
    snaps, raised = [], []
    for step in range(n_steps):
        x = rng.normal(size=(n_pods, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        try:
            st = tr.maybe_sync(st, step, model_mb=0.001)
        except PodUnreachableError as e:
            if not raises:
                raise
            raised.append((step, e.pod))
        if transport is not None and hasattr(transport, "tick"):
            transport.tick(0.5)
        snaps.append((st.sync_state.msg_norm.clone(),
                      st.sync_state.ef_residual.clone()))
    return st, tr, snaps, raised


def _jrun(transport, n_steps=6, n_pods=2, sync=JSYNC, raises=False):
    """``_run`` through the reference's trainer (the reference's
    ``tests/test_faults.py::_run``)."""
    tr = JTrainer(_jloss, _jinit,
                  JTrainerConfig(n_pods=n_pods, optimizer="sgd", lr=0.05,
                                 sync=sync),
                  transport=transport)
    st = tr.init_state(jax.random.key(0))
    rng = np.random.default_rng(7)
    raised = []
    for step in range(n_steps):
        x = rng.normal(size=(n_pods, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        try:
            st = tr.maybe_sync(st, step, model_mb=0.001)
        except jsync.PodUnreachableError as e:
            if not raises:
                raise
            raised.append((step, e.pod))
        if transport is not None and hasattr(transport, "tick"):
            transport.tick(0.5)
    return st, tr, None, raised


def _assert_same_stream(a, b, label):
    """Bit-identical params and SyncState telemetry after the same stream,
    at every step (the reference's ``_assert_same_stream``)."""
    st_a, _, snaps_a, _ = a
    st_b, _, snaps_b, _ = b
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


def _assert_matches_reference(port, ref, label):
    """The port's run against the reference's from the same inputs: the
    fault counters and the decision stream exactly, the parameters within
    ``PARAM_ATOL``."""
    (st_t, tr_t, _, raised_t), (st_j, tr_j, _, raised_j) = port, ref
    assert raised_t == raised_j, label
    for a, b in zip(jax.tree.leaves(st_j.params), T.leaves(st_t.params),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL, err_msg=label)
    np.testing.assert_array_equal(st_t.sync_state.tier.numpy(),
                                  np.asarray(st_j.sync_state.tier))
    ct, cj = tr_t.transport, tr_j.transport
    for name in ("retries", "retried_mb", "degraded_rounds",
                 "crash_recoveries", "outcomes"):
        if hasattr(cj, name) or name in vars(cj):
            assert getattr(ct, name) == getattr(cj, name), f"{label}: {name}"
    assert [dataclasses.astuple(r) for r in ct.records] == \
        [dataclasses.astuple(r) for r in cj.records], f"{label}: records"
    assert ct.probe.estimator.bandwidth_mbps == \
        cj.probe.estimator.bandwidth_mbps, f"{label}: probe belief"


def _both(plan=None, tolerate=True, policy=None, **kw):
    """The same scenario through the port and the reference:
    ``(port run, reference run)``."""
    port = _run(_transport("port", plan, tolerate, policy), **kw)
    ref = _jrun(_transport("ref", plan, tolerate, policy), **kw)
    return port, ref


# ------------------------------------------------------- passthrough


def test_empty_plan_is_bit_exact_passthrough():
    """ChaosTransport with no events is the wrapped transport: params,
    telemetry, billed records and probe belief all bit-identical."""
    clean = _run(_transport("port"))
    wrapped, ref = _both(FaultPlan())
    _assert_same_stream(clean, wrapped, "empty plan vs bare")
    wrapped_t, bare_t = wrapped[1].transport, clean[1].transport
    assert [r.seconds for r in bare_t.records] == \
           [r.seconds for r in wrapped_t.records]
    assert bare_t.probe.estimator.bandwidth_mbps == \
           wrapped_t.probe.estimator.bandwidth_mbps
    assert wrapped_t.in_graph        # no ship faults -> the wrapped ship
    assert wrapped_t.retries == 0 and wrapped_t.outcomes == []
    _assert_matches_reference(wrapped, ref, "empty plan")


# ---------------------------------------------------- retry + checksum


def test_retry_then_succeed_bit_equal_and_billed():
    """Failed attempts retry to success: parameters bit-equal to the clean
    run, every retry counted and billed, the probe fed the degraded (not
    clean) round time."""
    plan = FaultPlan((FaultEvent("fail", step=3, pod=1, attempts=2),))
    faulted, ref = _both(plan)
    chaos = faulted[1].transport
    clean = _run(_transport("port"))
    _assert_same_stream(clean, faulted, "retry-then-succeed vs clean")
    assert chaos.retries == 2
    assert chaos.retried_mb > 0.0
    [o] = [o for o in chaos.outcomes if o["step"] == 3]
    assert o["kinds"] == ["fail"] and o["attempts"] == 2
    assert o["extra_s"] == pytest.approx(
        retry_schedule(o["expected_s"], chaos.retry_policy, 2))
    clean_bw = clean[1].transport.probe.estimator.bandwidth_mbps
    assert chaos.probe.estimator.bandwidth_mbps < clean_bw
    _assert_matches_reference(faulted, ref, "retry")


def test_hard_timeout_is_retried_soft_timeout_is_slow():
    policy = RetryPolicy(max_retries=3, timeout_factor=4.0)
    hard = FaultPlan((FaultEvent("timeout", step=3, factor=6.0),))
    soft = FaultPlan((FaultEvent("timeout", step=3, factor=2.0),))
    out_h = resolve_round(hard, policy, 3, 1.0)
    out_s = resolve_round(soft, policy, 3, 1.0)
    assert out_h.attempts == 1 and out_h.extra_s > 0 and out_h.slowdown == 1.0
    assert out_s.attempts == 0 and out_s.extra_s == 0.0 \
        and out_s.slowdown == 2.0
    faulted, ref = _both(hard, policy=policy)
    _assert_same_stream(_run(_transport("port")), faulted,
                        "hard timeout retry")
    assert faulted[1].transport.retries == 1
    _assert_matches_reference(faulted, ref, "hard timeout")


def test_corruption_caught_by_checksums_and_reshipped():
    """A wire bit-flip is caught by the per-chunk checksums and the bucket
    re-ships clean: parameters bit-equal to the clean run."""
    plan = FaultPlan((FaultEvent("corrupt", step=3, pod=1),))
    faulted, ref = _both(plan)
    _assert_same_stream(_run(_transport("port")), faulted, "corrupt caught")
    assert faulted[1].transport.retries == 1
    _assert_matches_reference(faulted, ref, "corrupt")


def test_corruption_undetected_without_tolerance_diverges():
    """The no-tolerance baseline ships unverified: the same bit-flip
    decodes straight into the parameters, on both sides."""
    plan = FaultPlan((FaultEvent("corrupt", step=3, pod=1),))
    port, ref = _both(plan, tolerate=False)
    st, chaos = port[0], port[1].transport
    clean = _run(_transport("port"))[0]
    assert chaos.retries == 0 == ref[1].transport.retries
    damage = max(float(l.abs().max()) if bool(torch.isfinite(l).all())
                 else np.inf for l in T.leaves(st.params))
    clean_scale = max(float(l.abs().max()) for l in T.leaves(clean.params))
    assert damage > 1e4 * clean_scale
    # the same leaves go non-finite in the reference's run
    for a, b in zip(jax.tree.leaves(ref[0].params), T.leaves(st.params)):
        np.testing.assert_array_equal(np.isfinite(np.asarray(a)),
                                      torch.isfinite(b).numpy())
    assert chaos.outcomes == ref[1].transport.outcomes


def test_chunk_checksums_catch_any_row_flip():
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(3, 512)).astype(np.float32))
    cfg = SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                     codec_block=128)
    chunks, _ = _encode_bucket(cfg, flat, want_local=False)
    crc = chunk_checksum_rows(chunks)
    assert len(crc) == 3 and len(set(crc)) == 3
    assert chunk_checksum_rows(chunks) == crc
    bad = (chunks[0]._replace(scales=tfaults._flipped(chunks[0].scales, 1)),
           ) + tuple(chunks[1:])
    bad_crc = chunk_checksum_rows(bad)
    assert bad_crc[1] != crc[1] and bad_crc[0] == crc[0]
    # the reference's flip of the same chunks: the same bytes, the same CRCs
    jchunks, _ = jsync._encode_bucket(
        jsync.SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                         codec_block=128), jnp.asarray(flat.numpy()),
        want_local=False)
    assert jsync.chunk_checksum_rows(jchunks) == crc
    scales = np.asarray(jchunks[0].scales).copy()
    scales.view(np.uint32)[1] ^= np.uint32(0x40000000)
    np.testing.assert_array_equal(bad[0].scales.numpy().view(np.uint32),
                                  scales.view(np.uint32))


def test_ship_retry_exhaustion_raises_pod_unreachable():
    """A transport that keeps failing past the retry budget surfaces
    PodUnreachableError from the ship loop (ChaosTransport itself degrades
    the round before reaching it)."""

    class AlwaysFail:
        in_graph = False
        verify_checksums = False
        retry_policy = RetryPolicy(max_retries=2)

        def __init__(self):
            self.notes = []

        def note_retry(self, bucket, attempt, err):
            self.notes.append((bucket, attempt, err.reason))

        def ship_bucket(self, name, chunks, shift, payload_mb=0.0):
            raise TransferFailed(name, 0, "fail", pod=1)

    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    cfg = SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                     codec_block=128)
    chunks, _ = _encode_bucket(cfg, flat, want_local=False)
    ship = AlwaysFail()
    with pytest.raises(PodUnreachableError) as ei:
        ship_sync_payloads(cfg, {"all": chunks}, ship, {"all": 0.1})
    assert ei.value.pod == 1 and ei.value.bucket == "all"
    assert [a for _, a, _ in ship.notes] == [1, 2]   # budget exhausted


# ------------------------------------------------------ degraded rounds


def test_degraded_round_masks_membership_and_preserves_ef():
    """3 pods, pod 2 dead: the round completes over the survivors; the one
    delivered message applies bit-identically to the clean run, the
    undelivered senders keep their whole message in the EF residual, and
    the dead rows' telemetry zeroes out."""
    sync = dataclasses.replace(JSYNC, bucket_policy="single", buckets=())
    plan = FaultPlan((FaultEvent("crash", step=1, pod=2),))
    port, ref = _both(plan, n_steps=2, n_pods=3, sync=sync)
    st_f, chaos = port[0], port[1].transport
    st_c = _run(_transport("port"), n_steps=2, n_pods=3, sync=sync)[0]
    assert chaos.degraded_rounds == 1
    for lf, lc in zip(T.leaves(st_f.params), T.leaves(st_c.params)):
        assert torch.equal(lf[1], lc[1])
    msg = st_f.sync_state.msg_norm
    assert float(msg[0].sum()) > 0.0
    assert float(msg[1].sum()) == 0.0 and float(msg[2].sum()) == 0.0
    resid_f, resid_c = st_f.sync_state.ef_residual, st_c.sync_state.ef_residual
    assert torch.equal(resid_f[0], resid_c[0])
    for p in (1, 2):
        assert float(resid_f[p].norm()) > float(resid_c[p].norm())
    _assert_matches_reference(port, ref, "degraded")
    jmsg = np.asarray(ref[0].sync_state.msg_norm)
    np.testing.assert_array_equal(jmsg == 0.0, msg.numpy() == 0.0)


def test_degraded_round_never_trips_ef_guard():
    """2 pods, peer dead: no message delivered anywhere, telemetry all
    zero, BucketStats reads 'no reading yet', and the controller does not
    de-escalate on it."""
    plan = FaultPlan((FaultEvent("crash", step=1, pod=1),))
    port, ref = _both(plan, n_steps=2)
    st, tr = port[0], port[1]
    assert tr.transport.degraded_rounds == 1
    stats = BucketStats.from_sync_state(st.sync_state)
    assert stats.msg_norm == 0.0 and stats.resid_norm == 0.0
    jstats = jautotune.BucketStats.from_sync_state(ref[0].sync_state)
    assert dataclasses.astuple(stats) == dataclasses.astuple(jstats)
    tuner = AdaptiveSyncController(tr.cfg.sync, 44.6, 0.3, ef_guard=0.9)
    tuner.observe_wan(100.0)
    rung0 = tuner.rung
    upd = tuner.update(2, stats)
    assert upd is None and tuner.rung == rung0
    _assert_matches_reference(port, ref, "degraded, 2 pods")


def test_crash_rollback_raises_once_then_degrades():
    plan = FaultPlan((FaultEvent("crash", step=1, pod=1, mode="rollback"),))
    port, ref = _both(plan, n_steps=6, raises=True)
    chaos, jchaos = port[1].transport, ref[1].transport
    assert port[3] == [(1, 1)]           # one rollback, at the first round
    assert chaos.degraded_rounds == 2    # steps 3 and 5 complete degraded
    assert chaos.take_new_crashes() == (1,) == jchaos.take_new_crashes()
    assert chaos.take_new_crashes() == ()    # reported exactly once
    chaos.clear_crash(1)
    assert chaos.crash_recoveries == 1
    chaos.begin_round(7)
    assert chaos.round_failed_pods == ()     # removed pod stops degrading
    assert chaos.outcomes == jchaos.outcomes
    assert chaos.degraded_rounds == jchaos.degraded_rounds


def test_crash_with_async_snapshot_in_flight_recovers_from_durable(
        tmp_path):
    """Rollback-mode crash while the async engine still has snapshots in
    flight: recovery comes from ``last_durable()`` (the queue drains
    first), the restored state is bit-equal to the barrier capture it
    committed, no torn or staged snapshot is ever visible, and the
    post-rollback degraded rounds keep their invariants (dead row's
    telemetry zeroed)."""
    import threading

    from repro_torch.checkpoint.async_engine import (AsyncCheckpointEngine,
                                                     list_steps, step_dir)
    from repro_torch.core.sync import is_sync_step

    sync = dataclasses.replace(TSYNC, bucket_policy="single", buckets=())
    plan = FaultPlan((FaultEvent("crash", step=3, pod=2,
                                 mode="rollback"),))
    chaos = _transport("port", plan)
    tr = Trainer(_loss, _init,
                 TrainerConfig(n_pods=3, optimizer="sgd", lr=0.05,
                               sync=sync),
                 device="cpu", transport=chaos)
    st = tr.init_state(0)
    root = str(tmp_path)

    def capture(state):
        return T.tree_map(lambda x: x.clone()
                          if isinstance(x, torch.Tensor) else x, state)

    def same(a, b):
        for x, y in zip(T.leaves(a), T.leaves(b), strict=True):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)

    eng = AsyncCheckpointEngine(root, keep=2)
    gate = threading.Event()
    orig = eng._commit_snapshot

    def gated(*item):
        assert gate.wait(timeout=30)
        orig(*item)

    eng._commit_snapshot = gated
    eng.snapshot(st, 0)
    captures = {0: capture(st)}
    rng = np.random.default_rng(7)
    rollbacks = 0
    for step in range(6):
        x = rng.normal(size=(3, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        try:
            st = tr.maybe_sync(st, step, model_mb=0.001)
        except PodUnreachableError:
            # the crash caught the engine mid-commit: release it and
            # recover from the last DURABLE snapshot, not the queue
            assert eng.last_durable() is None
            gate.set()
            st, snap_step = eng.restore_last(like=st)
            rollbacks += 1
            same(captures[snap_step], st)
        else:
            if is_sync_step(sync, step):
                eng.snapshot(st, step + 1)
                captures[step + 1] = capture(st)
    assert rollbacks == 1
    gate.set()
    eng.wait()
    # no torn state: nothing staged left behind, and every committed
    # snapshot restores cleanly bit-equal to its barrier capture
    assert not any(n.endswith(".tmp") or n.startswith(".ckpt-stage-")
                   for n in os.listdir(root))
    steps = list_steps(root)
    assert steps == sorted(steps) and len(steps) <= 2
    for s in steps:
        out, got = ckpt_restore(step_dir(root, s), st)
        assert got == s
        same(captures[s], out)
    # degraded rounds after the rollback keep the mask invariants: the
    # dead pod's telemetry row is zero, the survivors' state sane
    assert chaos.degraded_rounds >= 1
    assert float(st.sync_state.msg_norm[2].sum()) == 0.0
    assert bool(torch.isfinite(st.params["w"]).all())
    eng.close()


# -------------------------------------------------- chaos property test


def test_seeded_chaos_plan_always_recovers():
    """Property (seed from CHAOS_SEED): any plan of retryable faults within
    the retry budget recovers to parameters and telemetry bit-identical to
    the clean run, with every injection counted; the decision stream is
    the reference's and replays through ``resolve_round`` after a JSON
    round trip."""
    rng = np.random.default_rng(CHAOS_SEED)
    policy = RetryPolicy(max_retries=3)
    steps = rng.choice([1, 3, 5, 7, 9], size=3, replace=False)
    events, expected_retries = [], 0
    for s in steps:
        kind = rng.choice(["fail", "timeout", "corrupt"])
        if kind == "fail":
            n = int(rng.integers(1, policy.max_retries + 1))
            events.append(FaultEvent("fail", step=int(s), pod=1,
                                     attempts=n))
            expected_retries += n
        elif kind == "timeout":
            events.append(FaultEvent("timeout", step=int(s), pod=1,
                                     factor=float(policy.timeout_factor
                                                  + rng.integers(0, 4))))
            expected_retries += 1
        else:
            events.append(FaultEvent("corrupt", step=int(s),
                                     pod=int(rng.integers(0, 2))))
            expected_retries += 1
    plan = FaultPlan(tuple(events), seed=CHAOS_SEED)
    faulted, ref = _both(plan, policy=policy, n_steps=10)
    chaos = faulted[1].transport
    _assert_same_stream(_run(_transport("port"), n_steps=10), faulted,
                        f"chaos seed {CHAOS_SEED}")
    assert chaos.retries == expected_retries
    for o in json.loads(json.dumps(chaos.outcomes)):
        out = resolve_round(plan, policy, o["step"], o["expected_s"])
        assert [list(out.kinds), out.attempts, out.extra_s, out.slowdown] \
            == [o["kinds"], o["attempts"], o["extra_s"], o["slowdown"]]
    _assert_matches_reference(faulted, ref, f"chaos seed {CHAOS_SEED}")


# ------------------------------------------------------- event delivery


@pytest.mark.parametrize("cp", [tcp, jcp], ids=["port", "reference"])
def test_event_bus_isolates_subscriber_errors(cp):
    bus = cp.EventBus()
    seen = []
    bus.subscribe("pod_crashed", lambda e: seen.append(("a", e.region)))

    def boom(e):
        raise KeyError(f"unknown region {e.region!r}")

    bus.subscribe("pod_crashed", boom)
    bus.subscribe("pod_crashed", lambda e: seen.append(("c", e.region)))
    with pytest.raises(KeyError, match="pod9"):
        bus.publish(cp.CloudEvent("pod_crashed", region="pod9"))
    assert seen == [("a", "pod9"), ("c", "pod9")]


@pytest.mark.parametrize("cp", [tcp, jcp], ids=["port", "reference"])
def test_event_bus_collects_multiple_errors(cp):
    bus = cp.EventBus()
    seen = []

    def boom1(e):
        raise KeyError("first")

    def boom2(e):
        raise ValueError("second")

    bus.subscribe("pod_crashed", boom1)
    bus.subscribe("pod_crashed", lambda e: seen.append(e.kind))
    bus.subscribe("pod_crashed", boom2)
    with pytest.raises(cp.EventDeliveryError) as ei:
        bus.publish(cp.CloudEvent("pod_crashed", region="pod1"))
    assert seen == ["pod_crashed"]
    assert [type(e) for _, e in ei.value.errors] == [KeyError, ValueError]
    assert ei.value.event.region == "pod1"


# ------------------------------------------------------- probe guard


def test_observe_transfer_ignores_degenerate_observations():
    probe = MeasuredWanProbe(alpha=0.5, cliff_snap=4.0)
    jprobe = jtransport.MeasuredWanProbe(alpha=0.5, cliff_snap=4.0)
    for p in (probe, jprobe):
        p.observe_transfer(1.0, 0.1)             # 80 Mbps belief
        before = p.estimator.bandwidth_mbps
        p.observe_transfer(0.0, 1.0)             # zero-byte round
        p.observe_transfer(1.0, 0.0)             # zero-time round
        p.observe_transfer(-1.0, 1.0)
        assert p.estimator.bandwidth_mbps == before
        assert p.n_observations == 1
    assert probe.estimator.bandwidth_mbps == jprobe.estimator.bandwidth_mbps


# ---------------------------------------------------------- DES billing


def _des(wan_mod, sync_mod, events):
    clouds = [wan_mod.SimCloud("sh", iter_time_s=0.1, units=4),
              wan_mod.SimCloud("cq", iter_time_s=0.1, units=4)]
    return wan_mod.simulate(clouds, sync_mod.SyncConfig("asgd_ga", 4),
                            n_iters=60, model_mb=0.6,
                            wan=wan_mod.WANConfig(seed=1), events=events)


def _timelines(res):
    return [dataclasses.astuple(c) for c in res.clouds]


def test_simulate_link_failed_bills_retries_and_traffic():
    ev = dict(duration_s=2.0, n_failures=2)
    base = _des(twan, tsync, [])
    failed = _des(twan, tsync, [SimEvent(1.0, "link_failed", **ev)])
    for b, f in zip(base.clouds, failed.clouds):
        assert f.total_s > b.total_s           # retry/backoff wall-clock
        assert f.traffic_mb > b.traffic_mb     # retried bytes at full cost
    jfailed = _des(jwan, jsync, [jwan.SimEvent(1.0, "link_failed", **ev)])
    assert _timelines(failed) == _timelines(jfailed)


def test_simulate_pod_crashed_departs_and_stalls_survivors():
    ev = dict(region="cq", pause_s=3.0)
    r = _des(twan, tsync, [SimEvent(1.0, "pod_crashed", **ev)])
    by = {c.region: c for c in r.clouds}
    assert by["sh"].reconfig_s >= 3.0          # barrier rollback stall
    assert by["cq"].total_s < by["sh"].total_s  # cq died early
    with pytest.raises(ValueError, match="unknown sim event kind"):
        SimEvent(0.0, "pod_exploded")
    jr = _des(jwan, jsync, [jwan.SimEvent(1.0, "pod_crashed", **ev)])
    assert _timelines(r) == _timelines(jr)


# ----------------------------------------------------- validation + CLI


def test_fault_event_and_retry_policy_validation():
    with pytest.raises(ValueError, match="kind 'melt'"):
        FaultEvent("melt", step=0)
    with pytest.raises(ValueError, match="step must be >= 0"):
        FaultEvent("fail", step=-1)
    with pytest.raises(ValueError, match="attempts must be >= 1"):
        FaultEvent("fail", step=0, attempts=0)
    with pytest.raises(ValueError, match="duration must be >= 1"):
        FaultEvent("flap", step=0, duration=0)
    with pytest.raises(ValueError, match="mode 'panic'"):
        FaultEvent("crash", step=0, mode="panic")
    with pytest.raises(ValueError, match="max_retries"):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="timeout_factor"):
        RetryPolicy(timeout_factor=0.5)
    with pytest.raises(ValueError, match="backoff_base"):
        RetryPolicy(backoff_base=0.0)
    assert retry_schedule(1.0, RetryPolicy(), 0) == 0.0
    assert retry_schedule(1.0, RetryPolicy(), 2) == pytest.approx(9.5)
    assert (tfaults.FAULT_KINDS, tfaults.CRASH_MODES,
            tfaults.NO_TOLERANCE_HANG) == (jfaults.FAULT_KINDS,
                                           jfaults.CRASH_MODES,
                                           jfaults.NO_TOLERANCE_HANG)


GOOD_SPECS = ["", "fail:x2@39,timeout:x6@67,corrupt@95,flap:x8@119+6,"
              "crash:pod1@183:rollback,seed=3", "flap:x4@10+2",
              "fail@1,crash:pod0@2", " corrupt@3 ,,seed=0"]
BAD_SPECS = ["corrupt", "melt@3", "corrupt@soon", "timeout:xfast@3",
             "flap@3+2", "fail@3+2", "corrupt@3:rollback", "crash:1@3",
             "corrupt:x2@3", "seed=pi", "fail:2@3", "fail:xmany@3",
             "crash:podX@3", "flap:x2@3+long", "crash:pod1@3:panic",
             "timeout:x0@3"]


def test_parse_faults_grammar_and_errors():
    parse_faults = ttrain.parse_faults
    assert parse_faults("") is None
    plan = parse_faults("fail:x2@39,timeout:x6@67,corrupt@95,"
                        "flap:x8@119+6,crash:pod1@183:rollback,seed=3")
    assert plan.seed == 3 and len(plan.events) == 5
    assert plan.events[0] == FaultEvent("fail", step=39, attempts=2)
    assert plan.events[1].factor == 6.0
    assert plan.events[3].duration == 6
    assert plan.events[4] == FaultEvent("crash", step=183, pod=1,
                                        mode="rollback")
    assert plan.needs_host_seam and plan.has_crashes
    assert not parse_faults("flap:x4@10+2").needs_host_seam
    for spec, msg in [("corrupt", "missing '@step'"),
                      ("melt@3", "unknown kind 'melt'"),
                      ("corrupt@soon", "step must be an integer"),
                      ("timeout:xfast@3", "factor must be a number"),
                      ("flap@3+2", "needs a slowdown factor"),
                      ("fail@3+2", "'\\+duration' only applies"),
                      ("corrupt@3:rollback", "recovery mode only applies"),
                      ("crash:1@3", "needs the dying pod"),
                      ("corrupt:x2@3", "corrupt takes no argument"),
                      ("seed=pi", "seed must be an integer")]:
        with pytest.raises(ValueError, match=msg):
            parse_faults(spec)


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS)
def test_parse_faults_equals_the_reference(spec):
    """The same spec gives the same plan, or the same error message."""
    def outcome(parse):
        try:
            plan = parse(spec)
        except ValueError as e:
            return ("error", str(e))
        if plan is None:
            return None
        return (plan.seed, [dataclasses.astuple(ev) for ev in plan.events])

    assert outcome(ttrain.parse_faults) == outcome(jtrain.parse_faults)


@pytest.mark.parametrize("argv,msg", [
    (["--faults", "corrupt@3"], "needs a billing transport"),
    (["--faults", "corrupt@3", "--transport", "sim", "--wan-trace", "100@0"],
     "host-seam codec"),
    (["--faults", "crash:pod5@3", "--transport", "sim", "--wan-trace",
      "100@0", "--compress-topk", "0.1", "--int8"], "out of range"),
    (["--no-tolerance"], "needs --faults")])
def test_launcher_rejects_inconsistent_fault_flags(argv, msg):
    base = ["--preset", "tiny", "--pods", "2", "--steps", "1"]
    with pytest.raises(SystemExit, match=msg) as ei:
        ttrain.main(base + argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as ej:
        jtrain.main(base + argv)
    assert str(ei.value) == str(ej.value)


# --------------------------------------------- BENCH_faults.json replay


BENCH = os.path.join(os.path.dirname(__file__), "..", "experiments", "bench",
                     "BENCH_faults.json")


def _bench():
    with open(BENCH) as f:
        return json.load(f)


@pytest.mark.parametrize("variant", ["tolerant", "tolerant_adaptive",
                                     "no_tolerance"])
def test_bench_faults_replays_through_the_port(variant):
    """Every recorded faulted round of each variant replays through the
    port's ``resolve_round``, floats included, after the JSON round trip
    (``benchmarks/check_regression.py::check_faults_replay``)."""
    base = _bench()
    scen = base["scenario"]
    plan = FaultPlan(events=tuple(FaultEvent(**e)
                                  for e in scen["fault_events"]),
                     seed=scen["seed"])
    policy = RetryPolicy(**scen["retry_policy"])
    run = base["variants"][variant]
    assert run["outcomes"]
    for o in run["outcomes"]:
        out = resolve_round(plan, policy, o["step"], o["expected_s"])
        assert [o["step"], list(out.kinds), out.attempts, out.extra_s,
                out.slowdown, list(out.crashed)] == \
            [o["step"], o["kinds"], o["attempts"], o["extra_s"],
             o["slowdown"], o["crashed"]]


# ---------------------------------------- same state, both packages


N_PODS = 3
SHAPES = {"attn": {"wq": (48, 40), "wo": (40, 48)},
          "ln1": {"scale": (48,)},
          "embed": {"tokens": (96, 48)}}
JSAME = jsync.SyncConfig(
    "asgd_ga", 2, compress_topk=0.05, quantize_int8=True,
    error_feedback=True, codec_block=256, overlap_chunks=2,
    bucket_policy="layer-class",
    buckets=(jsync.BucketOverride("norm", compress_topk=0.5),
             jsync.BucketOverride("embed", value_dtype="int4")))


def _same_state():
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda shape: jnp.asarray(rng.normal(size=(N_PODS,) + shape)
                                  .astype(np.float32)),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    st = jsync.init_sync_state(JSAME, params)
    rng = np.random.default_rng(2)
    buf = jax.tree.map(lambda b: jnp.asarray(
        rng.normal(size=b.shape).astype(np.float32)), st.ga_buffer)
    ef = jnp.asarray(0.1 * rng.normal(size=st.ef_residual.shape)
                     .astype(np.float32))
    return params, st._replace(ga_buffer=buf, ef_residual=ef,
                               steps_since_sync=jnp.int32(3))


def _eq_nan(a, b):
    """Bit for bit, NaN and inf compared as equal in place."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.where(np.isnan(a), 0, a),
                                  np.where(np.isnan(b), 0, b))


@pytest.mark.parametrize("spec,tolerate", [
    ("corrupt@3", True), ("corrupt@3", False), ("fail:x2@3", True),
    ("timeout:x6@3,corrupt@3", True), ("crash:pod2@3", True),
    ("crash:pod1@3", False), ("flap:x8@3+2", True)])
def test_same_state_faulted_round_equals_the_reference(spec, tolerate):
    """The same converted state through one faulted round over each
    package's chaos-wrapped ``SimTransport``: shipped chunks (a corrupted
    one included), new params, EF residual and tier bit for bit (NaN in
    place for the no-tolerance decode of an inf scale), the retries, the
    degraded membership and the round's billed outcome exactly."""
    jcfg = JSAME
    tcfg = _port_sync(jcfg)
    tcfg = dataclasses.replace(tcfg, compress_topk=jcfg.compress_topk,
                               codec_block=jcfg.codec_block)
    params, state = _same_state()
    tparams = T.tree_map(lambda a: convert.to_tensor(a, "cpu"),
                         jax.tree.map(np.asarray, params))
    tstate = convert.sync_state_from_jax(jax.tree.map(np.asarray, state),
                                         "cpu")
    tplan = ttrain.parse_faults(spec)
    tt = _transport("port", tplan, tolerate)
    jt = _transport("ref", tplan, tolerate)
    lr = 0.05
    for t in (tt, jt):
        t.begin_round(3)

    jpay = jax.jit(functools.partial(jsync.prepare_codec_sync, jcfg))(state)
    jwire = jsync.bucket_wire_mb(jcfg, jsync.bucket_layout(jcfg,
                                                           state.ga_buffer))
    jship = jsync.ship_sync_payloads(jcfg, jpay.chunks, jt, jwire)
    alive = None
    if jt.round_failed_pods:
        alive = np.ones(N_PODS, np.float32)
        alive[list(jt.round_failed_pods)] = 0.0
    jp, js = jsync.finish_codec_sync(
        jcfg, params, state, jpay, jship, lr,
        None if alive is None else jnp.asarray(alive))

    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    twire = tsync.bucket_wire_mb(tcfg, tsync.bucket_layout(
        tcfg, tstate.ga_buffer))
    # at the host seam both ship the buckets in name order (the trainer
    # sorts them as the reference's jitted prepare returns them)
    tship = tsync.ship_sync_payloads(tcfg, dict(sorted(tpay.chunks.items())),
                                     tt, twire)
    assert list(tship) == list(jship)
    assert tt.round_failed_pods == jt.round_failed_pods
    tp, ts = tsync.finish_codec_sync(
        tcfg, tparams, tstate, tpay, tship, lr,
        None if alive is None else torch.from_numpy(alive))
    for name in jship:
        for jc, tc in zip(jship[name], tship[name], strict=True):
            for a, b in zip(jc, tc):
                a = np.asarray(a)
                b = b.numpy()
                if a.dtype.itemsize == 1:
                    a, b = a.view(np.uint8), b.view(np.uint8)
                np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp), strict=True):
        _eq_nan(a, b)
    _eq_nan(js.ef_residual, ts.ef_residual)
    np.testing.assert_array_equal(np.asarray(js.tier), ts.tier.numpy())
    assert tt.retries == jt.retries
    assert tt.retried_mb == jt.retried_mb
    assert tt.on_sync(twire, step=3) == jt.on_sync(jwire, step=3)
    assert tt.outcomes == jt.outcomes
    assert tt.degraded_rounds == jt.degraded_rounds
    if spec == "corrupt@3" and not tolerate:
        assert not all(bool(torch.isfinite(x).all()) for x in T.leaves(tp))


def test_corrupt_flips_a_copy_on_a_transport_that_ships_views():
    """The inline ring at one pod (and a mesh roll) may hand back the
    sender's own tensors: the flip lands on a copy, so a retry re-ships
    the intact bytes and the round ends bit-equal to the clean one."""

    class Views(tsync.InlineRingShip):
        def ship_bucket(self, name, chunks, shift, payload_mb=0.0):
            return tuple(chunks)          # the sender's tensors, no copy

    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.normal(size=(2, 1000)).astype(np.float32))
    cfg = SyncConfig("asgd_ga", 1, compress_topk=0.1, quantize_int8=True,
                     codec_block=128, overlap_chunks=2)
    chunks, _ = _encode_bucket(cfg, flat, want_local=False)
    before = [c.scales.clone() for c in chunks]
    chaos = ChaosTransport(Views(), FaultPlan((FaultEvent("corrupt", step=0,
                                                          pod=1),)))
    chaos.begin_round(0)
    first = chaos.ship_bucket("all", chunks, 0, 1.0)
    assert not torch.equal(first[0].scales, before[0])
    assert all(torch.equal(c.scales, b) for c, b in zip(chunks, before))
    assert chaos.ship_bucket("all", chunks, 0, 1.0)[0] is chunks[0]


# --------------------------------------------------- the launchers


LAUNCH = ["--preset", "tiny", "--pods", "2", "--steps", "8", "--batch", "4",
          "--seq", "16", "--interval", "2", "--compress-topk", "0.05",
          "--int8", "--error-feedback", "--wan-trace", "100@0,40@5",
          "--transport", "sim:fluct=0.2,latency=0.02,seed=1",
          "--log-every", "0"]
FAULT_FIELDS = ("faults", "fault_tolerant", "retries", "retried_mb",
                "degraded_rounds", "crash_recoveries", "rollbacks",
                "final_pods", "reconfigs", "transfers", "wan_traffic_mb")


@pytest.mark.parametrize("faults", [
    ["--faults", "fail:x1@1,corrupt@3,crash:pod1@5"],
    ["--faults", "fail:x1@1,crash:pod1@3:rollback"],
    ["--faults", "corrupt@3,timeout:x6@5", "--no-tolerance"]],
    ids=["degrade", "rollback", "no-tolerance"])
def test_launcher_faults_equal_the_reference(faults, tmp_path):
    """The same argv through both launchers from the same parameters: the
    fault summary fields, the pod count and the billing are equal, the
    ``[faults]`` and ``[elasticity]`` lines too, the losses within
    ``LOSS_RTOL`` (finite ones)."""
    jargv = LAUNCH + faults + ["--ckpt-dir", str(tmp_path / "ref")]
    targv = LAUNCH + faults + ["--ckpt-dir", str(tmp_path / "port")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(jargv)
    jlines = [line for line in buf.getvalue().splitlines()
              if line.startswith(("[faults]", "[elasticity]"))]
    jparams = get_model_fns("transformer").init_params(
        jax.random.key(0), jtrain.preset_tiny())
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      ttrain.preset_tiny(), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(targv + ["--device", "cpu"], init_params=tparams)
    tlines = [line for line in buf.getvalue().splitlines()
              if line.startswith(("[faults]", "[elasticity]"))]
    assert tlines == jlines
    for k in FAULT_FIELDS:
        assert ts[k] == js[k], k
    if "--no-tolerance" not in faults:
        assert ts["final_pods"] == 1 and ts["crash_recoveries"] == 1
        assert ts["loss_last"] == pytest.approx(js["loss_last"],
                                                rel=LOSS_RTOL)
    # the same checkpoint directories, with the same manifests
    def listing(d):
        return sorted(os.listdir(d)) if d.exists() else None

    assert listing(tmp_path / "port") == listing(tmp_path / "ref")
    for sub in listing(tmp_path / "port") or ():
        mt = jckpt.load_manifest(str(tmp_path / "port" / sub))
        mj = jckpt.load_manifest(str(tmp_path / "ref" / sub))
        for k in ("step", "keys", "dtypes", "shapes", "metadata"):
            assert mt[k] == mj[k], (sub, k)
    assert ts["rollbacks"] == js["rollbacks"] == (
        1 if "rollback" in faults[1] else 0)
