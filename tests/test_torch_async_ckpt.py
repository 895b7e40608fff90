"""Port parity: the async snapshot engine and live pod migration
(``repro_torch.checkpoint.async_engine``, ``repro_torch.training.trainer.
LiveMigrator``) against ``repro.checkpoint.async_engine`` and
``repro.training.trainer.LiveMigrator``.

The first part mirrors ``tests/test_async_ckpt.py`` case for case, port
against port: commit and retention, the durability window, the failure
surface, and the acceptance bar, a live migration step-for-step
loss-identical to a pause-and-restore reconfiguration on the same event
trace.  ``test_property.py::test_async_snapshot_equals_blocking_save``
follows with the port's stronger contract: a snapshot's ``arrays.npz`` is
the blocking save's byte for byte, so the manifests' size and CRC32 are
equal too.  The port's own cases close it: the capture is a copy (the
port's trainer writes its state in place), snapshots restore across the
two packages with equal CRCs (the reference's clock held at the zip epoch,
at which the port dates every member), the capture refuses to fall back,
the buffer pool stays within ``max_inflight + 1`` sets, and the migration
arm's losses equal the reference's ``_run_trace`` from the same initial
parameters.
"""
import importlib.util
import os
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import async_engine as jengine
from repro.checkpoint import checkpoint as jckpt
from repro_torch import tree as T
from repro_torch.checkpoint import async_engine as engine_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.async_engine import (AsyncCheckpointEngine,
                                                 SnapshotError,
                                                 blocking_equivalent,
                                                 list_steps, step_dir)
from repro_torch.core.control_plane import (CloudEvent, ElasticityController,
                                            TrainingRequest,
                                            build_training_plan)
from repro_torch.core.scheduler import CloudResources
from repro_torch.core.sync import SyncConfig, is_sync_step
from repro_torch.training.trainer import (LiveMigrator, Trainer,
                                          TrainerConfig, _resized_like,
                                          apply_reconfig)

torch.set_num_threads(2)

CLOUDS = (CloudResources("sh", (("cascade", 6),), data_size=2.0),
          CloudResources("cq", (("sky", 6),), data_size=1.0),
          CloudResources("bj", (("sky", 3),), data_size=1.0))
# losses of one trace from each framework's own f32 gradients: torch's and
# XLA's products differ in their last bits (2.4e-7 relative at most over
# the 16 steps, on the CPU)
LOSS_RTOL = 1e-5
# the date zipfile reads when the reference's np.savez names a member
EPOCH = time.struct_time((1980, 1, 1, 0, 0, 0, 1, 1, 0))


def _ref_tests():
    """``tests/test_async_ckpt.py`` as a module (its ``_run_trace``)."""
    path = os.path.join(os.path.dirname(__file__), "test_async_ckpt.py")
    spec = importlib.util.spec_from_file_location("_ref_async_ckpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(n_pods, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(n_pods, 6, 3))
                              .astype(np.float32)),
        "opt": {"m": torch.from_numpy(rng.normal(size=(n_pods, 6, 3))
                                      .astype(np.float32))},
        "bias": torch.from_numpy(rng.normal(size=(n_pods, 3))
                                 .astype(np.float32)),
    }


def _zeros(tree):
    return T.tree_map(lambda x: torch.zeros_like(x)
                      if isinstance(x, torch.Tensor) else 0, tree)


def _assert_trees_equal(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert x == y


# ------------------------------------------------------ commit & retention


def test_engine_commits_and_prunes_to_keep(tmp_path):
    eng = AsyncCheckpointEngine(str(tmp_path), keep=2)
    for s in range(5):
        eng.snapshot(_tree(2, seed=s), s)
    eng.wait()
    assert eng.committed == 5
    assert list_steps(str(tmp_path)) == [3, 4]
    step, path = eng.last_durable()
    assert step == 4 and path == step_dir(str(tmp_path), 4)
    eng.close()


def test_engine_rejects_keepless_retention(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        AsyncCheckpointEngine(str(tmp_path), keep=0)


def test_engine_reseeds_durable_steps_from_disk(tmp_path):
    eng = AsyncCheckpointEngine(str(tmp_path), keep=3)
    eng.snapshot(_tree(2), 7)
    eng.close()
    eng2 = AsyncCheckpointEngine(str(tmp_path), keep=3)
    assert eng2.last_durable()[0] == 7
    eng2.close()


def test_async_snapshot_matches_blocking_save(tmp_path):
    """The engine's commit is the checkpoint layer's writer: restored trees
    and manifests match a blocking ``save`` of the same tree at the same
    step, and (the port dates members at the zip epoch) so do the file's
    bytes, size and CRC32."""
    tree = _tree(3, seed=11)
    eng = AsyncCheckpointEngine(str(tmp_path / "async"), keep=1)
    eng.snapshot(tree, 42, metadata={"pods": 3})
    eng.wait()
    _, apath = eng.last_durable()
    bpath = blocking_equivalent(tree, 42, str(tmp_path / "block"),
                                metadata={"pods": 3})
    like = _zeros(tree)
    a, astep = ckpt.restore(apath, like)
    b, bstep = ckpt.restore(bpath, like)
    assert astep == bstep == 42
    _assert_trees_equal(a, b)
    ma, mb = ckpt.load_manifest(apath), ckpt.load_manifest(bpath)
    for k in ("keys", "dtypes", "shapes", "step", "metadata",
              "arrays_bytes", "arrays_crc32"):
        assert ma[k] == mb[k], k
    with open(os.path.join(apath, "arrays.npz"), "rb") as fa, \
            open(os.path.join(bpath, "arrays.npz"), "rb") as fb:
        assert fa.read() == fb.read()
    eng.close()


def test_donated_buffers_are_reused_across_snapshots(tmp_path):
    eng = AsyncCheckpointEngine(str(tmp_path), keep=1)
    eng.snapshot(_tree(2, seed=0), 0)
    eng.wait()
    sets0 = list(eng._host_bufs)
    views0 = [list(s.views) for s in sets0]
    eng.snapshot(_tree(2, seed=1), 1)
    eng.wait()
    assert len(eng._host_bufs) == len(sets0) == 1
    assert eng._host_bufs[0] is sets0[0]
    assert all(a is b for a, b in zip(eng._host_bufs[0].views, views0[0]))
    out, _ = ckpt.restore(eng.last_durable()[1], _zeros(_tree(2)))
    _assert_trees_equal(out, _tree(2, seed=1))
    eng.close()


# --------------------------------------------------- durability under race


def _gated_engine(root, keep=2, max_inflight=2):
    """Engine whose commit blocks on an event: lets a test observe the
    window between enqueue and the atomic rename."""
    eng = AsyncCheckpointEngine(root, keep=keep, max_inflight=max_inflight)
    gate = threading.Event()
    orig = eng._commit_snapshot

    def gated(*item):
        assert gate.wait(timeout=30)
        orig(*item)

    eng._commit_snapshot = gated
    return eng, gate


def test_last_durable_advances_only_after_commit(tmp_path):
    eng, gate = _gated_engine(str(tmp_path))
    eng.snapshot(_tree(2), 5)
    # in flight: not durable, and no partial step dir is visible on disk
    assert eng.last_durable() is None
    assert list_steps(str(tmp_path)) == []
    gate.set()
    eng.wait()
    assert eng.last_durable()[0] == 5
    assert list_steps(str(tmp_path)) == [5]
    eng.close()


def test_restore_last_drains_inflight_snapshots(tmp_path):
    eng, gate = _gated_engine(str(tmp_path))
    tree = _tree(2, seed=9)
    eng.snapshot(tree, 3)
    gate.set()
    out, step = eng.restore_last(like=_zeros(tree))
    assert step == 3
    _assert_trees_equal(out, tree)
    eng.close()


def test_wait_surfaces_background_failure_as_snapshot_error(tmp_path):
    eng = AsyncCheckpointEngine(str(tmp_path), keep=1)

    def boom(*item):
        raise OSError("disk detached")

    eng._commit_snapshot = boom
    eng.snapshot(_tree(2), 1)
    with pytest.raises(SnapshotError, match="disk detached"):
        eng.wait()
    eng.close()


def test_restore_last_falls_back_past_corrupted_newest(tmp_path):
    """An externally damaged newest snapshot (truncated arrays.npz) is
    skipped and the previous durable snapshot restores instead."""
    eng = AsyncCheckpointEngine(str(tmp_path), keep=3)
    older = _tree(2, seed=1)
    eng.snapshot(older, 1)
    eng.snapshot(_tree(2, seed=2), 2)
    eng.wait()
    apath = os.path.join(step_dir(str(tmp_path), 2), "arrays.npz")
    with open(apath, "rb") as f:
        blob = f.read()
    with open(apath, "wb") as f:
        f.write(blob[: len(blob) // 2])
    out, step = eng.restore_last(like=_zeros(older))
    assert step == 1
    _assert_trees_equal(out, older)
    eng.close()


def test_restore_last_with_nothing_durable_raises(tmp_path):
    eng = AsyncCheckpointEngine(str(tmp_path), keep=1)
    with pytest.raises(FileNotFoundError):
        eng.restore_last(like=_tree(2))
    eng.close()


# ------------------------------------- the checkpoint-equivalence contract


def _loss(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _batch(n_pods, seed=0):
    """The reference test's batch: the same numpy draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_pods, 8, 4)).astype(np.float32)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    y = x @ w + 0.01 * rng.normal(size=(n_pods, 8, 1)).astype(np.float32)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _init_params(seed=0, n_pods=3):
    """What the reference's ``init_state(key(seed), same_init=False)``
    stacks: its ``_init`` over split keys, one model a pod, as numpy."""
    keys = jax.random.split(jax.random.key(seed), n_pods)
    p = jax.vmap(lambda k: {"w": jax.random.normal(k, (4, 1)) * 0.1})(keys)
    return jax.tree.map(np.asarray, p)


def _trainer(sync, optimizer="momentum", n_pods=3):
    return Trainer(_loss, None,
                   TrainerConfig(n_pods=n_pods, optimizer=optimizer,
                                 lr=0.05, sync=sync), device="cpu")


def _state(trainer, seed=0):
    return trainer.state_from_params(
        {k: torch.from_numpy(v.copy())
         for k, v in _init_params(seed, trainer.cfg.n_pods).items()})


def _run_trace(root, live, n_steps=16, event_step=5):
    """One elastic run over a fixed event trace: ``cloud_left`` fires at
    ``event_step``, the reconfig lands at the next sync barrier.

    ``live=False`` is the reference arm: pause at the barrier, blocking
    checkpoint save and restore, re-stack.  ``live=True`` is the migration
    arm: async barrier snapshots, ``stage`` at event time off the step
    path, ``reconcile`` at the barrier.  Returns the per-step losses."""
    sync = SyncConfig("asgd_ga", 4, compress_topk=0.25, quantize_int8=True,
                      error_feedback=True, codec_block=128)
    plan = build_training_plan(TrainingRequest(
        model="m", clouds=CLOUDS, sync=sync, global_batch=96))
    ctl = ElasticityController(plan)
    trainer = _trainer(sync)
    state = _state(trainer)
    engine = AsyncCheckpointEngine(os.path.join(root, "snaps"),
                                   keep=2) if live else None
    migrator = LiveMigrator(engine) if live else None
    if live:
        engine.snapshot(state, 0)
    losses, pending = [], None
    for step in range(n_steps):
        state, m = trainer.train_step(state,
                                      _batch(trainer.cfg.n_pods, step))
        state = trainer.maybe_sync(state, step)
        losses.append(float(m["loss"]))
        at_barrier = is_sync_step(trainer.cfg.sync, step)
        if live and at_barrier:
            engine.snapshot(state, step + 1)
        if step == event_step:
            pending = ctl.handle(CloudEvent("cloud_left", region="cq",
                                            time_s=float(step)))
            if live:
                keep, n_new = pending.pod_transition()
                migrator.stage(state, n_new, keep=keep)
        if pending is not None and at_barrier:
            if live:
                trainer, state, applied = migrator.reconcile(
                    trainer, state, pending)
            else:
                d = os.path.join(root, f"pause_{step + 1}")
                ckpt.save(d, state, step=step + 1)
                state, _ = ckpt.restore(d, like=state)
                trainer, state, applied = apply_reconfig(
                    trainer, state, pending)
            assert applied
            pending = None
    if live:
        assert migrator.migrations == 1
        assert not migrator.errors
        assert migrator.last_staged is not None
        assert migrator.last_staged["n_new"] == trainer.cfg.n_pods
        # the staged state is on the host, at the new pod count, from the
        # last durable snapshot before the barrier
        staged = migrator.last_staged["state"]
        assert all(x.device.type == "cpu" and x.shape[0] == 2
                   for x in T.leaves(staged.params))
        engine.close()
    return np.asarray(losses)


def test_live_migration_loss_identical_to_pause_and_restore(tmp_path):
    """The acceptance bar: a migrated run is step-for-step loss-identical
    to a pause-and-restore run on the same event trace; the staged
    snapshot pre-moves bytes but never perturbs the numerics, and the f32
    checkpoint round trip of the pause arm is exact."""
    ref = _run_trace(str(tmp_path / "pause"), live=False)
    mig = _run_trace(str(tmp_path / "live"), live=True)
    np.testing.assert_array_equal(ref, mig)


def test_stage_supersedes_and_stale_stage_degrades(tmp_path):
    """Two events between barriers: the second stage supersedes the first
    (counted, not reconciled), and reconcile still re-stacks correctly."""
    sync = SyncConfig("asgd_ga", 8)
    plan = build_training_plan(TrainingRequest(
        model="m", clouds=CLOUDS, sync=sync, global_batch=96))
    ctl = ElasticityController(plan)
    trainer = _trainer(sync, optimizer="sgd")
    state = _state(trainer, seed=1)
    engine = AsyncCheckpointEngine(str(tmp_path), keep=2)
    migrator = LiveMigrator(engine)
    engine.snapshot(state, 0)
    rc = ctl.handle(CloudEvent("cloud_left", region="cq", time_s=1.0))
    migrator.stage(state, rc.pod_transition()[1])
    migrator.stage(state, rc.pod_transition()[1])   # supersedes the first
    trainer, state, applied = migrator.reconcile(trainer, state, rc)
    assert applied and trainer.cfg.n_pods == 2
    assert migrator.restaged == 1 and migrator.migrations == 1
    engine.close()


def test_stage_without_durable_snapshot_degrades_cleanly(tmp_path):
    """No durable snapshot yet: stage is a no-op and reconcile falls back
    to the plain barrier re-stack (nothing staged, nothing raised)."""
    sync = SyncConfig("asgd_ga", 8)
    plan = build_training_plan(TrainingRequest(
        model="m", clouds=CLOUDS, sync=sync, global_batch=96))
    ctl = ElasticityController(plan)
    trainer = _trainer(sync, optimizer="sgd")
    state = _state(trainer, seed=2)
    engine = AsyncCheckpointEngine(str(tmp_path), keep=2)
    migrator = LiveMigrator(engine)
    rc = ctl.handle(CloudEvent("cloud_left", region="cq", time_s=1.0))
    migrator.stage(state, rc.pod_transition()[1])
    trainer, state, applied = migrator.reconcile(trainer, state, rc)
    assert applied and trainer.cfg.n_pods == 2
    assert migrator.last_staged is None and not migrator.errors
    engine.close()


# ---------------------------------- test_property.py's async-snapshot case


def _random_tree(n_pods, dtype, seed):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return torch.from_numpy(rng.normal(size=(n_pods,) + shape)
                                .astype(np.float32)).to(getattr(torch,
                                                                dtype))
    return {"w": leaf(4, 3), "nested": {"m": leaf(4, 3), "v": leaf(2)},
            "b": leaf(5)}


@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.integers(1, 4),
       st.sampled_from(["float32", "bfloat16"]),
       st.integers(0, 10_000))
def test_async_snapshot_equals_blocking_save(n_pods, dtype, seed):
    """An engine snapshot commits exactly what a blocking save of the same
    tree at the same step writes: restored trees are bit-identical, the
    manifests agree on keys, dtypes, shapes and step, and (the port's
    contract) on the arrays' size and CRC32."""
    import shutil
    import tempfile

    tree = _random_tree(n_pods, dtype, seed)
    root = tempfile.mkdtemp(prefix="ckpt_async_prop_")
    try:
        eng = AsyncCheckpointEngine(f"{root}/a", keep=1)
        eng.snapshot(tree, seed)
        eng.wait()
        _, apath = eng.last_durable()
        bpath = blocking_equivalent(tree, seed, f"{root}/b")
        like = _zeros(tree)
        a, astep = ckpt.restore(apath, like)
        b, bstep = ckpt.restore(bpath, like)
        assert astep == bstep == seed
        _assert_trees_equal(a, b)
        _assert_trees_equal(a, tree)
        ma, mb = ckpt.load_manifest(apath), ckpt.load_manifest(bpath)
        assert all(ma[k] == mb[k] for k in ("keys", "dtypes", "shapes",
                                            "step", "arrays_bytes",
                                            "arrays_crc32"))
        eng.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------- the port's own


def test_in_place_write_after_snapshot_keeps_the_captured_values(tmp_path):
    """The port's trainer writes its state in place: a write to a leaf
    right after ``snapshot()`` returns (the commit still gated) must not
    reach the committed snapshot, which holds the values at the call."""
    eng, gate = _gated_engine(str(tmp_path))
    tree = _tree(2, seed=4)
    tree["emb"] = torch.randn(2, 5).to(torch.bfloat16)
    want = T.tree_map(torch.clone, tree)
    eng.snapshot(tree, 1)
    for x in T.leaves(tree):
        x.add_(1.0)
        x.mul_(-3.0)
    gate.set()
    out, step = eng.restore_last(like=_zeros(want))
    assert step == 1
    _assert_trees_equal(out, want)
    eng.close()


def _pair_trees(n_pods=2, seed=3):
    """One tree in both packages: f32 and bf16 leaves and an int32 step."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_pods, 6, 3)).astype(np.float32)
    m = rng.normal(size=(n_pods, 4)).astype(ml_dtypes.bfloat16)
    port = {"w": torch.from_numpy(w),
            "nested": {"m": torch.from_numpy(
                m.view(np.int16).copy()).view(torch.bfloat16)},
            "step": 7}
    ref = {"w": jnp.asarray(w), "nested": {"m": jnp.asarray(m)},
           "step": jnp.asarray(7, jnp.int32)}
    return port, ref


def test_snapshots_restore_across_the_packages(tmp_path, monkeypatch):
    """A snapshot the port's engine commits restores in the reference's
    ``checkpoint.restore`` and one from the reference's engine in the
    port's, bit for bit (bf16 included); with the reference's clock at
    the zip epoch the two files are the same bytes, and the manifests'
    size and CRC32 equal."""
    monkeypatch.setattr(zipfile.time, "localtime", lambda *a: EPOCH)
    port_tree, ref_tree = _pair_trees()
    teng = AsyncCheckpointEngine(str(tmp_path / "port"), keep=1)
    teng.snapshot(port_tree, 5, metadata={"pods": 2})
    teng.wait()
    jeng = jengine.AsyncCheckpointEngine(str(tmp_path / "ref"), keep=1)
    jeng.snapshot(ref_tree, 5, metadata={"pods": 2})
    jeng.wait()
    tdir, jdir = teng.last_durable()[1], jeng.last_durable()[1]

    back_j, jstep = jckpt.restore(tdir, jax.tree.map(jnp.zeros_like,
                                                     ref_tree))
    assert jstep == 5
    for a, b in zip(jax.tree.leaves(back_j), jax.tree.leaves(ref_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    back_t, tstep = ckpt.restore(jdir, _zeros(port_tree))
    assert tstep == 5
    _assert_trees_equal(back_t, port_tree)

    mt, mj = ckpt.load_manifest(tdir), jckpt.load_manifest(jdir)
    for k in ("keys", "dtypes", "shapes", "step", "metadata",
              "arrays_bytes", "arrays_crc32"):
        assert mt[k] == mj[k], k
    teng.close()
    jeng.close()


def test_capture_failure_raises_snapshot_error_with_no_fallback(
        tmp_path, monkeypatch):
    """A host buffer that cannot be allocated fails ``snapshot()`` with
    :class:`SnapshotError`: nothing is queued or written, and the engine
    takes the next snapshot once buffers can be had."""
    eng = AsyncCheckpointEngine(str(tmp_path), keep=2)
    real = torch.empty

    def no_memory(*args, **kw):
        raise RuntimeError("out of host memory")

    monkeypatch.setattr(engine_mod.torch, "empty", no_memory)
    with pytest.raises(SnapshotError, match="out of host memory"):
        eng.snapshot(_tree(2), 1)
    monkeypatch.setattr(engine_mod.torch, "empty", real)
    eng.wait()
    assert eng.committed == 0 and list_steps(str(tmp_path)) == []
    assert eng._host_bufs == []
    eng.snapshot(_tree(2), 2)
    eng.wait()
    assert list_steps(str(tmp_path)) == [2]
    eng.close()


def test_pool_holds_at_most_max_inflight_plus_one_sets(tmp_path):
    """With the commit gated, ``max_inflight`` snapshots queue beside the
    one being committed, each in its own buffer set; the next one waits
    (backpressure) and, once the worker frees a set, reuses it.  A new
    layout (a pod re-stack) replaces a free set of the old one."""
    eng, gate = _gated_engine(str(tmp_path), keep=5, max_inflight=2)
    for s in range(3):
        eng.snapshot(_tree(2, seed=s), s)
    assert len(eng._host_bufs) == 3 and eng._free == []
    done = threading.Event()

    def fourth():
        eng.snapshot(_tree(2, seed=3), 3)
        done.set()

    t = threading.Thread(target=fourth, daemon=True)
    t.start()
    assert not done.wait(timeout=0.5)        # held back by the full pool
    gate.set()
    assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    eng.wait()
    assert len(eng._host_bufs) == 3 and list_steps(str(tmp_path)) == \
        [0, 1, 2, 3]
    eng.snapshot(_tree(1, seed=4), 4)        # a 1-pod layout
    eng.wait()
    shapes = sorted(s.views[0].shape[0] for s in eng._host_bufs)
    assert shapes == [1, 2, 2]
    out, _ = ckpt.restore(step_dir(str(tmp_path), 4), _zeros(_tree(1)))
    _assert_trees_equal(out, _tree(1, seed=4))
    eng.close()


def test_resized_like_allocates_nothing_and_restores_on_the_host(tmp_path):
    """The migration skeleton lives on the ``meta`` device with each pod
    dimension re-sized (the int step passes through); a restore through it
    lands on the host with the ``pod_resize="mean"`` transform."""
    tree = dict(_tree(3, seed=6), step=4)
    like = _resized_like(tree, 3, 2)
    assert like["step"] == 4
    assert all(x.device.type == "meta" and x.shape[0] == 2
               for x in T.leaves(like) if isinstance(x, torch.Tensor))
    ckpt.save(str(tmp_path), tree, step=4)
    out, _ = ckpt.restore(str(tmp_path), like, device="cpu",
                          pod_resize="mean")
    w = tree["w"].numpy()
    want = w[:2] + (w.mean(0, keepdims=True) - w[:2].mean(0, keepdims=True))
    np.testing.assert_array_equal(out["w"].numpy(), want)
    assert out["w"].device.type == "cpu" and out["step"] == 4


def test_migration_losses_equal_the_reference_run_trace(tmp_path):
    """The port's migration arm and the reference's ``_run_trace`` (its
    migration arm) from the same initial parameters and batches: the same
    loss stream within ``LOSS_RTOL``, the event's pod leaving at the same
    barrier (both runs assert one migration, staged at the new count)."""
    ref = _ref_tests()._run_trace(str(tmp_path / "ref"), live=True)
    mig = _run_trace(str(tmp_path / "port"), live=True)
    np.testing.assert_allclose(mig, ref, rtol=LOSS_RTOL, atol=0)
