"""Elastic reconfiguration on a pod axis split over processes (gloo on the
CPU), against the port's one-process run and the reference.

One cloud a process: the world holds as many pods' ranks as the run ever
has; a pod that leaves idles in the world, and a pod that joins is an idle
rank that becomes live (``Trainer.reconfigure`` on every rank of the
world).  Three launches, each read by many cases:

- **(3, 1, 1), 3 processes** (``torch_mesh_worker.elastic_schedule``):
  two steps and a codec round on 3 pods; a placed save, restored bit-equal;
  an async snapshot; pod 1 leaves at the barrier (``keep=(0, 2)``), staged
  by ``LiveMigrator``; two steps and a round on 2 pods; pod 1 rejoins; two
  steps and a round on 3 pods; a chaos round with pod 1 crashed (the
  degraded round's ``alive`` rows at 3 pods); then ``keep=(2, 0)``, which
  moves rows between ranks.  Every row of the parameters, the gradient
  accumulator and the EF residual is bit-equal to the same schedule run
  whole in one process, as are the host records; the placed save is the
  one-process save's file, which the reference's ``restore`` reads; the
  one-process save restores placed, resized from 3 pods to 2; a pod axis
  of 2 pods a rank refuses to reconfigure; the drop and rejoin are held to
  the reference's single-device ``Trainer.reconfigure`` within
  ``LOSS_RTOL`` and the flip rule of ``tests/test_torch_mesh_transports.py``.
- **(2, 2, 2), 8 processes** (``deep_schedule``): a placed save writes the
  file of the unplaced save of the same state gathered whole, and restores
  bit-equal, as does that unplaced save; the bound async engine's
  snapshot equals ``blocking_equivalent`` and ``restore_last`` puts it
  back placed bit-equal; 2 -> 1 -> 2 pods with the in-pod axes stays
  within ``LOSS_ATOL`` of the one-process run, the rows after the rejoin
  within its flip rule, and the rows after the last round within the rule
  of the one-process run continued from the split run's rejoined rows.
- **(2, 1, 1), 2 processes**: a save writes both pods' rows, the
  one-process save's file.
- **(1, 1, 1), 1 process**: every pod on one rank's mesh; the resize runs
  on the local shards, 2 -> 3 -> 2 pods bit-equal to one process.
"""
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_arch as jget_arch
from repro.core import sync as jsync
from repro.models import transformer as jtransformer
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro.training.trainer import TrainState as JTrainState

import torch_mesh_worker as W
from test_torch_mesh import LOSS_ATOL, _launch
from test_torch_mesh_transports import LOSS_RTOL, _flips_within
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
from repro_torch.configs import get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.models import transformer
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "granite-8b"
MAX_PODS, PER_POD, SEQ, LR = 3, 4, 16, 0.05
SYNC = SyncConfig("asgd_ga", 2, **W.ARM_SYNC)
# the points of the (3, 1, 1) schedule whose rows are held
POINTS = ("left", "joined", "mid", "swapped")


@functools.lru_cache(maxsize=1)
def _inputs():
    """The reference's smoke parameters converted, stacked over 3 pods,
    and token batches from a seed (each step's rows for 3 pods; a step on
    fewer pods takes the first rows)."""
    one = convert.params_from_jax(
        jax.tree.map(np.asarray, jtransformer.init_params(
            jax.random.key(0), jget_arch(ARCH).smoke)),
        get_arch(ARCH).smoke, device="cpu")
    params = T.tree_map(lambda x: torch.stack([x] * MAX_PODS), one)
    rng = np.random.default_rng(7)
    vocab = get_arch(ARCH).smoke.vocab_size
    batches = [{k: torch.from_numpy(rng.integers(
        0, vocab, (MAX_PODS, PER_POD, SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(W.ELASTIC_STEPS)]
    return params, batches


def _trainer(n_pods):
    cfg = get_arch(ARCH).smoke
    tr = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b), None,
                 TrainerConfig(n_pods=n_pods, lr=LR, sync=SYNC),
                 device="cpu", transport=W.elastic_transport())
    params, _ = _inputs()
    return tr, tr.state_from_params(
        T.tree_map(lambda x: x[:n_pods].clone(), params))


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The (3, 1, 1) schedule run whole in one process: its record, its
    gathered trees, the final state and its save directory."""
    d = str(tmp_path_factory.mktemp("whole"))
    tr, state = _trainer(3)
    _, batches = _inputs()
    with AsyncCheckpointEngine(os.path.join(d, "snaps"), keep=2) as eng:
        run = W.ElasticRun(tr, state, batches, d, None, eng)
        W.elastic_schedule(run)
    return {"rec": run.rec, "trees": run.trees, "dir": d}


@pytest.fixture(scope="module")
def split(tmp_path_factory, whole):
    """The (3, 1, 1) launch; the one-process save of step 2 is its whole
    checkpoint to restore placed."""
    params, batches = _inputs()
    d = str(tmp_path_factory.mktemp("split"))
    out = _launch({"elastic": "split", "arch": ARCH, "lr": LR,
                   "mesh": (3, 1, 1), "n_pods": 3, "params": params,
                   "batches": batches, "dir": d,
                   "whole_dir": os.path.join(whole["dir"], "placed")},
                  tmp_path_factory.mktemp("split_launch"))
    out["dir"] = d
    return out


@pytest.fixture(scope="module", autouse=True)
def _deep_launch(tmp_path_factory):
    """The (2, 2, 2) launch, started before the file's first case so that
    it runs beside the (3, 1, 1) fixtures (a launch waits mostly on its
    processes' start and on gloo)."""
    params, batches = _inputs()
    d = str(tmp_path_factory.mktemp("deep"))
    with ThreadPoolExecutor(1) as pool:
        yield d, pool.submit(
            _launch, {"elastic": "deep", "arch": ARCH, "lr": LR,
                      "mesh": (2, 2, 2), "n_pods": 2,
                      "params": T.tree_map(lambda x: x[:2], params),
                      "batches": batches, "dir": d},
            tmp_path_factory.mktemp("deep_launch"))


@pytest.fixture(scope="module")
def deep(_deep_launch):
    d, launched = _deep_launch
    out = launched.result()
    out["dir"] = d
    return out


def _equal_trees(got, want, what):
    for key in ("params", "ga"):
        for (path, a), b in zip(T.leaves_with_path(got[key]),
                                T.leaves(want[key]), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), \
                (what, key, path)
    assert torch.equal(got["ef"], want["ef"]), what


# ----------------------------------------------------------- (3, 1, 1)


@pytest.mark.parametrize("point", POINTS)
def test_split_rows_bit_equal_to_one_process(point, split, whole):
    """After the drop and rejoin's round (``mid``) and after ``keep=(2,
    0)`` (``swapped``): every pod's rows of the parameters, the gradient
    accumulator and the EF residual equal the one-process run's."""
    _equal_trees(split["trees"][point], whole["trees"][point], point)


def test_degraded_round_at_three_pods_matches_whole(split, whole):
    """The chaos round at 3 pods with pod 1 crashed: each rank reads the
    round's ``alive`` products at its own rows, so the rows after it equal
    the whole run's (at 2 pods both products are all zero, so rows read at
    the wrong place could not show)."""
    _equal_trees(split["trees"]["final"], whole["trees"]["final"], "final")
    for rank in split["ranks"]:
        assert rank["degraded"] == whole["rec"]["degraded"] == 1
        assert rank["outcomes"] == whole["rec"]["outcomes"]
        assert [o["kinds"] for o in rank["outcomes"]] == [["crash"]]


def test_split_host_records_equal(split, whole):
    """Losses step for step, and the billed records: ranks 0 and 2 take
    part in every round; rank 1 idles while pod 1 is away and misses the
    round at step 3 (no fluctuation: a round's bill depends on the clock,
    which every rank ticks)."""
    want = whole["rec"]
    r0, r1, r2 = split["ranks"]
    away = (2, 3)
    for rank in (r0, r2):
        assert rank["losses"] == want["losses"]
        assert rank["records"] == want["records"]
    assert r1["losses"] == {s: v for s, v in want["losses"].items()
                            if s not in away}
    assert r1["records"] == [r for r in want["records"]
                             if r[-1] not in away]
    assert r0["live"] and r2["live"] and r1["live"]
    assert all(r["n_pods"] == 3 for r in split["ranks"])


def test_placed_save_is_the_unplaced_file(split, whole):
    """The placed save of the 3-pod state writes the one-process save's
    file: the same size, CRC32 and shapes; the async snapshot of the
    restored state at the same step writes it too, and every rank
    restored the save bit-equal."""
    want = whole["rec"]["saves"]
    for rank in split["ranks"]:
        assert rank["saves"]["placed"] == want["placed"]
        assert rank["snapshot"] == tuple(want["placed"][:2])
        assert rank["restore_equal"] is True
    assert want["placed"][2][0][0] == 3      # the pod dimension, whole
    # the 2-pod state, saved by the ranks of pods 0 and 2 while rank 1
    # idles
    r0, r1, r2 = split["ranks"]
    assert r0["saves"]["before_join"] == r2["saves"]["before_join"] \
        == want["before_join"]
    assert "before_join" not in r1["saves"]
    assert want["before_join"][2][0][0] == 2


def _np(x):
    """A port leaf as the reference holds it."""
    return np.asarray(x, np.int32) if isinstance(x, int) else (
        x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if x.dtype == torch.bfloat16 else x.numpy())


def test_reference_restore_reads_the_placed_save(split, whole):
    """The reference's ``checkpoint.restore`` reads the placed save equal
    to the one-process save of the same state, leaf by leaf."""
    tr, like = _trainer(3)
    state, step = ckpt.restore(os.path.join(whole["dir"], "placed"), like)
    jlike = _jax_like(state)
    got, jstep = jckpt.restore(os.path.join(split["dir"], "placed"), jlike)
    assert jstep == step == 2
    for want, g in zip(T.leaves(state), jax.tree.leaves(got), strict=True):
        np.testing.assert_array_equal(np.asarray(g), _np(want), strict=True)


def test_whole_save_restores_placed_with_pod_resize(split, whole):
    """The one-process save of the 3-pod state restores onto the 2-pod
    placements after pod 1 left: each rank's rows of the mean-resized
    pod dimension, as the whole restore resizes them."""
    tr, state = _trainer(3)
    like = T.tree_map(lambda x: torch.empty((2,) + tuple(x.shape[1:]),
                                            dtype=x.dtype)
                      if isinstance(x, torch.Tensor) and x.dim()
                      and x.shape[0] == 3 else x, state)
    want, _ = ckpt.restore(os.path.join(whole["dir"], "placed"), like,
                           pod_resize="mean")
    got = split["trees"]["whole_resized"]
    for a, b in zip(T.leaves(got["params"]), T.leaves(want.params),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(got["ef"], want.sync_state.ef_residual)


def test_migrator_stages_each_ranks_rows(split, whole):
    """``LiveMigrator.stage`` takes its skeleton from the whole shapes:
    each rank of the new pod group stages one pod's rows of the
    snapshot; the departing rank stages nothing."""
    want = [[1] + list(x.shape[1:]) for x in
            T.leaves(_inputs()[0])]
    r0, r1, r2 = split["ranks"]
    assert r0["staged"] == r2["staged"] == want
    assert r1["staged"] is None
    for rank in split["ranks"]:
        assert rank["migrator_errors"] == []
    # the one-process run stages both pods
    assert whole["rec"]["staged"] == [[2] + w[1:] for w in want]


def test_keep_reversed_moves_rows_between_ranks(split, whole):
    """``keep=(2, 0)``: old pod 2 becomes pod 0 on rank 0 and old pod 0
    pod 1 on rank 2, each row sent point to point; rank 1 leaves."""
    r0, r1, r2 = split["ranks"]
    assert r0["swap_sent"] > 0 and r2["swap_sent"] > 0
    assert r1["swap_sent"] > 0          # pod 1's rows feed both means


def test_reconfigurations_reuse_meshes_and_groups(split):
    """Pods that leave and join make no process group once their layouts
    have been seen: the rejoin takes the first mesh again, and from the
    leave to ``keep=(2, 0)`` (the leave's layout again; saves and a
    rejoin between) no rank made a group."""
    for rank in split["ranks"]:
        assert rank["mesh_again"] is True
        before, after = rank["groups"]
        assert after == before


def test_several_pods_a_rank_refuse_to_reconfigure(split):
    for rank in split["ranks"]:
        assert rank["many_pods"] is not None
        assert "several a rank" in rank["many_pods"]


def _jax_like(state):
    """A reference ``TrainState`` shaped as the port's ``state``, to
    restore a checkpoint into."""
    ss = state.sync_state
    return JTrainState(
        params=jax.tree.map(jnp.asarray, T.tree_map(_np, state.params)),
        opt_state=(),
        sync_state=jsync.SyncState(*(
            jax.tree.map(jnp.asarray, T.tree_map(_np, getattr(ss, f)))
            for f in ss._fields)),
        step=jnp.int32(0))


def test_split_drop_and_rejoin_matches_the_reference(split, whole):
    """The anchor: the reference's single-device ``Trainer.reconfigure``
    from the converted state (the split run's saves before the drop and
    before the rejoin, read by the reference's ``restore``): the rows it
    re-stacks within the flip rule of the split run's (its mean and sum
    reduce in another order), and the first step after each within
    ``LOSS_RTOL``."""
    _, batches = _inputs()
    jcfg = jget_arch(ARCH).smoke
    jtr = JTrainer(lambda p, b: jtransformer.loss_fn(p, jcfg, b),
                   lambda k: jtransformer.init_params(k, jcfg),
                   JTrainerConfig(n_pods=3, optimizer="sgd", lr=LR,
                                  sync=jsync.SyncConfig("asgd_ga", 2,
                                                        **W.ARM_SYNC)))
    r0 = split["ranks"][0]
    for name, n_old, n_new, keep, point, step in (
            ("placed", 3, 2, (0, 2), "left", 2),
            ("before_join", 2, 3, None, "joined", 4)):
        jlike = _jax_like(_trainer(n_old)[1])
        jstate, _ = jckpt.restore(os.path.join(split["dir"], name), jlike)
        jtr, jstate = jtr.reconfigure(jstate, n_new, keep=keep)
        got = split["trees"][point]
        _flips_within(f"reconfigure to {n_new}",
                      params=(got["params"], jax.tree.leaves(jstate.params)),
                      ga=(got["ga"],
                          jax.tree.leaves(jstate.sync_state.ga_buffer)),
                      ef=(got["ef"], jstate.sync_state.ef_residual))
        _, metrics = jtr.train_step(
            jstate, {k: jnp.asarray(v[:n_new].numpy())
                     for k, v in batches[step].items()})
        np.testing.assert_allclose(r0["losses"][step],
                                   np.asarray(metrics["loss_per_pod"]),
                                   rtol=LOSS_RTOL)


# ----------------------------------------------------------- (2, 2, 2)


def test_deep_placed_save_restores_bit_equal(deep):
    """A placed save writes the file of the unplaced save of the same
    state gathered whole, and both restore onto the placements
    bit-equal."""
    m = ckpt.load_manifest(os.path.join(deep["dir"], "gathered"))
    for rank in deep["ranks"]:
        assert rank["saves"]["placed"][:2] == (m["arrays_bytes"],
                                               m["arrays_crc32"])
        assert rank["placed_restore_equal"] is True
        assert rank["restore_equal"] is True


def test_deep_snapshot_equals_blocking_equivalent(deep):
    for rank in deep["ranks"]:
        assert rank["snapshot"] == rank["blocking"]


def test_deep_restore_last_restores_placed_bit_equal(deep):
    """``restore_last(parts=...)`` puts the engine's snapshot back onto
    every rank's placements (its rows, its in-pod shards) bit-equal."""
    for rank in deep["ranks"]:
        assert rank["restore_last_equal"] is True


def test_deep_two_one_two_pods_within_loss_atol(deep):
    """2 -> 1 -> 2 pods with FSDP and tensor parallelism in the pod: the
    losses of every live rank within ``LOSS_ATOL`` of one process (in-pod
    sums reorder), pod 1's ranks idle while it is away.  The rows the
    rejoin makes, gathered whole: the parameters, the gradient accumulator
    and the EF residual within the flip rule of the one-process run's.
    The last round comes after the last loss: the one-process run goes on
    from the rejoined rows of the split run, and the rows after its round
    are held by the same rule (from the start, six steps of reordered
    in-pod sums flip more top-k winners than the rule's window of the
    transports' four)."""
    tr, state = _trainer(2)
    _, batches = _inputs()
    want = {}
    for step in range(6):
        if step == 2:
            tr, state = tr.reconfigure(state, 1, (0,))
        if step == 4:
            tr, state = tr.reconfigure(state, 2)
            got = deep["trees"]["rejoined"]
            _flips_within("deep rejoined",
                          params=(got["params"], state.params),
                          ga=(got["ga"], state.sync_state.ga_buffer),
                          ef=(got["ef"], state.sync_state.ef_residual))
            state = state._replace(
                params=T.tree_map(torch.clone, got["params"]),
                sync_state=state.sync_state._replace(
                    ga_buffer=T.tree_map(torch.clone, got["ga"]),
                    ef_residual=got["ef"].clone()))
        n = tr.cfg.n_pods
        state, metrics = tr.train_step(state, {k: v[:n] for k, v in
                                               batches[step].items()})
        want[step] = metrics["loss_per_pod"].tolist()
        state = tr.maybe_sync(state, step)
    for r, rank in enumerate(deep["ranks"]):
        steps = sorted(rank["losses"])
        assert steps == ([0, 1, 4, 5] if r >= 4 else list(range(6))), r
        for s in steps:
            diff = np.abs(np.subtract(rank["losses"][s], want[s])).max()
            assert diff < LOSS_ATOL, (r, s, rank["losses"][s], want[s])
    got = deep["trees"]["final"]
    _flips_within("deep final", params=(got["params"], state.params),
                  ga=(got["ga"], state.sync_state.ga_buffer),
                  ef=(got["ef"], state.sync_state.ef_residual))


# ----------------------------------------------------------- (2, 1, 1)


def test_two_pod_save_writes_both_pods_rows(tmp_path):
    """At (2, 1, 1) each rank holds one pod's rows: the save writes both
    pods, the one-process save's file, not one rank's rows as the whole
    tree."""
    params, batches = _inputs()
    d = str(tmp_path / "two")
    _launch({"elastic": "two", "arch": ARCH, "lr": LR, "mesh": (2, 1, 1),
             "n_pods": 2, "params": T.tree_map(lambda x: x[:2], params),
             "batches": batches, "dir": d}, tmp_path)
    tr, state = _trainer(2)
    state, _ = tr.train_step(state, {k: v[:2] for k, v in
                                     batches[0].items()})
    ckpt.save(str(tmp_path / "one"), state, step=state.step)
    got = ckpt.load_manifest(os.path.join(d, "placed"))
    want = ckpt.load_manifest(str(tmp_path / "one"))
    assert got["shapes"][0][0] == 2
    for k in ("arrays_bytes", "arrays_crc32", "shapes", "keys", "dtypes"):
        assert got[k] == want[k], k


# ----------------------------------------------------------- (1, 1, 1)


def test_one_rank_mesh_reconfigures_on_local_shards(tmp_path):
    """A mesh whose one rank holds every pod: ``reconfigure`` resizes the
    local shards and keeps the mesh; 2 -> 3 -> 2 pods (``keep=(2, 0)``)
    with steps and rounds between, bit-equal to one process."""
    params, batches = _inputs()
    out = _launch({"elastic": "one", "arch": ARCH, "lr": LR,
                   "mesh": (1, 1, 1), "n_pods": 2,
                   "params": T.tree_map(lambda x: x[:2], params),
                   "batches": batches, "dir": str(tmp_path / "one")},
                  tmp_path)
    tr, state = _trainer(2)
    run = W.ElasticRun(tr, state, batches, str(tmp_path))
    run.steps(0, 2)
    run.join(3)
    run.steps(2, 4)
    run.join(2, (2, 0))
    run.gather("final")
    assert out["ranks"][0] == {"kept_mesh": True}
    _equal_trees(out["trees"]["final"], run.trees["final"], "one rank")
