"""The WAN transports on a pod axis split over processes (gloo on the CPU),
against the port's one-process run and the reference's single-device
trainer.

One launch of 2 processes at (2, 1, 1) (one pod a rank) runs every arm of
``tests/torch_mesh_worker.py``'s ``build_arm`` through ``make_train_setup``
and ``Trainer.maybe_sync``, the transport bound to the trainer's pod axis:
``SimTransport``, ``MeshTransport``, ``ChaosTransport`` (a failed, a
corrupted and a degraded round), a streaming round that retunes mid-round
over a bandwidth cliff, ``HierarchicalTransport`` over two regions and a
``Trainer.retune`` from int8 to int4 between the rounds.  Each is bit-equal
to the same arm run whole in one process: the losses, every parameter, the
gradient accumulator, the EF residual, and what every rank saw on the host (records, billed seconds,
probe belief, fault outcomes, streaming decisions).  The ``"unequal"`` arm
gives rank 1 a slow measured hop: both ranks retune at the same chunk
because every measured second is agreed (the max over the ranks) before a
decision reads it.  The pod seam's units hold ``hierarchical_average`` of
4 pods over the 2 ranks, the successor trainer's mesh, the chaos
transport's corrupted row and a verifying ship's gathered checksums, in
a launch of their own so that each fails on its own at a commit without
them.  A launch of 8 processes at (2, 2, 2) runs the sim and chaos arms
with the in-pod axes sharded: the host records equal
the one-process run's, the losses are within ``LOSS_ATOL`` (in-pod tensor
parallelism reorders the sums, as in ``tests/test_torch_mesh.py``), and the
parameters, gradient accumulator and EF residual after the last round,
which no loss sees, are within the anchor's flip rule.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_arch as jget_arch
from repro.core import sync as jsync
from repro.core import transport as jtransport
from repro.core import wan as jwan
from repro.models import transformer as jtransformer
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig

import torch_mesh_worker as W
from test_torch_mesh import LOSS_ATOL, _launch
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch
from repro_torch.core.sync import hierarchical_average
from repro_torch.models import transformer
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "granite-8b"
N_PODS, PER_POD, SEQ, STEPS, LR = 2, 4, 16, 4, 0.05
ARMS = ("sim", "mesh", "chaos", "stream", "hier", "retune")
DEEP_ARMS = ("sim", "chaos")
# tests/test_torch_trainer.py's tolerances for the reference anchor: f32 on
# both sides, each framework's own gradients; a last-bit difference may
# flip a top-k winner, which moves that EF element by its whole value and
# that parameter by one receiver update, so its rule for the EF residual
# (at most FLIP_FRAC of the elements off) holds for the parameters too.
# The (2, 2, 2) runs are held to the one-process run by the same rule: the
# in-pod sums' order is a last-bit difference of the same kind
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-3, 1e-3
FLIP_FRAC, EF_NORM_RTOL = 1e-5, 1e-3
HIER = {"pairs-ama": (((0, 1), (2, 3)), "ama"),
        "pairs-sma": (((0, 1), (2, 3)), "sma"),
        "across-ama": (((0, 2), (1, 3)), "ama"),
        "across-sma": (((0, 2), (1, 3)), "sma")}


@functools.lru_cache(maxsize=1)
def _inputs():
    """The reference's smoke parameters converted, stacked over the pods,
    and token batches from a seed."""
    one = convert.params_from_jax(
        jax.tree.map(np.asarray, jtransformer.init_params(
            jax.random.key(0), jget_arch(ARCH).smoke)),
        get_arch(ARCH).smoke, device="cpu")
    params = T.tree_map(lambda x: torch.stack([x] * N_PODS), one)
    rng = np.random.default_rng(7)
    vocab = get_arch(ARCH).smoke.vocab_size
    batches = [{k: torch.from_numpy(rng.integers(
        0, vocab, (N_PODS, PER_POD, SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(STEPS)]
    return params, batches


def _job(mesh, arms, units=None):
    params, batches = _inputs()
    job = {"arch": ARCH, "lr": LR, "mesh": mesh, "n_pods": N_PODS,
           "params": params, "batches": batches, "arms": arms}
    if units is not None:
        job["units"] = units
    return job


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The arm run whole in one process: (params, gradient accumulator,
    EF residual, host)."""
    params, batches = _inputs()
    cfg = get_arch(ARCH).smoke
    sync, transport, stream, retune_to = W.build_arm(name)
    tr = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b), None,
                 TrainerConfig(n_pods=N_PODS, lr=LR, sync=sync),
                 device="cpu", transport=transport, stream=stream)
    tr.retune_to, tr.unequal = retune_to, False
    state = tr.state_from_params(T.tree_map(lambda x: x.clone(), params))
    tr, state, seen = W.drive(tr, state, batches)
    ss = state.sync_state
    return state.params, ss.ga_buffer, ss.ef_residual, seen


def _hier_tree():
    gen = torch.Generator().manual_seed(3)
    return {"w": torch.randn(4, 6, 5, generator=gen),
            "b": torch.randn(4, 7, generator=gen).to(torch.bfloat16)}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The (2, 1, 1) launch of every arm."""
    return _launch(_job((2, 1, 1), ARMS + ("unequal",)),
                   tmp_path_factory.mktemp("split"))


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """A (2, 1, 1) launch of the pod seam's units alone, each kept apart
    (an error is its value), so that each fails on its own."""
    job = _job((2, 1, 1), (), {"tree": _hier_tree(), "hier": HIER})
    return _launch(job, tmp_path_factory.mktemp("units"))["units"]


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The (2, 2, 2) launch: the sim and chaos arms, 8 ranks."""
    return _launch(_job((2, 2, 2), DEEP_ARMS),
                   tmp_path_factory.mktemp("deep"))


def _flips_within(what, **pairs):
    """Each ``name=(got, want)`` pair of trees within ``PARAM_ATOL`` and
    ``PARAM_RTOL``, but for at most ``FLIP_FRAC`` of the elements (flipped
    top-k winners), and the EF rows' norms within ``EF_NORM_RTOL``; ``-s``
    prints the gaps."""
    def flat(tree):
        return np.concatenate([
            (x.float().numpy() if torch.is_tensor(x)
             else np.asarray(x, dtype=np.float32)).ravel()
            for x in T.leaves(tree)])

    gaps = []
    for name, (got, want) in pairs.items():
        got, want = flat(got), flat(want)
        assert got.shape == want.shape, (what, name)
        off = ~np.isclose(got, want, atol=PARAM_ATOL, rtol=PARAM_RTOL)
        assert off.sum() <= FLIP_FRAC * got.size, (what, name, off.sum())
        gaps.append(f"{name}: {int(off.sum())} of {got.size} off, max "
                    f"|gap| {np.abs(got - want).max():.3g}")
    print(f"[{what}] " + "; ".join(gaps))
    got, want = pairs["ef"]
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1),
                               np.linalg.norm(np.asarray(want), axis=1),
                               rtol=EF_NORM_RTOL)


def _host_equal(name, got, want):
    """One rank's host observations against the one-process run's."""
    assert got["losses"] == want["losses"], name
    assert got["rounds"] == want["rounds"] == STEPS // 2, name
    if name == "mesh":
        # measured seconds: the bytes and steps of each record are equal
        assert [r[:2] + r[3:] for r in got["records"]] == \
            [r[:2] + r[3:] for r in want["records"]], name
    else:
        for key in ("records", "probe", "outcomes", "retries", "degraded",
                    "stream_rounds", "decisions", "stream_retunes"):
            assert got[key] == want[key], (name, key)
    assert got["tier"] == want["tier"], name


@pytest.mark.parametrize("name", ARMS)
def test_split_transport_bit_equal_to_one_process(name, split):
    out = split[name]
    params, ga, ef, seen = _one_process(name)
    for key, tree in (("params", params), ("ga", ga)):
        for (path, got), want in zip(T.leaves_with_path(out[key]),
                                     T.leaves(tree), strict=True):
            assert torch.equal(got, want), (name, key, path)
    assert torch.equal(out["ef"], ef), name
    r0, r1 = out["ranks"]
    for rank in (r0, r1):
        _host_equal(name, rank, seen)
        # the ring crossed the pod group
        assert rank["sends"] > 0, name
    # every rank holds the same host state, measured seconds included
    for key in r0:
        if key not in ("sends", "agreements", "reconfigure"):
            assert r0[key] == r1[key], (name, key)
    if name == "mesh":
        assert r0["probe"] is not None
        # one agreement a record: the max of the ranks' seconds
        assert r0["agreements"] == len(r0["records"]), r0["agreements"]
    if name == "chaos":
        assert r0["retries"] == 2 and r0["degraded"] == 1, r0
        assert [o["kinds"] for o in r0["outcomes"]] == \
            [["fail", "corrupt"], ["crash"]]
    if name == "stream":
        assert r0["stream_retunes"] == 1, r0["stream_retunes"]
    if name == "hier":
        assert len(r0["records"]) > 0
    if name == "retune":
        # Trainer.retune on the mesh, to int4 in every bucket; a shrink to
        # 1 pod would keep pod 0's rows on rank 0 and idle rank 1
        assert r0["successor_keeps_mesh"] is True
        assert r0["tier"] == [3] * 4
        assert r0["reconfigure"] == (0, 1) and r1["reconfigure"] is None


def test_successor_keeps_mesh(units):
    """The trainer a retune builds keeps the mesh and the pod axis (it
    was built without ``mesh=``, so it came back unplaced)."""
    for rank in units:
        assert rank["successor"] is True, rank["successor"]


def test_corrupt_row_is_global(units):
    """Pod 0's corrupted transfer lands on its ring peer, pod 1, which
    rank 1 holds: rank 1 flips it, rank 0 flips nothing (the row was the
    local row count modulo, so every rank flipped its own row 0)."""
    r0, r1 = (rank["corrupt"] for rank in units)
    assert isinstance(r0, dict) and isinstance(r1, dict), (r0, r1)
    assert r0["flipped"] is False and r1["flipped"] is True
    assert r0["rest_equal"] and r1["rest_equal"]


def test_checksums_gathered_over_the_pod_group(units):
    """A verifying ship over the split ring checks each receiver row
    against the sender's checksum, gathered over the pod group (the local
    ``len(sent_crc)`` held each row against its own sender row)."""
    for rank in units:
        assert rank["verified"] == {"equal": True, "crc_gathers": 1}, \
            rank["verified"]


@pytest.mark.parametrize("case", list(HIER))
def test_hierarchical_average_on_split_axis(case, units):
    groups, inter = HIER[case]
    want = hierarchical_average(_hier_tree(), groups, inter)
    for rank in units:
        got = rank[f"hier {case}"]
        assert isinstance(got, dict), got
        for a, b in zip(T.leaves(got["tree"]), T.leaves(want), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), case
        # one all-reduce a leaf, whatever the groups
        assert got["all_reduces"] == 2


def test_unequal_measured_seconds_retune_alike(split):
    """Rank 1's hop is slow, rank 0's is not: with every chunk's seconds
    agreed, both ranks see the cliff on the same chunk and retune alike."""
    r0, r1 = split["unequal"]["ranks"]
    assert r0["decisions"] == r1["decisions"]
    retunes = [(d["step"], d["chunk"], d["bucket"])
               for d in r0["decisions"] if d["action"] == "retune"]
    assert retunes and retunes[0][1] == 0, r0["decisions"]
    first = r0["decisions"][0]
    assert first["s"] >= W.UNEQUAL_SLOW_S, first
    assert r0["stream_retunes"] == r1["stream_retunes"] >= 1
    assert r0["records"] == r1["records"] and r0["probe"] == r1["probe"]


@pytest.mark.parametrize("name", DEEP_ARMS)
def test_deep_mesh_transport_matches_one_process(name, deep):
    out = deep[name]
    params, ga, ef, seen = _one_process(name)
    ranks = out["ranks"]
    assert len(ranks) == 8
    for rank in ranks:
        for key in ("records", "probe", "outcomes", "retries", "degraded",
                    "rounds", "tier"):
            assert rank[key] == seen[key], (name, key)
        diff = np.abs(np.array(rank["losses"])
                      - np.array(seen["losses"])).max()
        assert diff < LOSS_ATOL, (name, rank["losses"], seen["losses"])
    # the last round runs after the last loss (the chaos arm's degraded
    # one): the parameters, the gradient accumulator and the EF residual
    # hold it, within the flip rule, since in-pod reordering may flip a
    # top-k winner
    _flips_within("deep " + name, params=(out["params"], params),
                  ga=(out["ga"], ga), ef=(out["ef"], ef))


def test_split_sim_run_matches_the_reference(split):
    """The anchor: the split ``SimTransport`` codec run against the
    reference's single-device trainer over its own ``SimTransport``, from
    the same parameters and batches."""
    params, batches = _inputs()
    jcfg = jget_arch(ARCH).smoke
    trace = jwan.BandwidthTrace((0.0, 3.0), (100.0, 2.0))
    jt = jtransport.SimTransport(trace, jwan.WANConfig(fluctuation=0.2,
                                                       seed=3),
                                 probe=jtransport.MeasuredWanProbe())
    jtr = JTrainer(lambda p, b: jtransformer.loss_fn(p, jcfg, b),
                   lambda k: jtransformer.init_params(k, jcfg),
                   JTrainerConfig(n_pods=N_PODS, optimizer="sgd", lr=LR,
                                  sync=jsync.SyncConfig("asgd_ga", 2,
                                                        **W.ARM_SYNC)),
                   transport=jt)
    jstate = jtr.init_state(jax.random.key(0))
    losses = []
    for step, batch in enumerate(batches):
        jstate, metrics = jtr.train_step(
            jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        losses.append(np.asarray(metrics["loss_per_pod"]).tolist())
        jstate = jtr.maybe_sync(jstate, step)
        jt.tick(W.ARM_TICK_S)
    out = split["sim"]
    r0 = out["ranks"][0]
    np.testing.assert_allclose(r0["losses"], losses, rtol=LOSS_RTOL)
    rel = np.abs(np.subtract(r0["losses"], losses)) / np.abs(losses)
    print(f"[anchor] split sim run against the reference: losses within "
          f"{rel.max():.3g} relative")
    _flips_within("anchor", params=(out["params"],
                                    jax.tree.leaves(jstate.params)),
                  ef=(out["ef"], jstate.sync_state.ef_residual))
    assert r0["records"] == [dataclasses.astuple(r) for r in jt.records]
    assert r0["probe"] == jt.probe.estimator.bandwidth_mbps
