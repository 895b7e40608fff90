"""The port's mesh path in several processes (gloo on the CPU), against the
port's single-process run on the same converted parameters and batches.

Each case spawns one process per rank (``tests/torch_mesh_worker.py``),
which builds ``make_debug_mesh`` and ``make_train_setup``, places the state
and batches through ``TrainSetup`` and trains; rank 0 writes the losses, the
parameters and EF residual gathered whole, and the collectives of every
sync round.

- **(2, 1, 1), 2 processes**: one pod per rank, nothing split inside a pod.
  ``ama``, ``asgd_ga``, ``asp``, plain ``asgd`` and ``sma``: the losses,
  parameters and EF residual (and ASP's significant fraction) are
  bit-equal to the single-process run: the ring moves bytes, and the
  pod-axis sum of two pods is one commutative add.
- **(2, 2, 2), 8 processes**: granite ``ama`` (the reference's parity test,
  ``tests/test_dryrun_small.py``), qwen3-moe ``asgd_ga`` through the codec
  and mamba2 ``sma``, in-pod FSDP and tensor parallelism as DTensors.  The
  losses are within the reference's 5e-4 of the single-process run, the
  step count is 1 after one step, and the parameters are finite.
- **Collectives**: a ring round (``ama``, ``asgd_ga``, ``asp``) sends point
  to point over the pod group and gathers nothing over it (an ``asp``
  round all-reduces its count once); an ``sma`` round all-reduces
  over it, and an ``asgd`` step all-reduces its gradients (the seam's
  counts; on (2, 1, 1), where nothing is split inside a pod,
  ``CommDebugMode`` sees no all-gather at all in a ring round and sees the
  ``sma`` all-reduce).

Every process group has a 60 s timeout and every launch a time limit after
which its processes are killed, so a hang fails one test.  The rendezvous
is a ``FileStore`` under the test's ``tmp_path``, never a port.
"""
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtransformer

import torch_mesh_worker
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.models import transformer
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

N_PODS, PER_POD, SEQ, STEPS, LR = 2, 4, 16, 4, 0.05
LOSS_ATOL = 5e-4            # tests/test_dryrun_small.py's
LAUNCH_TIMEOUT = 240.0      # seconds for one multi-process run

SYNCS = {
    "ama": SyncConfig("ama", 2, compress_topk=0.05),
    "asgd_ga": SyncConfig("asgd_ga", 2, compress_topk=0.05,
                          quantize_int8=True, error_feedback=True),
    "sma": SyncConfig("sma", 2),
    "asp": SyncConfig("asp", 2, compress_topk=0.05),
    "asgd": SyncConfig("asgd", 2),
}
# the seam's all-reduces in one ring round: ASP's significance count
RING_ALL_REDUCES = {"ama": 0, "asgd_ga": 0, "asp": 1}


def _job(arch: str, strategy: str, mesh: tuple) -> dict:
    """The converted reference parameters stacked over the pods, and
    token batches from a seed."""
    jcfg = jget_arch(arch).smoke
    cfg = get_arch(arch).smoke
    one = convert.params_from_jax(
        jax.tree.map(np.asarray,
                     jtransformer.init_params(jax.random.key(0), jcfg)),
        cfg, device="cpu")
    params = T.tree_map(lambda x: torch.stack([x] * N_PODS), one)
    rng = np.random.default_rng(7)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (N_PODS, PER_POD, SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(STEPS)]
    return {"arch": arch, "sync": SYNCS[strategy], "lr": LR, "mesh": mesh,
            "n_pods": N_PODS, "params": params, "batches": batches}


def _single(job: dict):
    """The port's single-process run of the job: (losses, state)."""
    cfg = get_arch(job["arch"]).smoke
    trainer = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b), None,
                      TrainerConfig(n_pods=N_PODS, lr=LR, sync=job["sync"]),
                      device="cpu")
    state = trainer.state_from_params(
        T.tree_map(lambda x: x.clone(), job["params"]))
    losses = []
    for step, batch in enumerate(job["batches"]):
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss_per_pod"].tolist())
        state = trainer.maybe_sync(state, step)
    return losses, state


def _launch(job: dict, tmp_path) -> dict:
    """Run the job on ``prod(mesh)`` spawned ranks; rank 0's output."""
    world = int(np.prod(job["mesh"]))
    job_file, out_file = str(tmp_path / "job.pt"), str(tmp_path / "out.pt")
    torch.save(job, job_file)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_worker.run,
                         args=(r, world, job_file, out_file))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + LAUNCH_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks still running after " \
                     f"{LAUNCH_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    assert os.path.exists(out_file)
    return torch.load(out_file, weights_only=False)


def _ring_rounds(out: dict, strategy: str, nothing_in_pod: bool) -> None:
    assert len(out["rounds"]) == STEPS // 2
    for r in out["rounds"]:
        sends, all_reduces, all_gathers = r["pod"]
        assert sends > 0 and all_gathers == 0, r
        assert all_reduces == RING_ALL_REDUCES[strategy], r
        if nothing_in_pod:
            assert not any("all_gather" in k or "allgather" in k
                           for k in r["comm"]), r


@pytest.mark.parametrize("strategy", ["ama", "asgd_ga", "asp", "asgd"])
def test_two_pods_bit_equal_to_one_process(strategy, tmp_path):
    job = _job("granite-8b", strategy, (2, 1, 1))
    out = _launch(job, tmp_path)
    losses, state = _single(job)
    assert out["n_local"] == 1 and out["step"] == STEPS
    assert all(out["placed"]) and all(out["kept"])
    assert out["losses"] == losses
    for (path, got), want in zip(T.leaves_with_path(out["params"]),
                                 T.leaves(state.params)):
        assert torch.equal(got, want), path
    assert torch.equal(out["ef"], state.sync_state.ef_residual)
    assert torch.equal(out["significant_frac"],
                       state.sync_state.significant_frac)
    if strategy == "asgd":
        # no round: each step all-reduces every placed gradient leaf (the
        # metrics go by all-gather)
        assert out["rounds"] == []
        n_leaves = len(T.leaves(state.params))
        for sends, all_reduces, _ in out["step_pod"]:
            assert sends == 0 and all_reduces == n_leaves, out["step_pod"]
    else:
        _ring_rounds(out, strategy, nothing_in_pod=True)


def test_two_pods_sma_all_reduces(tmp_path):
    job = _job("granite-8b", "sma", (2, 1, 1))
    out = _launch(job, tmp_path)
    losses, state = _single(job)
    assert out["losses"] == losses
    for got, want in zip(T.leaves(out["params"]), T.leaves(state.params)):
        assert torch.equal(got, want)
    for r in out["rounds"]:
        sends, all_reduces, all_gathers = r["pod"]
        assert sends == 0 and all_reduces > 0 and all_gathers == 0, r
        assert r["comm"].get("c10d.allreduce_", 0) > 0, r


@pytest.mark.parametrize("arch,strategy", [
    ("granite-8b", "ama"),
    ("qwen3-moe-30b-a3b", "asgd_ga"),
    ("mamba2-1.3b", "sma"),
])
def test_debug_mesh_matches_one_process(arch, strategy, tmp_path):
    job = _job(arch, strategy, (2, 2, 2))
    out = _launch(job, tmp_path)
    losses, _ = _single(job)
    assert out["steps"][0] == 1 and out["step"] == STEPS
    # FSDP and tensor parallelism in the pod: leaves sharded, and their
    # placements kept through the steps and rounds
    assert all(out["placed"]) and all(out["kept"]) and out["sharded"] > 0
    diff = np.abs(np.array(out["losses"]) - np.array(losses)).max()
    assert diff < LOSS_ATOL, (out["losses"], losses)
    for leaf in T.leaves(out["params"]):
        assert bool(torch.isfinite(leaf).all())
    if strategy == "sma":
        for r in out["rounds"]:
            sends, all_reduces, all_gathers = r["pod"]
            assert sends == 0 and all_reduces > 0 and all_gathers == 0, r
    else:
        _ring_rounds(out, strategy, nothing_in_pod=False)


# a dense ``ama``, ``sma``, ``asgd_ga`` or ``asp`` round is elementwise
# across pods: on (2, 2, 2) each rank ships (or all-reduces) its own shard
# of every leaf; the codec keeps the round on leaves gathered whole
SHARD_SYNCS = {
    "ama": SyncConfig("ama", 2),
    "sma": SyncConfig("sma", 2),
    "asgd_ga": SyncConfig("asgd_ga", 2),
    "asp": SyncConfig("asp", 2),
    "codec": SYNCS["asgd_ga"],
}
ROUND_STEPS = 2             # one step, then a step and a round


@pytest.fixture(scope="module")
def shard_rounds(tmp_path_factory):
    """One 8-process launch: every config of ``SHARD_SYNCS`` run twice
    from the same state, through the trainer's own rounds and through
    ``_gathered_round`` (``tests/torch_mesh_worker.py``'s ``_rounds``)."""
    job = _job("granite-8b", "ama", (2, 2, 2))
    job["syncs"] = SHARD_SYNCS
    job["batches"] = job["batches"][:ROUND_STEPS]
    return _launch(job, tmp_path_factory.mktemp("rounds"))


@pytest.mark.parametrize("name", list(SHARD_SYNCS))
def test_split_pod_rounds_ship_own_shard(name, shard_rounds):
    own, gathered = shard_rounds[name]["own"], shard_rounds[name]["gathered"]
    rounds = ROUND_STEPS // 2
    # the losses, the step counters and every parameter leaf are bit-equal
    # to the whole-gather round on the same state
    assert own["losses"] == gathered["losses"]
    assert own["counters"] == gathered["counters"]
    for (path, got), want in zip(T.leaves_with_path(own["params"]),
                                 T.leaves(gathered["params"])):
        assert torch.equal(got, want), path
    for (sent, red, local, row), (g_sent, g_red, _, _) in zip(
            own["ranks"], gathered["ranks"]):
        # FSDP over "data" and tensor parallelism over "model": a rank
        # holds about a quarter of a pod's row (the norms are replicated)
        assert 3.9 < row / local <= 4.0, (row, local)
        if name in ("ama", "asgd_ga"):
            assert sent == [local] * rounds and g_sent == [row] * rounds
            assert red == g_red == [0] * rounds
        elif name == "sma":
            assert red == [local] * rounds and g_red == [row] * rounds
            assert sent == g_sent == [0] * rounds
        elif name == "asp":
            # each rank ships its own shard; its significance count (one
            # int64) is all-reduced over "data", then "model", then (one
            # f64) across pods, where the whole-gather round all-reduces
            # the pods' one f64 count
            assert sent == [local] * rounds and g_sent == [row] * rounds
            assert red == [8 + 8 + 8] * rounds and g_red == [8] * rounds
        else:
            # unchanged: the round gathers whole leaves either way
            assert sent == g_sent and red == g_red
            assert all(s > 0 for s in sent)
    assert torch.equal(own["significant_frac"],
                       gathered["significant_frac"])


# serving under ``serve_rules`` on (2, 2, 2): 8 rows over ("pod", "data"),
# the full cache's sequence over "model"; the decode step writes each row's
# K/V into the rank whose range of the sequence holds it and combines the
# ranks' softmax by all-reduce (``layers._decode_attend``), so its logits
# differ from one process's by the order of the sums: held within
# SERVE_RTOL of max|logit|, the greedy tokens equal
SERVE_ROWS, SERVE_PROMPT, SERVE_NEW = 8, 16, 4
SERVE_RTOL = 1e-5


def _serve_single(arch: str, params, prompt):
    from repro_torch.models.registry import get_model_fns

    cfg = get_arch(arch).smoke
    fns = get_model_fns(get_arch(arch).module)
    out, toks = [], []
    with torch.no_grad():
        logits, cache = fns.prefill(params, cfg, prompt,
                                    SERVE_PROMPT + SERVE_NEW)
        for i in range(SERVE_NEW):
            whole = logits.reshape(SERVE_ROWS, -1)
            out.append(whole)
            tok = torch.argmax(whole, dim=-1).to(torch.int32)
            toks.append(tok)
            logits, cache = fns.decode_step(params, cfg, tok[:, None], cache,
                                            SERVE_PROMPT + i)
        out.append(logits.reshape(SERVE_ROWS, -1))
    return out, toks


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b"])
def test_serving_on_mesh_matches_one_process(arch, tmp_path):
    job = _job(arch, "ama", (2, 2, 2))
    params = T.tree_map(lambda x: x[0].clone(), job["params"])
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(
        0, get_arch(arch).smoke.vocab_size,
        (SERVE_ROWS, SERVE_PROMPT)).astype(np.int32))
    out = _launch({"arch": arch, "mesh": (2, 2, 2), "params": params,
                   "prompt": prompt, "new": SERVE_NEW}, tmp_path)
    logits, tokens = _serve_single(arch, params, prompt)
    assert all(out["kept"]) and out["kept"]
    assert [t.tolist() for t in out["tokens"]] == [t.tolist() for t in tokens]
    for got, want in zip(out["logits"], logits):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= SERVE_RTOL * scale
