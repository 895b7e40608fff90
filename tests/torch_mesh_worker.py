"""One rank of a multi-process mesh run of the port (gloo, CPU), for
``tests/test_torch_mesh.py``.

Started with the ``spawn`` method, so it imports neither JAX nor the test
module: the job (the arch, the sync config, the mesh shape, the whole
stacked parameters and batches) arrives in a file written by the parent,
and rank 0 writes what the parent compares.  The group's rendezvous is a
``FileStore`` next to the job file, never a port.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def _whole_rows(x, pods):
    """A placed, pod-split leaf -> every pod's rows, whole (all ranks)."""
    from repro_torch.sharding.rules import whole_local
    return pods.gather(whole_local(x))


def run(rank: int, world: int, job_file: str, out_file: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(job_file, weights_only=False)
    store = dist.FileStore(job_file + ".store", world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        if "syncs" in job:
            _rounds(rank, job, out_file)
        elif "prompt" in job:
            _serve(rank, job, out_file)
        else:
            _run(rank, job, out_file)
    finally:
        dist.destroy_process_group()


class _AllReduceBytes:
    """The bytes of every ``c10d.allreduce_`` posted in its scope (below
    DTensor: the local tensors)."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if str(func.overloadpacket) == "c10d.allreduce_":
                    outer.nbytes += sum(t.numel() * t.element_size()
                                        for t in args[0])
                return func(*args, **(kwargs or {}))

        self.nbytes = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _rounds(rank: int, job: dict, out_file: str) -> None:
    """Each sync config of ``job["syncs"]`` twice from the same placed
    state: the trainer's own rounds (``maybe_sync``), then every round
    through ``_gathered_round``, the path that gathers each leaf whole.
    Per run: the losses, the step counters, every parameter leaf whole,
    ``asp``'s significant fraction, and each rank's bytes shipped point to point and all-reduced
    (``c10d.allreduce_``) in each round beside its local shard bytes and a
    pod's whole row bytes of the parameters."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.core.sync import is_sync_step
    from repro_torch.launch import context as C
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import whole_local

    mesh = make_debug_mesh(*job["mesh"])
    out = {}
    for name, sync in job["syncs"].items():
        runs = {}
        for how in ("own", "gathered"):
            setup = C.make_train_setup(get_arch(job["arch"]), mesh,
                                       sync=sync, optimizer="sgd",
                                       lr=job["lr"], smoke=True,
                                       n_pods=job["n_pods"])
            tr = setup.trainer
            state = setup.place_state(tr.state_from_params(
                T.tree_map(lambda x: x.clone(), job["params"])))
            local = sum(x.to_local().numel() * x.element_size()
                        for x in T.leaves(state.params))
            row = sum(x[0].numel() * x.element_size()
                      for x in T.leaves(job["params"]))
            losses, sent, reduced, counters = [], [], [], []
            for step, batch in enumerate(job["batches"]):
                state, metrics = tr.train_step(state,
                                               setup.place_batch(batch))
                losses.append(metrics["loss_per_pod"].tolist())
                before = sum(tr.pods.sent.values())
                with _AllReduceBytes() as red:
                    if how == "own":
                        state = tr.maybe_sync(state, step)
                    elif is_sync_step(sync, step):
                        state, _ = tr._gathered_round(state)
                if is_sync_step(sync, step):
                    sent.append(sum(tr.pods.sent.values()) - before)
                    reduced.append(red.nbytes)
                counters.append((state.step, int(whole_local(
                    state.sync_state.steps_since_sync))))
            per_rank = [None] * dist.get_world_size()
            dist.all_gather_object(per_rank, (sent, reduced, local, row))
            runs[how] = {
                "losses": losses, "counters": counters, "ranks": per_rank,
                "significant_frac": whole_local(
                    state.sync_state.significant_frac),
                "params": T.tree_map(lambda x: _whole_rows(x, tr.pods),
                                     state.params)}
        out[name] = runs
    if rank == 0:
        tmp = out_file + ".tmp"
        torch.save(out, tmp)
        os.replace(tmp, out_file)


def _serve(rank: int, job: dict, out_file: str) -> None:
    """Greedy serving on the mesh under ``serve_rules``: the parameters
    placed by ``make_serve_setup``, a prefill of ``job["prompt"]`` into a
    cache of ``prompt + new`` positions (the cache's sequence over
    ``"model"``, the rows over ``("pod", "data")``), then ``job["new"]``
    decode steps.  Rank 0 writes every step's logits gathered whole, the
    tokens, and whether every cache leaf kept its placements."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.launch import context as C
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import whole_local

    mesh = make_debug_mesh(*job["mesh"])
    setup = C.make_serve_setup(get_arch(job["arch"]), mesh, smoke=True)
    cfg, fns = setup.cfg, setup.fns
    params = setup.place_params(T.tree_map(lambda x: x.clone(),
                                           job["params"]))
    prompt = job["prompt"]
    B, S = prompt.shape
    logits_seq, tokens = [], []
    with torch.no_grad(), setup.scope():
        batch = setup.place_batch({"tokens": prompt})
        logits, cache = fns.prefill(params, cfg, batch["tokens"],
                                    S + job["new"])
        want = setup.cache_sharding(cache, S + job["new"])
        for i in range(job["new"]):
            whole = whole_local(logits).reshape(B, -1)
            logits_seq.append(whole)
            tok = torch.argmax(whole, dim=-1).to(torch.int32)
            tokens.append(tok)
            step = setup.place_batch({
                "token": tok[:, None],
                "cache_pos": torch.tensor(S + i, dtype=torch.int32)})
            logits, cache = fns.decode_step(params, cfg, step["token"],
                                            cache, step["cache_pos"])
        logits_seq.append(whole_local(logits).reshape(B, -1))
        kept = [tuple(x.placements) == sh.placements(mesh)
                for x, sh in zip(T.leaves(cache), T.leaves(want))]
    if rank == 0:
        tmp = out_file + ".tmp"
        torch.save({"logits": logits_seq, "tokens": tokens, "kept": kept},
                   tmp)
        os.replace(tmp, out_file)


def _run(rank: int, job: dict, out_file: str) -> None:
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.launch import context as C
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import is_dtensor, whole_local

    mesh = make_debug_mesh(*job["mesh"])
    setup = C.make_train_setup(get_arch(job["arch"]), mesh, sync=job["sync"],
                               optimizer="sgd", lr=job["lr"], smoke=True,
                               n_pods=job["n_pods"])
    tr = setup.trainer
    state = setup.place_state(tr.state_from_params(job["params"]))
    placed = [is_dtensor(x) for x in T.leaves(state.params)]
    def pod_counts():
        return tr.pods.sends, tr.pods.all_reduces, tr.pods.all_gathers

    losses, rounds, steps, step_pod = [], [], [], []
    for step, batch in enumerate(job["batches"]):
        before = pod_counts()
        state, metrics = tr.train_step(state, setup.place_batch(batch))
        step_pod.append([a - b for a, b in zip(pod_counts(), before)])
        losses.append(metrics["loss_per_pod"].tolist())
        steps.append(state.step)
        before = pod_counts()
        comm = CommDebugMode()
        with comm:
            state = tr.maybe_sync(state, step)
        if len(tr.sync_seconds) > len(rounds):
            counts = {str(k): v for k, v in comm.get_comm_counts().items()}
            rounds.append({"pod": [a - b for a, b in
                                   zip(pod_counts(), before)],
                           "comm": counts})
    # the in-place updates keep every leaf's placements
    kept = [tuple(x.placements) == s.placements(tr.inpod)
            for x, s in zip(T.leaves(state.params),
                            T.leaves(setup.state_sharding.params))]
    sharded = sum(any(p.is_shard() for p in x.placements)
                  for x in T.leaves(state.params))
    params = T.tree_map(lambda x: _whole_rows(x, tr.pods), state.params)
    ef = _whole_rows(state.sync_state.ef_residual, tr.pods)
    out = {"losses": losses, "rounds": rounds, "step": state.step,
           "steps": steps, "step_pod": step_pod,
           "significant_frac": whole_local(
               state.sync_state.significant_frac),
           "params": params, "ef": ef, "placed": placed, "kept": kept,
           "sharded": sharded,
           "n_local": T.leaves(state.params)[0].shape[0]}
    if rank == 0:
        tmp = out_file + ".tmp"
        torch.save(out, tmp)
        os.replace(tmp, out_file)
