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
        _run(rank, job, out_file)
    finally:
        dist.destroy_process_group()


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
