"""One rank of a multi-process mesh run of the port (gloo, CPU), for
``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh_transports.py``
(whose arms, :func:`build_arm` and :func:`drive`, live here so that the
one-process run builds and drives them the same way).

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
        if "elastic" in job:
            _elastic(rank, job, out_file)
        elif "arms" in job:
            _transports(rank, job, out_file)
        elif "syncs" in job:
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


# ------------------------------------------------ transports on a split axis

#: the codec of every transport arm: int8 + EF, top-k 0.05, three buckets,
#: two chunks where a bucket has the blocks; a round every 2 steps
ARM_SYNC = dict(compress_topk=0.05, quantize_int8=True, error_feedback=True,
                overlap_chunks=2, bucket_policy="layer-class")
ARM_TICK_S = 1.5            # sim seconds a step: the cliff lands in round 2
UNEQUAL_FAST_S, UNEQUAL_SLOW_S = 0.05, 0.5   # "unequal": belief, rank 1's hop


def build_arm(name: str, rank: int = 0):
    """Arm ``name`` -> (sync config, transport, streaming controller or
    None, the config a retune between the rounds goes to or None).  Every
    rank builds the same arm, except that in ``"unequal"`` rank 1's
    measured hop is slow (its ``emulate_mbps`` is set by :func:`drive`)."""
    import dataclasses

    from repro_torch.core.autotune import StreamingShipController
    from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
    from repro_torch.core.sync import SyncConfig
    from repro_torch.core.topology import HierarchicalTransport, TopologySpec
    from repro_torch.core.transport import (MeasuredWanProbe, MeshTransport,
                                            SimTransport)
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    sync = SyncConfig("asgd_ga", 2, **ARM_SYNC)
    trace = BandwidthTrace((0.0, 3.0), (100.0, 2.0))

    def sim(wan=WANConfig(fluctuation=0.2, seed=3)):
        return SimTransport(trace, wan, probe=MeasuredWanProbe())

    def stream_ctl(transport):
        # the guard never blocks: the smoke model's EF ratio is not the
        # subject here
        return StreamingShipController(
            sync, 1.0, cliff_ratio=2.0, ef_guard=1.0, escalate_margin=1.0,
            probe_est=transport.probe.estimator)

    if name == "sim":
        return sync, sim(), None, None
    if name == "mesh":
        return sync, MeshTransport(probe=MeasuredWanProbe()), None, None
    if name == "chaos":
        plan = FaultPlan((FaultEvent("fail", 1, pod=0),
                          FaultEvent("corrupt", 1, pod=0),
                          FaultEvent("crash", 3, pod=1)))
        return sync, ChaosTransport(sim(), plan), None, None
    if name == "stream":
        t = sim(WANConfig(latency_s=0.0, fluctuation=0.0))
        return sync, t, stream_ctl(t), None
    if name == "hier":
        spec = TopologySpec.from_regions(["us", "eu"], kind="ring")
        return sync, HierarchicalTransport(spec, trace,
                                           wan=WANConfig(seed=0),
                                           probe=MeasuredWanProbe()), \
            None, None
    if name == "retune":
        return sync, sim(), None, dataclasses.replace(sync,
                                                      value_dtype="int4")
    if name == "unequal":
        t = MeshTransport(probe=MeasuredWanProbe())
        return sync, t, stream_ctl(t), None
    raise ValueError(name)


def drive(trainer, state, batches, rank: int = 0, place=lambda b: b):
    """Train ``batches`` with ``trainer`` (one step, then a round where due;
    a sim clock ticks ``ARM_TICK_S`` a step); a retune (``trainer.
    retune_to``) goes in after the first round.  Returns (trainer, state,
    what every rank observed on the host: losses, records, billed and
    probed seconds, the fault outcomes, the streaming decisions)."""
    import dataclasses

    from repro_torch.sharding.rules import whole_local

    t = trainer.transport
    if getattr(trainer, "unequal", False):
        # the belief a fast hop meets; rank 1's emulated hop takes
        # UNEQUAL_SLOW_S for the first chunk, a cliff, and the others none
        first = trainer.chunk_mb(state)[sorted(trainer.chunk_mb(state))[0]][0]
        t.probe.estimator.observe(first * 8.0 / UNEQUAL_FAST_S)
        if rank == 1:
            t.emulate_mbps = first * 8.0 / UNEQUAL_SLOW_S
    losses, mesh_after = [], None
    retune_to = getattr(trainer, "retune_to", None)
    for step, batch in enumerate(batches):
        state, metrics = trainer.train_step(state, place(batch))
        losses.append(metrics["loss_per_pod"].tolist())
        state = trainer.maybe_sync(state, step)
        if hasattr(t, "tick"):
            t.tick(ARM_TICK_S)
        if retune_to is not None and len(trainer.sync_seconds) == 1:
            mesh_before = trainer.mesh
            trainer, state = trainer.retune(state, retune_to)
            mesh_after = trainer.mesh is mesh_before
            retune_to = None
    stream = trainer.stream
    seen = {
        "losses": losses,
        "records": [dataclasses.astuple(r) for r in t.records],
        "probe": t.probe.estimator.bandwidth_mbps,
        "outcomes": list(getattr(t, "outcomes", [])),
        "retries": getattr(t, "retries", 0),
        "degraded": getattr(t, "degraded_rounds", 0),
        "stream_rounds": [dict(r) for r in t.stream_rounds],
        "decisions": [] if stream is None else list(stream.decisions),
        "stream_retunes": trainer.stream_retunes,
        "rounds": len(trainer.sync_seconds),
        "tier": whole_local(state.sync_state.tier).tolist(),
        "successor_keeps_mesh": mesh_after,
    }
    return trainer, state, seen


def _transports(rank: int, job: dict, out_file: str) -> None:
    """Every arm of ``job["arms"]`` on the mesh through
    ``make_train_setup``, the transport bound by the trainer; then, on
    (2, 1, 1), the pod seam's units (:func:`_pod_units`):
    ``hierarchical_average`` of 4 pods over the 2 ranks, the successor
    trainer's mesh, the chaos transport's corrupted row, and a verifying
    ship's checksums.  Rank 0 writes each arm's parameters, gradient
    accumulator and EF residual gathered whole, and every rank's host
    observations."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.launch import context as C
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(*job["mesh"])
    out = {}
    for name in job["arms"]:
        sync, transport, stream, retune_to = build_arm(name, rank)
        setup = C.make_train_setup(get_arch(job["arch"]), mesh, sync=sync,
                                   optimizer="sgd", lr=job["lr"], smoke=True,
                                   n_pods=job["n_pods"], transport=transport,
                                   stream=stream)
        tr = setup.trainer
        tr.retune_to, tr.unequal = retune_to, name == "unequal"
        state = setup.place_state(tr.state_from_params(
            T.tree_map(lambda x: x.clone(), job["params"])))
        tr, state, seen = drive(tr, state, job["batches"], rank,
                                setup.place_batch)
        seen["sends"] = tr.pods.sends
        seen["agreements"] = tr.pods.agreements
        if name == "retune":
            # where a shrink to 1 pod would leave this rank's rows: the
            # reconfiguration plans on the split pod axis
            seen["reconfigure"] = tr.new_rows(1)
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, seen)
        out[name] = {
            "ranks": per_rank,
            "params": T.tree_map(lambda x: _whole_rows(x, tr.pods),
                                 state.params),
            "ga": T.tree_map(lambda x: _whole_rows(x, tr.pods),
                             state.sync_state.ga_buffer),
            "ef": _whole_rows(state.sync_state.ef_residual, tr.pods)}
    if "units" in job:
        out["units"] = _pod_units(rank, job["units"], mesh, job["arch"])
    if rank == 0:
        tmp = out_file + ".tmp"
        torch.save(out, tmp)
        os.replace(tmp, out_file)


def _pod_units(rank: int, units: dict, mesh, arch: str) -> list:
    """The pod seam alone over the world group (2 ranks), each unit on
    its own (an error is kept as its value, so that one unit's failure
    leaves the others to run): per rank, what each unit produced on its
    rows."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
    from repro_torch.core.sync import (PodAxis, SyncConfig,
                                       _encode_bucket, hierarchical_average,
                                       ship_sync_payloads)
    from repro_torch.core.transport import SimTransport
    from repro_torch.core.wan import BandwidthTrace
    from repro_torch.launch import context as C

    res = {}

    def unit(name, fn):
        try:
            res[name] = fn()
        except Exception as e:  # noqa: BLE001 — the test reads it
            res[name] = f"{type(e).__name__}: {e}"

    # hierarchical_average: 4 pods, 2 a rank; its all-reduces a call
    pods4 = PodAxis(4, dist.group.WORLD)
    mine = T.tree_map(pods4.rows, units["tree"])

    def hier(groups, inter):
        before = pods4.all_reduces
        out = T.tree_map(pods4.gather, hierarchical_average(
            mine, groups, inter, pods=pods4))
        return {"tree": out, "all_reduces": pods4.all_reduces - before}

    for key, (groups, inter) in units["hier"].items():
        unit(f"hier {key}", lambda g=groups, i=inter: hier(g, i))

    # the trainer a retune or reconfigure builds keeps the mesh and axis
    def successor():
        tr = C.make_train_setup(get_arch(arch), mesh,
                                sync=SyncConfig("asgd_ga", 2, **ARM_SYNC),
                                smoke=True, n_pods=2).trainer
        nxt = tr._successor(tr.cfg)
        return nxt.mesh is mesh and nxt.pods is tr.pods

    unit("successor", successor)

    # one pod a rank: the chunks of 2 pods, this rank's row
    pods = PodAxis(2, dist.group.WORLD)
    codec = SyncConfig("asgd_ga", 2, **ARM_SYNC).for_bucket("all")
    flat = torch.randn(2, 3 * codec.codec_block,
                       generator=torch.Generator().manual_seed(5))
    chunks = tuple(type(c)(*(pods.rows(p) for p in c))
                   for c in _encode_bucket(codec, flat, False)[0])
    inline = pods.ring.ship_bucket("all", chunks, 1)

    # the corrupted receiver row is global: pod 0's peer, pod 1, on rank 1
    def corrupt():
        chaos = ChaosTransport(
            SimTransport(BandwidthTrace((0.0,), (100.0,))),
            FaultPlan((FaultEvent("corrupt", 0, pod=0),)), tolerate=False)
        chaos.bind(pods)
        chaos.begin_round(0)
        hit = chaos.ship_bucket("all", chunks, 1)
        rest = (torch.equal(hit[0].q, inline[0].q)
                and torch.equal(hit[0].idx, inline[0].idx)
                and all(torch.equal(a, b)
                        for ca, cb in zip(hit[1:], inline[1:])
                        for a, b in zip(ca, cb)))
        return {"flipped": not torch.equal(hit[0].scales, inline[0].scales),
                "rest_equal": rest}

    unit("corrupt", corrupt)

    # a verifying host-seam ship over the split ring: the receiver's rows
    # are held to the sender checksums gathered over the pod group
    class Verified:
        in_graph, verify_checksums = False, True

        def __init__(self):
            self.pods = pods

        def ship_bucket(self, name, bchunks, shift, payload_mb=0.0):
            return pods.ring.ship_bucket(name, bchunks, shift)

    def verified():
        before = pods.all_gathers
        shipped = ship_sync_payloads(SyncConfig("asgd_ga", 2),
                                     {"all": chunks}, Verified())
        equal = all(torch.equal(a, b)
                    for ca, cb in zip(shipped["all"], inline)
                    for a, b in zip(ca, cb))
        return {"equal": equal, "crc_gathers": pods.all_gathers - before}

    unit("verified", verified)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, res)
    return per_rank


# -------------------------------------------- elastic reconfiguration

#: the elastic runs' sync round: the codec arms' config, a round every 2
#: steps; the transport bills without fluctuation (a pod that idles misses
#: rounds, and every rank's billing depends on the clock alone) and crashes
#: pod 1 in the round at ``ELASTIC_CRASH``
ELASTIC_STEPS = 8
ELASTIC_CRASH = 7
ELASTIC_TRACE = ((0.0, 3.0), (100.0, 2.0))


def elastic_transport():
    from repro_torch.core.faults import ChaosTransport, FaultEvent, FaultPlan
    from repro_torch.core.transport import SimTransport
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    sim = SimTransport(BandwidthTrace(*ELASTIC_TRACE),
                       WANConfig(fluctuation=0.0, seed=3))
    return ChaosTransport(sim, FaultPlan((FaultEvent("crash", ELASTIC_CRASH,
                                                     pod=1),)))


class Plan:
    """A reconfiguration plan as ``apply_reconfig`` reads one."""

    def __init__(self, n_new, keep, sync):
        from types import SimpleNamespace

        self.is_noop = False
        self._t = (keep, n_new)
        self.new = SimpleNamespace(request=SimpleNamespace(sync=sync))

    def pod_transition(self):
        return self._t


class ElasticRun:
    """One rank's elastic run (or the whole run in one process, with
    ``setup=None``): steps, placed saves and restores, an async snapshot,
    reconfigurations through ``LiveMigrator`` and ``Trainer.reconfigure``.
    ``rec`` holds what the host saw; ``trees`` the states gathered whole
    (every pod's rows on every live rank) at named points."""

    def __init__(self, tr, state, batches, out_dir, setup=None, engine=None):
        from repro_torch.training.trainer import LiveMigrator

        self.tr, self.state, self.batches = tr, state, batches
        self.setup, self.engine, self.out_dir = setup, engine, out_dir
        self.first_mesh = tr.mesh
        self.migrator = LiveMigrator(engine) if engine is not None else None
        self.rec = {"losses": {}, "saves": {}}
        self.trees = {}

    @property
    def live(self):
        return self.state is not None

    def place(self, batch):
        n = self.tr.cfg.n_pods
        batch = {k: v[:n] for k, v in batch.items()}
        if self.setup is None:
            return batch
        return self.setup.place_batch(batch, self.tr)

    def steps(self, lo, hi):
        t = self.tr.transport
        for step in range(lo, hi):
            if self.live:
                self.state, metrics = self.tr.train_step(
                    self.state, self.place(self.batches[step]))
                self.rec["losses"][step] = metrics["loss_per_pod"].tolist()
                self.state = self.tr.maybe_sync(self.state, step)
            t.tick(ARM_TICK_S)

    def save(self, name):
        """Save the state (placed: every rank); the manifest's commit
        record."""
        from repro_torch.checkpoint import checkpoint as ckpt

        d = os.path.join(self.out_dir, name)
        self.tr.save_state(d, self.state)
        m = ckpt.load_manifest(d)
        self.rec["saves"][name] = (m["arrays_bytes"], m["arrays_crc32"],
                                   m["shapes"])
        return d

    def restore(self, d):
        """Restore a save onto this trainer's placements, held to the live
        state leaf by leaf on this rank; continue from the restored
        state."""
        if self.setup is not None and self.setup.trainer is self.tr:
            got, step = self.setup.restore_state(d)
        else:
            got, step = self.tr.restore_state(d, self.state)
        self.rec["restore_equal"] = self.equal(got, step)
        self.state = got

    def equal(self, got, step):
        """Whether a restored ``(state, step)`` is the live state, leaf by
        leaf on this rank (placements included)."""
        from repro_torch import tree as T
        from repro_torch.sharding.rules import local_part

        return step == self.state.step and all(
            (torch.equal(local_part(a), local_part(b))
             and type(a) is type(b)) if isinstance(a, torch.Tensor)
            else a == b
            for a, b in zip(T.leaves(got), T.leaves(self.state)))

    def snapshot(self):
        """An async snapshot of the state; its manifest's commit record."""
        from repro_torch.checkpoint import checkpoint as ckpt

        parts = (self.tr.leaf_parts(self.state) if self.setup is not None
                 else None)
        self.engine.snapshot(self.state, self.state.step, parts=parts)
        self.engine.wait()
        _, d = self.engine.last_durable()
        m = ckpt.load_manifest(d)
        self.rec["snapshot"] = (m["arrays_bytes"], m["arrays_crc32"])

    def leave(self, n_new, keep):
        """Pods leave at the barrier, staged by ``LiveMigrator``."""
        like = self.setup.abstract_state if self.setup is not None else None
        self.migrator.stage(self.state, n_new, keep,
                            trainer=self.tr if self.setup else None,
                            like=like)
        self.tr, self.state, _ = self.migrator.reconcile(
            self.tr, self.state, Plan(n_new, keep, self.tr.cfg.sync))
        staged = self.migrator.last_staged
        from repro_torch import tree as T
        self.rec["staged"] = (None if staged is None else
                              [list(x.shape) for x in
                               T.leaves(staged["state"].params)])
        self.rec["migrator_errors"] = [repr(e) for e in self.migrator.errors]

    def join(self, n_new, keep=None):
        self.tr, self.state = self.tr.reconfigure(self.state, n_new, keep)

    def gather(self, name, state=None):
        """Every pod's rows of the parameters, the gradient accumulator
        and the EF residual, whole, on every live rank."""
        from repro_torch import tree as T

        state = self.state if state is None else state
        if state is None:
            return
        pods = self.tr.pods

        def rows(x):
            # a copy: whole in one process, the rows are the live leaf,
            # which the next step updates in place
            return _whole_rows(x, pods).clone()
        self.trees[name] = {
            "params": T.tree_map(rows, state.params),
            "ga": T.tree_map(rows, state.sync_state.ga_buffer),
            "ef": rows(state.sync_state.ef_residual)}

    def host(self):
        import dataclasses

        t = self.tr.transport
        self.rec.update(
            records=[dataclasses.astuple(r) for r in t.records],
            outcomes=list(t.outcomes), retries=t.retries,
            degraded=t.degraded_rounds, n_pods=self.tr.cfg.n_pods,
            live=self.live)
        return self.rec


def elastic_schedule(run: "ElasticRun", whole_dir=None) -> None:
    """The (3, 1, 1) schedule: two steps and a round on 3 pods; a placed
    save restored bit-equal; an async snapshot; pod 1 leaves at the
    barrier (``keep=(0, 2)``), staged; (split) the whole save of step 2
    restored placed, resized to 2 pods; two steps and a round on 2 pods
    and a save of the 2-pod state; pod 1 rejoins, two steps and a round on
    3 pods; two more with the chaos round (pod 1 crashed); then
    ``keep=(2, 0)``."""
    run.steps(0, 2)
    run.restore(run.save("placed"))
    run.snapshot()
    run.leave(2, (0, 2))
    run.rec["groups"] = [_groups()]
    run.gather("left")
    if whole_dir is not None and run.live:
        got, _ = run.tr.restore_state(whole_dir, run.state, pod_resize="mean")
        run.gather("whole_resized", got)
    run.steps(2, 4)
    if run.live:
        run.save("before_join")
    run.join(3)
    run.rec["mesh_again"] = run.tr.mesh is run.first_mesh
    run.gather("joined")
    run.steps(4, 6)
    run.gather("mid")
    run.steps(6, ELASTIC_STEPS)
    run.gather("final")
    run.host()
    run.join(2, (2, 0))
    run.rec["groups"].append(_groups())
    run.gather("swapped")
    run.rec["swap_sent"] = getattr(run.tr, "reconfig_sent", None)


def _groups() -> int:
    """The process groups this rank holds."""
    return len(dist.distributed_c10d._world.pg_map)


def deep_schedule(run: "ElasticRun") -> None:
    """The (2, 2, 2) schedule: two steps and a round; the state gathered
    whole and saved unplaced (rank 0) beside its placed save, which is
    restored bit-equal, as is the unplaced one; an async snapshot beside
    its blocking equivalent, and restored placed by ``restore_last``,
    bit-equal; 2 -> 1 pod, two steps; 1 -> 2 (the rows gathered), two steps
    and a round."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.async_engine import blocking_equivalent
    from repro_torch.sharding.rules import whole_local

    run.steps(0, 2)
    tr, state = run.tr, run.state
    whole = T.tree_map(lambda x, st: _whole_rows(x, tr.pods) if st
                       else whole_local(x) if isinstance(x, torch.Tensor)
                       else x, state, _stacked(tr, state))
    gathered = os.path.join(run.out_dir, "gathered")
    if dist.get_rank() == 0:
        ckpt.save(gathered, whole, step=state.step)
    dist.barrier()
    run.restore(run.save("placed"))
    run.rec["placed_restore_equal"] = run.rec["restore_equal"]
    run.restore(gathered)
    run.snapshot()
    run.rec["restore_last_equal"] = run.equal(*run.engine.restore_last(
        run.state, parts=tr.leaf_parts(run.state)))
    d = blocking_equivalent(run.state, run.state.step,
                            os.path.join(run.out_dir, "blocking"),
                            parts=tr.leaf_parts(run.state),
                            group=tr.io_group())
    m = ckpt.load_manifest(d)
    run.rec["blocking"] = (m["arrays_bytes"], m["arrays_crc32"])
    run.join(1, (0,))
    run.steps(2, 4)
    run.join(2)
    run.gather("rejoined")
    run.steps(4, 6)
    run.gather("final")
    run.host()


def _elastic(rank: int, job: dict, out_file: str) -> None:
    """Rank ``rank`` of an elastic launch: ``job["elastic"]`` names the
    schedule ("split": (3, 1, 1), :func:`elastic_schedule`; "deep":
    (2, 2, 2), :func:`deep_schedule`; "two": one step and a save at
    (2, 1, 1); "one": 2 -> 3 -> 2 pods on a one-rank mesh).  Rank 0 writes every rank's host record and its gathered
    trees; the saves are under ``job["dir"]``."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
    from repro_torch.configs import get_arch
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch import context as C
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(*job["mesh"])
    sync = SyncConfig("asgd_ga", 2, **ARM_SYNC)
    kind = job["elastic"]
    setup = C.make_train_setup(get_arch(job["arch"]), mesh, sync=sync,
                               optimizer="sgd", lr=job["lr"], smoke=True,
                               n_pods=job["n_pods"],
                               transport=elastic_transport())
    tr = setup.trainer
    state = setup.place_state(tr.state_from_params(
        T.tree_map(lambda x: x.clone(), job["params"])))
    out = {"trees": {}}
    if kind == "one":
        # every pod on the one rank's mesh: the resize runs on the local
        # shards and the mesh stays
        run = ElasticRun(tr, state, job["batches"], job["dir"], setup)
        run.steps(0, 2)
        run.join(3)
        run.steps(2, 4)
        run.join(2, (2, 0))
        run.gather("final")
        rec, out["trees"] = {"kept_mesh": run.tr.mesh is mesh}, run.trees
    elif kind == "two":
        # one step, then the placed save (the parent holds it to the
        # one-process save of the same step)
        state, _ = tr.train_step(state, setup.place_batch(
            {k: v[:2] for k, v in job["batches"][0].items()}))
        tr.save_state(os.path.join(job["dir"], "placed"), state)
        rec = {}
    else:
        engine = AsyncCheckpointEngine(os.path.join(job["dir"], "snaps"),
                                       keep=2)
        engine.bind(tr.mesh_ranks)
        run = ElasticRun(tr, state, job["batches"], job["dir"], setup,
                         engine)
        if kind == "split":
            elastic_schedule(run, job.get("whole_dir"))
            # a pod axis of 2 pods a rank: the reconfiguration refuses
            many = C.make_train_setup(get_arch(job["arch"]), mesh, sync=sync,
                                      smoke=True, n_pods=6).trainer
            try:
                many.reconfigure(None, 5)
                run.rec["many_pods"] = None
            except ValueError as e:
                run.rec["many_pods"] = str(e)
        else:
            deep_schedule(run)
        engine.close()
        rec, out["trees"] = run.rec, run.trees
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, rec)
    if rank == 0:
        out["ranks"] = per_rank
        tmp = out_file + ".tmp"
        torch.save(out, tmp)
        os.replace(tmp, out_file)


def _stacked(tr, state):
    from repro_torch.training.trainer import pod_stacked
    return pod_stacked(tr.cfg.sync, state)
