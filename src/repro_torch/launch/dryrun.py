"""Multi-pod dry run: trace every (arch x shape x mesh) step on a fake
process group, and count what one rank does.

Counterpart of ``repro/launch/dryrun.py``: the proof that the distribution
config is coherent without the hardware.  One process poses as rank 0 of a
fake group (``torch.testing``'s ``FakeProcessGroup``) of ``prod(mesh
shape)`` ranks, 512 for the multi-pod ``(2, 16, 16)`` mesh and 256 for the
single-pod ``(16, 16)``, and builds the production mesh (``launch/mesh.py``)
over device type ``"cpu"``.  Every tensor is a fake tensor
(``FakeTensorMode``): nothing is allocated and no device is used, like the
reference's 512 placeholder host devices.  So every op of
``repro_torch.kernels.ops`` takes its plain path, as the reference's ops do
when it lowers on host devices: the dry run counts the plain path.  It has
no device option and no fallback.

- A **training** shape (``lower_train``): ``make_train_setup`` builds the
  trainer on the mesh; ``Trainer._train_step`` runs once on a fake batch
  from ``shapes.train_batch_specs`` and ``Trainer._sync_round`` once after
  it, the counterparts of the reference's ``_train_step_impl`` and
  ``_sync_step_impl``.  (``train_step`` and ``maybe_sync`` read values on
  the host, which a fake tensor refuses.)
- A **serving** shape (``lower_prefill``, ``lower_decode``):
  ``make_serve_setup`` places the parameters under ``serve_rules`` (one
  replica a pod, FSDP over ``"data"``, tensor parallel over ``"model"``),
  the request batch over ``("pod", "data")`` and a decode cache by
  ``cache_logical_axes`` (a full cache's sequence over ``"model"``); the
  step is ``prefill`` of the prompt into a cache of ``seq_len`` positions
  (``encdec.forward`` for an encoder-decoder), or one ``decode_step``.  No
  sync step.

For each step, on this rank's local tensors (below DTensor):

- ``collectives``: bytes (each op's result) and counts by the reference's
  five kinds, from the ``c10d`` and functional-collective ops posted, plus
  ``PodAxis``'s own point-to-point ring ships, filed as
  ``collective-permute``.  A collective crosses pods when its group's ranks
  lie in more than one pod (pod = rank // (n_devices / n_pods)), so no byte
  is of unknown pod;
- ``memory``: the step's arguments' local bytes as
  ``argument_size_in_bytes``, the outputs' as ``output_size_in_bytes`` (of
  which ``alias_size_in_bytes`` share an argument's storage: a train step
  updates the state, a decode step the cache, in place), and the peak of
  the bytes of storages created during the step and alive at once as
  ``temp_size_in_bytes``;
- ``cost``: ``flops`` of the matrix products (``torch.utils.flop_counter``'s
  registry) and ``bytes accessed``, the input and output bytes of every
  op that is not a view or a collective.

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
with the reference's keys.  The fake group is the process's default group:
run a dry run in a process of its own (the CLI does).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh multi_pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \\
      --shape long_500k --mesh multi_pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 6 \\
      --out-dir DIR    # every arch x shape x mesh, each in a process of
                       # its own, 6 at a time; prints a table row a record
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, Arch, get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import context as C
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.launch.shapes import (INPUT_SHAPES, InputShape,
                                       decode_specs, prefill_specs,
                                       shape_supported, train_batch_specs)
from repro_torch.models import encdec
from repro_torch.sharding.rules import is_dtensor

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the collective ops a step posts (``c10d`` and the functional
# collectives, with or without autograd), by the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd")
# posted without bytes of their own; ``PodAxis`` counts its sends itself
_NOT_COUNTED = ("wait_tensor", "_wrap_tensor_autograd", "send", "recv_")
_MESHES = ("single_pod", "multi_pod")
_RANK = 0                   # the rank of the fake group this process poses as


def _combine(k1: float, k2: float, n_groups: int) -> float:
    """The reference's extrapolation: per-group cost ``k2 - k1``, the rest
    fixed, summed over ``n_groups`` groups."""
    body = max(k2 - k1, 0.0)
    fixed = max(k1 - body, 0.0)
    return fixed + n_groups * body


def _empty_collectives() -> Dict[str, Any]:
    return {"bytes_by_kind": {k: 0 for k in _COLLECTIVES},
            "counts_by_kind": {k: 0 for k in _COLLECTIVES},
            "total_bytes": 0, "cross_pod_bytes": 0,
            "cross_pod_unknown_bytes": 0}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _Tracer(TorchDispatchMode):
    """Runs every op on fake tensors and, between :meth:`begin` and
    :meth:`end`, counts this rank's local ops (the module's docstring).

    It sits above DTensor: an op on DTensors is handed back to DTensor
    (``NotImplemented``), whose local ops then reach this mode on local
    tensors.  DTensor's own bookkeeping is not counted: its index
    arithmetic on plain tensors runs on real tensors (a fake tensor
    refuses to be read on the host), and its output-shape propagation on
    fakes of another fake mode runs there.  Everything else runs under
    this mode's fake mode."""

    def __init__(self, n_devices: int, n_pods: int):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.fake = FakeTensorMode(allow_non_fake_inputs=True)
        self.per_pod = n_devices // max(n_pods, 1)
        self.depth = 0
        self.counting = False
        self._ranks: Dict[Any, tuple] = {}

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.depth:
                return NotImplemented
            self.depth += 1
            try:
                with self:
                    return func(*args, **kwargs)
            finally:
                self.depth -= 1
        operands = _tensors((args, kwargs))
        fakes = [t for t in operands if isinstance(t, FakeTensor)]
        if (self.depth and not fakes) or any(t.fake_mode is not self.fake
                                             for t in fakes):
            # DTensor's own work: index arithmetic on real tensors, or its
            # output shapes from global-shape fakes of a mode of its own
            return func(*args, **kwargs)
        with self.fake:
            out = func(*args, **kwargs)
        if self.counting:
            self._count(func, args, kwargs, operands, out)
        return out

    # ------------------------------------------------------------ counting
    def begin(self, args, pods=None) -> None:
        """Count from here: ``args`` (a tree of placed or plain tensors)
        are the step's arguments; ``pods`` its pod axis (a training step's
        ``PodAxis``, whose ring ships are counted; None for a serving
        step, which has none)."""
        self.coll = _empty_collectives()
        self.flops = 0
        self.bytes_accessed = 0
        self._args = self._locals(args)
        # the arguments' storages, held so that their keys stay theirs
        self._arg_storages = {
            x.untyped_storage()._cdata: x.untyped_storage()
            for x in (t.to_local() if is_dtensor(t) else t
                      for t in T.leaves(args)
                      if isinstance(t, torch.Tensor))}
        self._live: Dict[int, tuple] = {}
        self.live_bytes = self.peak_bytes = 0
        self._pods = pods
        if pods is not None:
            self._sends, self._sent = pods.sends, dict(pods.sent)
        self.counting = True

    def end(self, outputs) -> Dict[str, Any]:
        """Stop counting -> the step's ``collectives``, ``memory`` and
        ``cost`` records (``outputs``: what the step returned)."""
        self.counting = False
        pods = self._pods
        n_sends = pods.sends - self._sends if pods is not None else 0
        if n_sends:
            kind = "collective-permute"
            self.coll["counts_by_kind"][kind] += n_sends
            for peer, n in pods.sent.items():
                n -= self._sent.get(peer, 0)
                self.coll["bytes_by_kind"][kind] += n
                if peer // self.per_pod != _RANK // self.per_pod:
                    self.coll["cross_pod_bytes"] += n
        self.coll["total_bytes"] = sum(self.coll["bytes_by_kind"].values())
        outs = self._locals(outputs)
        memory = {
            "argument_size_in_bytes": sum(self._args.values()),
            "output_size_in_bytes": sum(outs.values()),
            "alias_size_in_bytes": sum(n for k, n in outs.items()
                                       if k[0] in self._arg_storages),
            "temp_size_in_bytes": self.peak_bytes,
        }
        self._args, self._arg_storages, self._live = {}, {}, {}
        return {"collectives": self.coll, "memory": memory,
                "cost": {"flops": float(self.flops),
                         "bytes accessed": float(self.bytes_accessed)}}

    @staticmethod
    def _locals(tree) -> Dict[tuple, int]:
        """``{(storage key, offset, shape): bytes}`` of the local tensors of
        a tree of placed or plain tensors: each tensor's own bytes, once
        (a leaf placed by rows may view a storage that holds more)."""
        out = {}
        for x in T.leaves(tree):
            if not isinstance(x, torch.Tensor):
                continue
            if is_dtensor(x):
                x = x.to_local()
            key = (x.untyped_storage()._cdata, x.storage_offset(),
                   tuple(x.shape))
            out[key] = _nbytes(x)
        return out

    def _group_ranks(self, group) -> tuple:
        import torch.distributed as dist

        if isinstance(group, str):
            name = group
        else:
            # a c10d op carries the group boxed as a script object
            if not isinstance(group, dist.ProcessGroup):
                group = dist.ProcessGroup.unbox(group)
            name = group.group_name
        if name not in self._ranks:
            pg = dist.distributed_c10d._resolve_process_group(name)
            self._ranks[name] = tuple(dist.get_process_group_ranks(pg))
        return self._ranks[name]

    def _count(self, func, args, kwargs, operands, out) -> None:
        ns, _, name = str(func.overloadpacket).partition(".")
        results = _tensors(out)
        if ns in _COLLECTIVE_NAMESPACES:
            if name in _NOT_COUNTED:
                return
            if name not in _KINDS:
                raise NotImplementedError(
                    f"the dry run has no kind for collective {func}")
            kind = _KINDS[name]
            named = dict(zip((a.name for a in func._schema.arguments), args))
            named.update(kwargs)
            group = named.get("group_name", named.get("process_group"))
            ranks = self._group_ranks(group)
            n = sum(_nbytes(t) for t in results)
            self.coll["bytes_by_kind"][kind] += n
            self.coll["counts_by_kind"][kind] += 1
            if len({r // self.per_pod for r in ranks}) > 1:
                self.coll["cross_pod_bytes"] += n
        elif ns != "prim" and not func.is_view and results:
            from torch.utils.flop_counter import flop_registry

            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.bytes_accessed += (sum(_nbytes(t) for t in operands)
                                    + sum(_nbytes(t) for t in results))
        for t in results:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._arg_storages:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, partial(self._freed, key)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank ``_RANK`` of a fake default process group of
    ``world_size`` ranks: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=_RANK,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(x):
    if not isinstance(x, torch.Tensor):
        return x
    return torch.zeros(tuple(x.shape), dtype=x.dtype)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def lower_train(arch: Arch, shape: InputShape, mesh, *, sync: SyncConfig,
                optimizer: str, config_overrides: Optional[dict] = None):
    """Trace the train step, then the sync round on its state, on ``mesh``
    (of the current fake group) -> ``(train, sync, setup)``, the two step
    records of :meth:`_Tracer.end`."""
    setup = C.make_train_setup(arch, mesh, sync=sync, optimizer=optimizer,
                               config_overrides=config_overrides)
    info = mesh_info(mesh)
    cfg_arch = Arch(name=arch.name, config=setup.cfg, smoke=arch.smoke,
                    module=arch.module)
    tr = setup.trainer
    tracer = _Tracer(info["n_devices"], info["n_pods"])
    with tracer:
        state = setup.place_state(T.tree_map(_fake_like,
                                             setup.abstract_state))
        specs = train_batch_specs(cfg_arch, shape, info["n_pods"])
        batch = setup.place_batch({k: _fake_like(v)
                                   for k, v in specs.items()})
        tracer.begin((state, batch), tr.pods)
        with tr._placed():
            state, per_pod = tr._train_step(state, batch)
        train = tracer.end((state, per_pod))
        tracer.begin(state, tr.pods)
        state, _ = tr._sync_round(state)
        sync_rec = tracer.end(state)
    return train, sync_rec, setup


def lower_prefill(arch: Arch, shape: InputShape, mesh):
    """Trace a prefill of ``shape`` on ``mesh`` under ``serve_rules``
    (``context.make_serve_setup``) -> ``(record, None, setup)``: the
    decoder stack's ``prefill`` of the prompt into a cache of
    ``seq_len`` positions, or, for an encoder-decoder, ``encdec.forward``
    over the tokens and the stub audio embeddings, as the reference
    lowers them.  No sync step."""
    setup = C.make_serve_setup(arch, mesh)
    cfg, fns = setup.cfg, setup.fns
    info = mesh_info(mesh)
    tracer = _Tracer(info["n_devices"], info["n_pods"])
    with tracer, torch.no_grad():
        params = setup.place_params(T.tree_map(_fake_like,
                                               setup.abstract_params))
        batch = setup.place_batch({k: _fake_like(v) for k, v in
                                   prefill_specs(arch, shape).items()})
        tracer.begin((params, batch))
        with setup.scope():
            if arch.module == "encdec":
                out, _ = encdec.forward(params, cfg, batch["tokens"],
                                        batch["audio_emb"])
            else:
                out = fns.prefill(params, cfg, batch["tokens"],
                                  shape.seq_len,
                                  positions=batch.get("positions"),
                                  patch_emb=batch.get("patch_emb"))
        rec = tracer.end(out)
    return rec, None, setup


def lower_decode(arch: Arch, shape: InputShape, mesh):
    """Trace one decode step of ``shape`` (one token a row over a cache of
    ``seq_len`` positions) on ``mesh`` under ``serve_rules`` -> ``(record,
    None, setup)``.  The cache is placed by ``cache_logical_axes``, as the
    reference's ``spec_tree_for_params``; the step updates it in place."""
    setup = C.make_serve_setup(arch, mesh)
    cfg, fns = setup.cfg, setup.fns
    info = mesh_info(mesh)
    tracer = _Tracer(info["n_devices"], info["n_pods"])
    with tracer, torch.no_grad():
        params = setup.place_params(T.tree_map(_fake_like,
                                               setup.abstract_params))
        abstract = fns.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
        cache = setup.place_cache(T.tree_map(_fake_like, abstract),
                                  shape.seq_len)
        batch = setup.place_batch({k: _fake_like(v) for k, v in
                                   decode_specs(arch, shape).items()})
        tracer.begin((params, batch["token"], cache, batch["cache_pos"]))
        with setup.scope():
            logits, cache = fns.decode_step(params, cfg, batch["token"],
                                            cache, batch["cache_pos"])
        rec = tracer.end((logits, cache))
    return rec, None, setup


def _lower_for(arch: Arch, shape: InputShape, mesh, *, sync: SyncConfig,
               optimizer: str, config_overrides: Optional[dict]):
    """The step records of ``shape``'s kind: ``lower_train``'s, or a
    serving step's (the overrides on a copy of the arch)."""
    if shape.kind == "train":
        return lower_train(arch, shape, mesh, sync=sync, optimizer=optimizer,
                           config_overrides=config_overrides)
    if config_overrides:
        arch = Arch(name=arch.name,
                    config=arch.config.replace(**config_overrides),
                    smoke=arch.smoke, module=arch.module)
    if shape.kind == "prefill":
        return lower_prefill(arch, shape, mesh)
    return lower_decode(arch, shape, mesh)


def _extrapolate_costs(arch: Arch, shape: InputShape, mesh, *,
                       sync: SyncConfig, optimizer: str,
                       base_overrides: Optional[dict]) -> Dict:
    """The reference's extrapolation of the step from one-group and
    two-group variants (``_combine``).  The reference needs it because
    XLA's CPU cost analysis counts a scanned loop's body once; the port
    runs every layer, so the record's own counts are the full-depth ones,
    and this is kept to hold the two equal."""
    cfg = arch.config
    if base_overrides:
        cfg = cfg.replace(**base_overrides)
    period, n_groups = cfg.period, cfg.n_groups

    def one(n_layers: int) -> Dict:
        ov = dict(base_overrides or {})
        ov.update({"n_layers": n_layers, "scan_layers": False})
        step, _, _ = _lower_for(arch, shape, mesh, sync=sync,
                                optimizer=optimizer, config_overrides=ov)
        coll = step["collectives"]
        return {"flops": step["cost"]["flops"],
                "bytes": step["cost"]["bytes accessed"],
                "collective_bytes": float(coll["total_bytes"]),
                "cross_pod_bytes": float(coll["cross_pod_bytes"]),
                "bytes_by_kind": coll["bytes_by_kind"]}

    c1 = one(period)
    c2 = one(2 * period)
    out = {k: _combine(c1[k], c2[k], n_groups) for k in
           ("flops", "bytes", "collective_bytes", "cross_pod_bytes")}
    out["bytes_by_kind"] = {
        k: _combine(float(c1["bytes_by_kind"][k]),
                    float(c2["bytes_by_kind"][k]), n_groups)
        for k in c1["bytes_by_kind"]}
    out["one_group"] = c1
    out["two_group"] = c2
    out["n_groups"] = n_groups
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_one(arch_name: str, shape_name: str, mesh_kind: str, *,
            sync_strategy: str = "ama", sync_interval: int = 8,
            sync_compress: float = 0.0,
            optimizer: str = "sgd", tag: str = "",
            config_overrides: Optional[dict] = None,
            out_dir: Optional[str] = None,
            extrapolate: bool = True) -> Dict:
    """One record: its static fields, then the traced step (and, for a
    training shape, the sync round), the extrapolation from one and two
    layer groups, and ``status`` (``"ok"``, ``"skipped"``, or ``"error"``
    with the traceback); written by :func:`_write` and returned."""
    arch = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    multi = mesh_kind == "multi_pod"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        info = mesh_info(mesh)
        ok, reason = shape_supported(arch, shape_name)
        rec: Dict = {
            "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
            "mesh_info": info, "tag": tag,
            "params": arch.config.param_count(),
            "active_params": arch.config.active_param_count(),
            "sync": {"strategy": sync_strategy, "interval": sync_interval,
                     "compress_topk": sync_compress},
            "optimizer": optimizer,
            "config_overrides": config_overrides or {},
            "tokens": (shape.global_batch * shape.seq_len
                       if shape.kind != "decode" else shape.global_batch),
        }
        if not ok:
            rec["status"] = "skipped"
            rec["skip_reason"] = reason
            _write(rec, out_dir)
            return rec

        t0 = time.time()
        sync = SyncConfig(sync_strategy, sync_interval,
                          compress_topk=sync_compress)
        try:
            step, sync_rec, _ = _lower_for(
                arch, shape, mesh, sync=sync, optimizer=optimizer,
                config_overrides=config_overrides)
            rec["lower_s"] = round(time.time() - t0, 2)
            rec.update(step)
            rec["status"] = "ok"
            if sync_rec is not None:
                rec["sync_step"] = sync_rec
            if extrapolate:
                t2 = time.time()
                rec["extrapolated"] = _extrapolate_costs(
                    arch, shape, mesh, sync=sync, optimizer=optimizer,
                    base_overrides=config_overrides)
                rec["extrapolate_s"] = round(time.time() - t2, 2)
        except Exception as e:
            # a sweep goes on past one failed combination: recorded
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
        rec["total_s"] = round(time.time() - t0, 2)
    _write(rec, out_dir)
    return rec


def _write(rec: Dict, out_dir: Optional[str] = None) -> None:
    d = os.path.abspath(out_dir or OUT_DIR)
    os.makedirs(d, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        d, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']} "
          f"-> {rec['status']} ({rec.get('total_s', 0)}s)", flush=True)


def _row(rec: Dict) -> str:
    """One record as a row of the sweep's table: status, per-rank argument
    + temp GB, flops, in-pod collective GB and cross-pod bytes of the step
    (and of a training shape's sync round)."""
    head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
    if rec["status"] != "ok":
        why = rec.get("skip_reason") or rec.get("error", "")
        return head + f"{rec['status']} ({why[:90]}) | - | - | - | - |"
    mem, coll = rec["memory"], rec["collectives"]
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    in_pod = coll["total_bytes"] - coll["cross_pod_bytes"]
    cross = f"{coll['cross_pod_bytes']:,}"
    if "sync_step" in rec:
        cross += (f" (round "
                  f"{rec['sync_step']['collectives']['cross_pod_bytes']:,})")
    return (head + f"ok, {rec['extrapolated']['n_groups']} groups | "
            f"{need / 1e9:.2f} | {rec['cost']['flops']:.4g} | "
            f"{in_pod / 1e9:.2f} | {cross} |")


def _sweep(jobs: list, args) -> int:
    """Each (arch, shape, mesh) of ``jobs`` through this command line in a
    process of its own (the fake group is the process's default group),
    ``args.jobs`` at a time, its output in ``<record>.log`` beside the
    record; then one table row a record.  Returns 1 if a run exits
    non-zero."""
    out_dir = os.path.abspath(args.out_dir or OUT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    tag = f"__{args.tag}" if args.tag else ""

    def one(job):
        a, s, m = job
        with open(os.path.join(out_dir, f"{a}__{s}__{m}{tag}.log"),
                  "w") as log:
            return subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 a, "--shape", s, "--mesh", m, "--sync", args.sync,
                 "--interval", str(args.interval), "--optimizer",
                 args.optimizer, "--tag", args.tag, "--out-dir", out_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT).returncode

    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        rcs = list(pool.map(one, jobs))
    print(f"[dryrun] {len(jobs)} runs in {time.time() - t0:.1f} s, "
          f"{args.jobs} at a time, torch {torch.__version__}")
    print("| arch | shape | mesh | status | argument + temp GB a rank | "
          "flops a step | in-pod collective GB a step | cross-pod B |")
    print("|---|---|---|---|---|---|---|---|")
    for a, s, m in jobs:
        path = os.path.join(out_dir, f"{a}__{s}__{m}{tag}.json")
        if os.path.exists(path):
            with open(path) as f:
                print(_row(json.load(f)))
    failed = [(job, rc) for job, rc in zip(jobs, rcs) if rc != 0]
    for (a, s, m), rc in failed:
        print(f"[dryrun] {a} {s} {m} exited {rc}, see "
              f"{os.path.join(out_dir, f'{a}__{s}__{m}{tag}.log')}")
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=list(_MESHES), default="single_pod")
    ap.add_argument("--all", action="store_true",
                    help="sweep: every arch x shape x both meshes, each in "
                         "a process of its own")
    ap.add_argument("--jobs", type=int, default=4,
                    help="--all: runs at a time")
    ap.add_argument("--sync", default="ama")
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    if args.all:
        jobs = [(a, s, m) for a in ARCH_IDS for s in INPUT_SHAPES
                for m in _MESHES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape, args.mesh)]
    if args.skip_existing:
        tag = f"__{args.tag}" if args.tag else ""

        def done(job):
            p = os.path.join(os.path.abspath(args.out_dir or OUT_DIR),
                             "__".join(job) + f"{tag}.json")
            if not os.path.exists(p):
                return False
            with open(p) as f:
                return json.load(f).get("status") in ("ok", "skipped")
        jobs = [j for j in jobs if not done(j)]
    if args.all:
        return _sweep(jobs, args)
    for a, s, m in jobs:
        run_one(a, s, m, sync_strategy=args.sync,
                sync_interval=args.interval, optimizer=args.optimizer,
                tag=args.tag, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
