"""Multi-pod dry run of training: trace the train step and the sync round of
every (arch x training shape x mesh) on a fake process group, and count what
one rank does.

Counterpart of the training half of ``repro/launch/dryrun.py``: the proof
that the distribution config is coherent without the hardware.  One process
poses as rank 0 of a fake group (``torch.testing``'s ``FakeProcessGroup``)
of ``prod(mesh shape)`` ranks, 512 for the multi-pod ``(2, 16, 16)`` mesh
and 256 for the single-pod ``(16, 16)``, and builds the production mesh
(``launch/mesh.py``) over device type ``"cpu"``.  Every tensor is a fake
tensor (``FakeTensorMode``): nothing is allocated and no device is used,
like the reference's 512 placeholder host devices.  So every op of
``repro_torch.kernels.ops`` takes its plain path, as the reference's ops do
when it lowers on host devices: the dry run counts the plain path.  It has
no device option and no fallback.

``make_train_setup`` builds the trainer on that mesh; ``Trainer._train_step``
runs once on a fake batch from ``shapes.train_batch_specs`` and
``Trainer._sync_round`` once after it, the counterparts of the reference's
``_train_step_impl`` and ``_sync_step_impl``.  (``train_step`` and
``maybe_sync`` read values on the host, which a fake tensor refuses.)  For
each, on this rank's local tensors (below DTensor):

- ``collectives``: bytes (each op's result) and counts by the reference's
  five kinds, from the ``c10d`` and functional-collective ops posted, plus
  ``PodAxis``'s own point-to-point ring ships, filed as
  ``collective-permute``.  A collective crosses pods when its group's ranks
  lie in more than one pod (pod = rank // (n_devices / n_pods)), so no byte
  is of unknown pod;
- ``memory``: the state's (and the batch's) local bytes as
  ``argument_size_in_bytes``, the outputs' as ``output_size_in_bytes`` (of
  which ``alias_size_in_bytes`` share an argument's storage: the step
  updates the state in place), and the peak of the bytes of storages
  created during the step and alive at once as ``temp_size_in_bytes``;
- ``cost``: ``flops`` of the matrix products (``torch.utils.flop_counter``'s
  registry) and ``bytes accessed``, the input and output bytes of every
  op that is not a view or a collective.

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
with the reference's keys.  ``lower_prefill`` and ``lower_decode`` (serving
under ``serve_rules`` on a mesh) are not ported: a ``prefill`` or ``decode``
shape raises (ROADMAP.md Queue 1 item 15b-4).

The fake group is the process's default group: run a dry run in a process
of its own (the CLI does).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh multi_pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every arch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
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
                                       shape_supported, train_batch_specs)
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
    def begin(self, args, pods) -> None:
        """Count from here: ``args`` (a tree of placed or plain tensors)
        are the step's arguments; ``pods`` its pod axis."""
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
        self._sends, self._sent = pods.sends, dict(pods.sent)
        self.counting = True

    def end(self, outputs) -> Dict[str, Any]:
        """Stop counting -> the step's ``collectives``, ``memory`` and
        ``cost`` records (``outputs``: what the step returned)."""
        self.counting = False
        pods = self._pods
        n_sends = pods.sends - self._sends
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


def _extrapolate_costs(arch: Arch, shape: InputShape, mesh, *,
                       sync: SyncConfig, optimizer: str,
                       base_overrides: Optional[dict]) -> Dict:
    """The reference's extrapolation of the train step from one-group and
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
        train, _, _ = lower_train(arch, shape, mesh, sync=sync,
                                  optimizer=optimizer, config_overrides=ov)
        coll = train["collectives"]
        return {"flops": train["cost"]["flops"],
                "bytes": train["cost"]["bytes accessed"],
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
            optimizer: str = "sgd", tag: str = "",
            config_overrides: Optional[dict] = None,
            out_dir: Optional[str] = None) -> Dict:
    """One record: its static fields, then the traced train step and sync
    round, their extrapolation from one and two layer groups, and
    ``status`` (``"ok"``, ``"skipped"``, or ``"error"`` with the
    traceback); written by :func:`_write` and returned."""
    arch = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind != "train":
        raise NotImplementedError(
            f"the dry run of a {shape.kind} shape ({shape_name}) is not "
            f"ported: serving under serve_rules on a mesh is ROADMAP.md "
            f"Queue 1 item 15b-4")
    multi = mesh_kind == "multi_pod"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        info = mesh_info(mesh)
        ok, reason = shape_supported(arch, shape_name)
        sync = SyncConfig(sync_strategy, sync_interval)
        rec: Dict = {
            "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
            "mesh_info": info, "tag": tag,
            "params": arch.config.param_count(),
            "active_params": arch.config.active_param_count(),
            "sync": {"strategy": sync.strategy, "interval": sync.interval,
                     "compress_topk": sync.compress_topk},
            "optimizer": optimizer,
            "config_overrides": config_overrides or {},
            "tokens": shape.global_batch * shape.seq_len,
        }
        if not ok:
            rec["status"] = "skipped"
            rec["skip_reason"] = reason
            _write(rec, out_dir)
            return rec

        t0 = time.time()
        try:
            train, sync_rec, _ = lower_train(
                arch, shape, mesh, sync=sync, optimizer=optimizer,
                config_overrides=config_overrides)
            rec["lower_s"] = round(time.time() - t0, 2)
            rec.update(train)
            rec["status"] = "ok"
            rec["sync_step"] = sync_rec
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=list(_MESHES), default="single_pod")
    ap.add_argument("--all", action="store_true",
                    help="sweep: every arch x the training shapes x both "
                         "meshes")
    ap.add_argument("--sync", default="ama")
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    if args.all:
        jobs = [(a, s, m) for a in ARCH_IDS for s in INPUT_SHAPES
                if INPUT_SHAPES[s].kind == "train" for m in _MESHES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape, args.mesh)]

    for a, s, m in jobs:
        if args.skip_existing:
            tag = f"__{args.tag}" if args.tag else ""
            p = os.path.join(os.path.abspath(args.out_dir or OUT_DIR),
                             f"{a}__{s}__{m}{tag}.json")
            if os.path.exists(p):
                with open(p) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
        run_one(a, s, m, sync_strategy=args.sync,
                sync_interval=args.interval, optimizer=args.optimizer,
                tag=args.tag, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
