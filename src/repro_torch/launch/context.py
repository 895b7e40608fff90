"""Shared launch context: rule sets, abstract state, placement trees.

Counterpart of ``repro/launch/context.py``.  Rule sets (logical axis ->
mesh axes) per step kind, the reference's, kept in
``repro_torch.sharding.rules`` (the trainer on a mesh reads them there) and
named here as in the reference:

- **train**: the training state is *stacked* over pods (leading
  ``pod_stack`` dim -> ``"pod"``); the in-pod batch shards over ``"data"``;
  parameters are FSDP-sharded over ``"data"`` and tensor-parallel over
  ``"model"``.
- **decode/prefill**: serving is per-pod replica, so the request batch
  shards over ``("pod", "data")`` and full KV caches shard their sequence
  over ``"model"``.

:func:`make_train_setup` builds the trainer on a mesh, the state's shapes
on the ``meta`` device (``abstract_state``) and its placement tree
(``state_sharding``, a :class:`~repro_torch.sharding.rules.NamedSharding`
per leaf); :meth:`TrainSetup.place_state` and :meth:`TrainSetup.place_batch`
put a whole state or batch on the mesh by those trees.  The ``"pod"`` entry
of a spec is carried out across processes (each rank keeps its pods' rows),
the in-pod entries as DTensor placements.  :func:`make_serve_setup` is the
serving counterpart: one model's parameters, a request batch and a decode
cache placed under :func:`serve_rules` as DTensors on the whole mesh, whose
``"pod"`` axis only the batch names (``ServeSetup``).

The reference pins JAX's partitionable threefry before it builds a sharded
setup (``ensure_partitionable_threefry``), so that a sharded init draws
the numbers an unsharded one does.  The port has no counterpart: torch
draws the parameters once, from one generator, and places them after.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs import Arch
from repro_torch.core.sync import (POD_STACKED_SYNC_FIELDS, SyncConfig,
                                   SyncState, ga_buffer_stacked)
from repro_torch.models.registry import ModelFns, get_model_fns
from repro_torch.optim.optimizers import AdamState
from repro_torch.sharding.rules import (LA, NamedSharding, map_la,
                                        mesh_sizes, serve_rules,
                                        sharding_tree_for_params,
                                        train_rules)
from repro_torch.training.trainer import (Trainer, TrainerConfig, TrainState,
                                          pod_stacked)

Pytree = Any


# ---------------------------------------------------------------------------
# logical axes of the composite state
# ---------------------------------------------------------------------------


def stacked_param_axes(fns: ModelFns, cfg) -> Pytree:
    return map_la(lambda la: LA(("pod_stack",) + la.names),
                  fns.param_logical_axes(cfg))


def opt_state_axes(optimizer: str, param_axes: Pytree) -> Pytree:
    if optimizer == "sgd":
        return ()
    if optimizer == "momentum":
        return param_axes
    if optimizer == "adamw":
        return AdamState(mu=param_axes, nu=param_axes, count=LA(()))
    raise KeyError(optimizer)


def sync_state_axes(sync: SyncConfig, param_axes: Pytree) -> SyncState:
    if ga_buffer_stacked(sync):
        buf = param_axes
    else:
        buf = map_la(lambda la: LA((None,)), param_axes)
    per_pod = {f: LA(("pod_stack", None)) for f in POD_STACKED_SYNC_FIELDS}
    return SyncState(ga_buffer=buf, steps_since_sync=LA(()),
                     significant_frac=LA(()),
                     tier=LA((None,)),              # (n_buckets,) vector
                     **per_pod)


def train_state_axes(fns: ModelFns, cfg, tcfg: TrainerConfig) -> TrainState:
    p = stacked_param_axes(fns, cfg)
    return TrainState(params=p, opt_state=opt_state_axes(tcfg.optimizer, p),
                      sync_state=sync_state_axes(tcfg.sync, p), step=LA(()))


def batch_axes(batch: Dict, *, stacked: bool) -> Dict:
    """Logical axes for a flat batch dict (dims: [pod_stack,] batch, ...).

    ``positions`` leads with the M-RoPE component dim (3, B, S); scalars
    (``cache_pos``) are unsharded."""
    out = {}
    for k, v in batch.items():
        inner_rank = len(v.shape) - (1 if stacked else 0)
        if inner_rank == 0:
            base: Tuple = ()
        elif k == "positions":
            base = (None, "batch") + (None,) * (inner_rank - 2)
        else:
            base = ("batch",) + (None,) * (inner_rank - 1)
        out[k] = LA((("pod_stack",) if stacked else ()) + base)
    return out


# ---------------------------------------------------------------------------
# setup constructors
# ---------------------------------------------------------------------------


def _place(x: torch.Tensor, sharding: NamedSharding, pods, inpod,
           stacked: bool) -> torch.Tensor:
    """One whole leaf -> this rank's part: its pods' rows (``stacked``
    leaves, on a split pod axis, copied: a view would keep every pod's
    storage alive on the rank), a DTensor on the in-pod mesh placed by the
    spec."""
    if stacked and pods.split:
        x = pods.rows(x).clone()
    if inpod is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(x, inpod, [Replicate()] * inpod.ndim,
                             run_check=False)
    return rep.redistribute(inpod, sharding.placements(inpod))


@dataclass
class TrainSetup:
    arch: Arch
    cfg: Any
    fns: ModelFns
    trainer: Trainer
    abstract_state: Pytree
    state_sharding: Pytree
    rules: Dict
    mesh: Any = None

    def place_state(self, state: TrainState) -> TrainState:
        """A whole train state (every pod's rows, plain tensors; from
        ``trainer.init_state(seed)``, or ``trainer.state_from_params`` of
        converted parameters) -> this rank's part on the mesh: its pods'
        rows of the pod-stacked leaves (:func:`~repro_torch.training.
        trainer.pod_stacked`), each a DTensor placed by
        :attr:`state_sharding`.  ``step`` stays an int.  The state is
        consumed: a replicated leaf shares its storage."""
        tr = self.trainer
        return T.tree_map(
            lambda x, s, stacked: _place(x, s, tr.pods, tr.inpod, stacked)
            if isinstance(x, torch.Tensor) else int(x),
            state, self.state_sharding, pod_stacked(tr.cfg.sync, state))

    def restore_state(self, directory: str,
                      pod_resize: Optional[str] = None
                      ) -> Tuple[TrainState, int]:
        """A checkpoint (of any placement, or none) onto the setup's
        placements: each rank keeps its rows, resized with ``pod_resize``
        when the file holds another pod count, and its in-pod shards, cut
        on the host.  Returns (state, step).  A placed state is saved by
        its trainer (``Trainer.save_state``, every rank of the mesh)."""
        return self.trainer.restore_state(directory, self.abstract_state,
                                          pod_resize=pod_resize,
                                          sharding=self.state_sharding)

    def place_batch(self, batch: Dict[str, torch.Tensor],
                    trainer: Optional[Trainer] = None
                    ) -> Dict[str, torch.Tensor]:
        """A whole stacked batch (leading pod dim) -> this rank's part:
        its pods' rows, each leaf placed by :func:`batch_sharding`, on the
        mesh of ``trainer`` (default: the setup's; after a
        reconfiguration, the successor's)."""
        tr = self.trainer if trainer is None else trainer
        sh = batch_sharding(batch, tr.mesh, self.rules, stacked=True)
        return {k: _place(v, sh[k], tr.pods, tr.inpod, True)
                for k, v in batch.items()}


def wrap_loss(fns: ModelFns, cfg) -> Callable:
    def loss(params, batch):
        return fns.loss_fn(params, cfg, batch)
    return loss


def _abstract_state(trainer: Trainer, fns: ModelFns, cfg,
                    n_pods: int) -> TrainState:
    """The trainer's state on the ``meta`` device: nothing allocated."""
    one = fns.abstract_params(cfg)
    stacked = T.tree_map(lambda x: x[None].expand((n_pods,) + tuple(x.shape)),
                         one)
    return trainer.state_from_params(stacked)


def make_train_setup(arch: Arch, mesh, *,
                     sync: SyncConfig = SyncConfig(),
                     optimizer: str = "sgd", lr: float = 0.01,
                     smoke: bool = False,
                     config_overrides: Optional[dict] = None,
                     n_pods: Optional[int] = None, transport=None,
                     stream=None) -> TrainSetup:
    """The trainer of ``arch`` on ``mesh`` with its abstract state and
    placement tree.  ``n_pods`` (default: the mesh's ``"pod"`` size) is
    the number of stacked pods, a multiple of that size: each rank of the
    pod axis holds ``n_pods / size`` of them (all of them on a mesh without
    a pod axis, whose one rank stacks every pod).  ``transport`` and
    ``stream`` go to the ``Trainer``, which binds the transport to its pod
    axis."""
    cfg = arch.smoke if smoke else arch.config
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    fns = get_model_fns(arch.module)
    pod_size = mesh_sizes(mesh).get("pod", 1)
    n_pods = pod_size if n_pods is None else int(n_pods)
    if n_pods % pod_size:
        raise ValueError(f"{n_pods} pods do not split over a pod axis of "
                         f"{pod_size}")
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    tcfg = TrainerConfig(n_pods=n_pods, optimizer=optimizer, lr=lr,
                         sync=sync)
    rules = train_rules()
    trainer = Trainer(wrap_loss(fns, cfg),
                      lambda g: fns.init_params(g, cfg, device), tcfg,
                      device=device, mesh=mesh, transport=transport,
                      stream=stream)
    abstract_state = _abstract_state(trainer, fns, cfg, n_pods)
    axes = train_state_axes(fns, cfg, tcfg)
    sharding = sharding_tree_for_params(axes, abstract_state, mesh, rules)
    return TrainSetup(arch=arch, cfg=cfg, fns=fns, trainer=trainer,
                      abstract_state=abstract_state,
                      state_sharding=sharding, rules=rules, mesh=mesh)


@dataclass
class ServeSetup:
    """Serving on a mesh under :func:`serve_rules`: the model's parameters
    unstacked (one replica per pod), FSDP over ``"data"`` and tensor
    parallel over ``"model"``; the request batch over ``("pod", "data")``;
    a decode cache's full sequence over ``"model"``.  The DTensors live on
    the whole mesh, ``"pod"`` included, which only the batch names: a
    serving step of a dense or SSM model crosses no pod (an MoE layer
    routes on its tokens gathered over the whole mesh)."""
    arch: Arch
    cfg: Any
    fns: ModelFns
    abstract_params: Pytree
    param_sharding: Pytree
    rules: Dict
    mesh: Any

    def scope(self):
        """A step on the mesh: the serving rules installed, and plain
        tensors meeting DTensors taken as replicated."""
        import contextlib

        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.sharding.rules import axis_rules

        stack = contextlib.ExitStack()
        stack.enter_context(axis_rules(self.rules, self.mesh))
        stack.enter_context(implicit_replication())
        return stack

    def _put(self, tree, shardings):
        return T.tree_map(lambda x, s: _place(x, s, None, self.mesh, False),
                          tree, shardings)

    def place_params(self, params: Pytree) -> Pytree:
        """Whole parameters (one model) -> this rank's parts."""
        return self._put(params, self.param_sharding)

    def place_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A whole request batch (a prefill's ``tokens`` and extras, or a
        decode step's ``token`` and ``cache_pos``) -> this rank's parts."""
        return self._put(batch, batch_sharding(batch, self.mesh, self.rules,
                                               stacked=False))

    def cache_sharding(self, cache: Pytree, seq_len: int) -> Pytree:
        """The placement tree of a decode cache of ``seq_len`` positions
        (the reference's ``spec_tree_for_params`` of
        ``cache_logical_axes``)."""
        return sharding_tree_for_params(
            self.fns.cache_logical_axes(self.cfg, seq_len), cache, self.mesh,
            self.rules)

    def place_cache(self, cache: Pytree, seq_len: int) -> Pytree:
        """A whole decode cache -> this rank's parts."""
        return self._put(cache, self.cache_sharding(cache, seq_len))


def make_serve_setup(arch: Arch, mesh, *, smoke: bool = False,
                     config_overrides: Optional[dict] = None) -> ServeSetup:
    """The serving counterpart of :func:`make_train_setup`: ``arch``'s
    parameters' shapes on the ``meta`` device and their placement tree on
    ``mesh`` under :func:`serve_rules`."""
    cfg = arch.smoke if smoke else arch.config
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    fns = get_model_fns(arch.module)
    rules = serve_rules()
    abstract = fns.abstract_params(cfg)
    sharding = sharding_tree_for_params(fns.param_logical_axes(cfg),
                                        abstract, mesh, rules)
    return ServeSetup(arch=arch, cfg=cfg, fns=fns, abstract_params=abstract,
                      param_sharding=sharding, rules=rules, mesh=mesh)


def batch_sharding(batch_specs: Dict, mesh, rules: Dict, *,
                   stacked: bool) -> Dict:
    axes = batch_axes(batch_specs, stacked=stacked)
    return sharding_tree_for_params(axes, batch_specs, mesh, rules)
