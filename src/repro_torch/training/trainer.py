"""Geo-distributed trainer: per-pod train step + sync-strategy integration.

Counterpart of the in-graph path of ``repro/training/trainer.py``.  Every
leaf of ``params`` / ``opt_state`` / ``ga_buffer`` (and the codec's flat
``ef_residual``) has a leading **pod** dimension.  The per-pod step is a
loop over that dimension: each pod's loss and gradients come from autograd
on its slice of the parameters, which is what the reference's ``jax.vmap``
of ``value_and_grad`` computes.  Every ``interval`` steps the sync round
runs: on the codec path the three stages of ``repro_torch.core.sync``
(prepare -> ship -> finish), through the CUDA codec kernels on the card,
shipped over the inline ring or a transport
(``repro_torch.core.transport``: the billed ``SimTransport``, the
host-timed ``MeshTransport``); the other strategies through
``apply_sync`` (sparse shipping through the CUDA top-k kernel).  The
reference splits its jitted step from the host seam; the port runs no
jit, so one round function serves both, and whether the ship is timed is
up to the transport's ``ship_bucket``.  With a
``StreamingShipController`` (``stream=``) over a streaming transport a
codec round ships chunk by chunk (:meth:`Trainer._stream_sync`) and may
re-encode its unsent tail at a cheaper rung mid-round.  ``reconfigure`` /
``resize_train_state`` / ``apply_reconfig`` re-stack the pod dimension at
a barrier, and ``retune`` swaps the sync config of the same strategy.

The step updates the stacked parameters and optimizer state in place
(slice by slice) instead of building new stacked tensors: at full width the
parameters are gigabytes, and nothing reads a train state after the step
that replaced it.

On a mesh (``mesh=``; ``repro_torch.launch.context.make_train_setup``
builds the trainer on one) the ``"pod"`` axis runs across processes:
each rank holds its own pods' rows and loops over them, and the sync layer
crosses the pod axis through its seam (``sync.PodAxis``): the inline ring
and every transport, bound to the axis (``WanTransport.bind``), ship over
its point-to-point ring, and every measured second and retry verdict is
agreed over the pod group before a host decision reads it.  On the
in-pod axes (``"data"``, ``"model"``) every state leaf
is a DTensor placed by ``TrainSetup.state_sharding``: the forward runs on
the placed parameters under ``axis_rules(train_rules())`` and
``implicit_replication``,
each gradient is redistributed to its parameter's placements, and the
in-place updates keep them.  A dense ``ama``, ``sma`` or ``asgd_ga`` round
is elementwise across pods and runs on the placed leaves: each rank ships
its own shard.  Any other round, a streaming one too, gathers each in-pod
leaf whole (``full_tensor``), runs on plain tensors (no DTensor reaches a
kernel: the codec's blocks are blocks of the whole flattened leaf) and
writes the result back into the placed leaves.  ``retune`` works on a
mesh, and so does ``reconfigure``: on a pod axis split over the world's
ranks, one pod a rank (one cloud a process), every rank of the world
calls it; a pod that leaves idles in the world, an idle rank that joins
receives its rows, each new row is computed on its own rank by the whole
resize's expression from the rows it needs (sent point to point over
one gloo group of the world), and the successor takes the mesh of the new
layout (made once a layout, :class:`_Shared`) and a new pod axis.
``save_state`` /
``restore_state`` checkpoint a placed state in the file of its whole
value.

:class:`LiveMigrator` stages a pod grow or shrink from the async snapshot
engine's last durable snapshot on a background thread (restored to the
host: the card already holds the live state) and reconciles it at the
next sync barrier through :func:`apply_reconfig`, so a migrated run is
bit-identical to a pause-and-restore one.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch import tree as T
from repro_torch.core.sync import (POD_STACKED_SYNC_FIELDS, WHOLE_PODS,
                                   ChunkPayload, PodAxis, PodResize,
                                   SyncConfig, SyncState,
                                   _chunk_widths, _sent_width, apply_sync,
                                   bucket_chunk_mb, bucket_layout,
                                   bucket_weights_of, bucket_wire_mb,
                                   finish_codec_sync,
                                   finish_codec_sync_split,
                                   ga_buffer_stacked, init_sync_state,
                                   is_sync_step,
                                   on_step_gradients, prepare_codec_sync,
                                   reencode_unsent, resize_sync_state,
                                   retune_sync_state, ship_sync_payloads,
                                   traffic_per_step_mb)
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          constant_schedule, get_optimizer,
                                          global_norm)
from repro_torch.sharding.rules import (axis_rules, contiguous_stride,
                                        is_dtensor, local_part, train_rules,
                                        whole_local)

Pytree = Any


class TrainState(NamedTuple):
    params: Pytree
    opt_state: Pytree
    sync_state: SyncState
    step: int


@dataclass(frozen=True)
class TrainerConfig:
    n_pods: int = 1
    optimizer: str = "sgd"
    optimizer_kwargs: tuple = ()
    lr: float = 0.05
    lr_schedule: Optional[Callable] = None
    clip_norm: float = 0.0
    sync: SyncConfig = field(default_factory=SyncConfig)

    def make_optimizer(self) -> Optimizer:
        return get_optimizer(self.optimizer, **dict(self.optimizer_kwargs))

    def make_schedule(self):
        return self.lr_schedule or constant_schedule(self.lr)


class StreamRetune(NamedTuple):
    """What a streaming round's mid-round retune shipped beside its ``cfg``
    prefix: the transient config, each bucket's count of prefix chunks,
    and the re-encoded tails before and after the ship (the round hook's
    ``retune=`` argument)."""

    cfg_to: SyncConfig
    sent: Dict[str, int]
    tails: Dict[str, Tuple[ChunkPayload, ...]]
    tail_shipped: Dict[str, Tuple[ChunkPayload, ...]]


def pod_stacked(sync: SyncConfig, state: TrainState) -> TrainState:
    """Which leaves of ``state`` lead with the pod dimension, as a tree of
    bools like it: every parameter and optimizer leaf, the sync fields of
    ``sync.POD_STACKED_SYNC_FIELDS`` and the gradient accumulator where the
    strategy keeps one a pod (``sync.ga_buffer_stacked``); not the step,
    the counters or the tiers.  Placement (``TrainSetup.place_state``),
    checkpoints of a placed state and the reconfiguration read it."""
    ss = state.sync_state

    def each(tree, flag: bool):
        return T.tree_map(lambda _: flag, tree)

    return TrainState(
        params=each(state.params, True),
        opt_state=each(state.opt_state, True),
        sync_state=SyncState(*(
            each(getattr(ss, f), ga_buffer_stacked(sync) if f == "ga_buffer"
                 else f in POD_STACKED_SYNC_FIELDS)
            for f in SyncState._fields)),
        step=False)


def _stack(trees: List[Pytree]) -> Pytree:
    return T.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _pod(tree: Pytree, p: int) -> Pytree:
    return T.tree_map(lambda x: x[p], tree)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_axes(mesh, n_pods: int):
    """(the pod axis, the in-pod mesh or None) of a ``DeviceMesh``."""
    if mesh is None:
        return WHOLE_PODS, None
    names = tuple(mesh.mesh_dim_names)
    pods = WHOLE_PODS
    if "pod" in names and mesh.size(names.index("pod")) > 1:
        pods = PodAxis(n_pods, mesh.get_group("pod"))
    inner = tuple(n for n in names if n != "pod")
    if not inner:
        return pods, None
    return pods, (mesh[inner] if "pod" in names else mesh)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient redistributed to its parameter's placements."""
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole plain ``src`` into the placed leaf ``dst``: each rank
    writes its own shard (a local slice, no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    local = dst.to_local()
    if local.data_ptr() == src.data_ptr() and local.shape == src.shape:
        return      # the round ran in place on the leaf itself
    mesh = dst.device_mesh
    part = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
                                  mesh, dst.placements).to_local()
    local.copy_(part)


def _keep_placed(dst, src):
    """After a round or a retune on whole values: the placed leaf ``dst``
    with ``src`` written into its shard, where ``src`` is a plain tensor
    of its shape; else ``src`` (a leaf the round left placed, or one of
    another shape, which stays plain)."""
    if is_dtensor(dst) and not is_dtensor(src) \
            and tuple(src.shape) == tuple(dst.shape):
        _write_back(dst, src)
        return dst
    return src


def _ships_shards(sync: SyncConfig) -> bool:
    """Whether a round is elementwise across pods, so that on the mesh it
    can run on each rank's own shard: ``sma`` (its mean ignores the
    top-k), and ``ama``, ``asgd_ga`` and ``asp`` when they ship dense (no
    top-k, so no codec either; ``asp``'s significance count is summed
    over the in-pod ranks, then across pods)."""
    if sync.strategy == "sma":
        return True
    return (sync.strategy in ("ama", "asgd_ga", "asp")
            and not 0.0 < sync.compress_topk < 1.0)


class Trainer:
    def __init__(self, loss_fn: Callable, init_fn: Callable,
                 cfg: TrainerConfig, device="cuda",
                 round_hook: Optional[Callable] = None, transport=None,
                 stream=None, mesh=None):
        """loss_fn(params, batch) -> (loss, metrics dict);
        init_fn(generator) -> params (single pod, on ``device``).

        Codec payloads ship through ``transport`` (``None``: the inline
        ring, ``torch.roll`` over the pod dimension); after every sync
        round, of any strategy, the transport's ``on_sync`` bills or
        flushes the round.  ``round_hook``, if given, is called after each
        codec round as ``round_hook(state, payloads, shipped, sync)``
        (``sync``: the round's config, whose tiers a retune changes),
        outside the round's timing: a check uses it to hold the round
        against its plain version.  After a streaming round that retuned
        mid-round, ``shipped`` holds only the prefix chunks and the hook
        gets ``retune=`` a :class:`StreamRetune` as well.  Other
        strategies' rounds have no hook of their own;
        ``kernels.ops.TOPK_CHECK_HOOK`` sees each sparse ship.

        ``stream`` (a ``repro_torch.core.autotune.StreamingShipController``)
        makes codec rounds over a streaming transport chunk-granular:
        each shipped chunk's billed or measured seconds reach the
        controller as it lands, and on a mid-round bandwidth cliff the
        round's unsent segments re-encode once at a cheaper rung
        (``sync.reencode_unsent`` / ``finish_codec_sync_split``; the EF
        residual carries the fidelity dropped).  A round with no retune is
        bit-identical to the classic round.

        ``mesh`` (a ``DeviceMesh`` over ``"pod"``, ``"data"``, ``"model"``)
        runs the step on a mesh under ``sharding.rules.train_rules()``: the
        module's docstring.  A transport with ``bind`` is bound to the
        trainer's pod axis, so that on an axis split over processes it
        ships over the axis's ring."""
        self.mesh = mesh
        # a rank of the world outside the mesh: a pod that left, idle until
        # a reconfiguration takes it back
        self.live = mesh is None or mesh.get_coordinate() is not None
        self.pods, self.inpod = (_mesh_axes(mesh, cfg.n_pods) if self.live
                                 else (WHOLE_PODS, None))
        self._io = None
        self._shared = _Shared()
        self._whole: Optional[TrainState] = None
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.cfg = cfg
        self.device = torch.device(device)
        self.round_hook = round_hook
        self.transport = transport
        self._bind()
        self.stream = stream
        self.optimizer = cfg.make_optimizer()
        self.schedule = cfg.make_schedule()
        self._bucket_weights: Optional[Dict[str, float]] = None
        self._wire_mb: Optional[Dict[str, float]] = None
        self._chunk_mb: Optional[Dict[str, Tuple[float, ...]]] = None
        self.traffic_mb = 0.0
        self.stream_retunes = 0
        self.step_seconds: List[float] = []
        self.sync_seconds: List[float] = []

    def _bind(self) -> None:
        bind = getattr(self.transport, "bind", None)
        if bind is not None and self.live:
            bind(self.pods)

    def _placed(self):
        """The scope of a step on the mesh: the sharding rules installed
        and plain tensors meeting DTensors taken as replicated."""
        import contextlib

        if self.inpod is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        stack = contextlib.ExitStack()
        stack.enter_context(axis_rules(train_rules(), self.mesh))
        stack.enter_context(implicit_replication())
        return stack

    @staticmethod
    def _sync_key(sync: SyncConfig) -> SyncConfig:
        """What a sync round depends on: every codec knob, but not the
        interval (host-side scheduling only).  Two configs with one key
        run the same round, so a retune between them carries every cached
        round quantity over."""
        return dataclasses.replace(sync, interval=1)

    def bucket_weights(self, state: TrainState
                       ) -> Optional[Dict[str, float]]:
        if self.cfg.sync.bucket_policy == "single":
            return None
        if self._bucket_weights is None:
            self._bucket_weights = bucket_weights_of(self.cfg.sync,
                                                     state.params)
        return self._bucket_weights

    def wire_mb(self, state: TrainState) -> Dict[str, float]:
        if self._wire_mb is None:
            layout = bucket_layout(self.cfg.sync,
                                   state.sync_state.ga_buffer)
            self._wire_mb = bucket_wire_mb(self.cfg.sync, layout)
        return self._wire_mb

    def chunk_mb(self, state: TrainState) -> Dict[str, Tuple[float, ...]]:
        """Per-chunk wire MB of each bucket (memoized per config): the
        streaming ship's chunk schedule."""
        if self._chunk_mb is None:
            layout = bucket_layout(self.cfg.sync,
                                   state.sync_state.ga_buffer)
            self._chunk_mb = bucket_chunk_mb(self.cfg.sync, layout)
        return self._chunk_mb

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0) -> TrainState:
        """Stacked initial state: one model from ``seed``, replicated on
        every pod (the paper's setup)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n = self.cfg.n_pods
        params = T.tree_map(
            lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(),
            self.init_fn(gen))
        return self.state_from_params(params)

    def state_from_params(self, params: Pytree) -> TrainState:
        """Train state around given stacked parameters (leading pod dim)."""
        n = T.leaves(params)[0].shape[0]
        opt_state = _stack([self.optimizer.init(_pod(params, p))
                            for p in range(n)])
        return TrainState(params=params, opt_state=opt_state,
                          sync_state=init_sync_state(self.cfg.sync, params),
                          step=0)

    # -------------------------------------------------------------- steps
    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        with spans.span("step"):
            lr = self.schedule(state.step)
            with self._placed():
                state, per_pod = self._train_step(state, batch)
            with spans.span("step.metrics"):
                # every pod's metrics on every rank: the host's view,
                # outside the step (which crosses the pod axis only for
                # ``asgd``'s mean)
                per_pod = {k: self.pods.gather(v)
                           for k, v in per_pod.items()}
                out = {"loss": per_pod["loss_per_pod"].mean(),
                       "loss_per_pod": per_pod["loss_per_pod"],
                       "grad_norm": per_pod["grad_norm"], "lr": lr}
                for k in per_pod:
                    if k not in out:
                        out[k] = per_pod[k].mean()
        return state, out

    def _train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step of this rank's pods -> (state, their per-pod metrics:
        ``loss_per_pod``, ``grad_norm`` and the loss function's others,
        one row per local pod)."""
        lr = self.schedule(state.step)
        n = T.leaves(state.params)[0].shape[0]
        losses, grads, extra = [], [], []
        for p in range(n):
            pp = T.tree_map(lambda x: x[p].detach().requires_grad_(True),
                            state.params)
            with spans.span("step.forward"):
                loss, metrics = self.loss_fn(pp, {k: v[p]
                                                  for k, v in batch.items()})
            with spans.span("step.backward"):
                g = list(torch.autograd.grad(loss, T.leaves(pp)))
            if self.inpod is not None:
                g = [_placed_like(gi, xi) for gi, xi in zip(g, T.leaves(pp))]
            grads.append(T.unflatten(pp, g))
            losses.append(whole_local(loss.detach()))
            extra.append({k: whole_local(v.detach())
                          for k, v in metrics.items() if k != "loss"})
        with spans.span("step.grads"):
            grads = _stack(grads)
            if self.cfg.clip_norm > 0:
                grads = _stack([clip_by_global_norm(_pod(grads, p),
                                                    self.cfg.clip_norm)
                                for p in range(n)])
        with spans.span("step.accumulate"):
            grads, sync_state = on_step_gradients(self.cfg.sync, grads,
                                                  state.sync_state, self.pods)
        with spans.span("step.optimizer"):
            for p in range(n):
                params_p = _pod(state.params, p)
                opt_p = _pod(state.opt_state, p)
                new_p, new_opt = self.optimizer.update(_pod(grads, p), opt_p,
                                                       params_p, lr)
                T.tree_map(lambda dst, src: dst.copy_(src), params_p, new_p)
                T.tree_map(lambda dst, src: dst.copy_(src), opt_p, new_opt)
        with spans.span("step.metrics"):
            per_pod = {"loss_per_pod": torch.stack(losses),
                       "grad_norm": torch.stack([whole_local(global_norm(
                           _pod(grads, p))) for p in range(n)])}
            per_pod.update({k: torch.stack([e[k] for e in extra])
                            for k in extra[0]})
        return TrainState(state.params, state.opt_state, sync_state,
                          state.step + 1), per_pod

    def _sync_round(self, state: TrainState):
        """One sync round -> (state, (payloads, shipped) or None).  On the
        in-pod mesh a round that is elementwise across pods
        (:func:`_ships_shards`) runs on the placed leaves, so each rank
        ships only its own shard of every leaf to the rank that holds the
        same shard in the peer pod; the others run on the state gathered
        whole (:meth:`_gathered_round`), as does every round off the mesh."""
        if self.inpod is None or not _ships_shards(self.cfg.sync):
            return self._gathered_round(state)
        with self._placed():
            new, rnd = self._plain_round(state)
        # the round's fresh counters are plain tensors: into the placed
        # leaves (the leaves it updated in place are the placed ones)
        T.tree_map(lambda d, w: _write_back(d, w)
                   if is_dtensor(d) and not is_dtensor(w) else None,
                   state, new)
        return state, rnd

    def _gathered_round(self, state: TrainState):
        """The round on the state gathered whole (a sparse ship's blocks
        and the codec's buckets span whole leaves), written back into the
        placed leaves: each rank ships the pod's whole rows.  Off the mesh
        the state is whole already and this is the round itself."""
        return self._gathered(self._plain_round, state)

    def _gathered(self, fn: Callable, state: TrainState, *args):
        """``fn(whole state, *args) -> (state, ...)`` run on the state
        gathered whole in the pod, its state written back into the placed
        leaves (a leaf the round replaced by a plain one of another shape
        stays plain); the round hook sees the whole state
        (``self._whole``).  ``None`` from ``fn`` passes through."""
        out = fn(T.tree_map(whole_local, state), *args)
        if out is None:
            return None
        whole, *rest = out
        self._whole = whole
        return (T.tree_map(_keep_placed, state, whole), *rest)

    def _plain_round(self, state: TrainState):
        lr = self.schedule(state.step)
        cfg = self.cfg.sync
        if not cfg.uses_codec:
            params, sync_state = apply_sync(cfg, state.params,
                                            state.sync_state, lr,
                                            pods=self.pods)
            return state._replace(params=params,
                                  sync_state=sync_state), None
        payloads = prepare_codec_sync(cfg, state.sync_state)
        chunks = payloads.chunks
        if not getattr(self.transport, "in_graph", True):
            # the reference's host seam gets its chunks from a jitted
            # prepare, which returns them key-sorted: it ships the buckets
            # in name order, so a fault keyed to ship calls (the first
            # failed attempt of a round) bites the same bucket here
            chunks = dict(sorted(chunks.items()))
        shipped = ship_sync_payloads(cfg, chunks, self.transport,
                                     self.wire_mb(state), self.pods)
        # a fault-aware transport reports the pods that missed the round:
        # finish degraded over the survivors
        failed = tuple(getattr(self.transport, "round_failed_pods", ())
                       or ())
        alive = None
        if failed:
            alive = torch.ones(self.cfg.n_pods, dtype=torch.float32)
            for p in failed:
                if 0 <= p < self.cfg.n_pods:
                    alive[p] = 0.0
        params, sync_state = finish_codec_sync(cfg, state.params,
                                               state.sync_state, payloads,
                                               shipped, lr, alive=alive,
                                               pods=self.pods)
        return (state._replace(params=params, sync_state=sync_state),
                (payloads, shipped))

    # ------------------------------------------------ streaming sync path
    def _can_stream(self) -> bool:
        return (self.stream is not None
                and self.cfg.sync.uses_codec
                and self.transport is not None
                and getattr(self.transport, "supports_streaming", False))

    def _stream_sync(self, state: TrainState, host_step: int):
        """One chunk-granular codec round -> ``(state, the round hook's
        arguments, its keywords)``, or None when the transport declines streaming this round (a chaos plan
        armed a fault: the classic retry and degrade path runs instead).

        Prepare at the live config; ship chunk by chunk, each landed chunk
        observed by the controller against the pre-round belief; on a
        cliff, one transient retune: the unsent segments re-encode at the
        cheaper rung, the transport re-prices the tail, and the split
        finish splices prefix and tail so the EF residual carries the
        tail's fidelity delta exactly.  ``end_stream_round`` then emits the
        records and the probe fold ``on_sync`` would.  Buckets ship in name
        order, the reference's (its jitted prepare returns them
        key-sorted), so a cliff lands in the same bucket.  On a split pod
        axis the EF telemetry the controller reads is every pod's
        (gathered), and the chunks' seconds come agreed from the
        transport, so every rank retunes at the same chunk."""
        from repro_torch.core.autotune import BucketStats

        cfg = self.cfg.sync
        wire = self.wire_mb(state)
        if not self.transport.begin_stream_round(wire, step=host_step):
            return None
        ss = state.sync_state
        self.stream.note_stats(BucketStats.from_sync_state(ss._replace(
            msg_norm=self.pods.gather(ss.msg_norm),
            resid_norm=self.pods.gather(ss.resid_norm))))
        self.stream.begin_round(host_step, cfg)
        lr = self.schedule(state.step)
        payloads = prepare_codec_sync(cfg, state.sync_state)
        chunk_mb = self.chunk_mb(state)
        shipped: Dict[str, List[ChunkPayload]] = {}
        # every bucket starts at 0 sent chunks: when a retune aborts the
        # schedule, buckets not yet reached re-encode whole
        sent: Dict[str, int] = {name: 0 for name in payloads.chunks}
        cfg_to: Optional[SyncConfig] = None
        with spans.span("round.ship"):
            for name in sorted(payloads.chunks):
                for i, chunk in enumerate(payloads.chunks[name]):
                    out, secs = self.transport.stream_ship_chunk(
                        name, chunk, cfg.peer_shift, chunk_mb[name][i])
                    shipped.setdefault(name, []).append(out)
                    sent[name] = i + 1
                    cfg_to = self.stream.observe_chunk(
                        name, chunk_mb[name][i], secs)
                    if cfg_to is not None:
                        break
                if cfg_to is not None:
                    break
        shipped_t = {n: tuple(c) for n, c in shipped.items()}
        tails: Dict[str, Tuple[ChunkPayload, ...]] = {}
        if cfg_to is not None:
            layout = bucket_layout(cfg, state.sync_state.ga_buffer)
            tails, tail_local = reencode_unsent(cfg, cfg_to, payloads.flat,
                                                layout, sent)
        if not tails:
            params, sync_state = finish_codec_sync(
                cfg, state.params, state.sync_state, payloads, shipped_t, lr,
                pods=self.pods)
            self.transport.end_stream_round()
            self.stream.end_round()
            return (state._replace(params=params, sync_state=sync_state),
                    (payloads, shipped_t, cfg), {})
        # price the re-encoded tail as one fresh transfer at the current
        # bandwidth, then stream it out chunk by chunk
        tail_schedule: Dict[str, Tuple[float, ...]] = {}
        for g, name in enumerate(layout.names):
            if name not in tails:
                continue
            size = layout.sizes[g]
            _, _, sw = _sent_width(cfg, name, size, sent)
            tcfg = cfg_to.for_bucket(name)
            tail_schedule[name] = tuple(
                tcfg.payload_mb(m * 4 / 1e6)
                for m in _chunk_widths(tcfg, size - sw))
        self.transport.retune_stream(
            sum(mb for t in tail_schedule.values() for mb in t))
        self.stream_retunes += 1
        tail_shipped: Dict[str, Tuple[ChunkPayload, ...]] = {}
        with spans.span("round.ship"):
            for name in sorted(tails):
                outs = []
                for i, chunk in enumerate(tails[name]):
                    out, secs = self.transport.stream_ship_chunk(
                        name, chunk, cfg.peer_shift, tail_schedule[name][i])
                    outs.append(out)
                    self.stream.observe_chunk(name, tail_schedule[name][i],
                                              secs)
                tail_shipped[name] = tuple(outs)
        params, sync_state = finish_codec_sync_split(
            cfg, cfg_to, state.params, state.sync_state, payloads,
            shipped_t, tail_shipped, tail_local, sent, lr, pods=self.pods)
        self.transport.end_stream_round()
        self.stream.end_round()
        return (state._replace(params=params, sync_state=sync_state),
                (payloads, shipped_t, cfg),
                {"retune": StreamRetune(cfg_to, sent, tails, tail_shipped)})

    def maybe_sync(self, state: TrainState, host_step: int,
                   model_mb: float = 0.0) -> TrainState:
        if self.cfg.n_pods > 1:
            # WAN transfers per sync round: one per pod on the flat ring; a
            # transport may expose its own schedule's count
            legs = getattr(self.transport, "wan_transfers_per_round", None)
            self.traffic_mb += traffic_per_step_mb(
                self.cfg.sync, model_mb,
                bucket_weights=self.bucket_weights(state)) * (
                    legs if legs is not None else self.cfg.n_pods)
        if is_sync_step(self.cfg.sync, host_step) and self.cfg.n_pods > 1:
            with spans.span("round"):
                # a fault-aware transport arms its plan for the round
                begin = getattr(self.transport, "begin_round", None)
                if begin is not None:
                    begin(host_step)
                # the step's queued device work is not the round's
                _wait(self.device)
                t0 = time.perf_counter()
                if self._can_stream():
                    streamed = self._gathered(self._stream_sync, state,
                                              host_step)
                    if streamed is not None:
                        # end_stream_round was this round's barrier
                        state, args, kw = streamed
                        seen, self._whole = self._whole, None
                        _wait(self.device)
                        self.sync_seconds.append(time.perf_counter() - t0)
                        if self.round_hook is not None:
                            self.round_hook(seen, *args, **kw)
                        return state
                state, rnd = self._sync_round(state)
                # the hook's whole state, not kept past the round
                seen, self._whole = self._whole, None
                _wait(self.device)
                self.sync_seconds.append(time.perf_counter() - t0)
                if self.transport is not None:
                    # round barrier: bill (sim) or flush (mesh) this round's
                    # transfers into the records and the measured probe
                    self.transport.on_sync(self.wire_mb(state),
                                           step=host_step)
                if self.round_hook is not None and rnd is not None:
                    # a round that ships payloads ran gathered
                    self.round_hook(seen, *rnd, self.cfg.sync)
        return state

    # ------------------------------------------------- placed checkpoints
    @property
    def mesh_ranks(self) -> Tuple[int, ...]:
        """The global ranks of the mesh, in its order (the first is the
        checkpoint writer)."""
        return tuple(int(r) for r in self.mesh.mesh.flatten().tolist())

    def io_group(self):
        """The ``checkpoint.CheckpointGroup`` of the mesh's ranks that
        carries a placed save to its writer, point to point over the gloo
        group of the world that the trainer's chain shares
        (:class:`_Shared`): made on first use.  That group is collective
        over the world: a reconfiguration makes it, else the first save on
        a mesh over the whole world."""
        import torch.distributed as dist

        from repro_torch.checkpoint.checkpoint import CheckpointGroup

        if self._io is None:
            if (self._shared.world is None
                    and self.mesh.size() != dist.get_world_size()):
                raise RuntimeError(
                    "a mesh over part of the world saves through the "
                    "world's gloo group, which a reconfiguration makes on "
                    "every rank; none has run")
            self._io = CheckpointGroup(self.mesh_ranks, self._shared.gloo())
        return self._io

    def leaf_parts(self, like: TrainState, sharding: Optional[TrainState]
                   = None, rows: Optional[Tuple[int, int]] = None
                   ) -> TrainState:
        """A ``checkpoint.Part`` for each leaf of ``like``: a placed state
        of this trainer (each DTensor gives its in-pod placements), or a
        skeleton of the whole state (``TrainSetup.abstract_state``) with
        its ``sharding`` (``TrainSetup.state_sharding``) on this trainer's
        in-pod mesh.  A pod-stacked leaf (:func:`pod_stacked`) has the pod
        axis's count of pods and this rank's rows of them; ``rows`` names
        other rows of a skeleton whose leading dimension is already whole
        (a staged migration's)."""
        from repro_torch.checkpoint.checkpoint import Part, owner_of

        pods, inpod = self.pods, self.inpod
        at_origin = inpod is None or not any(inpod.get_coordinate())

        def part(x, stacked, s=None):
            if not isinstance(x, torch.Tensor):
                return Part((), owner=at_origin and pods.index == 0)
            shape, held = tuple(x.shape), rows if stacked else None
            if stacked and rows is None:
                if pods.split:
                    shape = (pods.n_pods,) + shape[1:]
                held = (pods.first, pods.n_local if pods.split
                        else shape[0])
            mesh, placements = None, ()
            if is_dtensor(x):
                mesh, placements = x.device_mesh, tuple(x.placements)
            elif s is not None and inpod is not None:
                mesh, placements = inpod, tuple(s.placements(inpod))
            owner = owner_of(mesh, placements) if mesh is not None \
                else at_origin
            return Part(shape, held, mesh, placements,
                        owner and (stacked or pods.index == 0))

        stacked = pod_stacked(self.cfg.sync, like)
        if sharding is None:
            return T.tree_map(part, like, stacked)
        return T.tree_map(part, like, stacked, sharding)

    def save_state(self, directory: str, state: TrainState,
                   metadata: Optional[dict] = None) -> None:
        """Save ``state`` at its step in the reference's format.  On a mesh
        every rank calls it; the file is the one the unplaced save of the
        whole state writes, byte for byte (``checkpoint.save_placed``)."""
        from repro_torch.checkpoint import checkpoint as ckpt

        if self.mesh is None:
            ckpt.save(directory, state, step=int(state.step),
                      metadata=metadata)
            return
        ckpt.save_placed(directory, state, self.leaf_parts(state),
                         self.io_group(), step=int(state.step),
                         metadata=metadata)

    def restore_state(self, directory: str, like: TrainState,
                      pod_resize: Optional[str] = None,
                      sharding: Optional[TrainState] = None
                      ) -> Tuple[TrainState, int]:
        """Restore a checkpoint onto this trainer's placements, those of
        ``like`` and ``sharding`` (:meth:`leaf_parts`).  Each rank reads
        the whole file, resizes its pod dimension with ``pod_resize`` and
        keeps its rows and in-pod shards."""
        from repro_torch.checkpoint import checkpoint as ckpt

        if self.mesh is None:
            return ckpt.restore(directory, like, pod_resize=pod_resize)
        return ckpt.restore(directory, like, device=self.device,
                            pod_resize=pod_resize,
                            parts=self.leaf_parts(like, sharding))

    # ------------------------------------------------------ elasticity
    def _successor(self, cfg: TrainerConfig, mesh=None) -> "Trainer":
        """The trainer for ``cfg`` on ``mesh`` (default: this mesh), with
        the same transport and stream, the accounts and the shared groups
        carried over; on the same mesh it keeps the in-pod mesh and the
        checkpoint group, and at the same pod count the pod axis (and its
        counts)."""
        nxt = Trainer(self.loss_fn, self.init_fn, cfg, device=self.device,
                      round_hook=self.round_hook, transport=self.transport,
                      stream=self.stream,
                      mesh=self.mesh if mesh is None else mesh)
        nxt._shared = self._shared
        if mesh is None:
            nxt.inpod, nxt._io = self.inpod, self._io
            if cfg.n_pods == self.cfg.n_pods:
                nxt.pods = self.pods
                nxt._bind()
        nxt.traffic_mb = self.traffic_mb
        nxt.stream_retunes = self.stream_retunes
        nxt.step_seconds = self.step_seconds
        nxt.sync_seconds = self.sync_seconds
        return nxt

    def _split_world(self) -> bool:
        """Whether the world holds more than one pod's ranks, so that pods
        come and go with their ranks (one pod a rank of the pod axis)."""
        import torch.distributed as dist

        if self.mesh is None or "pod" not in self.mesh.mesh_dim_names:
            return False
        return dist.get_world_size() > self.mesh.size() // self.mesh.size(
            list(self.mesh.mesh_dim_names).index("pod"))

    def pod_slots(self, n_pods: int, keep: Optional[Tuple[int, ...]] = None):
        """Where the pods live across a reconfiguration on a split pod
        axis, one pod a slot of the world's ranks (slot ``s``: ranks
        ``s * inner .. (s + 1) * inner - 1``, one pod's in-pod mesh) ->
        ``(resize, old slots, new slots, inner)``: old pod ``p`` lives in
        slot ``old[p]``; the kept pods keep their slots, the joiners take
        the lowest idle ones, and new pod ``i`` lives in the ``i``-th of
        the new slots in ascending order, so that a kept pod whose new
        index falls on another slot moves there."""
        import torch.distributed as dist

        names = tuple(self.mesh.mesh_dim_names)
        if names[0] != "pod":
            raise ValueError(f"a reconfigured mesh leads with its pod axis, "
                             f"got {names}")
        layout = self.mesh.mesh
        inner = layout[0].numel()
        old = [int(layout[p].flatten()[0]) // inner
               for p in range(layout.shape[0])]
        for p, slot in enumerate(old):
            if layout[p].flatten().tolist() != list(
                    range(slot * inner, (slot + 1) * inner)):
                raise ValueError("the mesh's pods are not slots of the "
                                 "world's ranks in order")
        if len(old) != self.cfg.n_pods:
            raise ValueError(
                f"reconfigure on a split pod axis moves one pod a rank: "
                f"{self.cfg.n_pods} pods over a pod axis of {len(old)} "
                f"ranks hold several a rank")
        resize = PodResize.of(self.cfg.n_pods, n_pods, keep)
        kept = [old[k] for k in resize.keep]
        free = [s for s in range(dist.get_world_size() // inner)
                if s not in kept]
        joining = resize.n_new - len(resize.keep)
        if joining > len(free):
            raise ValueError(f"{resize.n_new} pods need {joining} idle pod "
                             f"slots of the world, it has {len(free)}")
        return resize, old, sorted(kept + free[:joining]), inner

    def new_rows(self, n_pods: int, keep: Optional[Tuple[int, ...]] = None
                 ) -> Optional[Tuple[int, int]]:
        """This rank's ``(first, count)`` rows of the pod dimension after a
        reconfiguration to ``n_pods``; ``None`` on a rank that will idle."""
        if self.mesh is None or not self._split_world():
            return (0, n_pods)
        import torch.distributed as dist

        _, _, new, inner = self.pod_slots(n_pods, keep)
        slot = dist.get_rank() // inner
        return (new.index(slot), 1) if slot in new else None

    def reconfigure(self, state: Optional[TrainState], n_pods: int,
                    keep: Optional[Tuple[int, ...]] = None,
                    sync: Optional[SyncConfig] = None
                    ) -> Tuple["Trainer", Optional[TrainState]]:
        """Apply a reconfiguration at a sync barrier: re-stack the pod
        dimension of the train state (:func:`resize_train_state`) and
        return a new ``Trainer`` for the new pod count and sync config,
        with the WAN-traffic account carried over.

        Off a mesh, or on one whose ranks hold every pod, the resize runs
        on each rank's local shards and the mesh stays.  On a pod axis
        split over the world's ranks (one pod a rank, :meth:`pod_slots`)
        every rank of the world calls it, an idle one with ``state=None``:
        each new pod's row is computed on its own ranks from the old rows
        it is made of, sent point to point (between the ranks of one
        in-pod coordinate) over the world's gloo group, by the expression
        of the whole resize, so that the rows are those of the whole run
        bit for bit; then the successor takes the mesh of the new layout
        (a new pod axis, the transport bound to it), a departing rank gets
        ``None`` for its state and a joining one its rows.  A split axis
        that holds several pods a rank raises ``ValueError``."""
        new_cfg = dataclasses.replace(self.cfg, n_pods=n_pods,
                                      sync=sync or self.cfg.sync)
        if not self._split_world():
            resize = PodResize.of(self.cfg.n_pods, n_pods, keep)
            local = T.tree_map(local_part, state)
            new = resize_train_state(new_cfg.sync, local, n_pods,
                                     resize=resize)
            nxt = self._successor(new_cfg)
            return nxt, T.tree_map(lambda x, old: _placed_as(
                x, old, nxt.inpod), new, state)
        return self._reconfigure_split(state, new_cfg, keep)

    def _reconfigure_split(self, state: Optional[TrainState],
                           new_cfg: TrainerConfig,
                           keep: Optional[Tuple[int, ...]]):
        import torch.distributed as dist

        resize, old, new, inner = self.pod_slots(new_cfg.n_pods, keep)
        slot, coord = divmod(dist.get_rank(), inner)
        ranks = torch.tensor([[s * inner + j for j in range(inner)]
                              for s in new]).reshape(
                                  (len(new),) + tuple(self.mesh.mesh.shape[1:]))
        # every rank of the world takes part in making the group and the
        # mesh, in the same order
        gloo = self._shared.gloo()
        nxt = self._successor(new_cfg, mesh=self._shared.mesh(self.mesh,
                                                              ranks))
        if slot not in set(old) | set(new):
            return nxt, None
        skeleton = (_skeleton(state, pod_stacked(self.cfg.sync, state))
                    if slot in old else None)
        # a joining rank learns the leaves' shapes, placements and the
        # values without a pod dimension from old pod 0's rank
        joining = [s for s in new if s not in old]
        if slot == old[0]:
            for s in joining:
                dist.send_object_list([skeleton], s * inner + coord,
                                      group=gloo)
        elif slot in joining:
            box = [None]
            dist.recv_object_list(box, old[0] * inner + coord, group=gloo)
            skeleton = box[0]
        local = (T.tree_map(local_part, state) if state is not None
                 else _from_skeleton(skeleton, self.device))
        moves = _SplitResize(resize, old, new, slot, inner, coord, gloo)
        new_state = resize_train_state(new_cfg.sync, local, new_cfg.n_pods,
                                       resize=moves)
        nxt.reconfig_sent = moves.sent
        if slot not in new:
            return nxt, None
        return nxt, T.tree_map(lambda x, sk: _placed_as(x, sk, nxt.inpod),
                               new_state, skeleton)

    def retune(self, state: TrainState, sync: SyncConfig
               ) -> Tuple["Trainer", TrainState]:
        """Apply a retune at a sync barrier: same strategy and pod count,
        another codec tier, top-k or interval.  Params and optimizer state
        pass through untouched; the sync state goes through
        :func:`retune_sync_state` (the EF residual carries over).  An
        interval-only retune (the same :meth:`_sync_key`) also keeps the
        cached wire and chunk accounting; one of the same bucket policy keeps the
        bucket weights.  The retune runs on the sync state's fields gathered
        whole in the pod (the params give only their shapes) and writes
        them back into the placed leaves, where there are any."""
        new_cfg = dataclasses.replace(self.cfg, sync=sync)
        ss = state.sync_state
        fields = ("ef_residual", "tier", "msg_norm", "resid_norm")
        skeleton = T.tree_map(lambda x: torch.empty(
            x.shape, dtype=x.dtype, device="meta"), state.params)
        new = retune_sync_state(sync, self.cfg.sync, ss._replace(
            **{f: whole_local(getattr(ss, f)) for f in fields}), skeleton)
        sync_state = new._replace(**{
            f: _keep_placed(getattr(ss, f), getattr(new, f))
            for f in fields})
        trainer = self._successor(new_cfg)
        if sync.bucket_policy == self.cfg.sync.bucket_policy:
            trainer._bucket_weights = self._bucket_weights
        if self._sync_key(sync) == self._sync_key(self.cfg.sync):
            trainer._wire_mb = self._wire_mb
            trainer._chunk_mb = self._chunk_mb
        return trainer, state._replace(sync_state=sync_state)

    # --------------------------------------------------------------- loop
    def fit(self, state: TrainState, batches: Callable[[int], Pytree],
            n_steps: int, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 0, model_mb: float = 0.0, log_every: int = 0
            ) -> Tuple[TrainState, Dict[str, List]]:
        """batches(step) -> stacked per-pod batch dict (n_pods leading);
        ``eval_fn(state)`` every ``eval_every`` steps goes to
        ``history["eval"]`` as ``(step, value)``."""
        history: Dict[str, List] = {"step": [], "loss": [],
                                    "loss_per_pod": [], "eval": []}
        for step in range(n_steps):
            batch = batches(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            _wait(self.device)
            self.step_seconds.append(time.perf_counter() - t0)
            state = self.maybe_sync(state, step, model_mb)
            history["step"].append(step)
            history["loss"].append(float(metrics["loss"]))
            history["loss_per_pod"].append(
                metrics["loss_per_pod"].float().cpu().tolist())
            if eval_fn and eval_every and (step + 1) % eval_every == 0:
                history["eval"].append((step, eval_fn(state)))
            if log_every and (step + 1) % log_every == 0:
                print(f"step {step + 1}: loss={history['loss'][-1]:.4f}")
        return state, history


# ---------------------------------------------------------------------------
# elasticity: pod re-stacking of the train state
# ---------------------------------------------------------------------------


class _Shared:
    """What a trainer and its successors make collectively once, on every
    rank of the world, and share: a gloo group of the whole world, which
    carries a split reconfiguration's rows and the placed saves' pieces
    point to point, and the meshes by layout, so that a reconfiguration
    back to a layout takes its mesh again.  The groups a run makes are
    bounded by its layouts, however often pods leave and join; a mesh is
    kept, not destroyed, since DTensor's caches key on equal meshes."""

    def __init__(self):
        self.world = None
        self.meshes: Dict[tuple, Any] = {}

    def gloo(self):
        """The world's gloo group, made on first use (collective over the
        world), with a checkpoint writer's timeout: ranks wait on it for
        the writer's disk."""
        from datetime import timedelta

        import torch.distributed as dist

        if self.world is None:
            self.world = dist.new_group(backend="gloo",
                                        timeout=timedelta(seconds=600))
        return self.world

    def mesh(self, current, ranks: torch.Tensor):
        """The mesh over ``ranks`` with ``current``'s device type and axis
        names: one made earlier (``current`` too), else a new one."""
        from torch.distributed.device_mesh import DeviceMesh

        def key(m, r):
            return (m.device_type, tuple(m.mesh_dim_names),
                    tuple(r.shape), tuple(r.flatten().tolist()))

        self.meshes.setdefault(key(current, current.mesh), current)
        k = key(current, ranks)
        if k not in self.meshes:
            self.meshes[k] = DeviceMesh(current.device_type, ranks,
                                        mesh_dim_names=current.mesh_dim_names)
        return self.meshes[k]


def resize_train_state(sync_cfg: SyncConfig, state: TrainState, n_new: int,
                       keep: Optional[Tuple[int, ...]] = None,
                       resize=None) -> TrainState:
    """Grow or shrink the pod dimension of a :class:`TrainState`.

    ``keep`` names the surviving old pods in their new order (default: the
    first ``min(old, new)``).  Params keep their global mean; optimizer
    moments are mean-seeded on grow and kept as they are on shrink (a mean
    shift could turn Adam's second moment negative); the sync state
    follows its strategy (:func:`repro_torch.core.sync.resize_sync_state`).
    ``resize`` (a ``sync.PodResize``, or the split pod axis's row mover)
    overrides ``keep`` and ``n_new``.
    """
    if resize is None:
        resize = PodResize.of(T.leaves(state.params)[0].shape[0], n_new,
                              keep)
    params = T.tree_map(lambda x: resize.leaf(x, "mean", "mean"),
                        state.params)
    opt = T.tree_map(lambda x: resize.leaf(x, "drop", "mean"),
                     state.opt_state)
    sync_state = resize_sync_state(sync_cfg, state.sync_state, params,
                                   resize=resize)
    return TrainState(params=params, opt_state=opt, sync_state=sync_state,
                      step=state.step)


@dataclass(frozen=True)
class _Leaf:
    """A leaf's description for a rank that joins without a state: the
    local shape and dtype, the in-pod placements and whole-in-pod shape
    of a DTensor (``None``: a plain tensor), and the value of a leaf that
    every pod holds alike (an ``int`` step, or a small host tensor)."""
    shape: Tuple[int, ...]
    dtype: Any
    placements: Optional[tuple]
    global_shape: Tuple[int, ...]
    value: Any


def _skeleton(state: TrainState, stacked: TrainState) -> TrainState:
    """``state``'s leaves described for a joining rank: the pod-stacked
    ones (``stacked``) by shape, the rest by value too (on the host)."""
    def each(x, st):
        if not isinstance(x, torch.Tensor):
            return _Leaf((), None, None, (), int(x))
        local = local_part(x)
        return _Leaf(tuple(local.shape), local.dtype,
                     tuple(x.placements) if is_dtensor(x) else None,
                     tuple(x.shape),
                     None if st else local.detach().cpu())
    return T.tree_map(each, state, stacked)


def _from_skeleton(skeleton: TrainState, device) -> TrainState:
    """A joining rank's local leaves: empty rows where the old rows go
    (never read: it holds no old pod), the shared values as they are."""
    def each(leaf: _Leaf):
        if leaf.dtype is None:
            return leaf.value
        if leaf.value is not None:
            return leaf.value.to(device)
        return torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    return T.tree_map(each, skeleton)


def _placed_as(x, like, inpod):
    """A new local leaf placed as ``like`` (a placed leaf or a
    :class:`_Leaf`) was, on the in-pod mesh ``inpod``: a DTensor with the
    same placements whose whole-in-pod shape takes ``x``'s rows."""
    placements = (like.placements if isinstance(like, _Leaf) else
                  tuple(like.placements) if is_dtensor(like) else None)
    if placements is None or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor

    shape = list(like.global_shape if isinstance(like, _Leaf)
                 else like.shape)
    if x.dim() and not any(p.is_shard(0) for p in placements):
        shape[0] = x.shape[0]
    return DTensor.from_local(x, inpod, placements, run_check=False,
                              shape=tuple(shape), stride=contiguous_stride(shape))


# values a chunk of a row moves and resizes at a time
_RESIZE_CHUNK = 1 << 24


class _SplitResize:
    """The rows of a :class:`~repro_torch.core.sync.PodResize` moved over a
    split pod axis, one pod a slot of ranks: for one in-pod coordinate,
    each new pod's row is computed on its own rank (``PodResize.row``,
    the whole resize's expression, column chunk by column chunk) from the
    old rows it needs, which their ranks send point to point over
    ``group`` (gloo; rows on the card travel through host memory).  Every
    rank of the group calls :meth:`leaf` for the same leaves in the same
    order; ``x`` is this rank's local rows ``(1, ...)`` (a joiner's are
    empty)."""

    def __init__(self, resize: PodResize, old, new, slot: int, inner: int,
                 coord: int, group):
        self.resize, self.group = resize, group
        self.n_old, self.keep, self.n_new = resize
        self.old, self.new = list(old), list(new)
        self.old_i = self.old.index(slot) if slot in self.old else None
        self.new_i = self.new.index(slot) if slot in self.new else None
        self.rank_of = lambda s: s * inner + coord
        self.sent = 0          # bytes this rank sent point to point

    def leaf(self, x: torch.Tensor, shrink: str, grow: str) -> torch.Tensor:
        import torch.distributed as dist

        r = self.resize
        if r.identity:
            return x
        # the (old pod, new pod) pairs whose row crosses ranks, this rank's
        mine = [(p, i) for i in range(self.n_new)
                for p in sorted(r.needs(shrink, grow, i))
                if self.old[p] != self.new[i]
                and (p == self.old_i or i == self.new_i)]
        # this rank's new row is its old row as it is
        same = (self.new_i is not None and self.new_i < len(self.keep)
                and self.keep[self.new_i] == self.old_i
                and (not r.shrunk or shrink == "drop"))
        out = (torch.empty_like(x) if self.new_i is not None and not same
               else None)
        n = x[0].numel()
        if not mine and out is None or n == 0:
            return x if out is None else out
        row = (x.reshape(x.shape[0], -1)[0] if self.old_i is not None
               else None)
        flat_out = out.reshape(-1) if out is not None else None
        for a in range(0, n, _RESIZE_CHUNK):
            b = min(n, a + _RESIZE_CHUNK)
            rows: List[Optional[torch.Tensor]] = [None] * self.n_old
            if row is not None:
                rows[self.old_i] = row[a:b]
            ops, got = [], {}
            for p, i in mine:
                if p == self.old_i:
                    ops.append(dist.P2POp(dist.isend, row[a:b].cpu(),
                                          self.rank_of(self.new[i]),
                                          self.group))
                    self.sent += (b - a) * x.element_size()
                elif p not in got:
                    got[p] = torch.empty(b - a, dtype=x.dtype)
                    ops.append(dist.P2POp(dist.irecv, got[p],
                                          self.rank_of(self.old[p]),
                                          self.group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            for p, t in got.items():
                rows[p] = t.to(x.device)
            if flat_out is not None:
                like = torch.empty(b - a, dtype=x.dtype, device=x.device)
                flat_out[a:b] = r.row(rows, like, shrink, grow, self.new_i)
        return x if out is None else out


def apply_reconfig(trainer: Trainer, state: TrainState, reconfig
                   ) -> Tuple[Trainer, TrainState, bool]:
    """Bridge a control-plane reconfiguration plan (``is_noop``,
    ``pod_transition() -> (keep, n_new)``, ``new.request.sync``) onto a
    live trainer; returns ``(trainer, state, applied)``.  An empty plan
    leaves both untouched."""
    if reconfig.is_noop:
        return trainer, state, False
    keep, n_new = reconfig.pod_transition()
    new_trainer, new_state = trainer.reconfigure(
        state, n_new, keep=keep, sync=reconfig.new.request.sync)
    return new_trainer, new_state, True


# ---------------------------------------------------------------------------
# elasticity: live pod migration off the step path
# ---------------------------------------------------------------------------


def _resized_like(tree: Pytree, n_old: int, n_new: int,
                  stacked: Optional[Pytree] = None) -> Pytree:
    """Shape and dtype skeleton of ``tree`` on the ``meta`` device (nothing
    allocated) with every pod-stacked leaf's leading dimension re-sized
    ``n_old -> n_new``: the leaves ``stacked`` marks (a tree of bools,
    :func:`pod_stacked`), else those that lead with ``n_old``; ``int``
    leaves (the step) pass through."""
    flags = (T.leaves(stacked) if stacked is not None else
             [isinstance(x, torch.Tensor) and x.dim() >= 1
              and x.shape[0] == n_old for x in T.leaves(tree)])

    def f(x, st):
        if not isinstance(x, torch.Tensor):
            return x
        shape = tuple(x.shape)
        if st:
            shape = (n_new,) + shape[1:]
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return T.unflatten(tree, [f(x, st) for x, st in
                              zip(T.leaves(tree), flags)])


class LiveMigrator:
    """Live pod migration: a grow or shrink staged off the training step.

    On a ``PlanDiff`` the surviving pods keep stepping.  :meth:`stage`
    materializes the target-pod-count state from the async engine's last
    durable snapshot on a background thread, through the checkpoint
    layer's ``pod_resize="mean"`` transform, onto the host: in a
    deployment this is the bulk WAN shipment of the migration (the
    ``migration_wire_mb`` bytes the DES bills as overlapped background
    traffic).  At the next sync barrier :meth:`reconcile` applies the
    pod-resize transforms to the *live* state (:func:`apply_reconfig` /
    :func:`resize_train_state`: EF residuals and optimizer moments carried
    under the invariants ``retune_sync_state`` guarantees), so the
    reconciled state is bit-identical to a pause-and-restore taken at the
    barrier; the staged restore validates the target structure and stands
    by as the recovery base if the barrier never comes (a pod crash
    mid-migration).  The reconfiguration's only stall is the one barrier
    it reconciles at, plus whatever of the stage (draining the engine's
    queue, reading the snapshot) has not finished by then."""

    def __init__(self, engine):
        self.engine = engine
        self._pending: Optional[Tuple[threading.Thread, Dict[str, Any]]] = None
        self.migrations = 0
        self.restaged = 0
        self.staged_mb = 0.0
        self.errors: List[Exception] = []
        self.last_staged: Optional[Dict[str, Any]] = None

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def stage(self, state: Optional[TrainState], n_new: int,
              keep: Optional[Tuple[int, ...]] = None, *,
              trainer: Optional[Trainer] = None,
              like: Optional[TrainState] = None) -> None:
        """Start materializing the ``n_new``-pod state from the last
        durable snapshot in the background.  Supersedes any earlier
        un-reconciled stage (the launcher composes events between
        barriers: only the barrier-time plan is reconciled).

        With a ``trainer`` on a split pod axis, each rank of the new pod
        group stages its own rows (``trainer.new_rows``), a joining rank
        (``state=None``) included, and a departing rank stages nothing;
        the skeleton is the whole state's shapes (``like``: e.g.
        ``TrainSetup.abstract_state``; default: read off ``state``'s
        parts), never the local leading dimension."""
        from repro_torch.checkpoint import checkpoint as _ckpt

        if self._pending is not None:
            self._join_pending(superseded=True)
        parts = None
        if trainer is not None and trainer.mesh is not None:
            rows = trainer.new_rows(n_new, keep)
            if rows is None:
                return
            if like is None:
                if state is None:
                    raise ValueError("a joining rank stages from the whole "
                                     "state's shapes: pass like=")
                like = T.tree_map(
                    lambda x, p: torch.empty(p.shape, dtype=x.dtype,
                                             device="meta")
                    if isinstance(x, torch.Tensor) else x,
                    state, trainer.leaf_parts(state))
            like = _resized_like(like, None, n_new,
                                 pod_stacked(trainer.cfg.sync, like))
            parts = trainer.leaf_parts(like, rows=rows)
        else:
            like = _resized_like(state, T.leaves(state.params)[0].shape[0],
                                 n_new)
        holder: Dict[str, Any] = {"n_new": n_new,
                                  "keep": tuple(keep) if keep else None}

        def work():
            try:
                self.engine.wait()
                durable = self.engine.last_durable()
                if durable is None:
                    return
                snap_step, path = durable
                staged, ckpt_step = _ckpt.restore(path, like=like,
                                                  device="cpu",
                                                  pod_resize="mean",
                                                  parts=parts)
                holder.update(
                    state=staged, snapshot_step=snap_step,
                    ckpt_step=ckpt_step,
                    mb=sum(x.numel() * x.element_size()
                           for x in T.leaves(staged.params)) / 1e6)
            except Exception as e:   # noqa: BLE001 — surfaced at reconcile
                holder["error"] = e

        t = threading.Thread(target=work, daemon=True, name="live-migrator")
        t.start()
        self._pending = (t, holder)

    def wait(self) -> None:
        """Block until the pending stage, if any, has finished; it stays
        pending for :meth:`reconcile`, whose barrier then holds only the
        resize."""
        if self._pending is not None:
            self._pending[0].join()

    def _join_pending(self, superseded: bool = False) -> Optional[Dict]:
        t, holder = self._pending
        t.join()
        self._pending = None
        err = holder.get("error")
        if err is not None:
            # a failed stage degrades to a plain barrier re-stack: the
            # reconcile math never depended on the staged bytes
            self.errors.append(err)
            return None
        if superseded:
            self.restaged += 1
            return None
        if "state" not in holder:
            return None   # no durable snapshot yet: nothing was staged
        return holder

    def reconcile(self, trainer: Trainer, state: TrainState, reconfig
                  ) -> Tuple[Trainer, TrainState, bool]:
        """At the sync barrier: reconcile the migration against the live
        state.  Same signature and semantics as :func:`apply_reconfig`, and
        bit-identical results: the staged snapshot never enters the
        numerics, it only pre-moved the bytes a joining or leaving pod
        needs and pre-validated the target structure.  On a split pod axis
        every rank of the world calls it, a departing one getting ``None``
        for its state (``Trainer.reconfigure``)."""
        staged = self._join_pending() if self._pending is not None else None
        new_trainer, new_state, applied = apply_reconfig(trainer, state,
                                                         reconfig)
        if not applied:
            return new_trainer, new_state, applied
        self.migrations += 1
        if staged is not None:
            if staged["n_new"] != new_trainer.cfg.n_pods:
                # the plan evolved between stage and barrier: the staged
                # skeleton is stale, and the barrier re-stack covered it
                self.restaged += 1
            elif new_state is not None:
                ref = T.leaves(new_state.params)
                got = T.leaves(staged["state"].params)
                if [(tuple(a.shape), a.dtype) for a in got] != \
                        [(tuple(a.shape), a.dtype) for a in ref]:
                    raise RuntimeError(
                        "staged migration skeleton does not match the "
                        "reconciled state — snapshot/plan divergence")
                self.staged_mb += staged["mb"]
                self.last_staged = staged
        return new_trainer, new_state, applied


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def stack_pod_batches(batches: List[Dict[str, np.ndarray]], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Stack per-cloud host batches on ``device``, padding uneven batch
    sizes with masked copies of the last example (``example_mask`` 0) so
    the elastic scheduler's uneven splits fit the stacked shape."""
    max_b = max(len(next(iter(b.values()))) for b in batches)
    out: Dict[str, List[np.ndarray]] = {}
    for b in batches:
        n = len(next(iter(b.values())))
        pad = max_b - n
        mask = np.concatenate([np.ones(n, np.float32),
                               np.zeros(pad, np.float32)])
        for k, v in b.items():
            if pad:
                v = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
            out.setdefault(k, []).append(v)
        out.setdefault("example_mask", []).append(mask)
    return {k: torch.from_numpy(np.stack(v)).to(device)
            for k, v in out.items()}


def accuracy_eval(apply_fn: Callable, data: Dict[str, np.ndarray],
                  batch: int = 512) -> Callable[[TrainState], float]:
    """Eval callback: mean over batches of pod 0's accuracy on held-out
    data (a 1-D logit is binary: ``logit > 0``)."""

    def fn(state: TrainState) -> float:
        p0 = T.tree_map(lambda x: x[0], state.params)
        dev = T.leaves(p0)[0].device
        n = len(data["y"])
        accs = []
        with torch.no_grad():
            for i in range(0, n, batch):
                x = torch.from_numpy(data["x"][i:i + batch]).to(dev)
                y = torch.from_numpy(data["y"][i:i + batch]).to(dev)
                logits = apply_fn(p0, x)
                pred = ((logits > 0).to(y.dtype) if logits.dim() == 1
                        else logits.argmax(-1))
                accs.append(float((pred == y).float().mean()))
        return float(np.mean(accs))

    return fn
