"""Geo-distributed trainer: per-pod train step + sync-strategy integration.

Counterpart of the in-graph path of ``repro/training/trainer.py``.  Every
leaf of ``params`` / ``opt_state`` / ``ga_buffer`` (and the codec's flat
``ef_residual``) has a leading **pod** dimension.  The per-pod step is a
loop over that dimension: each pod's loss and gradients come from autograd
on its slice of the parameters, which is what the reference's ``jax.vmap``
of ``value_and_grad`` computes.  Every ``interval`` steps the sync round
runs: on the codec path the three stages of ``repro_torch.core.sync``
(prepare -> inline ring ship -> finish), through the CUDA codec kernels on
the card.

The step updates the stacked parameters and optimizer state in place
(slice by slice) instead of building new stacked tensors: at full width the
parameters are gigabytes, and nothing reads a train state after the step
that replaced it.

Host-seam, streaming, masked rounds, retunes and reconfiguration are
ROADMAP Queue 1 items 8 and 11.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.sync import (SyncConfig, SyncState, apply_sync,
                                   bucket_layout, bucket_weights_of,
                                   bucket_wire_mb, finish_codec_sync,
                                   init_sync_state, is_sync_step,
                                   on_step_gradients, prepare_codec_sync,
                                   ship_sync_payloads, traffic_per_step_mb)
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          constant_schedule, get_optimizer,
                                          global_norm)

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


def _stack(trees: List[Pytree]) -> Pytree:
    return T.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _pod(tree: Pytree, p: int) -> Pytree:
    return T.tree_map(lambda x: x[p], tree)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, loss_fn: Callable, init_fn: Callable,
                 cfg: TrainerConfig, device="cuda",
                 round_hook: Optional[Callable] = None):
        """loss_fn(params, batch) -> (loss, metrics dict);
        init_fn(generator) -> params (single pod, on ``device``).

        Payloads ship over the inline ring (``torch.roll`` over the pod
        dimension).  ``round_hook``, if given, is called after each codec
        round as ``round_hook(state, payloads, shipped)``, outside the
        round's timing: a check uses it to hold the round against its
        plain version."""
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.cfg = cfg
        self.device = torch.device(device)
        self.round_hook = round_hook
        self.optimizer = cfg.make_optimizer()
        self.schedule = cfg.make_schedule()
        self._bucket_weights: Optional[Dict[str, float]] = None
        self._wire_mb: Optional[Dict[str, float]] = None
        self.traffic_mb = 0.0
        self.step_seconds: List[float] = []
        self.sync_seconds: List[float] = []

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
        lr = self.schedule(state.step)
        n = T.leaves(state.params)[0].shape[0]
        losses, grads, extra = [], [], []
        for p in range(n):
            pp = T.tree_map(lambda x: x[p].detach().requires_grad_(True),
                            state.params)
            loss, metrics = self.loss_fn(pp, {k: v[p]
                                              for k, v in batch.items()})
            g = torch.autograd.grad(loss, T.leaves(pp))
            grads.append(T.unflatten(pp, list(g)))
            losses.append(loss.detach())
            extra.append({k: v.detach() for k, v in metrics.items()
                          if k != "loss"})
        grads = _stack(grads)
        if self.cfg.clip_norm > 0:
            grads = _stack([clip_by_global_norm(_pod(grads, p),
                                                self.cfg.clip_norm)
                            for p in range(n)])
        grads, sync_state = on_step_gradients(self.cfg.sync, grads,
                                              state.sync_state)
        for p in range(n):
            params_p, opt_p = _pod(state.params, p), _pod(state.opt_state, p)
            new_p, new_opt = self.optimizer.update(_pod(grads, p), opt_p,
                                                   params_p, lr)
            T.tree_map(lambda dst, src: dst.copy_(src), params_p, new_p)
            T.tree_map(lambda dst, src: dst.copy_(src), opt_p, new_opt)
        loss_per_pod = torch.stack(losses)
        out = {"loss": loss_per_pod.mean(), "loss_per_pod": loss_per_pod,
               "grad_norm": torch.stack([global_norm(_pod(grads, p))
                                         for p in range(n)]),
               "lr": lr}
        for k in extra[0]:
            out[k] = torch.stack([e[k] for e in extra]).mean()
        return TrainState(state.params, state.opt_state, sync_state,
                          state.step + 1), out

    def _sync_round(self, state: TrainState):
        """One sync round -> (state, (payloads, shipped) or None)."""
        lr = self.schedule(state.step)
        cfg = self.cfg.sync
        if not cfg.uses_codec:
            params, sync_state = apply_sync(cfg, state.params,
                                            state.sync_state, lr)
            return state._replace(params=params,
                                  sync_state=sync_state), None
        payloads = prepare_codec_sync(cfg, state.sync_state)
        shipped = ship_sync_payloads(cfg, payloads.chunks,
                                     wire_mb=self.wire_mb(state))
        params, sync_state = finish_codec_sync(cfg, state.params,
                                               state.sync_state, payloads,
                                               shipped, lr)
        return (state._replace(params=params, sync_state=sync_state),
                (payloads, shipped))

    def maybe_sync(self, state: TrainState, host_step: int,
                   model_mb: float = 0.0) -> TrainState:
        if self.cfg.n_pods > 1:
            self.traffic_mb += traffic_per_step_mb(
                self.cfg.sync, model_mb,
                bucket_weights=self.bucket_weights(state)) * self.cfg.n_pods
        if is_sync_step(self.cfg.sync, host_step) and self.cfg.n_pods > 1:
            t0 = time.perf_counter()
            state, rnd = self._sync_round(state)
            _wait(self.device)
            self.sync_seconds.append(time.perf_counter() - t0)
            if self.round_hook is not None and rnd is not None:
                self.round_hook(state, *rnd)
        return state

    # --------------------------------------------------------------- loop
    def fit(self, state: TrainState, batches: Callable[[int], Pytree],
            n_steps: int, *, model_mb: float = 0.0, log_every: int = 0
            ) -> Tuple[TrainState, Dict[str, List]]:
        """batches(step) -> stacked per-pod batch dict (n_pods leading)."""
        history: Dict[str, List] = {"step": [], "loss": [],
                                    "loss_per_pod": []}
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
            if log_every and (step + 1) % log_every == 0:
                print(f"step {step + 1}: loss={history['loss'][-1]:.4f}")
        return state, history
