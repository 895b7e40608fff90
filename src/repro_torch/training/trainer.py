"""Geo-distributed trainer: per-pod train step + sync-strategy integration.

Counterpart of the in-graph path of ``repro/training/trainer.py``.  Every
leaf of ``params`` / ``opt_state`` / ``ga_buffer`` (and the codec's flat
``ef_residual``) has a leading **pod** dimension.  The per-pod step is a
loop over that dimension: each pod's loss and gradients come from autograd
on its slice of the parameters, which is what the reference's ``jax.vmap``
of ``value_and_grad`` computes.  Every ``interval`` steps the sync round
runs: on the codec path the three stages of ``repro_torch.core.sync``
(prepare -> inline ring ship -> finish), through the CUDA codec kernels on
the card; the other strategies through ``apply_sync`` (sparse shipping
through the CUDA top-k kernel).  ``reconfigure`` / ``resize_train_state``
/ ``apply_reconfig`` re-stack the pod dimension at a barrier, and
``retune`` swaps the sync config of the same strategy.

The step updates the stacked parameters and optimizer state in place
(slice by slice) instead of building new stacked tensors: at full width the
parameters are gigabytes, and nothing reads a train state after the step
that replaced it.

Host-seam, streaming, masked rounds and live migration are ROADMAP Queue 1
items 11 and 12.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.sync import (SyncConfig, SyncState, apply_sync,
                                   bucket_layout, bucket_weights_of,
                                   bucket_wire_mb, finish_codec_sync,
                                   grow_pods, init_sync_state, is_sync_step,
                                   on_step_gradients, prepare_codec_sync,
                                   resize_sync_state, retune_sync_state,
                                   ship_sync_payloads, shrink_pods,
                                   traffic_per_step_mb)
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
        round as ``round_hook(state, payloads, shipped, sync)`` (``sync``:
        the round's config, whose tiers a retune changes), outside the
        round's timing: a check uses it to hold the round against its
        plain version.  Other strategies' rounds have no hook of their own;
        ``kernels.ops.TOPK_CHECK_HOOK`` sees each sparse ship."""
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
            # the step's queued device work is not the round's
            _wait(self.device)
            t0 = time.perf_counter()
            state, rnd = self._sync_round(state)
            _wait(self.device)
            self.sync_seconds.append(time.perf_counter() - t0)
            if self.round_hook is not None and rnd is not None:
                self.round_hook(state, *rnd, self.cfg.sync)
        return state

    # ------------------------------------------------------ elasticity
    def _successor(self, cfg: TrainerConfig) -> "Trainer":
        nxt = Trainer(self.loss_fn, self.init_fn, cfg, device=self.device,
                      round_hook=self.round_hook)
        nxt.traffic_mb = self.traffic_mb
        nxt.step_seconds = self.step_seconds
        nxt.sync_seconds = self.sync_seconds
        return nxt

    def reconfigure(self, state: TrainState, n_pods: int,
                    keep: Optional[Tuple[int, ...]] = None,
                    sync: Optional[SyncConfig] = None
                    ) -> Tuple["Trainer", TrainState]:
        """Apply a reconfiguration at a sync barrier: re-stack the pod
        dimension of the whole train state (:func:`resize_train_state`)
        and return a new ``Trainer`` for the new pod count and sync config,
        with the WAN-traffic account carried over."""
        new_cfg = dataclasses.replace(self.cfg, n_pods=n_pods,
                                      sync=sync or self.cfg.sync)
        new_state = resize_train_state(new_cfg.sync, state, n_pods,
                                       keep=keep)
        return self._successor(new_cfg), new_state

    def retune(self, state: TrainState, sync: SyncConfig
               ) -> Tuple["Trainer", TrainState]:
        """Apply a retune at a sync barrier: same strategy and pod count,
        another codec tier, top-k or interval.  Params and optimizer state
        pass through untouched; the sync state goes through
        :func:`retune_sync_state` (the EF residual carries over).  An
        interval-only retune (the same :meth:`_sync_key`) also keeps the
        cached wire accounting; one of the same bucket policy keeps the
        bucket weights."""
        new_cfg = dataclasses.replace(self.cfg, sync=sync)
        sync_state = retune_sync_state(sync, self.cfg.sync, state.sync_state,
                                       state.params)
        trainer = self._successor(new_cfg)
        if sync.bucket_policy == self.cfg.sync.bucket_policy:
            trainer._bucket_weights = self._bucket_weights
        if self._sync_key(sync) == self._sync_key(self.cfg.sync):
            trainer._wire_mb = self._wire_mb
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


def resize_train_state(sync_cfg: SyncConfig, state: TrainState, n_new: int,
                       keep: Optional[Tuple[int, ...]] = None) -> TrainState:
    """Grow or shrink the pod dimension of a :class:`TrainState`.

    ``keep`` names the surviving old pods in their new order (default: the
    first ``min(old, new)``).  Params keep their global mean; optimizer
    moments are mean-seeded on grow and kept as they are on shrink (a mean
    shift could turn Adam's second moment negative); the sync state
    follows its strategy (:func:`repro_torch.core.sync.resize_sync_state`).
    """
    n_old = T.leaves(state.params)[0].shape[0]
    if keep is None:
        keep = tuple(range(min(n_old, n_new)))
    if len(keep) > n_new:
        raise ValueError(f"keep={keep} longer than n_new={n_new}")
    shrunk = len(keep) < n_old
    params, opt = state.params, state.opt_state
    if shrunk:
        params = shrink_pods(params, keep, how="mean")
        opt = shrink_pods(opt, keep, how="drop")
    if n_new > len(keep):
        params = grow_pods(params, n_new, how="mean")
        opt = grow_pods(opt, n_new, how="mean")
    sync_state = resize_sync_state(sync_cfg, state.sync_state, params,
                                   keep=keep if shrunk else None)
    return TrainState(params=params, opt_state=opt, sync_state=sync_state,
                      step=state.step)


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
