"""Functional optimizers over nested dicts of tensors.

Counterpart of ``repro/optim/optimizers.py``: ``update(grads, state, params,
lr) -> (new_params, new_state)``, math in f32 and every result cast back to
the dtype of what it replaces (``_cast_like``), so bf16 parameters stay
bf16.  The trainer calls ``update`` once per pod on that pod's slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as T

Pytree = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree, float], Tuple[Pytree, Pytree]]


def _cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(ref.dtype)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = T.tree_map(
            lambda p, g: _cast_like(p.float() - lr * g.float(), p),
            params, grads)
        return new, state

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9, state_dtype: str = "float32",
             nesterov: bool = False) -> Optimizer:
    sdt = _dtype(state_dtype)

    def init(params):
        return T.tree_map(lambda p: torch.zeros(p.shape, dtype=sdt,
                                                device=p.device), params)

    def update(grads, state, params, lr):
        new_m = T.tree_map(
            lambda m, g: _cast_like(beta * m.float() + g.float(), m),
            state, grads)
        if nesterov:
            step = T.tree_map(lambda g, m: g.float() + beta * m.float(),
                              grads, new_m)
        else:
            step = T.tree_map(lambda m: m.float(), new_m)
        new_p = T.tree_map(lambda p, s: _cast_like(p.float() - lr * s, p),
                           params, step)
        return new_p, new_m

    return Optimizer(f"momentum{beta}", init, update)


class AdamState(NamedTuple):
    mu: Pytree
    nu: Pytree
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype: str = "float32"
          ) -> Optimizer:
    sdt = _dtype(state_dtype)

    def init(params):
        dev = T.leaves(params)[0].device
        z = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)  # noqa: E731
        return AdamState(mu=T.tree_map(z, params), nu=T.tree_map(z, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=dev))

    def update(grads, state, params, lr):
        count = state.count + 1
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()
        new_mu = T.tree_map(
            lambda m, g: _cast_like(b1 * m.float() + (1 - b1) * g.float(), m),
            state.mu, grads)
        new_nu = T.tree_map(
            lambda v, g: _cast_like(b2 * v.float()
                                    + (1 - b2) * torch.square(g.float()), v),
            state.nu, grads)

        def upd(p, m, v):
            step = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)
            if weight_decay and p.dim() >= 2:
                step = step + weight_decay * p.float()
            return _cast_like(p.float() - lr * step, p)

        new_p = T.tree_map(upd, params, new_mu, new_nu)
        return new_p, AdamState(new_mu, new_nu, count)

    return Optimizer(f"adamw{b1},{b2}", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: float(lr)


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def clip_by_global_norm(tree: Pytree, max_norm: float) -> Pytree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.tree_map(lambda x: (x.float() * scale).to(x.dtype), tree)
