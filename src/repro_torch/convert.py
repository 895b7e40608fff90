"""Carry the reference's numbers into the port.

torch's generators cannot reproduce JAX's, so where the two packages must
compute from the same numbers (the parity tests), the JAX side's arrays are
handed over as numpy and turned into the port's tensors here.  The trees
have the same structure on both sides (the scanned ``blocks`` keep their
leading group axis), so conversion is leaf for leaf.  bfloat16 arrays
(numpy dtype ``bfloat16`` from ``ml_dtypes``) are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.sync import SyncState
from repro_torch.models import encdec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache
from repro_torch.models.ssm import SSMCache


def to_tensor(a: Any, device="cuda") -> torch.Tensor:
    """One numpy array (or array-like) -> tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_jax(np_tree: Any, cfg: ModelConfig, device="cuda") -> Any:
    """The JAX parameter tree (leaves as numpy) -> the port's parameters,
    checked against ``cfg``'s parameter count (the decoder-only tree's,
    with its MoE leaves, or the encoder-decoder tree's)."""
    out = T.tree_map(lambda a: to_tensor(a, device), np_tree)
    n = sum(x.numel() for x in T.leaves(out))
    want = encdec.param_count(cfg) if cfg.is_encdec else cfg.param_count()
    if n != want:
        raise ValueError(f"tree holds {n} parameters, {cfg.name} has "
                         f"{want}")
    return out


def paper_params_from_numpy(np_tree: Any, model: str, device="cuda") -> Any:
    """The reference's parameters of a paper model (``"lenet"``,
    ``"resnet"`` or ``"deepfm"``; leaves as numpy) -> the port's, checked
    leaf for leaf against the port's layout of that model (HWIO convs,
    ``(in, out)`` dense weights: the same on both sides)."""
    from repro_torch.models.reference import PAPER_MODELS

    out = T.tree_map(lambda a: to_tensor(a, device), np_tree)
    like = PAPER_MODELS[model]["init"](torch.Generator().manual_seed(0),
                                       "cpu")
    got = [(p, tuple(x.shape)) for p, x in T.leaves_with_path(out)]
    want = [(p, tuple(x.shape)) for p, x in T.leaves_with_path(like)]
    if got != want:
        raise ValueError(f"tree does not hold {model}'s parameters: "
                         f"{got} != {want}")
    return out


def sync_state_from_jax(np_state: Any, device="cuda") -> SyncState:
    """A reference ``SyncState`` (leaves as numpy) -> the port's."""
    return SyncState(*(T.tree_map(lambda a: to_tensor(a, device), getattr(
        np_state, f)) for f in SyncState._fields))


def cache_from_jax(np_cache: Any, device="cuda") -> Any:
    """A reference decode cache (``{"pos<i>": KVCache(k, v)}`` or
    ``SSMCache(state, conv)`` per position, or an ``EncDecCache(self_kv,
    cross_k, cross_v)``, leaves as numpy with their leading group axis) ->
    the port's."""
    if getattr(np_cache, "_fields", None) == encdec.EncDecCache._fields:
        return encdec.EncDecCache(
            self_kv=KVCache(*(to_tensor(a, device)
                              for a in np_cache.self_kv)),
            cross_k=to_tensor(np_cache.cross_k, device),
            cross_v=to_tensor(np_cache.cross_v, device))
    kinds = {KVCache._fields: KVCache, SSMCache._fields: SSMCache}
    out = {}
    for key, c in np_cache.items():
        kind = kinds.get(getattr(c, "_fields", None))
        if kind is None:
            raise ValueError(f"{key}: not a KVCache or SSMCache: {type(c)}")
        out[key] = kind(*(to_tensor(a, device) for a in c))
    return out
