"""Uniform model-function dispatch over the two model modules."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.models import encdec, transformer


@dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    abstract_params: Callable
    param_logical_axes: Callable
    loss_fn: Callable
    forward: Callable
    decode_step: Callable
    init_cache: Callable
    cache_logical_axes: Callable
    prefill: Optional[Callable] = None


def get_model_fns(module: str) -> ModelFns:
    if module == "transformer":
        return ModelFns(init_params=transformer.init_params,
                        abstract_params=transformer.abstract_params,
                        param_logical_axes=transformer.param_logical_axes,
                        cache_logical_axes=transformer.cache_logical_axes,
                        loss_fn=transformer.loss_fn,
                        forward=transformer.forward,
                        prefill=transformer.prefill,
                        decode_step=transformer.decode_step,
                        init_cache=transformer.init_cache)
    if module == "encdec":
        return ModelFns(init_params=encdec.init_params,
                        abstract_params=encdec.abstract_params,
                        param_logical_axes=encdec.param_logical_axes,
                        cache_logical_axes=encdec.cache_logical_axes,
                        loss_fn=encdec.loss_fn,
                        forward=encdec.forward,
                        decode_step=encdec.decode_step,
                        init_cache=encdec.init_cache)
    raise KeyError(module)
