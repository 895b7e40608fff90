"""Uniform model-function dispatch (the decoder-only module only)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def get_model_fns(module: str) -> ModelFns:
    if module == "transformer":
        return ModelFns(init_params=transformer.init_params,
                        loss_fn=transformer.loss_fn,
                        forward=transformer.forward,
                        prefill=transformer.prefill,
                        decode_step=transformer.decode_step,
                        init_cache=transformer.init_cache)
    raise NotImplementedError(
        f"model module {module!r} is not ported yet: see ROADMAP.md "
        f"Queue 1 item 13")
