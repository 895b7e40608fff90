"""Assigned input shapes and each architecture's input specs.

Counterpart of ``repro/launch/shapes.py``: the same four shapes, the same
``long_500k`` applicability rule, and the inputs of each step as tensors on
the ``meta`` device (the reference's ``jax.ShapeDtypeStruct``s): shape and
dtype, nothing allocated.

- ``train_4k``    -> train step (stacked per-pod batches, labels shifted)
- ``prefill_32k`` -> prefill    (build the KV cache from a 32k prompt)
- ``decode_32k``  -> decode step (one new token, 32k cache)
- ``long_500k``   -> decode step (one token, 524k cache): sub-quadratic
  state only (SSM, hybrid, windowed attention); the others are skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.configs import Arch


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def long_context_supported(arch: Arch) -> Tuple[bool, str]:
    """Which archs run ``long_500k``: the reference's rule."""
    if arch.module == "encdec":
        return False, "enc-dec decoder context is architecturally bounded (448)"
    if arch.config.subquadratic:
        return True, ""
    return False, "pure global attention; no windowed variant in model card"


def shape_supported(arch: Arch, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k":
        return long_context_supported(arch)
    return True, ""


def _token_specs(batch: int, seq: int, *, labels: bool
                 ) -> Dict[str, torch.Tensor]:
    d = {"tokens": _spec((batch, seq), torch.int32)}
    if labels:
        d["labels"] = _spec((batch, seq), torch.int32)
    return d


def _extras(arch: Arch, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    cfg = arch.config
    cdt = cfg.dtype("compute")
    out: Dict[str, torch.Tensor] = {}
    if arch.module == "encdec":
        out["audio_emb"] = _spec((batch, cfg.encoder_ctx, cfg.d_model), cdt)
    if cfg.vision_patches:
        out["patch_emb"] = _spec((batch, cfg.vision_patches, cfg.d_model),
                                 cdt)
        out["positions"] = _spec((3, batch, seq), torch.int32)
    return out


def train_batch_specs(arch: Arch, shape: InputShape, n_pods: int
                      ) -> Dict[str, torch.Tensor]:
    """Stacked per-pod train batch: leaves ``(n_pods, B / n_pods, ...)``."""
    if shape.global_batch % n_pods:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {n_pods} pods")
    b = shape.global_batch // n_pods
    flat = {**_token_specs(b, shape.seq_len, labels=True),
            **_extras(arch, b, shape.seq_len)}
    return {k: _spec((n_pods,) + tuple(v.shape), v.dtype)
            for k, v in flat.items()}


def prefill_specs(arch: Arch, shape: InputShape) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    return {**_token_specs(b, shape.seq_len, labels=False),
            **_extras(arch, b, shape.seq_len)}


def decode_specs(arch: Arch, shape: InputShape) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    return {"token": _spec((b, 1), torch.int32),
            "cache_pos": _spec((), torch.int32)}
