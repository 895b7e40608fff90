"""Architecture registry of the port: ``--arch <id>`` resolves here.

Ported: the dense decoders ``granite-8b``, ``gemma3-12b`` (5:1 local:global
windows, head_dim 256), ``minitron-8b`` and ``gemma2-27b`` (alternating
windows, attention and final-logit soft-caps), the SSM ``mamba2-1.3b``, the
MoE decoders ``qwen3-moe-30b-a3b`` and ``kimi-k2-1t-a32b``, the hybrid
``jamba-1.5-large-398b`` (Mamba and attention positions, MoE on every other
one), the encoder-decoder ``whisper-tiny`` (module ``encdec``) and the
vision-language ``qwen2-vl-2b`` (M-RoPE, a stubbed vision encoder's patch
embeddings over the first positions): every arch of the reference's
registry, in its order.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-moe-30b-a3b": ("qwen3_moe_30b_a3b", "transformer"),
    "jamba-1.5-large-398b": ("jamba_1_5_large_398b", "transformer"),
    "mamba2-1.3b": ("mamba2_1_3b", "transformer"),
    "whisper-tiny": ("whisper_tiny", "encdec"),
    "granite-8b": ("granite_8b", "transformer"),
    "kimi-k2-1t-a32b": ("kimi_k2_1t_a32b", "transformer"),
    "gemma3-12b": ("gemma3_12b", "transformer"),
    "minitron-8b": ("minitron_8b", "transformer"),
    "qwen2-vl-2b": ("qwen2_vl_2b", "transformer"),
    "gemma2-27b": ("gemma2_27b", "transformer"),
}

ARCH_IDS = tuple(_MODULES)


@dataclass(frozen=True)
class Arch:
    name: str
    config: ModelConfig
    smoke: ModelConfig
    module: str  # "transformer" | "encdec"


def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    modname, kind = _MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{modname}")
    return Arch(name=name, config=mod.CONFIG, smoke=mod.smoke_config(),
                module=kind)


def all_archs():
    """Every arch, in the reference's registry order."""
    return [get_arch(n) for n in ARCH_IDS]
