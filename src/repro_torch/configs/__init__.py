"""Architecture registry of the port: ``--arch <id>`` resolves here.

Ported: the dense decoders ``granite-8b``, ``gemma3-12b`` (5:1 local:global
windows, head_dim 256), ``minitron-8b`` and ``gemma2-27b`` (alternating
windows, attention and final-logit soft-caps), the SSM ``mamba2-1.3b``, the
MoE decoders ``qwen3-moe-30b-a3b`` and ``kimi-k2-1t-a32b``, the hybrid
``jamba-1.5-large-398b`` (Mamba and attention positions, MoE on every other
one) and the encoder-decoder ``whisper-tiny`` (module ``encdec``).  The
reference's ``qwen2-vl-2b`` needs multimodal positions (ROADMAP.md Queue 1
item 9b).
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
    "gemma2-27b": ("gemma2_27b", "transformer"),
}

ARCH_IDS = tuple(_MODULES)

# every arch id of the reference's registry (repro/configs/__init__.py), in
# its order: a name outside it is unknown (KeyError, as the reference
# raises); a name in it that is not in ARCH_IDS is not ported yet
REFERENCE_ARCH_IDS = (
    "qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "mamba2-1.3b",
    "whisper-tiny", "granite-8b", "kimi-k2-1t-a32b", "gemma3-12b",
    "minitron-8b", "qwen2-vl-2b", "gemma2-27b",
)


@dataclass(frozen=True)
class Arch:
    name: str
    config: ModelConfig
    smoke: ModelConfig
    module: str  # "transformer" | "encdec"


def get_arch(name: str) -> Arch:
    if name not in REFERENCE_ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(REFERENCE_ARCH_IDS)}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(_MODULES)}); "
            f"see ROADMAP.md Queue 1 item 9b (M-RoPE, sdpa_chunked and the "
            f"vision placeholders)")
    modname, kind = _MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{modname}")
    return Arch(name=name, config=mod.CONFIG, smoke=mod.smoke_config(),
                module=kind)


def all_archs():
    """Every ported arch, in the reference's registry order."""
    return [get_arch(n) for n in ARCH_IDS]
