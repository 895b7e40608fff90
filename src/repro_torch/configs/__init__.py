"""Architecture registry of the port: ``--arch <id>`` resolves here.

``granite-8b`` (dense) and ``mamba2-1.3b`` (SSM) are ported; the
reference's other architectures need the MoE, hybrid and encoder-decoder
model families (ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

_MODULES = {
    "granite-8b": ("granite_8b", "transformer"),
    "mamba2-1.3b": ("mamba2_1_3b", "transformer"),
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
    module: str  # "transformer"


def get_arch(name: str) -> Arch:
    if name not in REFERENCE_ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(REFERENCE_ARCH_IDS)}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(_MODULES)}); "
            f"see ROADMAP.md Queue 1 item 13")
    modname, kind = _MODULES[name]
    mod = importlib.import_module(f"repro_torch.configs.{modname}")
    return Arch(name=name, config=mod.CONFIG, smoke=mod.smoke_config(),
                module=kind)
