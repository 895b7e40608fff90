"""The benchmark's weights: made from the seed on the device, in a few large
draws, in the dtype they are trained in, in the program's parameter tree.

Every matrix is normal with standard deviation ``1 / sqrt(fan_in)`` (the
embedding table 1), every norm scale 0 (a gain of ``1 + 0``).  The same
seed gives the same values on the same device, so the reference gets the
program's starting point by drawing again after the program has gone.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from trainbench.reference.model import Spec, layout, nest

Path = Tuple[str, ...]
_DRAW = 1 << 28            # values a draw: bounds the draw's scratch


def _std(path: Path, shape: Tuple[int, ...]) -> float:
    if path == ("embed", "tokens"):
        return 1.0
    return 1.0 / math.sqrt(shape[-2])


def make(spec: Spec, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[Path, torch.Tensor]:
    """One pod's parameters, ``{path: tensor}`` in layout order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[Path, torch.Tensor] = {}
    for path, shape in layout(spec):
        if len(shape) - (path[0] == "blocks") <= 1:
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        x = torch.empty(shape, dtype=dtype, device=device)
        flat = x.view(-1)
        for lo in range(0, flat.numel(), _DRAW):
            part = flat[lo:lo + _DRAW]
            torch.randn(part.numel(), generator=gen, out=part)
        out[path] = x.mul_(_std(path, shape))
    return out


def stacked(params: Dict[Path, torch.Tensor], pods: int):
    """The program's stacked tree: every pod's rows the same weights."""
    return nest({k: v[None].expand((pods,) + tuple(v.shape)).contiguous()
                 for k, v in params.items()})
