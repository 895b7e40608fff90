"""Frozen plain arithmetic of the WAN codec.

A copy of the codec's published definition, kept here so that a change to
the program cannot move the yardstick:

- the codec keeps, per block of ``block`` float32 values, the ``k_block``
  largest by ``|x|`` truncated to its top 16 bits (ties to the lower
  index), in index order, and ships each as ``clip(round(x / (max|x| *
  f32(1/127))), -127, 127)`` with one float32 scale (``max|x| * f32(1/127)``,
  1 for an all-zero block) per block.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

KEY_MASK = ~((1 << 15) - 1)
INV_127 = float(np.float32(1.0 / 127.0))
_SLICE = 1 << 14          # blocks sorted at once: bounds the sort's scratch


def k_per_block(block: int, frac: float) -> int:
    return max(1, min(block, int(round(block * frac))))


def encode(x: torch.Tensor, k_block: int, block: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row ``(n,)`` f32 -> (codes f32 ``(nb, k_block)``, block-local
    indices ``(nb, k_block)``, scales ``(nb,)``)."""
    n = x.shape[0]
    block = min(block, n)
    k_block = min(k_block, block)
    nb = -(-n // block)
    xb = F.pad(x.float(), (0, nb * block - n)).reshape(nb, block)
    inv = torch.tensor(INV_127, dtype=torch.float32, device=x.device)
    codes, locs, scales = [], [], []
    for lo in range(0, nb, _SLICE):
        xc = xb[lo:lo + _SLICE]
        mag = xc.abs()
        keys = mag.view(torch.int32) & KEY_MASK
        order = torch.sort(keys, dim=1, descending=True,
                           stable=True).indices[:, :k_block]
        loc = torch.sort(order, dim=1).values
        maxabs = mag.amax(dim=1)
        s = torch.where(maxabs > 0, maxabs * inv, torch.ones_like(maxabs))
        codes.append(torch.clamp(torch.round(torch.gather(xc, 1, loc)
                                             / s[:, None]), -127, 127))
        locs.append(loc)
        scales.append(s)
    return torch.cat(codes), torch.cat(locs), torch.cat(scales)


def decode(codes: torch.Tensor, loc: torch.Tensor, scales: torch.Tensor,
           n: int, block: int) -> torch.Tensor:
    """Inverse of :func:`encode` -> dense f32 ``(n,)``."""
    block = min(block, n)
    nb = scales.shape[0]
    dense = torch.zeros(nb, block, dtype=torch.float32, device=codes.device)
    dense.scatter_(1, loc, codes * scales[:, None])
    return dense.reshape(-1)[:n]

