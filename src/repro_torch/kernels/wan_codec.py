"""Fused WAN payload codec: constants and host helpers.

Counterpart of ``repro/kernels/wan_codec.py`` (its lines 68-193).  The codec
selects, per contiguous block of ``block`` fp32 values, the ``k_block``
largest by magnitude truncated to its top 16 bits (``KEY_MASK``; ties to the
lowest index), keeps the winners in index order, and encodes them against
the block's ``max|x|`` scale on one of three tiers:

- ``"int8"``: ``q = clip(round(x / (max|x| * INV_127)), -127, 127)``;
- ``"fp8"``:  ``x / (max|x| * INV_FP8_MAX)`` clipped to +-448, cast to
  fp8-e4m3 and shipped as its bit pattern;
- ``"int4"``: ``q = clip(round(x / (max|x| * INV_7)), -7, 7)``, packed two
  codes to a byte (low nibble first) by :func:`pack_nibbles`.

The bit-level spec lives in the plain version (``kernels/ref.py``); the CUDA
kernels (``kernels/csrc/wan_codec.cu``) reproduce it bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# keep the top 16 of the 31 magnitude bits (sign bit of |x| is always 0):
# bits 30..23 exponent, 22..15 top mantissa byte
KEY_MASK = ~((1 << 15) - 1)

# scale = maxabs * INV, never maxabs / Q: both sides multiply by the same
# float32 constant, so the scale rounds identically everywhere
INV_127 = np.float32(1.0 / 127.0)     # int8 tier: q in [-127, 127]
INV_7 = np.float32(1.0 / 7.0)         # int4 tier: q in [-7, 7]
FP8_MAX = 448.0                       # fp8-e4m3 largest finite value
INV_FP8_MAX = np.float32(1.0 / 448.0)

VALUE_DTYPES = ("int8", "fp8", "int4")  # the codec's precision ladder

DEFAULT_BLOCK = 4096

# per-tier scale constant and code range (fp8 clips in value space)
TIER_INV = {"int8": INV_127, "fp8": INV_FP8_MAX, "int4": INV_7}
TIER_QMAX = {"int8": 127.0, "fp8": FP8_MAX, "int4": 7.0}


def k_per_block(block: int, frac: float) -> int:
    """Per-block winner count for a target compression fraction."""
    return max(1, min(block, int(round(block * frac))))


def check_value_dtype(value_dtype: str) -> None:
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"unknown value_dtype {value_dtype!r} "
                         f"(expected one of {VALUE_DTYPES})")


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (.., k) int8 in [-7, 7] -> (.., ceil(k/2)) uint8.

    Low nibble first, two's complement; odd ``k`` pads one zero nibble."""
    k = q.shape[-1]
    if k % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    qi = q.to(torch.int32)
    lo = qi[..., 0::2] & 0xF
    hi = qi[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(p: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: (.., ceil(k/2)) uint8 -> (.., k) int8."""
    pi = p.to(torch.int32)
    lo = pi & 0xF
    hi = (pi >> 4) & 0xF
    pairs = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (-1,))
    signed = torch.where(pairs < 8, pairs, pairs - 16)
    return signed[..., :k].to(torch.int8)
