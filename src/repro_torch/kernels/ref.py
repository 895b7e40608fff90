"""Plain PyTorch versions of the port's kernels (the attention, SSD, top-k
and codec parts of ``repro/kernels/ref.py``, its lines 26-85 and 91-161).

``sdpa`` is the spec of the flash-attention kernel: the full softmax over
masks built from positions ``0..S-1``, through the port's
``layers.sdpa_reference``.  The kernel agrees with it to the tolerance of
the reference's own kernel test (``2e-2`` in bf16, ``2e-5`` in f32), not to
the bit.

``ssd`` is the spec of the SSD chunked-scan kernel: the chunked algorithm
of ``models/ssm.py::ssd_chunked`` at chunk ``min(chunk, S)``, all in f32.
``ssd_naive`` is the literal per-step recurrence that anchors it.  The
kernel agrees with ``ssd`` to the reference kernel test's tolerance
(``y / max|y|`` within ``1e-5``, the final state within ``1e-3``).

The codec functions are the bit-level spec of the fused WAN codec. The CPU
path runs them, and on the card they are what the CUDA kernels are held
against, bit for bit. Selection is a *stable* descending sort on the
truncated key, so ties go to the lowest index on every device
(``torch.topk`` has no tie order on CUDA and is not used). A NaN is keyed
as the canonical NaN, so all NaNs tie above +inf, a block holding one has
scale 1 (its maximum is NaN), and a NaN winner clips to ``-qmax``; the
reference leaves that code to the float-to-int conversion, which has no
defined value, so the port defines it as its kernel computes it. Both functions
take one flat vector ``(n,)`` or a batch of them ``(rows, n)`` (the pod
dimension), and work through the blocks in slices of ``_SLICE_BLOCKS`` so
that the sort's scratch stays bounded at any size.

``topk_block`` is the spec of the block top-k kernel (the legacy sparse
fp32 shipping): per block of ``block`` values, the ``k_block = max(1, k //
nb)`` largest ``|x|``, ties to the lowest index, in descending order; the
padded tail of the last block takes part with zeros, and winners from it
get their index clamped to ``n - 1``.  Selection is a stable descending
sort of ``|x|`` per block, so it is bit-equal to the reference's
``lax.top_k`` on every device.  ``topk_decompress`` resolves repeated
indices (the clamped pad winners) explicitly, the last entry in idx order
winning, as the reference's scatter does on the CPU; a scatter with
repeated indices has no defined order on CUDA.
"""
from __future__ import annotations

from math import prod
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wan_codec import (KEY_MASK, TIER_INV, TIER_QMAX,
                                           check_value_dtype, pack_nibbles,
                                           unpack_nibbles)
from repro_torch.models.layers import attn_bias, sdpa_reference
from repro_torch.models.ssm import ssd_chunked

_SLICE_BLOCKS = 1 << 14        # 64M fp32 values per slice at block 4096
_NAN_BITS = 0x7FFFFFFF         # the canonical NaN: every NaN's key


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         softcap: float = 0.0) -> torch.Tensor:
    """Attention of q ``(B, Sq, H, Dh)`` over k, v ``(B, Sk, K, Dh)`` with
    masks from positions ``0..Sq-1`` and ``0..Sk-1``."""
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[None].expand(B, Sq)
    kp = torch.arange(Sk, device=q.device)[None].expand(B, Sk)
    bias = attn_bias(qp, kp, None, causal, window)
    return sdpa_reference(q, k, v, bias, softcap)


def ssd(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: x ``(B, S, H, P)``, a ``(B, S, H)``, Bm and Cm
    ``(B, S, H, N)``, init_state ``(B, H, P, N)`` -> (y in x.dtype, final
    state f32)."""
    return ssd_chunked(x, a, Bm, Cm, chunk=min(chunk, x.shape[1]),
                       init_state=init_state)


def ssd_naive(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Literal recurrence: s_t = exp(a_t) s_{t-1} + B_t ⊗ x_t; y_t = C_t · s_t."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    s = (torch.zeros(B, H, P, N, dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        s = s * torch.exp(a[:, t].to(f32))[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bm[:, t].to(f32), x[:, t].to(f32))
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t].to(f32), s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def topk_block(x: torch.Tensor, k: int, block: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-balanced top-k of ``x`` ``(n,)`` or ``(rows, n)`` (each row on
    its own) -> (vals in ``x.dtype``, idx int32), each ``(.., min(k,
    nb * k_block))``, winners block by block in descending ``|x|``."""
    if x.dim() not in (1, 2):
        raise ValueError(f"topk_block takes (n,) or (rows, n), got "
                         f"{tuple(x.shape)}")
    xr = x if x.dim() == 2 else x[None]
    rows, n = xr.shape
    block = min(block, n)
    nb = -(-n // block)
    k_block = max(1, k // nb)
    if k_block > block:
        raise ValueError(f"k_block {k_block} > block {block}")
    xb = xr if nb * block == n else F.pad(xr, (0, nb * block - n))
    xb = xb.reshape(rows * nb, block)
    loc_parts = []
    for lo in range(0, rows * nb, _SLICE_BLOCKS):
        mag = xb[lo:lo + _SLICE_BLOCKS].abs()
        loc_parts.append(torch.sort(mag, dim=1, descending=True,
                                    stable=True).indices[:, :k_block])
    loc = torch.cat(loc_parts)
    vals = torch.gather(xb, 1, loc).reshape(rows, nb * k_block)
    base = torch.arange(nb, device=x.device).repeat(rows)[:, None] * block
    idx = torch.clamp((loc + base).reshape(rows, nb * k_block), max=n - 1)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    return (vals, idx) if x.dim() == 2 else (vals[0], idx[0])


def topk_block_chunks(x: torch.Tensor, chunk: int, k: int,
                      block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_block` of every ``chunk``-value piece of each row of
    ``x`` ``(rows, numel)`` (the last piece zero-padded): (vals, idx), each
    ``(rows, n_chunks, ..)``; the plain version of the kernel's batched
    launch."""
    rows, numel = x.shape
    n_chunks = -(-numel // chunk)
    pad = n_chunks * chunk - numel
    xp = F.pad(x, (0, pad)) if pad else x
    vals, idx = topk_block(xp.reshape(rows * n_chunks, chunk), k, block)
    return (vals.reshape(rows, n_chunks, -1),
            idx.reshape(rows, n_chunks, -1))


def topk_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k of ``(n,)`` by ``|x|``, ties to the lowest index."""
    idx = torch.sort(x.abs(), descending=True, stable=True).indices[:k]
    return x[idx], idx.to(torch.int32)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Scatter ``vals`` at ``idx`` into zeros: ``(.., kk)`` -> ``(.., n)``
    in ``vals.dtype``.  Where an index repeats, its last entry wins: the
    earlier ones are sent to a scratch slot past the end, so the scatter
    writes each position at most once."""
    lead, kk = vals.shape[:-1], vals.shape[-1]
    rows = prod(lead)
    v = vals.reshape(rows, kk)
    i = idx.reshape(rows, kk).long()
    srt, order = torch.sort(i, dim=1, stable=True)
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:, :-1] = srt[:, 1:] != srt[:, :-1]
    keep = torch.empty_like(last).scatter_(1, order, last)
    g = i + torch.arange(rows, device=i.device)[:, None] * n
    dst = torch.where(keep, g, rows * n)
    out = torch.zeros(rows * n + 1, dtype=vals.dtype, device=vals.device)
    out.scatter_(0, dst.reshape(-1), v.reshape(-1))
    return out[:rows * n].view(*lead, n)


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    if x.dim() not in (1, 2):
        raise ValueError(f"codec input must be (n,) or (rows, n), got "
                         f"{tuple(x.shape)}")
    return x if x.dim() == 2 else x[None]


def wan_encode(x: torch.Tensor, k_block: int, block: int = 4096,
               value_dtype: str = "int8"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-local top-k on the 16-bit truncated ``|x|`` key, winners in
    index order, quantized per block on the requested tier.

    Returns ``(payload, idx int32, scales f32)``: payload int8
    ``(.., nb*k_block)`` for int8/fp8 (fp8 ships its bit pattern) or uint8
    ``(.., nb*ceil(k_block/2))`` nibble-packed for int4; ``idx`` block-local;
    one scale per block."""
    check_value_dtype(value_dtype)
    xr = _as_rows(x)
    rows, n = xr.shape
    block = min(block, n)
    k_block = min(k_block, block)
    nb = -(-n // block)
    xb = xr.float()
    if nb * block != n:
        xb = F.pad(xb, (0, nb * block - n))
    xb = xb.reshape(rows * nb, block)
    inv = torch.tensor(TIER_INV[value_dtype], dtype=torch.float32,
                       device=x.device)
    qmax = TIER_QMAX[value_dtype]
    q_parts, idx_parts, s_parts = [], [], []
    for lo in range(0, rows * nb, _SLICE_BLOCKS):
        xc = xb[lo:lo + _SLICE_BLOCKS]
        mag = xc.abs()
        keys = torch.where(torch.isnan(mag), _NAN_BITS,
                           mag.view(torch.int32)) & KEY_MASK
        order = torch.sort(keys, dim=1, descending=True,
                           stable=True).indices[:, :k_block]
        loc = torch.sort(order, dim=1).values
        vals = torch.gather(xc, 1, loc)
        maxabs = mag.amax(dim=1)
        scales = torch.where(maxabs > 0, maxabs * inv,
                             torch.ones_like(maxabs))
        v = vals / scales[:, None]
        # fmax / fmin drop a NaN, as the kernel's fmaxf / fminf do
        lo_q, hi_q = (torch.tensor(b, dtype=torch.float32, device=x.device)
                      for b in (-qmax, qmax))
        if value_dtype == "fp8":
            q = torch.fmin(torch.fmax(v, lo_q), hi_q).to(
                torch.float8_e4m3fn).view(torch.int8)
        else:
            q = torch.fmin(torch.fmax(torch.round(v), lo_q), hi_q).to(
                torch.int8)
        q_parts.append(q)
        idx_parts.append(loc.to(torch.int32))
        s_parts.append(scales)
    q = torch.cat(q_parts).reshape(rows, nb, k_block)
    if value_dtype == "int4":
        q = pack_nibbles(q)
    idx = torch.cat(idx_parts).reshape(rows, nb * k_block)
    scales = torch.cat(s_parts).reshape(rows, nb)
    q = q.reshape(rows, -1)
    if x.dim() == 1:
        return q[0], idx[0], scales[0]
    return q, idx, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, k_block: int,
               value_dtype: str) -> torch.Tensor:
    """Wire payload ``(rows, nb, bytes)`` -> values ``(rows, nb, k_block)``
    f32 (codes times the block's scale)."""
    if value_dtype == "int4":
        codes = unpack_nibbles(q, k_block).float()
    elif value_dtype == "fp8":
        codes = q.view(torch.float8_e4m3fn).float()
    else:
        codes = q.float()
    return codes * scales[..., None]


def wan_decode(q: torch.Tensor, idx: torch.Tensor, scales: torch.Tensor,
               n: int, block: int = 4096,
               value_dtype: str = "int8") -> torch.Tensor:
    """Inverse of :func:`wan_encode` -> dense f32 ``(n,)`` or ``(rows, n)``."""
    check_value_dtype(value_dtype)
    batched = scales.dim() == 2
    sr = scales if batched else scales[None]
    rows, nb = sr.shape
    block = min(block, n)
    k_block = idx.shape[-1] // nb
    v = dequantize(q.reshape(rows, nb, -1), sr, k_block, value_dtype)
    il = idx.reshape(rows, nb, k_block).long()
    dense = torch.zeros(rows, nb, block, dtype=torch.float32,
                        device=scales.device).scatter_(2, il, v)
    dense = dense.reshape(rows, nb * block)[:, :n]
    return dense if batched else dense[0]
