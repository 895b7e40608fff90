"""Flash attention: the host side of the CUDA kernel.

Counterpart of the wrapper half of ``repro/kernels/flash_attention.py`` (its
lines 106-160).  The kernel itself is ``csrc/flash_attention.cu``.  On bf16
inputs (the serving path) it runs FlashAttention-2's shape on the tensor
cores: one block per (q-tile, head, batch row), 16 query rows a warp, K and
V tiles of 64 keys staged in shared memory in bf16 with ``cp.async`` and
double-buffered, ``QK^T`` and ``PV`` on ``mma.sync`` with f32 accumulation
and an online softmax on the accumulator fragments.  f32 inputs keep the
first port's scalar kernel.  Both build causal / sliding-window /
soft-capped GQA masks from positions ``0..S-1`` and skip fully masked
k-tiles.  Unlike the Pallas wrapper, which pads ``q``, ``k`` and ``v`` to
the block size, the CUDA kernel masks the ragged edge itself and reads the
arrays in place through their strides: no padded copies.  The bf16 kernel's
``cp.async`` loads take 16 aligned bytes, so a bf16 view whose base or
strides are not 16-byte aligned is refused (:func:`check_aligned`), not
copied.

The public entry point is ``repro_torch.kernels.ops.flash_attention``, which
dispatches by device; this module checks what the kernel takes and launches
it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

# the bf16 tensor-core kernel's tile at Dh <= 128: query rows per block,
# keys per k-tile (csrc/flash_attention.cu; checked against the library at
# load)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 64
ALIGN_BYTES = 16                   # one cp.async of the bf16 kernel
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535               # gridDim.y (heads), gridDim.z (batch)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """Raise on anything the kernel does not take: q ``(B, Sq, H, Dh)``,
    k and v ``(B, Sk, K, Dh)`` with ``H % K == 0``, one dtype of
    :data:`DTYPES`, ``Dh`` in :data:`HEAD_DIMS`, a unit last stride."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, S, H, Dh) arrays, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Sk, K, Dh) beside q {tuple(q.shape)}")
    K = k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} is not supported by the flash "
                         f"kernel (supported: {HEAD_DIMS})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes one dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if min(B, Sq, k.shape[1]) < 1:
        raise ValueError("flash_attention needs non-empty inputs")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} batch rows and heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last dimension")


def check_aligned(*tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every tensor's base address and every
    stride of an axis longer than one are multiples of 16 bytes: the bf16
    kernel stages rows with 16-byte ``cp.async`` copies and makes no
    aligned copy of its own."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % ALIGN_BYTES:
            raise ValueError(f"flash_attention's bf16 kernel needs a "
                             f"{ALIGN_BYTES}-byte aligned base address, got "
                             f"one {t.data_ptr() % ALIGN_BYTES} bytes past "
                             f"(view of shape {tuple(t.shape)}, offset "
                             f"{t.storage_offset()})")
        for dim in range(t.dim() - 1):
            if t.shape[dim] > 1 and (t.stride(dim) * size) % ALIGN_BYTES:
                raise ValueError(f"flash_attention's bf16 kernel needs "
                                 f"{ALIGN_BYTES}-byte aligned strides, got "
                                 f"stride {t.stride(dim)} (x {size} bytes) "
                                 f"on axis {dim} of {tuple(t.shape)}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, P, I, I, F, F, P]
        lib.flash_attention_launch.restype = I
        lib.flash_attention_tile.argtypes = [I]
        lib.flash_attention_tile.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        tile = (lib.flash_attention_tile(0), lib.flash_attention_tile(1))
        if tile != (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K):
            raise RuntimeError(f"flash kernel tile {tile} != host constants "
                               f"{(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)}")
        lib.typed = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         softcap: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``(B, Sq, H, Dh)`` in
    ``q.dtype``.  A failed build or launch raises."""
    check_inputs(q, k, v, window)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype == torch.bfloat16:
        check_aligned(q, k, v)
    B, Sq, H, Dh = q.shape
    out = torch.empty(B, Sq, H, Dh, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, k.shape[1], H, k.shape[2],
        Dh, ctypes.cast(strides, ctypes.c_void_p), int(bool(causal)),
        0 if window is None else int(window),
        float(softcap or 0.0), 1.0 / math.sqrt(Dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    return out
