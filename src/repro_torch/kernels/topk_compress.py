"""Block-balanced top-k (the legacy sparse fp32 shipping): the host side of
the CUDA kernel.

Counterpart of the wrapper half of ``repro/kernels/topk_compress.py`` (its
lines 50-77).  The kernel itself is ``csrc/topk_compress.cu``: one warp per
block of ``block`` values, a threshold from the lanes' maxima and one
sorted compaction (``k_block`` rounds of a warp argmax on (|x|, -index)
where that does not cover the block).  The wrapper does what the Pallas
wrapper does around its launch (the block size, ``k_block``, the clamp of
pad winners to ``n - 1`` and the cut to ``k``), with one difference in
form: it takes a whole leaf ``(rows, numel)`` cut into chunks of ``chunk``
values, as the sync layer's ``_ship_ring`` cuts it, and covers every (row,
chunk) in one launch.  The chunk and block pads are zeros that the kernel reads as zeros without a
padded copy being made.

The public entry points are ``repro_torch.kernels.ops.topk_compress`` and
``topk_compress_chunked``, which dispatch by device; this module checks
what the kernel takes and launches it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_BLOCK = 1024                   # csrc/topk_compress.cu kMaxBlock
DTYPES = (torch.float32, torch.bfloat16)


def plan(numel: int, chunk: int, k: int, block: int) -> Tuple[int, int, int]:
    """``(n_chunks, block, k_block)`` of one leaf, as the reference derives
    them: ``block = min(block, chunk)``, ``k_block = max(1, k // nb)``."""
    if numel < 1 or chunk < 1 or k < 1 or block < 1:
        raise ValueError(f"top-k needs positive sizes, got numel={numel}, "
                         f"chunk={chunk}, k={k}, block={block}")
    block = min(block, chunk)
    nb = -(-chunk // block)
    k_block = max(1, k // nb)
    if k_block > block:
        raise ValueError(f"k_block {k_block} > block {block}")
    return -(-numel // chunk), block, k_block


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_compress")
    if not getattr(lib, "typed", False):
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.topk_compress_launch.argtypes = [P, I, LL, I, LL, LL, LL, I, I,
                                             P, P, P]
        lib.topk_compress_launch.restype = I
        lib.topk_compress_max_block.argtypes = []
        lib.topk_compress_max_block.restype = I
        lib.topk_compress_error_string.argtypes = [I]
        lib.topk_compress_error_string.restype = ctypes.c_char_p
        if lib.topk_compress_max_block() != MAX_BLOCK:
            raise RuntimeError(f"top-k kernel block limit "
                               f"{lib.topk_compress_max_block()} != host "
                               f"constant {MAX_BLOCK}")
        lib.typed = True
    return lib


def topk_compress_cuda(x: torch.Tensor, chunk: int, k: int, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA ``(rows, numel)`` tensor (f32 or bf16,
    unit last stride); returns (vals in ``x.dtype``, idx int32), each
    ``(rows, n_chunks, min(k, nb * k_block))``.  A failed build or launch
    raises."""
    if x.dim() != 2 or not x.is_cuda:
        raise ValueError(f"topk_compress_cuda takes a CUDA (rows, numel) "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"the top-k kernel takes {DTYPES}, got {x.dtype}")
    rows, numel = x.shape
    n_chunks, block, k_block = plan(numel, chunk, k, block)
    if block > MAX_BLOCK:
        raise ValueError(f"block {block} > {MAX_BLOCK}, the largest the "
                         f"top-k kernel takes")
    if chunk >= 1 << 31:
        raise ValueError("chunk indices must fit int32")
    if x.stride(1) != 1:
        x = x.contiguous()
    nb = -(-chunk // block)
    vals = torch.empty(rows, n_chunks, nb * k_block, dtype=x.dtype,
                       device=x.device)
    idx = torch.empty(rows, n_chunks, nb * k_block, dtype=torch.int32,
                      device=x.device)
    lib = _lib()
    err = lib.topk_compress_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0), rows,
        numel, n_chunks, chunk, block, k_block, vals.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_compress kernel launch failed: "
                           f"{lib.topk_compress_error_string(err).decode()}")
    idx.clamp_(max=chunk - 1)
    return vals[..., :k], idx[..., :k]
