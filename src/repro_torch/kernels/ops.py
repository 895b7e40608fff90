"""Public kernel wrappers: the hand-written CUDA kernel on the card, the
plain version on the CPU.

Counterpart of ``repro/kernels/ops.py`` (``flash_attention``, ``ssd_scan``,
``topk_compress``, ``topk_decompress``, ``wan_encode``, ``wan_decode`` and
``wan_codec_fns``, its lines 27-113), with the same signatures (less the
reference's ``interpret``: the CUDA kernels have no interpret mode).
Dispatch is by the tensor's device:

- a CUDA tensor with ``use_kernel=True`` (the default) launches the kernel
  of ``csrc/*.cu``; a failed build or launch raises;
- a CUDA tensor with ``use_kernel=False`` runs the plain version (only the
  parity checks ask for that);
- a CPU tensor runs the plain version.

The codec inputs may be one flat vector ``(n,)`` or a batch ``(rows, n)``:
the sync layer passes the whole pod dimension, and one launch covers it.
``LAUNCHES`` counts kernel launches per wrapper, and nothing else.
``FLASH_CHECK_HOOK``, when set, is called after every flash-attention launch
with ``(q, k, v, out, causal=, window=, softcap=)``, and ``SSD_CHECK_HOOK``
after every SSD launch with ``(x, a, Bm, Cm, y, final_state, chunk=,
init_state=)``, and ``TOPK_CHECK_HOOK`` after every top-k launch with
``(x, vals, idx, chunk=, k=, block=)`` (the batched form's arguments); a
caller that holds a kernel to its plain version on a live path sets them
(``chip_smoke.py``).

No DTensor reaches a kernel: every entry point raises ``TypeError`` on one.
The codec's blocks are blocks of the whole flattened leaf, so a shard's
blocks would not be the reference's, and on the card a DTensor would reach
the extension as a tensor without storage.  The mesh path gathers its
leaves whole before a round (``repro_torch.training.trainer``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (check_inputs,
                                                 flash_attention_cuda)
from repro_torch.kernels.ssd_scan import check_inputs as check_ssd_inputs
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.topk_compress import topk_compress_cuda
from repro_torch.kernels.wan_codec import (TIER_INV, TIER_QMAX, VALUE_DTYPES,
                                           check_value_dtype, pack_nibbles,
                                           unpack_nibbles)

LAUNCHES: Dict[str, int] = {"wan_encode": 0, "wan_decode": 0,
                             "flash_attention": 0, "ssd_scan": 0,
                             "topk_compress": 0}
FLASH_CHECK_HOOK: Optional[Callable] = None
SSD_CHECK_HOOK: Optional[Callable] = None
TOPK_CHECK_HOOK: Optional[Callable] = None
_MAX_ROWS = 65535                  # gridDim.y


def _refuse_dtensor(what: str, *tensors) -> None:
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes plain tensors, not a DTensor: gather "
                        f"the leaf whole first (full_tensor)")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_kernel(t: torch.Tensor, use_kernel: bool) -> bool:
    if t.device.type == "cuda":
        return use_kernel
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels have no path for device "
                     f"{t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, bias=None) -> torch.Tensor:
    """Blockwise flash attention: q ``(B, Sq, H, Dh)``, k and v
    ``(B, Sk, K, Dh)`` -> ``(B, Sq, H, Dh)`` in ``q.dtype``.

    Masks come from positions ``0..S-1`` (``bias`` is ignored, as in the
    reference).  A CUDA tensor launches ``csrc/flash_attention.cu``, a CPU
    tensor runs the plain ``ref.sdpa``; both refuse what the kernel does not
    take.  The kernel is forward-only, as the TPU kernel is: inputs that
    need a gradient raise rather than run the plain version."""
    _refuse_dtensor("flash_attention", q, k, v)
    del bias
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only (the TPU kernel has no VJP "
            "either); its backward kernel is ROADMAP.md Queue 2 item 6")
    check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return _ref.sdpa(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no path for device "
                         f"{q.device}")
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    if FLASH_CHECK_HOOK is not None:
        FLASH_CHECK_HOOK(q, k, v, out, causal=causal, window=window,
                         softcap=softcap)
    return out


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan: x ``(B, S, H, P)`` f32 (pre-multiplied by
    dt), a ``(B, S, H)`` f32 log decay, Bm and Cm ``(B, S, H, N)`` f32 or
    bf16, init_state ``(B, H, P, N)`` or None (zeros) -> (y ``(B, S, H, P)``
    f32, final state ``(B, H, P, N)`` f32).  ``S`` must be at most ``chunk`` or a
    multiple of it (``ValueError`` where the reference asserts).

    A CUDA tensor launches ``csrc/ssd_scan.cu``, a CPU tensor runs the plain
    ``ref.ssd``; both refuse what the kernel does not take.  The kernel is
    forward-only, as the TPU kernel is: inputs that need a gradient raise
    rather than run the plain version."""
    _refuse_dtensor("ssd_scan", x, a, Bm, Cm, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, Bm, Cm, init_state)):
        raise NotImplementedError(
            "ssd_scan is forward-only (the TPU kernel has no VJP either); "
            "its backward kernel is ROADMAP.md Queue 2 item 8")
    check_ssd_inputs(x, a, Bm, Cm, chunk, init_state)
    if x.device.type == "cpu":
        return _ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no path for device {x.device}")
    y, final = ssd_scan_cuda(x, a, Bm, Cm, chunk=chunk,
                             init_state=init_state)
    LAUNCHES["ssd_scan"] += 1
    if SSD_CHECK_HOOK is not None:
        SSD_CHECK_HOOK(x, a, Bm, Cm, y, final, chunk=chunk,
                       init_state=init_state)
    return y, final


def topk_compress(x: torch.Tensor, k: int, *, block: int = 1024,
                  use_kernel: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-balanced top-k of ``x`` ``(n,)`` or ``(rows, n)``, f32 or
    bf16 -> (vals in ``x.dtype``, idx int32), each ``(.., min(k, nb *
    k_block))``; see ``ref.topk_block`` for the spec.

    Deliberately unlike the reference, whose ``ops.topk_compress`` defaults
    to ``use_kernel=False`` so that its sync path never ran the Pallas
    kernel: kernel and plain version are bit-identical, so the choice is
    pure dispatch, and a CUDA tensor launches the kernel by default.
    ``use_kernel=False`` runs the plain version (for the checks)."""
    _refuse_dtensor("topk_compress", x)
    if x.dim() not in (1, 2):
        raise ValueError(f"topk_compress takes (n,) or (rows, n), got "
                         f"{tuple(x.shape)}")
    if not _on_kernel(x, use_kernel):
        return _ref.topk_block(x, k, block)
    xr = x if x.dim() == 2 else x[None]
    vals, idx = topk_compress_chunked(xr, xr.shape[1], k, block=block)
    vals, idx = vals[:, 0], idx[:, 0]
    return (vals, idx) if x.dim() == 2 else (vals[0], idx[0])


def topk_compress_chunked(x: torch.Tensor, chunk: int, k: int, *,
                          block: int = 1024, use_kernel: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched form of :func:`topk_compress` that the sync layer ships
    a leaf with: each row of ``x`` ``(rows, numel)`` is cut into pieces of
    ``chunk`` values (the last zero-padded), and each piece compressed as
    ``topk_compress(piece, k, block=block)`` would -> (vals, idx), each
    ``(rows, n_chunks, ..)``.  On the card one launch covers the leaf."""
    _refuse_dtensor("topk_compress_chunked", x)
    if x.dim() != 2:
        raise ValueError(f"topk_compress_chunked takes (rows, numel), got "
                         f"{tuple(x.shape)}")
    if not _on_kernel(x, use_kernel):
        return _ref.topk_block_chunks(x, chunk, k, block)
    vals, idx = topk_compress_cuda(x, chunk, k, block)
    LAUNCHES["topk_compress"] += 1
    if TOPK_CHECK_HOOK is not None:
        TOPK_CHECK_HOOK(x, vals, idx, chunk=chunk, k=k, block=block)
    return vals, idx


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """Inverse of :func:`topk_compress`: ``(.., kk)`` -> dense ``(.., n)``
    in ``vals.dtype``; a repeated index keeps its last entry.  Plain
    PyTorch on every device: the reference's is a scatter, not a kernel."""
    _refuse_dtensor("topk_decompress", vals, idx)
    return _ref.topk_decompress(vals, idx, n)


def _lib() -> ctypes.CDLL:
    lib = _build.load("wan_codec")
    if not getattr(lib, "typed", False):
        P, LL, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        lib.wan_encode_launch.argtypes = [P, LL, LL, I, I, I, I, F, F,
                                          P, P, P, P]
        lib.wan_encode_launch.restype = I
        lib.wan_decode_launch.argtypes = [P, P, P, LL, I, I, I, I, P, P]
        lib.wan_decode_launch.restype = I
        lib.wan_codec_error_string.argtypes = [I]
        lib.wan_codec_error_string.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.wan_codec_error_string(err).decode()}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dim() not in (1, 2):
        raise ValueError(f"codec input must be (n,) or (rows, n), got "
                         f"{tuple(x.shape)}")
    xr = x if x.dim() == 2 else x[None]
    if xr.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch")
    return xr


def _encode_cuda(x: torch.Tensor, k_block: int, block: int,
                 value_dtype: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    xr = _rows(x).float()
    if xr.stride(1) != 1:
        xr = xr.contiguous()
    rows, n = xr.shape
    block = min(block, n)
    k_block = min(k_block, block)
    if not 1 <= k_block <= block <= (1 << 16):
        raise ValueError(f"need 1 <= k_block <= block <= 65536, got "
                         f"k_block={k_block}, block={block}")
    nb = -(-n // block)
    q = torch.empty(rows, nb, k_block, dtype=torch.int8, device=x.device)
    idx = torch.empty(rows, nb * k_block, dtype=torch.int32, device=x.device)
    scales = torch.empty(rows, nb, dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.wan_encode_launch(
        xr.data_ptr(), xr.stride(0), n, rows, block, k_block,
        int(value_dtype == "fp8"), float(TIER_INV[value_dtype]),
        TIER_QMAX[value_dtype], q.data_ptr(), idx.data_ptr(),
        scales.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(lib, err, "wan_encode")
    LAUNCHES["wan_encode"] += 1
    if value_dtype == "int4":
        q = pack_nibbles(q)
    q = q.reshape(rows, -1)
    if x.dim() == 1:
        return q[0], idx[0], scales[0]
    return q, idx, scales


def _decode_cuda(q: torch.Tensor, idx: torch.Tensor, scales: torch.Tensor,
                 n: int, block: int, value_dtype: str) -> torch.Tensor:
    batched = scales.dim() == 2
    sr = _rows(scales).float().contiguous()
    rows, nb = sr.shape
    block = min(block, n)
    if nb != -(-n // block):
        raise ValueError(f"{nb} scales per row do not cover n={n} in "
                         f"blocks of {block}")
    k_block = idx.shape[-1] // nb
    il = idx.reshape(rows, nb * k_block).to(torch.int32).contiguous()
    qr = q.reshape(rows, nb, -1)
    if value_dtype == "int4":
        qr = unpack_nibbles(qr, k_block)
    qr = qr.contiguous()
    if qr.dtype != torch.int8 or qr.shape[-1] != k_block:
        raise ValueError(f"payload {tuple(q.shape)} {q.dtype} does not hold "
                         f"{k_block} {value_dtype} codes per block")
    out = torch.empty(rows, n, dtype=torch.float32, device=scales.device)
    lib = _lib()
    err = lib.wan_decode_launch(
        qr.data_ptr(), il.data_ptr(), sr.data_ptr(), n, rows, block,
        k_block, int(value_dtype == "fp8"), out.data_ptr(),
        torch.cuda.current_stream(scales.device).cuda_stream)
    _check_launch(lib, err, "wan_decode")
    LAUNCHES["wan_decode"] += 1
    return out if batched else out[0]


def wan_encode(x: torch.Tensor, k_block: int, *, block: int = 4096,
               value_dtype: str = "int8", use_kernel: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused WAN codec encode: block-local top-k + value quantization on the
    int8/fp8/int4 tier ladder.  Kernel and plain version are bit-identical."""
    _refuse_dtensor("wan_encode", x)
    check_value_dtype(value_dtype)
    if _on_kernel(x, use_kernel):
        return _encode_cuda(x, k_block, block, value_dtype)
    return _ref.wan_encode(x, k_block, block=block, value_dtype=value_dtype)


def wan_decode(q: torch.Tensor, idx: torch.Tensor, scales: torch.Tensor,
               n: int, *, block: int = 4096, value_dtype: str = "int8",
               use_kernel: bool = True) -> torch.Tensor:
    _refuse_dtensor("wan_decode", q, idx, scales)
    check_value_dtype(value_dtype)
    if _on_kernel(scales, use_kernel):
        return _decode_cuda(q, idx, scales, n, block, value_dtype)
    return _ref.wan_decode(q, idx, scales, n, block=block,
                           value_dtype=value_dtype)


def wan_codec_fns(*, block: int = 4096, value_dtype: str = "int8",
                  use_kernel: bool = True):
    """Bind one bucket group's codec knobs; returns ``(encode, decode)``.

    ``encode(x, k_block) -> (q, idx, scales)``;
    ``decode(q, idx, scales, n) -> dense``."""
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"unknown codec value_dtype {value_dtype!r}")

    def encode(x: torch.Tensor, k_block: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return wan_encode(x, k_block, block=block, value_dtype=value_dtype,
                          use_kernel=use_kernel)

    def decode(q: torch.Tensor, idx: torch.Tensor, scales: torch.Tensor,
               n: int) -> torch.Tensor:
        return wan_decode(q, idx, scales, n, block=block,
                          value_dtype=value_dtype, use_kernel=use_kernel)

    return encode, decode
