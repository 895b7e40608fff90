"""Mamba2 SSD chunked scan: the host side of the CUDA kernel.

Counterpart of the wrapper half of ``repro/kernels/ssd_scan.py`` (its lines
73-115).  The kernel itself is ``csrc/ssd_scan.cu``, Mamba2's own split of
the chunked algorithm in three launches: the chunk-local states, in parallel
over (P-tile, head, chunk, batch row); the pass of the state over the
chunks, in order; and y (the intra-chunk and carried-state terms), in
parallel over 128-row tiles of every chunk.  Every product runs on the
tensor cores (``C B^T`` in bf16 when B and C are bf16, the products with an
f32 operand as 3xTF32).  The per-chunk states and decays are scratch that
this wrapper allocates with ``torch.empty``: ``B * (S / L) * H * P * N``
f32 values (16.8 MB at mamba2-1.3b's prefill).  Like the flash wrapper, and
unlike the Pallas one, it reads x, a, B and C in place through their
strides, so B and C may be a stride-0 view over heads (one B/C group) and
no repeated copy is made.

The public entry point is ``repro_torch.kernels.ops.ssd_scan``, which
dispatches by device (one call is one count in ``LAUNCHES``, whatever its
launches); this module checks what the kernel takes and launches it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.ssm import check_chunking

# the CUDA kernel's limits (csrc/ssd_scan.cu kMaxN, kMaxL; checked against
# the library at load)
MAX_STATE_DIM = 128
MAX_CHUNK = 4096
BC_DTYPES = (torch.float32, torch.bfloat16)   # of B and C (x and a: f32)
_MAX_GRID_YZ = 65535               # gridDim.y (batch x chunks), gridDim.z


def check_inputs(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor]) -> int:
    """Raise on anything the kernel does not take; returns the chunk length
    ``L = min(chunk, S)``.  x ``(B, S, H, P)`` f32, a ``(B, S, H)``
    f32, Bm and Cm ``(B, S, H, N)`` of one dtype (f32 or bf16) with ``N <=
    128``, init_state ``(B, H, P, N)``; ``S % L == 0`` (the reference
    asserts it); a unit last stride for x, Bm and Cm."""
    if x.dim() != 4 or a.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B, S, H, P), a (B, S, H), B and "
                         f"C (B, S, H, N); got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(a.shape) != (Bsz, S, H) or tuple(Bm.shape) != (Bsz, S, H, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"a {tuple(a.shape)}, B {tuple(Bm.shape)} and C "
                         f"{tuple(Cm.shape)} do not match x {tuple(x.shape)}")
    if min(Bsz, S, H, P, N) < 1:
        raise ValueError("ssd_scan needs non-empty inputs")
    if N > MAX_STATE_DIM:
        raise ValueError(f"state_dim {N} > {MAX_STATE_DIM}, the largest the "
                         f"SSD kernel takes")
    if x.dtype != torch.float32 or a.dtype != torch.float32 \
            or Bm.dtype not in BC_DTYPES or Cm.dtype != Bm.dtype:
        raise ValueError(f"ssd_scan takes x and a in float32 and B, C of one "
                         f"dtype in {BC_DTYPES}; got {x.dtype}, {a.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype}")
    if init_state is not None and tuple(init_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)} is not "
                         f"{(Bsz, H, P, N)}")
    L = check_chunking(S, chunk)
    if L > MAX_CHUNK:
        raise ValueError(f"chunk {L} > {MAX_CHUNK}, the largest the SSD "
                         f"kernel takes")
    if Bsz > _MAX_GRID_YZ or H > _MAX_GRID_YZ \
            or Bsz * (S // L) > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} batch rows, heads and "
                         f"(batch row, chunk) pairs")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan needs a contiguous last dimension")
    return L


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I,
                                        I, I, I, I, P, P]
        lib.ssd_scan_launch.restype = I
        lib.ssd_scan_limit.argtypes = [I]
        lib.ssd_scan_limit.restype = I
        lib.ssd_scan_error_string.argtypes = [I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        limits = (lib.ssd_scan_limit(0), lib.ssd_scan_limit(1))
        if limits != (MAX_STATE_DIM, MAX_CHUNK):
            raise RuntimeError(f"SSD kernel limits {limits} != host "
                               f"constants {(MAX_STATE_DIM, MAX_CHUNK)}")
        lib.typed = True
    return lib


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, *, chunk: int,
                  init_state: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; returns (y ``(B, S, H, P)`` f32,
    final state ``(B, H, P, N)`` f32).  A failed build or launch raises."""
    L = check_inputs(x, a, Bm, Cm, chunk, init_state)
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (a, Bm, Cm))):
        raise ValueError("ssd_scan_cuda takes CUDA tensors on one device")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if init_state is not None:
        if init_state.device != dev:
            raise ValueError("init_state must be on x's device")
        init_state = init_state.float()
        if init_state.stride(-1) != 1:
            raise ValueError("init_state needs a contiguous last dimension")
    y = torch.empty(Bsz, S, H, P, dtype=x.dtype, device=dev)
    final = torch.empty(Bsz, H, P, N, dtype=torch.float32, device=dev)
    # scratch: each chunk's local state, then the state entering it; and
    # each chunk's decay exp(sum of a over the chunk)
    states = torch.empty(Bsz, S // L, H, P, N, dtype=torch.float32,
                         device=dev)
    decay = torch.empty(Bsz, S // L, H, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 18)(
        *x.stride()[:3], *a.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        *y.stride()[:3],
        *((0, 0, 0) if init_state is None else init_state.stride()[:3]))
    lib = _lib()
    err = lib.ssd_scan_launch(
        x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(),
        states.data_ptr(), decay.data_ptr(),
        int(Bm.dtype == torch.bfloat16), Bsz, S, H, P, N, L,
        ctypes.cast(strides, ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    return y, final
