"""Mamba2 (SSD, state-space duality) layer.

Counterpart of ``repro/models/ssm.py``, function for function:
``SSMCache``, ``ssm_init``, the chunked SSD algorithm of arXiv:2405.21060
(``_segsum``, ``ssd_chunked``), ``_causal_conv``, ``ssm_apply`` and
``init_ssm_cache``.  The sequence is cut into chunks; inside a chunk the
recurrence is a dense masked product, and across chunks a small ``(B, H,
P, N)`` f32 state is carried (a Python loop over chunks stands in for the
reference's ``lax.scan``).  ``ssd_chunked`` is the plain version of the SSD
kernel (``kernels/ref.py::ssd``); on the card the kernel path of
``ssm_apply`` runs ``csrc/ssd_scan.cu`` instead.

Decode keeps O(1) state: the ``(B, H, P, N)`` SSM state and a ``(B, W-1,
C)`` ring of the last conv inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init
from repro_torch.sharding.rules import local_region, shard


class SSMCache(NamedTuple):
    """Decode state of one SSM position: ``state`` ``(B, H, P, N)`` f32,
    ``conv`` ``(B, W-1, C)`` the last conv inputs."""

    state: torch.Tensor
    conv: torch.Tensor


def _conv_channels(cfg: ModelConfig) -> int:
    c = cfg.ssm
    return cfg.d_inner + 2 * c.n_groups * c.state_dim


def ssm_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    c = cfg.ssm
    D, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    pdt = cfg.dtype("param")
    # in_proj emits [z, x, B, C, dt]
    zxbcdt = 2 * d_in + 2 * c.n_groups * c.state_dim + H
    u = torch.rand(H, generator=gen, dtype=torch.float32, device=device)
    u = math.log(0.001) + u * (math.log(0.1) - math.log(0.001))
    conv_w = torch.randn(c.conv_width, _conv_channels(cfg), generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, D, zxbcdt, pdt, device),
        "conv_w": (conv_w / math.sqrt(c.conv_width)).to(pdt),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "D_skip": torch.ones(H, dtype=torch.float32, device=device),
        "gate_norm": rmsnorm_init(d_in, pdt, device),
        "out_proj": dense_init(gen, d_in, D, pdt, device),
    }


# ---------------------------------------------------------------------------
# chunked SSD core (the plain version of the SSD kernel)
# ---------------------------------------------------------------------------


def check_chunking(S: int, chunk: int) -> int:
    """The chunk length ``L = min(chunk, S)``; raises unless ``S % L == 0``
    (the reference asserts the same condition)."""
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"SSD needs the sequence length to be a multiple "
                         f"of the chunk: S={S}, chunk={L} (S must be <= "
                         f"{chunk} or a multiple of it)")
    return L


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} a[..., k], -inf above the diagonal.

    a: (..., L) -> (..., L, L)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              device=a.device))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, H, P)`` (pre-multiplied by dt), a ``(B, S, H)`` log decay,
    Bm and Cm ``(B, S, H, N)`` (already broadcast to heads), init_state
    ``(B, H, P, N)``.  Returns (y ``(B, S, H, P)`` in x.dtype, final state
    ``(B, H, P, N)`` f32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = check_chunking(S, chunk)
    nc = S // L

    f32 = torch.float32
    xc = x.reshape(Bsz, nc, L, H, P).to(f32)
    ac = a.reshape(Bsz, nc, L, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, L, H, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, L, H, N).to(f32)

    a_hl = torch.movedim(ac, -1, -2)                     # (B, nc, H, L)
    a_cum = torch.cumsum(a_hl, dim=-1)

    # 1) intra-chunk dense block
    Lmat = torch.exp(_segsum(a_hl))                      # (B, nc, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xc)

    # 2) per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)    # (B, nc, H, L)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, decay_states, xc)

    # 3) inter-chunk recurrence; each chunk sees the *incoming* state
    chunk_decay = torch.exp(a_cum[..., -1])              # (B, nc, H)
    carry = (torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B, nc, H, P, N)

    # 4) state -> output contribution
    state_decay = torch.exp(a_cum)                       # (B, nc, H, L)
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", Cc, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), carry


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. seq ``(B, S, C)``; w ``(W, C)``; history
    ``(B, W-1, C)``.  The shifted products are summed in ``seq.dtype`` in
    the reference's order (Python ``sum``), then SiLU runs in f32."""
    W = w.shape[0]
    if history is None:
        history = seq.new_zeros(seq.shape[0], W - 1, seq.shape[2])
    padded = torch.cat([history, seq], dim=1)           # (B, S+W-1, C)
    S = seq.shape[1]
    out = sum(padded[:, i:i + S] * w[i][None, None, :] for i in range(W))
    return F.silu(out.float()).to(seq.dtype)


# logical names of the SSD's head-parallel operands, (B, S, H, P|N), and of
# its state, (B, H, P, N): on a mesh the SSD runs on each rank's rows and
# heads (``local_region``), where its ops need no rule of DTensor's
_HEADS = ("batch", None, "ssm_heads", None)
_STATE = ("batch", "ssm_heads", None, None)


def _recurrent_step(state, a, Bm, x_dt, Cm):
    """One token of the recurrence: state = state * exp(a) + B ⊗ x_dt,
    y = C · state.  a ``(B, H)``, Bm and Cm ``(B, H, N)``, x_dt
    ``(B, H, P)`` -> (y ``(B, 1, H, P)``, state f32)."""
    st = state.float()
    st = st * torch.exp(a[:, :, None, None]) + torch.einsum(
        "bhn,bhp->bhpn", Bm.float(), x_dt)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), st)[:, None]
    return y, st


def ssm_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
              cache: Optional[SSMCache] = None, *, use_kernel: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Train/prefill when S > 1 (returns the new cache if one was passed);
    single-token recurrent decode when S == 1 and a cache is given.

    ``use_kernel`` sends the SSD through ``ops.ssd_scan`` (the CUDA kernel
    for a CUDA tensor, ``ref.ssd`` on the CPU) instead of ``ssd_chunked``.
    With one B/C group (mamba2), B and C reach the SSD as a stride-0 view
    over heads, not as the reference's repeated copy; with G groups
    (jamba's 8) they are expanded to heads by a copy, as in the
    reference (``2 * B * S * H * N`` values)."""
    c = cfg.ssm
    B_, S, D = x.shape
    d_in, H, P, N, G = cfg.d_inner, cfg.ssm_heads, c.head_dim, \
        c.state_dim, c.n_groups
    cdt = cfg.dtype("compute")
    x = x.to(cdt)

    # on a mesh the layer's activations keep one layout, rows over the
    # batch axes and every channel whole: left to DTensor, its layout
    # choices here cost minutes of host time in the products
    zxbcdt = shard(x @ params["in_proj"].to(cdt), "batch", "seq", None)
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H],
                                    dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)           # (B, S, conv_ch)
    w = params["conv_w"].to(cdt)
    Wd = w.shape[0]

    if cache is not None and S == 1:
        conv_hist = cache.conv.to(cdt)
        conv_out = _causal_conv(conv_in, w, conv_hist)
        new_conv = torch.cat([conv_hist, conv_in], dim=1)[:, 1:]
    else:
        conv_out = _causal_conv(conv_in, w)
        new_conv = None
        if cache is not None:
            tail = conv_in[:, -(Wd - 1):]
            pad = Wd - 1 - tail.shape[1]
            if pad > 0:
                tail = F.pad(tail, (0, 0, pad, 0))
            new_conv = tail

    xs, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B_, S, H, P)
    Bc = Bc.reshape(B_, S, G, N)
    Cc = Cc.reshape(B_, S, G, N)
    if G == 1:
        Bh, Ch = Bc.expand(B_, S, H, N), Cc.expand(B_, S, H, N)
    else:
        Bh = Bc.repeat_interleave(H // G, dim=2)
        Ch = Cc.repeat_interleave(H // G, dim=2)

    dt = F.softplus(dt.float() + params["dt_bias"])     # (B, S, H)
    A = -torch.exp(params["A_log"])                      # (H,) negative
    a = A[None, None, :] * dt                            # log decay
    x_dt = xs.float() * dt[..., None]                    # (B, S, H, P)

    init_state = cache.state if cache is not None else None

    if S == 1 and cache is not None:
        y, final_state = local_region(
            _recurrent_step, (cache.state, a[:, 0], Bh[:, 0], x_dt[:, 0],
                              Ch[:, 0]),
            (_STATE, _HEADS[:1] + _HEADS[2:3], _HEADS[:1] + _HEADS[2:],
             _HEADS[:1] + _HEADS[2:], _HEADS[:1] + _HEADS[2:]),
            [(_HEADS, (B_, 1, H, P)), (_STATE, tuple(cache.state.shape))])
    elif use_kernel:
        from repro_torch.kernels import ops

        y, final_state = ops.ssd_scan(x_dt, a, Bh, Ch, chunk=c.chunk_size,
                                      init_state=init_state)
    else:
        L = min(c.chunk_size, S)
        y, final_state = local_region(
            lambda x, a, b, c, s: ssd_chunked(x, a, b, c, chunk=L,
                                              init_state=s),
            (x_dt, a, Bh, Ch, init_state),
            (_HEADS, _HEADS[:3], _HEADS, _HEADS, _STATE),
            [(_HEADS, tuple(x_dt.shape)), (_STATE, (B_, H, P, N))])

    y = y + xs.float() * params["D_skip"][None, None, :, None]
    # the heads whole again: the gate's norm runs over all of d_in
    y = shard(y.reshape(B_, S, d_in).to(cdt), "batch", "seq", None)
    y = y * F.silu(z.float()).to(cdt)
    y = rmsnorm(params["gate_norm"], y, cfg.norm_eps)
    out = y @ params["out_proj"].to(cdt)

    new_cache = None
    if cache is not None:
        new_cache = SSMCache(state=final_state.to(cache.state.dtype),
                             conv=new_conv.to(cache.conv.dtype))
    return out, new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None,
                   device="cuda") -> SSMCache:
    c = cfg.ssm
    cdt = dtype or cfg.dtype("compute")
    return SSMCache(
        state=torch.zeros(batch, cfg.ssm_heads, c.head_dim, c.state_dim,
                          dtype=torch.float32, device=device),
        conv=torch.zeros(batch, c.conv_width - 1, _conv_channels(cfg),
                         dtype=cdt, device=device),
    )
