"""Decoder layers as plain functions over nested dicts of tensors.

Counterpart of ``repro/models/layers.py``: activations are ``(B, S, D)``,
attention ``(B, S, H, Dh)``; parameters are created in ``cfg.param_dtype``
and compute runs in ``cfg.compute_dtype`` with f32 softmax and
normalization.  Positions are ``(B, S)``, or ``(3, B, S)`` (t, h, w) under
qwen2-vl's M-RoPE, whose masks read the first component.  The projections,
the MLP and the unembed stay ``torch.matmul`` (the reference leaves them to
XLA).  Full-sequence attention is the plain ``sdpa_reference`` under
``attention_impl="xla"`` (the reference's default), the online-softmax
loop over key chunks ``sdpa_chunked`` under ``"xla_chunked"`` (plain
PyTorch, as the reference runs it in XLA) and the CUDA flash kernel under
``"pallas"``; decode attends over a :class:`KVCache` with
``sdpa_reference``, as the reference does.  Cross-attention
(``kv_override``, the encoder-decoder's) attends over given K/V with no
mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.sharding.rules import (axis_group, is_dtensor,
                                        local_region, logical_to_spec,
                                        merge_dims, replicate, shard,
                                        split_dim)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(d_in, d_out, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def rmsnorm_init(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm scaled by ``(1 + scale)``, in f32."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (B, S, half)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of ``x`` (B, S, H, Dh) by f32 ``angles``
    (B, S, Dh/2)."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): ``positions`` is (3, B, S), (t, h, w).

    The ``head_dim/2`` frequency slots are split into ``sections`` (summing
    to head_dim/2); slot group i rotates by the i-th position component.
    Equal components give :func:`apply_rope`'s result bit for bit."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    pos = positions.float()
    parts, start = [], 0
    for comp, n in enumerate(sections):
        parts.append(pos[comp][..., None] * freqs[start:start + n])
        start += n
    return _rotate(x, torch.cat(parts, dim=-1))           # (B, S, half)


def position_embed(cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos_embed == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_embed == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


def attention_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    pdt = cfg.dtype("param")
    return {
        "wq": dense_init(gen, D, H * Dh, pdt, device),
        "wk": dense_init(gen, D, K * Dh, pdt, device),
        "wv": dense_init(gen, D, K * Dh, pdt, device),
        "wo": dense_init(gen, H * Dh, D, pdt, device,
                         scale=1.0 / math.sqrt(H * Dh)),
    }


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(logits / cap)
    return logits


def attn_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
              k_valid: Optional[torch.Tensor], causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """Additive f32 bias of shape (B, 1, Sq, Sk)."""
    # out of place: on a mesh the positions may be placed (qwen2-vl's come
    # with the batch) while ``ok`` starts plain
    ok = torch.ones(q_pos.shape[0], q_pos.shape[1], k_pos.shape[1],
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        ok = ok & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    if k_valid is not None:
        ok = ok & k_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def _sdpa_plain(q, k, v, bias, softcap: float) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qh = q.reshape(B, Sq, K, G, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh.float(),
                          k.float()) / math.sqrt(Dh)
    logits = _softcap(logits, softcap)
    logits = logits + bias[:, :, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _kv_layout(kv: torch.Tensor, seq_axis: Optional[str] = None):
    """How a placed K/V tensor ``(B, S, K, Dh)`` (a cache leaf, its
    sequence named ``seq_axis``) lies on its mesh: (the logical name of
    its heads, sharded as the kv heads are or None, and ``axis_group`` of
    its sequence: None when whole).  A query's heads take the same name,
    so that each query head's group is on the rank of its kv head."""
    if not is_dtensor(kv):
        return "kv_heads", None
    spec = logical_to_spec(tuple(kv.shape), ("batch", seq_axis, "kv_heads",
                                             None), mesh=kv.device_mesh)
    return ("kv_heads" if spec[2] is not None else None,
            axis_group(kv.device_mesh, spec[1]))


def sdpa_reference(q, k, v, bias, softcap: float = 0.0) -> torch.Tensor:
    """Plain scaled-dot-product attention in f32 with GQA.

    q: (B, Sq, H, Dh); k, v: (B, Sk, K, Dh); bias: (B, 1, Sq, Sk).  On a
    mesh it runs on each rank's rows and kv heads
    (:func:`~repro_torch.sharding.rules.local_region`): attention needs no
    communication there."""
    ref = next((t for t in (q, k, v) if is_dtensor(t)), None)
    if ref is None:
        return _sdpa_plain(q, k, v, bias, softcap)
    qh = _kv_layout(k)[0] if is_dtensor(k) else None
    kv = ("batch", None, qh, None)
    return local_region(
        lambda q, k, v, b: _sdpa_plain(q, k, v, b, softcap),
        (q, k, v, bias), (("batch", None, qh, None), kv, kv,
                          ("batch", None, None, None)),
        [(("batch", None, qh, None), tuple(q.shape))])


def _decode_attend(q, k_new, v_new, cache, pos, tok_pos, *,
                   window: Optional[int], softcap: float, cdt,
                   seq_axis: Optional[str]) -> torch.Tensor:
    """Write each row's new K/V at its slot and attend over its valid
    slots (``attention_apply``'s decode mode).  On a mesh, each rank
    writes and reads its local shard of the cache in place: the rank
    whose range of the sequence (``seq_axis``, ``"cache_seq"`` for a full
    cache) holds a row's slot writes it, with no host read of ``pos``;
    the softmax's max and sum and the output are all-reduced over the
    sequence's mesh axis, so K and V are never gathered."""
    B = q.shape[0]
    C = cache.k.shape[1]
    ring = window is not None and C == window
    cache_names = ("batch", seq_axis, "kv_heads", None)
    qh, split = _kv_layout(cache.k, seq_axis)
    group, ways, coord = split if split is not None else (None, 1, 0)

    def attend(q, kn, vn, ck, cv, pos, tpos):
        Bl, Cl = ck.shape[0], ck.shape[1]
        off = coord * Cl
        slot = torch.remainder(pos, C) if ring else torch.clamp(pos,
                                                                max=C - 1)
        rows = torch.arange(Bl, device=ck.device)
        if ways == 1:
            ck.index_put_((rows, slot), kn[:, 0].to(ck.dtype))
            cv.index_put_((rows, slot), vn[:, 0].to(cv.dtype))
        else:
            loc = slot - off
            own = ((loc >= 0) & (loc < Cl))[:, None, None]
            idx = torch.clamp(loc, 0, Cl - 1)
            for c, new in ((ck, kn), (cv, vn)):
                c.index_put_((rows, idx), torch.where(
                    own, new[:, 0].to(c.dtype), c[rows, idx]))
        slots = off + torch.arange(Cl, device=ck.device)[None]
        if ring:
            # slot j holds absolute position p = pos - ((pos - j) mod C)
            k_pos = pos[:, None] - torch.remainder(pos[:, None] - slots, C)
            k_valid = k_pos >= 0
        else:
            k_pos = slots.expand(Bl, Cl)
            k_valid = slots <= pos[:, None]
        bias = attn_bias(tpos, k_pos, k_valid, causal=True, window=window)
        if ways == 1:
            return _sdpa_plain(q, ck.to(cdt), cv.to(cdt), bias, softcap)
        from torch.distributed import _functional_collectives as funcol

        Hl, Dh = q.shape[2], q.shape[3]
        Kl = ck.shape[2]
        qg = q.reshape(Bl, 1, Kl, Hl // Kl, Dh)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                              ck.to(cdt).float()) / math.sqrt(Dh)
        logits = _softcap(logits, softcap) + bias[:, :, None, :, :]
        m = funcol.all_reduce(logits.amax(dim=-1, keepdim=True), "max",
                              group)
        p = torch.exp(logits - m)
        denom = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
        out = funcol.all_reduce(torch.einsum(
            "bkgqs,bskd->bqkgd", p / denom, cv.to(cdt).float()), "sum",
            group)
        return out.reshape(Bl, 1, Hl, Dh).to(q.dtype)

    pos = pos.expand(B) if pos.dim() == 0 else pos
    return local_region(
        attend, (q, k_new, v_new, cache.k, cache.v, pos, tok_pos),
        (("batch", None, qh, None), ("batch", None, qh, None),
         ("batch", None, qh, None), cache_names, cache_names, ("batch",),
         ("batch", None)),
        [(("batch", None, qh, None), tuple(q.shape))])


class KVCache(NamedTuple):
    """Decode cache of one attention position: k, v ``(B, C, K, Dh)``."""

    k: torch.Tensor
    v: torch.Tensor


def sdpa_chunked(q, k, v, q_pos, k_pos, *, causal: bool,
                 window: Optional[int], softcap: float = 0.0,
                 chunk: int = 512) -> torch.Tensor:
    """Blockwise attention with an online softmax over key chunks, the
    reference's ``sdpa_chunked`` (a ``lax.scan`` in XLA there, a loop of
    plain PyTorch here): it never holds the (Sq, Sk) score matrix, only
    (Sq, chunk).  q: (B, Sq, H, Dh); k, v: (B, Sk, K, Dh); q_pos (B, Sq)
    and k_pos (B, Sk) are the absolute positions the masks read.  Keys are
    padded to a whole chunk at position -1,000,000, masked scores are
    -1e30, and a row that has seen no key yet keeps a zero running max."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    c = min(chunk, Sk)
    pad = (-Sk) % c
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1_000_000)
    qh = q.reshape(B, Sq, K, G, Dh).float() / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    m = torch.full((B, K, G, Sq, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, Dh), dtype=torch.float32,
                      device=q.device)
    for start in range(0, Sk + pad, c):
        kb, vb = kf[:, start:start + c], vf[:, start:start + c]
        pb = k_pos[:, start:start + c][:, None, :]           # (B, 1, c)
        s = _softcap(torch.einsum("bqkgd,bskd->bkgqs", qh, kb), softcap)
        vis = pb > (-1_000_000 + 1)                          # padding off
        if causal:
            vis = vis & (pb <= q_pos[:, :, None])
        if window is not None:
            vis = vis & (pb > (q_pos[:, :, None] - window))
        vis = vis[:, None, None].expand(s.shape)
        s = torch.where(vis, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new <= -1e29, 0.0, m_new)
        p = torch.where(vis, torch.exp(s - m_safe), 0.0)
        alpha = torch.where(m <= -1e29, 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)                # (B,K,G,Sq,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def _sdpa(cfg: ModelConfig, q, k, v, bias, *, causal: bool,
          window: Optional[int],
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch between the plain attention, the chunked loop and the flash
    kernel.

    ``"pallas"`` sends a multi-token query to ``ops.flash_attention``, which
    builds its masks from positions ``0..S-1`` and ignores ``bias``: the
    callers (``forward`` without explicit positions, ``prefill``) give it
    exactly those positions.  ``"xla_chunked"`` sends a multi-token query
    with ``positions`` to :func:`sdpa_chunked` with keys at ``0..Sk-1``, as
    the reference does, whatever the query positions."""
    impl = cfg.attention_impl
    if impl == "pallas_interpret":
        raise NotImplementedError(
            "attention_impl 'pallas_interpret' runs a Pallas kernel in "
            "interpret mode; the port's flash kernel runs compiled on the "
            "card under 'pallas' (ROADMAP.md Queue 2 item 3)")
    if impl == "pallas" and q.shape[1] > 1:
        from repro_torch.kernels import ops

        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=cfg.attn_softcap, bias=bias)
    if impl not in ("xla", "xla_chunked", "pallas"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    if impl == "xla_chunked" and q.shape[1] > 1 and positions is not None:
        k_pos = torch.arange(k.shape[1], device=k.device)[None].expand(
            k.shape[0], k.shape[1])
        return sdpa_chunked(q, k, v, positions, k_pos, causal=causal,
                            window=window, softcap=cfg.attn_softcap)
    return sdpa_reference(q, k, v, bias, softcap=cfg.attn_softcap)


def attention_apply(params: dict, cfg: ModelConfig, spec: LayerSpec,
                    x: torch.Tensor, positions: torch.Tensor, *,
                    causal: bool = True, cache: Optional[KVCache] = None,
                    cache_pos: Union[int, torch.Tensor, None] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention, full-sequence or one decode token.

    Modes:
      - train/prefill: ``cache is None``; returns ``(out, None)``.
      - decode: ``cache`` given and ``S == 1``; ``cache_pos`` (a scalar or a
        ``(B,)`` int tensor, tokens already cached per row) says where each
        row writes its K/V: slot ``cache_pos % C`` in a ring buffer
        (``spec.window == C``), else ``min(cache_pos, C - 1)``.  Each row
        then attends over its own valid slots.  The cache is updated **in
        place** (the reference returns a new one); returns ``(out, cache)``.
      - cross-attention: ``kv_override`` gives precomputed ``(k, v)``
        ``(B, Sk, K, Dh)``; the queries attend over all of them, with no
        mask; returns ``(out, None)``.

    ``positions`` is ``(B, S)``, or ``(3, B, S)`` under M-RoPE; every mask
    reads its first component, as the reference's do.
    """
    B, S, D = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = cfg.dtype("compute")
    x = x.to(cdt)
    q = split_dim(x @ params["wq"].to(cdt), 2, (H, Dh))
    tok_pos = positions if positions.dim() == 2 else positions[0]  # (B, S)

    if kv_override is not None:
        k, v = kv_override
        q = position_embed(cfg, q, positions)
        k_pos = torch.arange(k.shape[1], dtype=tok_pos.dtype,
                             device=x.device)[None].expand(B, k.shape[1])
        bias = attn_bias(tok_pos, k_pos, None, causal=False, window=None)
        out = _sdpa(cfg, q, k, v, bias, causal=False, window=None)
        return merge_dims(out, 2, 2) @ params["wo"].to(cdt), None

    k = split_dim(x @ params["wk"].to(cdt), 2, (K, Dh))
    v = split_dim(x @ params["wv"].to(cdt), 2, (K, Dh))
    q = position_embed(cfg, q, positions)
    k = position_embed(cfg, k, positions)

    if cache is None:
        if cfg.attention_impl == "xla_chunked" and S > 1:
            bias = None       # sdpa_chunked masks chunk by chunk
        else:
            bias = attn_bias(tok_pos, tok_pos, None, causal=causal,
                             window=spec.window)
        out = _sdpa(cfg, q, k, v, bias, causal=causal, window=spec.window,
                    positions=tok_pos)
        return merge_dims(out, 2, 2) @ params["wo"].to(cdt), None

    # ------------------------------------------------------------- decode
    if S != 1:
        raise ValueError(f"decode expects one query token, got {S}")
    pos = torch.as_tensor(cache_pos, device=x.device).long()
    out = _decode_attend(q, k, v, cache, pos, tok_pos, window=spec.window,
                         softcap=cfg.attn_softcap, cdt=cdt,
                         seq_axis="cache_seq" if spec.window is None
                         else None)
    return merge_dims(out, 2, 2) @ params["wo"].to(cdt), cache


def fill_kv_cache(dst: torch.Tensor, src: torch.Tensor,
                  seq_axis: Optional[str]) -> None:
    """The prompt's K or V ``src`` ``(B, Sq, K, Dh)`` into an empty cache
    leaf ``dst`` ``(B, C, K, Dh)``, in place: slots ``0..Sq-1`` when the
    cache holds the prompt, else (a ring buffer shorter than the prompt)
    the tail, rolled so that slot j holds position p = j (mod C).  On a
    mesh each rank fills its own shard of the sequence (``seq_axis``)."""
    C, Sq = dst.shape[1], src.shape[1]
    heads, split = _kv_layout(dst, seq_axis)
    coord = split[2] if split is not None else 0

    def fill(d, s):
        if C >= Sq:
            part = s[:, coord * d.shape[1]:(coord + 1) * d.shape[1]]
            d[:, :part.shape[1]] = part
        else:
            d.copy_(torch.roll(s[:, -C:], Sq % C, dims=1))
        return ()

    local_region(fill, (dst, src), (("batch", seq_axis, "kv_heads", None),
                                    ("batch", None, heads, None)), [])


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                  seq_len: int, dtype=None, device="cuda") -> KVCache:
    """An empty decode cache for one attention position (a ring buffer of
    ``window`` slots for a windowed position)."""
    dtype = dtype or cfg.dtype("compute")
    cap = min(spec.window, seq_len) if spec.window is not None else seq_len
    shape = (batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    pdt = cfg.dtype("param")
    return {
        "wg": dense_init(gen, D, Fd, pdt, device),
        "wu": dense_init(gen, D, Fd, pdt, device),
        "wd": dense_init(gen, Fd, D, pdt, device, scale=1.0 / math.sqrt(Fd)),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; the gate's SiLU runs in f32."""
    cdt = x.dtype
    g = F.silu((x @ params["wg"].to(cdt)).float()).to(cdt)
    u = x @ params["wu"].to(cdt)
    return (g * u) @ params["wd"].to(cdt)


def embed_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    pdt = cfg.dtype("param")
    p = {"tokens": dense_init(gen, V, D, pdt, device, scale=1.0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, D, V, pdt, device)
    return p


def _sharded_lookup(tokens: torch.Tensor, table: torch.Tensor
                    ) -> torch.Tensor:
    """``F.embedding(tokens, table)`` on a table placed by ``("vocab",
    "fsdp")``, without gathering it: each rank looks up the rows of its
    vocab shard (zeros for the others' tokens), and the partial rows are
    all-reduced over the vocab's axis, one of them nonzero, so the sum is
    exact.  Where the batch and the table's columns share the ``"data"``
    axis, the tokens of the ranks along it are gathered first and an
    all-to-all returns each its rows with every column."""
    from torch.distributed import _functional_collectives as funcol

    mesh = table.device_mesh
    t_spec = logical_to_spec(tuple(table.shape), ("vocab", "fsdp"),
                             mesh=mesh)
    b_spec = logical_to_spec(tuple(tokens.shape), ("batch", None), mesh=mesh)
    vocab = axis_group(mesh, t_spec[0])
    cols = axis_group(mesh, t_spec[1])
    batch_axes = (() if b_spec[0] is None else (b_spec[0],)
                  if isinstance(b_spec[0], str) else b_spec[0])
    swap = cols is not None and t_spec[1] in batch_axes

    def lookup(tok, tab):
        if swap:
            gather = getattr(funcol, "all_gather_single",
                             funcol.all_gather_tensor)
            tok = gather(tok.contiguous(), 0, cols[0])
        Vl = tab.shape[0]
        rows = tok.long() - (vocab[2] * Vl if vocab is not None else 0)
        ok = ((rows >= 0) & (rows < Vl))[..., None]
        emb = torch.where(ok, F.embedding(torch.clamp(rows, 0, Vl - 1),
                                          tab), 0.0).to(tab.dtype)
        if vocab is not None:
            emb = funcol.all_reduce(emb, "sum", vocab[0])
        if swap:
            n = cols[1]
            emb = funcol.all_to_all_single(emb.contiguous(), None, None,
                                           cols[0])
            mid, Dl = tuple(emb.shape[1:-1]), emb.shape[-1]
            Bl = emb.shape[0] // n
            emb = torch.movedim(emb.reshape(n, Bl, *mid, Dl), 0, -2)
            emb = emb.reshape(Bl, *mid, n * Dl)
        return emb

    return local_region(lookup, (tokens, table),
                        (("batch", None), ("vocab", "fsdp")),
                        [(("batch", None, "fsdp"),
                          tuple(tokens.shape) + (table.shape[1],))])


def embed_apply(params: dict, cfg: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype.  ``embed_impl="onehot"`` is
    the reference's one-hot product over ``cfg.padded_vocab``, which
    distributes over a vocab-sharded table (a partial sum per shard, then
    one reduction) where the gather would gather the table whole; a one-hot
    row times the table selects the row exactly, so both give the same
    bits.  Any other value but ``"gather"`` raises."""
    cdt = cfg.dtype("compute")
    if cfg.embed_impl == "onehot":
        oh = F.one_hot(tokens.long(), cfg.padded_vocab).to(cdt)
        oh = shard(oh, "batch", "seq", "vocab")
        emb = oh @ params["tokens"].to(cdt)
    elif cfg.embed_impl == "gather":
        # on a mesh, with a gradient to take, the lookup reads the table
        # gathered (indexing gathers it too), through ``F.embedding``:
        # torch 2.11's DTensor rules raise in the backward of indexing
        # (``index_put``) and of a lookup in a vocab-sharded table (a
        # masked partial sum).  Without one (serving), the table is never
        # gathered (:func:`_sharded_lookup`).  The rows are the same
        table = params["tokens"].to(cdt)
        if torch.is_grad_enabled() or not is_dtensor(table):
            emb = F.embedding(tokens, replicate(table))
        else:
            emb = _sharded_lookup(tokens, table)
    else:
        raise ValueError(f"unknown embed_impl {cfg.embed_impl!r}")
    if cfg.tie_embeddings:
        emb = emb * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt,
                                 device=emb.device)
    return emb


def unembed_apply(params: dict, cfg: ModelConfig,
                  h: torch.Tensor) -> torch.Tensor:
    cdt = cfg.dtype("compute")
    if cfg.tie_embeddings:
        logits = h @ params["tokens"].to(cdt).T
    else:
        logits = h @ params["lm_head"].to(cdt)
    return _softcap(logits.float(), cfg.final_softcap)
