"""Encoder-decoder backbone (whisper-tiny).

Counterpart of ``repro/models/encdec.py``: ``EncDecCache``, ``init_params``,
``encode``, ``_cross_kv``, ``forward``, ``loss_fn``, ``init_cache`` and
``decode_step``.  As in the reference, the mel-spectrogram and conv
frontend is a stub: the encoder takes precomputed frame embeddings ``(B,
encoder_ctx, D)``; the backbone uses RoPE where Whisper has learned
absolute embeddings.  The encoder's self-attention is non-causal over the
frames; under ``attention_impl="pallas"`` it runs the flash kernel (on the
card) at the frame count, 1500 for whisper-tiny.  Each decoder block runs
causal self-attention, cross-attention over the encoder output's K/V
(projected once per block: ``_cross_kv``) and the MLP.  Decode keeps a
full self-attention KV cache per block and the precomputed cross K/V; the
cache is updated in place.  The reference's ``shard`` calls stand at its
places (each block's output, the decoder's embeddings and its logits):
placements on a DTensor under ``repro_torch.sharding.rules.axis_rules``,
no-ops on plain tensors.  ``abstract_params``, ``param_logical_axes`` and
``cache_logical_axes`` give the trees the mesh path places.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.transformer import (_select_group,
                                            softmax_cross_entropy,
                                            stack_groups)
from repro_torch.sharding.rules import LA, shard, split_dim

Params = Dict[str, Any]
_SPEC = LayerSpec()  # plain global attention


class EncDecCache(NamedTuple):
    """``self_kv`` ``(G, B, C, K, Dh)`` stacked over decoder blocks;
    ``cross_k``, ``cross_v`` ``(G, B, Senc, K, Dh)``."""

    self_kv: L.KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _block_init(gen: torch.Generator, cfg: ModelConfig, cross: bool,
                device) -> Params:
    D, pdt = cfg.d_model, cfg.dtype("param")
    p = {
        "ln1": L.rmsnorm_init(D, pdt, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(D, pdt, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }
    if cross:
        p["lnx"] = L.rmsnorm_init(D, pdt, device)
        p["xattn"] = L.attention_init(gen, cfg, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random parameters from ``gen`` in the reference's tree (torch's
    generator cannot reproduce JAX's; ``repro_torch.convert`` carries the
    reference's parameters over)."""
    pdt = cfg.dtype("param")
    return {
        "embed": L.embed_init(gen, cfg, device),
        "encoder": {
            "blocks": stack_groups(cfg.encoder_layers, lambda: _block_init(
                gen, cfg, False, device)),
            "final_norm": L.rmsnorm_init(cfg.d_model, pdt, device),
        },
        "decoder": {
            "blocks": stack_groups(cfg.n_layers, lambda: _block_init(
                gen, cfg, True, device)),
            "final_norm": L.rmsnorm_init(cfg.d_model, pdt, device),
        },
    }


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree on the ``meta`` device, nothing allocated."""
    return init_params(torch.Generator(device="cpu"), cfg, device="meta")


def param_logical_axes(cfg: ModelConfig) -> Params:
    """``LA`` leaves in the parameter tree's structure, the reference's."""
    def g(*names):
        return LA(("layers",) + names)

    attn = {"wq": g("fsdp", "heads"), "wk": g("fsdp", "kv_heads"),
            "wv": g("fsdp", "kv_heads"), "wo": g("heads", "fsdp")}
    mlp = {"wg": g("fsdp", "d_ff"), "wu": g("fsdp", "d_ff"),
           "wd": g("d_ff", "fsdp")}
    block = {"ln1": {"scale": g(None)}, "attn": dict(attn),
             "ln2": {"scale": g(None)}, "mlp": dict(mlp)}
    dec_block = dict(block, lnx={"scale": g(None)}, xattn=dict(attn))
    embed: Params = {"tokens": LA(("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        embed["lm_head"] = LA(("fsdp", "vocab"))
    return {"embed": embed,
            "encoder": {"blocks": block, "final_norm": {"scale": LA((None,))}},
            "decoder": {"blocks": dec_block,
                        "final_norm": {"scale": LA((None,))}}}


def cache_logical_axes(cfg: ModelConfig, seq_len: int) -> EncDecCache:
    del cfg, seq_len
    kv = LA(("layers", "batch", "cache_seq", "kv_heads", None))
    cross = LA(("layers", "batch", None, "kv_heads", None))
    return EncDecCache(self_kv=L.KVCache(k=kv, v=kv), cross_k=cross,
                       cross_v=cross)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_params`'s tree (``ModelConfig.
    param_count`` counts the decoder-only stack)."""
    D, V = cfg.d_model, cfg.padded_vocab
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
    block = 2 * D + attn + 3 * D * cfg.d_ff
    embed = V * D * (1 if cfg.tie_embeddings else 2)
    return (embed + cfg.encoder_layers * block + D
            + cfg.n_layers * (block + D + attn) + D)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def encode(params: Params, cfg: ModelConfig,
           audio_emb: torch.Tensor) -> torch.Tensor:
    """audio_emb ``(B, Senc, D)`` stub frame embeddings -> ``(B, Senc,
    D)``."""
    h = audio_emb.to(cfg.dtype("compute"))
    B, Senc, _ = h.shape
    pos = _positions(B, Senc, h.device)
    blocks = params["encoder"]["blocks"]
    for g in range(cfg.encoder_layers):
        p = _select_group(blocks, g)
        hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
        out, _ = L.attention_apply(p["attn"], cfg, _SPEC, hn, pos,
                                   causal=False)
        h = h + out
        hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
        h = shard(h + L.mlp_apply(p["mlp"], hn), "batch", "seq", "d_model")
    return L.rmsnorm(params["encoder"]["final_norm"], h, cfg.norm_eps)


def _cross_kv(p: Params, cfg: ModelConfig, enc: torch.Tensor):
    B, Senc, _ = enc.shape
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = cfg.dtype("compute")
    k = split_dim(enc @ p["xattn"]["wk"].to(cdt), 2, (K, Dh))
    v = split_dim(enc @ p["xattn"]["wv"].to(cdt), 2, (K, Dh))
    return k, v


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            audio_emb: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Teacher-forced decoder over ``(B, S)`` tokens given stub audio
    embeddings.  Returns (logits f32, {})."""
    enc = encode(params, cfg, audio_emb)
    B, Sq = tokens.shape
    pos = _positions(B, Sq, tokens.device)
    h = shard(L.embed_apply(params["embed"], cfg, tokens),
              "batch", "seq", "d_model")
    blocks = params["decoder"]["blocks"]
    for g in range(cfg.n_layers):
        p = _select_group(blocks, g)
        hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
        out, _ = L.attention_apply(p["attn"], cfg, _SPEC, hn, pos,
                                   causal=True)
        h = h + out
        hn = L.rmsnorm(p["lnx"], h, cfg.norm_eps)
        out, _ = L.attention_apply(p["xattn"], cfg, _SPEC, hn, pos,
                                   kv_override=_cross_kv(p, cfg, enc))
        h = h + out
        hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
        h = shard(h + L.mlp_apply(p["mlp"], hn), "batch", "seq", "d_model")
    h = L.rmsnorm(params["decoder"]["final_norm"], h, cfg.norm_eps)
    logits = L.unembed_apply(params["embed"], cfg, h)
    return shard(logits, "batch", "seq", "vocab"), {}


def loss_fn(params: Params, cfg: ModelConfig,
            batch: dict) -> Tuple[torch.Tensor, dict]:
    logits, _ = forward(params, cfg, batch["tokens"], batch["audio_emb"])
    ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce, {"loss": ce, "ce": ce}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               enc: Optional[torch.Tensor] = None,
               params: Optional[Params] = None,
               device="cuda") -> EncDecCache:
    """An empty self-attention cache of ``seq_len`` positions per decoder
    block, and the cross K/V of ``enc`` (the encoder's output) when both
    ``enc`` and ``params`` are given, else zeros."""
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = cfg.dtype("compute")
    G = cfg.n_layers
    if enc is not None:
        device = enc.device
    kv = L.KVCache(
        k=torch.zeros(G, batch, seq_len, K, Dh, dtype=cdt, device=device),
        v=torch.zeros(G, batch, seq_len, K, Dh, dtype=cdt, device=device))
    if enc is not None and params is not None:
        blocks = params["decoder"]["blocks"]
        pairs = [_cross_kv(_select_group(blocks, g), cfg, enc)
                 for g in range(G)]
        ck = torch.stack([k for k, _ in pairs])
        cv = torch.stack([v for _, v in pairs])
    else:
        shape = (G, batch, cfg.encoder_ctx, K, Dh)
        ck = torch.zeros(shape, dtype=cdt, device=device)
        cv = torch.zeros(shape, dtype=cdt, device=device)
    return EncDecCache(self_kv=kv, cross_k=ck, cross_v=cv)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: EncDecCache, cache_pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, EncDecCache]:
    """One decoder token ``(B, 1)`` at ``cache_pos`` (a scalar or ``(B,)``);
    cross-attention reads the precomputed encoder K/V.  Returns (logits
    ``(B, 1, V)`` f32, cache); the cache is updated in place."""
    B = token.shape[0]
    pos = torch.as_tensor(cache_pos, device=token.device).to(torch.int32)
    positions = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
    h = L.embed_apply(params["embed"], cfg, token)
    blocks = params["decoder"]["blocks"]
    for g in range(cfg.n_layers):
        p = _select_group(blocks, g)
        kv = L.KVCache(cache.self_kv.k[g], cache.self_kv.v[g])
        hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
        out, _ = L.attention_apply(p["attn"], cfg, _SPEC, hn, positions,
                                   cache=kv, cache_pos=pos)
        h = h + out
        hn = L.rmsnorm(p["lnx"], h, cfg.norm_eps)
        out, _ = L.attention_apply(
            p["xattn"], cfg, _SPEC, hn, positions,
            kv_override=(cache.cross_k[g], cache.cross_v[g]))
        h = h + out
        hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
        h = h + L.mlp_apply(p["mlp"], hn)
    h = L.rmsnorm(params["decoder"]["final_norm"], h, cfg.norm_eps)
    return L.unembed_apply(params["embed"], cfg, h), cache
