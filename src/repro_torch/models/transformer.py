"""Decoder-only stack of attention, SSM and MoE positions, a loop over
layer groups.

Counterpart of ``repro/models/transformer.py``: the same parameter tree
(repeated-block leaves stacked over ``cfg.n_groups`` on a leading axis), the
same forward (with the MoE auxiliaries summed over positions and groups) and
next-token loss (plus ``moe_loss``), and the same decode path:
``init_cache`` (per pattern position, a
:class:`~repro_torch.models.layers.KVCache` or an
:class:`~repro_torch.models.ssm.SSMCache`, stacked over groups; a hybrid
pattern mixes both), ``prefill`` and ``decode_step``.  Windowed and
soft-capped attention positions run as in the reference; SSM positions (the
mamba2 family, jamba's Mamba layers) run
:func:`~repro_torch.models.ssm.ssm_apply`; MoE positions (qwen3-moe,
kimi-k2, jamba) run :func:`~repro_torch.models.moe.moe_apply`.  qwen2-vl
runs M-RoPE over ``(3, B, S)`` positions, and its stubbed vision encoder's
``patch_emb`` ``(B, Np, D)`` takes the place of the first ``Np`` token
embeddings.  The encoder-decoder family lives in ``encdec.py`` and raises
``NotImplementedError`` here.

``forward`` checkpoints each layer group by ``cfg.remat``, as the
reference's ``_maybe_remat`` wraps its scanned group: ``"none"`` keeps
every activation, ``"dots"`` keeps the outputs of the unbatched products
(``x @ W``, which fold to ``aten.mm``) and recomputes the rest, anything
else (``"full"``) keeps the group's inputs alone.  Recompute runs the same
operations on the same inputs, so gradients are unchanged.

One difference in dispatch, not in function: the reference's ``prefill``
runs its SSM positions through ``ssd_chunked``; the port's ``prefill`` runs
every SSD through ``ops.ssd_scan``, so that on the card the serving path
runs the SSD kernel and no plain version.  On the CPU ``ops.ssd_scan`` is
``ref.ssd`` = ``ssd_chunked`` at chunk ``min(chunk, S)``, exactly what the
reference's prefill computes.  ``forward`` and ``loss_fn`` take the
reference's ``use_ssm_kernel`` flag.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SS
from repro_torch.models.config import ATTN, LayerSpec, ModelConfig
from repro_torch.sharding.rules import (LA, is_dtensor, shard, split_dim,
                                        zeros)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder model runs through "
            f"repro_torch.models.encdec, not the decoder-only stack")


def _init_position(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                   device) -> Params:
    pdt = cfg.dtype("param")
    p: Params = {"ln1": L.rmsnorm_init(cfg.d_model, pdt, device)}
    if spec.kind == ATTN:
        p["attn"] = L.attention_init(gen, cfg, device)
    else:
        p["ssm"] = SS.ssm_init(gen, cfg, device)
    if spec.mlp:
        p["ln2"] = L.rmsnorm_init(cfg.d_model, pdt, device)
        if spec.moe:
            p["moe"] = M.moe_init(gen, cfg, device)
        else:
            p["mlp"] = L.mlp_init(gen, cfg, device)
    return p


def stack_groups(n: int, make_group) -> Params:
    """``n`` groups from ``make_group()``, stacked on a leading axis.  Each
    stacked leaf is allocated once and filled group by group, so the peak
    is the stack plus one group; a single group is stacked as a view."""
    blocks = None
    for g in range(n):
        group = make_group()
        if n == 1:
            return T.tree_map(lambda x: x[None], group)
        if blocks is None:
            blocks = T.tree_map(lambda x: x.new_empty((n, *x.shape)), group)
        T.tree_map(lambda dst, src: dst[g].copy_(src), blocks, group)
        del group
    return blocks


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random parameters from ``gen`` (not the reference's numbers: torch's
    generator cannot reproduce JAX's; ``repro_torch.convert`` carries the
    reference's parameters over when the two must agree).  The blocks are
    built by :func:`stack_groups`: their peak is one stacked copy plus one
    group."""
    check_supported(cfg)
    blocks = stack_groups(cfg.n_groups, lambda: {
        f"pos{i}": _init_position(gen, cfg, spec, device)
        for i, spec in enumerate(cfg.pattern)})
    return {
        "embed": L.embed_init(gen, cfg, device),
        "blocks": blocks,
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype("param"),
                                     device),
    }


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes and dtypes on the ``meta`` device,
    nothing allocated (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return init_params(torch.Generator(device="cpu"), cfg, device="meta")


# ---------------------------------------------------------------------------
# logical sharding axes of every parameter and cache leaf
# ---------------------------------------------------------------------------


def _position_axes(cfg: ModelConfig, spec: LayerSpec) -> Params:
    def g(*names):      # the stacked leading group dim
        return LA(("layers",) + names)

    p: Params = {"ln1": {"scale": g(None)}}
    if spec.kind == ATTN:
        p["attn"] = {"wq": g("fsdp", "heads"), "wk": g("fsdp", "kv_heads"),
                     "wv": g("fsdp", "kv_heads"), "wo": g("heads", "fsdp")}
    else:
        p["ssm"] = {"in_proj": g("fsdp", None), "conv_w": g(None, "conv_ch"),
                    "A_log": g(None), "dt_bias": g(None), "D_skip": g(None),
                    "gate_norm": {"scale": g(None)},
                    "out_proj": g(None, "fsdp")}
    if spec.mlp:
        p["ln2"] = {"scale": g(None)}
        if spec.moe and cfg.moe_param_shard == "ff":
            # the expert FFN's hidden dim over the data axis: the weights
            # never gather; the F-contraction reduces activations
            p["moe"] = {"router": g("fsdp", "experts"),
                        "wg": g("experts", None, "expert_ff"),
                        "wu": g("experts", None, "expert_ff"),
                        "wd": g("experts", "expert_ff", None)}
        elif spec.moe:
            p["moe"] = {"router": g("fsdp", "experts"),
                        "wg": g("experts", "fsdp", None),
                        "wu": g("experts", "fsdp", None),
                        "wd": g("experts", None, "fsdp")}
        else:
            p["mlp"] = {"wg": g("fsdp", "d_ff"), "wu": g("fsdp", "d_ff"),
                        "wd": g("d_ff", "fsdp")}
    return p


def param_logical_axes(cfg: ModelConfig) -> Params:
    """``LA`` leaves in the parameter tree's structure, the reference's."""
    embed: Params = {"tokens": LA(("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        embed["lm_head"] = LA(("fsdp", "vocab"))
    return {"embed": embed,
            "blocks": {f"pos{i}": _position_axes(cfg, spec)
                       for i, spec in enumerate(cfg.pattern)},
            "final_norm": {"scale": LA((None,))}}


def cache_logical_axes(cfg: ModelConfig, seq_len: int) -> Params:
    """``LA`` leaves of the decode cache: a full (global-attention) cache's
    sequence is ``cache_seq``, which the serving rules map onto
    ``"model"``; a ring-buffer (windowed) cache keeps its sequence whole."""
    del seq_len
    axes: Params = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == ATTN:
            seq = "cache_seq" if spec.window is None else None
            kv = LA(("layers", "batch", seq, "kv_heads", None))
            axes[f"pos{i}"] = L.KVCache(k=kv, v=kv)
        else:
            axes[f"pos{i}"] = SS.SSMCache(
                state=LA(("layers", "batch", "ssm_heads", None, None)),
                conv=LA(("layers", "batch", None, "conv_ch")))
    return axes


def _zero_aux(device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero, "router_entropy": zero}


def _ffn(p: Params, cfg: ModelConfig, spec: LayerSpec, h: torch.Tensor,
         moe_per_row: bool = False) -> Tuple[torch.Tensor, dict]:
    """The position's optional FFN (dense MLP or MoE), pre-norm residual;
    returns (h, aux), aux zeros where no MoE ran."""
    aux = _zero_aux(h.device)
    if spec.mlp:
        hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
        if spec.moe:
            out, aux = M.moe_apply(p["moe"], cfg, hn, per_row=moe_per_row)
        else:
            out = L.mlp_apply(p["mlp"], hn)
        h = h + out
    return shard(h, "batch", "seq", "d_model"), aux


def _apply_position(p: Params, cfg: ModelConfig, spec: LayerSpec,
                    h: torch.Tensor, positions: torch.Tensor,
                    cache=None, cache_pos=None,
                    use_ssm_kernel: bool = False,
                    moe_per_row: bool = False) -> Tuple[torch.Tensor, dict]:
    """One pattern position: (attention | SSM) + optional (MLP | MoE),
    pre-norm residual (a decode step when ``cache`` is given; it is updated
    in place).  SSM positions ignore positions.  Returns (h, aux)."""
    hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    if spec.kind == ATTN:
        out, _ = L.attention_apply(p["attn"], cfg, spec, hn, positions,
                                   cache=cache, cache_pos=cache_pos)
    else:
        out, new = SS.ssm_apply(p["ssm"], cfg, hn, cache=cache,
                                use_kernel=use_ssm_kernel)
        if cache is not None:
            cache.state.copy_(new.state)
            cache.conv.copy_(new.conv)
    return _ffn(p, cfg, spec, h + out, moe_per_row)


def _add_aux(total: Optional[dict], aux: dict) -> dict:
    return aux if total is None else {k: total[k] + aux[k] for k in total}


def _positions_for(cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
    """``positions`` if given, else ``0..S-1`` per row: ``(B, S)``, or
    ``(3, B, S)`` under M-RoPE.  Explicit positions under ``"pallas"``
    raise: the flash kernel masks from ``0..S-1``."""
    if positions is not None:
        if cfg.attention_impl == "pallas":
            raise NotImplementedError(
                "attention_impl 'pallas' builds its masks from positions "
                "0..S-1 and takes no explicit positions")
        return positions
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, S)
    if cfg.pos_embed == "mrope":
        pos = pos[None].expand(3, B, S)
    return pos


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           patch_emb: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, the first ``Np`` rows replaced by ``patch_emb``
    ``(B, Np, D)`` (cast to their dtype) for a model with vision
    placeholders, as the reference's ``dynamic_update_slice``: out of
    place, so the replaced rows take no gradient."""
    h = L.embed_apply(params["embed"], cfg, tokens)
    if patch_emb is not None and cfg.vision_patches:
        n = patch_emb.shape[1]
        if n > h.shape[1]:
            raise ValueError(f"patch_emb holds {n} patches, more than the "
                             f"{h.shape[1]} positions of the sequence")
        h = torch.cat([patch_emb.to(h.dtype), h[:, n:]], dim=1)
    return shard(h, "batch", "seq", "d_model")


# the PyTorch form of jax's ``dots_with_no_batch_dims_saveable``: ``x @ W``
# folds to ``mm`` (``addmm`` with a bias) and is kept; attention's and the
# experts' batched products are ``bmm`` and are recomputed with the rest
_DOTS = partial(create_selective_checkpoint_contexts,
                [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` checkpointed by ``cfg.remat`` while grad is enabled (without
    grad there is nothing to keep, and ``fn`` runs as it is).  Non-reentrant
    checkpointing: the trainer takes each pod's gradients with
    ``torch.autograd.grad``, which the reentrant form refuses."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False, context_fn=_DOTS)
    return partial(checkpoint, fn, use_reentrant=False)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            patch_emb: Optional[torch.Tensor] = None,
            use_ssm_kernel: bool = False,
            return_hidden: bool = False) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward. Returns (logits f32, aux), or with
    ``return_hidden`` (the final-normed hidden state, aux).
    ``use_ssm_kernel`` sends the SSM positions' SSD through
    ``ops.ssd_scan``, as the reference's flag does."""
    check_supported(cfg)
    positions = _positions_for(cfg, tokens, positions)
    h = _embed(params, cfg, tokens, patch_emb)

    def group(h, gp):
        group_aux = None
        for i, spec in enumerate(cfg.pattern):
            h, aux = _apply_position(gp[f"pos{i}"], cfg, spec, h, positions,
                                     use_ssm_kernel=use_ssm_kernel)
            group_aux = _add_aux(group_aux, aux)
        return h, group_aux

    run = _maybe_remat(cfg, group)
    per_group = []
    for g in range(cfg.n_groups):
        h, group_aux = run(h, _select_group(params["blocks"], g))
        per_group.append(group_aux)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    # the reference sums each group's positions in order, then the groups
    aux = {k: torch.sum(torch.stack([a[k] for a in per_group]), dim=0)
           for k in per_group[0]}
    if return_hidden:
        return h, aux
    logits = L.unembed_apply(params["embed"], cfg, h)
    return shard(logits, "batch", "seq", "vocab"), aux


def _select_group(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _select_group(v, g) for k, v in tree.items()}
    return tree[g]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Token-mean CE. logits (B,S,V) f32, labels (B,S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit is read with the vocab whole on each rank: DTensor's
    # gather along a sharded dimension leaves a masked partial sum that it
    # fails to reduce at this rank
    gold = torch.gather(shard(logits, "batch", "seq", None), -1,
                        labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict,
            use_ssm_kernel: bool = False) -> Tuple[torch.Tensor, dict]:
    """Next-token LM loss plus the MoE auxiliaries. batch: {tokens,
    labels[, mask, positions, patch_emb]}."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          patch_emb=batch.get("patch_emb"),
                          use_ssm_kernel=use_ssm_kernel)
    ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = ce + M.moe_loss(aux, cfg) if cfg.has_moe else ce
    return total, {"loss": total, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda", like: Optional[torch.Tensor] = None
               ) -> Params:
    """Cache tree: per pattern position, one ``KVCache`` (attention) or
    ``SSMCache`` (SSM) whose leaves carry a leading group axis, as the
    reference's.  When ``like`` is a DTensor (a placed prompt), each leaf
    is a DTensor on its mesh placed by :func:`cache_logical_axes` under
    the current rules, and each rank allocates only its shard."""
    check_supported(cfg)
    axes = cache_logical_axes(cfg, seq_len)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == ATTN:
            one = L.init_kv_cache(cfg, spec, batch, seq_len, device="meta")
        else:
            one = SS.init_ssm_cache(cfg, batch, device="meta")
        caches[f"pos{i}"] = type(one)(*(
            zeros((cfg.n_groups, *x.shape), names, dtype=x.dtype,
                  device=device, like=like)
            for x, names in zip(one, axes[f"pos{i}"])))
    return caches


def _group_cache(cache: Params, g: int) -> Params:
    """Group ``g``'s cache: views into the pool, so writes land in place."""
    return {key: type(c)(*(x[g] for x in c)) for key, c in cache.items()}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, cache_pos: Union[int, torch.Tensor], *,
                moe_per_row: bool = False) -> Tuple[torch.Tensor, Params]:
    """One-token decode: ``token`` ``(B, 1)``, ``cache_pos`` a scalar or a
    ``(B,)`` tensor of tokens already cached per row (the reference's
    per-slot ``vmap`` written out as a batch dimension).  ``moe_per_row``
    routes each row's token through the MoE positions alone, with the
    capacity of one token, as the reference's per-slot ``vmap`` does;
    without it the B tokens are routed together, as in the reference's
    batched ``decode_step``.  Returns (logits ``(B, 1, V)`` f32, cache);
    the cache is updated in place."""
    check_supported(cfg)
    B = token.shape[0]
    pos = torch.as_tensor(cache_pos, device=token.device).to(torch.int32)
    positions = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
    if cfg.pos_embed == "mrope":
        positions = positions[None].expand(3, B, 1)
    h = L.embed_apply(params["embed"], cfg, token)
    for g in range(cfg.n_groups):
        caches = _group_cache(cache, g)
        for i, spec in enumerate(cfg.pattern):
            gp = _select_group(params["blocks"][f"pos{i}"], g)
            h, _ = _apply_position(gp, cfg, spec, h, positions,
                                   cache=caches[f"pos{i}"], cache_pos=pos,
                                   moe_per_row=moe_per_row)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed_apply(params["embed"], cfg, h), cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int, *, positions: Optional[torch.Tensor] = None,
            patch_emb: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt ``(B, S)`` and build its decode cache of
    ``cache_len`` positions.  As in the reference, each attention position
    recomputes the prompt's K/V into the cache; a ring buffer shorter than
    the prompt keeps the tail, rolled so that slot j holds position
    p = j (mod C).  Each SSM position writes its final state and the last
    conv inputs, its SSD running through ``ops.ssd_scan`` (the kernel on
    the card).  ``positions`` and ``patch_emb`` as in :func:`forward`.
    Returns (last-token logits ``(B, V)`` f32, cache)."""
    check_supported(cfg)
    B, Sq = tokens.shape
    positions = _positions_for(cfg, tokens, positions)
    cache = init_cache(cfg, B, cache_len, device=tokens.device, like=tokens)
    cdt = cfg.dtype("compute")
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    h = _embed(params, cfg, tokens, patch_emb)
    # kernels refuse placed tensors: on a mesh the SSD runs its plain path
    use_kernel = not is_dtensor(h)
    for g in range(cfg.n_groups):
        caches = _group_cache(cache, g)
        for i, spec in enumerate(cfg.pattern):
            p = _select_group(params["blocks"][f"pos{i}"], g)
            c = caches[f"pos{i}"]
            if spec.kind != ATTN:
                h, _ = _apply_position(p, cfg, spec, h, positions, cache=c,
                                       use_ssm_kernel=use_kernel)
                continue
            hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
            out, _ = L.attention_apply(p["attn"], cfg, spec, hn, positions)
            k = split_dim(hn @ p["attn"]["wk"].to(cdt), 2, (K, Dh))
            v = split_dim(hn @ p["attn"]["wv"].to(cdt), 2, (K, Dh))
            k = L.position_embed(cfg, k, positions)
            seq_axis = "cache_seq" if spec.window is None else None
            L.fill_kv_cache(c.k, k, seq_axis)
            L.fill_kv_cache(c.v, v, seq_axis)
            h, _ = _ffn(p, cfg, spec, h + out)
    h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return L.unembed_apply(params["embed"], cfg, h)[:, 0], cache
