"""Dense decoder-only transformer, a loop over layer groups.

Counterpart of the dense path of ``repro/models/transformer.py``: the same
parameter tree (repeated-block leaves stacked over ``cfg.n_groups`` on a
leading axis), the same forward and the same next-token loss.  Other
``arch_type`` values (MoE, SSM, hybrid, audio, vision) are ROADMAP Queue 1
item 13 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.has_moe or cfg.has_ssm \
            or cfg.vision_patches or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet; "
            f"the port runs the dense family (see ROADMAP.md Queue 1 item "
            f"13 for MoE, SSM and encoder-decoder models)")


def _init_position(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                   device) -> Params:
    pdt = cfg.dtype("param")
    p: Params = {"ln1": L.rmsnorm_init(cfg.d_model, pdt, device),
                 "attn": L.attention_init(gen, cfg, device)}
    if spec.mlp:
        p["ln2"] = L.rmsnorm_init(cfg.d_model, pdt, device)
        p["mlp"] = L.mlp_init(gen, cfg, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random parameters from ``gen`` (not the reference's numbers: torch's
    generator cannot reproduce JAX's; ``repro_torch.convert`` carries the
    reference's parameters over when the two must agree)."""
    check_supported(cfg)
    groups = [{f"pos{i}": _init_position(gen, cfg, spec, device)
               for i, spec in enumerate(cfg.pattern)}
              for _ in range(cfg.n_groups)]
    blocks = T.tree_map(lambda *xs: torch.stack(xs), groups[0], *groups[1:])
    return {
        "embed": L.embed_init(gen, cfg, device),
        "blocks": blocks,
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype("param"),
                                     device),
    }


def _apply_position(p: Params, cfg: ModelConfig, spec: LayerSpec,
                    h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One pattern position: attention + optional MLP, pre-norm residual."""
    hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    h = h + L.attention_apply(p["attn"], cfg, spec, hn, positions)
    if spec.mlp:
        hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
        h = h + L.mlp_apply(p["mlp"], hn)
    return h


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward. Returns (logits f32, aux)."""
    check_supported(cfg)
    if positions is None:
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    h = L.embed_apply(params["embed"], cfg, tokens)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.pattern):
            gp = _select_group(params["blocks"][f"pos{i}"], g)
            h = _apply_position(gp, cfg, spec, h, positions)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed_apply(params["embed"], cfg, h)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, {"lb_loss": zero, "z_loss": zero, "router_entropy": zero}


def _select_group(tree: Any, g: int) -> Any:
    if isinstance(tree, dict):
        return {k: _select_group(v, g) for k, v in tree.items()}
    return tree[g]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Token-mean CE. logits (B,S,V) f32, labels (B,S) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params: Params, cfg: ModelConfig, batch: dict
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token LM loss. batch: {tokens, labels[, mask, positions]}."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"))
    ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce, {"loss": ce, "ce": ce, **aux}
