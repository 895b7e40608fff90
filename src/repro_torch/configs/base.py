"""Helpers shared by architecture configs (copy of ``repro/configs/base.py``).

Every assigned architecture file exports:
  CONFIG          — the exact full-scale configuration from the assignment
  smoke_config()  — reduced same-family variant (<=2 pattern repeats,
                    d_model<=512, <=4 experts) for CPU smoke tests
"""
from __future__ import annotations

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig

ATTN = "attn"
SSM = "ssm"


def dense(name: str, *, n_layers: int, d_model: int, n_heads: int,
          n_kv_heads: int, d_ff: int, vocab: int, head_dim=None,
          pattern=None, **kw) -> ModelConfig:
    return ModelConfig(
        name=name, arch_type=kw.pop("arch_type", "dense"),
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv_heads, d_ff=d_ff, vocab_size=vocab,
        head_dim=head_dim,
        pattern=tuple(pattern) if pattern else (LayerSpec(),), **kw)


def shrink(cfg: ModelConfig, *, d_model: int = 256, n_heads: int = 4,
           n_kv_heads: int = 2, d_ff: int = 512, vocab: int = 512,
           repeats: int = 1, experts: int = 4, top_k: int = 2,
           head_dim: int = 64, **kw) -> ModelConfig:
    """Reduced same-family variant: keeps the layer pattern (so local/global,
    MoE and SSM positions are all exercised) but tiny dims."""
    moe = cfg.moe
    if cfg.has_moe:
        moe = MoEConfig(num_experts=experts, top_k=min(top_k, experts),
                        capacity_factor=cfg.moe.capacity_factor)
    ssm = SSMConfig(state_dim=32, head_dim=16, n_groups=1, conv_width=4,
                    chunk_size=32, expand=2) if cfg.has_ssm else cfg.ssm
    # shrink windows so smoke seqs exercise the ring-buffer path
    pattern = tuple(
        LayerSpec(kind=s.kind,
                  window=(16 if s.window is not None else None),
                  moe=s.moe, mlp=s.mlp)
        for s in cfg.pattern)
    return cfg.replace(
        name=cfg.name + "-smoke",
        n_layers=cfg.period * repeats, d_model=d_model,
        n_heads=n_heads, n_kv_heads=min(n_kv_heads, n_heads),
        d_ff=d_ff, vocab_size=vocab, head_dim=head_dim,
        pattern=pattern, moe=moe, ssm=ssm,
        encoder_layers=(2 if cfg.encoder_layers else 0),
        encoder_ctx=(24 if cfg.encoder_ctx else 0),
        vision_patches=(8 if cfg.vision_patches else 0),
        vocab_multiple=64,
        param_dtype="float32", compute_dtype="float32",
        remat="none", **kw)
