"""Model configuration system (copy of ``repro/models/config.py``).

A model is described by a :class:`ModelConfig` holding global dimensions plus a
repeating *layer pattern* (a list of :class:`LayerSpec`).  ``n_layers`` must be a
multiple of the pattern period; the decoder stack is executed as a
loop over ``n_layers // period`` *groups*, each group applying the
pattern positions in order with its own parameters (stacked on a leading
group axis, as in the reference, so parameter trees convert leaf for leaf).
The port runs every family the reference does.

The pattern mechanism expresses every assigned architecture:

- dense llama-style        -> period 1:  [attn+mlp]
- gemma2 local:global 1:1  -> period 2:  [attn(window)+mlp, attn+mlp]
- gemma3 local:global 5:1  -> period 6:  [attn(window)]*5 + [attn]
- qwen3-moe / kimi-k2      -> period 1:  [attn+moe]
- jamba 1:7 attn:mamba     -> period 8:  mamba*3, attn, mamba*4 with MoE on odd
- mamba2                   -> period 1:  [ssm+(no mlp)]
- whisper / qwen2-vl       -> dense patterns + modality stubs (see encdec.py /
                              transformer.py input handling)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

ATTN = "attn"
SSM = "ssm"

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating layer pattern."""

    kind: str = ATTN                 # "attn" | "ssm"
    window: Optional[int] = None     # sliding-window size (None = global attention)
    moe: bool = False                # MoE FFN instead of dense FFN
    mlp: bool = True                 # whether the position has an FFN at all

    def __post_init__(self):
        if self.kind not in (ATTN, SSM):
            raise ValueError(f"unknown layer kind: {self.kind!r}")


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance auxiliary loss weight
    router_z_weight: float = 1e-3     # router-z loss weight


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128      # N, the SSM state size
    head_dim: int = 64        # P, channels per SSM head
    n_groups: int = 1         # B/C groups (Mamba2 "G")
    conv_width: int = 4       # causal depthwise conv width
    chunk_size: int = 256     # SSD chunk length
    expand: int = 2           # d_inner = expand * d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // n_heads
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # position encoding: "rope" | "mrope" | "learned" | "none"
    pos_embed: str = "rope"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # qwen2-vl M-RoPE split of head_dim/2

    # gemma-style logit soft-capping (0 = disabled)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0

    # encoder-decoder (whisper): number of encoder layers, encoder context length
    encoder_layers: int = 0
    encoder_ctx: int = 0              # e.g. 1500 audio frames
    # vlm stub: number of vision patch embeddings prepended to the text sequence
    vision_patches: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # dtypes (string so the config is hashable / serializable)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention implementation: "xla" (jnp reference), "xla_chunked"
    # (flash-style blockwise in pure XLA), "pallas", "pallas_interpret"
    attention_impl: str = "xla"
    # embedding lookup: "gather" | "onehot" (vocab-sharded-friendly matmul)
    embed_impl: str = "gather"
    # MoE dispatch: "global" (one sort over the whole token set) |
    # "grouped" (sort/scatter local to each batch row; only the expert
    # einsum's all-to-all crosses shards)
    moe_dispatch: str = "global"
    # expert-weight sharding: "fsdp" (gather weights over data axis) | "ff"
    # (shard the expert FFN hidden dim over data; activations reduce instead
    # of weights gathering — wins when weights >> activations per step)
    moe_param_shard: str = "fsdp"
    # remat policy for each layer group of the training forward: "none" |
    # "full" (keep the group's inputs) | "dots" (also keep x @ W products);
    # the port checkpoints with torch.utils.checkpoint (transformer.py)
    remat: str = "full"
    # scan over layer groups (compact HLO) vs python-unrolled groups (exact
    # cost_analysis — XLA-CPU counts while bodies once, so the dry-run
    # extrapolates totals from small unrolled variants)
    scan_layers: bool = True
    # vocab padding multiple (sharding-friendly)
    vocab_multiple: int = 2048

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.period}"
            )
        return self.n_layers // self.period

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def dtype(self, which: str) -> torch.dtype:
        name = {"param": self.param_dtype, "compute": self.compute_dtype}[which]
        return TORCH_DTYPES[name]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def max_window(self) -> Optional[int]:
        """Largest sliding window in the pattern, None if any position is global attn."""
        w = 0
        for spec in self.pattern:
            if spec.kind == ATTN:
                if spec.window is None:
                    return None
                w = max(w, spec.window)
        return w or None

    @property
    def has_attention(self) -> bool:
        return any(s.kind == ATTN for s in self.pattern)

    @property
    def has_ssm(self) -> bool:
        return any(s.kind == SSM for s in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(s.moe for s in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if the arch can serve unbounded context with bounded-or-linear
        attention state: SSM positions carry O(1) state; hybrids qualify
        because only a small minority of layers keep a (sequence-sharded) KV
        cache; local:global dense patterns qualify because local layers keep
        a bounded ring cache.  Pure global-attention stacks do not."""
        if not self.has_attention:
            return True
        if self.has_ssm:
            return True   # hybrid: attention is a small minority of layers
        n_global = sum(1 for s in self.pattern if s.kind == ATTN and s.window is None)
        if n_global == 0:
            return True
        # mostly-local dense patterns (gemma2/gemma3)
        return len(self.pattern) > 1 and n_global < len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; used for 6ND roofline)."""
        D, V = self.d_model, self.padded_vocab
        Dh, H, K = self.resolved_head_dim, self.n_heads, self.n_kv_heads
        total = V * D                                  # token embedding
        if not self.tie_embeddings:
            total += D * V                             # lm head
        total += D                                     # final norm
        per_pattern = 0
        for spec in self.pattern:
            per_pattern += D                           # pre-norm
            if spec.kind == ATTN:
                per_pattern += D * H * Dh + 2 * D * K * Dh + H * Dh * D
            else:
                c = self.ssm
                d_in = self.d_inner
                n_h = self.ssm_heads
                # in_proj: z, x, B, C, dt
                zxbcdt = 2 * d_in + 2 * c.n_groups * c.state_dim + n_h
                per_pattern += D * zxbcdt
                per_pattern += c.conv_width * (d_in + 2 * c.n_groups * c.state_dim)
                per_pattern += 3 * n_h                 # A_log, dt_bias, D skip
                per_pattern += d_in                    # gated norm
                per_pattern += d_in * D                # out_proj
            if spec.mlp:
                per_pattern += D                       # post/mlp norm
                if spec.moe:
                    e = self.moe.num_experts
                    per_pattern += D * e               # router
                    per_pattern += e * 3 * D * self.d_ff
                else:
                    per_pattern += 3 * D * self.d_ff
        total += per_pattern * self.n_groups
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if not self.has_moe:
            return self.param_count()
        D = self.d_model
        total = self.param_count()
        for spec in self.pattern:
            if spec.moe:
                e, k = self.moe.num_experts, self.moe.top_k
                inactive = (e - k) * 3 * D * self.d_ff
                total -= inactive * self.n_groups
        return total
