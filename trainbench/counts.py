"""Operation and byte counts the per-layer metrics divide by, worked out
from a cell's configuration and mix alone, and the chip's published peaks.

- :func:`step_flops`: the model FLOPs of one training step of all pods:
  6 per matrix parameter a token uses (forward and backward; for a mixture
  of experts, the router and the ``top_k`` routed experts only; the output
  head over the published vocabulary, not its padding; the embedding
  lookup none), plus the causal attention's scores and values, 4 * heads *
  head_dim * (S (S + 1) / 2) a sequence forward and twice that backward.
  Recomputation and expert-capacity padding are not counted.
- :func:`codec_round_bytes`: the bytes one codec round's encode and decode
  launches need: the encode reads each pod's float32 message once and
  writes its codes (1 B), indices (4 B) and block scales (4 B); each of the
  two decodes a bucket (the sender's own, for the residual, and the
  peer's) reads them and writes the dense float32 message.
"""
from __future__ import annotations

from trainbench.reference.codec import k_per_block
from trainbench.reference.model import Spec
from trainbench.reference.train import packing

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def matmul_params_per_token(spec: Spec) -> int:
    """Matrix parameters one token's forward multiplies by."""
    D, H, K, Dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    attn = D * H * Dh * 2 + D * K * Dh * 2
    if spec.moe:
        ffn = D * spec.num_experts + spec.top_k * 3 * D * spec.d_ff
    else:
        ffn = 3 * D * spec.d_ff
    return spec.n_layers * (attn + ffn) + D * spec.vocab


def step_flops(spec: Spec, mix: dict) -> float:
    """Model FLOPs of one step of every pod (``global_batch`` rows of
    ``seq`` tokens in all)."""
    rows, S = int(mix["global_batch"]), int(mix["seq"])
    dense = 6.0 * matmul_params_per_token(spec) * rows * S
    attn_fwd = 4.0 * spec.n_heads * spec.head_dim * S * (S + 1) / 2
    return dense + 3.0 * attn_fwd * rows * spec.n_layers


def codec_round_bytes(spec: Spec, mix: dict) -> float:
    s, pods = mix["sync"], int(mix["pods"])
    total = 0.0
    for _, leaves in packing(spec, s):
        n = sum(size for _, size in leaves)
        block = min(int(s["codec_block"]), n)
        nb = -(-n // block)
        kb = k_per_block(block, float(s["compress_topk"]))
        wire = nb * kb * (1 + 4) + nb * 4
        dense = 4.0 * n
        total += (dense + wire) + 2 * (wire + dense)
    return pods * total

