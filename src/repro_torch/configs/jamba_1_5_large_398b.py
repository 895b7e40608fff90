"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Pattern period 8: one attention layer per 8 (position 3), the rest Mamba;
MoE FFN on every other position (Jamba's e=2 spacing), dense FFN elsewhere.
Adaptation: Mamba blocks use the Mamba2/SSD formulation (TPU-friendly dense
chunks) rather than Mamba1's selective scan.
"""
from repro_torch.configs.base import ATTN, SSM, dense, shrink
from repro_torch.models.config import LayerSpec, MoEConfig, SSMConfig

_PATTERN = [
    LayerSpec(kind=SSM, moe=False),
    LayerSpec(kind=SSM, moe=True),
    LayerSpec(kind=SSM, moe=False),
    LayerSpec(kind=ATTN, moe=True),
    LayerSpec(kind=SSM, moe=False),
    LayerSpec(kind=SSM, moe=True),
    LayerSpec(kind=SSM, moe=False),
    LayerSpec(kind=SSM, moe=True),
]

CONFIG = dense(
    "jamba-1.5-large-398b", arch_type="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=8, chunk_size=256),
)


def smoke_config():
    return shrink(CONFIG, repeats=1)
