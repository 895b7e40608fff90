"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128) expert d_ff=768 vocab=151936.
"""
from repro_torch.configs.base import dense, shrink
from repro_torch.models.config import LayerSpec, MoEConfig

CONFIG = dense(
    "qwen3-moe-30b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    pattern=[LayerSpec(moe=True)],
    moe=MoEConfig(num_experts=128, top_k=8),
    rope_theta=1_000_000.0,
)


def smoke_config():
    return shrink(CONFIG, repeats=2)
