"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8, head_dim=128) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8.  Adaptation: the K2 model card uses MLA; the
assignment specifies GQA kv=8, which is what we implement.
"""
from repro_torch.configs.base import dense, shrink
from repro_torch.models.config import LayerSpec, MoEConfig

CONFIG = dense(
    "kimi-k2-1t-a32b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840,
    pattern=[LayerSpec(moe=True)],
    moe=MoEConfig(num_experts=384, top_k=8, capacity_factor=1.0),
    rope_theta=1_000_000.0,
)


def smoke_config():
    return shrink(CONFIG, repeats=2)
