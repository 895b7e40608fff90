"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import SSM, dense, shrink
from repro_torch.models.config import LayerSpec, SSMConfig

CONFIG = dense(
    "mamba2-1.3b", arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    pattern=[LayerSpec(kind=SSM, mlp=False)],
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, chunk_size=256),
    pos_embed="none", tie_embeddings=True,
)


def smoke_config():
    return shrink(CONFIG, repeats=2, d_ff=0)
