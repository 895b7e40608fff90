"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import dense, shrink

CONFIG = dense(
    "granite-8b", arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, rope_theta=10_000_000.0,
)


def smoke_config():
    return shrink(CONFIG, repeats=2)
