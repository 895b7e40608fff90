"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import dense, shrink

CONFIG = dense(
    "minitron-8b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab=256000,
)


def smoke_config():
    return shrink(CONFIG, repeats=2)
