"""gemma2-27b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16, head_dim=128) d_ff=36864 vocab=256000.
Pattern period 2: sliding-window (4096) then global; attention softcap 50,
final logit softcap 30.
"""
from repro_torch.configs.base import dense, shrink
from repro_torch.models.config import LayerSpec

_PATTERN = [LayerSpec(window=4096), LayerSpec()]

CONFIG = dense(
    "gemma2-27b", arch_type="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    pattern=_PATTERN, tie_embeddings=True,
    attn_softcap=50.0, final_softcap=30.0,
)


def smoke_config():
    return shrink(CONFIG, repeats=1)
