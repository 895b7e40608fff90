"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt scaled per assignment].

48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.
Pattern period 6: 5 sliding-window (1024) layers then 1 global layer.
"""
from repro_torch.configs.base import dense, shrink
from repro_torch.models.config import LayerSpec

_PATTERN = [LayerSpec(window=1024)] * 5 + [LayerSpec()]

CONFIG = dense(
    "gemma3-12b", arch_type="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern=_PATTERN, tie_embeddings=True,
    rope_theta=1_000_000.0,
)


def smoke_config():
    return shrink(CONFIG, repeats=1)
