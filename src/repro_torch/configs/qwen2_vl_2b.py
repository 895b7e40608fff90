"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The ViT vision
encoder + projector are a stub: the caller gives patch embeddings
(B, vision_patches, D), written over the leading placeholder positions,
and may give (3, B, S) t/h/w position ids for M-RoPE (``0..S-1`` on all
three by default).
"""
from repro_torch.configs.base import dense, shrink

CONFIG = dense(
    "qwen2-vl-2b", arch_type="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    pos_embed="mrope", mrope_sections=(16, 24, 24),
    vision_patches=256,
)


def smoke_config():
    return shrink(CONFIG, repeats=2, head_dim=64, n_heads=4, n_kv_heads=2,
                  mrope_sections=(8, 12, 12))
