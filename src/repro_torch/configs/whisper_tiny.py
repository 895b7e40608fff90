"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865, encoder
context 1500 frames.  The mel+conv frontend is a stub: ``input_specs``
provides precomputed frame embeddings (B, 1500, 384).
"""
from repro_torch.configs.base import dense, shrink

CONFIG = dense(
    "whisper-tiny", arch_type="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865,
    encoder_layers=4, encoder_ctx=1500,
)


def smoke_config():
    return shrink(CONFIG, repeats=2, n_heads=2, n_kv_heads=2)
