"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and never imports it (or JAX).  What is ported so far is
the paper's training plane on the dense decoder: control-plane plan, token
data, the per-pod train step and the every-``interval``-steps ASGD-GA sync
round through the fused WAN codec, whose encode and decode run as
hand-written CUDA kernels (``repro_torch.kernels.csrc.wan_codec``).

Entry points default to ``device="cuda"``; the CPU is used only when the
caller passes ``device="cpu"`` (the parity tests do).
"""
