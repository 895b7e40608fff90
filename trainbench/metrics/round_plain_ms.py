"""Median over the traced rounds of the round's wall time less the device
time of its codec (``encode_kernel``, ``decode_kernel``) and top-k
(``topk_kernel``) launches: the round's plain passes."""
import statistics

UNIT = "ms"
KERNELS = ("encode_kernel", "decode_kernel", "topk_kernel")


def read(ctx):
    tl = ctx["timeline"]
    plain = [(b - a) - sum(tl.kernel_seconds(k, a, b) for k in KERNELS)
             for name, a, b in tl.host if name == "trainbench.round"]
    return statistics.median(plain) * 1e3 if plain else None
