"""The least time of a round's codec launches (``counts.codec_round_bytes``
at the HBM peak) over their device time a traced round (``encode_kernel``
and ``decode_kernel``)."""

UNIT = "%"


def read(ctx):
    tl, c = ctx["timeline"], ctx["counts"]
    rounds = [e for e in tl.host if e[0] == "trainbench.round"]
    spent = sum(tl.kernel_seconds(k) for k in ("encode_kernel",
                                                "decode_kernel"))
    if not rounds or spent <= 0:
        return None
    least = c.codec_round_bytes(ctx["spec"], ctx["mix"]) / c.PEAK_HBM_BYTES
    return 100.0 * least * len(rounds) / spent
