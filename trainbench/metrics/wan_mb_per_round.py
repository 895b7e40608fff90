"""MB one round puts on the WAN over all pods: the trainer's per-pod wire
MB (``Trainer.wire_mb``, summed over buckets) times the ring's transfers a
round."""

UNIT = "MB"


def read(ctx):
    return sum(ctx["wire_mb"].values()) * ctx["transfers"]
