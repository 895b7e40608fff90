"""Median host-clock time of the window's ``Trainer.train_step`` calls,
each bounded by ``torch.cuda.synchronize()`` (the traced run times them)."""
import statistics

UNIT = "ms"


def read(ctx):
    steps = ctx["steps_s"]
    return statistics.median(steps) * 1e3 if steps else None
