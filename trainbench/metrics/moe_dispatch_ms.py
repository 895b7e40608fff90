"""Device ms a traced step launched under ``ct.moe.route``,
``ct.moe.dispatch`` and ``ct.moe.combine``: the MoE layers' work around
their expert products, in the forward and its recompute.
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import STEP, per_ms

UNIT = "ms"
SPANS = ("ct.moe.route", "ct.moe.dispatch", "ct.moe.combine")


def read(ctx):
    return per_ms(ctx, SPANS, STEP)
