"""Device ms a traced round launched under ``ct.round.apply``: the EF
rollover, the bucket norms (``ct.round.norms``) and the receiver update.
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import ROUND, per_ms

UNIT = "ms"
SPANS = ("ct.round.apply",)


def read(ctx):
    return per_ms(ctx, SPANS, ROUND)
