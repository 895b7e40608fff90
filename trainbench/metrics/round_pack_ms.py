"""Device ms a traced round launched under ``ct.round.pack``: the pack of
the GA buffer, its divide and the EF add before the encode.
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import ROUND, per_ms

UNIT = "ms"
SPANS = ("ct.round.pack",)


def read(ctx):
    return per_ms(ctx, SPANS, ROUND)
