"""Device ms a traced step launched under ``ct.step.forward``: each pod's
loss function, with the spans inside it.
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import STEP, per_ms

UNIT = "ms"
SPANS = ("ct.step.forward",)


def read(ctx):
    return per_ms(ctx, SPANS, STEP)
