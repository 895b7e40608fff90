"""Device ms a traced step launched under ``ct.step.backward``: each pod's
``torch.autograd.grad``, its recomputed forward included.
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import STEP, per_ms

UNIT = "ms"
SPANS = ("ct.step.backward",)


def read(ctx):
    return per_ms(ctx, SPANS, STEP)
