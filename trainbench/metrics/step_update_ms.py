"""Device ms a traced step launched under its state passes:
``ct.step.grads`` (the pod stack and clip), ``ct.step.accumulate`` (the
GA add), ``ct.step.optimizer`` (the update and copy back) and
``ct.step.metrics`` (the loss and gradient-norm stacks).
Read from a launch-linked timeline (``trainbench.span_trace``) in
``ctx["span_timeline"]``; None without one."""
from trainbench.span_trace import STEP, per_ms

UNIT = "ms"
SPANS = ("ct.step.grads", "ct.step.accumulate", "ct.step.optimizer",
         "ct.step.metrics")


def read(ctx):
    return per_ms(ctx, SPANS, STEP)
