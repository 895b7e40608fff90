"""Where a traced run's device time goes, by the program's ``ct.`` spans.

    python3 trainbench/split.py --workload <cell> --seed <n> --seconds <s> \
        [--out <file>]

From the root of a checkout, on the card.  Runs the cell as ``run.py
--trace 1`` does (the same harness call: the same window, traced stretch
and comparison), keeps the traced stretch's profiler and prints one JSON
object: the run's result, the span metrics read from a launch-linked
timeline (:mod:`trainbench.span_trace`), device ms by span a step or a
round, device and idle seconds by innermost span, and the split's checks:
the share of ``ct.step`` and ``ct.round`` launched under none of their
child spans, and the children's sums over their parents; and, in an MoE
cell, the share of routed (token, choice) pairs that capacity dropped
(``moe.slots``).  The counters, and so ``moe_slot_fill_pct`` here, count
the traced stretch alone (``run.py``'s also count the profiled warm-up
interval).  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPAN_METRICS = ("step_forward_ms", "step_backward_ms", "step_update_ms",
                "round_pack_ms", "round_apply_ms", "moe_dispatch_ms",
                "moe_slot_fill_pct")
STEP_PARTS = ("ct.step.forward", "ct.step.backward", "ct.step.grads",
              "ct.step.accumulate", "ct.step.optimizer", "ct.step.metrics")
ROUND_PARTS = ("ct.round.pack", "ct.round.encode", "ct.round.ship",
               "ct.round.decode", "ct.round.apply")


def split(st, counts=None) -> dict:
    """The span split of a :class:`span_trace.SpanTimeline`, with the drop
    rate of the counters ``counts`` (``repro_torch.spans.read()``)."""
    from trainbench import harness
    from trainbench.span_trace import NONE, ROUND, STEP
    from trainbench.trace import top

    steps, rounds = st.count(STEP), st.count(ROUND)
    incl = {n: st.inclusive_s(n) for n in sorted({s[0] for s in st.spans})}
    inner = st.device_by_span()
    out = {
        "metrics": {m: harness.read_metric(m, {"span_timeline": st})[0]
                    for m in SPAN_METRICS},
        "steps": steps, "rounds": rounds,
        "ms_per": {n: 1e3 * s / (rounds if n.startswith("ct.round")
                                 else steps) for n, s in incl.items()},
        "device_by_span": top(inner, 40),
        "idle_by_span": top(st.idle_by_span(), 40),
        "busy_s": st.busy_s, "window_s": st.window_s,
        "in_spans_s": st.in_spans_s, "no_span_s": inner.get(NONE, 0.0),
    }
    checks = {"in_spans_over_busy": st.in_spans_s / st.busy_s,
              "launched after their start": st.late_launches}
    for parent, parts in (("ct.step", STEP_PARTS), ("ct.round", ROUND_PARTS)):
        if incl.get(parent):
            checks[f"{parent} self share"] = inner.get(parent, 0.0) \
                / incl[parent]
            checks[f"{parent} parts over it"] = sum(
                incl.get(p, 0.0) for p in parts) / incl[parent]
    out["checks"] = checks
    if counts and counts.get("moe.slots.routed"):
        out["moe_drop_pct"] = 100.0 * (
            1.0 - counts["moe.slots.kept"] / counts["moe.slots.routed"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("split: no CUDA device", file=sys.stderr)
        return 2
    from trainbench import harness
    from trainbench.run import process_start
    from trainbench.span_trace import SpanTimeline, linked_events
    from repro_torch import spans

    t_start = process_start()
    # the harness's profiler sessions, the last one the traced stretch's;
    # the counters restart with each, so they count the traced stretch
    sessions = []
    profiler = harness._profiler

    def keep(device):
        spans.reset()
        sessions.append(profiler(device))
        return sessions[-1]

    harness._profiler = keep
    out = harness.run(harness.load_cell(args.workload), args.seed,
                      args.seconds, True, t_start)
    device, host = linked_events(sessions[-1])
    marks = [e for e in host if e[0].startswith("trainbench.")]
    st = SpanTimeline(device, host, min(a for _, a, _ in marks),
                      max(b for _, _, b in marks))
    result = dict(out.result, workload=args.workload, seed=args.seed,
                  torch=torch.__version__, split=split(st, spans.read()))
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
