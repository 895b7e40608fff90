"""Device time by the program's ``ct.`` spans on a made-up, launch-linked
timeline, the span metrics' readers, and a traced CPU run that reads the
program's MoE slot counter."""
import time
from types import SimpleNamespace

import pytest

from trainbench import harness, split
from trainbench.span_trace import NONE, SpanTimeline, linked_events
from trainbench.tests.tiny import tiny_cell
from trainbench.trace import Timeline

# host events: (name, start s, end s); the main thread's spans, one span
# of autograd's thread (a recomputed MoE combine inside the backward) and
# the runtime calls that launch, keyed by their id (the CUDA correlation id
# a device operation shares with its launch)
SPANS = [("trainbench.train_step", 0.0, 0.5), ("ct.step", 0.0, 0.48),
         ("ct.step.forward", 0.0, 0.10), ("ct.moe.dispatch", 0.02, 0.04),
         ("ct.step.backward", 0.10, 0.30), ("ct.moe.combine", 0.15, 0.18),
         ("ct.step.optimizer", 0.30, 0.40),
         ("trainbench.round", 0.5, 1.0), ("ct.round", 0.5, 1.0),
         ("ct.round.pack", 0.5, 0.6), ("ct.round.apply", 0.7, 0.9),
         ("ct.round.norms", 0.8, 0.85)]
CALLS = {101: ("cudaLaunchKernel", 0.01), 102: ("cudaLaunchKernel", 0.03),
         103: ("cuLaunchKernel", 0.16), 104: ("cudaLaunchKernel", 0.35),
         105: ("cudaMemcpyAsync", 0.45), 108: ("cudaLaunchKernel", 0.49),
         106: ("cudaLaunchKernel", 0.55), 107: ("cudaLaunchKernel", 0.82)}
# device operations: (name, start, end, id); no call was recorded for the
# last two, which count at their own start
KERNELS = [("gemm", 0.05, 0.12, 101), ("scatter", 0.12, 0.13, 102),
           ("gemm_bwd", 0.16, 0.20, 103),
           # launched under the optimizer, run in the round's time
           ("add", 0.52, 0.56, 104), ("copy", 0.56, 0.57, 105),
           ("stack", 0.49, 0.50, 108), ("cat", 0.60, 0.65, 106),
           ("norm", 0.86, 0.88, 107),
           ("memset", 0.95, 0.97, 109), ("memcpy", 0.98, 0.99, 110)]


def _host():
    return SPANS + [(n, t, t + 0.001) for n, t in CALLS.values()]


def _device():
    return [(n, a, b, CALLS[i][1] if i in CALLS else a)
            for n, a, b, i in KERNELS]


def _timeline():
    return SpanTimeline(_device(), _host(), 0.0, 1.0)


def test_linked_events_take_the_launching_calls_start():
    from torch.autograd import DeviceType

    def ev(name, a, b, kind, id_, user=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=a * 1e6, end=b * 1e6),
            device_type=kind, id=id_, is_user_annotation=user)

    events = [ev(n, t, t + 0.001, DeviceType.CPU, i)
              for i, (n, t) in CALLS.items()]
    # host operators and spans count their ids apart: one that equals a
    # device operation's id is no launch
    events += [ev("aten::add_", 0.999, 0.9995, DeviceType.CPU, i)
               for i in CALLS]
    events += [ev(n, a, b, DeviceType.CUDA, i) for n, a, b, i in KERNELS]
    events.append(ev("ct.step", 0.0, 0.48, DeviceType.CUDA, 1, user=True))
    device, host = linked_events(SimpleNamespace(events=lambda: events))
    assert [d[0] for d in device] == [k[0] for k in KERNELS]
    for (name, a, b, launch), want in zip(device, _device()):
        assert (name, a, b) == want[:3]
        assert launch == pytest.approx(want[3])
    assert len(host) == 2 * len(CALLS)


def test_attribution_by_launch_not_by_run():
    st = _timeline()
    # the add ran inside the round, but was launched under the optimizer
    assert st.inclusive_s("ct.step.optimizer") == pytest.approx(0.04)
    assert st.kernel_seconds("add", 0.5, 1.0) == pytest.approx(0.04)
    # the forward's GEMM ran on into the backward's time
    assert st.inclusive_s("ct.step.forward") == pytest.approx(0.07 + 0.01)


def test_inclusive_against_innermost():
    st = _timeline()
    assert st.inclusive_s("ct.step") == pytest.approx(
        0.07 + 0.01 + 0.04 + 0.04 + 0.01)
    # autograd's thread's recompute counts in the backward, inclusively
    assert st.inclusive_s("ct.step.backward") == pytest.approx(0.04)
    assert st.inclusive_s("ct.round.apply") == pytest.approx(0.02)
    inner = st.device_by_span()
    assert inner["ct.step.forward"] == pytest.approx(0.07)
    assert inner["ct.moe.dispatch"] == pytest.approx(0.01)
    assert inner["ct.moe.combine"] == pytest.approx(0.04)
    assert "ct.step.backward" not in inner
    assert inner["ct.step"] == pytest.approx(0.01)          # its self time
    assert inner["ct.round.norms"] == pytest.approx(0.02)
    assert inner[NONE] == pytest.approx(0.01)               # the stack
    assert st.in_spans_s == pytest.approx(
        sum(b - a for _, a, b, _ in KERNELS) - 0.01)


def test_operations_without_a_link_count_at_their_start():
    st = _timeline()
    assert st.late_launches == 0
    # a launch after its operation's start is a wrong link, beyond the
    # clocks' few us of skew
    late = _device() + [("late", 0.30, 0.31, 0.45),
                        ("skew", 0.30, 0.31, 0.30001)]
    assert SpanTimeline(late, _host(), 0.0, 1.0).late_launches == 1
    assert st.device_by_span()["ct.round"] == pytest.approx(0.02 + 0.01)
    assert st.inclusive_s("ct.round") == pytest.approx(
        0.05 + 0.02 + 0.02 + 0.01)


def test_idle_by_the_innermost_ct_span():
    idle = _timeline().idle_by_span()
    assert idle["ct.moe.dispatch"] == pytest.approx(0.05)   # [0, .05]
    assert idle["ct.step.backward"] == pytest.approx(0.03)  # [.13, .16]
    assert idle["ct.step.optimizer"] == pytest.approx(0.29)  # [.20, .49]
    # [.50, .52] and [.57, .60]
    assert idle["ct.round.pack"] == pytest.approx(0.02 + 0.03)
    assert idle["ct.round.apply"] == pytest.approx(0.21)    # [.65, .86]
    assert idle["ct.round"] == pytest.approx(0.07 + 0.01 + 0.01)
    assert sum(idle.values()) == pytest.approx(1.0 - _timeline().busy_s)


def test_the_base_timeline_reads_as_before():
    st = _timeline()
    base = Timeline([d[:3] for d in _device()], _host(), 0.0, 1.0)
    assert st.busy_s == base.busy_s
    assert st.gaps() == base.gaps()
    assert st.idle_by_host() == base.idle_by_host()
    assert st.op_seconds() == base.op_seconds()
    for needle in ("gemm", "add", "m"):
        assert st.kernel_seconds(needle) == base.kernel_seconds(needle)


@pytest.mark.parametrize("name,want", [
    ("step_forward_ms", 80.0), ("step_backward_ms", 40.0),
    ("step_update_ms", 40.0), ("round_pack_ms", 50.0),
    ("round_apply_ms", 20.0), ("moe_dispatch_ms", 50.0)])
def test_span_readers(name, want):
    value, unit = harness.read_metric(name, {"span_timeline": _timeline()})
    assert unit == "ms" and value == pytest.approx(want)
    # no span timeline (the harness's context), no per-step or per-round
    # span, no span of the metric's (a program without them): no value
    assert harness.read_metric(name, {})[0] is None
    no_marks = [e for e in _host() if not e[0].startswith("trainbench.")]
    st = SpanTimeline(_device(), no_marks, 0.0, 1.0)
    assert harness.read_metric(name, {"span_timeline": st})[0] is None
    no_ct = [e for e in _host() if not e[0].startswith("ct.")]
    st = SpanTimeline(_device(), no_ct, 0.0, 1.0)
    assert harness.read_metric(name, {"span_timeline": st})[0] is None


def test_split_sums_and_self_shares():
    out = split.split(_timeline())
    assert (out["steps"], out["rounds"]) == (1, 1)
    assert out["metrics"]["step_forward_ms"] == pytest.approx(80.0)
    checks = out["checks"]
    assert checks["ct.step self share"] == pytest.approx(0.01 / 0.17)
    assert checks["ct.step parts over it"] == pytest.approx(
        (0.08 + 0.04 + 0.04) / 0.17)
    assert checks["ct.round parts over it"] == pytest.approx(
        (0.05 + 0.02) / 0.10)
    assert checks["in_spans_over_busy"] == pytest.approx(
        out["in_spans_s"] / out["busy_s"])
    assert "moe_drop_pct" not in out
    counts = {"moe.slots.kept": 90.0, "moe.slots.routed": 120.0,
              "moe.slots.rows": 150.0}
    assert split.split(_timeline(), counts)["moe_drop_pct"] == \
        pytest.approx(25.0)


def test_a_traced_cpu_run_reads_the_slot_counter():
    from repro_torch import spans

    cell = tiny_cell("qwen3moe-asgdga-int8")
    spans.reset()
    cell.metrics = ["moe_slot_fill_pct"]
    traced = harness.run(cell, 2**31 + 11, 0.0, True, time.perf_counter(),
                         device="cpu")
    fill = traced.result["metrics"]["moe_slot_fill_pct"]
    assert fill["unit"] == "%" and 0.0 < fill["value"] <= 100.0
    plain = harness.run(cell, 2**31 + 11, 0.0, False, time.perf_counter(),
                        device="cpu")
    assert set(plain.result["metrics"]) == {
        "train_tokens_per_s", "sync_round_ms_p90", "peak_device_gb",
        "setup_s"}
