"""Port parity: the train launcher's control loop (``--adaptive-sync``,
``--wan-trace``, ``--events``, ``--bucket-policy layer-class``, the
streaming and topology flags ``--stream-retune``, ``--topology``, the
snapshot engine's ``--async-checkpoint``, ``--snapshot-every``,
``--keep-snapshots`` and the ``--serve`` smoke) against
``repro.launch.train`` on the same flags.

Both launchers start from the same parameters (the reference's
``init_params`` at key 0, converted with ``repro_torch.convert``) and read
the same token batches.  The controllers' decisions come from each
framework's own gradients, whose EF norms agree to their last bits, so the
decision stream (every ``[autotune]`` retune and ``[elasticity]`` event and
reconfig line) must be the reference's, line for line; the losses agree
within ``LOSS_RTOL`` and the summary's accounting exactly.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models.registry import get_model_fns
from repro_torch import convert
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)

# f32 on both sides over 20 steps, 4 pod re-stackings and 6 retunes
LOSS_RTOL = 1e-5
EF_RATIO_ATOL = 1e-3

FLAGS = ["--preset", "tiny", "--pods", "2", "--steps", "20", "--batch", "4",
         "--seq", "16", "--interval", "2", "--compress-topk", "0.05",
         "--int8", "--error-feedback", "--adaptive-sync",
         "--bucket-policy", "layer-class",
         "--wan-trace", "100@0,0.5@3,100@10", "--ef-guard", "0.98",
         "--events",
         "straggler:pod0x2.0@2,cloud_left:pod1@10,cloud_joined:pod1@13",
         "--log-every", "0"]


def _control_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("[autotune]", "[elasticity]",
                                "[control-plane]"))]


def test_control_loop_decisions_equal_the_reference_launcher():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(FLAGS)
    jlines = _control_lines(buf.getvalue())
    jparams = get_model_fns("transformer").init_params(
        jax.random.key(0), jtrain.preset_tiny())
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      ttrain.preset_tiny(), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(FLAGS + ["--device", "cpu"], init_params=tparams)
    tlines = _control_lines(buf.getvalue())

    assert tlines == jlines
    # the run exercised what it is meant to: retunes down to an int4 rung,
    # a straggler re-plan and pod1 leaving and rejoining
    assert any("int4@" in line for line in tlines
               if line.startswith("[autotune] step"))
    assert [line.split(": ")[1] for line in tlines
            if "reconfig applied" in line] == \
        ["2 pods, sync interval 2", "2 pods, sync interval 64",
         "1 pods, sync interval 2", "2 pods, sync interval 2"]
    for key in ("reconfigs", "retunes", "final_pods", "final_interval",
                "final_tier", "final_compress_topk", "final_value_dtype",
                "final_buckets", "wan_traffic_mb"):
        assert ts[key] == js[key], key
    assert (ts["reconfigs"], ts["retunes"], ts["final_pods"]) == (4, 6, 2)
    assert ts["max_ef_ratio"] == pytest.approx(js["max_ef_ratio"],
                                               abs=EF_RATIO_ATOL)
    for name, r in js["max_ef_ratio_by_bucket"].items():
        assert ts["max_ef_ratio_by_bucket"][name] == pytest.approx(
            r, abs=EF_RATIO_ATOL)
    assert ts["loss_first"] == pytest.approx(js["loss_first"],
                                             rel=LOSS_RTOL)
    assert ts["loss_last"] == pytest.approx(js["loss_last"], rel=LOSS_RTOL)
    # the port's own record of the run: a round per sync at the knobs it
    # ran, each applied reconfig with its pod count
    assert [n for _, n, _ in ts["reconfigs_at"]] == [2, 2, 1, 2]
    assert len(ts["decisions"]) == ts["retunes"]
    assert any("int4" in knobs for _, knobs, _ in ts["rounds"])


def _both(flags):
    """Run both launchers on ``flags`` from the same parameters; returns
    (reference summary, its lines, port summary, its lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(flags)
    jlines = buf.getvalue().splitlines()
    jparams = get_model_fns("transformer").init_params(
        jax.random.key(0), jtrain.preset_tiny())
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      ttrain.preset_tiny(), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(flags + ["--device", "cpu"], init_params=tparams)
    return js, jlines, ts, buf.getvalue().splitlines()


STREAM_FLAGS = ["--preset", "tiny", "--pods", "2", "--steps", "12",
                "--batch", "4", "--seq", "16", "--interval", "2",
                "--compress-topk", "0.05", "--int8", "--error-feedback",
                "--overlap-chunks", "2", "--bucket-policy", "layer-class",
                "--wan-trace", "100@0,0.5@5", "--log-every", "0"]
SUMMARY_KEYS = ("stream_retune", "stream_retunes", "stream_rounds",
                "stream_decisions", "topology", "final_topology",
                "topology_switches", "topology_reroutes",
                "wan_transfers_per_round", "transfers",
                "measured_bandwidth_mbps", "wan_traffic_mb", "retunes",
                "final_tier")


def test_stream_retune_launcher_equals_the_reference():
    """``--stream-retune`` over a clean sim link that collapses 200x
    inside round 3: the ``[stream]`` line, one mid-round retune and the
    streaming summary keys are the reference launcher's."""
    js, jlines, ts, tlines = _both(STREAM_FLAGS + [
        "--transport", "sim:fluct=0,latency=0", "--stream-retune",
        "--stream-cliff", "3.0", "--stream-hysteresis", "1"])
    pick = ("[stream]", "[transport]", "[autotune]")
    assert [line for line in tlines if line.startswith(pick)] == \
        [line for line in jlines if line.startswith(pick)]
    for key in SUMMARY_KEYS:
        assert ts[key] == js[key], key
    assert ts["stream_retunes"] == 1 and ts["stream_rounds"] == 6
    assert ts["loss_last"] == pytest.approx(js["loss_last"], rel=LOSS_RTOL)


@pytest.mark.parametrize("topology", ["tree", "auto"])
def test_topology_launcher_equals_the_reference(topology):
    """``--topology tree`` (a fixed hierarchy) and ``auto`` (the planner
    as the controller's third actuator, with streaming rounds on top):
    the ``[topology]``, ``[autotune]`` and ``[stream]`` lines and the
    topology summary keys are the reference launcher's."""
    extra = ["--pods", "3", "--batch", "6", "--topology", topology]
    if topology == "auto":
        extra += ["--adaptive-sync", "--stream-retune"]
    js, jlines, ts, tlines = _both(STREAM_FLAGS + extra)
    pick = ("[topology]", "[transport]", "[autotune]", "[stream]")
    assert [line for line in tlines if line.startswith(pick)] == \
        [line for line in jlines if line.startswith(pick)]
    assert any(line.startswith("[topology]") for line in tlines)
    for key in SUMMARY_KEYS:
        assert ts[key] == js[key], key
    assert ts["wan_transfers_per_round"] == (4 if topology == "tree" else 3)
    assert ts["loss_last"] == pytest.approx(js["loss_last"], rel=LOSS_RTOL)


REFUSALS = {
    "topology-with-transport": ["--topology", "tree", "--wan-trace",
                                "100@0", "--transport", "sim"],
    "topology-needs-trace": ["--topology", "tree"],
    "auto-needs-adaptive": ["--topology", "auto", "--wan-trace", "100@0",
                            "--compress-topk", "0.05", "--int8",
                            "--error-feedback"],
    "stream-needs-codec": ["--stream-retune", "--wan-trace", "100@0",
                           "--transport", "sim", "--compress-topk", "0.05",
                           "--int8"],
    "stream-needs-streaming-transport": ["--stream-retune",
                                         "--compress-topk", "0.05",
                                         "--int8", "--error-feedback"],
    "cliff-needs-stream": ["--stream-cliff", "2.0"],
    "hysteresis-needs-stream": ["--stream-hysteresis", "2"],
    "snapshot-every-needs-async": ["--snapshot-every", "3"],
    "keep-snapshots-needs-async": ["--keep-snapshots", "3"],
    "keep-snapshots-at-least-one": ["--async-checkpoint",
                                    "--keep-snapshots", "0"],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_stream_and_topology_refusals_equal_the_reference(case):
    """Each refusal of the streaming, topology and snapshot flags exits
    with the reference launcher's message."""
    flags = ["--preset", "tiny", "--steps", "1", "--log-every", "0"] + \
        REFUSALS[case]
    with pytest.raises(SystemExit) as jerr, \
            contextlib.redirect_stdout(io.StringIO()):
        jtrain.main(flags)
    with pytest.raises(SystemExit) as terr, \
            contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(flags + ["--device", "cpu"])
    assert isinstance(jerr.value.code, str)
    assert terr.value.code == jerr.value.code


SNAPSHOT_FLAGS = ["--preset", "tiny", "--pods", "2", "--steps", "8",
                  "--batch", "4", "--seq", "16", "--interval", "2",
                  "--compress-topk", "0.05", "--int8", "--error-feedback",
                  "--async-checkpoint", "--log-every", "0"]
SNAPSHOT_CASES = {
    # pod1 leaves at step 2: staged from the step-2 snapshot, reconciled
    # at the step-4 barrier, then re-anchored at 1 pod
    "migration": ["--events", "cloud_left:pod1@2"],
    # a rollback-mode crash at the step-4 round: restored from the last
    # durable snapshot, then pod1 removed at the next barrier
    "rollback": ["--wan-trace", "100@0", "--transport", "sim",
                 "--faults", "crash:pod1@3:rollback"],
    # the cadence between barriers and a deeper retention
    "cadence": ["--events", "cloud_left:pod1@4", "--snapshot-every", "3",
                "--keep-snapshots", "3"],
}
SNAPSHOT_KEYS = ("async_checkpoint", "snapshots", "last_durable_step",
                 "migrations", "staged_mb", "rollbacks", "reconfigs",
                 "final_pods", "crash_recoveries", "degraded_rounds")


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
def test_async_checkpoint_launcher_equals_the_reference(case):
    """``--async-checkpoint`` (replacing the check that argparse refused
    the snapshot flags and ``--serve``, which the port now has): the
    ``[elasticity]``, ``[faults]`` and engine lines and the snapshot
    summary keys are the reference launcher's; losses within
    ``LOSS_RTOL``."""
    js, jlines, ts, tlines = _both(SNAPSHOT_FLAGS + SNAPSHOT_CASES[case])
    pick = ("[elasticity]", "[faults]", "[ckpt] async engine:")
    assert [line for line in tlines if line.startswith(pick)] == \
        [line for line in jlines if line.startswith(pick)]
    for key in SNAPSHOT_KEYS:
        assert ts[key] == js[key], key
    assert ts["snapshots"] >= 3 and ts["last_durable_step"] is not None
    if case == "rollback":
        assert ts["rollbacks"] == 1 and ts["migrations"] == 1
    else:
        assert ts["migrations"] == 1 and ts["staged_mb"] > 0
    assert ts["loss_first"] == pytest.approx(js["loss_first"],
                                             rel=LOSS_RTOL)
    assert ts["loss_last"] == pytest.approx(js["loss_last"], rel=LOSS_RTOL)


def test_serve_smoke_equals_the_reference():
    """``--serve``: the 4-slot continuous-batching smoke on pod 0's final
    parameters; the ``serve`` block and its line are the reference's."""
    js, jlines, ts, tlines = _both(
        ["--preset", "tiny", "--pods", "2", "--steps", "4", "--batch", "4",
         "--seq", "16", "--interval", "2", "--log-every", "0", "--serve"])
    assert ts["serve"] == js["serve"] == {"requests": 6, "new_tokens": 48,
                                          "decode_steps": 15}
    assert [line for line in tlines if line.startswith("[serve]")] == \
        [line for line in jlines if line.startswith("[serve]")]
    assert js["async_checkpoint"] is ts["async_checkpoint"] is False
    assert ts["snapshots"] is ts["migrations"] is None


def test_adaptive_sync_needs_the_codec_with_error_feedback():
    with pytest.raises(SystemExit, match="--adaptive-sync requires"):
        ttrain.main(["--preset", "tiny", "--adaptive-sync", "--steps", "1",
                     "--compress-topk", "0.05", "--int8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--bucket-patterns is inert"):
        ttrain.main(["--preset", "tiny", "--bucket-patterns", "moe-router",
                     "--device", "cpu"])


def test_parsers_equal_the_reference():
    spec = "cloud_left:pod1@40,bandwidth:25@60,straggler:pod0x2.0@80," \
           "cloud_joined:pod7@100"
    tev, jev = ttrain.parse_events(spec), jtrain.parse_events(spec)
    assert sorted(tev) == sorted(jev)
    for step in tev:
        for a, b in zip(tev[step], jev[step]):
            assert (a.kind, a.region, a.time_s, a.bandwidth_mbps,
                    a.slowdown) == (b.kind, b.region, b.time_s,
                                    b.bandwidth_mbps, b.slowdown)
    for spec in ("100@0,25@60,80@120",
                 "random:seed=3,base=100,sigma=0.6,period=20"):
        t = ttrain.parse_wan_trace(spec, 200, 0.5)
        j = jtrain.parse_wan_trace(spec, 200, 0.5)
        assert (t.times_s, t.mbps) == (j.times_s, j.mbps)
    assert ttrain.parse_wan_trace("", 10, 0.5) is None
    over = "embed:topk=0.02:dtype=int4:block=1024,norm:dtype=int8"
    assert [vars(o) for o in ttrain.parse_bucket_overrides(over)] == \
        [vars(o) for o in jtrain.parse_bucket_overrides(over)]
    with pytest.raises(ValueError, match="unknown override key"):
        ttrain.parse_bucket_overrides("embed:size=3")
    with pytest.raises(ValueError, match="unknown event kind"):
        ttrain.parse_events("meteor:pod1@3")
