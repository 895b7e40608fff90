"""Port parity: the train launcher's control loop (``--adaptive-sync``,
``--wan-trace``, ``--events``, ``--bucket-policy layer-class``) against
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


@pytest.mark.parametrize("flag", ["--transport", "--faults", "--topology",
                                  "--ckpt-dir", "--async-checkpoint",
                                  "--stream-retune", "--serve"])
def test_unported_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as err:
        ttrain.main(["--preset", "tiny", flag, "x", "--device", "cpu"])
    assert err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


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
