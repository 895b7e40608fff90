"""Port parity: the serving control path (``GeoRouter``, the replica
autoscaler) and the serving launcher against the reference.

The recorded decision streams of ``experiments/bench/BENCH_serving.json``
(read as a fixture, never written) replay through the port's
``replay_decisions`` and ``ServingElasticityController`` exactly, as
``benchmarks/check_regression.py`` requires of the reference.  The two
launchers, given the same flags, route the same requests to the same
replicas (the model's numbers differ: torch's and JAX's generators give
different random weights from one seed).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.core.control_plane import (TRAINING_EVENT_KINDS,
                                            CloudEvent,
                                            ServingElasticityController)
from repro_torch.launch import serve as tserve
from repro_torch.serving.router import (GeoRouter, ReplicaSpec,
                                        replay_decisions)

torch.set_num_threads(2)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiments", "bench", "BENCH_serving.json")


@pytest.fixture(scope="module")
def bench():
    with open(BENCH) as f:
        return json.load(f)


def test_router_replays_recorded_decisions(bench):
    scen = bench["scenario"]
    specs = [ReplicaSpec(**r) for r in scen["replicas"]]
    replayed = replay_decisions(specs, bench["router"]["mode"],
                                bench["router"]["events"],
                                **scen["router_knobs"])
    assert len(replayed) == len(bench["router"]["decisions"]) > 0
    assert replayed == bench["router"]["decisions"]


def test_autoscaler_replays_recorded_decisions(bench):
    auto = bench["autoscaler"]
    ctrl = ServingElasticityController(**auto["knobs"])
    replayed = []
    for t, rps in auto["observations"]:
        d = ctrl.handle(CloudEvent("load_changed", time_s=t, rps=rps))
        replayed.append([t, d.old_replicas, d.new_replicas, d.reason])
    assert replayed == auto["decisions"]


REPLICAS = [ReplicaSpec(region="us-east", cost_per_unit_hour=3.0),
            ReplicaSpec(region="eu-west", units=2, cost_per_unit_hour=2.0)]


def test_router_reroutes_after_link_collapse():
    r = GeoRouter(REPLICAS, mode="balanced")
    r.observe_transfer("us-east", "eu-west", payload_mb=4.0, seconds=0.32)
    assert r.route(0, "us-east", 64, 256) == "us-east"   # idle, local
    assert r.route(1, "us-east", 64, 256) == "eu-west"   # queue spill
    r.observe_transfer("us-east", "eu-west", payload_mb=4.0, seconds=320.0)
    assert r.route(2, "us-east", 64, 256) == "us-east"   # rerouted home
    with pytest.raises(ValueError, match="rid 0"):
        r.route(0, "us-east", 16, 32)


def test_autoscaler_hysteresis_and_bus():
    class Bus:
        """The smallest bus: kind -> subscribers."""

        def __init__(self):
            self.subs = {}

        def subscribe(self, kind, fn):
            self.subs.setdefault(kind, []).append(fn)

        def publish(self, ev):
            for fn in self.subs.get(ev.kind, []):
                fn(ev)

    ctrl = ServingElasticityController(replicas=1, max_replicas=4,
                                       target_rps_per_replica=4.0,
                                       hysteresis=2)
    assert not ctrl.handle(CloudEvent("load_changed", rps=10.0)).is_noop
    assert ctrl.replicas == 3                          # immediate scale-up
    assert ctrl.handle(CloudEvent("load_changed", rps=2.0)).is_noop
    assert ctrl.handle(CloudEvent("load_changed", rps=2.0)
                       ).new_replicas == 1
    with pytest.raises(ValueError, match="rps"):
        ctrl.handle(CloudEvent("load_changed"))
    with pytest.raises(ValueError, match="kind"):
        CloudEvent("nope")
    assert "load_changed" not in TRAINING_EVENT_KINDS
    bus = Bus()
    ctrl = ServingElasticityController(replicas=1, max_replicas=2, bus=bus)
    bus.publish(CloudEvent("load_changed", rps=9.0))
    assert ctrl.replicas == 2


def _summary(text):
    return json.JSONDecoder().raw_decode(text[text.index("{"):])[0]


@pytest.mark.parametrize("flags", [
    ["--scheduler", "continuous", "--slots", "3", "--replicas", "3",
     "--router", "balanced"],
    ["--scheduler", "batch", "--batch", "2", "--replicas", "3",
     "--router", "nearest", "--autoscale"],
    ["--arch", "mamba2-1.3b", "--scheduler", "continuous", "--slots", "2",
     "--replicas", "2", "--router", "balanced"],
])
def test_launcher_routes_match_reference(flags, capsys):
    common = ["--prompt-len", "12", "--new-tokens", "4", "--requests", "7"]
    jresults = jserve.main(common + flags)
    jsum = _summary(capsys.readouterr().out)
    tresults = tserve.main(common + flags + ["--device", "cpu"])
    tsum = _summary(capsys.readouterr().out)
    assert tsum["device"] == "cpu"
    assert tsum["routes"] == jsum["routes"]
    for key in ("replicas", "autoscale", "requests", "new_tokens"):
        assert tsum[key] == jsum[key]
    assert sorted(tresults) == sorted(jresults)
    for rid, toks in tresults.items():
        assert np.asarray(toks).shape == np.asarray(jresults[rid]).shape
