"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's lowering, each in a process of its own (the dry run's fake
process group is global to its process; the reference's dry run sets
``XLA_FLAGS`` to 512 host devices when it is imported).

- **The sync step at (2, 2, 2)**: granite-8b's smoke config, ``InputShape(
  "dbg", 32, 8, "train")``, sgd, interval 2.  The reference's train and
  sync steps are lowered by its own ``_lower_for`` on an Auto-axis
  ``jax.sharding.Mesh`` over 8 of its host devices (``jax.make_mesh``'s
  axes are Explicit on this jax, where the reference's dry run fails) and
  parsed by its ``parse_collectives``, which files every byte of a
  ``collective-permute`` and of a transposed-iota all-reduce under
  ``cross_pod_unknown_bytes``: the port's cross-pod bytes, whose groups
  are known, are held to the reference's known plus unknown ones, exactly.
  Ring strategies ship by ``collective-permute`` and all-reduce nothing
  across pods, ``sma`` all-reduces; the train step crosses no pod on
  either side; the sync step's arguments are within 1% of the
  reference's.
- **Static fields**: ``params``, ``active_params``, ``mesh_info`` and the
  skip decisions equal the reference's for every arch, shape and mesh.
- **Extrapolation**: from one and two layer groups, the reference's rule
  gives the full-depth flops and collective bytes at 2 and 4 smoke layers.
- **The production mesh**: granite-8b ``train_4k`` on the multi-pod mesh of
  512 fake ranks at 2 layers returns ``"ok"`` in under 60 s, with the
  reference's record keys and the record under ``--out-dir``.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300                 # seconds for one subprocess
STRATEGIES = ("ama", "asgd_ga", "sma")
DEPTHS = (2, 4)
PRODUCTION_S = 60.0
ARG_RTOL = 0.01

_REFERENCE = """
import dataclasses, json
import numpy as np
from repro.launch import dryrun as D      # 512 host devices
import jax
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, get_arch
from repro.core.sync import SyncConfig
from repro.launch.mesh import make_production_mesh, mesh_info
from repro.launch.shapes import INPUT_SHAPES, InputShape, shape_supported

mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
arch = get_arch("granite-8b")
smoke = dataclasses.replace(arch, config=arch.smoke)
shape = InputShape("dbg", 32, 8, "train")
out = {"steps": {}, "static": {}}
for strategy in %(strategies)r:
    lowered, sync_lowered, _ = D._lower_for(
        smoke, shape, mesh, sync=SyncConfig(strategy, 2), optimizer="sgd",
        config_overrides=None)
    train, sync = lowered.compile(), sync_lowered.compile()
    out["steps"][strategy] = {
        "train": D.parse_collectives(train.as_text(), 2, 8),
        "sync": D.parse_collectives(sync.as_text(), 2, 8),
        "sync_memory": D._memory_analysis_dict(sync)}
for kind in ("single_pod", "multi_pod"):
    info = mesh_info(make_production_mesh(multi_pod=kind == "multi_pod"))
    for a in ARCH_IDS:
        ar = get_arch(a)
        out["static"][a + "/" + kind] = {
            "params": ar.config.param_count(),
            "active_params": ar.config.active_param_count(),
            "mesh_info": info,
            "supported": {s: list(shape_supported(ar, s))
                          for s in INPUT_SHAPES}}
print(json.dumps(out))
"""

_PORT = """
import dataclasses, json, time
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     mesh_info)
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape, shape_supported

arch = get_arch("granite-8b")
smoke = dataclasses.replace(arch, config=arch.smoke)
shape = InputShape("dbg", 32, 8, "train")
out = {"steps": {}, "extrapolated": {}, "static": {}}
with D.fake_group(8):
    mesh = make_debug_mesh(2, 2, 2, device_type="cpu")
    for strategy in %(strategies)r:
        train, sync, _ = D.lower_train(smoke, shape, mesh,
                                       sync=SyncConfig(strategy, 2),
                                       optimizer="sgd")
        out["steps"][strategy] = {"train": train, "sync": sync}
    for depth in %(depths)r:
        ov = {"n_layers": depth}
        train, _, _ = D.lower_train(smoke, shape, mesh,
                                    sync=SyncConfig("ama", 2),
                                    optimizer="sgd", config_overrides=ov)
        out["extrapolated"][str(depth)] = {
            "full": train, "extrapolated": D._extrapolate_costs(
                smoke, shape, mesh, sync=SyncConfig("ama", 2),
                optimizer="sgd", base_overrides=ov)}
t0 = time.time()
rec = D.run_one("granite-8b", "train_4k", "multi_pod",
                config_overrides={"n_layers": 2}, out_dir=%(out_dir)r)
out["production"] = {"record": rec, "wall_s": time.time() - t0}
for kind, n in (("single_pod", 256), ("multi_pod", 512)):
    with D.fake_group(n):
        info = mesh_info(make_production_mesh(
            multi_pod=kind == "multi_pod", device_type="cpu"))
    for a in ARCH_IDS:
        ar = get_arch(a)
        out["static"][a + "/" + kind] = {
            "params": ar.config.param_count(),
            "active_params": ar.config.active_param_count(),
            "mesh_info": info,
            "supported": {s: list(shape_supported(ar, s))
                          for s in INPUT_SHAPES}}
print(json.dumps(out))
"""

# the reference's record keys (``repro/launch/dryrun.py`` ``run_one``) that
# an ``"ok"`` training record holds
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_info", "tag", "params",
               "active_params", "sync", "optimizer", "config_overrides",
               "tokens", "status", "lower_s", "collectives", "memory",
               "cost", "sync_step", "extrapolated", "total_s"}


def _start(code: str, jax_side: bool) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if jax_side:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once, each in its own process."""
    out_dir = str(tmp_path_factory.mktemp("dryrun_torch"))
    ref = _start(_REFERENCE % {"strategies": STRATEGIES}, jax_side=True)
    port = _start(_PORT % {"strategies": STRATEGIES, "depths": DEPTHS,
                           "out_dir": out_dir}, jax_side=False)
    return {"reference": _result(ref), "port": _result(port),
            "out_dir": out_dir}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sync_step_cross_pod_bytes_match_reference(strategy, runs):
    ref = runs["reference"]["steps"][strategy]["sync"]
    port = runs["port"]["steps"][strategy]["sync"]["collectives"]
    want = ref["cross_pod_bytes"] + ref["cross_pod_unknown_bytes"]
    assert want > 0
    assert port["cross_pod_bytes"] == want, (port, ref)
    assert port["cross_pod_unknown_bytes"] == 0
    # every byte of the round crosses the pod axis, none moves in the pod
    assert port["total_bytes"] == port["cross_pod_bytes"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sync_step_collective_kinds(strategy, runs):
    """``tests/test_dryrun_small.py``'s assertion, on both sides."""
    for side in ("reference", "port"):
        steps = runs[side]["steps"][strategy]
        coll = steps["sync"] if side == "reference" else \
            steps["sync"]["collectives"]
        counts = coll["counts_by_kind"]
        if strategy == "sma":
            assert counts["all-reduce"] > 0, (side, counts)
        else:
            assert counts["collective-permute"] > 0, (side, counts)
            assert counts["all-reduce"] == 0, (side, counts)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_step_crosses_no_pod(strategy, runs):
    ref = runs["reference"]["steps"][strategy]
    port = runs["port"]["steps"][strategy]
    assert ref["train"]["cross_pod_bytes"] == 0
    assert port["train"]["collectives"]["cross_pod_bytes"] == 0
    assert port["train"]["collectives"]["total_bytes"] > 0
    assert port["train"]["cost"]["flops"] > 0
    want = ref["sync_memory"]["argument_size_in_bytes"]
    got = port["sync"]["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= ARG_RTOL * want, (got, want)


def test_static_fields_match_reference(runs):
    ref, port = runs["reference"]["static"], runs["port"]["static"]
    assert len(port) == len(ref) > 0
    assert port == ref


@pytest.mark.parametrize("depth", DEPTHS)
def test_extrapolation_matches_full_depth(depth, runs):
    run = runs["port"]["extrapolated"][str(depth)]
    full, ex = run["full"], run["extrapolated"]
    coll = full["collectives"]
    assert ex["n_groups"] == depth
    assert ex["flops"] == full["cost"]["flops"] > 0
    assert ex["collective_bytes"] == coll["total_bytes"] > 0
    assert ex["cross_pod_bytes"] == coll["cross_pod_bytes"]
    assert ex["bytes_by_kind"] == {k: float(v) for k, v in
                                   coll["bytes_by_kind"].items()}


def test_production_mesh_run(runs):
    prod = runs["port"]["production"]
    rec = prod["record"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert prod["wall_s"] < PRODUCTION_S
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert rec["mesh_info"] == {"n_devices": 512, "n_pods": 2, "data": 16,
                                "model": 16}
    assert rec["sync_step"]["collectives"]["cross_pod_bytes"] > 0
    assert rec["collectives"]["cross_pod_bytes"] == 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["extrapolated"]["flops"] == rec["cost"]["flops"]
    path = os.path.join(runs["out_dir"],
                        "granite-8b__train_4k__multi_pod.json")
    with open(path) as f:
        assert json.load(f)["status"] == "ok"


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serving_shapes_raise(shape, tmp_path):
    """Before any process group or record: nothing to run in a
    subprocess."""
    from repro_torch.launch import dryrun as D

    with pytest.raises(NotImplementedError, match="15b-4"):
        D.run_one("granite-8b", shape, "multi_pod", out_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
