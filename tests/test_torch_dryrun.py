"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's lowering, each in a process of its own (the dry run's fake
process group is global to its process; the reference's dry run sets
``XLA_FLAGS`` to 512 host devices when it is imported).

The reference's steps are lowered by its own ``_lower_for`` on an
Auto-axis ``jax.sharding.Mesh`` over 8 of its host devices (``jax.
make_mesh``'s axes are Explicit on this jax, where the reference's dry run
fails) and compiled.  Its ``parse_collectives`` files a
``collective-permute`` and a transposed-iota group under
``cross_pod_unknown_bytes``; :func:`_classify` here reads each collective's
groups from the compiled HLO instead (``replica_groups`` as a list or an
iota, ``source_target_pairs``) and files it as crossing pods when one of
its groups holds devices ``< 4`` and ``>= 4``: the reference's exact
cross-pod bytes.

- **The sync step at (2, 2, 2)**: granite-8b's smoke config, ``InputShape(
  "dbg", 32, 8, "train")``, sgd, interval 2.  The port's sync-step
  cross-pod bytes equal the reference's exact ones for ``ama``, ``asgd_ga``
  and ``sma`` (1,446,912, a rank's shard) and are held to the measured gap
  for dense ``asp``, sparse ``ama`` and the codec (``CROSS_POD_GAP``,
  ROADMAP.md Queue 3).  The dense rounds move nothing in the pod, but
  ``asp``'s two 8 B all-reduces of its count.  The port's train step crosses no pod, the
  reference's only by averaging two f32 metrics over the pods; the sync
  step's arguments are within 1% of the reference's.
- **The serving steps at (2, 2, 2)**: granite-8b's and mamba2-1.3b's smoke
  configs at ``InputShape("dbg_p", 32, 8, "prefill")`` and
  ``InputShape("dbg_d", 32, 8, "decode")``, and whisper-tiny's
  encoder-decoder forward at the prefill shape: the port's step crosses
  no pod (the reference's crosses them once, gathering its embedding
  lookup's rows over the whole batch), and the port's arguments are within
  1% of the reference's.  The
  port's decode step posts no all-gather as large as one layer's local
  cache shard (the cache is written and read in place, never gathered).
  In-pod collective bytes a step, measured on a CPU (torch 2.13, jax 0.9):

  ========================  ===========  ===========
  step                      port         reference
  ========================  ===========  ===========
  granite-8b prefill            3,281,920    1,901,312
  granite-8b decode               129,184    1,456,208
  mamba2-1.3b prefill           2,183,680    2,388,992
  mamba2-1.3b decode               72,208    1,114,008
  whisper-tiny forward          5,932,928    3,244,800
  ========================  ===========  ===========

- **Static fields**: ``params``, ``active_params``, ``mesh_info``,
  ``tokens``, ``sync``, ``optimizer``, ``config_overrides`` and the skip
  decisions of ``run_one`` equal the reference's for every arch, shape and
  mesh (both sides' ``_lower_for`` replaced by one that raises, so that
  each record holds its static fields alone).
- **Extrapolation**: from one and two layer groups, the reference's rule
  gives the full-depth flops and collective bytes at 2 and 4 smoke layers.
- **The production mesh**: granite-8b ``train_4k`` and ``decode_32k`` on the
  multi-pod mesh of 512 fake ranks at 2 layers return ``"ok"`` in under
  60 s, with the reference's record keys and the records under
  ``--out-dir``; neither step crosses pods.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 420                 # seconds for one subprocess
STRATEGIES = ("ama", "asgd_ga", "sma", "asp", "sparse_ama", "codec")
SYNCS = {
    "ama": "SyncConfig('ama', 2)",
    "asgd_ga": "SyncConfig('asgd_ga', 2)",
    "sma": "SyncConfig('sma', 2)",
    "asp": "SyncConfig('asp', 2)",
    "sparse_ama": "SyncConfig('ama', 2, compress_topk=0.05)",
    "codec": "SyncConfig('asgd_ga', 2, compress_topk=0.05, "
             "quantize_int8=True, error_feedback=True)",
}
# the reference's exact cross-pod bytes less the port's, measured on a CPU
# (jax 0.9, torch 2.13), tolerance 0; ROADMAP.md Queue 3, "sync-step
# cross-pod bytes against the reference's":
# - asp: both ship the rank's 1,446,912 B; the reference all-reduces its 12
#   per-leaf int32 counts across pods (48 B), the port one f64 (8 B)
# - sparse ama: the reference's partitioner all-gathers the stacked leaves
#   over all 8 devices (11,544,576 B across pods) and permutes 522,736 B
#   across pods, the port permutes its 574,960 B of payload
# - the codec: both permute the same 218,507 B of payload across pods; the
#   reference also all-gathers the stacked leaves (11,567,104 B across pods)
CROSS_POD_GAP = {"asp": 40, "sparse_ama": 11_492_352, "codec": 11_567_104}
# the port's dense asp round: its int64 significance count all-reduced over
# "data" and over "model" before the f64 across pods
ASP_IN_POD_COUNT = 16
SERVING = (("granite-8b", "prefill"), ("granite-8b", "decode"),
           ("mamba2-1.3b", "prefill"), ("mamba2-1.3b", "decode"),
           ("whisper-tiny", "prefill"))
DEPTHS = (2, 4)
PRODUCTION_S = 60.0
ARG_RTOL = 0.01

_SYNCS = "{" + ", ".join(f"{k!r}: {v}" for k, v in SYNCS.items()) + "}"

_REFERENCE = """
import dataclasses, json, re, tempfile
import numpy as np
from repro.launch import dryrun as D      # 512 host devices
import jax
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, get_arch
from repro.core.sync import SyncConfig
from repro.launch.shapes import INPUT_SHAPES, InputShape

_IOTA = re.compile(r"replica_groups=\\[([0-9,]+)\\]<=\\[([0-9,]+)\\]"
                   r"(?:T\\(([0-9,]+)\\))?")
_LIST = re.compile(r"(?:replica_groups|source_target_pairs)="
                   r"\\{((?:\\{[0-9,]*\\},?)*)\\}")
_OP = re.compile(r"%%?[\\w.\\-]+\\s*=\\s*(\\([^)]*\\)|[a-z0-9]+\\[[0-9,]*\\][^ ]*)"
                 r"\\s+([a-z\\-]+)")


def _groups(line):
    m = _IOTA.search(line)
    if m:
        shape = [int(x) for x in m.group(1).split(",")]
        dims = [int(x) for x in m.group(2).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(3):
            ids = ids.transpose([int(x) for x in m.group(3).split(",")])
        return ids.reshape(shape).tolist()
    m = _LIST.search(line)
    if m:
        return [[int(x) for x in g.split(",") if x]
                for g in re.findall(r"\\{([0-9,]*)\\}", m.group(1))]
    return None


def _classify(hlo, per_pod=4):
    out = {"cross": {}, "in_pod": {}}
    for line in hlo.splitlines():
        m = _OP.match(line.strip())
        if not m:
            continue
        op = m.group(2)
        if op.endswith("-done"):
            continue
        kind = op[:-6] if op.endswith("-start") else op
        if kind not in D._COLLECTIVES:
            continue
        n = D._shape_bytes(m.group(1))
        groups = _groups(line) or [list(range(8))]
        cross = any(min(g) < per_pod <= max(g) for g in groups if g)
        side = out["cross" if cross else "in_pod"]
        side[kind] = side.get(kind, 0) + n
    return out


mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
out = {"steps": {}, "serving": {}, "static": {}}
granite = get_arch("granite-8b")
smoke = dataclasses.replace(granite, config=granite.smoke)
shape = InputShape("dbg", 32, 8, "train")
for name, sync in %(syncs)s.items():
    lowered, sync_lowered, _ = D._lower_for(
        smoke, shape, mesh, sync=sync, optimizer="sgd",
        config_overrides=None)
    train, sync = lowered.compile(), sync_lowered.compile()
    out["steps"][name] = {
        "train": _classify(train.as_text()),
        "sync": _classify(sync.as_text()),
        "sync_kinds": D.parse_collectives(sync.as_text(), 2, 8),
        "sync_memory": D._memory_analysis_dict(sync)}
for arch_name, kind in %(serving)r:
    ar = get_arch(arch_name)
    ar = dataclasses.replace(ar, config=ar.smoke)
    lowered, _, _ = D._lower_for(ar, InputShape("dbg_" + kind[0], 32, 8, kind),
                                 mesh, sync=SyncConfig(), optimizer="sgd",
                                 config_overrides=None)
    step = lowered.compile()
    out["serving"][arch_name + "/" + kind] = {
        "collectives": _classify(step.as_text()),
        "memory": D._memory_analysis_dict(step)}


def _static(*a, **k):
    raise RuntimeError("static fields only")


D._lower_for = _static
with tempfile.TemporaryDirectory() as tmp:
    for kind in ("single_pod", "multi_pod"):
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                rec = D.run_one(a, s, kind, out_dir=tmp, extrapolate=False)
                out["static"]["/".join((a, s, kind))] = rec
print(json.dumps(out))
"""

_PORT = """
import dataclasses, json, tempfile, time
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.shapes import INPUT_SHAPES, InputShape
from repro_torch.sharding.rules import mesh_sizes

largest = {}
_count = D._Tracer._count


def _counting(self, func, args, kwargs, operands, out):
    ns, _, name = str(func.overloadpacket).partition(".")
    if ns in D._COLLECTIVE_NAMESPACES and name in D._KINDS:
        kind = D._KINDS[name]
        n = sum(D._nbytes(t) for t in D._tensors(out))
        largest[kind] = max(largest.get(kind, 0), n)
    return _count(self, func, args, kwargs, operands, out)


D._Tracer._count = _counting


def _layer_cache_bytes(setup, shape):
    # one layer's local shard of the decode cache (every leaf of group 0)
    cache = setup.fns.init_cache(setup.cfg, shape.global_batch,
                                 shape.seq_len, device="meta")
    sizes = mesh_sizes(setup.mesh)
    total = 0
    for x, sh in zip(D.T.leaves(cache), D.T.leaves(setup.cache_sharding(
            cache, shape.seq_len))):
        n = x[0].numel() * x.element_size()
        for entry in sh.spec:
            for ax in (() if entry is None else (entry,)
                       if isinstance(entry, str) else entry):
                n //= sizes[ax]
        total += n
    return total


granite = get_arch("granite-8b")
smoke = dataclasses.replace(granite, config=granite.smoke)
shape = InputShape("dbg", 32, 8, "train")
out = {"steps": {}, "serving": {}, "extrapolated": {}, "static": {},
       "production": {}}
with D.fake_group(8):
    mesh = make_debug_mesh(2, 2, 2, device_type="cpu")
    for name, sync in %(syncs)s.items():
        train, sync, _ = D.lower_train(smoke, shape, mesh, sync=sync,
                                       optimizer="sgd")
        out["steps"][name] = {"train": train, "sync": sync}
    for arch_name, kind in %(serving)r:
        ar = get_arch(arch_name)
        ar = dataclasses.replace(ar, config=ar.smoke)
        sh = InputShape("dbg_" + kind[0], 32, 8, kind)
        largest.clear()
        step, _, setup = D._lower_for(ar, sh, mesh, sync=SyncConfig(),
                                      optimizer="sgd", config_overrides=None)
        out["serving"][arch_name + "/" + kind] = {
            "step": step, "largest": dict(largest),
            "layer_cache": (_layer_cache_bytes(setup, sh)
                            if kind == "decode" else None)}
    for depth in %(depths)r:
        ov = {"n_layers": depth}
        train, _, _ = D.lower_train(smoke, shape, mesh,
                                    sync=SyncConfig("ama", 2),
                                    optimizer="sgd", config_overrides=ov)
        out["extrapolated"][str(depth)] = {
            "full": train, "extrapolated": D._extrapolate_costs(
                smoke, shape, mesh, sync=SyncConfig("ama", 2),
                optimizer="sgd", base_overrides=ov)}
for shape_name in ("train_4k", "decode_32k"):
    t0 = time.time()
    rec = D.run_one("granite-8b", shape_name, "multi_pod",
                    config_overrides={"n_layers": 2}, out_dir=%(out_dir)r)
    out["production"][shape_name] = {"record": rec,
                                     "wall_s": time.time() - t0}


def _static(*a, **k):
    raise RuntimeError("static fields only")


D._lower_for = _static
with tempfile.TemporaryDirectory() as tmp:
    for kind in ("single_pod", "multi_pod"):
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                rec = D.run_one(a, s, kind, out_dir=tmp, extrapolate=False)
                out["static"]["/".join((a, s, kind))] = rec
print(json.dumps(out))
"""

# the reference's record keys (``repro/launch/dryrun.py`` ``run_one``) that
# an ``"ok"`` record holds; a training record adds ``sync_step``
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_info", "tag", "params",
               "active_params", "sync", "optimizer", "config_overrides",
               "tokens", "status", "lower_s", "collectives", "memory",
               "cost", "extrapolated", "total_s"}
STATIC_KEYS = ("arch", "shape", "mesh", "mesh_info", "tag", "params",
               "active_params", "sync", "optimizer", "config_overrides",
               "tokens", "status", "skip_reason")


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
    args = {"syncs": _SYNCS, "serving": SERVING, "depths": DEPTHS,
            "out_dir": out_dir}
    ref = _start(_REFERENCE % args, jax_side=True)
    port = _start(_PORT % args, jax_side=False)
    return {"reference": _result(ref), "port": _result(port),
            "out_dir": out_dir}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sync_step_cross_pod_bytes_match_reference(strategy, runs):
    ref = runs["reference"]["steps"][strategy]["sync"]["cross"]
    port = runs["port"]["steps"][strategy]["sync"]["collectives"]
    want = sum(ref.values())
    assert want > 0
    assert port["cross_pod_unknown_bytes"] == 0
    assert want - port["cross_pod_bytes"] == CROSS_POD_GAP.get(strategy, 0), \
        (port, ref)
    if strategy in ("ama", "asgd_ga", "sma", "asp"):
        # a rank ships its own shard: 1,446,912 B of granite's smoke
        # parameters, a quarter of a pod's row
        kind = "all-reduce" if strategy == "sma" else "collective-permute"
        assert ref[kind] == port["bytes_by_kind"][kind] == 1_446_912
        # nothing moves in the pod, but asp's significance count: one f64
        # all-reduced over "data" and one over "model" (16 B)
        in_pod = port["total_bytes"] - port["cross_pod_bytes"]
        assert in_pod == (ASP_IN_POD_COUNT if strategy == "asp" else 0), port
    if strategy == "codec":
        # the codec's payload crosses pods byte for byte as the reference's
        assert port["bytes_by_kind"]["collective-permute"] == \
            ref["collective-permute"] == port["cross_pod_bytes"]


@pytest.mark.parametrize("strategy", ("ama", "asgd_ga", "sma", "asp"))
def test_sync_step_collective_kinds(strategy, runs):
    """``tests/test_dryrun_small.py``'s assertion, on both sides; ``asp``
    also all-reduces its significance count."""
    for side in ("reference", "port"):
        steps = runs[side]["steps"][strategy]
        coll = steps["sync_kinds"] if side == "reference" else \
            steps["sync"]["collectives"]
        counts = coll["counts_by_kind"]
        if strategy == "sma":
            assert counts["all-reduce"] > 0, (side, counts)
        else:
            assert counts["collective-permute"] > 0, (side, counts)
            assert (counts["all-reduce"] > 0) == (strategy == "asp"), \
                (side, counts)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_step_crosses_no_pod(strategy, runs):
    ref = runs["reference"]["steps"][strategy]
    port = runs["port"]["steps"][strategy]
    # the reference's step averages two f32 metrics over the pods (an
    # all-reduce of 8 B across them); the port's step crosses nothing, and
    # ``Trainer.train_step`` gathers the per-pod metrics after it
    assert ref["train"]["cross"] == {"all-reduce": 8}
    assert port["train"]["collectives"]["cross_pod_bytes"] == 0
    assert port["train"]["collectives"]["total_bytes"] > 0
    assert port["train"]["cost"]["flops"] > 0
    want = ref["sync_memory"]["argument_size_in_bytes"]
    got = port["sync"]["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= ARG_RTOL * want, (got, want)


@pytest.mark.parametrize("case", ["/".join(c) for c in SERVING])
def test_serving_step_crosses_no_pod(case, runs):
    ref = runs["reference"]["serving"][case]
    port = runs["port"]["serving"][case]["step"]
    # the reference's partitioner gathers its embedding lookup's rows over
    # the whole batch, the pods' included (8 rows x S tokens x 128 f32 of
    # the smoke width's 256, one all-gather); the port's lookup stays in
    # the pod (``layers._sharded_lookup``)
    rows = 8 * (32 if case.endswith("prefill") else 1) * 128 * 4
    assert ref["collectives"]["cross"] == {"all-gather": rows}
    assert sum(ref["collectives"]["in_pod"].values()) > 0
    coll = port["collectives"]
    assert coll["cross_pod_bytes"] == coll["cross_pod_unknown_bytes"] == 0
    assert coll["total_bytes"] > 0 and port["cost"]["flops"] > 0
    want = ref["memory"]["argument_size_in_bytes"]
    got = port["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= ARG_RTOL * want, (got, want)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b"])
def test_decode_gathers_no_cache_shard(arch, runs):
    run = runs["port"]["serving"][arch + "/decode"]
    layer = run["layer_cache"]
    assert layer > 0
    assert run["largest"].get("all-gather", 0) < layer, run
    # the step writes the cache in place: its bytes alias the arguments
    mem = run["step"]["memory"]
    assert mem["alias_size_in_bytes"] >= layer


@pytest.mark.parametrize("mesh", ["single_pod", "multi_pod"])
def test_static_fields_match_reference(mesh, runs):
    ref, port = runs["reference"]["static"], runs["port"]["static"]
    keys = [k for k in ref if k.endswith("/" + mesh)]
    assert len(keys) == 40 and set(port) == set(ref)
    for k in keys:
        want = {f: ref[k].get(f) for f in STATIC_KEYS}
        got = {f: port[k].get(f) for f in STATIC_KEYS}
        if want["status"] == "error":
            # both sides' lowering replaced by one that raises
            assert got["status"] == "error", k
        assert got == want, k


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


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_production_mesh_run(shape, runs):
    prod = runs["port"]["production"][shape]
    rec = prod["record"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert prod["wall_s"] < PRODUCTION_S
    keys = RECORD_KEYS | ({"sync_step"} if shape == "train_4k" else set())
    assert keys <= set(rec), keys - set(rec)
    assert ("sync_step" in rec) == (shape == "train_4k")
    assert rec["mesh_info"] == {"n_devices": 512, "n_pods": 2, "data": 16,
                                "model": 16}
    assert rec["tokens"] == (256 * 4096 if shape == "train_4k" else 128)
    if shape == "train_4k":
        assert rec["sync_step"]["collectives"]["cross_pod_bytes"] > 0
    assert rec["collectives"]["cross_pod_bytes"] == 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["extrapolated"]["flops"] == rec["cost"]["flops"]
    path = os.path.join(runs["out_dir"],
                        f"granite-8b__{shape}__multi_pod.json")
    with open(path) as f:
        assert json.load(f)["status"] == "ok"
