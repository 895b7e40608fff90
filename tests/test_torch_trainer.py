"""Port parity: a 2-pod ASGD-GA run through the fused codec, and the
launcher entry point, against ``repro.training`` / ``repro.launch``.

Both trainers start from the same parameters (the JAX init converted with
``repro_torch.convert``) and see the same token batches.  Each framework
computes its own gradients, whose last bits differ, and the codec's 16-bit
selection key and rounding can turn a last-bit difference into another
winner or code now and then, so the run is compared with ``allclose`` at
the tolerances stated here, never bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.sync import SyncConfig as JSync
from repro.models import transformer as jtransformer
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.sync import SyncConfig as TSync
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttransformer
from repro_torch.training.trainer import Trainer as TTrainer
from repro_torch.training.trainer import TrainerConfig as TTrainerConfig

torch.set_num_threads(2)

JCFG = jget_arch("granite-8b").smoke
TCFG = tget_arch("granite-8b").smoke
N_PODS, STEPS, SEQ, PER_POD = 2, 4, 16, 2
LR = 0.05
CLIP = 5.0          # below the smoke model's first gradient norms
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-3, 1e-3
# the EF residual holds whatever the codec did not ship: where a last-bit
# gradient difference flips one winner, that element's residual differs by
# its whole value.  Allow such flips in at most FLIP_FRAC of the elements,
# and hold the residual's norm to EF_NORM_RTOL.
FLIP_FRAC, EF_NORM_RTOL = 1e-5, 1e-3


def _batches():
    streams = [TokenStream(vocab_size=JCFG.vocab_size, seq_len=SEQ,
                           batch_size=PER_POD, seed=7, shard=i,
                           n_shards=N_PODS) for i in range(N_PODS)]
    out = []
    for step in range(STEPS):
        parts = [s.batch(step) for s in streams]
        out.append({k: np.stack([p[k] for p in parts]) for k in parts[0]})
    return out


def test_codec_run_matches_reference():
    kw = dict(compress_topk=0.01, quantize_int8=True, error_feedback=True)
    jtr = JTrainer(lambda p, b: jtransformer.loss_fn(p, JCFG, b),
                   lambda k: jtransformer.init_params(k, JCFG),
                   JTrainerConfig(n_pods=N_PODS, lr=LR, clip_norm=CLIP,
                                  sync=JSync("asgd_ga", 2, **kw)))
    jstate = jtr.init_state(jax.random.key(0))
    p0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate.params)
    ttr = TTrainer(lambda p, b: ttransformer.loss_fn(p, TCFG, b), None,
                   TTrainerConfig(n_pods=N_PODS, lr=LR, clip_norm=CLIP,
                                  sync=TSync("asgd_ga", 2, **kw)),
                   device="cpu")
    tp0 = convert.params_from_jax(p0, TCFG, device="cpu")
    tstate = ttr.state_from_params(T.tree_map(
        lambda x: x[None].expand((N_PODS,) + tuple(x.shape)).contiguous(),
        tp0))
    batches = _batches()
    jstate, jhist = jtr.fit(jstate, lambda s: batches[s], STEPS)
    tstate, thist = ttr.fit(
        tstate, lambda s: {k: torch.from_numpy(v)
                           for k, v in batches[s].items()}, STEPS)
    assert len(ttr.sync_seconds) == 2            # steps 2 and 4 synced
    np.testing.assert_allclose(thist["loss_per_pod"], jhist["loss_per_pod"],
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jstate.params), T.leaves(tstate.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL)
    t_ef = tstate.sync_state.ef_residual.numpy()
    j_ef = np.asarray(jstate.sync_state.ef_residual)
    off = ~np.isclose(t_ef, j_ef, atol=PARAM_ATOL, rtol=PARAM_RTOL)
    assert off.sum() <= FLIP_FRAC * t_ef.size, off.sum()
    np.testing.assert_allclose(np.linalg.norm(t_ef, axis=1),
                               np.linalg.norm(j_ef, axis=1),
                               rtol=EF_NORM_RTOL)
    assert int(tstate.sync_state.steps_since_sync) == 0


def test_launcher_summary_matches_reference(capsys):
    """The port's launcher on the CPU: same control-plane and codec lines,
    and the summary's accounting equal to the reference's own helpers."""
    from repro.core.sync import traffic_per_step_mb
    from repro.launch.train import preset_tiny

    ts = tlaunch.main(["--preset", "tiny", "--steps", "4", "--interval",
                       "2", "--compress-topk", "0.02", "--int8",
                       "--error-feedback", "--seq", "16", "--log-every", "2",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[control-plane] ring topology: ((0, 1), (1, 0))" in out
    assert "[control-plane] batch split:   (4, 4)" in out
    assert "[train] wan codec: top-k 0.02 + int8, block 4096, ef=on" in out
    assert "(66x below dense)" in out
    assert "step     4  loss" in out
    assert ts["model"] == "dense-tiny" and ts["device"] == "cpu"
    assert (ts["pods"], ts["steps"], ts["final_tier"]) == (2, 4, 1)
    model_mb = preset_tiny().param_count() * 4 / 1e6
    jcfg = JSync("asgd_ga", 2, compress_topk=0.02, quantize_int8=True,
                 error_feedback=True)
    assert ts["wan_traffic_mb"] == sum(
        traffic_per_step_mb(jcfg, model_mb) * 2 for _ in range(4))
    assert np.isfinite(ts["loss_first"]) and np.isfinite(ts["loss_last"])


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.9}),
    ("momentum", {"beta": 0.8, "nesterov": True}),
    ("adamw", {"weight_decay": 0.01})])
def test_optimizers_match_reference(name, kw):
    """Two updates from the same params and grads; f32 elementwise math
    on both sides, compared to a few ulps (rtol 1e-6)."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt

    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape)
                          .astype(np.float32), params) for _ in range(2)]
    jo, to = jopt.get_optimizer(name, **kw), topt.get_optimizer(name, **kw)
    jp, tp = params, T.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(g, js, jp, jnp.float32(0.1))
        tp, ts = to.update(T.tree_map(torch.from_numpy, g), ts, tp, 0.1)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    g = T.tree_map(torch.from_numpy, grads[0])
    np.testing.assert_allclose(
        float(topt.global_norm(g)), float(jopt.global_norm(grads[0])),
        rtol=1e-6)
    clipped = topt.clip_by_global_norm(g, 0.5)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 0.5,
                               rtol=1e-5)


def test_token_stream_batches_are_bit_equal():
    from repro.data.pipeline import TokenStream as JStream

    for structured in (True, False):
        kw = dict(vocab_size=512, seq_len=16, batch_size=3, seed=7, shard=1,
                  n_shards=2, structured=structured)
        a, b = JStream(**kw).batch(5), TokenStream(**kw).batch(5)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_training_plan_matches_reference():
    from repro.core import control_plane as jcp
    from repro.core import scheduler as jsched
    from repro_torch.core import control_plane as tcp
    from repro_torch.core import scheduler as tsched

    def plan(cp, sched, sync):
        clouds = tuple(sched.CloudResources(
            region=f"pod{i}", devices=(("v5e", 4),), data_size=r)
            for i, r in enumerate((2.0, 1.0, 1.0)))
        return cp.build_training_plan(cp.TrainingRequest(
            model="m", clouds=clouds, sync=sync, global_batch=12))

    j = plan(jcp, jsched, JSync("asgd_ga", 4))
    t = plan(tcp, tsched, TSync("asgd_ga", 4))
    assert (t.batch_split, t.topology, t.ps_identities) == \
        (j.batch_split, j.topology, j.ps_identities)
    assert [dataclasses.asdict(p) for p in t.resource_plans] == \
        [dataclasses.asdict(p) for p in j.resource_plans]
