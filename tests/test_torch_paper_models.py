"""Port parity: the paper's models (LeNet, ResNet, DeepFM) and the paper's
sync-strategy study (Fig 11) against ``repro.models.reference`` and
``repro.training.trainer``.

The reference's parameters are converted with
``convert.paper_params_from_numpy`` and both sides see the same numpy
batches.  Each framework runs its own f32 convolutions and matmuls, whose
sums round in another order, so logits, gradients and per-step losses are
compared with ``allclose`` at the tolerances stated here, never bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sync import SyncConfig as JSync
from repro.data.pipeline import GeoDataset as JGeo
from repro.data.pipeline import synthetic_classification as jsynth
from repro.models import reference as jref
from repro.training import trainer as jtrainer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.core.sync import SyncConfig as TSync
from repro_torch.data.pipeline import GeoDataset as TGeo
from repro_torch.data.pipeline import synthetic_classification as tsynth
from repro_torch.models import reference as tref
from repro_torch.training import trainer as ttrainer

torch.set_num_threads(2)

# f32 forwards through a few convolutions or matmuls: relative to the
# largest logit / gradient entry, a few hundred ulps
LOGIT_RTOL, GRAD_RTOL = 1e-5, 1e-5
# 16 SGD steps (with sync rounds) from the same init: per-step losses
LOSS_RTOL = 1e-4


def _inputs(name: str, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    m = jref.PAPER_MODELS[name]
    if name == "deepfm":
        x = rng.integers(0, jref.N_FEATURES, (batch, jref.N_FIELDS))
        return x.astype(np.int32), rng.integers(0, 2, batch).astype(np.int32)
    x = rng.normal(size=(batch,) + m["input_shape"]).astype(np.float32)
    return x, rng.integers(0, m["n_classes"], batch).astype(np.int32)


def _params(name: str, seed: int = 1):
    jp = jref.PAPER_MODELS[name]["init"](jax.random.key(seed))
    tp = convert.paper_params_from_numpy(jax.tree.map(np.asarray, jp), name,
                                         "cpu")
    return jp, tp


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy()
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("name,batch", [("lenet", 5), ("resnet", 3),
                                        ("deepfm", 7)])
def test_logits_and_grads_close(name, batch):
    jp, tp = _params(name)
    x, y = _inputs(name, batch)
    jm, tm = jref.PAPER_MODELS[name], tref.PAPER_MODELS[name]
    lj = jm["apply"](jp, jnp.asarray(x))
    lt = tm["apply"](tp, torch.from_numpy(x))
    assert tuple(lt.shape) == tuple(lj.shape)
    assert _rel_err(lj, lt) < LOGIT_RTOL
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch_t = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    loss_j, grads_j = jax.value_and_grad(jm["loss"])(jp, batch_j)
    tpp = T.tree_map(lambda t: t.requires_grad_(True), tp)
    loss_t = tm["loss"](tpp, batch_t)
    grads_t = torch.autograd.grad(loss_t, T.leaves(tpp))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(grads_j), grads_t):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel_err(a, b) < GRAD_RTOL
    # the embedding gathers carry their gradients
    if name == "deepfm":
        g = dict(zip((p for p, _ in T.leaves_with_path(tpp)), grads_t))
        assert float(g["['emb']"].abs().sum()) > 0
        assert float(g["['lin']"].abs().sum()) > 0


def test_resnet_stride_two_pads_like_xla_same(monkeypatch):
    """A 3x3 stride-2 conv on an even input pads (0, 1) under XLA's SAME;
    with symmetric (1, 1) padding the logits move off the reference."""
    jp, tp = _params("resnet", seed=2)
    x, _ = _inputs("resnet", 2, seed=3)
    lj = jref.resnet_apply(jp, jnp.asarray(x))
    assert _rel_err(lj, tref.resnet_apply(tp, torch.from_numpy(x))) \
        < LOGIT_RTOL
    assert tref._same_pad(32, 3, 2) == (0, 1)
    assert tref._same_pad(32, 1, 2) == (0, 0)
    assert tref._same_pad(28, 5, 1) == (2, 2)
    monkeypatch.setattr(tref, "_same_pad",
                        lambda size, k, stride: ((k - 1) // 2, (k - 1) // 2))
    assert _rel_err(lj, tref.resnet_apply(tp, torch.from_numpy(x))) > 1e-2


def test_param_mb_and_table():
    for name in ("lenet", "resnet", "deepfm"):
        jp, tp = _params(name)
        assert tref.param_mb(tp) == pytest.approx(jref.param_mb(jp))
        jm, tm = jref.PAPER_MODELS[name], tref.PAPER_MODELS[name]
        for key in ("input_shape", "n_classes", "grad_mb"):
            assert jm[key] == tm[key]
    with pytest.raises(ValueError):
        convert.paper_params_from_numpy(
            jax.tree.map(np.asarray, _params("lenet")[0]), "resnet", "cpu")


def _fig11_run(strategy: str, interval: int, steps: int = 16):
    """Paper Fig 11's LeNet run (2 pods, sgd, lr 0.05) on both sides from
    the same converted init and the same GeoDataset batches."""
    m_j, m_t = jref.PAPER_MODELS["lenet"], tref.PAPER_MODELS["lenet"]
    data = jsynth(512, m_j["input_shape"], m_j["n_classes"], seed=0)
    test = jsynth(256, m_j["input_shape"], m_j["n_classes"], seed=1)
    tdata = tsynth(512, m_t["input_shape"], m_t["n_classes"], seed=0)
    for k in data:
        np.testing.assert_array_equal(data[k], tdata[k])
    jgeo = JGeo.partition(data, ["bj", "sh"], [1, 1])
    tgeo = TGeo.partition(tdata, ["bj", "sh"], [1, 1])
    jl = [jgeo.loader("bj", 32, seed=0), jgeo.loader("sh", 32, seed=1)]
    tl = [tgeo.loader("bj", 32, seed=0), tgeo.loader("sh", 32, seed=1)]
    jbatches = [jtrainer.stack_pod_batches([next(x) for x in jl])
                for _ in range(steps)]
    tbatches = [ttrainer.stack_pod_batches([next(x) for x in tl], "cpu")
                for _ in range(steps)]
    for jb, tb in zip(jbatches, tbatches):
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())

    jtr = jtrainer.Trainer(lambda p, b: (m_j["loss"](p, b), {}), m_j["init"],
                           jtrainer.TrainerConfig(
                               n_pods=2, optimizer="sgd", lr=0.05,
                               sync=JSync(strategy, interval)))
    jstate = jtr.init_state(jax.random.key(0))
    p0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate.params)
    ttr = ttrainer.Trainer(lambda p, b: (m_t["loss"](p, b), {}), None,
                           ttrainer.TrainerConfig(
                               n_pods=2, optimizer="sgd", lr=0.05,
                               sync=TSync(strategy, interval)),
                           device="cpu")
    tp0 = convert.paper_params_from_numpy(p0, "lenet", "cpu")
    tstate = ttr.state_from_params(T.tree_map(
        lambda x: x[None].expand((2,) + tuple(x.shape)).contiguous(), tp0))
    jstate, jhist = jtr.fit(jstate, lambda s: jbatches[s], steps,
                            eval_fn=jtrainer.accuracy_eval(m_j["apply"],
                                                           test),
                            eval_every=steps)
    tstate, thist = ttr.fit(tstate, lambda s: tbatches[s], steps,
                            eval_fn=ttrainer.accuracy_eval(m_t["apply"],
                                                           test),
                            eval_every=steps)
    return jstate, jhist, tstate, thist


@pytest.mark.parametrize("strategy,interval", [
    ("asgd", 1), ("asgd_ga", 8), ("ama", 8), ("sma", 8)])
def test_fig11_lenet_run_matches_reference(strategy, interval):
    jstate, jhist, tstate, thist = _fig11_run(strategy, interval)
    assert len(thist["loss"]) == 16
    np.testing.assert_allclose(np.asarray(thist["loss_per_pod"]),
                               np.asarray(jhist["loss_per_pod"]),
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jstate.params), T.leaves(tstate.params)):
        assert _rel_err(a, b) < LOSS_RTOL
    # pod 0's accuracy on 256 held-out examples: the same params up to
    # rounding, so at most one example may flip
    (js, jacc), (ts, tacc) = jhist["eval"][-1], thist["eval"][-1]
    assert js == ts == 15 and abs(jacc - tacc) <= 1 / 256 + 1e-9
    if strategy in ("asgd", "sma"):     # sma@8 synced at step 8 and 16
        for leaf in T.leaves(tstate.params):
            assert torch.equal(leaf[0], leaf[1])
