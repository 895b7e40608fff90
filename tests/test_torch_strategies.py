"""Port parity: the sync strategies (``asgd``, dense and sparse ``asgd_ga``,
``ama``, ``sma``, ``asp``), the ring ship and the pod-count and retune
transforms against ``repro.core.sync`` / ``repro.training.trainer``.

Both sides start from the same stacked parameters and ``SyncState``
(converted with ``repro_torch.convert``).  A round is then deterministic
arithmetic on the same arrays: ``_ship_ring`` (dense and sparse), ``ama``,
``asp`` and sparse ``asgd_ga`` at 2 pods must give the same params,
``ga_buffer`` and ``significant_frac`` bit for bit.  Means over the pod
dimension (``sma``, ``hierarchical_average``, the grow/shrink transforms)
are reductions whose order may differ between the frameworks: they are held
to ``MEAN_RTOL``, a few f32 ulps.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync as jsync
from repro.training import trainer as jtrainer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.core import sync as tsync
from repro_torch.kernels import ref as tref
from repro_torch.training import trainer as ttrainer

torch.set_num_threads(2)

# the granite smoke config's leaf paths and ranks at a quarter of its widths
SHAPES = {
    "blocks": {"pos0": {"attn": {"wk": (2, 64, 32), "wo": (2, 64, 64),
                                 "wq": (2, 64, 64), "wv": (2, 64, 32)},
                        "ln1": {"scale": (2, 64)},
                        "ln2": {"scale": (2, 64)},
                        "mlp": {"wd": (2, 128, 64), "wg": (2, 64, 128),
                                "wu": (2, 64, 128)}}},
    "embed": {"lm_head": (64, 128), "tokens": (128, 64)},
    "final_norm": {"scale": (64,)},
}
# a mean over pods is a reduction in each framework's own order: relative
# 1e-6 is a few f32 ulps; the absolute MEAN_ATOL is a few ulps of the
# operands (|x| < 8), for results that are differences of two means
MEAN_RTOL, MEAN_ATOL = 1e-6, 2e-6


@functools.lru_cache(maxsize=None)
def _jax_params(n_pods: int, dtype: str = "float32", seed: int = 1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda shape: jnp.asarray(rng.normal(size=(n_pods,) + shape)
                                  .astype(np.float32)).astype(dtype),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _to_port(tree):
    return T.tree_map(lambda a: convert.to_tensor(a, "cpu"),
                      jax.tree.map(np.asarray, tree))


def _state_to_port(state):
    return convert.sync_state_from_jax(jax.tree.map(np.asarray, state), "cpu")


def _port_cfg(jcfg):
    return tsync.SyncConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)
                               if f.name != "bucket_spec"})


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _tensor_bits(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return _bits(t)


def _tree_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), T.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a), _tensor_bits(b))


def _tree_close(jtree, ttree, rtol=MEAN_RTOL):
    for a, b in zip(jax.tree.leaves(jtree), T.leaves(ttree)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=rtol, atol=MEAN_ATOL)


def _round(jcfg, n_pods, dtype="float32", lr=0.05, steps=3):
    """One ``apply_sync`` on both sides from the same state; returns
    ``(jax params, jax state, port params, port state)``."""
    params = _jax_params(n_pods, dtype)
    state = jsync.init_sync_state(jcfg, params)
    rng = np.random.default_rng(2)
    if jcfg.strategy == "asgd_ga":
        state = state._replace(ga_buffer=jax.tree.map(
            lambda b: jnp.asarray(rng.normal(size=b.shape)
                                  .astype(np.float32)), state.ga_buffer))
    if jcfg.strategy == "asp":
        # params moved since the reference was taken: a mix of significant
        # and insignificant deltas
        params = jax.tree.map(
            lambda p: (p.astype(jnp.float32) * (1 + 0.02 * jnp.asarray(
                rng.normal(size=p.shape).astype(np.float32)))).astype(
                    p.dtype), params)
    state = state._replace(steps_since_sync=jnp.int32(steps))
    tparams, tstate = _to_port(params), _state_to_port(state)
    jp, js = jsync.apply_sync(jcfg, params, state, lr)
    tp, ts = tsync.apply_sync(_port_cfg(jcfg), tparams, tstate, lr)
    return jp, js, tp, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk", [0.0, 0.01, 0.3])
@pytest.mark.parametrize("n_pods", [2, 3])
def test_ship_ring_bit_equal(n_pods, topk, dtype):
    jcfg = jsync.SyncConfig("ama", 2, compress_topk=topk)
    params = _jax_params(n_pods, dtype)
    jout = jsync._ship_ring(jcfg, params)
    tout = tsync._ship_ring(_port_cfg(jcfg), _to_port(params))
    _tree_equal(jout, tout)


def test_sparse_ship_cuts_leaves_into_chunks(monkeypatch):
    """A leaf above ``CHUNK`` values ships as its zero-padded chunks, each
    compressed on its own (the reference's chunk is 2**26 values, beyond a
    CPU test; the port's is patched down here)."""
    monkeypatch.setattr(tsync, "CHUNK", 1000)
    cfg = tsync.SyncConfig("ama", 2, compress_topk=0.05)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 7, 350)).astype(np.float32))
    got = tsync._ship_ring(cfg, {"w": x})["w"]
    flat = torch.nn.functional.pad(x.reshape(2, -1), (0, 3 * 1000 - 2450))
    want = torch.zeros(2, 3000)
    for p in range(2):
        for c in range(3):
            v, i = tref.topk_block(flat[p, c * 1000:(c + 1) * 1000], 50)
            want[(p + 1) % 2, c * 1000:(c + 1) * 1000] = \
                tref.topk_decompress(v, i, 1000)
    np.testing.assert_array_equal(got.reshape(2, -1).numpy(),
                                  want[:, :2450].numpy())


@pytest.mark.parametrize("strategy,topk,dtype", [
    ("asgd_ga", 0.0, "float32"), ("asgd_ga", 0.01, "float32"),
    ("asgd_ga", 0.2, "bfloat16"),
    ("ama", 0.0, "bfloat16"), ("ama", 0.01, "float32"),
    ("ama", 0.01, "bfloat16"),
    ("asp", 0.0, "float32"), ("asp", 0.01, "float32"),
    ("asp", 0.1, "bfloat16")])
def test_apply_sync_bit_equal_at_two_pods(strategy, topk, dtype):
    jcfg = jsync.SyncConfig(strategy, 2, compress_topk=topk)
    jp, js, tp, ts = _round(jcfg, 2, dtype)
    _tree_equal(jp, tp)
    _tree_equal(js.ga_buffer, ts.ga_buffer)
    np.testing.assert_array_equal(_bits(js.significant_frac),
                                  _tensor_bits(ts.significant_frac))
    assert int(ts.steps_since_sync) == int(js.steps_since_sync) == 0
    np.testing.assert_array_equal(np.asarray(js.tier), ts.tier.numpy())
    if strategy == "asp":
        assert 0.0 < float(ts.significant_frac) < 1.0


@pytest.mark.parametrize("strategy", ["ama", "asp", "asgd_ga"])
def test_sparse_apply_sync_bit_equal_at_three_pods(strategy):
    jcfg = jsync.SyncConfig(strategy, 2, compress_topk=0.05)
    jp, js, tp, ts = _round(jcfg, 3)
    _tree_equal(jp, tp)
    _tree_equal(js.ga_buffer, ts.ga_buffer)


def test_sparse_ama_halves_what_was_not_shipped():
    """The reference's semantics, kept: each pod averages with a peer tree
    that is mostly zeros, so unshipped entries are halved."""
    jcfg = jsync.SyncConfig("ama", 2, compress_topk=0.01)
    jp, _, tp, _ = _round(jcfg, 2)
    p0 = _to_port(_jax_params(2))
    w0, w1 = p0["blocks"]["pos0"]["mlp"]["wd"], tp["blocks"]["pos0"]["mlp"][
        "wd"]
    halved = (w1 == w0 * 0.5).float().mean()
    assert float(halved) > 0.95


@pytest.mark.parametrize("n_pods", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sma_close_to_reference(n_pods, dtype):
    jcfg = jsync.SyncConfig("sma", 4)
    jp, js, tp, ts = _round(jcfg, n_pods, dtype)
    rtol = MEAN_RTOL if dtype == "float32" else 2 ** -8   # one bf16 ulp
    _tree_close(jp, tp, rtol=rtol)
    for leaf in T.leaves(tp):
        assert torch.equal(leaf[0], leaf[-1])


def test_sma_bit_equal_at_two_pods():
    jp, _, tp, _ = _round(jsync.SyncConfig("sma", 4), 2)
    _tree_equal(jp, tp)


@pytest.mark.parametrize("strategy", ["asgd", "asgd_ga", "ama", "sma",
                                      "asp"])
def test_single_pod_sync_is_identity(strategy):
    cfg = tsync.SyncConfig(strategy, 4)
    p = _to_port(_jax_params(1))
    before = T.tree_map(lambda x: x.clone(), p)
    out, st = tsync.apply_sync(cfg, p, tsync.init_sync_state(cfg, p))
    for a, b in zip(T.leaves(out), T.leaves(before)):
        assert torch.equal(a, b)
    assert int(st.steps_since_sync) == 0


@pytest.mark.parametrize("strategy", ["asgd", "asgd_ga", "ama", "sma",
                                      "asp"])
def test_init_sync_state_matches_reference(strategy):
    jcfg = jsync.SyncConfig(strategy, 4)
    params = _jax_params(2)
    js = jsync.init_sync_state(jcfg, params)
    tparams = _to_port(params)
    ts = tsync.init_sync_state(_port_cfg(jcfg), tparams)
    _tree_equal(js.ga_buffer, ts.ga_buffer)
    for f in ("steps_since_sync", "significant_frac", "ef_residual", "tier",
              "msg_norm", "resid_norm"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy())
    if strategy == "asp":   # a copy: the round updates params in place
        leaf = T.leaves(tparams)[0]
        assert T.leaves(ts.ga_buffer)[0].data_ptr() != leaf.data_ptr()


@pytest.mark.parametrize("groups,inter", [
    ([(0,), (1,), (2,), (3,)], "ama"), ([(0, 1, 2, 3)], "sma"),
    ([(0, 2), (1, 3)], "sma"), ([(0, 1), (2,), (3,)], "ama"),
    ([(3, 0), (1,), (2,)], "ama")])
def test_hierarchical_average_close_to_reference(groups, inter):
    params = _jax_params(4)
    jout = jsync.hierarchical_average(params, groups, inter=inter)
    tout = tsync.hierarchical_average(_to_port(params), groups, inter=inter)
    _tree_close(jout, tout)


def test_hierarchical_average_singletons_is_flat_ama_bit_for_bit():
    params = _to_port(_jax_params(3))
    hier = tsync.hierarchical_average(params, [(0,), (1,), (2,)])
    flat, _ = tsync.apply_sync(tsync.SyncConfig("ama", 2),
                               T.tree_map(lambda x: x.clone(), params),
                               tsync.init_sync_state(
                                   tsync.SyncConfig("ama", 2), params))
    for a, b in zip(T.leaves(hier), T.leaves(flat)):
        assert torch.equal(a, b)


def test_hierarchical_average_validation():
    p = _to_port(_jax_params(3))
    with pytest.raises(ValueError):
        tsync.hierarchical_average(p, [(0, 1)])
    with pytest.raises(ValueError):
        tsync.hierarchical_average(p, [(0,), (1, 2)], inter="mean")
    with pytest.raises(ValueError):
        tsync.hierarchical_average(p, [(0,), (1,), (2,)], shift=3)


@pytest.mark.parametrize("how", ["mean", "clone", "zeros"])
def test_grow_pods_matches_reference(how):
    params = _jax_params(3)
    jout = jsync.grow_pods(params, 5, how=how)
    tout = tsync.grow_pods(_to_port(params), 5, how=how)
    _tree_close(jout, tout)
    if how != "mean":
        _tree_equal(jout, tout)


@pytest.mark.parametrize("how", ["mean", "sum", "drop"])
@pytest.mark.parametrize("keep", [(0, 2), (3, 1), (2,)])
def test_shrink_pods_matches_reference(how, keep):
    params = _jax_params(4)
    jout = jsync.shrink_pods(params, keep, how=how)
    tout = tsync.shrink_pods(_to_port(params), keep, how=how)
    _tree_close(jout, tout)
    if how == "drop":
        _tree_equal(jout, tout)


def test_pod_transform_validation():
    p = _to_port(_jax_params(3))
    with pytest.raises(ValueError):
        tsync.grow_pods(p, 2)
    with pytest.raises(ValueError):
        tsync.shrink_pods(p, ())
    with pytest.raises(ValueError):
        tsync.shrink_pods(p, (0, 0))
    with pytest.raises(ValueError):
        tsync.shrink_pods(p, (5,))
    with pytest.raises(ValueError):
        tsync.grow_pods(p, 4, how="bogus")


def _codec_cfg(**kw):
    base = dict(compress_topk=0.01, quantize_int8=True, error_feedback=True)
    base.update(kw)
    return jsync.SyncConfig("asgd_ga", 2, **base)


@pytest.mark.parametrize("jcfg", [_codec_cfg(),
                                  jsync.SyncConfig("asp", 2),
                                  jsync.SyncConfig("ama", 4)],
                         ids=["asgd_ga-ef", "asp", "ama"])
@pytest.mark.parametrize("n_new,keep", [(2, (2, 0)), (5, None),
                                        (4, (1, 2))])
def test_resize_sync_state_matches_reference(jcfg, n_new, keep):
    params = _jax_params(3)
    state = jsync.init_sync_state(jcfg, params)
    rng = np.random.default_rng(6)
    state = state._replace(
        ga_buffer=jax.tree.map(lambda b: jnp.asarray(
            rng.normal(size=b.shape).astype(np.float32)), state.ga_buffer),
        ef_residual=jnp.asarray(rng.normal(size=state.ef_residual.shape)
                                .astype(np.float32)),
        steps_since_sync=jnp.int32(2),
        significant_frac=jnp.float32(0.25))
    if keep is not None and len(keep) < 3:
        new = jsync.shrink_pods(params, keep)
        if n_new > len(keep):
            new = jsync.grow_pods(new, n_new)
    else:
        new = jsync.grow_pods(params, n_new)
    js = jsync.resize_sync_state(jcfg, state, new, keep=keep)
    ts = tsync.resize_sync_state(_port_cfg(jcfg), _state_to_port(state),
                                 _to_port(new), keep=keep)
    _tree_close(js.ga_buffer, ts.ga_buffer)
    for f in ("ef_residual", "msg_norm", "resid_norm"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=MEAN_RTOL, atol=MEAN_ATOL)
    for f in ("steps_since_sync", "significant_frac", "tier"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy())


def test_resize_sync_state_preserves_the_ga_total():
    cfg = tsync.SyncConfig("asgd_ga", 2)
    p = _to_port(_jax_params(4))
    st = tsync.init_sync_state(cfg, p)
    st = st._replace(ga_buffer=T.tree_map(lambda b: torch.randn_like(b),
                                          st.ga_buffer))
    new = tsync.shrink_pods(p, (0, 3))
    out = tsync.resize_sync_state(cfg, st, new, keep=(0, 3))
    for a, b in zip(T.leaves(st.ga_buffer), T.leaves(out.ga_buffer)):
        torch.testing.assert_close(b.sum(0), a.sum(0), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("old,new", [
    (_codec_cfg(), _codec_cfg(value_dtype="int4")),
    (_codec_cfg(), _codec_cfg(bucket_policy="layer-class")),
    (_codec_cfg(bucket_policy="layer-class"), _codec_cfg()),
    (_codec_cfg(), _codec_cfg(error_feedback=False)),
    (_codec_cfg(error_feedback=False), _codec_cfg()),
    (_codec_cfg(), dataclasses.replace(_codec_cfg(), interval=8))])
def test_retune_sync_state_matches_reference(old, new):
    params = _jax_params(2)
    state = jsync.init_sync_state(old, params)
    rng = np.random.default_rng(7)
    state = state._replace(
        ef_residual=jnp.asarray(rng.normal(size=state.ef_residual.shape)
                                .astype(np.float32)),
        msg_norm=jnp.asarray(rng.random(size=state.msg_norm.shape)
                             .astype(np.float32)))
    js = jsync.retune_sync_state(new, old, state, params)
    ts = tsync.retune_sync_state(_port_cfg(new), _port_cfg(old),
                                 _state_to_port(state), _to_port(params))
    for f in ("ef_residual", "tier", "msg_norm", "resid_norm"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy())


def test_retune_cannot_change_strategy():
    p = _to_port(_jax_params(2))
    cfg = tsync.SyncConfig("ama", 2)
    with pytest.raises(ValueError):
        tsync.retune_sync_state(tsync.SyncConfig("sma", 2), cfg,
                                tsync.init_sync_state(cfg, p), p)


def test_accounting_helpers_match_reference():
    jcfg = _codec_cfg(bucket_policy="layer-class", overlap_chunks=3)
    params = _jax_params(2)
    layout_j = jsync.bucket_layout(jcfg, params)
    layout_t = tsync.bucket_layout(_port_cfg(jcfg), _to_port(params))
    assert jsync.bucket_chunk_mb(jcfg, layout_j) == \
        tsync.bucket_chunk_mb(_port_cfg(jcfg), layout_t)
    for n_new in (1, 2, 5):
        assert jsync.migration_wire_mb(params, n_new) == \
            tsync.migration_wire_mb(_to_port(params), n_new)
    for strategy in ("asgd", "asgd_ga", "ama", "sma", "asp"):
        for topk in (0.0, 0.01):
            jc = jsync.SyncConfig(strategy, 4, compress_topk=topk)
            assert jsync.traffic_per_step_mb(jc, 48.0) == \
                tsync.traffic_per_step_mb(_port_cfg(jc), 48.0)


# ------------------------------------------------- the trainer's transforms


def _loss(p, b):
    return sum((leaf.float() ** 2).mean() for leaf in T.leaves(p)), {}


def _trainers(jcfg, n_pods):
    jtr = jtrainer.Trainer(lambda p, b: (0.0, {}), None,
                           jtrainer.TrainerConfig(n_pods=n_pods,
                                                  optimizer="momentum",
                                                  sync=jcfg))
    ttr = ttrainer.Trainer(_loss, None,
                           ttrainer.TrainerConfig(n_pods=n_pods,
                                                  optimizer="momentum",
                                                  sync=_port_cfg(jcfg)),
                           device="cpu")
    params = _jax_params(n_pods)
    jstate = jtrainer.TrainState(params, jax.vmap(jtr.optimizer.init)(params),
                                 jsync.init_sync_state(jcfg, params),
                                 jnp.int32(0))
    rng = np.random.default_rng(8)
    jstate = jstate._replace(opt_state=jax.tree.map(
        lambda o: jnp.asarray(rng.normal(size=o.shape).astype(np.float32)),
        jstate.opt_state))
    tstate = ttrainer.TrainState(
        _to_port(jstate.params), _to_port(jstate.opt_state),
        _state_to_port(jstate.sync_state), 0)
    return jtr, jstate, ttr, tstate


@pytest.mark.parametrize("strategy", ["asgd_ga", "asp"])
@pytest.mark.parametrize("n_new,keep", [(2, (2, 0)), (5, None)])
def test_resize_train_state_matches_reference(strategy, n_new, keep):
    jcfg = jsync.SyncConfig(strategy, 2)
    jtr, jstate, ttr, tstate = _trainers(jcfg, 3)
    js = jtrainer.resize_train_state(jcfg, jstate, n_new, keep=keep)
    ts = ttrainer.resize_train_state(ttr.cfg.sync, tstate, n_new, keep=keep)
    _tree_close(js.params, ts.params)
    _tree_close(js.opt_state, ts.opt_state)
    _tree_close(js.sync_state.ga_buffer, ts.sync_state.ga_buffer)
    with pytest.raises(ValueError):
        ttrainer.resize_train_state(ttr.cfg.sync, tstate, 1, keep=(0, 1))


def test_reconfigure_and_apply_reconfig():
    jcfg = jsync.SyncConfig("asgd_ga", 2)
    _, jstate, ttr, tstate = _trainers(jcfg, 3)
    ttr.traffic_mb = 12.5
    new_sync = tsync.SyncConfig("asgd_ga", 4)
    plan = SimpleNamespace(is_noop=False,
                           pod_transition=lambda: ((2, 0), 2),
                           new=SimpleNamespace(request=SimpleNamespace(
                               sync=new_sync)))
    tr2, st2, applied = ttrainer.apply_reconfig(ttr, tstate, plan)
    assert applied and tr2.cfg.n_pods == 2 and tr2.cfg.sync == new_sync
    assert tr2.traffic_mb == 12.5
    js = jtrainer.resize_train_state(jcfg, jstate, 2, keep=(2, 0))
    _tree_close(js.params, st2.params)
    noop = SimpleNamespace(is_noop=True)
    assert ttrainer.apply_reconfig(ttr, tstate, noop) == (ttr, tstate,
                                                          False)


def test_retune_carries_state_and_interval_only_keeps_the_round():
    jcfg = _codec_cfg(bucket_policy="layer-class")
    _, _, ttr, tstate = _trainers(jcfg, 2)
    ttr.traffic_mb = 3.0
    ttr.bucket_weights(tstate)
    ttr.wire_mb(tstate)
    ef = tstate.sync_state.ef_residual
    tr2, st2 = ttr.retune(tstate, dataclasses.replace(ttr.cfg.sync,
                                                      interval=8))
    assert tr2.cfg.sync.interval == 8 and tr2.traffic_mb == 3.0
    assert tr2._wire_mb is ttr._wire_mb
    assert tr2._bucket_weights is ttr._bucket_weights
    assert st2.params is tstate.params and torch.equal(
        st2.sync_state.ef_residual, ef)
    tr3, st3 = ttr.retune(tstate, dataclasses.replace(ttr.cfg.sync,
                                                      value_dtype="int4"))
    assert tr3._wire_mb is None
    assert st3.sync_state.tier.tolist() == [3, 3, 3, 3]
    with pytest.raises(ValueError):
        ttr.retune(tstate, tsync.SyncConfig("ama", 2))
