"""Port parity: the ASGD-GA sync round against ``repro.core.sync``.

Both sides start from the same state: the same stacked parameters, the
same accumulated-gradient buffer and EF residual (converted with
``repro_torch.convert``).  From the same arrays the round is deterministic
arithmetic, so the wire chunks, the new parameters, the EF residual and the
tier and step telemetry must be equal bit for bit; the per-bucket norms are
reductions and agree to a stated tolerance.  The accounting helpers are host
arithmetic and must agree exactly too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync as jsync
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.core import sync as tsync

torch.set_num_threads(2)

N_PODS = 3
# a decoder-shaped tree (the granite smoke config's leaf paths and ranks, at
# a quarter of its widths): ragged codec blocks, one bucket per class
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


@functools.lru_cache(maxsize=1)
def _jax_params():
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda shape: jnp.asarray(rng.normal(size=(N_PODS,) + shape)
                                  .astype(np.float32)),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _jax_state(cfg, steps=3, seed=2):
    params = _jax_params()
    st = jsync.init_sync_state(cfg, params)
    rng = np.random.default_rng(seed)
    buf = jax.tree.map(lambda b: jnp.asarray(
        rng.normal(size=b.shape).astype(np.float32)), st.ga_buffer)
    ef = jnp.asarray(0.1 * rng.normal(size=st.ef_residual.shape)
                     .astype(np.float32))
    return params, st._replace(ga_buffer=buf, ef_residual=ef,
                               steps_since_sync=jnp.int32(steps))


def _to_port(params, state):
    np_params = jax.tree.map(np.asarray, params)
    tparams = T.tree_map(lambda a: convert.to_tensor(a, "cpu"), np_params)
    tstate = convert.sync_state_from_jax(jax.tree.map(np.asarray, state),
                                         "cpu")
    return tparams, tstate


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.itemsize == 1:
        a, b = a.view(np.uint8), b.view(np.uint8)
    np.testing.assert_array_equal(a, b)


# The telemetry norms are f32 reductions that each framework sums in its
# own order, so they agree to rounding, not to the bit: relative 1e-6 is a
# few ulps of f32 for sums of squares over these segments.
NORM_RTOL = 1e-6


def _norms_close(js, ts):
    for name in ("msg_norm", "resid_norm"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=NORM_RTOL, atol=0)


def _codec_cfg(value_dtype, chunks, policy="single"):
    return jsync.SyncConfig("asgd_ga", 2, compress_topk=0.01,
                            quantize_int8=True, value_dtype=value_dtype,
                            error_feedback=True, overlap_chunks=chunks,
                            bucket_policy=policy)


def _port_cfg(jcfg):
    return tsync.SyncConfig(
        jcfg.strategy, jcfg.interval, compress_topk=jcfg.compress_topk,
        quantize_int8=jcfg.quantize_int8, value_dtype=jcfg.value_dtype,
        error_feedback=jcfg.error_feedback, overlap_chunks=jcfg.overlap_chunks,
        codec_block=jcfg.codec_block, bucket_policy=jcfg.bucket_policy)


@pytest.mark.parametrize("value_dtype,chunks,policy", [
    ("int8", 1, "single"), ("fp8", 1, "single"), ("int4", 1, "single"),
    ("int8", 4, "single"), ("int4", 2, "layer-class")])
def test_same_state_codec_round_is_bit_exact(value_dtype, chunks, policy):
    jcfg = _codec_cfg(value_dtype, chunks, policy)
    tcfg = _port_cfg(jcfg)
    lr = 0.05
    params, state = _jax_state(jcfg)
    tparams, tstate = _to_port(params, state)

    jpay = jax.jit(functools.partial(jsync.prepare_codec_sync, jcfg))(state)
    jship = jsync.ship_sync_payloads(jcfg, jpay.chunks)
    jp, js = jsync.finish_codec_sync(jcfg, params, state, jpay, jship, lr)

    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    tship = tsync.ship_sync_payloads(tcfg, tpay.chunks)
    _eq(jpay.flat, tpay.flat)
    _eq(jpay.local, tpay.local)
    assert sorted(jship) == sorted(tship)   # jit returns dicts key-sorted
    for name in jship:
        assert len(jship[name]) == len(tship[name])
        for jc, tc in zip(jship[name], tship[name]):
            assert tc.idx.dtype == torch.uint16
            for a, b in zip(jc, tc):
                _eq(a, b)
    tp, ts = tsync.finish_codec_sync(tcfg, tparams, tstate, tpay, tship, lr)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        _eq(a, b)
    _eq(js.ef_residual, ts.ef_residual)
    _norms_close(js, ts)
    _eq(js.tier, ts.tier)
    _eq(js.steps_since_sync, ts.steps_since_sync)
    for a, b in zip(jax.tree.leaves(js.ga_buffer), T.leaves(ts.ga_buffer)):
        _eq(a, b)


def test_degraded_round_alive_mask_is_bit_exact():
    jcfg = _codec_cfg("int8", 1)
    tcfg = _port_cfg(jcfg)
    params, state = _jax_state(jcfg, steps=2, seed=5)
    tparams, tstate = _to_port(params, state)
    alive = np.array([1.0, 0.0, 1.0], np.float32)
    jpay = jax.jit(functools.partial(jsync.prepare_codec_sync, jcfg))(state)
    jship = jsync.ship_sync_payloads(jcfg, jpay.chunks)
    jp, js = jsync.finish_codec_sync(jcfg, params, state, jpay, jship, 0.1,
                                     jnp.asarray(alive))
    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    tship = tsync.ship_sync_payloads(tcfg, tpay.chunks)
    tp, ts = tsync.finish_codec_sync(tcfg, tparams, tstate, tpay, tship, 0.1,
                                     alive=torch.from_numpy(alive))
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        _eq(a, b)
    _eq(js.ef_residual, ts.ef_residual)
    _norms_close(js, ts)


def test_same_state_dense_round_is_bit_exact():
    jcfg = jsync.SyncConfig("asgd_ga", 3)
    tcfg = _port_cfg(jcfg)
    params, state = _jax_state(jcfg)
    tparams, tstate = _to_port(params, state)
    jp, js = jsync.apply_sync(jcfg, params, state, 0.05)
    tp, ts = tsync.apply_sync(tcfg, tparams, tstate, 0.05)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        _eq(a, b)
    _eq(js.tier, ts.tier)
    _eq(js.steps_since_sync, ts.steps_since_sync)


def test_on_step_gradients_accumulates_like_reference():
    jcfg = _codec_cfg("int8", 1)
    tcfg = _port_cfg(jcfg)
    params, state = _jax_state(jcfg)
    _, tstate = _to_port(params, state)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda b: jnp.asarray(
        rng.normal(size=b.shape).astype(np.float32)), state.ga_buffer)
    tgrads = T.tree_map(lambda a: convert.to_tensor(a, "cpu"),
                        jax.tree.map(np.asarray, grads))
    _, js = jsync.on_step_gradients(jcfg, grads, state)
    _, ts = tsync.on_step_gradients(tcfg, tgrads, tstate)
    for a, b in zip(jax.tree.leaves(js.ga_buffer), T.leaves(ts.ga_buffer)):
        _eq(a, b)
    _eq(js.steps_since_sync, ts.steps_since_sync)


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("n_total", [1, 4095, 4096, 40961, 838_881_280])
def test_chunk_widths_match(chunks, n_total):
    jcfg = _codec_cfg("int8", chunks)
    assert jsync._chunk_widths(jcfg, n_total) == \
        tsync._chunk_widths(_port_cfg(jcfg), n_total)


@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
def test_payload_and_wire_accounting_match(value_dtype):
    jcfg = _codec_cfg(value_dtype, 4)
    tcfg = _port_cfg(jcfg)
    params, state = _jax_state(jcfg)
    tparams, _ = _to_port(params, state)
    for mb in (0.5, 1677.76, 3355.52):
        assert jcfg.payload_mb(mb) == tcfg.payload_mb(mb)
        assert jsync.traffic_per_step_mb(jcfg, mb) == \
            tsync.traffic_per_step_mb(tcfg, mb)
    jl = jsync.bucket_layout(jcfg, params)
    tl = tsync.bucket_layout(tcfg, tparams)
    assert jl.__dict__ == tl.__dict__
    assert jsync.bucket_wire_mb(jcfg, jl) == tsync.bucket_wire_mb(tcfg, tl)


def test_layer_class_layout_matches():
    jcfg = jsync.SyncConfig("asgd_ga", 2, compress_topk=0.01,
                            quantize_int8=True, bucket_policy="layer-class")
    tcfg = tsync.SyncConfig("asgd_ga", 2, compress_topk=0.01,
                            quantize_int8=True, bucket_policy="layer-class")
    params, _ = _jax_state(jsync.SyncConfig("asgd_ga", 2))
    tparams = T.tree_map(lambda a: convert.to_tensor(a, "cpu"),
                         jax.tree.map(np.asarray, params))
    jl = jsync.bucket_layout(jcfg, params)
    tl = tsync.bucket_layout(tcfg, tparams)
    assert jl.__dict__ == tl.__dict__
    assert jcfg.bucket_tiers == tcfg.bucket_tiers
    assert jsync.bucket_weights_of(jcfg, params) == \
        tsync.bucket_weights_of(tcfg, tparams)


@pytest.mark.parametrize("kw", [
    dict(strategy="nope"), dict(interval=0), dict(codec_block=64),
    dict(quantize_int8=True), dict(error_feedback=True),
    dict(value_dtype="fp8"), dict(overlap_chunks=2),
    dict(strategy="sma", quantize_int8=True, compress_topk=0.1),
    dict(bucket_policy="layer-class"),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        jsync.SyncConfig(**kw)
    with pytest.raises(ValueError):
        tsync.SyncConfig(**kw)


def test_unported_strategies_raise():
    """Every strategy runs, and the codec round ships through a transport
    as well as over the inline ring: a ``SimTransport`` ships the ring's
    bytes and bills the round."""
    from repro_torch.core.transport import MeasuredWanProbe, SimTransport
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    for strategy in tsync.STRATEGIES:
        cfg = tsync.SyncConfig(strategy, 2, compress_topk=0.5)
        p = {"w": torch.ones(2, 3)}
        tsync.apply_sync(cfg, p, tsync.init_sync_state(cfg, p))
    tcfg = _port_cfg(_codec_cfg("int8", 2, "layer-class"))
    _, tstate = _to_port(*_jax_state(_codec_cfg("int8", 2, "layer-class")))
    tpay = tsync.prepare_codec_sync(tcfg, tstate)
    wire = tsync.bucket_wire_mb(tcfg, tsync.bucket_layout(tcfg,
                                                         tstate.ga_buffer))
    sim = SimTransport(BandwidthTrace((0.0,), (100.0,)), WANConfig(seed=1),
                       probe=MeasuredWanProbe())
    shipped = tsync.ship_sync_payloads(tcfg, tpay.chunks, sim, wire)
    inline = tsync.ship_sync_payloads(tcfg, tpay.chunks, None, wire)
    assert list(shipped) == list(inline) == list(wire)
    for name in inline:
        for a, b in zip(shipped[name], inline[name]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert sim.on_sync(wire, step=1) > 0.0
    assert [r.bucket for r in sim.records] == list(wire)
    assert sim.probe.n_observations == 1
