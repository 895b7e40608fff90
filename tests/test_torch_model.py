"""Port parity: the dense decoder (granite-8b smoke config: 2 layers,
d_model 256, vocab 512, fp32) against ``repro.models``.

Both sides get the same parameters (the JAX tree converted with
``repro_torch.convert``) and the same token batch.  Each framework runs its
own f32 matmuls and reductions, whose summation orders differ, so the
forward, the loss and the gradients agree to the tolerances stated here,
not to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS as TARCH_IDS
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(2)

JCFG = jget_arch("granite-8b").smoke
TCFG = tget_arch("granite-8b").smoke
B, S = 2, 16

# f32 on both sides; the tolerances cover summation-order differences
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4   # atol = frac * max|grad| per leaf


def _np_params(seed=0):
    """Random parameters of the config's exact tree (numpy leaves)."""
    rng = np.random.default_rng(seed)
    abstract = jtransformer.abstract_params(JCFG)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        abstract)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab_size, size=(B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_configs_match_reference():
    assert TCFG.param_count() == JCFG.param_count()
    full_j, full_t = jget_arch("granite-8b").config, \
        tget_arch("granite-8b").config
    assert full_t.param_count() == full_j.param_count()
    for f in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "rope_theta", "n_layers", "padded_vocab"):
        assert getattr(full_t, f) == getattr(full_j, f)
        assert getattr(TCFG, f) == getattr(JCFG, f)


def test_converted_params_keep_tree_and_bits():
    np_params = _np_params()
    tp = convert.params_from_jax(np_params, TCFG, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(np_params)[0]
    tl = T.leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())


def test_bf16_conversion_is_bit_exact():
    x = jnp.asarray(np.random.default_rng(3).normal(size=(7, 5)),
                    jnp.bfloat16)
    t = convert.to_tensor(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(x.astype(jnp.float32)),
                                  t.float().numpy())


def test_forward_and_loss_match():
    np_params, batch = _np_params(), _batch()
    jlogits, _ = jax.jit(lambda p, t: jtransformer.forward(p, JCFG, t))(
        np_params, batch["tokens"])
    jloss, _ = jax.jit(lambda p, b: jtransformer.loss_fn(p, JCFG, b))(
        np_params, batch)
    tp = convert.params_from_jax(np_params, TCFG, device="cpu")
    tb = _torch_batch(batch)
    tlogits, _ = ttransformer.forward(tp, TCFG, tb["tokens"])
    tloss, _ = ttransformer.loss_fn(tp, TCFG, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def test_grads_match():
    np_params, batch = _np_params(seed=4), _batch(seed=5)
    jgrads = jax.jit(jax.grad(
        lambda p, b: jtransformer.loss_fn(p, JCFG, b)[0]))(np_params, batch)
    tp = convert.params_from_jax(np_params, TCFG, device="cpu")
    leaves = [x.requires_grad_(True) for x in T.leaves(tp)]
    tloss, _ = ttransformer.loss_fn(tp, TCFG, _torch_batch(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    for a, b in zip(jax.tree.leaves(jgrads), tgrads):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(a).max()))


def test_layers_match():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, 4, 64)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e7).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e7)),
        atol=1e-5, rtol=1e-5)
    h = rng.normal(size=(B, S, 256)).astype(np.float32)
    scale = rng.normal(size=(256,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(h)).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(h))),
        atol=1e-5, rtol=1e-5)
    bias_j = jlayers.attn_bias(jnp.asarray(pos), jnp.asarray(pos), None,
                               causal=True, window=4)
    bias_t = tlayers.attn_bias(torch.from_numpy(pos), torch.from_numpy(pos),
                               None, causal=True, window=4)
    np.testing.assert_array_equal(np.asarray(bias_j), bias_t.numpy())


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "whisper-tiny"])
def test_moe_hybrid_and_encdec_families_resolve(name):
    j, t = jget_arch(name), tget_arch(name)
    assert name in TARCH_IDS and t.name == j.name == name
    assert t.module == j.module
    assert t.config.param_count() == j.config.param_count()
    assert t.smoke.param_count() == j.smoke.param_count()
    assert t.config.arch_type == j.config.arch_type
    if t.module == "transformer":
        ttransformer.check_supported(t.config)
    else:
        with pytest.raises(NotImplementedError, match="encdec"):
            ttransformer.check_supported(t.config)


def test_arch_registry_matches_the_reference():
    # every arch of the reference's registry, in its order
    assert TARCH_IDS == tuple(JARCH_IDS)


@pytest.mark.parametrize("name", ["no-such-arch", "granite-9b", ""])
def test_unknown_arch_raises_key_error_as_the_reference(name):
    with pytest.raises(KeyError):
        jget_arch(name)
    with pytest.raises(KeyError):
        tget_arch(name)
