"""Port parity: ``embed_impl="onehot"``, the one-hot product over the
padded vocabulary, against the reference's, and against the port's own
gather.

A one-hot row times the table selects the row exactly (every other
product is a zero, every sum adds zeros), so within the port the one-hot
embeddings, and the logits of a forward through them, equal the gather's
bit for bit, in f32 and in bf16.  Against the reference the forward is held
at ``tests/test_torch_model.py``'s logit tolerances (f32 on both sides,
summation order differs).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer

from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(2)

B, S = 2, 16
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4      # tests/test_torch_model.py's


def _cfgs(arch: str, **kw):
    jcfg = dataclasses.replace(jget_arch(arch).smoke, **kw)
    tcfg = tget_arch(arch).smoke.replace(**kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))
    return np_params, convert.params_from_jax(np_params, tcfg, device="cpu")


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-12b"])
def test_onehot_forward_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, embed_impl="onehot")
    np_params, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg)
    want, _ = jtransformer.forward(np_params, jcfg, toks)
    got, _ = ttransformer.forward(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    jemb = jlayers.embed_apply(np_params["embed"], jcfg, toks)
    temb = tlayers.embed_apply(tparams["embed"], tcfg, torch.from_numpy(toks))
    np.testing.assert_array_equal(temb.numpy(), np.asarray(jemb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-12b"])
def test_onehot_equals_gather_bit_for_bit(arch, dtype):
    jcfg, tcfg = _cfgs(arch, param_dtype=dtype, compute_dtype=dtype)
    _, tparams = _params(jcfg, tcfg)
    toks = torch.from_numpy(_tokens(jcfg))
    onehot = tcfg.replace(embed_impl="onehot")
    assert torch.equal(tlayers.embed_apply(tparams["embed"], onehot, toks),
                       tlayers.embed_apply(tparams["embed"], tcfg, toks))
    with torch.no_grad():
        a, _ = ttransformer.forward(tparams, onehot, toks)
        b, _ = ttransformer.forward(tparams, tcfg, toks)
    assert torch.equal(a, b)


def test_unknown_embed_impl_raises():
    _, tcfg = _cfgs("granite-8b")
    with pytest.raises(ValueError, match="embed_impl"):
        tlayers.embed_apply({"tokens": torch.zeros(tcfg.padded_vocab, 4)},
                            tcfg.replace(embed_impl="sparse"),
                            torch.zeros(1, 2, dtype=torch.int32))
