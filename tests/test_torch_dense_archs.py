"""Port parity: the three dense archs beside granite (gemma2-27b,
gemma3-12b, minitron-8b) at their smoke configs, and the warmup-cosine
learning-rate schedule, against ``repro``.

Both sides get the same parameters (the JAX tree converted with
``repro_torch.convert``) and the same tokens.  The smoke configs keep each
arch's layer pattern: gemma2's alternating window of 16 with attention and
final-logit soft-caps, gemma3's five windowed layers per global one at
head_dim 64, minitron's global attention; the prompts are longer than the
windows.  f32 on both sides: logits, losses and caches agree to the
tolerances stated here, not to the bit (each framework sums its own way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtransformer
from repro.optim.optimizers import \
    warmup_cosine_schedule as jwarmup_cosine_schedule
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, all_archs
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import transformer as ttransformer
from repro_torch.optim.optimizers import warmup_cosine_schedule

torch.set_num_threads(2)

ARCHS = ["gemma2-27b", "gemma3-12b", "minitron-8b"]
B, S = 2, 24                      # S above the smoke windows (16)

# f32 on both sides; the tolerances cover summation-order differences
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
CACHE_ATOL, CACHE_RTOL = 1e-5, 1e-4
# the schedule is f32 on both sides: a few ulps of cos apart at most
LR_RTOL, LR_ATOL = 1e-6, 1e-7


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    ja, ta = jget_arch(name), tget_arch(name)
    assert name in ARCH_IDS and ta.module == ja.module == "transformer"
    for jcfg, tcfg in ((ja.config, ta.config), (ja.smoke, ta.smoke)):
        assert tcfg.param_count() == jcfg.param_count()
        for f in ("d_model", "n_heads", "n_kv_heads", "resolved_head_dim",
                  "d_ff", "vocab_size", "padded_vocab", "n_layers",
                  "rope_theta", "tie_embeddings", "attn_softcap",
                  "final_softcap", "param_dtype", "compute_dtype"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert [s.window for s in tcfg.pattern] == \
            [s.window for s in jcfg.pattern]


def test_all_archs_lists_every_ported_arch():
    assert [a.name for a in all_archs()] == list(ARCH_IDS)
    assert set(ARCHS) <= set(ARCH_IDS)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_loss_match(name):
    jcfg, tcfg = jget_arch(name).smoke, tget_arch(name).smoke
    np_params = _np_params(jcfg)
    toks = _tokens(jcfg, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    jlogits, _ = jtransformer.forward(np_params, jcfg,
                                      jnp.asarray(batch["tokens"]))
    jloss, _ = jtransformer.loss_fn(np_params, jcfg,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tlogits, _ = ttransformer.forward(tp, tcfg,
                                          torch.from_numpy(batch["tokens"]))
        tloss, _ = ttransformer.loss_fn(
            tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", [("xla", "xla"),
                                  ("pallas_interpret", "pallas")])
def test_prefill_matches_reference(name, impl):
    jcfg = jget_arch(name).smoke.replace(attention_impl=impl[0])
    tcfg = tget_arch(name).smoke.replace(attention_impl=impl[1])
    np_params = _np_params(jcfg, seed=2)
    toks = _tokens(jcfg, (2, 20), seed=3)          # longer than the window
    jl, jc = jtransformer.prefill(np_params, jcfg, jnp.asarray(toks), 32)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tl, tc = ttransformer.prefill(tp, tcfg, torch.from_numpy(toks), 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    assert sorted(tc) == sorted(jc)
    for key, jcache in jc.items():
        for t, j in zip(tc[key], jcache):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=CACHE_ATOL, rtol=CACHE_RTOL)


@pytest.mark.parametrize("peak,warmup,total,floor", [
    (1.0, 10, 100, 0.0), (3e-4, 0, 50, 0.0), (0.02, 7, 40, 1e-3),
    (0.1, 25, 25, 0.0)])
def test_warmup_cosine_matches_reference_per_step(peak, warmup, total,
                                                  floor):
    ts = warmup_cosine_schedule(peak, warmup, total, floor)
    js = jwarmup_cosine_schedule(peak, warmup, total, floor)
    got = np.array([ts(s) for s in range(total + 20)])
    want = np.array([float(js(s)) for s in range(total + 20)])
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=LR_ATOL)
    assert all(isinstance(ts(s), float) for s in (0, warmup, total))


def test_warmup_cosine_endpoints_as_the_reference_tests():
    # tests/test_substrate.py::test_warmup_cosine, on the port
    sched = warmup_cosine_schedule(1.0, warmup=10, total=100)
    assert sched(0) == 0.0
    assert sched(10) == pytest.approx(1.0)
    assert sched(100) == pytest.approx(0.0, abs=1e-6)
    assert sched(5) == pytest.approx(0.5)
