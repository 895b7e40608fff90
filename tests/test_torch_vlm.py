"""Port parity: qwen2-vl-2b (M-RoPE over ``(3, B, S)`` positions, the vision
placeholders' ``patch_emb``) and ``sdpa_chunked`` against ``repro.models``
and ``repro.serving.engine``.

Both sides get the same parameters (the JAX tree converted with
``repro_torch.convert``), the same tokens, patch embeddings and positions,
all drawn from numpy seeds; f32 smoke configs.  Each framework runs its own
f32 matmuls and transcendentals, so logits, caches and gradients agree to
the tolerances stated here, not to the bit; greedy tokens agree exactly.
The explicit positions follow qwen2-vl's scheme: the image patches share
t = 0 and take (h, w) on a grid, the text after them counts on from the
largest patch position on all three components.

Under ``"xla_chunked"`` with explicit positions the reference builds its
key positions as ``0..Sk-1`` while its queries read ``positions[0]``, and
under ``"xla"`` both sides read ``positions[0]``: the two give different
logits.  The port follows the reference in each (ROADMAP.md, "not port
faults"), and the test holds both the agreement and the difference.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import get_model_fns as jget_model_fns
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.serving.engine import ContinuousEngine, ServingEngine

torch.set_num_threads(2)

NAME = "qwen2-vl-2b"
JARCH, TARCH = jget_arch(NAME), tget_arch(NAME)
B, S = 2, 24
NP = JARCH.smoke.vision_patches           # 8 patches on a 2 x 4 grid

# f32 on both sides; the tolerances cover summation-order differences
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
CACHE_ATOL, CACHE_RTOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4   # atol = frac * max|grad| per leaf
# M-RoPE: each side's f32 cos and sin of the same angles; bf16 rounds the
# f32 rotation once on each side, so the two can be one bf16 ulp apart
ROPE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
ATTN_ATOL, ATTN_RTOL = 1e-5, 1e-5        # sdpa_chunked, f32
# the reference's quirk moves these logits by far more than the tolerance
QUIRK_GAP = 100 * LOGIT_ATOL


def _cfgs(impl="xla"):
    return (JARCH.smoke.replace(attention_impl=impl),
            TARCH.smoke.replace(attention_impl=impl))


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=shape).astype(np.int32)


def _patches(jcfg, b=B, n=NP, seed=2):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(b, n, jcfg.d_model))).astype(np.float32)


def _vl_positions(b, s, n=NP, grid_w=4):
    """(3, b, s): patches at t 0 on an (h, w) grid, text counting on from
    the largest patch position on every component."""
    pos = np.zeros((3, b, s), np.int32)
    i = np.arange(n)
    pos[1, :, :n], pos[2, :, :n] = i // grid_w, i % grid_w
    start = pos[:, :, :n].max() + 1
    pos[:, :, n:] = start + np.arange(s - n)
    return pos


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert TARCH.module == JARCH.module == "transformer"
    assert TARCH.config.param_count() == 1_782_142_464
    for jcfg, tcfg in ((JARCH.config, TARCH.config),
                       (JARCH.smoke, TARCH.smoke)):
        assert tcfg.param_count() == jcfg.param_count()
        for f in ("name", "arch_type", "d_model", "n_heads", "n_kv_heads",
                  "resolved_head_dim", "d_ff", "vocab_size", "padded_vocab",
                  "n_layers", "rope_theta", "tie_embeddings", "pos_embed",
                  "mrope_sections", "vision_patches", "remat",
                  "param_dtype", "compute_dtype"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert TARCH.config.padded_vocab == 153_600


def test_converted_params_keep_tree_and_bits():
    np_params = _np_params(JARCH.smoke)
    tp = convert.params_from_jax(np_params, TARCH.smoke, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(np_params)[0]
    tl = T.leaves_with_path(tp)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    assert "lm_head" in tp["embed"]                  # untied


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections", [(16, 8, 8), (8, 12, 12), (32, 0, 0),
                                      (2, 20, 10)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(sections, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 10, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 500, size=(3, 2, 10)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x, dtype), jnp.asarray(pos),
                               1e6, sections)
    got = tlayers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(pos), 1e6, sections)
    assert str(got.dtype) == f"torch.{dtype}"
    atol, rtol = ROPE_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_apply_mrope_refuses_sections_off_half():
    x = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="sum to head_dim/2 = 32"):
        tlayers.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32),
                            1e4, (16, 8, 4))


def test_mrope_equals_rope_when_positions_equal():
    # tests/test_models.py's case, on the port; here bit for bit
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, 4, 64)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
    y1 = tlayers.apply_rope(x, pos, 10000.0)
    y2 = tlayers.apply_mrope(x, pos[None].expand(3, 2, 8), 10000.0,
                             (16, 8, 8))
    assert torch.equal(y1, y2)


def test_mrope_sections_rotate_independently():
    # tests/test_models.py's case, on the port
    x = torch.ones(1, 1, 1, 64)
    t_only = torch.tensor([[[3]], [[0]], [[0]]])
    h_only = torch.tensor([[[0]], [[3]], [[0]]])
    yt = tlayers.apply_mrope(x, t_only, 10000.0, (16, 8, 8))
    yh = tlayers.apply_mrope(x, h_only, 10000.0, (16, 8, 8))
    # the t-section (first 16 freq slots) differs, the h-section matches ones
    assert float((yt[..., :16] - yh[..., :16]).abs().max()) > 1e-3
    np.testing.assert_allclose(yt[..., 16:24].numpy(), x[..., 16:24].numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# sdpa_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(),                                        # Sk 40 = 2.5 chunks
    dict(causal=False),
    dict(window=8),
    dict(softcap=30.0),
    dict(H=6, K=2, window=5, softcap=20.0),        # GQA groups of 3
    dict(H=4, K=1),                                # MQA
    dict(chunk=64),                                # chunk above Sk
    dict(chunk=8),                                 # Sk a multiple of it
    dict(Sq=7),                                    # the last 7 queries
    dict(Sq=7, causal=False, chunk=9),
])
def test_sdpa_chunked_matches_reference(case):
    H, K = case.get("H", 4), case.get("K", 2)
    Sq, Sk, Dh = case.get("Sq", 40), 40, 32
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              softcap=case.get("softcap", 0.0), chunk=case.get("chunk", 16))
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, K, Dh)).astype(np.float32)
            for _ in range(2))
    k_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    q_pos = k_pos[:, Sk - Sq:]
    want = jlayers.sdpa_chunked(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                **kw)
    got = tlayers.sdpa_chunked(*map(torch.from_numpy,
                                    (q, k, v, q_pos, k_pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=ATTN_RTOL)
    # and the plain attention on the same masks
    bias = tlayers.attn_bias(torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), None,
                             causal=kw["causal"], window=kw["window"])
    np.testing.assert_allclose(
        got.numpy(), tlayers.sdpa_reference(
            *map(torch.from_numpy, (q, k, v)), bias,
            softcap=kw["softcap"]).numpy(), atol=ATTN_ATOL, rtol=ATTN_RTOL)


def test_sdpa_chunked_keeps_bf16_out():
    q = torch.randn(1, 16, 2, 32).bfloat16()
    k = torch.randn(1, 16, 2, 32).bfloat16()
    pos = torch.arange(16)[None]
    out = tlayers.sdpa_chunked(q, k, k, pos, pos, causal=True, window=None,
                               chunk=5)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _forward_pair(impl, explicit, seed=0):
    jcfg, tcfg = _cfgs(impl)
    np_params = _np_params(jcfg, seed)
    toks, pe = _tokens(jcfg, (B, S), seed + 1), _patches(jcfg, seed=seed + 2)
    pos = _vl_positions(B, S) if explicit else None
    jlogits, _ = jtransformer.forward(np_params, jcfg, jnp.asarray(toks),
                                      positions=_j(pos),
                                      patch_emb=jnp.asarray(pe))
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tlogits, _ = ttransformer.forward(tp, tcfg, _t(toks),
                                          positions=_t(pos),
                                          patch_emb=_t(pe))
    return tlogits.numpy(), np.asarray(jlogits)


@pytest.mark.parametrize("impl", ["xla", "xla_chunked"])
@pytest.mark.parametrize("explicit", [False, True])
def test_forward_and_loss_match(impl, explicit):
    jcfg, tcfg = _cfgs(impl)
    np_params = _np_params(jcfg, seed=3)
    toks = _tokens(jcfg, (B, S + 1), seed=4)
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask,
             "patch_emb": _patches(jcfg, seed=5)}
    if explicit:
        batch["positions"] = _vl_positions(B, S)
    jloss, _ = jtransformer.loss_fn(np_params, jcfg,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tloss, _ = ttransformer.loss_fn(tp, tcfg, {k: _t(v) for k, v
                                                   in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    tl, jl = _forward_pair(impl, explicit)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_chunked_quirk_under_explicit_positions_follows_reference():
    # default positions: "xla" and "xla_chunked" agree on both sides
    np.testing.assert_allclose(_forward_pair("xla", False)[0],
                               _forward_pair("xla_chunked", False)[0],
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    # explicit ones: the chunked keys sit at 0..S-1, the plain keys at
    # positions[0]; each port path equals its reference path, and they
    # differ from each other as the reference's do
    (tx, jx), (tc, jc) = (_forward_pair("xla", True),
                          _forward_pair("xla_chunked", True))
    np.testing.assert_allclose(tx, jx, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(tc, jc, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    assert float(np.abs(jx - jc).max()) > QUIRK_GAP
    assert float(np.abs(tx - tc).max()) > QUIRK_GAP


def test_patch_emb_replaces_the_first_embeddings():
    jcfg, tcfg = _cfgs()
    tp = convert.params_from_jax(_np_params(jcfg), tcfg, device="cpu")
    toks, pe = _t(_tokens(jcfg, (B, S))), _t(_patches(jcfg))
    with torch.no_grad():
        h_pe, _ = ttransformer.forward(tp, tcfg, toks, patch_emb=pe,
                                       return_hidden=True)
        h, _ = ttransformer.forward(tp, tcfg, toks, return_hidden=True)
        logits, _ = ttransformer.forward(tp, tcfg, toks)
    assert h_pe.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(
        ttransformer.L.unembed_apply(tp["embed"], tcfg, h).numpy(),
        logits.numpy(), atol=1e-6, rtol=1e-6)
    # every row attends to the patches at positions 0..NP-1
    assert bool(((h_pe - h).abs().amax(dim=-1) > 0).all())
    assert torch.equal(ttransformer._embed(tp, tcfg, toks, pe)[:, :NP], pe)
    # a model without vision placeholders ignores patch_emb, as the
    # reference does
    gcfg = tget_arch("granite-8b").smoke
    gp = ttransformer.init_params(torch.Generator().manual_seed(0), gcfg,
                                  "cpu")
    with torch.no_grad():
        a, _ = ttransformer.forward(gp, gcfg, toks, patch_emb=pe)
        b, _ = ttransformer.forward(gp, gcfg, toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("explicit", [False, True])
def test_grads_match(explicit):
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, seed=6)
    toks = _tokens(jcfg, (B, S + 1), seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patch_emb": _patches(jcfg, seed=8)}
    if explicit:
        batch["positions"] = _vl_positions(B, S)
    jgrads = jax.jit(jax.grad(
        lambda p, b: jtransformer.loss_fn(p, jcfg, b)[0]))(np_params, batch)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    leaves = [x.requires_grad_(True) for x in T.leaves(tp)]
    tloss, _ = ttransformer.loss_fn(tp, tcfg,
                                    {k: _t(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    for (path, _), a, b in zip(T.leaves_with_path(tp),
                               jax.tree.leaves(jgrads), tgrads):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(a).max()), err_msg=path)
    # the placeholders' token rows take no gradient through the embedding
    g_tok = tgrads[[p for p, _ in T.leaves_with_path(tp)].index(
        "['embed']['tokens']")]
    only_patches = set(batch["tokens"][:, :NP].ravel()) - set(
        batch["tokens"][:, NP:].ravel())
    assert only_patches and all(float(g_tok[t].abs().max()) == 0.0
                                for t in only_patches)


@pytest.mark.parametrize("explicit", [False, True])
def test_prefill_and_decode_match(explicit):
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, seed=9)
    prompt, cont = _tokens(jcfg, (B, 20), seed=10), _tokens(jcfg, (B, 4), 11)
    pe = _patches(jcfg, seed=12)
    pos = _vl_positions(B, 20) if explicit else None
    cache_len = 32
    jl, jcache = jtransformer.prefill(np_params, jcfg, jnp.asarray(prompt),
                                      cache_len, positions=_j(pos),
                                      patch_emb=jnp.asarray(pe))
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tl, tcache = ttransformer.prefill(tp, tcfg, _t(prompt), cache_len,
                                          positions=_t(pos), patch_emb=_t(pe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    assert sorted(tcache) == sorted(jcache)
    for key, jc in jcache.items():
        for t, j in zip(tcache[key], jc):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=CACHE_ATOL, rtol=CACHE_RTOL)
    jstep = jax.jit(lambda p, t, c, i: jtransformer.decode_step(
        p, jcfg, t, c, i))
    for i in range(cont.shape[1]):
        at = prompt.shape[1] + i
        jl, jcache = jstep(np_params, cont[:, i:i + 1], jcache,
                           jnp.int32(at))
        with torch.no_grad():
            tl, tcache = ttransformer.decode_step(
                tp, tcfg, _t(cont[:, i:i + 1]), tcache,
                torch.full((B,), at, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_explicit_positions_under_pallas_raise():
    _, tcfg = _cfgs("pallas")
    tp = ttransformer.init_params(torch.Generator().manual_seed(0), tcfg,
                                  "cpu")
    toks = _t(_tokens(tcfg, (B, S)))
    for pos in (_t(_vl_positions(B, S)), _t(_vl_positions(B, S))[0]):
        with pytest.raises(NotImplementedError, match="0..S-1"):
            ttransformer.forward(tp, tcfg, toks, positions=pos)
        with pytest.raises(NotImplementedError, match="0..S-1"):
            ttransformer.prefill(tp, tcfg, toks, 32, positions=pos)


def test_more_patches_than_positions_raise():
    _, tcfg = _cfgs()
    tp = ttransformer.init_params(torch.Generator().manual_seed(0), tcfg,
                                  "cpu")
    toks = _t(_tokens(tcfg, (B, 6)))
    pe = _t(_patches(tcfg, n=7))
    with pytest.raises(ValueError, match="7 patches"):
        ttransformer.forward(tp, tcfg, toks, patch_emb=pe)
    with pytest.raises(ValueError, match="7 patches"):
        ttransformer.prefill(tp, tcfg, toks, 16, patch_emb=pe)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_generate_with_patch_emb_matches_reference():
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, seed=13)
    prompt, pe = _tokens(jcfg, (B, 16), seed=14), _patches(jcfg, seed=15)
    jres = JServingEngine(JARCH, np_params, cache_len=32,
                          use_smoke=True).generate(
        jnp.asarray(prompt), 8, patch_emb=jnp.asarray(pe))
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    eng = ServingEngine(TARCH, tp, cache_len=32, use_smoke=True)
    tres = eng.generate(prompt, 8, patch_emb=pe)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    # the patches move the tokens
    assert not np.array_equal(eng.generate(prompt, 8).tokens, tres.tokens)


def test_continuous_engine_matches_reference():
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, seed=16)
    prompts = [_tokens(jcfg, (n,), seed=17 + n) for n in (12, 5, 9, 16, 7)]
    jeng = JContinuousEngine(JARCH, np_params, n_slots=3, cache_len=32,
                             use_smoke=True)
    teng = ContinuousEngine(TARCH, convert.params_from_jax(
        np_params, tcfg, device="cpu"), n_slots=3, cache_len=32,
        use_smoke=True)
    out = []
    for eng in (jeng, teng):
        res = {}
        pending = list(enumerate(prompts))
        while pending or eng.live_slots:
            if pending and eng.free_slots:
                rid, p = pending.pop(0)
                eng.insert(p, 6, rid=rid)
            for f in eng.step():
                res[f.rid] = list(f.tokens)
        out.append(res)
    assert out[0] == out[1] and sorted(out[1]) == list(range(len(prompts)))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

TRAIN_FLAGS = ["--arch", NAME, "--smoke", "--pods", "2", "--steps", "4",
               "--batch", "4", "--seq", "16", "--interval", "2",
               "--compress-topk", "0.05", "--int8", "--error-feedback",
               "--log-every", "0"]
# f32 over 4 steps and 2 codec rounds (each side's top-k over its own
# gradients)
TRAIN_LOSS_RTOL = 1e-4


def test_train_launcher_matches_reference():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(TRAIN_FLAGS)
    jlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[train] ")]
    jparams = jget_model_fns("transformer").init_params(jax.random.key(0),
                                                        JARCH.smoke)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      TARCH.smoke, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(TRAIN_FLAGS + ["--device", "cpu"],
                         init_params=tparams)
    tlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[train] ")]
    assert tlines[0].rsplit(", device", 1)[0] == jlines[0]
    assert tlines[1:] == jlines[1:]
    for key in ("loss_first", "loss_last"):
        assert np.isfinite(ts[key])
        np.testing.assert_allclose(ts[key], js[key], rtol=TRAIN_LOSS_RTOL)
    assert ts["wan_traffic_mb"] == pytest.approx(js["wan_traffic_mb"])


def _summary(text):
    return json.JSONDecoder().raw_decode(text[text.index("{"):])[0]


@pytest.mark.parametrize("scheduler", ["continuous", "batch"])
def test_serve_launcher_matches_reference(scheduler, capsys):
    flags = ["--arch", NAME, "--smoke", "--scheduler", scheduler,
             "--slots", "2", "--batch", "2", "--replicas", "2",
             "--prompt-len", "12", "--new-tokens", "4", "--requests", "5"]
    jresults = jserve.main(flags)
    jsum = _summary(capsys.readouterr().out)
    tresults = tserve.main(flags + ["--device", "cpu"])
    tsum = _summary(capsys.readouterr().out)
    assert tsum["device"] == "cpu" and tsum["arch"] == jsum["arch"] == NAME
    for key in ("scheduler", "router", "replicas", "autoscale", "requests",
                "new_tokens", "routes"):
        assert tsum[key] == jsum[key], key
    assert sorted(tresults) == sorted(jresults)
    for rid, toks in tresults.items():
        assert np.asarray(toks).shape == np.asarray(jresults[rid]).shape
