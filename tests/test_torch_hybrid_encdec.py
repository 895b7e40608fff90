"""Port parity: the hybrid decoder (jamba: Mamba and attention positions in
one group, MoE on every other position) and the encoder-decoder (whisper)
against ``repro.models.transformer``, ``repro.models.encdec`` and
``repro.serving.engine``, on their smoke configs in f32.

Both sides get the same parameters (the JAX tree converted with
``repro_torch.convert``) and the same inputs.  Each framework runs its own
f32 matmuls and transcendentals, so logits, losses and caches agree to the
tolerances stated here; greedy tokens agree one for one.  Jamba runs once as
published (one B/C group) and once with 8 B/C groups, so the SSD's B and C
are expanded by group (a copy per head), as the reference does.  Last, the
stacked ``init_params`` is held to a peak of one stacked copy plus one
group, counted in tensor bytes.
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jget_arch
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro.models.config import SSMConfig as JSSMConfig
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import encdec as tencdec
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import SSMConfig as TSSMConfig
from repro_torch.serving.engine import ContinuousEngine, ServingEngine

torch.set_num_threads(2)

JAMBA, WHISPER = "jamba-1.5-large-398b", "whisper-tiny"
GROUPS = [1, 8]
B = 2

# f32 on both sides; the tolerances cover summation-order differences
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
# caches and the encoder output, after several positions (SSM, attention,
# MoE) of summation-order differences: atol = frac * max|leaf|
CACHE_ATOL_FRAC, CACHE_RTOL = 1e-5, 1e-4
AUX_RTOL = 1e-5
# the reference's own decode-vs-forward tolerance
# (tests/test_models.py::test_whisper_decode_matches_forward)
STEP_ATOL, STEP_RTOL = 2e-3, 2e-2


def _jamba(groups):
    jcfg, tcfg = jget_arch(JAMBA).smoke, tget_arch(JAMBA).smoke
    if groups != 1:
        kw = dict(state_dim=32, head_dim=16, n_groups=groups, conv_width=4,
                  chunk_size=32, expand=2)
        jcfg = jcfg.replace(ssm=JSSMConfig(**kw))
        tcfg = tcfg.replace(ssm=TSSMConfig(**kw))
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=shape).astype(np.int32)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(
        t.numpy(), j, rtol=CACHE_RTOL,
        atol=CACHE_ATOL_FRAC * max(1.0, float(np.abs(j).max())))


def _close_cache(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for key, jc in jcache.items():
        assert type(tcache[key]).__name__ == type(jc).__name__
        for t, j in zip(tcache[key], jc):
            _close(t, j)


@pytest.fixture(scope="module", params=GROUPS, ids=lambda g: f"groups{g}")
def jamba(request):
    jcfg, tcfg = _jamba(request.param)
    np_params = _np_params(jcfg)
    return jcfg, tcfg, np_params, convert.params_from_jax(
        np_params, tcfg, device="cpu")


def test_jamba_config_matches_reference():
    j, t = jget_arch(JAMBA).config, tget_arch(JAMBA).config
    assert t.param_count() == j.param_count()
    assert t.pattern == tuple(type(t.pattern[0])(**vars(s)) for s in
                              j.pattern)
    assert (t.ssm.n_groups, t.ssm_heads, t.d_inner) == (8, 256, 16384)
    assert t.has_ssm and t.has_attention and t.has_moe


def test_jamba_forward_and_loss_match(jamba):
    jcfg, tcfg, np_params, tp = jamba
    toks = _tokens(jcfg, (B, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jlogits, jaux = jax.jit(lambda p, t: jtransformer.forward(p, jcfg, t))(
        np_params, batch["tokens"])
    jloss, _ = jax.jit(lambda p, b: jtransformer.loss_fn(p, jcfg, b))(
        np_params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, taux = ttransformer.forward(tp, tcfg, tb["tokens"])
    tloss, _ = ttransformer.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def test_jamba_prefill_then_decode_match(jamba):
    jcfg, tcfg, np_params, tp = jamba
    prompt, cont = _tokens(jcfg, (B, 32), seed=2), _tokens(jcfg, (B, 4), 3)
    jlogits, jcache = jax.jit(lambda p, t: jtransformer.prefill(
        p, jcfg, t, 40))(np_params, prompt)
    with torch.no_grad():
        tlogits, tcache = ttransformer.prefill(
            tp, tcfg, torch.from_numpy(prompt), 40)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    _close_cache(tcache, jcache)
    jstep = jax.jit(lambda p, t, c, pos: jtransformer.decode_step(
        p, jcfg, t, c, pos))
    for i in range(cont.shape[1]):
        jl, jcache = jstep(np_params, cont[:, i:i + 1], jcache,
                           jnp.int32(32 + i))
        with torch.no_grad():
            tl, tcache = ttransformer.decode_step(
                tp, tcfg, torch.from_numpy(cont[:, i:i + 1]), tcache, 32 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    _close_cache(tcache, jcache)


def test_jamba_engine_tokens_match_reference(jamba):
    jcfg, tcfg, np_params, tp = jamba
    prompts = [_tokens(jcfg, (n,), seed=10 + n) for n in (32, 20, 64)]
    out = {}
    for name, eng in (
            ("jax", JContinuousEngine(None, np_params, n_slots=3,
                                      cache_len=72, cfg=jcfg,
                                      module="transformer")),
            ("torch", ContinuousEngine(None, tp, n_slots=3, cache_len=72,
                                       cfg=tcfg, module="transformer"))):
        got = {}
        for rid, p in enumerate(prompts):
            eng.insert(p, 6, rid=rid)
        while eng.live_slots:
            for f in eng.step():
                got[f.rid] = f.tokens
        out[name] = got
    assert sorted(out["torch"]) == sorted(out["jax"]) == [0, 1, 2]
    for rid, toks in out["jax"].items():
        np.testing.assert_array_equal(out["torch"][rid], toks)


def test_grouped_bc_is_expanded_by_group():
    # 8 groups over 32 heads: head h reads group h // 4, a repeated copy
    _, tcfg = _jamba(8)
    p = _np_params(_jamba(8)[0], seed=5)
    tp = convert.params_from_jax(p, tcfg, device="cpu")
    ssm = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in tp["blocks"]["pos0"]["ssm"].items()}
    seen = []
    orig = tssm.ssd_chunked

    def spy(x, a, Bm, Cm, chunk, init_state=None):
        seen.append((Bm, Cm))
        return orig(x, a, Bm, Cm, chunk, init_state)

    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 32, tcfg.d_model)).astype(np.float32))
    tssm.ssd_chunked = spy
    try:
        tssm.ssm_apply(ssm, tcfg, x)
    finally:
        tssm.ssd_chunked = orig
    (Bm, Cm), = seen
    H, G = tcfg.ssm_heads, tcfg.ssm.n_groups
    assert Bm.shape[2] == H and Bm.is_contiguous()
    for h in range(H):
        assert torch.equal(Bm[:, :, h], Bm[:, :, (h // (H // G)) * (H // G)])
        assert torch.equal(Cm[:, :, h], Cm[:, :, (h // (H // G)) * (H // G)])
    assert not torch.equal(Bm[:, :, 0], Bm[:, :, H - 1])


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = jget_arch(WHISPER).smoke, tget_arch(WHISPER).smoke
    init = jax.jit(jencdec.init_params, static_argnums=1)
    np_params = jax.tree.map(np.asarray, init(jax.random.key(0), jcfg))
    audio = (0.1 * np.random.default_rng(7).normal(
        size=(B, jcfg.encoder_ctx, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, np_params, convert.params_from_jax(
        np_params, tcfg, device="cpu"), audio


def test_whisper_params_convert_leaf_for_leaf(whisper):
    jcfg, tcfg, np_params, tp, _ = whisper
    jl = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [p for p, _ in T.leaves_with_path(tp)]
    like = tencdec.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [(p, tuple(x.shape)) for p, x in T.leaves_with_path(like)] == \
        [(jax.tree_util.keystr(p), x.shape) for p, x in jl]
    full = tget_arch(WHISPER).config
    assert tencdec.param_count(full) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(
            jencdec.abstract_params(jget_arch(WHISPER).config)))


def test_whisper_encode_forward_and_loss_match(whisper):
    jcfg, tcfg, np_params, tp, audio = whisper
    toks = _tokens(jcfg, (B, 13), seed=8)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "audio_emb": audio}
    jenc = jencdec.encode(np_params, jcfg, jnp.asarray(audio))
    jlogits, _ = jencdec.forward(np_params, jcfg, jnp.asarray(toks[:, :-1]),
                                 jnp.asarray(audio))
    jloss, _ = jencdec.loss_fn(np_params, jcfg,
                               jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tenc = tencdec.encode(tp, tcfg, tb["audio_emb"])
    tlogits, _ = tencdec.forward(tp, tcfg, tb["tokens"], tb["audio_emb"])
    tloss, tm = tencdec.loss_fn(tp, tcfg, tb)
    _close(tenc, jenc)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert sorted(tm) == ["ce", "loss"]


def test_whisper_decode_matches_forward_and_reference(whisper):
    # mirrors the reference's test_whisper_decode_matches_forward, and holds
    # each step and the cache to the reference's decode
    jcfg, tcfg, np_params, tp, audio = whisper
    S = 12
    toks = _tokens(jcfg, (1, S), seed=9)
    a1 = audio[:1]
    full, _ = tencdec.forward(tp, tcfg, torch.from_numpy(toks),
                              torch.from_numpy(a1))
    enc = tencdec.encode(tp, tcfg, torch.from_numpy(a1))
    cache = tencdec.init_cache(tcfg, 1, S, enc=enc, params=tp)
    jenc = jencdec.encode(np_params, jcfg, jnp.asarray(a1))
    jcache = jencdec.init_cache(jcfg, 1, S, enc=jenc, params=np_params)
    _close(cache.cross_k, jcache.cross_k)
    for t in range(S):
        with torch.no_grad():
            logits, cache = tencdec.decode_step(
                tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), cache, t)
        jl, jcache = jencdec.decode_step(np_params, jcfg,
                                         jnp.asarray(toks[:, t:t + 1]),
                                         jcache, jnp.int32(t))
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, t].detach().numpy(),
                                   atol=STEP_ATOL, rtol=STEP_RTOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    moved = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    assert type(moved) is tencdec.EncDecCache
    for a, b in zip(T.leaves(moved), T.leaves(cache)):
        _close(b, a.numpy())


def test_whisper_serving_engine_matches_reference(whisper):
    jcfg, tcfg, np_params, tp, audio = whisper
    prompt = _tokens(jcfg, (B, 6), seed=11)
    jarch, tarch = jget_arch(WHISPER), tget_arch(WHISPER)
    jeng = JServingEngine(jarch, np_params, cache_len=16, use_smoke=True)
    teng = ServingEngine(tarch, tp, cache_len=16, use_smoke=True)
    jres = jeng.generate(jnp.asarray(prompt), 8, audio_emb=audio)
    tres = teng.generate(prompt, 8, audio_emb=audio)
    assert tres.tokens.shape == (B, 8) and tres.prefill_len == 6
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    # the slot pool needs a one-shot prefill, which the model has not
    for eng in (JContinuousEngine, ContinuousEngine):
        with pytest.raises(ValueError, match="one-shot prefill"):
            eng(tarch if eng is ContinuousEngine else jarch,
                tp if eng is ContinuousEngine else np_params,
                use_smoke=True)


# ---------------------------------------------------------------------------
# init_params: one stacked copy plus one group
# ---------------------------------------------------------------------------


class _PeakBytes(TorchDispatchMode):
    """The largest sum of live tensor storages allocated inside the mode:
    every op's output tensors are registered by storage, and a storage
    counts until the last tensor object on it is collected."""

    def __init__(self):
        super().__init__()
        self.live = {}        # storage address -> (nbytes, ids of tensors)
        self.peak = 0

    def _drop(self, ptr, ident):
        nbytes, ids = self.live[ptr]
        ids.discard(ident)
        if not ids:
            del self.live[ptr]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            ptr = st.data_ptr()
            if not st.nbytes():
                continue
            entry = self.live.setdefault(ptr, (st.nbytes(), set()))
            if id(t) not in entry[1]:
                entry[1].add(id(t))
                weakref.finalize(t, self._drop, ptr, id(t))
        self.peak = max(self.peak, sum(n for n, _ in self.live.values()))
        return out


def _nbytes(tree):
    return sum(x.numel() * x.element_size() for x in T.leaves(tree))


@pytest.mark.parametrize("name,n_layers", [("qwen3-moe-30b-a3b", 4),
                                           (JAMBA, 8)])
def test_init_params_peak_is_one_stack_plus_one_group(name, n_layers):
    cfg = tget_arch(name).smoke.replace(n_layers=n_layers)
    with _PeakBytes() as m:
        params = ttransformer.init_params(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
    peak = m.peak
    group = _nbytes(params["blocks"]) // cfg.n_groups
    # the f32 draw of the leaf being initialized is the one transient
    draw = max(x[0].numel() * 4 for x in T.leaves(params["blocks"]))
    assert peak <= _nbytes(params) + (group if cfg.n_groups > 1 else 0) \
        + draw, (peak, _nbytes(params), group, draw)
    # a torch.stack over a list of groups would hold the blocks twice
    assert peak < 2 * _nbytes(params["blocks"])
