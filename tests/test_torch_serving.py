"""Port parity: the serving plane (prefill, per-slot decode, the slot-pool
engine and its schedulers) against ``repro.models`` and
``repro.serving.engine``.

Two configs, both granite's smoke size in f32: the dense one (2 layers of
global attention) and a windowed one (4 layers alternating a sliding window
of 8 with global attention, attention soft-capped at 30), whose prompts are
longer than the window so the ring buffer rolls.  Both sides get the same
parameters (the JAX tree converted with ``repro_torch.convert``) and the
same tokens.  Each framework runs its own f32 matmuls, so logits and caches
agree to the tolerances stated here, not to the bit; the engine invariants
(batch == solo, slot independence) hold bit for bit within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtransformer
from repro.models.config import LayerSpec as JLayerSpec
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import ContinuousScheduler as JContinuousScheduler
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import LayerSpec as TLayerSpec
from repro_torch.serving.engine import (BatchScheduler, ContinuousEngine,
                                        ContinuousScheduler, ServingEngine)

torch.set_num_threads(2)

JARCH, TARCH = jget_arch("granite-8b"), tget_arch("granite-8b")

# f32 on both sides; the tolerances cover summation-order differences
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
CACHE_ATOL, CACHE_RTOL = 1e-5, 1e-4
# greedy tokens must agree wherever the reference's top-2 logit margin is
# wider than the logit tolerance can move
MARGIN = 10 * LOGIT_ATOL

WINDOWED = dict(n_layers=4, attn_softcap=30.0)
CONFIGS = ["dense", "windowed"]


def _cfgs(kind, impl=("xla", "xla")):
    jcfg, tcfg = JARCH.smoke, TARCH.smoke
    if kind == "windowed":
        jcfg = jcfg.replace(pattern=(JLayerSpec(window=8), JLayerSpec()),
                            **WINDOWED)
        tcfg = tcfg.replace(pattern=(TLayerSpec(window=8), TLayerSpec()),
                            **WINDOWED)
    return (jcfg.replace(attention_impl=impl[0]),
            tcfg.replace(attention_impl=impl[1]))


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=shape).astype(np.int32)


def _close_cache(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for key, jc in jcache.items():
        for t, j in zip(tcache[key], jc):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=CACHE_ATOL, rtol=CACHE_RTOL)


@pytest.mark.parametrize("kind", CONFIGS)
@pytest.mark.parametrize("impl", [("xla", "xla"),
                                  ("pallas_interpret", "pallas")])
def test_prefill_matches_reference(kind, impl):
    jcfg, tcfg = _cfgs(kind, impl)
    np_params = _np_params(jcfg)
    toks = _tokens(jcfg, (2, 12))                 # longer than the window
    jl, jc = jtransformer.prefill(np_params, jcfg, jnp.asarray(toks), 16)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tl, tc = ttransformer.prefill(tp, tcfg, torch.from_numpy(toks), 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    _close_cache(tc, jc)
    if kind == "windowed":                        # the ring buffer is full
        assert tc["pos0"].k.shape[2] == 8 and tc["pos1"].k.shape[2] == 16


def _random_pool(jcfg, n_slots, cache_len, seed=2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (0.5 * rng.normal(size=x.shape)).astype(np.float32),
        jtransformer.init_cache(jcfg, n_slots, cache_len))


@pytest.mark.parametrize("kind", CONFIGS)
def test_decode_per_row_positions_match_reference_vmap(kind):
    # the reference engine vmaps a single-sequence decode_step over slots;
    # the port writes the slot axis out with a (B,) position vector
    jcfg, tcfg = _cfgs(kind)
    np_params = _np_params(jcfg, seed=3)
    pool = _random_pool(jcfg, 3, 16)
    toks = _tokens(jcfg, (3, 1), seed=4)
    pos = np.array([12, 5, 9], np.int32)          # 12 wraps a ring of 8

    def one(p, tok, cache, q):
        cache1 = jax.tree.map(lambda x: x[:, None], cache)
        logits, nc = jtransformer.decode_step(p, jcfg, tok[None], cache1, q)
        return logits[0, 0], jax.tree.map(lambda x: x[:, 0], nc)

    jl, jpool = jax.vmap(one, in_axes=(None, 0, 1, 0), out_axes=(0, 1))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks), pool,
        jnp.asarray(pos))
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    tpool = convert.cache_from_jax(pool, "cpu")
    with torch.no_grad():
        tl, out_pool = ttransformer.decode_step(
            tp, tcfg, torch.from_numpy(toks), tpool, torch.from_numpy(pos))
    assert out_pool is tpool                      # updated in place
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    _close_cache(tpool, jpool)


@pytest.mark.parametrize("kind", CONFIGS)
def test_decode_scalar_position_matches_reference(kind):
    jcfg, tcfg = _cfgs(kind)
    np_params = _np_params(jcfg, seed=5)
    pool = _random_pool(jcfg, 2, 16, seed=6)
    toks = _tokens(jcfg, (2, 1), seed=7)
    jl, jpool = jtransformer.decode_step(np_params, jcfg, jnp.asarray(toks),
                                         pool, jnp.int32(11))
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    tpool = convert.cache_from_jax(pool, "cpu")
    with torch.no_grad():
        tl, _ = ttransformer.decode_step(tp, tcfg, torch.from_numpy(toks),
                                         tpool, 11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    _close_cache(tpool, jpool)


@pytest.mark.parametrize("kind", CONFIGS)
def test_greedy_tokens_teacher_forced_through_port(kind):
    # the reference engine's greedy tokens, fed back through the port's
    # prefill + decode: same logits within tolerance, and the same argmax
    # wherever the reference's top-2 margin is wider than MARGIN
    jcfg, tcfg = _cfgs(kind)
    np_params = _np_params(jcfg, seed=8)
    prompt = _tokens(jcfg, (12,), seed=9)
    n_new = 8
    jeng = JContinuousEngine(None, np_params, n_slots=2, cache_len=24,
                             cfg=jcfg, module="transformer")
    jeng.insert(prompt, n_new, rid=0)
    jtoks = None
    while jtoks is None:
        for f in jeng.step():
            jtoks = f.tokens
    assert jtoks.size == n_new

    full = np.concatenate([prompt, jtoks[:-1]])[None]
    jlogits, _ = jtransformer.forward(np_params, jcfg, jnp.asarray(full))
    jlogits = np.asarray(jlogits)[0, prompt.size - 1:, : jcfg.vocab_size]

    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        logits, cache = ttransformer.prefill(
            tp, tcfg, torch.from_numpy(prompt)[None], 24)
        tlogits = [logits[0]]
        for i, tok in enumerate(jtoks[:-1]):
            logits, cache = ttransformer.decode_step(
                tp, tcfg, torch.tensor([[int(tok)]], dtype=torch.int32),
                cache, prompt.size + i)
            tlogits.append(logits[0, 0])
    tlogits = torch.stack(tlogits)[:, : tcfg.vocab_size].numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert wide.sum() >= n_new // 2
    np.testing.assert_array_equal(tlogits.argmax(-1)[wide], jtoks[wide])


# ---------------------------------------------------------------------------
# the engine's invariants, within the port (tests/test_serving.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _cfgs("dense")
    np_params = _np_params(jcfg, seed=10)
    return tcfg, convert.params_from_jax(np_params, tcfg, device="cpu"), \
        np_params


def test_greedy_generate_matches_manual_loop(granite):
    cfg, params, _ = granite
    engine = ServingEngine(TARCH, params, cache_len=24, use_smoke=True)
    prompt = _tokens(cfg, (2, 8), seed=11)
    gen = engine.generate(prompt, 6)
    assert gen.tokens.shape == (2, 6)
    toks, outs = prompt, []
    with torch.no_grad():
        for _ in range(6):
            logits, _ = ttransformer.forward(params, cfg,
                                             torch.from_numpy(toks))
            nxt = logits[:, -1, : cfg.vocab_size].argmax(-1).numpy()
            outs.append(nxt)
            toks = np.concatenate([toks, nxt[:, None].astype(np.int32)], 1)
    np.testing.assert_array_equal(gen.tokens, np.stack(outs, 1))


def test_temperature_sampling_within_vocab(granite):
    cfg, params, _ = granite
    engine = ServingEngine(TARCH, params, cache_len=16, use_smoke=True)
    gen = engine.generate(_tokens(cfg, (1, 4), seed=12), 8, temperature=1.0,
                          generator=torch.Generator().manual_seed(3))
    assert gen.tokens.shape == (1, 8)
    assert gen.tokens.min() >= 0 and gen.tokens.max() < cfg.vocab_size


def test_batch_matches_solo_generation(granite):
    cfg, params, _ = granite
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (2, 8, 5, 3, 8, 6)]       # deliberately mixed
    sched = BatchScheduler(ServingEngine(TARCH, params, cache_len=16,
                                         use_smoke=True), batch_size=3)
    rids = [sched.submit(p, 4) for p in prompts]
    batched = sched.run()
    assert set(batched) == set(rids)
    solo = ServingEngine(TARCH, params, cache_len=16, use_smoke=True)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(
            batched[rid], solo.generate(p[None], 4).tokens[0],
            err_msg=f"prompt len {p.size} diverged from solo generation")


def test_insert_never_clobbers_live_slot(granite):
    cfg, params, _ = granite
    eng = ContinuousEngine(TARCH, params, n_slots=2, cache_len=16,
                           use_smoke=True)
    rng = np.random.default_rng(0)

    def p(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    s0 = eng.insert(p(4), 8, rid=0)
    with pytest.raises(RuntimeError, match="clobber"):
        eng.insert(p(4), 8, rid=1, slot=s0)
    eng.insert(p(5), 8, rid=1)
    with pytest.raises(RuntimeError, match="free slot"):
        eng.insert(p(3), 8, rid=2)
    with pytest.raises(ValueError, match="non-empty"):
        eng.insert(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="cache_len"):
        eng.insert(p(8), 99)
    assert eng.live_slots == [0, 1]


def test_evict_frees_exactly_one_slot(granite):
    cfg, params, _ = granite
    eng = ContinuousEngine(TARCH, params, n_slots=3, cache_len=16,
                           use_smoke=True)
    rng = np.random.default_rng(1)
    for r in range(3):
        eng.insert(rng.integers(0, cfg.vocab_size, 4).astype(np.int32), 8,
                   rid=r)
    before = {i: eng.slots[i].rid for i in eng.live_slots}
    eng.evict(1)
    assert eng.free_slots == [1]
    assert {i: eng.slots[i].rid for i in eng.live_slots} == \
        {i: r for i, r in before.items() if i != 1}
    with pytest.raises(RuntimeError, match="already free"):
        eng.evict(1)


def test_decode_bit_identical_under_concurrent_insert(granite):
    cfg, params, _ = granite
    rng = np.random.default_rng(2)
    pa = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    pb = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    alone = ContinuousEngine(TARCH, params, n_slots=2, cache_len=16,
                             use_smoke=True)
    alone.insert(pa, 8, rid=0)
    ref = None
    while ref is None:
        for f in alone.step():
            if f.rid == 0:
                ref = f.tokens
    shared = ContinuousEngine(TARCH, params, n_slots=2, cache_len=16,
                              use_smoke=True)
    shared.insert(pa, 8, rid=0)
    shared.step()                       # slot 0 decodes alone once...
    shared.insert(pb, 8, rid=1)         # ...then a neighbour moves in
    got = {}
    while len(got) < 2:
        for f in shared.step():
            got[f.rid] = f.tokens
    np.testing.assert_array_equal(got[0], ref)


def test_eos_evicts_slot_early(granite):
    cfg, params, _ = granite
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, 5).astype(np.int32)
    free = ContinuousEngine(TARCH, params, n_slots=1, cache_len=16,
                            use_smoke=True)
    free.insert(prompt, 6, rid=0)
    full = None
    while full is None:
        for f in free.step():
            full = f.tokens
    assert full.size == 6 and len(set(full.tolist())) > 1
    eos = int(full[2])                  # a token the run actually emits
    first = full.tolist().index(eos)
    eng = ContinuousEngine(TARCH, params, n_slots=1, cache_len=16,
                           use_smoke=True, eos_id=eos)
    eng.insert(prompt, 6, rid=0)
    fin = eng.take_finished()[0] if first == 0 else None
    while fin is None:
        for f in eng.step():
            fin = f
    assert fin.reason == "eos"
    assert fin.tokens[-1] == eos and fin.tokens.size == first + 1
    assert eng.free_slots == [0]        # the slot is immediately reusable


def test_scheduler_history_matches_reference(granite):
    # decoupled queues: prefill-inserts interleave with decode steps, never
    # two prefills back to back, and the interleaving is the reference's
    cfg, params, np_params = granite
    rng = np.random.default_rng(4)
    subs = [(rng.integers(0, cfg.vocab_size, 4).astype(np.int32), m)
            for m in (6, 3, 5, 2, 4)]
    sched = ContinuousScheduler(ContinuousEngine(
        TARCH, params, n_slots=2, cache_len=16, use_smoke=True))
    jsched = JContinuousScheduler(JContinuousEngine(
        JARCH, np_params, n_slots=2, cache_len=16, use_smoke=True))
    rids = [sched.submit(p, m) for p, m in subs]
    assert [jsched.submit(p, m) for p, m in subs] == rids
    results, jresults = sched.run(), jsched.run()
    assert set(results) == set(rids) == set(jresults)
    assert all(len(results[r]) == m for r, (_, m) in zip(rids, subs))
    assert sched.history == jsched.history
    kinds = [h[0] for h in sched.history]
    assert "prefill" in kinds[kinds.index("decode"):]
    for a, b in zip(kinds, kinds[1:]):
        assert not (a == "prefill" and b == "prefill")
