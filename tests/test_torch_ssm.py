"""Port parity: the Mamba2 family (the SSD scan's plain version and CPU
dispatch, ``ssm_apply``, the model's forward, loss, prefill and decode, and
the serving engine and router over mamba2) against the reference.

SSD inputs are made by numpy from a seed; the reference runs its Pallas
kernel in interpret mode and its plain ``ref.ssd`` / ``ref.ssd_naive``, as
its own tests do.  Model parameters are the reference's own initialisation
(``repro.models.transformer.init_params``) of the mamba2-1.3b smoke config
(2 layers, d_model 256, 32 SSM heads of P 16, N 32, chunk 32, f32), carried
over with ``repro_torch.convert``.  Each framework runs its own f32 sums, so
results agree to the tolerances stated here, not to the bit.  The CUDA
kernel itself is held to the plain version in
``tests/test_torch_kernels_cuda.py`` on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import ContinuousScheduler as JContinuousScheduler
from repro.serving.router import GeoRouter as JGeoRouter
from repro.serving.router import ReplicaSpec as JReplicaSpec
from repro_torch import convert
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import route_and_submit
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serving.engine import ContinuousEngine, ContinuousScheduler
from repro_torch.serving.router import GeoRouter, ReplicaSpec

torch.set_num_threads(2)

JCFG = jget_arch("mamba2-1.3b").smoke
TCFG = tget_arch("mamba2-1.3b").smoke

# the reference kernel test's tolerances: y / max|y| and the final state
SSD_Y_TOL, SSD_STATE_TOL = 1e-5, 1e-3
# f32 on both sides; the tolerances cover summation-order differences.  The
# reference's initialisation gives logits up to ~50 (tied embeddings scaled
# by sqrt(d_model)), so their absolute tolerance is a fraction of max|logit|
LOGIT_ATOL_FRAC, LOGIT_RTOL = 1e-5, 1e-4
CACHE_ATOL, CACHE_RTOL = 1e-5, 1e-4

SSD_SHAPES = [(2, 128, 4, 16, 32, 32), (1, 256, 2, 64, 128, 64),
              (2, 64, 8, 8, 16, 64)]          # tests/test_kernels.py


def _ssd_inputs(B, S, H, P, N, seed, decay=0.1, init=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, S, H))) * decay).astype(np.float32)
    Bm = rng.normal(size=(B, S, H, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, H, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if init else None
    return x, a, Bm, Cm, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close_ssd(y, f, y_ref, f_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    scale = float(np.abs(y_ref).max())
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=SSD_Y_TOL)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               atol=SSD_STATE_TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_reference(B, S, H, P, N, chunk, init):
    arrays = _ssd_inputs(B, S, H, P, N, seed=S + N, init=init)
    x, a, Bm, Cm, s0 = _j(*arrays)
    jy, jf = jref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=s0)
    x, a, Bm, Cm, s0 = _t(*arrays)
    ty, tf = tref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=s0)
    assert ty.dtype == torch.float32 and tf.shape == (B, H, P, N)
    _close_ssd(ty, tf, jy, jf)
    # the CPU dispatch of the kernel wrapper is the plain version
    oy, of = ops.ssd_scan(x, a, Bm, Cm, chunk=chunk, init_state=s0)
    assert torch.equal(oy, ty) and torch.equal(of, tf)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_matches_reference_pallas_interpret(B, S, H, P, N, chunk):
    arrays = _ssd_inputs(B, S, H, P, N, seed=S * N)
    jy, jf = jssd_scan(*_j(*arrays[:4]), chunk=chunk, interpret=True)
    ty, tf = ops.ssd_scan(*_t(*arrays[:4]), chunk=chunk)
    _close_ssd(ty, tf, jy, jf)


def test_ssd_naive_matches_reference_and_anchors_chunked():
    # tests/test_kernels.py::test_ssd_chunked_matches_naive_recurrence
    arrays = _ssd_inputs(1, 64, 2, 8, 16, seed=3, decay=0.2, init=True)
    x, a, Bm, Cm, s0 = _t(*arrays)
    ny, nf = tref.ssd_naive(x, a, Bm, Cm, init_state=s0)
    jy, jf = jref.ssd_naive(*_j(*arrays[:4]), init_state=jnp.asarray(s0))
    np.testing.assert_allclose(ny.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(jf), atol=1e-5,
                               rtol=1e-5)
    cy, cf = tref.ssd(x, a, Bm, Cm, chunk=16, init_state=s0)
    np.testing.assert_allclose(cy.numpy(), ny.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cf.numpy(), nf.numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_with_initial_state_continues_stream():
    # tests/test_kernels.py::test_ssd_with_initial_state_continues_stream
    x, a, Bm, Cm, _ = _t(*_ssd_inputs(1, 128, 2, 8, 16, seed=4))
    y_full, f_full = ops.ssd_scan(x, a, Bm, Cm, chunk=32)
    y1, f1 = ops.ssd_scan(x[:, :64], a[:, :64], Bm[:, :64], Cm[:, :64],
                          chunk=32)
    y2, f2 = ops.ssd_scan(x[:, 64:], a[:, 64:], Bm[:, 64:], Cm[:, 64:],
                          chunk=32, init_state=f1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(f2, f_full, atol=1e-4, rtol=0)


def test_ssd_refuses_what_the_reference_refuses_and_gradients():
    x, a, Bm, Cm, _ = _ssd_inputs(1, 40, 2, 8, 16, seed=5)
    with pytest.raises(AssertionError):            # (40, 32)
        jref.ssd(*_j(x, a, Bm, Cm), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*_t(x, a, Bm, Cm), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tref.ssd(*_t(x, a, Bm, Cm), chunk=32)
    tx, ta, tB, tC = _t(*_ssd_inputs(1, 32, 2, 8, 16, seed=6)[:4])
    with pytest.raises(ValueError, match="state_dim"):
        ops.ssd_scan(tx, ta, torch.zeros(1, 32, 2, 256),
                     torch.zeros(1, 32, 2, 256))
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(tx, ta.double(), tB, tC)
    with pytest.raises(ValueError, match="float32"):    # x is f32 only
        ops.ssd_scan(tx.bfloat16(), ta, tB, tC)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.ssd_scan(tx.requires_grad_(), ta, tB, tC)
    with torch.no_grad():                          # no gradient: it runs
        ops.ssd_scan(tx, ta, tB, tC)
    assert ops.LAUNCHES["ssd_scan"] == 0           # the CPU path launches none


# ---------------------------------------------------------------------------
# the layer and the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    init = jax.jit(jtransformer.init_params, static_argnums=1)
    np_params = jax.tree.map(np.asarray, init(jax.random.key(0), JCFG))
    return np_params, convert.params_from_jax(np_params, TCFG, device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, size=shape).astype(np.int32)


def _layer0(np_params, tparams):
    jp = jax.tree.map(lambda x: x[0], np_params["blocks"]["pos0"]["ssm"])
    tp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv
                                                     in v.items()})
          for k, v in tparams["blocks"]["pos0"]["ssm"].items()}
    return jp, tp


def _close_logits(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL_FRAC * float(np.abs(j).max()))


def _close_cache(tc, jc):
    for t, j in zip(tc, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=CACHE_ATOL,
                                   rtol=CACHE_RTOL)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_apply_matches_reference(mamba, mode):
    jp, tp = _layer0(*mamba)
    S = {"train": 64, "prefill": 64, "decode": 1}[mode]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, S, JCFG.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode != "train":
        cache = jssm.init_ssm_cache(JCFG, 2)
        if mode == "decode":                       # a cache mid-stream
            cache = jax.tree.map(lambda c: jnp.asarray(
                rng.normal(size=c.shape).astype(np.float32)), cache)
        jcache = cache
        tcache = tssm.SSMCache(*(torch.from_numpy(np.array(c))
                                 for c in cache))
    jout, jnew = jssm.ssm_apply(jp, JCFG, jnp.asarray(x), jcache)
    for use_kernel in (False, True):
        with torch.no_grad():
            tout, tnew = tssm.ssm_apply(tp, TCFG, torch.from_numpy(x),
                                        tcache, use_kernel=use_kernel)
        _close_logits(tout, jout)
        if mode == "train":
            assert tnew is None
        else:
            _close_cache(tnew, jnew)


@pytest.mark.parametrize("use_ssm_kernel", [False, True])
def test_forward_and_loss_match_reference(mamba, use_ssm_kernel):
    np_params, tparams = mamba
    toks = _tokens((2, 64), seed=8)               # two chunks of 32
    labels = _tokens((2, 64), seed=9)
    jl, _ = jtransformer.forward(np_params, JCFG, jnp.asarray(toks),
                                 use_ssm_kernel=use_ssm_kernel)
    jloss, _ = jtransformer.loss_fn(
        np_params, JCFG, {"tokens": jnp.asarray(toks),
                          "labels": jnp.asarray(labels)},
        use_ssm_kernel=use_ssm_kernel)
    with torch.no_grad():
        tl, aux = ttransformer.forward(tparams, TCFG, torch.from_numpy(toks),
                                       use_ssm_kernel=use_ssm_kernel)
        tloss, metrics = ttransformer.loss_fn(
            tparams, TCFG, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)},
            use_ssm_kernel=use_ssm_kernel)
    _close_logits(tl, jl)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(metrics["ce"]) == float(tloss)


def test_ssm_kernel_path_refuses_gradients(mamba):
    _, tparams = mamba
    params = {"embed": tparams["embed"], "final_norm": tparams["final_norm"],
              "blocks": tparams["blocks"]}
    params["embed"] = {"tokens": tparams["embed"]["tokens"].clone()
                       .requires_grad_()}
    batch = {"tokens": torch.from_numpy(_tokens((1, 32), seed=10)),
             "labels": torch.from_numpy(_tokens((1, 32), seed=11))}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttransformer.loss_fn(params, TCFG, batch, use_ssm_kernel=True)
    loss, _ = ttransformer.loss_fn(params, TCFG, batch)
    loss.backward()                                # the plain path trains
    assert params["embed"]["tokens"].grad is not None


@pytest.mark.parametrize("S", [1, 2, 20, 64])
def test_prefill_matches_reference(mamba, S):
    # S 1 runs the recurrent step, S 2 a conv ring padded on the left,
    # S 20 one short chunk, S 64 two chunks
    np_params, tparams = mamba
    toks = _tokens((2, S), seed=12)
    jl, jc = jtransformer.prefill(np_params, JCFG, jnp.asarray(toks), 72)
    with torch.no_grad():
        tl, tc = ttransformer.prefill(tparams, TCFG, torch.from_numpy(toks),
                                      72)
    _close_logits(tl, jl)
    assert sorted(tc) == sorted(jc) == ["pos0"]
    assert isinstance(tc["pos0"], tssm.SSMCache)
    assert tc["pos0"].state.shape == (2, 2, 32, 16, 32)   # (G, B, H, P, N)
    assert tc["pos0"].conv.shape == (2, 2, 3, 576)        # (G, B, W-1, C)
    _close_cache(tc["pos0"], jc["pos0"])


def test_prefill_refuses_prompt_the_reference_refuses(mamba):
    np_params, tparams = mamba
    toks = _tokens((1, 40), seed=13)               # > chunk 32, not a multiple
    with pytest.raises(AssertionError):
        jtransformer.prefill(np_params, JCFG, jnp.asarray(toks), 48)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ttransformer.prefill(tparams, TCFG, torch.from_numpy(toks), 48)
    eng = ContinuousEngine(None, tparams, n_slots=2, cache_len=48, cfg=TCFG,
                           module="transformer")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        eng.insert(toks[0], 4, rid=0)
    assert eng.free_slots == [0, 1] and not eng.prefill_seconds


def test_decode_step_matches_reference(mamba):
    # the pool mid-stream, each slot at its own position (SSM positions
    # ignore them); the cache is updated in place
    np_params, tparams = mamba
    rng = np.random.default_rng(14)
    pool = jax.tree.map(
        lambda c: (0.5 * rng.normal(size=c.shape)).astype(np.float32),
        jtransformer.init_cache(JCFG, 3, 16))
    toks = _tokens((3, 1), seed=15)
    jl, jpool = jtransformer.decode_step(np_params, JCFG, jnp.asarray(toks),
                                         pool, jnp.int32(9))
    tpool = convert.cache_from_jax(pool, "cpu")
    assert isinstance(tpool["pos0"], tssm.SSMCache)
    with torch.no_grad():
        tl, out = ttransformer.decode_step(
            tparams, TCFG, torch.from_numpy(toks), tpool,
            torch.tensor([12, 5, 9], dtype=torch.int32))
    assert out is tpool
    _close_logits(tl, jl)
    _close_cache(tpool["pos0"], jpool["pos0"])


def test_decode_matches_forward(mamba):
    # tests/test_models.py::test_decode_matches_forward, for the port, and
    # the port's step logits against the reference's forward
    np_params, tparams = mamba
    S = 24
    toks = _tokens((1, S), seed=16)
    jfull, _ = jtransformer.forward(np_params, JCFG, jnp.asarray(toks))
    with torch.no_grad():
        full, _ = ttransformer.forward(tparams, TCFG, torch.from_numpy(toks))
        cache = ttransformer.init_cache(TCFG, 1, S, device="cpu")
        outs = []
        for t in range(S):
            logits, cache = ttransformer.decode_step(
                tparams, TCFG, torch.from_numpy(toks[:, t:t + 1]), cache, t)
            outs.append(logits[:, 0])
    steps = torch.stack(outs, dim=1).numpy()
    np.testing.assert_allclose(steps, full.numpy(), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(steps, np.asarray(jfull), atol=2e-3,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_tokens_and_step_logits_match_reference(mamba):
    # the reference engine's greedy tokens; the port's engine must emit the
    # same ones, and the same tokens teacher-forced through the port's
    # prefill + decode must give the reference's forward logits per step
    np_params, tparams = mamba
    prompt = _tokens((24,), seed=17)     # prompt + 7 fed back <= one chunk
    n_new = 8
    jeng = JContinuousEngine(None, np_params, n_slots=2, cache_len=48,
                             cfg=JCFG, module="transformer")
    teng = ContinuousEngine(None, tparams, n_slots=2, cache_len=48,
                            cfg=TCFG, module="transformer")
    got = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        eng.insert(prompt, n_new, rid=0)
        while name not in got:
            for f in eng.step():
                got[name] = f.tokens
    jtoks = got["jax"]
    assert jtoks.size == n_new

    full = np.concatenate([prompt, jtoks[:-1]])[None]
    jlogits, _ = jtransformer.forward(np_params, JCFG, jnp.asarray(full))
    jlogits = np.asarray(jlogits)[0, prompt.size - 1:, : JCFG.vocab_size]
    with torch.no_grad():
        logits, cache = ttransformer.prefill(
            tparams, TCFG, torch.from_numpy(prompt)[None], 48)
        tlogits = [logits[0]]
        for i, tok in enumerate(jtoks[:-1]):
            logits, cache = ttransformer.decode_step(
                tparams, TCFG, torch.tensor([[int(tok)]], dtype=torch.int32),
                cache, prompt.size + i)
            tlogits.append(logits[0, 0])
    tlogits = torch.stack(tlogits)[:, : TCFG.vocab_size].numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=2e-3, rtol=2e-2)
    # every step's top-2 margin is wider than the tolerance can move, so
    # the tokens must agree one for one
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    assert ((top2[:, 1] - top2[:, 0]) > 2e-3 + 2e-2 * top2[:, 1]).all()
    np.testing.assert_array_equal(got["torch"], jtoks)


def test_router_and_schedulers_match_reference(mamba):
    # two replicas behind a balanced GeoRouter, each a continuous scheduler
    # over a 2-slot pool: the same placements, interleavings and tokens
    np_params, tparams = mamba
    regions = ("us-east", "eu-west")
    out = {}
    for name, (router_cls, spec_cls, sched_cls, eng_cls, params, cfg) in {
            "jax": (JGeoRouter, JReplicaSpec, JContinuousScheduler,
                    JContinuousEngine, np_params, JCFG),
            "torch": (GeoRouter, ReplicaSpec, ContinuousScheduler,
                      ContinuousEngine, tparams, TCFG)}.items():
        router = router_cls([spec_cls(region=r, n_slots=2) for r in regions],
                            mode="balanced")
        scheds = {r: sched_cls(eng_cls(None, params, n_slots=2,
                                       cache_len=40, cfg=cfg,
                                       module="transformer"))
                  for r in regions}
        placed = route_and_submit(router, scheds, regions, 5, 32, 4,
                                  cfg.vocab_size, seed=0)
        by_region = {r: s.run() for r, s in scheds.items()}
        out[name] = ({rid: (p[0], p[1]) for rid, p in placed.items()},
                     {rid: by_region[p[0]][p[1]] for rid, p in placed.items()},
                     {r: s.history for r, s in scheds.items()})
    (jplaced, jres, jhist), (tplaced, tres, thist) = out["jax"], out["torch"]
    assert tplaced == jplaced and len(set(p[0] for p in tplaced.values())) == 2
    assert thist == jhist
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid])


def test_decode_bit_identical_under_concurrent_insert(mamba):
    _, tparams = mamba
    pa, pb = _tokens((32,), seed=18), _tokens((20,), seed=19)

    def engine():
        return ContinuousEngine(None, tparams, n_slots=2, cache_len=48,
                                cfg=TCFG, module="transformer")

    alone = engine()
    alone.insert(pa, 8, rid=0)
    ref = None
    while ref is None:
        for f in alone.step():
            ref = f.tokens
    shared = engine()
    shared.insert(pa, 8, rid=0)
    shared.step()                       # slot 0 decodes alone once...
    shared.insert(pb, 8, rid=1)         # ...then a neighbour moves in
    got = {}
    while len(got) < 2:
        for f in shared.step():
            got[f.rid] = f.tokens
    np.testing.assert_array_equal(got[0], ref)
