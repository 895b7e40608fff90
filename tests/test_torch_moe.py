"""Port parity: the MoE FFN (``repro_torch.models.moe``) and the MoE
decoders (qwen3-moe and kimi-k2 smoke configs) against ``repro.models.moe``
and ``repro.models.transformer``.

Both sides get the same parameters (the JAX tree converted with
``repro_torch.convert``) and the same inputs.  Each framework runs its own
f32 matmuls and transcendentals, whose last bits differ, so on random
inputs the outputs, aux losses and gradients agree to the tolerances stated
here.  The dispatch itself (routing, ties, ranks within an expert, capacity
drops, the combine's order) is held bit for bit on *exact* inputs: small
integers and one-hot router inputs, on which every product, sum, softmax
and SiLU both frameworks compute is exact, so any difference in which token
reaches which capacity slot, or in which contributions are summed, shows
(the one inexact number there is ``log(E)`` in the tie case's z-loss and
entropy, held to the aux tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.config import MoEConfig as JMoEConfig
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.serving.engine import ContinuousEngine

torch.set_num_threads(2)

NAMES = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
DISPATCH = ["global", "grouped"]
B, S = 2, 32

# f32 on both sides: summation-order and transcendental differences
Y_ATOL_FRAC, Y_RTOL = 1e-5, 1e-5         # atol = frac * max|y|
AUX_RTOL = 1e-5
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4   # atol = frac * max|grad| per leaf


def _cfgs(name="qwen3-moe-30b-a3b", **kw):
    return (jget_arch(name).smoke.replace(**kw),
            tget_arch(name).smoke.replace(**kw))


def _np_moe(jcfg, seed=0):
    init = jax.jit(jmoe.moe_init, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg))


def _t(tree):
    return T.tree_map(lambda a: convert.to_tensor(a, "cpu"), tree)


def _exact_inputs(jcfg, case, seed=0):
    """x ``(B, S, D)`` and MoE parameters on which both frameworks compute
    exactly.  x's first E columns are one-hot router inputs (``case``
    "ties": all zero), column E is 1 and the rest 0/1; the router maps
    the one-hot column e to a logit of 200 for expert e (softmax exactly 1
    for it, exactly 0 for the rest; "ties": a zero router, every
    probability exactly 1/E).  The experts' gate products are integers of
    at least 20 (SiLU(g) == g in f32), the up products small integers, the
    down projection sparse 0/1, so every expert output is an exact
    integer."""
    rng = np.random.default_rng(seed)
    E, D, F = jcfg.moe.num_experts, jcfg.d_model, jcfg.d_ff
    x = np.zeros((B, S, D), np.float32)
    if case != "ties":
        x[np.arange(B)[:, None], np.arange(S)[None],
          rng.integers(0, E, size=(B, S))] = 1.0
    x[..., E] = 1.0
    x[..., E + 1:] = rng.integers(0, 2, size=(B, S, D - E - 1))
    router = np.zeros((D, E), np.float32)
    if case != "ties":
        router[np.arange(E), np.arange(E)] = 200.0
    wg = rng.integers(0, 2, size=(E, D, F)).astype(np.float32)
    wg[:, :E + 1] = 0.0
    wg[:, E] = 20.0
    wu = rng.integers(-1, 2, size=(E, D, F)).astype(np.float32)
    wu[:, :E] = 0.0
    wd = (rng.random(size=(E, F, D)) < 1 / 64).astype(np.float32)
    return x, {"router": router, "wg": wg, "wu": wu, "wd": wd}


@pytest.mark.parametrize("case", ["routed", "ties", "drops"])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_dispatch_bit_equal_on_exact_inputs(dispatch, case):
    cf = 0.1 if case == "drops" else 1.25
    moe = dict(num_experts=4, top_k=2, capacity_factor=cf)
    jcfg, tcfg = _cfgs(moe=JMoEConfig(**moe), moe_dispatch=dispatch)
    tcfg = tcfg.replace(moe=TMoEConfig(**moe))
    x, p = _exact_inputs(jcfg, case)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                              jnp.asarray(x))
    ty, taux = tmoe.moe_apply(_t(p), tcfg, torch.from_numpy(x))
    jy = np.asarray(jy)
    assert np.abs(jy).max() > 0
    np.testing.assert_array_equal(ty.numpy(), jy)
    np.testing.assert_array_equal(taux["lb_loss"].numpy(),
                                  np.asarray(jaux["lb_loss"]))
    for k in ("z_loss", "router_entropy"):
        if case == "ties":   # log(E): each framework's log rounds it
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=AUX_RTOL)
        else:                # log(1) and 0 * log(1e-9): exact
            np.testing.assert_array_equal(taux[k].numpy(),
                                          np.asarray(jaux[k]))
    dropped = (np.abs(jy) == 0).all(-1).mean()
    if case == "drops":   # as the reference's test_moe_capacity_drops_tokens
        assert dropped > 0.3
    if case == "ties":    # every token ties: experts 0 and 1, C of them kept
        n = B * S if dispatch == "global" else S
        assert jmoe.expert_capacity(n, jcfg) < n and dropped > 0


@pytest.mark.parametrize("n", [1, 2, 7, 16, 64, 100, 2048, 4096])
@pytest.mark.parametrize("name", NAMES)
def test_expert_capacity_matches_reference(name, n):
    jcfg, tcfg = _cfgs(name)
    for j, t in ((jcfg, tcfg), (jget_arch(name).config,
                                tget_arch(name).config)):
        assert tmoe.expert_capacity(n, t) == jmoe.expert_capacity(n, j)


@pytest.mark.parametrize("cf", [1.25, 0.1])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_apply_matches_reference(dispatch, cf):
    moe = dict(num_experts=4, top_k=2, capacity_factor=cf)
    jcfg, tcfg = _cfgs(moe=JMoEConfig(**moe), moe_dispatch=dispatch)
    tcfg = tcfg.replace(moe=TMoEConfig(**moe))
    p = _np_moe(jcfg)
    x = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(p, x)
    ty, taux = tmoe.moe_apply(_t(p), tcfg, torch.from_numpy(x))
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=Y_RTOL,
                               atol=Y_ATOL_FRAC * float(np.abs(jy).max()))
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL)


# bf16, the dtype qwen3-moe is served in, at its own routing (128 experts,
# top-8) and smoke widths.  On a natural router (``moe_init``'s) the
# reference runs op by op: under ``jax.jit`` XLA on the CPU computes the
# router product with an f32 result instead of rounding it to bf16 as the
# code writes it (logits up to 7.8e-3 apart; on seed 1 one token of 64
# takes another eighth expert, a gap of 0.25 on max|y| 1.05), which the
# port, rounding as written, does not follow.  Op by op the routing is
# equal, and over seeds 0-5 and both dispatches the outputs differ by at
# most half a bf16 step of max|y| (at most 26 of 16384 elements differ):
# the experts' products round their f32 accumulations to bf16.  They are
# held to one step.
QWEN3_MOE = dict(num_experts=128, top_k=8)
BF16_AUX_RTOL = 1e-6      # measured at most 2.1e-7


def _bf16_step(y: np.ndarray) -> float:
    """One bf16 step (8 significant bits) at max|y|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7))


def _qwen3_bf16_cfgs(dispatch):
    kw = dict(moe_dispatch=dispatch, param_dtype="bfloat16",
              compute_dtype="bfloat16")
    jcfg, tcfg = _cfgs(moe=JMoEConfig(**QWEN3_MOE), **kw)
    assert (tget_arch("qwen3-moe-30b-a3b").config.moe.top_k
            == QWEN3_MOE["top_k"])
    return jcfg, tcfg.replace(moe=TMoEConfig(**QWEN3_MOE))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_apply_matches_reference_in_bf16(dispatch, seed):
    jcfg, tcfg = _qwen3_bf16_cfgs(dispatch)
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                     _np_moe(jcfg, seed=seed))
    x = np.random.default_rng(seed + 10).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, jaux = jmoe.moe_apply(p, jcfg, xb)
    tp = _t(jax.tree.map(np.asarray, p))
    tx = convert.to_tensor(np.asarray(xb), "cpu")
    ty, taux = tmoe.moe_apply(tp, tcfg, tx)
    assert ty.dtype == torch.bfloat16
    # the same eight experts for every token
    logits = (xb.reshape(B * S, -1) @ p["router"]).astype(jnp.float32)
    _, je = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 8)
    _, te, _ = tmoe._route(tp, tcfg, tx.reshape(1, B * S, -1))
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je))
    jy = np.asarray(jy).astype(np.float32)
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                               atol=_bf16_step(jy))
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=BF16_AUX_RTOL)


def _exact_bf16_inputs(jcfg, case, seed=0):
    """:func:`_exact_inputs` at top-8 in bf16: each token's router input
    is eight-hot, so its eight experts get probability 1/8 exactly (the
    rest exp(-200), 0 in f32) and weight 0.125; every expert output is an
    integer that bf16 holds, and weighted by 0.125 it stays exact.  The
    combine then adds eight bf16 terms of up to ~2600 with one rounding per
    add, so its order decides the last bits.  ``case`` "drops" routes every
    token among 12 experts, over their capacity of 8."""
    rng = np.random.default_rng(seed)
    E, K, D, F = (jcfg.moe.num_experts, jcfg.moe.top_k, jcfg.d_model,
                  jcfg.d_ff)
    pool = 12 if case == "drops" else E
    x = np.zeros((B, S, D), np.float32)
    for b in range(B):
        for s in range(S):
            x[b, s, rng.choice(pool, K, replace=False)] = 1.0
    x[..., E] = 1.0
    x[..., E + 1:] = rng.integers(0, 2, size=(B, S, D - E - 1))
    router = np.zeros((D, E), np.float32)
    router[np.arange(E), np.arange(E)] = 200.0
    wg = rng.integers(0, 2, size=(E, D, F)).astype(np.float32)
    wg[:, :E + 1] = 0.0
    wg[:, E] = 20.0
    wu = rng.integers(-1, 2, size=(E, D, F)).astype(np.float32)
    wu[:, :E + 1] = 0.0
    wd = (rng.random(size=(E, F, D)) < 1 / 16).astype(np.float32)
    return x, {"router": router, "wg": wg, "wu": wu, "wd": wd}


@pytest.mark.parametrize("case", ["routed", "drops"])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_combine_order_bit_equal_in_bf16(dispatch, case):
    """The combine's order at top-8 in bf16, bit for bit: a sum of the
    same eight contributions in another order rounds differently."""
    jcfg, tcfg = _qwen3_bf16_cfgs(dispatch)
    x, p = _exact_bf16_inputs(jcfg, case)
    p = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, _ = jmoe.moe_apply(p, jcfg, xb)
    ty, _ = tmoe.moe_apply(_t(jax.tree.map(np.asarray, p)), tcfg,
                           convert.to_tensor(np.asarray(xb), "cpu"))
    jy = np.asarray(jy).astype(np.float32)
    assert np.abs(jy).max() > 256     # above bf16's exact integers
    np.testing.assert_array_equal(ty.float().numpy(), jy)
    dropped = (jy == 0).all(-1).mean()
    assert (dropped > 0.3) if case == "drops" else dropped == 0


def test_zero_router_ties_pick_the_lowest_experts():
    # a zero router ties every expert: the reference's top_k keeps the
    # lower ids, so every token goes to experts 0..K-1 with equal weights
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    p = _np_moe(jcfg)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(2).normal(size=(1, 4, jcfg.d_model)).astype(
        np.float32)
    tp = _t(p)
    top_p, top_e, _ = tmoe._route(tp, tcfg, torch.from_numpy(x))
    K = tcfg.moe.top_k
    assert top_e.tolist() == [[list(range(K))] * 4]
    assert torch.equal(top_p, torch.full_like(top_p, 1.0 / K))
    jy, _ = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
    ty, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=Y_RTOL,
                               atol=Y_ATOL_FRAC * float(np.abs(jy).max()))


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_grads_match_reference(dispatch):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch)
    p = _np_moe(jcfg, seed=3)
    x = np.random.default_rng(4).normal(size=(1, 16, jcfg.d_model)).astype(
        np.float32)

    def jf(p, x):
        y, aux = jmoe.moe_apply(p, jcfg, x)
        return jnp.sum(y ** 2) + jmoe.moe_loss(aux, jcfg)

    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(p, x)
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tcfg, tx)
    loss = torch.sum(y ** 2) + tmoe.moe_loss(aux, tcfg)
    tg = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)] + [tx])
    want = [np.asarray(jg[0][k]) for k in sorted(tp)] + [np.asarray(jg[1])]
    for name, a, b in zip(sorted(tp) + ["x"], want, tg):
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(a).max()), err_msg=name)
    assert float(tg[sorted(tp).index("router")].abs().max()) > 0


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(name):
    for j, t in ((jget_arch(name).config, tget_arch(name).config),
                 (jget_arch(name).smoke, tget_arch(name).smoke)):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.moe.num_experts, t.moe.top_k, t.moe.capacity_factor) == \
            (j.moe.num_experts, j.moe.top_k, j.moe.capacity_factor)
        for f in ("d_model", "n_heads", "n_kv_heads", "resolved_head_dim",
                  "d_ff", "vocab_size", "n_layers", "rope_theta",
                  "moe_dispatch"):
            assert getattr(t, f) == getattr(j, f)


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    toks = _tokens(jcfg, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    mask[1, -5:] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    jlogits, jaux = jax.jit(lambda p, t: jtransformer.forward(p, jcfg, t))(
        np_params, batch["tokens"])
    jloss, jm = jax.jit(lambda p, b: jtransformer.loss_fn(p, jcfg, b))(
        np_params, batch)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, taux = ttransformer.forward(tp, tcfg, tb["tokens"])
    tloss, tm = ttransformer.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tloss) > float(tm["ce"])        # moe_loss is in the total
    for k in ("ce", "lb_loss", "z_loss", "router_entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=AUX_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_model_grads_match(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg, seed=4)
    toks = _tokens(jcfg, (B, 17), seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jgrads = jax.jit(jax.grad(
        lambda p, b: jtransformer.loss_fn(p, jcfg, b)[0]))(np_params, batch)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    leaves = [x.requires_grad_(True) for x in T.leaves(tp)]
    tloss, _ = ttransformer.loss_fn(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    for (path, _), a, b in zip(T.leaves_with_path(tp),
                               jax.tree.leaves(jgrads), tgrads):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(a).max()), err_msg=path)
        if "router" in path:
            assert float(b.abs().max()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_match(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg, seed=6)
    prompt, cont = _tokens(jcfg, (B, 20), seed=7), _tokens(jcfg, (B, 4), 8)
    cache_len = 32
    jlogits, jcache = jax.jit(lambda p, t: jtransformer.prefill(
        p, jcfg, t, cache_len))(np_params, prompt)
    tp = convert.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        tlogits, tcache = ttransformer.prefill(tp, tcfg,
                                               torch.from_numpy(prompt),
                                               cache_len)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    jstep = jax.jit(lambda p, t, c, pos: jtransformer.decode_step(
        p, jcfg, t, c, pos))
    for i in range(cont.shape[1]):
        pos = prompt.shape[1] + i
        jl, jcache = jstep(np_params, cont[:, i:i + 1], jcache,
                           jnp.int32(pos))
        with torch.no_grad():
            tl, tcache = ttransformer.decode_step(
                tp, tcfg, torch.from_numpy(cont[:, i:i + 1]), tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


# ---------------------------------------------------------------------------
# the slot pool: every slot routed alone
# ---------------------------------------------------------------------------

POOL = 16
# qwen3's smoke MoE (4 experts, top-2) at capacity factor 0.25: 16 tokens
# routed together get a capacity of 8 per expert, one token alone 8 as well
POOL_MOE = dict(num_experts=4, top_k=2, capacity_factor=0.25)


@pytest.fixture(scope="module")
def colliding():
    """qwen3's smoke decoder with a zero router at every MoE position: every
    token ties and goes to experts 0 and 1, so a pool's slots collide."""
    jcfg, tcfg = _cfgs(moe=JMoEConfig(**POOL_MOE))
    tcfg = tcfg.replace(moe=TMoEConfig(**POOL_MOE))
    np_params = _np_params(jcfg, seed=9)
    for pos in np_params["blocks"].values():
        pos["moe"]["router"] = np.zeros_like(pos["moe"]["router"])
    return jcfg, tcfg, np_params, convert.params_from_jax(
        np_params, tcfg, device="cpu")


def _run_pool(eng, prompts, n_new):
    for rid, p in enumerate(prompts):
        eng.insert(p, n_new, rid=rid)
    out = {}
    while eng.live_slots:
        for f in eng.step():
            out[f.rid] = f.tokens
    return out


def test_pool_routes_each_slot_alone_as_the_reference_vmap(colliding):
    jcfg, tcfg, np_params, tp = colliding
    prompts = [_tokens(jcfg, (6 + i,), seed=20 + i) for i in range(POOL)]
    n_new = 5
    jeng = JContinuousEngine(None, np_params, n_slots=POOL, cache_len=32,
                             cfg=jcfg, module="transformer")
    teng = ContinuousEngine(None, tp, n_slots=POOL, cache_len=32, cfg=tcfg,
                            module="transformer")
    jout, tout = _run_pool(jeng, prompts, n_new), _run_pool(teng, prompts,
                                                            n_new)
    assert sorted(tout) == sorted(jout) == list(range(POOL))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    # each request alone in the same pool gives its tokens bit for bit
    for rid in (0, POOL - 1):
        solo = ContinuousEngine(None, tp, n_slots=POOL, cache_len=32,
                                cfg=tcfg, module="transformer")
        np.testing.assert_array_equal(
            _run_pool(solo, [prompts[rid]], n_new)[0], tout[rid])

    # the same 16 tokens routed together overflow experts 0 and 1: the
    # pool's per-row routing is what keeps them
    C = tmoe.expert_capacity(POOL, tcfg)
    assert C < POOL and tmoe.expert_capacity(1, tcfg) >= 1
    cache = ttransformer.init_cache(tcfg, POOL, 32, device="cpu")
    tok = torch.from_numpy(np.stack([p[:1] for p in prompts]))
    with torch.no_grad():
        rows, _ = ttransformer.decode_step(
            tp, tcfg, tok, T.tree_map(torch.clone, cache), 0,
            moe_per_row=True)
        together, _ = ttransformer.decode_step(
            tp, tcfg, tok, T.tree_map(torch.clone, cache), 0)
    np.testing.assert_allclose(rows[:C].numpy(), together[:C].numpy(),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    gap = (rows[C:] - together[C:]).abs().amax(dim=(1, 2))
    assert bool((gap > 100 * LOGIT_ATOL).all())


# ---------------------------------------------------------------------------
# training: the MoE objective through the codec round, routers bucketed
# ---------------------------------------------------------------------------

TRAIN_FLAGS = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--pods", "2",
               "--steps", "6", "--batch", "8", "--seq", "32",
               "--interval", "2", "--compress-topk", "0.05", "--int8",
               "--error-feedback", "--bucket-policy", "layer-class",
               "--bucket-patterns", "moe-router", "--log-every", "0"]
# f32 over 6 steps and 3 codec rounds (each side's top-k over its own
# gradients)
TRAIN_LOSS_RTOL = 1e-4


def test_train_launcher_moe_router_buckets_match_reference():
    import contextlib
    import io

    from repro.launch import train as jtrain
    from repro.models.registry import get_model_fns
    from repro_torch.launch import train as ttrain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js = jtrain.main(TRAIN_FLAGS)
    jlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[train] ")]
    jcfg, tcfg = _cfgs()
    jparams = get_model_fns("transformer").init_params(jax.random.key(0),
                                                       jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = ttrain.main(TRAIN_FLAGS + ["--device", "cpu"],
                         init_params=tparams)
    tlines = [line for line in buf.getvalue().splitlines()
              if line.startswith("[train] ")]
    # the same parameter count, payload and bucket groups (the experts in
    # "moe", the routers in their own "router" group)
    assert tlines[0].rsplit(", device", 1)[0] == jlines[0]
    assert tlines[1:] == jlines[1:]
    groups = dict(part.split(" (")[0].rsplit(" ", 2)[:2]
                  for part in tlines[-1].split(": ", 1)[1].split("), "))
    assert set(groups) == {"embed", "norm", "dense", "moe", "router"}
    assert float(groups["moe"]) > 0
    for key in ("loss_first", "loss_last"):
        assert np.isfinite(ts[key])
        np.testing.assert_allclose(ts[key], js[key], rtol=TRAIN_LOSS_RTOL)
    assert ts["wan_traffic_mb"] == pytest.approx(js["wan_traffic_mb"])
