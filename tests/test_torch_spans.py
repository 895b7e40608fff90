"""The port's spans and counters (``repro_torch.spans``) on the CPU.

With no profiler the spans are one shared no-op and the counters record
nothing; under ``torch.profiler`` a 2-pod ASGD-GA step and round through
the codec emit every ``ct.`` span in its place and count, and the run's
numbers are bit for bit those of the run without a profiler; the
``moe.slots.*`` counters equal a count made from the router's choices.
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch import tree as T
from repro_torch.configs import get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

N_PODS, INTERVAL, PER_POD, SEQ = 2, 2, 2, 16
CODEC = dict(compress_topk=0.05, quantize_int8=True, error_feedback=True)
STEP_SPANS = {"ct.step.forward": N_PODS, "ct.step.backward": N_PODS,
              "ct.step.grads": 1, "ct.step.accumulate": 1,
              "ct.step.optimizer": 1, "ct.step.metrics": 2}
ROUND_SPANS = {"ct.round.pack": 1, "ct.round.encode": 1,
               "ct.round.ship": 1, "ct.round.decode": 1,
               "ct.round.apply": 1}
MOE_SPANS = ("ct.moe.route", "ct.moe.dispatch", "ct.moe.experts",
             "ct.moe.combine")


def _trainer(arch):
    cfg = get_arch(arch).smoke
    tr = Trainer(lambda p, b: transformer.loss_fn(p, cfg, b),
                 lambda g: transformer.init_params(g, cfg, "cpu"),
                 TrainerConfig(n_pods=N_PODS, lr=0.05,
                               sync=SyncConfig("asgd_ga", INTERVAL,
                                               **CODEC)),
                 device="cpu")
    return cfg, tr


def _batch(cfg, step):
    parts = [TokenStream(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         batch_size=PER_POD, seed=3, shard=p,
                         n_shards=N_PODS).batch(step)
             for p in range(N_PODS)]
    return {k: torch.from_numpy(np.stack([b[k] for b in parts]))
            for k in parts[0]}


def _run(arch, steps=INTERVAL):
    """``steps`` steps, each followed by ``maybe_sync`` -> (state, losses)."""
    cfg, tr = _trainer(arch)
    state = tr.init_state(0)
    losses = []
    for step in range(steps):
        state, metrics = tr.train_step(state, _batch(cfg, step))
        state = tr.maybe_sync(state, step)
        losses.append(metrics["loss_per_pod"])
    return state, losses


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


def _ct_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(spans.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


def test_no_profiler_no_record_function(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(spans, "record_function", boom)
    assert spans.span("step") is spans.span("round") is spans._NULL
    spans.reset()
    spans.add("moe.slots.kept", torch.tensor(3))
    spans.add("moe.slots.rows", 8)
    _run("qwen3-moe-30b-a3b")
    assert spans.read() == {}


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_step_and_round_spans_nest_and_count(arch):
    cfg = get_arch(arch).smoke
    _, events = _profiled(lambda: _run(arch))
    got = Counter(e.name for e in events)
    moe_calls = N_PODS * INTERVAL * sum(
        s.moe for s in cfg.pattern) * (cfg.n_layers // len(cfg.pattern))
    want = Counter({"ct.step": INTERVAL, "ct.round": 1,
                    "ct.round.norms": 1})
    want.update({k: v * INTERVAL for k, v in STEP_SPANS.items()})
    want.update(ROUND_SPANS)
    want.update({k: moe_calls for k in MOE_SPANS if moe_calls})
    assert got == want
    parent = dict.fromkeys(STEP_SPANS, "ct.step")
    parent.update(dict.fromkeys(ROUND_SPANS, "ct.round"))
    parent.update(dict.fromkeys(MOE_SPANS, "ct.step.forward"))
    parent.update({"ct.step": None, "ct.round": None,
                   "ct.round.norms": "ct.round.apply"})
    for e in events:
        assert _ct_parent(e) == parent[e.name], e.name
    # the round's spans on the sync step only: after the last step's span
    last_step = max(e.time_range.start for e in events if e.name == "ct.step")
    assert all(e.time_range.start > last_step for e in events
               if e.name.startswith("ct.round"))


def test_profiler_changes_no_bit():
    def leaves(out):
        state, losses = out
        return (T.leaves(state.params) + T.leaves(state.sync_state.ga_buffer)
                + [state.sync_state.ef_residual] + losses)

    plain = leaves(_run("qwen3-moe-30b-a3b", steps=INTERVAL + 1))
    traced, _ = _profiled(lambda: _run("qwen3-moe-30b-a3b",
                                       steps=INTERVAL + 1))
    traced = leaves(traced)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_row", [False, True])
def test_moe_slots_count_the_routers_choices(per_row):
    cfg = get_arch("qwen3-moe-30b-a3b").smoke.replace(
        moe_dispatch="global")
    # a capacity below the load, so that some choices are dropped
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg, "cpu")
    B, S, D = 3, 16, cfg.d_model
    x = torch.randn(B, S, D, generator=gen)
    spans.reset()
    _profiled(lambda: moe.moe_apply(params, cfg, x, per_row=per_row))
    got = spans.read()
    spans.reset()

    E, K = cfg.moe.num_experts, cfg.moe.top_k
    groups = x if per_row else x.reshape(1, B * S, D)
    G, T_ = groups.shape[:2]
    C = moe.expert_capacity(T_, cfg)
    _, top_e, _ = moe._route(params, cfg, groups)
    kept = sum(min(int((top_e[g] == e).sum()), C)
               for g in range(G) for e in range(E))
    assert got == {"moe.slots.kept": kept, "moe.slots.routed": G * T_ * K,
                   "moe.slots.rows": G * E * C}
    assert kept < G * T_ * K          # the capacity dropped some
