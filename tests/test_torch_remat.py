"""Port parity: ``cfg.remat``, the per-group activation checkpointing of
``repro_torch.models.transformer.forward``, against ``repro.models``'
``_maybe_remat`` (``jax.checkpoint`` with ``nothing_saveable`` or
``dots_with_no_batch_dims_saveable``).

Recompute runs the same operations on the same inputs, so within the port
the gradients under ``"none"``, ``"full"`` and ``"dots"`` are equal bit for
bit (the CPU's kernels are deterministic); against the reference under the
same policy they agree to the tolerance stated here (f32, each framework's
own summation order).  Five smoke configs cover every position kind the
recompute must reproduce: dense attention (granite, qwen2-vl with M-RoPE
and patch embeddings), MoE routing with its stable sort and fixed capacity
(qwen3-moe), the SSD scan (mamba2) and a hybrid group of both (jamba).

What a policy keeps is measured as the bytes of every storage that an
operation of the forward allocated and that is still alive when the
forward returns: what autograd holds for the backward (the outputs, the
same under every policy, included).  An outer ``saved_tensors_hooks``
cannot see this: the checkpoint installs its own hooks inside each group,
and the selective policy keeps its products in a cache of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(2)

NAMES = ["granite-8b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
         "jamba-1.5-large-398b", "qwen2-vl-2b"]
POLICIES = ["none", "full", "dots"]
B, S = 2, 32                              # S = the smoke SSD chunk

# f32 on both sides; the tolerance covers summation-order differences
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4   # atol = frac * max|grad| per leaf


def _np_params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        jtransformer.abstract_params(jcfg))


def _batch(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.vision_patches:
        batch["patch_emb"] = (0.02 * rng.normal(
            size=(B, jcfg.vision_patches, jcfg.d_model))).astype(np.float32)
    return batch


def _port_grads(tparams, tcfg, batch):
    tp = T.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    loss, _ = ttransformer.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    return float(loss.detach()), torch.autograd.grad(loss, T.leaves(tp))


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    jcfg = jget_arch(request.param).smoke
    tcfg = tget_arch(request.param).smoke
    np_params = _np_params(jcfg)
    return (jcfg, tcfg, np_params,
            convert.params_from_jax(np_params, tcfg, device="cpu"),
            _batch(jcfg))


def test_port_grads_bit_equal_across_policies(model):
    _, tcfg, _, tparams, batch = model
    losses, grads = zip(*(_port_grads(tparams, tcfg.replace(remat=r), batch)
                          for r in POLICIES))
    assert losses[0] == losses[1] == losses[2]
    for r, g in zip(POLICIES[1:], grads[1:]):
        for (path, _), a, b in zip(T.leaves_with_path(tparams), grads[0], g):
            assert torch.equal(a, b), (r, path)


@pytest.mark.parametrize("remat", POLICIES)
def test_grads_match_reference_under_the_same_policy(model, remat):
    jcfg, tcfg, np_params, tparams, batch = model
    jcfg = jcfg.replace(remat=remat)
    jgrads = jax.jit(jax.grad(lambda p, b: jtransformer.loss_fn(
        p, jcfg, b)[0]))(np_params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    _, tgrads = _port_grads(tparams, tcfg.replace(remat=remat), batch)
    for (path, _), a, b in zip(T.leaves_with_path(tparams),
                               jax.tree.leaves(jgrads), tgrads):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(a).max()), err_msg=path)


class _LiveStorages(TorchDispatchMode):
    """Every storage an operation allocates, outside ``skip`` (the
    parameters' and the batch's), by a weak reference and its bytes."""

    def __init__(self, skip):
        super().__init__()
        self.skip, self.refs = skip, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                ref = StorageWeakRef(st)
                if ref.cdata not in self.skip:
                    self.refs[ref.cdata] = (ref, st.nbytes())
        return out

    def alive_bytes(self) -> int:
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _kept_bytes(tparams, tcfg, batch) -> int:
    tp = T.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    skip = {StorageWeakRef(x.untyped_storage()).cdata
            for x in T.leaves(tp) + list(tb.values())}
    mode = _LiveStorages(skip)
    with mode:
        loss, _ = ttransformer.loss_fn(tp, tcfg, tb)
    kept = mode.alive_bytes()
    torch.autograd.grad(loss, T.leaves(tp))       # the graph is whole
    return kept


def test_kept_bytes_order_full_dots_none(model):
    _, tcfg, _, tparams, batch = model
    full, dots, none = (_kept_bytes(tparams, tcfg.replace(remat=r), batch)
                        for r in ("full", "dots", "none"))
    assert 0 < full < dots < none, (full, dots, none)


def test_no_grad_forward_checkpoints_nothing(model, monkeypatch):
    _, tcfg, _, tparams, batch = model
    calls = []
    real = ttransformer.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("context_fn"))
        return real(*args, **kw)

    monkeypatch.setattr(ttransformer, "checkpoint", counted)
    toks = torch.from_numpy(batch["tokens"])
    for remat in POLICIES:
        with torch.no_grad():
            ttransformer.forward(tparams, tcfg.replace(remat=remat), toks)
    assert calls == []
    tp = T.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    for remat in POLICIES:
        ttransformer.forward(tp, tcfg.replace(remat=remat), toks)
    # one checkpoint per group under "full" and "dots", the selective
    # policy only under "dots"
    n = tcfg.n_groups
    assert calls[:n] == [None] * n
    assert calls[n:] == [ttransformer._DOTS] * n
