"""Port parity: the models' axis trees, their abstract parameters and the
train state's spec tree, against the reference, leaf for leaf by path.

- ``param_logical_axes`` and ``cache_logical_axes`` of every arch equal the
  reference's;
- ``abstract_params`` (meta tensors) have the reference's shapes and dtypes
  (``jax.eval_shape`` of its init);
- ``spec_tree_for_params(train_state_axes(...))`` under ``train_rules()``
  on the fake ``(2, 2, 2)`` and ``(2, 16, 16)`` meshes equals the
  reference's ``PartitionSpec``s, for sgd, momentum and adamw and the
  strategies ``asgd_ga``, ``asp``, ``ama`` and ``sma``.  The train state's
  ``step`` (an int in the port) has the axes ``LA(())`` and maps to the
  empty spec ``()``, no placement, on both sides;
- ``make_serve_setup``'s placements under ``serve_rules()`` (the
  parameters, the prefill and decode batches and the decode caches of
  ``decode_32k`` and ``long_500k``) equal the reference's
  ``spec_tree_for_params`` on both fake meshes, for every arch.

The reference side runs without devices: a fake mesh object and abstract
shapes, no ``jax.make_mesh`` and no ``make_train_setup`` (which would flip
JAX's threefry setting for the whole test process).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P
from repro.configs import get_arch as jget_arch
from repro.core.sync import SyncConfig as JSync
from repro.launch import context as JC
from repro.models.registry import get_model_fns as jget_fns
from repro.sharding.rules import is_la as jis_la
from repro.sharding.rules import spec_tree_for_params as jspec_tree
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.sync import SyncConfig
from repro_torch.launch import context as C
from repro_torch.models.registry import get_model_fns
from repro_torch.sharding.rules import LA, Spec, spec_tree_for_params
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _fake_mesh(shape):
    class Mesh:
        axis_names = ("pod", "data", "model")

        class devices:  # noqa: D401
            pass
    Mesh.devices.shape = shape
    return Mesh()


MESHES = {"2x2x2": (2, 2, 2), "2x16x16": (2, 16, 16)}


def _port_paths(tree, prefix=""):
    """``[(keystr, leaf)]`` with ``LA`` and ``Spec`` leaves kept whole, in
    the reference's flatten order and path format."""
    if isinstance(tree, (LA, Spec)) or not isinstance(tree, (dict, tuple,
                                                             list)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        kids = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        kids = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        kids = [(f"[{i}]", v) for i, v in enumerate(tree)]
    out = []
    for key, sub in kids:
        out.extend(_port_paths(sub, prefix + key))
    return out


def _ref_paths(tree, is_leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def _same_axes(port_tree, ref_tree):
    got = [(p, tuple(la)) for p, la in _port_paths(port_tree)]
    want = [(p, tuple(la)) for p, la in _ref_paths(ref_tree, jis_la)]
    assert got == want


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch_name", ARCH_IDS)
def test_axis_trees_and_abstract_params(arch_name, smoke):
    arch, jarch = get_arch(arch_name), jget_arch(arch_name)
    cfg = arch.smoke if smoke else arch.config
    jcfg = jarch.smoke if smoke else jarch.config
    fns, jfns = get_model_fns(arch.module), jget_fns(jarch.module)
    _same_axes(fns.param_logical_axes(cfg), jfns.param_logical_axes(jcfg))
    _same_axes(fns.cache_logical_axes(cfg, 64),
               jfns.cache_logical_axes(jcfg, 64))
    got = _port_paths(fns.abstract_params(cfg))
    want = _ref_paths(jfns.abstract_params(jcfg), None)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert x.device.type == "meta", path
        assert tuple(x.shape) == tuple(y.shape), path
        assert x.dtype == _DTYPES[jnp.dtype(y.dtype)], path
    # and the axes name every dimension of their leaf
    axes = dict(_port_paths(fns.param_logical_axes(cfg)))
    for path, x in got:
        assert len(axes[path]) == x.dim(), path


@functools.lru_cache(maxsize=None)
def _states(arch_name: str, optimizer: str, strategy: str):
    """(port axes, port abstract state, reference axes, reference abstract
    state) at 2 pods, full width."""
    arch, jarch = get_arch(arch_name), jget_arch(arch_name)
    fns, jfns = get_model_fns(arch.module), jget_fns(jarch.module)
    tcfg = TrainerConfig(n_pods=2, optimizer=optimizer,
                         sync=SyncConfig(strategy, 2))
    jtcfg = JTrainerConfig(n_pods=2, optimizer=optimizer,
                           sync=JSync(strategy, 2))
    trainer = Trainer(C.wrap_loss(fns, arch.config), None, tcfg,
                      device="cpu")
    state = C._abstract_state(trainer, fns, arch.config, 2)
    jtrainer = JTrainer(JC.wrap_loss(jfns, jarch.config),
                        lambda k: jfns.init_params(k, jarch.config), jtcfg)
    jstate = jax.eval_shape(jtrainer.init_state, jax.random.key(0))
    return (C.train_state_axes(fns, arch.config, tcfg), state,
            JC.train_state_axes(jfns, jarch.config, jtcfg), jstate)


_COMBOS = ([("granite-8b", o, s) for o in ("sgd", "momentum", "adamw")
            for s in ("asgd_ga", "asp", "ama", "sma")]
           + [(a, ("sgd", "momentum", "adamw")[i % 3],
               ("asgd_ga", "asp", "ama", "sma")[i % 4])
              for i, a in enumerate(ARCH_IDS) if a != "granite-8b"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_name,optimizer,strategy", _COMBOS)
def test_train_state_specs_match_the_reference(arch_name, optimizer,
                                               strategy, mesh):
    axes, state, jaxes, jstate = _states(arch_name, optimizer, strategy)
    fake = _fake_mesh(MESHES[mesh])
    got = _port_paths(spec_tree_for_params(axes, state, C.train_rules(),
                                           fake))
    want = _ref_paths(jspec_tree(jaxes, jstate, JC.train_rules(), fake),
                      lambda x: isinstance(x, P))
    assert [(p, tuple(s)) for p, s in got] == \
        [(p, tuple(s)) for p, s in want]
    specs = dict(got)
    assert specs[".step"] == () and isinstance(state.step, int)


def test_rule_sets_are_the_reference():
    assert C.train_rules() == JC.train_rules()
    assert C.serve_rules() == JC.serve_rules()


def test_batch_axes_are_the_reference():
    batch = {"tokens": torch.empty(2, 4, 8, device="meta"),
             "positions": torch.empty(2, 3, 4, 8, device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
              for k, v in batch.items()}
    for stacked in (True, False):
        got = C.batch_axes(batch, stacked=stacked)
        want = JC.batch_axes(jbatch, stacked=stacked)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _ref_caches(arch_name: str, batch: int, seq: int):
    """The reference's abstract decode cache, as its ``lower_decode``
    builds it."""
    jarch = jget_arch(arch_name)
    if jarch.module == "encdec":
        from repro.models import encdec as jencdec
        return jax.eval_shape(lambda: jencdec.init_cache(jarch.config, batch,
                                                         seq))
    jfns = jget_fns(jarch.module)
    return jax.eval_shape(lambda: jfns.init_cache(jarch.config, batch, seq))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_name", ARCH_IDS)
def test_serve_specs_match_the_reference(arch_name, mesh):
    """``make_serve_setup``'s placement of the parameters, the prefill and
    decode batches and the decode caches of ``decode_32k`` and (where the
    arch runs it) ``long_500k`` under ``serve_rules()``, against the
    reference's ``spec_tree_for_params`` of the same axes: the kv heads
    yield ``"model"`` to the cache's sequence, and an axis that does not
    divide (``long_500k``'s batch of 1) is dropped."""
    from repro.launch import shapes as JS
    from repro_torch.launch import shapes as S

    arch, jarch = get_arch(arch_name), jget_arch(arch_name)
    fns, jfns = get_model_fns(arch.module), jget_fns(jarch.module)
    fake = _fake_mesh(MESHES[mesh])
    setup = C.make_serve_setup(arch, fake)
    rules = JC.serve_rules()
    is_p = lambda x: isinstance(x, P)  # noqa: E731

    def same(got, want):
        assert [(p, tuple(s.spec)) for p, s in _port_paths(got)] == \
            [(p, tuple(s)) for p, s in _ref_paths(want, is_p)]

    same(setup.param_sharding, jspec_tree(
        jfns.param_logical_axes(jarch.config),
        jfns.abstract_params(jarch.config), rules, fake))
    for shape_name in ("prefill_32k", "decode_32k", "long_500k"):
        if not S.shape_supported(arch, shape_name)[0]:
            continue
        shape, jshape = S.INPUT_SHAPES[shape_name], JS.INPUT_SHAPES[
            shape_name]
        if shape.kind == "prefill":
            specs, jspecs = S.prefill_specs(arch, shape), \
                JS.prefill_specs(jarch, jshape)
        else:
            specs, jspecs = S.decode_specs(arch, shape), \
                JS.decode_specs(jarch, jshape)
            cache = fns.init_cache(arch.config, shape.global_batch,
                                   shape.seq_len, device="meta")
            same(setup.cache_sharding(cache, shape.seq_len), jspec_tree(
                jfns.cache_logical_axes(jarch.config, shape.seq_len),
                _ref_caches(arch_name, shape.global_batch, shape.seq_len),
                rules, fake))
        same(C.batch_sharding(specs, fake, setup.rules, stacked=False),
             jspec_tree(JC.batch_axes(jspecs, stacked=False), jspecs, rules,
                        fake))
