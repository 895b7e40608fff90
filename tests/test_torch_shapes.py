"""Port parity: ``repro_torch.launch.shapes`` against ``repro.launch.shapes``.

For every arch and each of the four assigned shapes, the port's input specs
(meta tensors) have the reference's names, shapes and dtypes (its
``jax.ShapeDtypeStruct``s), and the same shapes are skipped for the same
reasons.  Nothing is allocated.
"""
import jax.numpy as jnp
import pytest
import torch
from repro.configs import get_arch as jget_arch
from repro.launch import shapes as JS

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import shapes as S

torch.set_num_threads(2)

_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype == _DTYPES[jnp.dtype(want[k].dtype)], k


def test_input_shapes_are_the_reference():
    assert list(S.INPUT_SHAPES) == list(JS.INPUT_SHAPES)
    for name, shape in S.INPUT_SHAPES.items():
        want = JS.INPUT_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (want.name, want.seq_len, want.global_batch, want.kind)


@pytest.mark.parametrize("shape_name", list(JS.INPUT_SHAPES))
@pytest.mark.parametrize("arch_name", ARCH_IDS)
def test_input_specs_match_the_reference(arch_name, shape_name):
    arch, jarch = get_arch(arch_name), jget_arch(arch_name)
    shape, jshape = S.INPUT_SHAPES[shape_name], JS.INPUT_SHAPES[shape_name]
    ok = S.shape_supported(arch, shape_name)
    assert ok == JS.shape_supported(jarch, shape_name)
    if not ok[0]:
        return
    if shape.kind == "train":
        for n_pods in (1, 2):
            _same(S.train_batch_specs(arch, shape, n_pods),
                  JS.train_batch_specs(jarch, jshape, n_pods))
    elif shape.kind == "prefill":
        _same(S.prefill_specs(arch, shape), JS.prefill_specs(jarch, jshape))
    else:
        _same(S.decode_specs(arch, shape), JS.decode_specs(jarch, jshape))


def test_uneven_pod_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        S.train_batch_specs(get_arch("granite-8b"), S.INPUT_SHAPES["train_4k"],
                            3)
