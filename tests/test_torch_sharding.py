"""Port parity: ``repro_torch.sharding.rules`` against ``repro.sharding.rules``.

The spec rules are held to the reference's on the same fake meshes (an
object with ``axis_names`` and ``devices.shape``, as
``tests/test_substrate.py`` uses): the port's spec is a tuple equal to
``tuple(PartitionSpec)``.  Placements and ``shard`` on DTensors run on a
``DeviceMesh`` over a fake process group (``FakeStore``): one process that
stands for every rank, no communication.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from repro.sharding import rules as jrules
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.kernels import ops
from repro_torch.sharding import rules as R

torch.set_num_threads(2)


class _FakeMesh:
    axis_names = ("pod", "data", "model")
    class devices:  # noqa: D401
        shape = (2, 16, 16)
        size = 512


def _both(shape, logical, rules):
    """The port's spec and the reference's, as tuples."""
    got = R.logical_to_spec(shape, logical, rules, _FakeMesh())
    want = jrules.logical_to_spec(shape, logical, rules, _FakeMesh())
    return tuple(got), tuple(want)


def test_logical_to_spec_divisibility_fallback():
    rules = {"heads": "model", "batch": ("pod", "data"), "kv": "model"}
    got, want = _both((6, 32), ("heads", "batch"), rules)
    assert got == want == (None, ("pod", "data"))
    got, want = _both((64, 31), ("heads", "batch"), rules)
    assert got == want == ("model", None)


def test_logical_to_spec_no_duplicate_axis():
    rules = {"cache_seq": "model", "kv_heads": "model"}
    got, want = _both((32768, 16), ("cache_seq", "kv_heads"), rules)
    assert got == want == ("model", None)


def test_spec_tree_for_params():
    tree = {"w": R.LA(("heads", None)), "b": R.LA((None,))}
    ab = {"w": torch.empty(32, 8, device="meta"),
          "b": torch.empty(8, device="meta")}
    specs = R.spec_tree_for_params(tree, ab, {"heads": "model"}, _FakeMesh())
    assert specs["w"] == tuple(P("model", None))
    assert specs["b"] == tuple(P(None))
    jtree = {"w": jrules.LA(("heads", None)), "b": jrules.LA((None,))}
    jab = {"w": jax.ShapeDtypeStruct((32, 8), jnp.float32),
           "b": jax.ShapeDtypeStruct((8,), jnp.float32)}
    jspecs = jrules.spec_tree_for_params(jtree, jab, {"heads": "model"},
                                         _FakeMesh())
    assert {k: tuple(v) for k, v in jspecs.items()} == specs


@pytest.mark.parametrize("dim", [1, 2, 6, 32, 64, 512, 1024, 3 * 512])
def test_longest_divisible_prefix(dim):
    """A three-axis rule keeps its longest divisible prefix (2, 32, 512)."""
    rules = {"batch": ("pod", "data", "model")}
    got, want = _both((dim,), ("batch",), rules)
    assert got == want
    expect = {1: None, 2: "pod", 6: "pod", 32: ("pod", "data"),
              64: ("pod", "data"), 512: ("pod", "data", "model"),
              1024: ("pod", "data", "model"),
              3 * 512: ("pod", "data", "model")}[dim]
    assert got == (expect,)


def test_sharding_for_is_the_reference():
    """``sharding_for``'s spec under the default rules is the reference's
    (whose ``NamedSharding`` needs a JAX mesh, so its spec is taken from
    ``logical_to_spec``, which its ``sharding_for`` wraps)."""
    got = R.sharding_for((64, 32, 6), ("batch", "heads", "kv_heads"),
                         _FakeMesh())
    spec = jrules.logical_to_spec((64, 32, 6), ("batch", "heads",
                                                "kv_heads"), None, _FakeMesh())
    assert got.spec == tuple(spec) == (("pod", "data"), "model", None)


def test_default_rules_are_the_reference():
    assert R.DEFAULT_RULES == jrules.DEFAULT_RULES


def test_shard_is_a_noop_without_rules_and_on_plain_tensors():
    x = torch.randn(4, 6, 8)
    assert R.shard(x, "batch", "seq", "d_model") is x
    with R.axis_rules(R.DEFAULT_RULES, _FakeMesh()):
        assert R.shard(x, "batch", "seq", "d_model") is x
        with pytest.raises(ValueError, match="rank-3"):
            R.shard(x, "batch", "seq")
    assert R.current_mesh() is None


@pytest.fixture
def fake_mesh():
    """A (2, 2, 2) ``DeviceMesh`` over a fake process group of 8 ranks
    (this process is rank 0 of it)."""
    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_debug_mesh(2, 2, 2)
    finally:
        dist.destroy_process_group()


def test_mesh_info_is_the_reference(fake_mesh):
    from repro.launch import mesh as jmesh

    from repro_torch.launch.mesh import mesh_info

    class Fake:
        axis_names = ("pod", "data", "model")

        class devices:  # noqa: D401
            shape, size = (2, 2, 2), 8

    assert mesh_info(fake_mesh) == jmesh.mesh_info(Fake()) == {
        "n_devices": 8, "n_pods": 2, "data": 2, "model": 2}


def test_placements_for_on_a_device_mesh(fake_mesh):
    inpod = fake_mesh["data", "model"]
    spec = R.logical_to_spec((2, 4, 64, 32), ("pod_stack", "layers", "fsdp",
                                              "heads"),
                             {**R.DEFAULT_RULES, "pod_stack": "pod"},
                             fake_mesh)
    assert spec == ("pod", None, "data", "model")
    assert R.placements_for(spec, fake_mesh) == (Shard(0), Shard(2),
                                                 Shard(3))
    # the pod axis runs across processes: the in-pod mesh skips it
    assert R.placements_for(spec, inpod) == (Shard(2), Shard(3))
    # one tensor dim over two mesh axes: Shard on both, major to minor
    assert R.placements_for((("pod", "data"), None), fake_mesh) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        R.placements_for((("data", "pod"),), fake_mesh)


def test_shard_redistributes_a_dtensor(fake_mesh):
    inpod = fake_mesh["data", "model"]
    x = distribute_tensor(torch.randn(4, 6, 8), inpod,
                          [Replicate(), Replicate()])
    with R.axis_rules({"batch": "data", "vocab": "model"}, fake_mesh):
        y = R.shard(x, "batch", None, "vocab")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        # 6 does not divide over "model" (2 does): the axis is dropped
        z = R.shard(x, None, "vocab", None)
        assert tuple(z.placements) == (Replicate(), Shard(1))
        assert R.shard(y, "batch", None, "vocab") is y


def test_ops_refuse_a_dtensor(fake_mesh):
    """No DTensor reaches a kernel wrapper, on any device."""
    inpod = fake_mesh["data", "model"]
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.randn(2, 8192), inpod, rep)
    q = distribute_tensor(torch.randn(1, 16, 2, 8), inpod, rep)
    encode, decode = ops.wan_codec_fns(block=4096)
    calls = [
        lambda: encode(x, 41),
        lambda: ops.wan_encode(x, 41),
        lambda: ops.wan_decode(x, x, x, 8192),
        lambda: decode(x, x, x, 8192),
        lambda: ops.topk_compress(x, 10),
        lambda: ops.topk_compress_chunked(x, 4096, 10),
        lambda: ops.topk_decompress(x, x, 8192),
        lambda: ops.flash_attention(q, q, q),
        lambda: ops.ssd_scan(q, q[..., 0], q, q, chunk=16),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="DTensor"):
            call()
