"""Port parity: the plain PyTorch WAN codec against the JAX package.

Both sides see the same input arrays, so the codec's outputs must be equal
bit for bit: against ``repro.kernels.ref`` (the JAX oracle) and against the
Pallas kernels run in interpret mode, as ``tests/test_wan_codec.py`` runs
them.  The CUDA kernels are held against the same plain version on the
card by ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import wan_codec as jcodec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wan_codec as tcodec

torch.set_num_threads(2)

TIERS = ("int8", "fp8", "int4")


@functools.partial(jax.jit, static_argnames=("k_block", "n", "block",
                                             "value_dtype"))
def _jax_round_trip(x, *, k_block, n, block, value_dtype):
    """The JAX oracle's encode and decode as one compiled program (op by op
    dispatch would compile each small op separately)."""
    out = jref.wan_encode(x, k_block, block=block, value_dtype=value_dtype)
    return out, jref.wan_decode(*out, n, block=block,
                                value_dtype=value_dtype)


def _np(a):
    """Byte-exact numpy view (fp8/uint8/int8 payloads compare as bytes)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _assert_same(jax_out, torch_out):
    assert len(jax_out) == len(torch_out)
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(_np(a), _np(b))


def _input(n, seed, ties=False):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    if ties:
        x[:64] = 0.25                 # a run of equal keys
        x[n // 2:] = 0.0              # whole zero blocks
    return x


CASES = [
    (4096, 41, 1024, False),
    (8192, 82, 4096, False),
    (1000, 16, 256, False),           # n not a multiple of the block
    (300, 8, 512, False),             # one short block
    (5000, 13, 1024, True),           # ragged tail, ties, zero blocks, odd k
    (777, 16, 128, True),
]


@pytest.mark.parametrize("value_dtype", TIERS)
@pytest.mark.parametrize("n,k_block,block,ties", CASES)
def test_codec_matches_jax_oracle_exactly(n, k_block, block, ties,
                                          value_dtype):
    x = _input(n, seed=n + k_block, ties=ties)
    a, da = _jax_round_trip(jnp.asarray(x), k_block=k_block, n=n,
                            block=block, value_dtype=value_dtype)
    b = tops.wan_encode(torch.from_numpy(x), k_block, block=block,
                        value_dtype=value_dtype)
    _assert_same(a, b)
    db = tops.wan_decode(*b, n, block=block, value_dtype=value_dtype)
    np.testing.assert_array_equal(np.asarray(da), db.numpy())


@pytest.mark.parametrize("value_dtype", TIERS)
def test_codec_matches_interpret_pallas_exactly(value_dtype):
    n, k_block, block = 5000, 13, 1024
    x = _input(n, seed=3, ties=True)
    a = jcodec.wan_encode_pallas(jnp.asarray(x), k_block, block=block,
                                 value_dtype=value_dtype, interpret=True)
    b = tref.wan_encode(torch.from_numpy(x), k_block, block=block,
                        value_dtype=value_dtype)
    _assert_same(a, b)
    da = jcodec.wan_decode_pallas(*a, n, block=block,
                                  value_dtype=value_dtype, interpret=True)
    db = tref.wan_decode(*b, n, block=block, value_dtype=value_dtype)
    np.testing.assert_array_equal(np.asarray(da), db.numpy())


@pytest.mark.parametrize("value_dtype", TIERS)
def test_all_zero_input_scales_to_one(value_dtype):
    z = torch.zeros(512)
    q, i, s = tops.wan_encode(z, 7, block=256, value_dtype=value_dtype)
    assert int(q.abs().max()) == 0
    assert torch.equal(s, torch.ones(2))
    d = tops.wan_decode(q, i, s, 512, block=256, value_dtype=value_dtype)
    assert torch.equal(d, torch.zeros(512))


@pytest.mark.parametrize("value_dtype", TIERS)
def test_nan_and_inf_inputs_follow_the_ports_rule(value_dtype):
    """The port's codec defines NaN (the reference leaves a NaN winner's
    code to an undefined float-to-int conversion): every NaN is keyed as
    the canonical NaN, so NaNs tie above +inf and win first, lowest index
    first; a block holding one has scale 1; a NaN winner clips to -qmax.
    The CUDA kernel follows the same rule (``tests/test_torch_kernels_cuda
    .py``); a finite row beside a NaN row is untouched."""
    x = torch.randn(2, 512, generator=torch.Generator().manual_seed(0))
    x[0, 300] = float("inf")
    x[1, 40:] = float("nan")
    x[1, 10] = -float("inf")
    q, i, s = tops.wan_encode(x, 7, block=256, value_dtype=value_dtype)
    fin = tops.wan_encode(x[0, :256], 7, block=256, value_dtype=value_dtype)
    assert torch.equal(q[0, :q.shape[1] // 2], fin[0])
    assert torch.equal(i[0, :7], fin[1]) and s[0, 0] == fin[2][0]
    assert s[0, 1] == float("inf") and 300 - 256 in i[0, 7:].tolist()
    assert s[1].tolist() == [1.0, 1.0]
    assert i[1, :7].tolist() == list(range(40, 47))
    assert i[1, 7:].tolist() == list(range(7))
    codes = (tcodec.unpack_nibbles(q[1].reshape(2, -1), 7).reshape(-1)
             if value_dtype == "int4" else q[1])
    if value_dtype != "fp8":
        assert codes.tolist() == [-tcodec.TIER_QMAX[value_dtype]] * 14

def test_batched_rows_equal_row_by_row():
    """A (pods, n) call is one encode per row (the sync layer's shape)."""
    x = torch.from_numpy(np.stack([_input(3000, 1), _input(3000, 2)]))
    q, i, s = tops.wan_encode(x, 9, block=1024, value_dtype="int4")
    d = tops.wan_decode(q, i, s, 3000, block=1024, value_dtype="int4")
    for r in range(2):
        qr, ir, sr = tops.wan_encode(x[r], 9, block=1024, value_dtype="int4")
        assert torch.equal(q[r], qr) and torch.equal(i[r], ir)
        assert torch.equal(s[r], sr)
        assert torch.equal(d[r], tops.wan_decode(qr, ir, sr, 3000,
                                                 block=1024,
                                                 value_dtype="int4"))


def test_column_slice_input_reads_in_place():
    """The sync layer encodes column slices of the (pods, N) buffer."""
    full = torch.from_numpy(np.stack([_input(6000, 4), _input(6000, 5)]))
    sl = full[:, 1000:5096]
    a = tops.wan_encode(sl, 20, block=1024)
    b = tops.wan_encode(sl.contiguous(), 20, block=1024)
    _assert_same(a, b)


@pytest.mark.parametrize("k", [1, 2, 7, 8, 41])
def test_pack_nibbles_matches_jax(k):
    codes = np.random.default_rng(k).integers(-7, 8, size=(5, k)
                                              ).astype(np.int8)
    pj = jax.jit(jcodec.pack_nibbles)(jnp.asarray(codes))
    pt = tcodec.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    assert pt.dtype == torch.uint8
    back = tcodec.unpack_nibbles(pt, k)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jcodec.unpack_nibbles, static_argnums=1)(pj, k)),
        back.numpy())


def test_constants_and_k_per_block_match():
    for name in ("KEY_MASK", "INV_127", "INV_7", "FP8_MAX", "INV_FP8_MAX",
                 "VALUE_DTYPES", "DEFAULT_BLOCK"):
        ref_v, port_v = getattr(jcodec, name), getattr(tcodec, name)
        if isinstance(ref_v, float):
            # the reference multiplies by jnp.float32(INV): the port keeps
            # exactly that float32 value
            assert np.float32(ref_v) == port_v
        else:
            assert ref_v == port_v
    for block in (128, 1000, 4096):
        for frac in (0.001, 0.01, 0.02, 0.3, 1.0):
            assert jcodec.k_per_block(block, frac) == \
                tcodec.k_per_block(block, frac)


def test_unknown_tier_and_device_raise():
    with pytest.raises(ValueError):
        tops.wan_encode(torch.zeros(8), 1, value_dtype="int2")
    with pytest.raises(ValueError):
        tops.wan_codec_fns(value_dtype="fp16")
    # a CPU tensor never reaches the kernel, whatever use_kernel says
    tops.reset_launches()
    tops.wan_encode(torch.ones(256), 4, block=128, use_kernel=True)
    assert tops.LAUNCHES == {"wan_encode": 0, "wan_decode": 0,
                             "flash_attention": 0, "ssd_scan": 0,
                             "topk_compress": 0}


def _adversarial(case, n, seed):
    """Inputs that split the CUDA encode's selection paths."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    if case == "one_bin":           # every key in one high-byte bin
        x = (np.sign(x) * rng.uniform(1, 2, size=n)).astype(np.float32)
    elif case in ("ties_spread", "large_block_ties"):
        x = (np.round(x * 2) / 2).astype(np.float32)   # ties at t
    elif case == "half_zero":       # a zero half in every block of 4096
        x.reshape(-1, 4096)[:, :2048] = 0.0
    return x


@pytest.mark.parametrize("value_dtype", TIERS)
@pytest.mark.parametrize("case,n,k_block,block", [
    ("one_bin", 9000, 41, 4096),
    ("ties_spread", 9000, 41, 4096),
    ("k_eq_block", 700, 128, 128),
    ("k_one", 9000, 1, 4096),
    ("k_large", 9000, 300, 4096),
    ("half_zero", 8192, 41, 4096),
    ("large_block_ties", 70_000, 655, 65536)])
def test_codec_adversarial_matches_jax_oracle(case, n, k_block, block,
                                              value_dtype):
    x = _adversarial(case, n, seed=n + k_block)
    a, da = _jax_round_trip(jnp.asarray(x), k_block=k_block, n=n,
                            block=block, value_dtype=value_dtype)
    b = tops.wan_encode(torch.from_numpy(x), k_block, block=block,
                        value_dtype=value_dtype)
    _assert_same(a, b)
    db = tops.wan_decode(*b, n, block=block, value_dtype=value_dtype)
    np.testing.assert_array_equal(np.asarray(da), db.numpy())
