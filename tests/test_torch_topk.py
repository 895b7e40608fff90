"""Port parity: the block top-k (the legacy sparse shipping) against
``repro.kernels.ref`` and the Pallas kernel in interpret mode.

The same numpy inputs go to both sides.  Selection is deterministic
arithmetic on the same values (a stable descending sort of ``|x|`` per block
against ``lax.top_k`` and the kernel's iterative argmax, ties to the lowest
index in all three), so vals, idx and the decompressed dense vector must be
equal bit for bit, in f32 and bf16.  On the CPU the ``ops`` wrappers run the
plain version; the CUDA kernel is held to it by the ``cuda`` tests and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.topk_compress import topk_compress_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    npd, td = DTYPES[dtype]
    xj = jnp.asarray(x.astype(npd))
    xt = torch.from_numpy(x.astype(np.float32)).to(td)
    return xj, xt


def _bits(a) -> np.ndarray:
    """Bit pattern of a JAX array or tensor (so -0.0 != +0.0)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int32) if a.dtype == torch.float32 \
            else a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(j, t):
    np.testing.assert_array_equal(_bits(j), _bits(t))


def _check(x: np.ndarray, k: int, block: int, dtype: str = "float32",
           pallas: bool = False):
    """Reference vs port: topk_block, ops dispatch, decompress; returns the
    reference's idx."""
    xj, xt = _pair(x, dtype)
    n = x.shape[0]
    vj, ij = jref.topk_block(xj, k, block=block)
    vt, it = tref.topk_block(xt, k, block=block)
    _same(vj, vt)
    _same(ij, it)
    assert vt.dtype == xt.dtype and it.dtype == torch.int32
    # the ops wrapper on a CPU tensor runs the plain version, which the
    # reference's ops runs by default too
    vo, io = tops.topk_compress(xt, k, block=block)
    _same(jops.topk_compress(xj, k, block=block)[0], vo)
    _same(ij, io)
    _same(jref.topk_decompress(vj, ij, n), tops.topk_decompress(vt, it, n))
    if pallas:
        vp, ip = topk_compress_pallas(xj, k, block=block, interpret=True)
        _same(vp, vt)
        _same(ip, it)
    return np.asarray(ij)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,block", [(4096, 64, 512), (1000, 16, 256),
                                       (8192, 128, 1024), (256, 8, 256)])
def test_topk_bit_equal_on_the_reference_kernel_shapes(n, k, block, dtype):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    # the Pallas kernel stores its f32 winner into a bf16 output ref, which
    # interpret mode refuses on this JAX; bf16 is held to ref.topk_block
    _check(x, k, block, dtype, pallas=dtype == "float32")


def test_ties_go_to_the_lowest_index_in_descending_order():
    x = np.zeros(2048, np.float32)
    x[5], x[7], x[1030] = 1.0, -1.0, 2.0
    idx = _check(x, 6, 1024, pallas=True)
    np.testing.assert_array_equal(idx, [5, 7, 0, 1030, 1024, 1025])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heavy_ties_zeros_and_negative_zero(dtype):
    rng = np.random.default_rng(3)
    ints = np.round(rng.normal(size=3000) * 2).astype(np.float32)
    _check(ints, 50, 256, dtype)
    zeros = np.zeros(3000, np.float32)
    _check(zeros, 40, 256, dtype)
    negz = np.zeros(3000, np.float32)
    negz[::7] = -0.0
    negz[100] = -0.5
    _check(negz, 40, 256, dtype, pallas=dtype == "float32")


def test_pad_winners_write_last_and_overwrite_x_at_n_minus_1():
    """n 1027 at block 1024: the second block's pad zeros win, their idx is
    clamped to n - 1, and in the decompress the last write (a pad's 0.0)
    wins over the real x[n-1]."""
    x = np.random.default_rng(0).normal(size=1027).astype(np.float32)
    x[-1] = -0.782
    idx = _check(x, 16, 1024, pallas=True)
    assert (idx == 1026).sum() > 1
    vt, it = tref.topk_block(torch.from_numpy(x), 16, 1024)
    # the real x[n-1] wins first; the pad zeros clamped onto it come later
    assert float(vt[it == 1026][0]) == x[-1]
    dense = tops.topk_decompress(vt, it, 1027)
    assert float(dense[-1]) == 0.0


def test_decompress_repeated_index_keeps_its_last_entry():
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    idx = torch.tensor([[3, 1, 3, 0], [2, 2, 2, 2]], dtype=torch.int32)
    dense = tops.topk_decompress(vals, idx, 4)
    np.testing.assert_array_equal(dense.numpy(), [[4.0, 2.0, 0.0, 3.0],
                                                  [0.0, 0.0, 8.0, 0.0]])
    for r in range(2):
        _same(jref.topk_decompress(jnp.asarray(vals[r].numpy()),
                                   jnp.asarray(idx[r].numpy()), 4),
              dense[r])


@pytest.mark.parametrize("n,k,block", [
    (5000, 3, 1024),       # k // nb == 0: k_block 1, nb winners cut to k
    (8192, 81, 1024),      # nb * k_block (80) < k: fewer than k come back
    (1000, 512, 1000),     # k_block 512
    (300, 20, 1024),       # n < block
    (150, 1, 1024)])       # LeNet's first conv at top-k 0.01
def test_k_per_block_edge_cases(n, k, block):
    x = np.random.default_rng(k).normal(size=n).astype(np.float32)
    _check(x, k, block, pallas=n <= 1000)
    nb = -(-n // min(block, n))
    got = tref.topk_block(torch.from_numpy(x), k, block)[0].shape[0]
    assert got == min(k, nb * max(1, k // nb))


def test_rows_and_chunks_match_row_by_row():
    """The batched forms the sync layer ships a leaf with: each (row,
    chunk) is compressed as a flat vector would be."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2500)).astype(np.float32))
    v, i = tops.topk_compress(x, 30, block=512)
    for r in range(3):
        vr, ir = tref.topk_block(x[r], 30, 512)
        _same(vr, v[r])
        _same(ir, i[r])
    vc, ic = tops.topk_compress_chunked(x, 1024, 12, block=256)
    assert vc.shape == (3, 3, 12)
    padded = torch.nn.functional.pad(x, (0, 3 * 1024 - 2500))
    for r in range(3):
        for c in range(3):
            vr, ir = tref.topk_block(padded[r, c * 1024:(c + 1) * 1024], 12,
                                     256)
            _same(vr, vc[r, c])
            _same(ir, ic[r, c])


def test_topk_exact_bit_equal():
    rng = np.random.default_rng(9)
    x = np.round(rng.normal(size=2000) * 3).astype(np.float32)
    vj, ij = jref.topk_exact(jnp.asarray(x), 77)
    vt, it = tref.topk_exact(torch.from_numpy(x), 77)
    _same(vj, vt)
    _same(ij, it)


@settings(max_examples=20, deadline=None)
@given(st.integers(16, 512), st.integers(1, 32), st.integers(0, 1000))
def test_topk_property_bit_equal(n, k, seed):
    k = min(k, n)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    _check(x, k, 64)


def _adversarial(case: str, n: int, seed: int) -> np.ndarray:
    """Inputs that split the CUDA kernel's branches, blocks of 1024."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    tiles = x.reshape(-1, 1024)
    if case == "stride32":          # lane 0 of each tile owns 32 large values
        x[::32] *= 50
    elif case == "stride128":       # lane 0 owns 8
        x[::128] *= 50
    elif case == "stride16":        # two lanes own 64: > 32 keys above L
        x[::16] *= 50
    elif case == "all_equal":
        x[:] = 0.75
    elif case == "tie_at_threshold":
        # five 3.0s and ten -2.0s a tile, in different lanes and register
        # slots: the 10th key ties at 2.0, split across lanes
        np.clip(x, -0.9, 0.9, out=x)
        tiles[:, [33, 250, 511, 700, 1000]] = 3.0
        tiles[:, [7, 40, 100, 300, 301, 555, 703, 901, 1017, 1023]] = -2.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["stride32", "stride128", "stride16",
                                  "all_equal", "tie_at_threshold"])
def test_topk_adversarial_inputs(case, dtype):
    """The inputs that take each branch of the CUDA kernel (the fast
    threshold-and-compact path, its ties at L, and the round loop for more
    than 32 keys above L), k_block 10 as on the main path."""
    x = _adversarial(case, 4096, seed=len(case))
    idx = _check(x, 40, 1024, dtype, pallas=dtype == "float32")
    if case == "tie_at_threshold":
        np.testing.assert_array_equal(
            idx[:10], [33, 250, 511, 700, 1000, 7, 40, 100, 300, 301])
