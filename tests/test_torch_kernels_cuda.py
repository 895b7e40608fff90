"""The CUDA codec kernels against their plain versions, on the card.

Marked ``cuda``: these run only where a CUDA device and ``nvcc`` exist and
skip elsewhere (the fixture decides at run time, never at import).  Run
them on a GPU machine (which has no JAX, hence no conftest) with
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("n,k_block,block", [
    (1 << 20, 41, 4096), (777_777, 41, 4096), (5000, 7, 128),
    (300_000, 655, 65536)])
def test_kernels_bit_equal_to_plain(cuda, n, k_block, block, value_dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(2, n, generator=gen, device=cuda)
    x[:, : n // 10] = 0.25
    x[:, n // 2: n // 2 + 2 * block] = 0.0
    before = dict(ops.LAUNCHES)
    kern = ops.wan_encode(x, k_block, block=block, value_dtype=value_dtype)
    plain = ops.wan_encode(x, k_block, block=block, value_dtype=value_dtype,
                           use_kernel=False)
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dk = ops.wan_decode(*kern, n, block=block, value_dtype=value_dtype)
    dp = ops.wan_decode(*plain, n, block=block, value_dtype=value_dtype,
                        use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    assert ops.LAUNCHES["wan_encode"] == before["wan_encode"] + 1
    assert ops.LAUNCHES["wan_decode"] == before["wan_decode"] + 1
