"""The CUDA kernels (the WAN codec, flash attention) against their plain
versions, on the card.

Marked ``cuda``: these run only where a CUDA device and ``nvcc`` exist and
skip elsewhere (the fixture decides at run time, never at import).  Run
them on a GPU machine (which has no JAX, hence no conftest) with
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

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


# the reference's flash tolerance (tests/test_kernels.py): online softmax
# against the full softmax, and one bf16 ulp of the output
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_case(cuda, B, S, H, K, Dh, dtype, *, causal=True, window=None,
                softcap=0.0, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, Dh, generator=gen, device=cuda
                           ).to(dtype) for n in (H, K, K))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    expect = ref.sdpa(q, k, v, causal=causal, window=window,
                      softcap=softcap)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert ops.LAUNCHES["flash_attention"] == before + 1
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,K,Dh", [
    (2, 128, 4, 2, 64), (1, 256, 4, 4, 64), (2, 96, 6, 2, 32),
    (1, 64, 8, 1, 128), (1, 1000, 32, 8, 128), (1, 300, 16, 8, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_plain(cuda, B, S, H, K, Dh, dtype):
    _flash_case(cuda, B, S, H, K, Dh, dtype)


@pytest.mark.parametrize("window", [16, 64, 256])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_window_softcap_matches_plain(cuda, window, softcap):
    _flash_case(cuda, 1, 333, 4, 2, 64, torch.float32, window=window,
                softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_matches_plain(cuda, dtype):
    _flash_case(cuda, 2, 77, 2, 2, 32, dtype, causal=False)


def test_flash_reads_strided_views_in_place(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 100, 4 + 2 + 2, 64, generator=gen, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, ref.sdpa(q, k, v), atol=2e-5,
                               rtol=2e-5)
