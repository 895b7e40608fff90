"""Port parity: flash attention's plain version and its CPU dispatch against
the reference's Pallas kernel (``interpret=True``) and ``ref.sdpa``.

The cases are the reference's own kernel tests (``tests/test_kernels.py``)
plus the granite smoke config's attention shape.  Inputs are made by numpy
from a seed; bf16 inputs are rounded once by JAX and carried over bit for
bit.  Tolerances are the reference's: ``2e-5`` in f32 (summation order),
``2e-2`` in bf16 (one output ulp).  The CUDA kernel itself is held to the
plain version in ``tests/test_torch_kernels_cuda.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SMOKE = jget_arch("granite-8b").smoke


def _inputs(B, Sq, H, K, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=(B, Sq, n, Dh)), dtype)
          for n in (H, K, K)]
    tx = [convert.to_tensor(np.asarray(x), "cpu") for x in jx]
    return jx, tx


def _check(B, S, H, K, Dh, dtype, *, causal=True, window=None, softcap=0.0,
           block=64, seed=0):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, H, K, Dh, dtype, seed)
    kw = dict(causal=causal, window=window, softcap=softcap)
    j_kernel = jflash(jq, jk, jv, interpret=True, block_q=block,
                      block_k=block, **kw)
    j_plain = jref.sdpa(jq, jk, jv, **kw)
    t_plain = tref.sdpa(tq, tk, tv, **kw)
    t_ops = ops.flash_attention(tq, tk, tv, **kw)
    assert t_ops.dtype == tq.dtype and t_ops.shape == tq.shape
    assert torch.equal(t_ops, t_plain)        # the CPU path is the plain one
    tol = TOL[jnp.dtype(dtype).name]
    for j in (j_kernel, j_plain):
        np.testing.assert_allclose(t_plain.float().numpy(),
                                   np.asarray(j, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,K,Dh", [
    (2, 128, 4, 2, 64),
    (1, 256, 4, 4, 64),
    (2, 96, 6, 2, 32),     # non-multiple of block
    (1, 64, 8, 1, 128),    # MQA
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_matches_reference(B, S, H, K, Dh, dtype):
    _check(B, S, H, K, Dh, dtype)


@pytest.mark.parametrize("window", [16, 64])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_window_softcap_matches_reference(window, softcap):
    _check(1, 128, 4, 2, 64, jnp.float32, window=window, softcap=softcap,
           block=32, seed=1)


def test_flash_noncausal_matches_reference():
    _check(2, 64, 2, 2, 32, jnp.float32, causal=False, block=32, seed=2)


def test_flash_at_smoke_config_shape():
    _check(2, 16, SMOKE.n_heads, SMOKE.n_kv_heads, SMOKE.resolved_head_dim,
           jnp.float32, block=8, seed=3)


def test_flash_refuses_gradients_and_unsupported_shapes():
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    k = torch.randn(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():                      # inference: runs
        assert ops.flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="head_dim 48"):
        ops.flash_attention(torch.randn(1, 8, 4, 48),
                            torch.randn(1, 8, 2, 48),
                            torch.randn(1, 8, 2, 48))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.randn(1, 8, 3, 64), k, k)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q.detach().half(), k.half(), k.half())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q.detach(), k, k, window=0)
    assert ops.LAUNCHES["flash_attention"] == 0   # the CPU path launches none


@pytest.mark.parametrize("view", ["offset", "seq_stride", "head_stride"])
def test_bf16_kernel_refuses_misaligned_views(view):
    # the bf16 kernel's cp.async loads take 16 aligned bytes; the check runs
    # on the host, so it is held here on CPU tensors (the CPU dispatch runs
    # the plain version and takes any view)
    from repro_torch.kernels.flash_attention import check_aligned

    base = torch.zeros(2, 64, 4, 72, dtype=torch.bfloat16)
    check_aligned(base[..., :64], base[..., 8:72])
    if view == "offset":
        bad = base[..., 1:65]
    elif view == "seq_stride":
        bad = torch.zeros(2, 64, 4 * 64 + 4, dtype=torch.bfloat16
                          )[..., :256].reshape(2, 64, 4, 64)
    else:
        bad = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        check_aligned(base[..., :64], bad)
    out = ops.flash_attention(bad, bad, bad)
    torch.testing.assert_close(out, tref.sdpa(bad, bad, bad))


def test_bf16_kernel_takes_the_models_projections():
    # layers.attention_apply's q, k, v at granite's head layout (H 32, K 8,
    # Dh 128) are fresh projections: aligned, so the kernel takes them
    from repro_torch.kernels.flash_attention import check_aligned

    x = torch.zeros(1, 16, 512, dtype=torch.bfloat16)
    q = (x @ torch.zeros(512, 32 * 128, dtype=torch.bfloat16)
         ).reshape(1, 16, 32, 128)
    k = (x @ torch.zeros(512, 8 * 128, dtype=torch.bfloat16)
         ).reshape(1, 16, 8, 128)
    check_aligned(q, k, k)
