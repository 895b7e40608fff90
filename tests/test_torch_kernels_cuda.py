"""The CUDA kernels (the WAN codec, flash attention, the SSD scan, the block
top-k) against their plain versions, on the card.

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



@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("k_block,block", [(41, 4096), (300, 4096),
                                           (655, 65536)])
@pytest.mark.parametrize("case", ["nan_row", "scattered", "ragged_tail"])
def test_codec_on_nan_and_inf_bit_equal_to_plain(cuda, case, k_block, block,
                                                 value_dtype):
    """NaN and inf inputs (a corrupted payload decoded into the parameters,
    then their gradients): a NaN keyed as the canonical NaN, above +inf,
    a NaN block's scale 1, a NaN winner clipped to -qmax, in the kernel as
    in the plain version; nothing written outside a block."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 777_777
    x = torch.randn(2, n, generator=gen, device=cuda)
    if case == "nan_row":
        x[1] = float("nan")
    elif case == "scattered":
        x[1, ::7] = float("nan")
        x[0, ::13] = float("inf")
    else:
        x[1, -100:] = float("nan")
    kern = ops.wan_encode(x, k_block, block=block, value_dtype=value_dtype)
    plain = ops.wan_encode(x, k_block, block=block, value_dtype=value_dtype,
                           use_kernel=False)
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dk = ops.wan_decode(*kern, n, block=block, value_dtype=value_dtype)
    dp = ops.wan_decode(*plain, n, block=block, value_dtype=value_dtype,
                        use_kernel=False)
    torch.cuda.synchronize()
    nk, np_ = torch.isnan(dk), torch.isnan(dp)
    assert torch.equal(nk, np_)
    assert torch.equal(torch.where(nk, 0, dk), torch.where(np_, 0, dp))


# the reference's flash tolerance (tests/test_kernels.py): online softmax
# against the full softmax, and one bf16 ulp of the output
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_case(cuda, B, S, H, K, Dh, dtype, *, causal=True, window=None,
                softcap=0.0, seed=0, Sk=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, Sk or S, K, Dh, generator=gen, device=cuda
                        ).to(dtype) for _ in range(2))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [16, 64, 256])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_window_softcap_matches_plain(cuda, window, softcap, dtype):
    _flash_case(cuda, 1, 333, 4, 2, 64, dtype, window=window,
                softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_matches_plain(cuda, dtype):
    _flash_case(cuda, 2, 77, 2, 2, 32, dtype, causal=False)


# the MoE, hybrid and encoder-decoder families' prefill shapes: GQA groups
# of 8 (qwen3-moe 32/4; kimi-k2 and jamba 64/8, head_dim 128), whisper's
# non-causal encoder over 1500 frames (6 heads of 64) and its decoder's
# cross-attention over them
@pytest.mark.parametrize("S,H,K", [(2048, 32, 4), (2048, 64, 8),
                                   (1024, 64, 8)])
def test_flash_gqa8_prefill_shapes(cuda, S, H, K):
    _flash_case(cuda, 1, S, H, K, 128, torch.bfloat16)


# qwen2-vl-2b's prefill: 12 heads over 2 KV heads, a GQA group of 6
@pytest.mark.parametrize("B,S", [(1, 2048), (2, 2048), (1, 1000)])
def test_flash_qwen2_vl_prefill_shape(cuda, B, S):
    _flash_case(cuda, B, S, 12, 2, 128, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq", [(1, 1500), (4, 1500), (4, 32)])
def test_flash_whisper_noncausal(cuda, B, Sq, dtype):
    _flash_case(cuda, B, Sq, 6, 6, 64, dtype, causal=False, Sk=1500)


# the tensor-core (bf16) kernel: every head dim, one tile and less, Sq != Sk
# both ways, MQA, non-causal, and windows that start inside a k-tile
@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_head_dims(cuda, Dh, causal):
    _flash_case(cuda, 2, 333, 8, 2, Dh, torch.bfloat16, causal=causal)


@pytest.mark.parametrize("S", [1, 5, 17, 64, 65, 129])
def test_flash_bf16_short_sequences(cuda, S):
    _flash_case(cuda, 3, S, 4, 2, 128, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(100, 300), (300, 100), (17, 1000),
                                   (1000, 17)])
def test_flash_bf16_sq_ne_sk(cuda, Sq, Sk, causal):
    _flash_case(cuda, 2, Sq, 4, 2, 64, torch.bfloat16, causal=causal,
                Sk=Sk)


@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_bf16_mqa(cuda, Dh):
    _flash_case(cuda, 1, 1000, 16, 1, Dh, torch.bfloat16)


@pytest.mark.parametrize("window,softcap", [(1, 0.0), (100, 50.0),
                                            (700, 0.0)])
def test_flash_bf16_window_at_scale(cuda, window, softcap):
    _flash_case(cuda, 1, 2048, 32, 8, 128, torch.bfloat16, window=window,
                softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_strided_views_in_place(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 100, 4 + 2 + 2, 64, generator=gen,
                      device=cuda).to(dtype)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = ops.flash_attention(q, k, v)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.sdpa(q, k, v).float(),
                               atol=tol, rtol=tol)


def test_flash_bf16_refuses_misaligned_views(cuda):
    # a view one element past an aligned base: cp.async cannot take it, and
    # the wrapper makes no aligned copy
    base = torch.randn(1, 64, 4, 72, device=cuda).to(torch.bfloat16)
    q = base[..., 1:65]
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)
    wide = torch.randn(1, 64, 4 * 64 + 4, device=cuda).to(torch.bfloat16)
    q = wide[..., :256].reshape(1, 64, 4, 64)      # seq stride 260 elements
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before


# the reference's SSD tolerance (tests/test_kernels.py): y / max|y| and the
# final state; f32 sums in another order than the chunked plain version
SSD_Y_TOL, SSD_STATE_TOL = 1e-5, 1e-3


def _ssd_case(cuda, B, S, H, P, N, chunk, *, bc_dtype=torch.float32,
              init=False, expand=False, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    x = randn(B, S, H, P)
    a = -randn(B, S, H).abs() * 0.1
    if expand:                          # one B/C group: stride 0 over heads
        Bm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
        Cm = randn(B, S, 1, N).to(bc_dtype).expand(B, S, H, N)
    else:
        Bm, Cm = randn(B, S, H, N).to(bc_dtype), randn(B, S, H, N).to(bc_dtype)
    s0 = randn(B, H, P, N) if init else None
    before = ops.LAUNCHES["ssd_scan"]
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=chunk, init_state=s0)
    y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert f.dtype == torch.float32 and f.shape == (B, H, P, N)
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y / scale, y_ref / scale, atol=SSD_Y_TOL,
                               rtol=0)
    torch.testing.assert_close(f, f_ref, atol=SSD_STATE_TOL, rtol=0)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 16, 32, 32), (1, 256, 2, 64, 128, 64),
    (2, 64, 8, 8, 16, 64),              # the reference's kernel tests
    (1, 256, 4, 64, 128, 256),          # S == chunk
    (2, 100, 4, 64, 128, 256),          # S < chunk, ragged sub-tiles
    (2, 96, 3, 24, 40, 32)])            # odd widths
def test_ssd_matches_plain(cuda, B, S, H, P, N, chunk, init):
    _ssd_case(cuda, B, S, H, P, N, chunk, init=init)


@pytest.mark.parametrize("expand", [False, True])
def test_ssd_bf16_and_stride0_bc(cuda, expand):
    _ssd_case(cuda, 1, 512, 8, 64, 128, 256, bc_dtype=torch.bfloat16,
              expand=expand)


def test_ssd_at_the_serving_prefill_shape(cuda):
    # mamba2-1.3b's prefill: B 1, S 2048, 64 heads, P 64, N 128, chunk 256,
    # x and a f32, B and C bf16 as one group's stride-0 view over heads
    _ssd_case(cuda, 1, 2048, 64, 64, 128, 256, bc_dtype=torch.bfloat16,
              expand=True)


@pytest.mark.parametrize("S", [2048, 1024])
def test_ssd_at_jamba_shape_with_eight_bc_groups(cuda, S):
    # jamba's Mamba layers: 256 heads of P 64, N 128, chunk 256, 8 B/C
    # groups expanded to heads (32 heads a group) by a copy, as ssm_apply
    # passes them; x and a f32, B and C bf16
    gen = torch.Generator(device=cuda).manual_seed(S)
    H, P, N, G = 256, 64, 128, 8
    x = torch.randn(1, S, H, P, generator=gen, device=cuda)
    a = -torch.randn(1, S, H, generator=gen, device=cuda).abs() * 0.1
    Bg, Cg = (torch.randn(1, S, G, N, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    Bm = Bg.repeat_interleave(H // G, dim=2)
    Cm = Cg.repeat_interleave(H // G, dim=2)
    before = ops.LAUNCHES["ssd_scan"]
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=256)
    y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y / scale, y_ref / scale, atol=SSD_Y_TOL,
                               rtol=0)
    torch.testing.assert_close(f, f_ref, atol=SSD_STATE_TOL, rtol=0)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_chunk_lengths(cuda, chunk, bc_dtype):
    _ssd_case(cuda, 1, 1024, 8, 64, 128, chunk, bc_dtype=bc_dtype,
              expand=True, init=True)


def test_ssd_sixteen_chunks(cuda):
    # S 4096 at chunk 256: the state passes over 16 chunks
    _ssd_case(cuda, 1, 4096, 16, 64, 128, 256, bc_dtype=torch.bfloat16,
              expand=True)


def test_ssd_at_the_scoring_shape(cuda):
    # mamba2-1.3b's scoring forward: B 2, S 2048
    _ssd_case(cuda, 2, 2048, 64, 64, 128, 256, bc_dtype=torch.bfloat16,
              expand=True)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("expand", [False, True])
def test_ssd_init_state_and_bc_layouts(cuda, bc_dtype, expand):
    _ssd_case(cuda, 2, 512, 8, 64, 128, 256, bc_dtype=bc_dtype,
              expand=expand, init=True)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_ragged_p_tiles_and_state_dim(cuda, bc_dtype):
    # P 80: a full 64-column P-tile and a ragged one; N 100 and L 96: zero
    # padding up to the kernel's compile-time widths and a ragged i-tile
    _ssd_case(cuda, 2, 192, 3, 80, 100, 96, bc_dtype=bc_dtype, init=True)


def test_ssd_reads_strided_views_in_place(cuda):
    # x, B and C as column slices of one projection, as ssm_apply passes them
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, S, H, P, N = 2, 256, 4, 16, 32
    proj = torch.randn(B, S, H * P + 2 * N, generator=gen, device=cuda)
    x = proj[..., :H * P].reshape(B, S, H, P)
    Bm = proj[..., H * P:H * P + N][:, :, None].expand(B, S, H, N)
    Cm = proj[..., H * P + N:][:, :, None].expand(B, S, H, N)
    a = -torch.rand(B, S, H, generator=gen, device=cuda) * 0.1
    y, f = ops.ssd_scan(x, a, Bm, Cm, chunk=64)
    y_ref, f_ref = ref.ssd(x, a, Bm, Cm, chunk=64)
    scale = float(y_ref.abs().max())
    torch.testing.assert_close(y / scale, y_ref / scale, atol=SSD_Y_TOL,
                               rtol=0)
    torch.testing.assert_close(f, f_ref, atol=SSD_STATE_TOL, rtol=0)


# granite-8b at 2 layers: each leaf's per-pod shape, as _ship_ring cuts it
# into chunks of 2**26 values (the MLP leaves pad to 2 chunks, embed and
# unembed are 3)
GRANITE_LEAVES = [(2, 4096, 1024), (2, 4096, 4096), (2, 4096, 4096),
                  (2, 4096, 1024), (2, 4096), (2, 4096), (2, 14336, 4096),
                  (2, 4096, 14336), (2, 4096, 14336), (4096, 49152),
                  (49152, 4096), (4096,)]
CHUNK = 1 << 26


def _topk_case(x, chunk, k, block=1024):
    """The kernel's batched launch bit-equal to the plain version: vals
    (bit pattern), idx and the decompressed dense rows."""
    before = ops.LAUNCHES["topk_compress"]
    vk, ik = ops.topk_compress_chunked(x, chunk, k, block=block)
    vp, ip = ops.topk_compress_chunked(x, chunk, k, block=block,
                                       use_kernel=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["topk_compress"] == before + 1
    assert vk.dtype == vp.dtype == x.dtype and ik.dtype == torch.int32
    assert vk.shape == vp.shape and torch.equal(ik, ip)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(vk.view(bits), vp.view(bits))
    assert torch.equal(ops.topk_decompress(vk, ik, chunk).view(bits),
                       ops.topk_decompress(vp, ip, chunk).view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRANITE_LEAVES)
def test_topk_granite_leaves(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    x = torch.randn((2,) + shape, generator=gen, device=cuda).to(dtype)
    numel = x[0].numel()
    chunk = min(CHUNK, numel)
    _topk_case(x.reshape(2, numel), chunk, max(1, int(chunk * 0.01)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties", "zeros", "negzero", "pad_wins",
                                  "k_lt_nb", "short", "k_block_512",
                                  "n_lt_block", "stride32", "stride128",
                                  "stride16", "all_equal",
                                  "tie_at_threshold"])
def test_topk_edge_cases(cuda, case, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(3, 300_000, generator=gen, device=cuda)
    chunk, k = 300_000, 3000
    if case == "ties":
        x = torch.round(x * 2)
    elif case == "zeros":
        x = torch.zeros_like(x)
    elif case == "negzero":
        x = torch.where(x > 0, -0.0, 0.0)
        x[:, 5] = -0.25
    elif case == "pad_wins":            # n 1027: the second block's pads
        x, chunk, k = x[:, :1027].clone(), 1027, 16
    elif case == "k_lt_nb":             # k // nb == 0: k_block 1, cut to k
        chunk, k = 5000, 3
    elif case == "short":               # nb * k_block (80) < k (81)
        x, chunk, k = x[:, :8192].clone(), 8192, 81
    elif case == "k_block_512":
        chunk, k = 4096, 2048
    elif case == "n_lt_block":
        x, chunk, k = x[:, :300].clone(), 300, 20
    elif case in ("stride32", "stride128", "stride16", "all_equal",
                  "tie_at_threshold"):
        # the inputs that split the kernel's branches: 292 whole tiles of
        # 1024, k_block 10; large values every 32 (one lane holds 32 of
        # them) or 16 positions (two lanes hold 64) put more than 32 keys
        # above the lane-maxima bound, every 128 (one lane holds 8) not
        x, chunk, k = x[:, :299_008].clone(), 299_008, 2990
        if case.startswith("stride"):
            x[:, ::int(case[6:])] *= 50
        elif case == "all_equal":
            x.fill_(0.75)
        else:
            # per tile five 3.0s and ten -2.0s in different lanes and
            # register slots: the 10th key ties at 2.0, split across lanes
            x.clamp_(-0.9, 0.9)
            x.view(3, -1, 1024)[..., [33, 250, 511, 700, 1000]] = 3.0
            x.view(3, -1, 1024)[..., [7, 40, 100, 300, 301, 555, 703, 901,
                                      1017, 1023]] = -2.0
    _topk_case(x.to(dtype), chunk, k)


def test_topk_flat_and_rows_entry_points(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 10_000, generator=gen, device=cuda)
    for xs in (x, x[1], x[:, 17:9000]):     # rows, flat, a column slice
        vk, ik = ops.topk_compress(xs, 100, block=512)
        vp, ip = ops.topk_compress(xs, 100, block=512, use_kernel=False)
        assert torch.equal(vk, vp) and torch.equal(ik, ip)
    with pytest.raises(ValueError):
        ops.topk_compress(x, 10, block=2048)


@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("case,n,k_block,block", [
    ("one_bin", 300_000, 41, 4096),        # every key in one high-byte bin
    ("ties_spread", 300_000, 41, 4096),    # ties at t over many threads
    ("k_eq_block", 5000, 128, 128),
    ("k_one", 300_000, 1, 4096),
    ("k_large", 300_000, 300, 4096),       # > 256: no floor
    ("half_zero", 299_008, 41, 4096),      # a zero half drops the floor
    ("large_block", 300_000, 655, 65536),
    ("large_block_ties", 300_000, 655, 65536),
    ("small_k_large_block", 300_000, 41, 65536)])
def test_encode_adversarial(cuda, case, n, k_block, block, value_dtype):
    """Inputs that split the encode's selection: the candidate list that
    warp 0 finishes (one_bin, ties_spread, k_one, k_eq_block), the general
    path (more than 256 candidates: k_large, half_zero; and the 65536
    blocks, whose keys stay in shared memory)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, n, generator=gen, device=cuda)
    if case == "one_bin":
        x = torch.sign(x) * (1 + torch.rand(2, n, generator=gen,
                                            device=cuda))
    elif case in ("ties_spread", "large_block_ties"):
        x = torch.round(x * 2) / 2
    elif case == "half_zero":
        x.view(2, -1, block)[..., :block // 2] = 0.0
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


@pytest.mark.parametrize("block", [128, 1000, 1024, 2048, 4096])
def test_encode_unaligned_and_odd_blocks(cuda, block):
    """Scalar loads: a column slice whose start is not 16-byte aligned, an
    odd row stride, and a block that is not a multiple of 4."""
    gen = torch.Generator(device=cuda).manual_seed(block)
    full = torch.randn(2, 70_001, generator=gen, device=cuda)
    for x in (full[:, 3:60_000], full[:, 4:60_004], full):
        kern = ops.wan_encode(x, 13, block=block)
        plain = ops.wan_encode(x, 13, block=block, use_kernel=False)
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)


@pytest.mark.parametrize("value_dtype", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("case", ["strided_unaligned", "strided_aligned",
                                  "shrunk_unaligned", "shrunk_aligned"])
def test_codec_on_streaming_tail_views(cuda, case, value_dtype):
    """The streaming retune's tail re-encode: ``flat[:, off + sw:off +
    size]`` read in place (a row-strided view, its base 16-byte aligned or
    not), at the retune's cheaper top-k, and a tail narrower than the codec
    block encoded at its own width, as ``sync._encode_bucket`` does; the
    encode and the decode bit-equal to the plain versions, one launch
    each, the view left as it was."""
    from repro_torch.core.sync import SyncConfig, _chunk_widths, _encode_bucket
    from repro_torch.kernels.wan_codec import k_per_block

    gen = torch.Generator(device=cuda).manual_seed(11)
    flat = torch.randn(2, 1_000_004, generator=gen, device=cuda)
    lo = {"strided_unaligned": 12_289, "strided_aligned": 12_288,
          "shrunk_unaligned": 401_001, "shrunk_aligned": 401_000}[case]
    # a shrunk block of 3000 takes the 16-byte loads on an aligned base,
    # one of 3001 the scalar ones
    width = {"strided_unaligned": 600_000, "strided_aligned": 600_000,
             "shrunk_unaligned": 3_001, "shrunk_aligned": 3_000}[case]
    view = flat[:, lo:lo + width]
    assert view.stride(0) == flat.shape[1]
    assert (view.data_ptr() % 16 == 0) == case.endswith("_aligned")
    before = view.clone()
    block = min(4096, width)
    k_block = k_per_block(block, 0.01)
    launches = dict(ops.LAUNCHES)
    kern = ops.wan_encode(view, k_block, block=block,
                          value_dtype=value_dtype)
    plain = ops.wan_encode(view, k_block, block=block,
                           value_dtype=value_dtype, use_kernel=False)
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    dk = ops.wan_decode(*kern, width, block=block, value_dtype=value_dtype)
    dp = ops.wan_decode(*plain, width, block=block, value_dtype=value_dtype,
                        use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    assert ops.LAUNCHES["wan_encode"] == launches["wan_encode"] + 1
    assert ops.LAUNCHES["wan_decode"] == launches["wan_decode"] + 1
    assert torch.equal(view, before)
    # the sync layer's tail encode: chunks on codec-block boundaries, the
    # block shrunk to the tail's width, the local reconstruction decoded
    cfg = SyncConfig("asgd_ga", 2, compress_topk=0.01, quantize_int8=True,
                     value_dtype=value_dtype, error_feedback=True,
                     overlap_chunks=4)
    chunks, local = _encode_bucket(cfg, view, want_local=True)
    off, parts = 0, []
    for c, m in zip(chunks, _chunk_widths(cfg, width), strict=True):
        q, idx, scales = ops.wan_encode(view[:, off:off + m], k_block,
                                        block=block, value_dtype=value_dtype,
                                        use_kernel=False)
        assert torch.equal(c.q, q) and torch.equal(c.scales, scales)
        assert torch.equal(c.idx.to(torch.int32), idx)
        parts.append(ops.wan_decode(q, idx, scales, m, block=block,
                                    value_dtype=value_dtype,
                                    use_kernel=False))
        off += m
    assert off == width
    assert torch.equal(local, torch.cat(parts, dim=1))


# ------------------------------------------------- the async snapshot engine


def _snapshot_trainer(cuda):
    """A 2-pod trainer over a linear model big enough (64 MB of f32
    params and momentum, bf16 beside them) that the capture's copies are
    still running when the next step is queued."""
    from repro_torch.core.sync import SyncConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    def loss(params, batch):
        pred = batch["x"] @ params["w"] + params["e"].float().sum()
        return torch.mean((pred - batch["y"]) ** 2), {}

    def init(gen):
        return {"w": torch.randn(4096, 2048, generator=gen, device=cuda)
                * 0.01,
                "e": (torch.randn(1024, 1024, generator=gen, device=cuda)
                      * 1e-3).to(torch.bfloat16)}

    tr = Trainer(loss, init, TrainerConfig(
        n_pods=2, optimizer="momentum", lr=0.05,
        sync=SyncConfig("asgd_ga", 1000)), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"x": torch.randn(2, 64, 4096, generator=gen, device=cuda),
             "y": torch.randn(2, 64, 2048, generator=gen, device=cuda)}
    return tr, tr.init_state(0), batch


def _host_copy(tree):
    from repro_torch import tree as T

    return T.tree_map(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, tree)


def _equal_trees(a, b):
    from repro_torch import tree as T

    for x, y in zip(T.leaves(a), T.leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        else:
            assert x == y


def test_snapshot_then_in_place_step_commits_pre_step_values(cuda, tmp_path):
    """``snapshot()`` returns with its device-to-host copies queued; the
    next ``train_step``, which writes the params and momentum in place, is
    ordered behind them on the device, so the committed snapshot holds the
    pre-step values; the buffers are page-locked."""
    from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine

    tr, state, batch = _snapshot_trainer(cuda)
    state, _ = tr.train_step(state, batch)
    torch.cuda.synchronize()
    want = _host_copy(state)
    with AsyncCheckpointEngine(str(tmp_path), keep=1) as eng:
        eng.snapshot(state, 1)
        state, _ = tr.train_step(state, batch)
        after = _host_copy(state)
        out, step = eng.restore_last(like=state)
        assert all(b.block.is_pinned() for b in eng._host_bufs)
    assert step == 1
    _equal_trees(out, want)
    assert not torch.equal(after.params["w"], want.params["w"])


def test_pinned_pool_is_reused_across_two_snapshots(cuda, tmp_path):
    """Two snapshots of one layout, drained in between, go through the same
    page-locked block and views, and each commits its own values."""
    from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
    from repro_torch.checkpoint.checkpoint import restore

    tr, state, batch = _snapshot_trainer(cuda)
    with AsyncCheckpointEngine(str(tmp_path), keep=2) as eng:
        want0 = _host_copy(state)
        eng.snapshot(state, 0)
        eng.wait()
        sets = list(eng._host_bufs)
        ptr = sets[0].block.data_ptr()
        state, _ = tr.train_step(state, batch)
        want1 = _host_copy(state)
        eng.snapshot(state, 1)
        eng.wait()
        assert eng._host_bufs == sets and len(sets) == 1
        assert sets[0].block.data_ptr() == ptr and sets[0].block.is_pinned()
        for s, want in ((0, want0), (1, want1)):
            out, _ = restore(str(tmp_path / f"step_{s:08d}"), state)
            _equal_trees(out, want)


def test_stream_order_holds_when_a_restack_frees_the_old_state(
        cuda, tmp_path):
    """A re-stack right after ``snapshot()`` frees the old state while its
    copies may still run; the allocator must not hand that memory to the
    new tensors before the copies end, so the snapshot commits the old
    values though the new state overwrites freshly allocated memory."""
    from repro_torch.checkpoint.async_engine import AsyncCheckpointEngine
    from repro_torch.checkpoint.checkpoint import restore
    from repro_torch.training.trainer import resize_train_state

    tr, state, batch = _snapshot_trainer(cuda)
    state, _ = tr.train_step(state, batch)
    torch.cuda.synchronize()
    want = _host_copy(state)
    with AsyncCheckpointEngine(str(tmp_path), keep=1) as eng:
        eng.snapshot(state, 1)
        state = resize_train_state(tr.cfg.sync, state, 3)
        junk = [torch.full((4096, 2048), 7.0, device=cuda)
                for _ in range(8)]
        eng.wait()
        out, _ = restore(str(tmp_path / "step_00000001"), want)
    _equal_trees(out, want)
    assert state.params["w"].shape[0] == 3 and len(junk) == 8


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_training_step_grads_bit_equal_to_none(cuda, remat):
    """One training step of qwen2-vl's smoke decoder in bf16 on the card
    (M-RoPE, patch embeddings, the codec's leaves): the gradients and the
    updated parameters under ``remat`` equal those under ``"none"`` bit
    for bit, since recompute runs the same kernels on the same inputs."""
    from repro_torch import tree as T
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.training.trainer import Trainer, TrainerConfig

    base = get_arch("qwen2-vl-2b").smoke.replace(param_dtype="bfloat16",
                                                 compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, base.vocab_size, (2, 2, 65), generator=gen,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "patch_emb": 0.02 * torch.randn(
                 2, 2, base.vision_patches, base.d_model, generator=gen,
                 device=cuda)}
    out = {}
    for r in ("none", remat):
        cfg = base.replace(remat=r)
        tr = Trainer(lambda p, b, cfg=cfg: transformer.loss_fn(p, cfg, b),
                     lambda g, cfg=cfg: transformer.init_params(g, cfg,
                                                                cuda),
                     TrainerConfig(n_pods=2, optimizer="sgd", lr=0.1),
                     device=cuda)
        state = tr.init_state(0)
        pp = T.tree_map(lambda x: x[0].detach().requires_grad_(True),
                        state.params)
        loss, _ = transformer.loss_fn(pp, cfg, {k: v[0]
                                                for k, v in batch.items()})
        grads = torch.autograd.grad(loss, T.leaves(pp))
        state, metrics = tr.train_step(state, batch)
        torch.cuda.synchronize()
        out[r] = (grads, T.leaves(state.params), metrics["loss_per_pod"])
    (g0, p0, l0), (g1, p1, l1) = out["none"], out[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    assert all(torch.equal(x, y) for x, y in zip(p0, p1))


# ------------------------------------------------------- the mesh path


@pytest.fixture
def nccl_one_rank(cuda):
    """A one-rank NCCL group (a ``HashStore``, no network) and a (1, 1)
    in-pod mesh on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh(1, 1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_ops_refuse_a_dtensor_on_the_card(cuda, nccl_one_rank):
    from torch.distributed.tensor import Replicate, distribute_tensor

    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.randn(2, 8192, device=cuda), nccl_one_rank,
                          rep)
    q = distribute_tensor(torch.randn(1, 128, 2, 64, device=cuda,
                                      dtype=torch.bfloat16),
                          nccl_one_rank, rep)
    encode, decode = ops.wan_codec_fns(block=4096)
    before = dict(ops.LAUNCHES)
    for call in (lambda: encode(x, 41), lambda: decode(x, x, x, 8192),
                 lambda: ops.wan_encode(x, 41),
                 lambda: ops.wan_decode(x, x, x, 8192),
                 lambda: ops.topk_compress(x, 10),
                 lambda: ops.topk_compress_chunked(x, 4096, 10),
                 lambda: ops.topk_decompress(x, x, 8192),
                 lambda: ops.flash_attention(q, q, q),
                 lambda: ops.ssd_scan(q, q[..., 0], q, q)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
    assert ops.LAUNCHES == before


def _pod_ring_rank(rank: int, store_file: str, out_file: str) -> None:
    """One rank of the two-card pod ring: 4 pods, 2 per card."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core.sync import PodAxis

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_file, 2),
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    try:
        gen = torch.Generator().manual_seed(0)
        whole = torch.randn(4, 3, 5, generator=gen).cuda()
        pods = PodAxis(4, dist.group.WORLD)
        mine = pods.rows(whole)
        ok = all(torch.equal(pods.roll(mine, s),
                             pods.rows(torch.roll(whole, s, dims=0)))
                 for s in (1, 2, 3))
        ok = ok and torch.allclose(pods.mean(mine),
                                   whole.mean(dim=0, keepdim=True))
        if rank == 0:
            torch.save({"ok": ok, "sends": pods.sends}, out_file)
    finally:
        dist.destroy_process_group()


def test_two_card_pod_ring(cuda, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("the pod ring across cards needs two cards")
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    out = str(tmp_path / "out.pt")
    procs = [ctx.Process(target=_pod_ring_rank,
                         args=(r, str(tmp_path / "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    res = torch.load(out)
    assert res["ok"] and res["sends"] > 0
