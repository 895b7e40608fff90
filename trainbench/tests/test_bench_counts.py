"""The counts behind ``train_mfu_pct`` and the roofline metrics, against
hand counts of both configurations."""
import json

import pytest

from trainbench import counts, harness
from trainbench.reference.model import Spec


def _cell(name):
    return harness.load_cell(name)


def test_granite_x2_matmul_parameters():
    spec = _cell("granite8b-asgdga-int8").spec
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2          # wq, wo, wk, wv
    mlp = 3 * 4096 * 14336
    head = 4096 * 49152
    assert counts.matmul_params_per_token(spec) == 2 * (attn + mlp) + head
    assert counts.matmul_params_per_token(spec) == 637_534_208


def test_qwen3_moe_x1_active_matmul_parameters():
    spec = _cell("qwen3moe-asgdga-int8").spec
    attn = 2048 * 4096 * 2 + 2048 * 512 * 2
    active = 2048 * 128 + 8 * 3 * 2048 * 768           # router, 8 experts
    head = 2048 * 151936                               # not the padding
    assert counts.matmul_params_per_token(spec) == attn + active + head
    assert round(counts.matmul_params_per_token(spec) / 1e6) == 368


def test_granite_step_flops():
    cell = _cell("granite8b-asgdga-int8")
    tokens = 8 * 512
    attn = 3 * 4 * 32 * 128 * (512 * 513 / 2) * 8 * 2
    assert counts.step_flops(cell.spec, cell.mix) == pytest.approx(
        6 * 637_534_208 * tokens + attn, rel=1e-12)


def test_granite_codec_round_bytes():
    cell = _cell("granite8b-asgdga-int8")
    n = 838_881_280
    nb = n // 4096                                     # 204,805 blocks
    wire = nb * 41 * 5 + nb * 4                        # codes, idx, scales
    per_pod = (4 * n + wire) + 2 * (wire + 4 * n)
    assert counts.codec_round_bytes(cell.spec, cell.mix) == 2 * per_pod


def test_qwen_codec_bytes_cover_every_bucket():
    cell = _cell("qwen3moe-asgdga-int8")
    from trainbench.reference.train import packing
    groups = packing(cell.spec, cell.mix["sync"])
    assert [g for g, _ in groups] == ["embed", "norm", "dense", "moe",
                                      "router"]
    total = sum(size for _, leaves in groups for _, size in leaves)
    # two 153,600-row tables, attention, two norms, router, 128 experts
    assert total == (2 * 153_600 * 2048 + 18_874_368 + 2 * 2048
                     + 2048 * 128 + 3 * 128 * 2048 * 768 + 2048)
    assert counts.codec_round_bytes(cell.spec, cell.mix) > 2 * 3 * 4 * total


def test_spec_reads_the_published_keys():
    g = json.load(open(harness.HERE / "configs" / "granite-8b-x2.json"))
    q = json.load(open(harness.HERE / "configs"
                       / "qwen3-moe-30b-a3b-x1.json"))
    gs, qs = Spec.from_file(g), Spec.from_file(q)
    assert (gs.n_layers, gs.d_model, gs.n_heads, gs.n_kv_heads,
            gs.head_dim, gs.d_ff, gs.vocab, gs.vocab_rows) == \
        (2, 4096, 32, 8, 128, 14336, 49152, 49152)
    assert not gs.moe and gs.norm_eps == g["rms_norm_eps"]
    assert (qs.n_layers, qs.d_model, qs.n_heads, qs.n_kv_heads,
            qs.head_dim, qs.d_ff, qs.vocab, qs.vocab_rows) == \
        (1, 2048, 32, 4, 128, 768, 151936, 153600)
    assert (qs.num_experts, qs.top_k, qs.router_aux_weight,
            qs.capacity_factor, qs.router_z_weight) == \
        (128, 8, 0.01, 1.25, 0.001)
    with pytest.raises(ValueError):
        Spec.from_file(dict(g, tie_word_embeddings=True))
