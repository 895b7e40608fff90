"""Cells of the benchmark's own files cut to sizes a CPU test holds."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from trainbench import harness  # noqa: E402


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_cell(cell_name: str, dtype: str = "bfloat16",
              limits: bool = True) -> harness.Cell:
    """``cell_name``'s configuration and mix at toy widths: 64 wide, 4 heads
    over 2, 8 experts top-2 for a mixture, a 500-id vocabulary in 512 rows,
    4 rows of 16 tokens, codec blocks of 256.  ``dtype`` sets the
    parameter and compute dtype of the program and the file alike."""
    bench = _json(ROOT / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[cell_name]
    cfg = copy.deepcopy(_json(harness.HERE / "configs" / f"{w['config']}.json"))
    mix = copy.deepcopy(_json(harness.HERE / "traffic" / f"{w['traffic']}.json"))
    moe = "num_experts" in cfg
    sizes = dict(n_layers=1 if moe else 2, d_model=64, n_heads=4,
                 n_kv_heads=2, head_dim=16, d_ff=32 if moe else 96)
    rep = dict(sizes, vocab_size=500, vocab_multiple=256, param_dtype=dtype,
               compute_dtype=dtype)
    if moe:
        rep["moe"] = dict(num_experts=8, top_k=2)
    cfg["program"]["replace"] = rep
    cfg.update(num_hidden_layers=sizes["n_layers"], hidden_size=64,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               vocab_size=500, torch_dtype=dtype)
    cfg["moe_intermediate_size" if moe else "intermediate_size"] = \
        sizes["d_ff"]
    cfg["port"].update(vocab_rows=512, compute_dtype=dtype)
    if moe:
        cfg.update(num_experts=8, num_experts_per_tok=2)
    mix.update(global_batch=4, seq=16)
    if "codec_block" in mix["sync"]:
        mix["sync"]["codec_block"] = 256
    lim = (_json(harness.HERE / "limits" / f"{cell_name}.json") if limits
           else {})
    return harness.Cell(name=cell_name, config=cfg, mix=mix, limits=lim,
                        metrics=[])


CELLS = ("granite8b-asgdga-int8", "qwen3moe-asgdga-int8")
