"""The reference against the program at toy sizes on the CPU: the same
loss and gradients in float32, the frozen codec bit for bit, and
the first steps of every cell within a hair in float32."""
import time

import pytest
import torch

from trainbench import harness, traffic, weights
from trainbench.reference import codec
from trainbench.reference.model import grads_of, nest
from trainbench.tests.tiny import CELLS, tiny_cell

from repro_torch.kernels import ref as kref
from repro_torch.models import transformer


@pytest.mark.parametrize("cell_name", ["granite8b-asgdga-int8",
                                       "qwen3moe-asgdga-int8"])
def test_loss_and_grads_match_the_program_in_f32(cell_name):
    cell = tiny_cell(cell_name, dtype="float32")
    prog = harness.Program(cell, "cpu")
    spec = cell.spec
    p0 = weights.make(spec, 3, "cpu", torch.float32)
    batch = {k: v[0] for k, v in traffic.ring(cell.mix, spec.vocab, 4,
                                              "cpu")[0].items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    loss, _ = transformer.loss_fn(nest(leaves), prog.cfg, batch)
    g_prog = torch.autograd.grad(loss, list(leaves.values()))
    ref_loss, g_ref = grads_of(p0, spec, batch)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    for (k, gr), gp in zip(g_ref.items(), g_prog):
        assert float((gp - gr).norm()) <= 1e-4 * max(float(gr.norm()),
                                                     1e-12), k


@pytest.mark.parametrize("n,block,frac", [(10_000, 256, 0.01),
                                          (4096 * 3, 4096, 0.05),
                                          (777, 128, 0.3)])
def test_frozen_codec_is_the_programs_bit_for_bit(n, block, frac):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g)
    x[::7] = x[3]                       # ties at the threshold
    x[: block] = 0.0                    # an all-zero block
    kb = codec.k_per_block(min(block, n), frac)
    q, idx, s = kref.wan_encode(x, kb, block=block)
    codes, loc, scales = codec.encode(x, kb, block)
    assert torch.equal(q.float().reshape(codes.shape), codes)
    assert torch.equal(idx.long().reshape(loc.shape), loc)
    assert torch.equal(s, scales)
    assert torch.equal(kref.wan_decode(q, idx, s, n, block=block),
                       codec.decode(codes, loc, scales, n, block))


@pytest.mark.parametrize("cell_name", CELLS)
def test_first_steps_agree_in_f32(cell_name):
    out = harness.run(tiny_cell(cell_name, dtype="float32"), 7, 0.0, False,
                      time.perf_counter(), device="cpu")
    assert all(v <= 1e-4 for v, _ in out.checks.values()), out.checks
