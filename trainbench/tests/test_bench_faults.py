"""A run with the timed path broken underneath comes out not ``correct``:
the harness's look for a card skipped, everything else as in a run, at
toy sizes on the CPU, under each cell's own limits.  Then the control, the
reference at fp8 in the program's place, fails them too; on the card, at
the cell's own size, over three seeds."""
import time

import pytest
import torch

from trainbench import harness
from trainbench.tests.tiny import CELLS, tiny_cell

from repro_torch.core import sync as S


def frozen_step(prog):
    """A step that computes each pod's loss and returns its state
    unchanged."""
    tr = prog.trainer

    def step(state, batch):
        n = int(prog.trainer.cfg.n_pods)
        with torch.no_grad():
            losses = [tr.loss_fn(
                {k: _pod(v, p) for k, v in state.params.items()},
                {k: v[p] for k, v in batch.items()})[0] for p in range(n)]
        return state._replace(step=state.step + 1), {
            "loss_per_pod": torch.stack(losses).float(),
            "grad_norm": torch.zeros(n)}
    tr._train_step = step


def _pod(tree, p):
    if isinstance(tree, dict):
        return {k: _pod(v, p) for k, v in tree.items()}
    return tree[p]


def half_batch(prog):
    """Each pod's loss, and so its mean, over the first half of its rows."""
    tr, loss_fn = prog.trainer, prog.trainer.loss_fn

    def half(params, batch):
        return loss_fn(params, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})
    tr.loss_fn = half


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch,
          "no_exchange": None}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_program_is_not_correct(cell_name, fault, monkeypatch):
    if fault == "no_exchange":
        # the ring between pods delivers each pod its own rows
        real = S.PodAxis.roll
        monkeypatch.setattr(S.PodAxis, "roll", lambda self, x, shift: x
                            if not self.split else real(self, x, shift))
    for seed in (2**31 + 11, 5):
        out = harness.run(tiny_cell(cell_name), seed, 0.0, False,
                          time.perf_counter(), device="cpu",
                          program_hook=FAULTS[fault])
        assert not out.result["correct"], (seed, out.checks)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name):
    from trainbench import traffic, weights
    from trainbench.check import compare
    from trainbench.reference.model import fp8_mm_fn
    from trainbench.reference.train import Reference

    cell = tiny_cell(cell_name)
    spec, mix = cell.spec, cell.mix
    for seed in (2**31 + 21, 22, 23):
        p0 = weights.make(spec, seed, "cpu", torch.bfloat16)
        batches = traffic.ring(mix, spec.vocab, seed + 1, "cpu")[:3]
        ref = Reference(spec, mix).run(p0, batches)
        got = Reference(spec, mix, mm=fp8_mm_fn()).run(p0, batches)
        numbers = compare(got, ref)
        assert any(numbers[k] > lim for k, lim in cell.limits.items()), \
            (seed, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the cell's own size")
    from trainbench import traffic, weights
    from trainbench.check import compare
    from trainbench.reference.model import fp8_mm_fn, no_tf32
    from trainbench.reference.train import Reference

    cell = harness.load_cell(cell_name)
    spec, mix = cell.spec, cell.mix
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        p0 = weights.make(spec, seed, "cuda", torch.bfloat16)
        batches = traffic.ring(mix, spec.vocab, seed + 1, "cuda")[:3]
        with no_tf32():
            ref = Reference(spec, mix).run(p0, batches)
            got = Reference(spec, mix, mm=fp8_mm_fn()).run(p0, batches)
        numbers = compare(got, ref)
        assert any(numbers[k] > lim for k, lim in cell.limits.items()), \
            (seed, numbers)
        del p0, batches, ref, got
        torch.cuda.empty_cache()
