"""The batch generator: shapes, shifted labels, seeded and distinct rows."""
import torch

from trainbench import traffic
from trainbench.tests.tiny import tiny_cell


def test_ring_shapes_labels_and_seed():
    mix = tiny_cell("granite8b-asgdga-int8").mix
    a = traffic.ring(mix, 500, 2**31 + 3, "cpu")
    b = traffic.ring(mix, 500, 2**31 + 3, "cpu")
    assert len(a) == mix["tokens"]["ring"]
    assert a[0]["tokens"].shape == (2, 2, 16)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    # labels are the next tokens
    assert torch.equal(a[0]["tokens"][..., 1:], a[0]["labels"][..., :-1])
    assert bool((a[0]["mask"] == 1).all())
    rows = torch.stack([r["tokens"] for r in a]).reshape(-1, 16)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    assert int(rows.max()) < 500


def test_pods_draw_from_their_own_laws():
    mix = dict(tiny_cell("granite8b-asgdga-int8").mix, seq=255,
               global_batch=64)
    ring = traffic.ring(mix, 500, 1, "cpu")
    ids = torch.stack([r["tokens"] for r in ring])        # (R, P, B, S)
    top_share = [torch.bincount(ids[:, p].reshape(-1), minlength=500)
                 .max().item() / ids[:, p].numel() for p in range(2)]
    # Zipf 1.1 puts more on its top id than Zipf 0.8
    assert top_share[0] > 1.5 * top_share[1]
