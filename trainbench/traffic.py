"""The one batch generator every traffic mix feeds.

A mix's ``tokens`` entry gives, per pod, the exponent ``s`` of a Zipf law
over the vocabulary (``p(rank r) ~ r ** -s``; 0 is uniform), each pod over
its own random ranking of the ids (clouds hold different data), and the
number of distinct batches in the ring the window cycles through.  Every
row is ``seq + 1`` ids drawn on the device from the seed; the tokens are
its first ``seq``, the labels its last ``seq`` and the mask all ones.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def ring(mix: dict, vocab: int, seed: int, device
         ) -> List[Dict[str, torch.Tensor]]:
    """``mix["tokens"]["ring"]`` batches, each ``{tokens, labels, mask}`` of
    shape ``(pods, global_batch // pods, seq)``."""
    pods, seq = int(mix["pods"]), int(mix["seq"])
    rows = int(mix["global_batch"]) // pods
    zipf = mix["tokens"]["zipf"]
    n_ring = int(mix["tokens"]["ring"])
    if len(zipf) != pods or rows * pods != int(mix["global_batch"]):
        raise ValueError("the mix needs one Zipf exponent a pod and a "
                         "global batch that the pods split evenly")
    gen = torch.Generator(device=device).manual_seed(seed)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    ids = torch.empty(n_ring, pods, rows, seq + 1, dtype=torch.int64,
                      device=device)
    for p, s in enumerate(zipf):
        cdf = torch.cumsum(ranks ** -float(s), 0)
        cdf = (cdf / cdf[-1]).float()
        perm = torch.randperm(vocab, generator=gen, device=device)
        u = torch.rand(n_ring, rows, seq + 1, generator=gen, device=device)
        ids[:, p] = perm[torch.searchsorted(cdf, u).clamp(max=vocab - 1)]
    ids = ids.to(torch.int32)
    mask = torch.ones(pods, rows, seq, dtype=torch.float32, device=device)
    return [{"tokens": ids[i, ..., :-1].contiguous(),
             "labels": ids[i, ..., 1:].contiguous(), "mask": mask}
            for i in range(n_ring)]
