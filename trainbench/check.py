"""The comparison that decides ``correct``: the program's first steps
against the reference's, on the same weights and batches.

Each number is the worst over pods (and steps, or leaves):

- ``loss``: ``|loss - ref| / |ref|`` of every checked step;
- ``grad``: the first gradient as the optimizer got it, by leaf;
- ``change``: the change of the parameters over the checked steps, by
  leaf, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (round-off alone moves them);
- ``ef``: the error-feedback residual after the first round, by leaf.

By leaf, a number is the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

QUIET_LEAF = 1e-3


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> float:
    med = statistics.median(ref.values())
    return max(abs(got[k] - r) / max(r, med, 1e-30)
               for k, r in ref.items() if keep is None or k in keep)


def compare(got: dict, ref: dict) -> Dict[str, float]:
    pods = range(len(ref["grad"]))
    out = {"loss": max(abs(a - r) / abs(r)
                       for ga, ra in zip(got["loss"], ref["loss"])
                       for a, r in zip(ga, ra)),
           "grad": max(_leaf_gap(got["grad"][p], ref["grad"][p])
                       for p in pods)}
    keep: List[set] = []
    for p in pods:
        med = statistics.median(ref["grad"][p].values())
        keep.append({k for k, g in ref["grad"][p].items()
                     if g >= QUIET_LEAF * med})
    out["change"] = max(_leaf_gap(got["change"][p], ref["change"][p],
                                  keep[p]) for p in pods)
    if ref.get("ef") is not None and got.get("ef") is not None:
        out["ef"] = max(_leaf_gap(got["ef"][p], ref["ef"][p]) for p in pods)
    return out
