"""The reference's first steps of a cell: every pod's SGD step, and the
mix's ``asgd_ga`` round where it falls due, in plain PyTorch.

Parameters are stored in the configuration's ``param_dtype`` (bf16) and
each update is worked out in float32 and rounded back into them, as the
configuration states; losses and gradients come from :mod:`model` in
float32.  Every pod accumulates its float32 gradients; at the round each
pod's mean gradient plus its error-feedback residual is packed bucket by
bucket, encoded (:mod:`codec`), sent one step round the ring (pod ``p``
receives from pod ``p - 1``), decoded, and applied as an SGD step of the
receiver; the residual keeps what the encoding lost.

:meth:`Reference.run` gives, per pod, what the comparison reads: each
step's loss, and each leaf's norm of the first gradient as the optimizer
got it, of the change of the parameters over the steps, and of the
residual after the first round.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from trainbench.reference import codec
from trainbench.reference.model import (MatMul, Spec, f32_mm, grads_of,
                                        layout, path_str)

Path = Tuple[str, ...]
FAULTS = ("half_batch", "no_exchange")


def classify(path: Path, ndim: int, buckets: dict) -> str:
    """The bucket group of one leaf: the first group with a pattern in its
    path, else ``vector`` for a leaf of rank <= 1, else ``fallback``."""
    low = path_str(path).lower()
    for name, subs in buckets["patterns"]:
        if any(s in low for s in subs):
            return name
    return buckets["vector"] if ndim <= 1 else buckets["fallback"]


def packing(spec: Spec, sync: dict) -> List[Tuple[str, List[Tuple[Path, int]]]]:
    """``[(bucket, [(leaf, size)])]`` in wire order: buckets in their
    declared order, leaves in layout order within each."""
    leaves = layout(spec)
    buckets = sync.get("buckets")
    if buckets is None:
        return [("all", [(p, math.prod(s)) for p, s in leaves])]
    groups: Dict[str, List[Tuple[Path, int]]] = {n: [] for n in
                                                 buckets["names"]}
    for p, s in leaves:
        groups[classify(p, len(s), buckets)].append((p, math.prod(s)))
    return [(n, groups[n]) for n in buckets["names"] if groups[n]]


def _norms(tree: Dict[Path, torch.Tensor]) -> Dict[str, float]:
    return {path_str(k): float(v.float().norm()) for k, v in tree.items()}


class Reference:
    """One run of the reference (or of the control, with a lower-precision
    ``mm``) over the same weights and batches as the program's."""

    def __init__(self, spec: Spec, mix: dict, mm: MatMul = f32_mm,
                 fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.spec, self.mix, self.mm, self.fault = spec, mix, mm, fault
        self.sync = mix.get("sync", {})
        self.pods = mix["pods"]

    def _batch(self, batch: Dict[str, torch.Tensor], p: int):
        b = {k: v[p] for k, v in batch.items()}
        if self.fault == "half_batch":
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
        return b

    def _peer(self, p: int) -> int:
        return p if self.fault == "no_exchange" else (p - 1) % self.pods

    def run(self, params0: Dict[Path, torch.Tensor],
            batches: Sequence[Dict[str, torch.Tensor]]) -> dict:
        """``params0``: one pod's stored parameters (every pod starts from
        them); ``batches``: one stacked ``(pods, rows, seq)`` batch a step.
        Returns ``{loss: [step][pod], grad, change, ef: [pod]{leaf:
        norm}}`` (``ef`` None without error feedback)."""
        if self.mix["strategy"] != "asgd_ga":
            raise ValueError("the reference's round is asgd_ga's")
        lr, P = float(self.mix["lr"]), self.pods
        params = [{k: v.clone() for k, v in params0.items()}
                  for _ in range(P)]
        acc = [{k: torch.zeros(v.shape, device=v.device)
                for k, v in params0.items()} for _ in range(P)]
        out = {"loss": [], "grad": [None] * P, "change": [None] * P,
               "ef": None}
        self._ef = None
        since = 0
        for step, batch in enumerate(batches):
            row = []
            for p in range(P):
                loss, g = grads_of(params[p], self.spec,
                                   self._batch(batch, p), self.mm)
                row.append(loss)
                for k in g:
                    acc[p][k].add_(g[k])
                if step == 0:
                    out["grad"][p] = _norms(g)
                params[p] = {k: (v.float() - lr * g[k]).to(v.dtype)
                             for k, v in params[p].items()}
                del g
            out["loss"].append(row)
            since += 1
            if P > 1 and (step + 1) % int(self.mix["interval"]) == 0:
                ef = self._codec_round(params, acc, since, lr)
                if out["ef"] is None:
                    out["ef"] = ef
                since = 0
        out["change"] = [_norms({k: params[p][k].float() - params0[k].float()
                                 for k in params0}) for p in range(P)]
        return out

    def _codec_round(self, params, acc, since: int, lr: float):
        """One ``asgd_ga`` round through the codec; returns each pod's
        residual norms by leaf."""
        s = self.sync
        if not (s.get("quantize_int8") and 0 < s["compress_topk"] < 1):
            raise ValueError("the reference's asgd_ga round is the codec's")
        P, groups = self.pods, packing(self.spec, s)
        scale = float(torch.tensor(lr, dtype=torch.float32)
                      * s.get("ga_lr_scale", 1.0))
        ef = self._ef or [None] * P
        sent, resid = [], []
        for p in range(P):
            parts, residual = [], {}
            for name, leaves in groups:
                flat = torch.cat([acc[p][k].reshape(-1) for k, _ in leaves])
                flat.div_(float(since))
                if ef[p] is not None:
                    flat.add_(ef[p][name])
                n = flat.shape[0]
                block = min(int(s["codec_block"]), n)
                wire = codec.encode(flat, codec.k_per_block(
                    block, s["compress_topk"]), block)
                parts.append((name, wire, n, block))
                if s.get("error_feedback"):
                    flat.sub_(codec.decode(*wire, n, block))
                    residual[name] = flat
            sent.append(parts)
            resid.append(residual)
        for p in range(P):
            for (name, wire, n, block), (_, leaves) in zip(sent[self._peer(p)],
                                                           groups):
                dense = codec.decode(*wire, n, block)
                off = 0
                for k, size in leaves:
                    g = dense[off:off + size].reshape(params[p][k].shape)
                    params[p][k] = (params[p][k].float() - scale * g
                                    ).to(params[p][k].dtype)
                    off += size
        for a in acc:
            for v in a.values():
                v.zero_()
        self._ef = resid if self.sync.get("error_feedback") else None
        if self._ef is None:
            return None
        out = []
        for r in resid:
            norms = {}
            for name, leaves in groups:
                off = 0
                for k, size in leaves:
                    norms[path_str(k)] = float(r[name][off:off + size].norm())
                    off += size
            out.append(norms)
        return out
