"""Data pipeline: synthetic token streams + geo-partitioned datasets.

Numpy-only copy of ``repro/data/pipeline.py``; batches are bit-equal.

Two layers:

1. ``TokenStream`` — deterministic synthetic LM data (per-shard PRNG, no
   disk), shaped like a real tokenized corpus: (tokens, labels=shifted,
   mask).  Used by examples, benchmarks and the end-to-end driver.
2. ``GeoDataset`` — the paper's *pre-existing, unevenly distributed* training
   data: one shard per cloud/pod with an arbitrary distribution ratio
   (e.g. 2:1 between Shanghai/Chongqing).  The elastic scheduler consumes
   the shard sizes; per-pod loaders draw only from their own shard, which is
   what makes inter-pod sync a *model* sync rather than a data exchange —
   the paper's federated-ish constraint.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TokenStream:
    """Deterministic synthetic LM token stream."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    # structured-synthetic mode: tokens follow a learnable bigram process so
    # training loss actually decreases (used by convergence tests)
    structured: bool = True

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.shard) * 1_000_003 + step)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, V = self.batch_size, self.seq_len + 1, self.vocab_size
        if self.structured:
            # bigram next = (3 * tok + noise) % V : learnable structure
            toks = np.empty((B, S), np.int32)
            toks[:, 0] = rng.integers(0, V, size=B)
            noise = (rng.random((B, S)) < 0.1)
            rand = rng.integers(0, V, size=(B, S))
            for t in range(1, S):
                nxt = (3 * toks[:, t - 1] + 1) % V
                toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        else:
            toks = rng.integers(0, V, size=(B, S)).astype(np.int32)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, S - 1), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


# ---------------------------------------------------------------------------
# supervised synthetic sets for the paper's reference models
# ---------------------------------------------------------------------------


def synthetic_classification(
    n: int, input_shape: Tuple[int, ...], n_classes: int, seed: int = 0,
    feature_vocab: Optional[int] = None, task_seed: int = 1234,
) -> Dict[str, np.ndarray]:
    """A learnable synthetic classification set (class-conditional means for
    image-shaped inputs; class-correlated categorical ids for DeepFM-style
    inputs).  ``task_seed`` fixes the underlying concept (class means /
    prototype ids) so different ``seed`` draws are train/test splits of the
    *same* task."""
    task_rng = np.random.default_rng(task_seed)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    if feature_vocab is not None:
        fields = input_shape[0]
        base = task_rng.integers(0, feature_vocab, size=(n_classes, fields))
        x = base[y]
        flip = rng.random((n, fields)) < 0.25
        x = np.where(flip, rng.integers(0, feature_vocab, size=(n, fields)), x)
        return {"x": x.astype(np.int32), "y": y}
    means = task_rng.normal(0, 1, size=(n_classes,) + input_shape).astype(np.float32)
    x = means[y] + rng.normal(0, 1.2, size=(n,) + input_shape).astype(np.float32)
    return {"x": x, "y": y}


# ---------------------------------------------------------------------------
# geo-partitioned dataset
# ---------------------------------------------------------------------------


@dataclass
class GeoShard:
    region: str
    data: Dict[str, np.ndarray]

    @property
    def size(self) -> int:
        return len(self.data["y"])


@dataclass
class GeoDataset:
    """Pre-existing data distributed across clouds with a given ratio."""

    shards: List[GeoShard]

    @classmethod
    def partition(cls, data: Dict[str, np.ndarray], regions: Sequence[str],
                  ratio: Sequence[float], seed: int = 0) -> "GeoDataset":
        n = len(data["y"])
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        total = sum(ratio)
        counts = [int(n * r / total) for r in ratio]
        counts[-1] = n - sum(counts[:-1])
        shards, off = [], 0
        for region, c in zip(regions, counts):
            idx = perm[off:off + c]
            off += c
            shards.append(GeoShard(region,
                                   {k: v[idx] for k, v in data.items()}))
        return cls(shards)

    def sizes(self) -> Dict[str, int]:
        return {s.region: s.size for s in self.shards}

    def loader(self, region: str, batch_size: int, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
        shard = next(s for s in self.shards if s.region == region)
        rng = np.random.default_rng(seed)
        n = shard.size
        while True:
            idx = rng.integers(0, n, size=batch_size)
            yield {k: v[idx] for k, v in shard.data.items()}

    def epoch_batches(self, region: str, batch_size: int) -> int:
        shard = next(s for s in self.shards if s.region == region)
        return max(1, shard.size // batch_size)
