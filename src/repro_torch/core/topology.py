"""Per-link bandwidth beliefs, the part of ``repro/core/topology.py`` that
the serving plane's router needs (its lines 71-121): :func:`link_key` and
:class:`LinkBeliefs`, copied.  The aggregation topologies of that module are
ROADMAP.md Queue 1 item 10.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.autotune import WanProbeEstimator

Link = Tuple[str, str]


def link_key(a: str, b: str) -> Link:
    """Canonical (sorted) key for the undirected inter-region link a<->b."""
    if a == b:
        raise ValueError(f"no WAN link from region {a!r} to itself")
    return (a, b) if a < b else (b, a)


class LinkBeliefs:
    """Per-link bandwidth beliefs: one cliff-snapping estimator per
    inter-region link, the per-link generalization of
    :class:`~repro.core.transport.MeasuredWanProbe`.

    Links never observed report ``default_mbps`` — schedule compilation
    must be total even before the first transfer."""

    def __init__(self, default_mbps: float = 100.0, alpha: float = 0.5,
                 cliff_snap: float = 4.0):
        if default_mbps <= 0:
            raise ValueError("default_mbps must be positive")
        self.default_mbps = float(default_mbps)
        self.alpha = alpha
        self.cliff_snap = cliff_snap
        self._est: Dict[Link, WanProbeEstimator] = {}

    def observe(self, a: str, b: str, mbps: float) -> None:
        """Fold one achieved-bandwidth sample into the a<->b belief."""
        key = link_key(a, b)
        est = self._est.get(key)
        if est is None:
            est = self._est[key] = WanProbeEstimator(
                alpha=self.alpha, cliff_snap=self.cliff_snap)
        est.observe(float(mbps))

    def mbps(self, a: str, b: str) -> float:
        est = self._est.get(link_key(a, b))
        if est is None or est.bandwidth_mbps is None:
            return self.default_mbps
        return est.bandwidth_mbps

    def snapshot(self) -> Dict[str, float]:
        """``"a|b" -> belief`` for every observed link (bench recording)."""
        return {f"{a}|{b}": round(e.bandwidth_mbps, 6)
                for (a, b), e in sorted(self._est.items())
                if e.bandwidth_mbps is not None}
