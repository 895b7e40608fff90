"""WAN bandwidth estimation, the part of ``repro/core/autotune.py`` that
the serving plane needs (its lines 133-196): :class:`WanProbeEstimator` and
:class:`WanProbe`, copied.  The adaptive sync controllers of that module
are ROADMAP.md Queue 1 item 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_EPS = 1e-12


class WanProbeEstimator:
    """Bandwidth EMA + fluctuation estimator, shareable across controllers.

    The per-bucket controller holds ONE of these for all bucket rungs (the
    WAN does not care which bucket's bytes it carries), and the single-
    bucket controller embeds its own; both consume the same achieved-
    bandwidth samples (simulator, ``--wan-trace``, or ``bandwidth_changed``
    events off the control-plane bus).

    ``cliff_snap`` (off at 0): when a sample comes in more than
    ``cliff_snap``x BELOW the EMA, the belief snaps to the sample instead
    of averaging toward it — smoothing exists for noise, and a bandwidth
    collapse is not noise.  The fluctuation estimate still absorbs the
    full deviation first (a cliff IS fluctuation), and recoveries stay
    smoothed (optimism is what the EMA protects against).  The
    multi-bucket controller enables this by default, so one observation
    of a crashed link reprices every bucket's escalation before the next
    transfer is paid."""

    def __init__(self, alpha: float = 0.5, cliff_snap: float = 0.0):
        self.alpha = alpha
        self.cliff_snap = cliff_snap
        self._ema: Optional[float] = None
        self._var: float = 0.0        # EMA of squared relative deviation

    def observe(self, bandwidth_mbps: float) -> "WanProbe":
        b = float(bandwidth_mbps)
        if self._ema is None:
            self._ema = b
        else:
            rel = (b - self._ema) / (self._ema + _EPS)
            self._var += self.alpha * (rel * rel - self._var)
            if self.cliff_snap > 0 and b * self.cliff_snap < self._ema:
                self._ema = b
            else:
                self._ema += self.alpha * (b - self._ema)
        return self.probe

    @property
    def bandwidth_mbps(self) -> Optional[float]:
        return self._ema

    @property
    def probe(self) -> "WanProbe":
        return WanProbe(
            bandwidth_mbps=self._ema if self._ema is not None else 0.0,
            fluctuation=self._var ** 0.5)


@dataclass(frozen=True)
class WanProbe:
    """Smoothed WAN picture: bandwidth EMA + fluctuation (EMA coefficient
    of variation), fed by the simulator, a ``--wan-trace``, or
    ``bandwidth_changed`` events off the control-plane ``EventBus``."""

    bandwidth_mbps: float
    fluctuation: float = 0.0
