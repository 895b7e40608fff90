"""WAN transport layer, the host-only part: :class:`TransferRecord` and
:class:`MeasuredWanProbe`, copied from ``repro/core/transport.py`` (its
lines 56-139).

The measured-feedback data path::

    transport.ship_bucket -> TransferRecord (wire MB, seconds)
        -> transport.on_sync -> MeasuredWanProbe.observe_transfer
        -> WanProbeEstimator (EMA + fluctuation + cliff-snap)
        -> Adaptive/BucketedSyncController(probe_est=...)

The transports themselves (``WanTransport``, ``SimTransport``,
``MeshTransport`` and the streaming round) are ROADMAP.md Queue 1 item 11;
until then the port's sync rounds ship over the inline ring
(``repro_torch.core.sync.InlineRingShip``) and a probe is fed by hand or
from a recorded stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.autotune import WanProbe, WanProbeEstimator

_EPS = 1e-9


@dataclass
class TransferRecord:
    """One bucket's shipped transfer: wire bytes and how long they took.

    ``seconds`` is measured wall-clock for the reference's
    ``MeshTransport`` and the simulator-billed time for its
    ``SimTransport`` — downstream consumers
    (the probe, telemetry, benchmarks) cannot tell the difference, which
    is the point of the seam."""

    bucket: str
    payload_mb: float
    seconds: float
    step: Optional[int] = None

    @property
    def mbps(self) -> float:
        """Achieved bandwidth of this transfer (megabits/second)."""
        return self.payload_mb * 8.0 / max(self.seconds, _EPS)


class MeasuredWanProbe:
    """Feeds a :class:`~repro_torch.core.autotune.WanProbeEstimator` from
    transport-reported transfer times instead of declared trace events.

    One observation per sync round (the round's total wire MB over its
    total seconds): achieved bandwidth = ``payload_mb * 8 / seconds``.
    The estimator's cliff-snap still applies — one observation of a
    collapsed link reprices the belief before the next transfer is paid.
    Hand ``estimator`` to a controller's ``probe_est`` to close the loop
    with no trace wired to the controller."""

    def __init__(self, alpha: float = 0.5, cliff_snap: float = 4.0,
                 estimator: Optional[WanProbeEstimator] = None):
        self.estimator = (estimator if estimator is not None
                          else WanProbeEstimator(alpha=alpha,
                                                 cliff_snap=cliff_snap))
        self.n_observations = 0
        self.last_mbps: Optional[float] = None
        # chunk-granular observations (the streaming seam): each chunk's
        # (wire MB, seconds, mbps) lands here AS IT LANDS, mid-round — the
        # StreamingShipController reads these to retune before the round
        # finishes.  The shared estimator still folds exactly once per
        # round (at the round barrier), so round-level controllers see the
        # identical belief stream whether streaming is on or off.
        self.n_chunk_observations = 0
        self.last_chunk_mbps: Optional[float] = None
        self.chunk_log: List[Tuple[float, float, float]] = []

    def observe_transfer(self, payload_mb: float, seconds: float) -> WanProbe:
        """Fold one (wire MB, seconds) sample into the bandwidth belief.

        Degenerate samples — no bytes moved (an empty, skipped or fully
        degraded round) or a non-positive duration — are dropped, not
        folded: ``mbps -> ~0`` on them, and the estimator's cliff-snap
        would read that as a collapsed link and wedge the belief (and the
        autotuner with it) at the floor over a round that never touched
        the network."""
        if payload_mb <= 0.0 or seconds <= 0.0:
            return self.probe
        mbps = payload_mb * 8.0 / max(seconds, _EPS)
        self.last_mbps = mbps
        self.n_observations += 1
        return self.estimator.observe(mbps)

    def observe_chunk(self, payload_mb: float, seconds: float) -> None:
        """Record one landed chunk's measured transfer, mid-round.

        Deliberately does NOT touch the estimator: the round-level belief
        folds once per round via :meth:`observe_transfer` (bit-identical
        to the non-streaming path), while the chunk log gives the
        streaming controller its first-chunk feedback."""
        if payload_mb <= 0.0 or seconds <= 0.0:
            return
        mbps = payload_mb * 8.0 / max(seconds, _EPS)
        self.last_chunk_mbps = mbps
        self.n_chunk_observations += 1
        self.chunk_log.append((payload_mb, seconds, mbps))

    @property
    def probe(self) -> WanProbe:
        return self.estimator.probe
