"""Pluggable WAN transport layer: one seam from the billed simulator to a
host-timed ship on the card.

Counterpart of ``repro/core/transport.py``.  The sync layer
(``repro_torch.core.sync``) produces wire payloads (per-bucket
:class:`~repro_torch.core.sync.ChunkPayload` triples) and consumes them
back; who moves the bytes to the ring peer, and how long
that took, is this module's job.  Three implementations of one protocol:

- the **inline ring** (``transport=None`` /
  :class:`~repro_torch.core.sync.InlineRingShip`): ``torch.roll`` over the
  pod dimension, no timing; point to point over the pod group when the
  pod axis is split over processes.
- :class:`SimTransport`: ships over the same inline ring (so its rounds
  are the inline rounds, bit for bit) and *bills* every sync round against
  a :class:`~repro_torch.core.wan.BandwidthTrace` and
  :class:`~repro_torch.core.wan.WANConfig` with the simulator's own
  ``transfer_time`` law (lognormal fluctuation, latency, seeded numpy
  generator): host arithmetic, float for float the reference's.
- :class:`MeshTransport`: a host-timed ship.  Each bucket's transfer runs
  on its own, between device waits, and its wall-clock goes into a
  :class:`TransferRecord`.  It is single-process, as the reference's is:
  with at least ``n_pods`` devices each pod row lives on its own device and
  the ship copies row ``p`` to device ``(p + shift) % n``; with fewer it is
  a roll on the payload's own device.  On a pod axis split over
  processes the rows already sit one pod a rank, and the timed ship is the
  axis's point-to-point ring.  ``emulate_mbps`` adds a WAN-scale hop.
  :meth:`MeshTransport.measure_overlap` measures what
  ``SyncConfig.overlap_chunks`` pipelining buys, in one process.

Every transport ships over the ring of the pod axis it is bound to
(:meth:`WanTransport.bind`; the ``Trainer`` binds its own, default the
whole axis).  Billing is seeded host arithmetic, the same on every rank;
a measured second is agreed over the pod group (the max over the ranks,
:meth:`~repro_torch.core.sync.PodAxis.agree`) before a record, the probe
or a controller reads it, so the ranks of a split axis decide alike.

The measured-feedback data path::

    transport.ship_bucket -> TransferRecord (wire MB, seconds)
        -> transport.on_sync -> MeasuredWanProbe.observe_transfer
        -> WanProbeEstimator (EMA + fluctuation + cliff-snap)
        -> Adaptive/BucketedSyncController(probe_est=...)

The streaming round (``begin_stream_round``, ``stream_chunk`` /
``stream_ship_chunk``, ``retune_stream``, ``end_stream_round``) makes the
chunk, not the round, the unit of WAN feedback: each shipped chunk's billed
or measured seconds land in ``probe.observe_chunk`` as it lands, a
mid-round retune re-prices the re-encoded tail, and the round closes with
the same per-bucket records and the same one probe fold ``on_sync`` makes.
A streaming round without a retune bills bit for bit as the classic one.

Layering: ``sync`` does not import this module (transports are duck-typed
at the seam); this module sits above ``sync``, ``wan`` and ``autotune`` and
below ``training`` and ``launch``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.autotune import WanProbe, WanProbeEstimator
from repro_torch.core.sync import (_INLINE_RING, WHOLE_PODS, ChunkPayload,
                                   PodAxis, SyncConfig, _chunk_widths,
                                   _decode_bucket, _encode_bucket,
                                   _wire_bits)
from repro_torch.core.wan import (BandwidthTrace, WANConfig, stream_chunk_time,
                                  transfer_time)

_EPS = 1e-9


@dataclass
class TransferRecord:
    """One bucket's shipped transfer: wire bytes and how long they took.

    ``seconds`` is measured wall-clock for :class:`MeshTransport` and the
    simulator-billed time for :class:`SimTransport`; downstream consumers
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


class _StreamRound:
    """Mutable per-round state of a streaming ship (transport-internal).

    ``t_round`` is the round's one clean transfer draw, the same draw the
    classic ``on_sync`` would make, consumed in the same rng order; every
    pre-retune chunk bills its pro-rata share of it
    (``wan.stream_chunk_time``), so the first chunk's achieved bandwidth is
    the round's achieved bandwidth.  A mid-round retune re-prices only the
    re-encoded tail with a second draw (``t_tail`` over ``tail_mb``)."""

    def __init__(self, step: Optional[int], wire_mb: Mapping[str, float],
                 t_round: float):
        self.step = step
        self.wire_mb = dict(wire_mb)
        self.total = float(sum(self.wire_mb.values()))
        self.t_round = t_round
        self.retuned = False
        self.tail_mb = 0.0
        self.t_tail = 0.0
        self.prefix_s = 0.0             # billed seconds before the retune
        self.billed: Dict[str, float] = {}     # bucket -> seconds shipped
        self.shipped: Dict[str, float] = {}    # bucket -> wire MB shipped
        self.chunks: List[Tuple[str, float, float]] = []
        #   (bucket, chunk MB, seconds) in ship order: the replayable
        #   per-chunk observation stream

    def bill(self, name: str, chunk_mb: float) -> float:
        if self.retuned:
            secs = stream_chunk_time(self.t_tail, chunk_mb, self.tail_mb)
        else:
            secs = stream_chunk_time(self.t_round, chunk_mb, self.total)
            self.prefix_s += secs
        self._account(name, chunk_mb, secs)
        return secs

    def bill_measured(self, name: str, chunk_mb: float,
                      secs: float) -> float:
        """Account a chunk whose transfer was timed on the host (mesh): no
        billing law, the measurement is the cost."""
        self._account(name, chunk_mb, secs)
        return secs

    def _account(self, name: str, chunk_mb: float, secs: float) -> None:
        self.billed[name] = self.billed.get(name, 0.0) + secs
        self.shipped[name] = self.shipped.get(name, 0.0) + chunk_mb
        self.chunks.append((name, chunk_mb, secs))

    @property
    def t_total(self) -> float:
        """Round seconds: the untouched clean draw when no retune fired
        (not a sum of chunk slices, whose float association would drift
        the zero-retune bill), else the prefix slices plus the tail draw."""
        if not self.retuned:
            return self.t_round
        return self.prefix_s + self.t_tail

    @property
    def shipped_mb(self) -> float:
        return float(sum(self.shipped.values()))

    def summary(self, t_s: float, t_round: Optional[float] = None) -> Dict:
        """The round as ``stream_rounds`` keeps it."""
        return {"step": self.step, "total_mb": self.total,
                "t_round": self.t_round if t_round is None else t_round,
                "chunks": list(self.chunks), "retuned": self.retuned,
                "tail_mb": self.tail_mb, "t_tail": self.t_tail,
                "shipped_mb": self.shipped_mb, "t_s": t_s}


class WanTransport:
    """The transport protocol ``sync.ship_sync_payloads`` emits payloads to.

    ``in_graph=True`` transports ship inside the round with the inline
    ring's ops; ``in_graph=False`` ones execute and time each bucket's
    transfer at the host seam (and only they verify checksums).
    ``on_sync`` is the round barrier: called on the host once per sync
    round with the per-bucket wire MB, it bills (sim) or flushes (mesh) the
    round's transfers into ``records`` and the probe, returning the
    round's transfer seconds."""

    in_graph: bool = True
    probe: Optional[MeasuredWanProbe] = None
    #: transports that implement the chunk-granular streaming round
    #: (begin_stream_round / stream_* / end_stream_round) set this True;
    #: the trainer ships the classic way (ship_bucket + on_sync) otherwise
    supports_streaming: bool = False

    def __init__(self):
        self.pods: PodAxis = WHOLE_PODS
        self.records: List[TransferRecord] = []
        # replayable per-round streaming summaries (only streaming
        # transports append; kept on the base so consumers can read it
        # unconditionally)
        self.stream_rounds: List[Dict] = []
        self._stream: Optional[_StreamRound] = None

    def bind(self, pods: PodAxis) -> None:
        """Ship over the pod axis ``pods`` from now on: its ring, and its
        agreement for measured seconds (the ``Trainer`` binds its own)."""
        self.pods = pods

    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        raise NotImplementedError

    def on_sync(self, wire_mb: Mapping[str, float],
                step: Optional[int] = None) -> float:
        return 0.0

    # ------------------------------------------- streaming round protocol
    # A streaming round opens with the whole planned per-bucket wire
    # schedule, ships chunk by chunk (each chunk's billed or measured
    # transfer landing in ``probe.observe_chunk`` as it lands), may retune
    # once mid-round (abort the unsent schedule, re-price a re-encoded
    # tail), and closes with ``end_stream_round``, which emits the same
    # per-bucket records and the same single probe fold ``on_sync`` would.
    # A round with zero retunes is bit-identical to the classic path:
    # records, probe belief and rng stream.

    def begin_stream_round(self, wire_mb: Mapping[str, float],
                           step: Optional[int] = None) -> bool:
        """Arm a streaming round.  Returns False to decline: the caller
        ships the round the classic way (``ship_bucket`` and ``on_sync``)."""
        del wire_mb, step
        return False

    def stream_chunk(self, name: str, chunk_mb: float) -> float:
        """Billing-only ship of one chunk (no data moves): the simulator's
        and the benchmarks' entry point.  Returns the chunk's seconds."""
        raise NotImplementedError

    def stream_ship_chunk(self, name: str, chunk: ChunkPayload, shift: int,
                          chunk_mb: float) -> Tuple[ChunkPayload, float]:
        """Ship one chunk's payload to the ring peer and bill it: returns
        (shipped chunk, seconds), the trainer's entry point."""
        raise NotImplementedError

    def retune_stream(self, tail_mb: float) -> None:
        """Abort the unsent chunk schedule; the chunks that follow are the
        re-encoded tail, priced as one fresh transfer of ``tail_mb``."""
        raise NotImplementedError

    def end_stream_round(self) -> float:
        """Round barrier of a streaming round: emit per-bucket records, fold
        the round's aggregate into the probe once, return the round's
        transfer seconds."""
        raise NotImplementedError


class SimTransport(WanTransport):
    """The WAN simulator behind the transport seam.

    Shipping is the inline ring's (results are bit-exact); *billing*
    replays the simulator's transfer law: at each sync round the trace's
    bandwidth at the transport's clock prices the round's total wire bytes
    through ``wan.transfer_time`` (latency + lognormal fluctuation, seeded
    numpy generator, so a run's decision stream replays).  The caller owns
    the clock: ``tick(dt)`` advances it by emulated compute time,
    ``on_sync`` bills at the current clock."""

    in_graph = True

    def __init__(self, trace: BandwidthTrace,
                 wan: Optional[WANConfig] = None,
                 probe: Optional[MeasuredWanProbe] = None):
        super().__init__()
        self.trace = trace
        self.wan = wan if wan is not None else WANConfig()
        self.probe = probe
        self.clock_s = 0.0
        self._rng = np.random.default_rng(self.wan.seed)

    def tick(self, dt_s: float) -> None:
        """Advance the sim clock by ``dt_s`` emulated seconds."""
        self.clock_s += dt_s

    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        # delegating to the inline ring is the bit-exactness guarantee;
        # billing lives in on_sync, where sizes are host values
        return self.pods.ring.ship_bucket(name, chunks, shift, payload_mb)

    def on_sync(self, wire_mb: Mapping[str, float],
                step: Optional[int] = None) -> float:
        """Bill one sync round: one ``transfer_time`` draw on the round's
        total payload (the simulator's law), split across buckets
        proportionally for the per-bucket records."""
        bw = self.trace.at(self.clock_s)
        total = sum(wire_mb.values())
        if total <= 0.0:
            return 0.0
        t = transfer_time(total, bw, self.wan, self._rng)
        for name, mb in wire_mb.items():
            self.records.append(TransferRecord(
                bucket=name, payload_mb=mb, seconds=t * mb / total,
                step=step))
        if self.probe is not None:
            self.probe.observe_transfer(total, t)
        return t

    # ------------------------------------------- streaming round protocol
    supports_streaming = True

    def begin_stream_round(self, wire_mb: Mapping[str, float],
                           step: Optional[int] = None) -> bool:
        """Arm a streaming round: draw the round's one clean transfer time
        now (the same trace lookup and rng draw as ``on_sync``), so a
        zero-retune round bills bit for bit as the classic one."""
        total = sum(wire_mb.values())
        if total <= 0.0:
            return False
        bw = self.trace.at(self.clock_s)
        t = transfer_time(total, bw, self.wan, self._rng)
        self._stream = _StreamRound(step, wire_mb, t)
        return True

    def stream_chunk(self, name: str, chunk_mb: float) -> float:
        secs = self._stream.bill(name, chunk_mb)
        if self.probe is not None:
            self.probe.observe_chunk(chunk_mb, secs)
        return secs

    def stream_ship_chunk(self, name: str, chunk: ChunkPayload, shift: int,
                          chunk_mb: float) -> Tuple[ChunkPayload, float]:
        shipped = self.pods.ring.ship_bucket(name, (chunk,), shift,
                                             chunk_mb)[0]
        return shipped, self.stream_chunk(name, chunk_mb)

    def retune_stream(self, tail_mb: float) -> None:
        """Abort the unsent schedule: the re-encoded tail is priced as one
        fresh ``transfer_time`` draw at the current traced bandwidth."""
        st = self._stream
        st.retuned = True
        st.tail_mb = float(tail_mb)
        st.t_tail = (transfer_time(tail_mb, self.trace.at(self.clock_s),
                                   self.wan, self._rng)
                     if tail_mb > 0.0 else 0.0)

    def end_stream_round(self) -> float:
        return _close_billed_round(self)


def _close_billed_round(transport: WanTransport) -> float:
    """``end_stream_round`` of a billing transport (sim, hierarchical):
    records, the one probe fold and the round summary.  Without a retune
    the records are the canonical per-bucket split of the clean draw and
    the probe sees (round total, clean draw), the exact sample ``on_sync``
    feeds; a retuned round records and observes what actually shipped over
    what it took."""
    st = transport._stream
    transport._stream = None
    if not st.retuned:
        for name, mb in st.wire_mb.items():
            transport.records.append(TransferRecord(
                bucket=name, payload_mb=mb,
                seconds=st.t_round * mb / st.total, step=st.step))
    else:
        for name, mb in st.shipped.items():
            transport.records.append(TransferRecord(
                bucket=name, payload_mb=mb,
                seconds=st.billed.get(name, 0.0), step=st.step))
    t = st.t_total
    mb_obs = st.total if not st.retuned else st.shipped_mb
    if transport.probe is not None:
        transport.probe.observe_transfer(mb_obs, t)
    transport.stream_rounds.append(st.summary(t))
    return t


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` copied to ``device`` without a host wait, dtype kept."""
    return _wire_bits(t).to(device, non_blocking=True).view(t.dtype)


def _ring_send(items: Sequence, devs: Sequence[torch.device], shift: int,
               send) -> List:
    """One ring step over devices: ``items[p]`` lives on ``devs[p]``, and
    entry ``(p + shift) % n`` of the result is ``send(items[p], devs[(p +
    shift) % n])``."""
    n = len(devs)
    out = [None] * n
    for p, item in enumerate(items):
        q = (p + shift) % n
        out[q] = send(item, devs[q])
    return out


def _move_chunks(chunks: Sequence[ChunkPayload], device: torch.device
                 ) -> Tuple[ChunkPayload, ...]:
    return tuple(ChunkPayload(*(_move(p, device) for p in c))
                 for c in chunks)


def _wait(devices: Sequence[torch.device]) -> None:
    """Wait for the queued work of every CUDA device in ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _on(device: torch.device):
    """Make ``device`` current for the launches in the block (a kernel
    launches on the current device's stream of its tensor)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _record(devices: Sequence[torch.device]) -> List:
    """An event recorded on the current stream of each CUDA device in
    ``devices``: what a hop thread waits on instead of the whole device."""
    out = []
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            out.append(ev)
    return out


class MeshTransport(WanTransport):
    """A host-timed ship of each bucket, in one process.

    With at least ``n_pods`` devices (``devices``, or every device of the
    payload's type: each card, or the one CPU), row ``p`` of every wire
    part is placed on device ``p`` before the timer starts; the timed part
    copies it to device ``(p + shift) % n`` and waits for every device
    involved; the rows are stacked back onto the payload's device after
    the timer stops.  With fewer devices ``sharding`` is ``None`` and the
    ship is a roll on the payload's own device (the reference's rule; same
    bytes, no cross-device traffic to time).  On the card the timer is
    bracketed by device waits, so a record times the copy, not its launch.
    Each transfer's wall-clock goes into a :class:`TransferRecord`: the
    measured feedback the adaptive controllers read through
    :class:`MeasuredWanProbe`.  Bound to a pod axis split over processes
    (:meth:`bind`), each rank holds its own pods' rows: the timed ship is
    the axis's point-to-point ring between device waits, and each
    transfer's seconds are the max over the ranks, agreed before anything
    records them.

    ``in_graph=False``: the trainer ships bucket by bucket at the host
    seam, which is where the timing boundary lives."""

    in_graph = False

    def __init__(self, probe: Optional[MeasuredWanProbe] = None,
                 devices: Optional[Sequence] = None,
                 emulate_mbps: Optional[float] = None):
        super().__init__()
        self.probe = probe
        self._devices = (None if devices is None
                         else [torch.device(d) for d in devices])
        # devices of one host have no WAN between them: transfers complete
        # at fabric speed.  ``emulate_mbps`` adds a real wall-clock hop
        # (sleep of payload_mb*8/mbps) after each shipped bucket, so the
        # measured times, and everything downstream, are WAN-scale;
        # ``None`` reports the raw fabric
        self.emulate_mbps = emulate_mbps
        self._round: List[TransferRecord] = []

    # ------------------------------------------------------------ placement
    def devices(self, device_type: str = "cuda") -> List[torch.device]:
        """The devices pod rows may be placed on: those given, else every
        device of ``device_type`` (each card, or the one CPU)."""
        if self._devices is not None:
            return list(self._devices)
        if device_type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [torch.device(device_type)]

    def sharding(self, n_pods: int, device_type: str = "cuda"
                 ) -> Optional[List[torch.device]]:
        """One device per pod row when there are enough devices, else
        ``None`` (the ship is then a local roll: same numerics, no
        cross-device traffic to time)."""
        devs = self.devices(device_type)
        return devs[:n_pods] if len(devs) >= n_pods else None

    @property
    def sharded(self) -> bool:
        """Whether two pods' rows would sit on two cards."""
        return self.sharding(2) is not None

    # -------------------------------------------------------------- shipping
    def _timed_ship(self, chunks: Sequence[ChunkPayload], shift: int,
                    payload_mb: float) -> Tuple[Tuple[ChunkPayload, ...],
                                                float]:
        """Ship ``chunks`` one ring step and time it on the host: the
        placement is waited for before the clock starts, the ship (and the
        emulated hop) before it stops, and the rows are gathered back onto
        the payload's device after.  Returns (shipped chunks, seconds).
        On a split pod axis: the axis's ring between device waits, the
        seconds agreed over the pod group."""
        home = chunks[0].q.device
        if self.pods.split:
            _wait([home])
            t0 = time.perf_counter()
            out = self.pods.ring.ship_bucket("", chunks, shift)
            _wait([home])
            if self.emulate_mbps:
                time.sleep(payload_mb * 8.0 / self.emulate_mbps)
            return out, self.pods.agree([time.perf_counter() - t0])[0]
        n = int(chunks[0].q.shape[0])
        devs = self.sharding(n, home.type)
        fence = devs if devs is not None else [home]
        if devs is not None:
            # per chunk, per part: row p on device p
            placed = [[[_move(part[p:p + 1], devs[p]) for p in range(n)]
                       for part in c] for c in chunks]
        _wait(fence)                    # placement is not transfer time
        t0 = time.perf_counter()
        if devs is None:
            out = self.pods.ring.ship_bucket("", chunks, shift)
        else:
            sent = [[_ring_send(rows, devs, shift, _move) for rows in c]
                    for c in placed]
        _wait(fence)
        if self.emulate_mbps:
            time.sleep(payload_mb * 8.0 / self.emulate_mbps)
        secs = time.perf_counter() - t0
        if devs is not None:
            out = tuple(ChunkPayload(*(
                torch.cat([_wire_bits(r).to(home) for r in rows]).view(
                    part.dtype) for rows, part in zip(parts, c)))
                for parts, c in zip(sent, chunks))
        return out, secs

    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        out, secs = self._timed_ship(chunks, shift, payload_mb)
        rec = TransferRecord(bucket=name, payload_mb=payload_mb,
                             seconds=secs)
        self.records.append(rec)
        self._round.append(rec)
        return out

    def on_sync(self, wire_mb: Mapping[str, float],
                step: Optional[int] = None) -> float:
        """Round barrier: flush this round's measured transfers into the
        probe (one aggregate observation: total wire MB over total
        measured seconds)."""
        del wire_mb
        if not self._round:
            return 0.0
        mb = sum(r.payload_mb for r in self._round)
        secs = sum(r.seconds for r in self._round)
        for r in self._round:
            r.step = step
        self._round = []
        if self.probe is not None and mb > 0.0:
            self.probe.observe_transfer(mb, secs)
        return secs

    # ------------------------------------------- streaming round protocol
    supports_streaming = True

    def begin_stream_round(self, wire_mb: Mapping[str, float],
                           step: Optional[int] = None) -> bool:
        """Arm a streaming round.  No billing draw: every chunk's cost is
        its measured seconds, landing as it lands."""
        if sum(wire_mb.values()) <= 0.0:
            return False
        self._stream = _StreamRound(step, wire_mb, 0.0)
        return True

    def stream_ship_chunk(self, name: str, chunk: ChunkPayload, shift: int,
                          chunk_mb: float) -> Tuple[ChunkPayload, float]:
        """Ship one chunk, timed as ``ship_bucket`` times a bucket: its
        seconds hold the chunk's own transfer, not the encode before it."""
        out, secs = self._timed_ship((chunk,), shift, chunk_mb)
        self._stream.bill_measured(name, chunk_mb, secs)
        if self.probe is not None:
            self.probe.observe_chunk(chunk_mb, secs)
        return out[0], secs

    def retune_stream(self, tail_mb: float) -> None:
        """Nothing to re-price: every chunk is measured, so the re-encoded
        (smaller) tail costs what it takes.  Kept for the round summary."""
        self._stream.retuned = True
        self._stream.tail_mb = float(tail_mb)

    def end_stream_round(self) -> float:
        st = self._stream
        self._stream = None
        secs = float(sum(st.billed.values()))
        for name, mb in st.shipped.items():
            self.records.append(TransferRecord(
                bucket=name, payload_mb=mb,
                seconds=st.billed.get(name, 0.0), step=st.step))
        if self.probe is not None and st.shipped_mb > 0.0:
            self.probe.observe_transfer(st.shipped_mb, secs)
        self.stream_rounds.append(st.summary(secs, t_round=secs))
        return secs

    # ------------------------------------------------- overlap measurement
    def measure_overlap(self, cfg: SyncConfig, n_pods: int, n_elems: int,
                        *, seed: int = 0, reps: int = 3,
                        device="cuda") -> Dict:
        """Measure what ``overlap_chunks`` pipelining buys: the realized
        version of the WAN simulator's ``1/overlap_chunks`` blocking model.

        Two schedules over the same chunk boundaries and codec knobs, each
        timed end to end on the host clock (best of ``reps`` after a
        warm-up run):

        - **serialized**: encode chunk i, ship it (the roll or the
          cross-device copy, then the emulated WAN hop when
          ``emulate_mbps`` is set) to completion, then encode chunk i+1.
        - **pipelined**: the ship of chunk i is data-independent of the
          encode of chunk i+1, so chunk i's hop runs on a worker thread
          while chunk i+1 encodes; only the last chunk's hop stays
          unhidden.

        Decodes run after all transfers in both schedules, and both
        schedules must decode to the same tensor (``RuntimeError`` if they
        do not).  With ``emulate_mbps=None`` the hop is the raw device
        fabric, and the speedup degenerates to ~1.  Single-process: it
        makes and ships its own rows over the devices of this process and
        never crosses a bound pod axis."""
        if not cfg.uses_codec:
            raise ValueError("measure_overlap times the codec path: cfg "
                             "must have the fused codec enabled "
                             "(asgd_ga + compress_topk + quantize_int8)")
        home = torch.device(device)
        rng = np.random.default_rng(seed)
        flat = torch.from_numpy(rng.normal(size=(n_pods, n_elems))
                                .astype(np.float32)).to(home)
        devs = self.sharding(n_pods, home.type)
        # the pods' rows in groups, each on one device: all of them on
        # ``home``, or one row on each device of the sharding
        groups = ([(home, flat)] if devs is None else
                  [(d, flat[p:p + 1].to(d)) for p, d in enumerate(devs)])
        gdev = [d for d, _ in groups]
        shift = cfg.peer_shift
        widths = _chunk_widths(cfg, n_elems)
        chunk_mb = [cfg.payload_mb(4 * m / 1e6) for m in widths]
        one = dataclasses.replace(cfg, overlap_chunks=1)
        offs = [sum(widths[:i]) for i in range(len(widths))]
        # the chunk segments are sliced outside the timed region
        segs = [[rows[:, off:off + m] for _, rows in groups]
                for m, off in zip(widths, offs)]

        def ship(chs):
            """The encoded chunk of every group, shipped one ring step."""
            if devs is None:
                return [_INLINE_RING.ship_bucket("", chs[0], shift)]
            return _ring_send(chs, devs, shift, _move_chunks)

        # CONCURRENCY CONTRACT: every encode, roll and decode is launched
        # from THIS thread.  The worker only waits for its chunk's ship
        # (an event recorded just after it, not the whole device, which
        # would also wait for the next chunk's encode) and pays the
        # emulated hop; that wait and hop is what overlaps the next encode
        def run(pipelined: bool, pool: ThreadPoolExecutor
                ) -> Tuple[float, torch.Tensor, List[float]]:
            shipped: List = [None] * len(widths)
            hop_s: List[float] = [0.0] * len(widths)
            prev = None
            _wait(gdev)
            t0 = time.perf_counter()
            for i, m in enumerate(widths):
                chs = []
                for d, seg in zip(gdev, segs[i]):
                    with _on(d):
                        chs.append(_encode_bucket(one, seg,
                                                  want_local=False)[0])
                shipped[i] = ship(chs)
                events = _record(gdev)

                def hop(events=events, mb=chunk_mb[i], i=i):
                    h0 = time.perf_counter()
                    for ev in events:
                        ev.synchronize()
                    if self.emulate_mbps:
                        time.sleep(mb * 8.0 / self.emulate_mbps)
                    hop_s[i] = time.perf_counter() - h0

                if pipelined:
                    if prev is not None:
                        prev.result()  # ONE link: transfers serialize
                        #   among themselves; only encode overlaps them
                    prev = pool.submit(hop)
                else:
                    hop()
            if prev is not None:
                prev.result()
            rows = []
            for g, d in enumerate(gdev):
                with _on(d):
                    rows.append(torch.cat(
                        [_decode_bucket(one, shipped[i][g], m)
                         for i, m in enumerate(widths)], dim=1).to(home))
            out = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
            _wait(gdev + [home])
            return time.perf_counter() - t0, out, hop_s

        def timeit(pipelined: bool, pool: ThreadPoolExecutor
                   ) -> Tuple[float, torch.Tensor, List[float]]:
            _, out, _ = run(pipelined, pool)   # warm-up
            best = float("inf")
            best_hops: List[float] = []
            for _ in range(reps):
                dt, out, hops = run(pipelined, pool)
                if dt < best:
                    best, best_hops = dt, hops
            return best, out, best_hops

        with ThreadPoolExecutor(max_workers=1) as pool:
            t_serial, out_serial, hops_serial = timeit(False, pool)
            t_pipe, out_pipe, hops_pipe = timeit(True, pool)
        if not torch.equal(out_serial, out_pipe):
            raise RuntimeError("measure_overlap: the serialized and "
                               "pipelined schedules decoded to different "
                               "tensors")
        return {
            "n_devices": len(self.devices(home.type)),
            "sharded": devs is not None,
            "n_pods": n_pods,
            "n_elems": n_elems,
            "chunks": len(widths),
            "emulate_mbps": self.emulate_mbps,
            "wire_mb": round(sum(chunk_mb), 4),
            "chunk_mb": [round(mb, 6) for mb in chunk_mb],
            "chunk_transfer_s": {
                "serialized": [round(h, 6) for h in hops_serial],
                "pipelined": [round(h, 6) for h in hops_pipe],
            },
            "t_pipelined_s": round(t_pipe, 6),
            "t_serialized_s": round(t_serial, 6),
            "overlap_speedup": round(t_serial / max(t_pipe, _EPS), 3),
        }
