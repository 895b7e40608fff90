"""Deterministic fault injection and tolerance behind the WAN transport seam.

Counterpart of ``repro/core/faults.py``.  Failure is an injectable,
recoverable event at the transport seam (``repro_torch.core.transport``):

- :class:`FaultEvent` / :class:`FaultPlan`: a seeded schedule of faults
  keyed to sync steps: transfer **timeouts** (a transfer N x slower than
  the bandwidth belief is declared failed), outright transfer
  **failures**, payload **corruption** (a real bit-flip on the wire
  triple, caught or not by the per-chunk checksums of
  ``sync.chunk_checksum_rows``), link **flaps** (a slowdown window) and pod
  **crashes** (degraded rounds over the surviving membership, or a
  mid-round rollback to the last sync barrier).
- :func:`resolve_round`: the one pure decision and billing law of a
  faulted round.  The chaos transport bills with it live, and a recorded
  outcome stream replays through it float for float after a JSON round
  trip (``experiments/bench/BENCH_faults.json``).
- :class:`ChaosTransport`: wraps any transport.  With an empty plan it is
  bit-exact passthrough (delegation, not reimplementation).  With
  ``tolerate=False`` it is the no-tolerance baseline: no checksums, no
  retries, no degraded rounds; corruption decodes into the parameters and
  a crashed peer hangs the round.

Retry and backoff budgets come from :class:`repro_torch.core.wan.RetryPolicy`,
the law the DES failure events share, so ``wan.simulate`` and a chaos-wrapped
transport bill a failed attempt alike.  The corruption flips bits on a copy
of the shipped scales on their own device: a transport may ship views of
the sender's tensors, and an in-place flip would damage what a retry
re-ships.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.sync import (WHOLE_PODS, ChunkPayload, PodAxis,
                                   PodUnreachableError, TransferFailed)
from repro_torch.core.wan import RetryPolicy, retry_schedule

FAULT_KINDS = ("timeout", "fail", "corrupt", "flap", "crash")
CRASH_MODES = ("degrade", "rollback")

#: no-tolerance crash billing: with nobody timing out the transfer, a
#: round with a dead peer hangs this many expected-transfer-times before
#: an operator intervenes.  The cost the fault-tolerant path exists to avoid.
NO_TOLERANCE_HANG = 64.0

# XOR-ed into a corrupted fp32 scale: the exponent's top bit (1.0f
# 0x3F800000 becomes +inf 0x7F800000)
_FLIP = 0x40000000


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, keyed to the sync step it first bites at.

    ``pod`` is the sender whose link the fault lives on (for ``corrupt``
    the bit-flip lands on that sender's *receiver* row after the ring
    permute); ``duration`` (rounds) only applies to ``flap``; ``factor``
    is the slowdown multiplier of ``flap`` and ``timeout``; ``attempts``
    is how many attempts fail before one succeeds (``fail`` / ``timeout``
    / ``corrupt``); ``mode`` picks the crash recovery story."""

    kind: str
    step: int
    pod: int = 0
    duration: int = 1
    factor: float = 8.0
    attempts: int = 1
    mode: str = "degrade"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} unknown (kinds: "
                f"{', '.join(FAULT_KINDS)})")
        if self.step < 0:
            raise ValueError(f"fault {self.kind}: step must be >= 0, "
                             f"got {self.step}")
        if self.pod < 0:
            raise ValueError(f"fault {self.kind}@{self.step}: pod must be "
                             f">= 0, got {self.pod}")
        if self.duration < 1:
            raise ValueError(f"fault {self.kind}@{self.step}: duration must "
                             f"be >= 1 round, got {self.duration}")
        if self.factor <= 0:
            raise ValueError(f"fault {self.kind}@{self.step}: factor must "
                             f"be > 0, got {self.factor}")
        if self.attempts < 1:
            raise ValueError(f"fault {self.kind}@{self.step}: attempts must "
                             f"be >= 1, got {self.attempts}")
        if self.mode not in CRASH_MODES:
            raise ValueError(
                f"fault crash@{self.step}: mode {self.mode!r} unknown "
                f"(modes: {', '.join(CRASH_MODES)})")

    def active(self, step: int) -> bool:
        if self.kind == "flap":
            return self.step <= step < self.step + self.duration
        if self.kind == "crash":
            return step >= self.step        # dead until recovered/removed
        return step == self.step


@dataclass(frozen=True)
class FaultPlan:
    """A committed, seeded fault schedule: the whole experiment input.

    The same plan against the same run injects the same faults, bills the
    same retries and takes the same recovery decisions."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        return tuple(ev for ev in self.events if ev.active(step))

    @property
    def needs_host_seam(self) -> bool:
        """Ship-level faults (failed or corrupted transfers, crashes) need
        the host-seam ship; billing-only plans (flaps) keep the wrapped
        transport's in-graph ship."""
        return any(ev.kind in ("fail", "timeout", "corrupt", "crash")
                   for ev in self.events)

    @property
    def has_crashes(self) -> bool:
        return any(ev.kind == "crash" for ev in self.events)


@dataclass(frozen=True)
class RoundOutcome:
    """One faulted round's resolved decision and bill (pure, replayable)."""

    step: int
    kinds: Tuple[str, ...]        # active event kinds this round
    attempts: int                 # failed attempts billed (and retried)
    extra_s: float                # retry/backoff wall-clock added
    slowdown: float               # multiplier on the clean transfer time
    crashed: Tuple[int, ...]      # pods dead as of this round


def resolve_round(plan: FaultPlan, policy: RetryPolicy, step: int,
                  expected_s: float) -> RoundOutcome:
    """Resolve one sync round against the plan: which faults bite, how
    many attempts fail, and what the retry/backoff law bills for them.

    Pure math over its four inputs.  A ``timeout`` below the policy's
    ``timeout_factor`` is merely slow (no retry); at or above it the
    attempt is declared failed.  Retryable attempts cap at
    ``policy.max_retries``: beyond that the sender is unreachable and the
    round degrades instead (the transport's ``round_failed_pods``)."""
    kinds: List[str] = []
    attempts, extra, slow = 0, 0.0, 1.0
    crashed: List[int] = []
    for ev in plan.at(step):
        kinds.append(ev.kind)
        if ev.kind == "timeout" and ev.factor < policy.timeout_factor:
            slow *= ev.factor
        elif ev.kind in ("fail", "timeout", "corrupt"):
            n = min(max(1, ev.attempts), policy.max_retries)
            extra += retry_schedule(expected_s, policy, n)
            attempts += n
        elif ev.kind == "flap":
            slow *= ev.factor
        elif ev.kind == "crash":
            crashed.append(ev.pod)
    return RoundOutcome(step=step, kinds=tuple(kinds), attempts=attempts,
                        extra_s=extra, slowdown=slow,
                        crashed=tuple(crashed))


def _flipped(scales: torch.Tensor, row: int) -> torch.Tensor:
    """A copy of ``scales`` (f32, on its own device) with ``_FLIP`` XOR-ed
    into every word of ``row``; ``scales`` itself is left as it was."""
    out = scales.clone()
    bits = out.view(torch.int32)
    bits[row] ^= _FLIP
    return out


class ChaosTransport:
    """Wrap any transport with a seeded deterministic :class:`FaultPlan`.

    Contract (``tests/test_torch_faults.py``):

    - **Empty plan: bit-exact passthrough.**  Shipping delegates to the
      wrapped transport, billing is the wrapped ``on_sync`` verbatim,
      ``in_graph`` is inherited.
    - **Faulted rounds bill through** :func:`resolve_round`: every outcome
      is appended to ``outcomes`` (the replayable stream) and the degraded
      time feeds the wrapped probe once, so the adaptive controllers see
      the post-retry bandwidth.
    - **Crashes**: ``mode="degrade"`` marks the pod in
      ``round_failed_pods`` (the trainer completes the round over the
      surviving membership mask); ``mode="rollback"`` raises
      :class:`~repro_torch.core.sync.PodUnreachableError` once (the
      launcher restores the last sync-barrier checkpoint), then degrades
      until the control plane removes the pod and calls
      :meth:`clear_crash`.
    - ``tolerate=False`` is the **no-tolerance baseline**: no checksums
      (corruption decodes into the parameters), no retries, no degraded
      rounds; a crashed peer hangs every round ``NO_TOLERANCE_HANG``
      expected-transfer-times.
    """

    def __init__(self, inner, plan: FaultPlan,
                 policy: Optional[RetryPolicy] = None,
                 tolerate: bool = True):
        self.inner = inner
        self.pods: PodAxis = WHOLE_PODS
        self.plan = plan
        self.retry_policy = policy if policy is not None else RetryPolicy()
        self.tolerate = tolerate
        self._step: Optional[int] = None
        self._round_events: Tuple[FaultEvent, ...] = ()
        self._round_failed: Tuple[int, ...] = ()
        self._attempts: Dict[int, int] = {}      # event index -> injected
        self._payload_mb: Dict[str, float] = {}  # bucket -> last wire MB
        self._cleared: set = set()               # pods recovered + removed
        self._rolled_back: set = set()           # rollback already taken
        self._reported: set = set()              # crashes sent to the bus
        self.retries = 0
        self.degraded_rounds = 0
        self.crash_recoveries = 0
        self.retried_mb = 0.0
        self.outcomes: List[dict] = []           # replayable decision stream

    # ------------------------------------------------------------- plumbing
    def __getattr__(self, name):
        # delegate everything the wrapper does not own (probe, records,
        # tick, wan_transfers_per_round, ...) to the wrapped transport
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def bind(self, pods: PodAxis) -> None:
        """Bind the wrapper and the wrapped transport to the pod axis
        ``pods``.  The plan and every decision of it are host state, the
        same on every rank; only the corrupted row is placed by the axis."""
        self.pods = pods
        bind = getattr(self.inner, "bind", None)
        if bind is not None:
            bind(pods)

    @property
    def in_graph(self) -> bool:
        return (not self.plan.needs_host_seam
                and getattr(self.inner, "in_graph", True))

    @property
    def verify_checksums(self) -> bool:
        """The tolerance switch the host-seam ship loop reads: the
        no-tolerance baseline ships unverified."""
        return self.tolerate

    @property
    def clock_s(self) -> float:
        return self.inner.clock_s

    @clock_s.setter
    def clock_s(self, value: float) -> None:
        self.inner.clock_s = value

    # -------------------------------------------------------- round control
    def begin_round(self, step: int) -> None:
        """Arm the plan for one sync round (the trainer calls this before
        shipping): which pods this round treats as dead, namely crashed
        pods not yet removed, and senders whose scheduled failed attempts
        exceed the retry budget (the round degrades instead of erroring)."""
        self._step = step
        self._round_events = self.plan.at(step)
        self._attempts = {}
        failed: List[int] = []
        if self.tolerate:
            for ev in self._round_events:
                if ev.kind == "crash" and ev.pod not in self._cleared:
                    if ev.mode == "degrade" or ev.pod in self._rolled_back:
                        failed.append(ev.pod)
                elif ev.kind in ("fail", "timeout", "corrupt"):
                    slow_only = (ev.kind == "timeout" and
                                 ev.factor < self.retry_policy.timeout_factor)
                    if (not slow_only
                            and ev.attempts > self.retry_policy.max_retries):
                        failed.append(ev.pod)
        self._round_failed = tuple(dict.fromkeys(failed))

    def begin_stream_round(self, wire_mb, step=None):
        """Streaming rounds and fault injection compose by exclusion: a
        round the plan touches declines streaming (returns False), so the
        trainer ships the classic way, where :func:`resolve_round` owns the
        billing, retries and degraded membership.  Clean rounds delegate to
        the wrapped transport."""
        if self.plan.at(step if step is not None else self._step):
            return False
        return self.inner.begin_stream_round(wire_mb, step=step)

    @property
    def round_failed_pods(self) -> Tuple[int, ...]:
        """Pods the current round completes without (degraded membership);
        always empty for the no-tolerance baseline."""
        return self._round_failed if self.tolerate else ()

    def take_new_crashes(self) -> Tuple[int, ...]:
        """Crashed pods not yet reported to the control plane (the launcher
        publishes a ``pod_crashed`` event per pod, exactly once)."""
        new = []
        for ev in self._round_events:
            if (ev.kind == "crash" and ev.pod not in self._cleared
                    and ev.pod not in self._reported
                    and (ev.mode == "degrade"
                         or ev.pod in self._rolled_back)):
                self._reported.add(ev.pod)
                new.append(ev.pod)
        return tuple(new)

    def clear_crash(self, pod: int) -> None:
        """The control plane removed the crashed pod (reconfig applied):
        stop degrading rounds for it and count the recovery."""
        if pod not in self._cleared:
            self._cleared.add(pod)
            self.crash_recoveries += 1
        self._round_failed = tuple(p for p in self._round_failed
                                   if p != pod)

    def note_retry(self, bucket: str, attempt: int, err) -> None:
        """Ship-loop hook: one failed attempt was retried; count it and
        bill the retried bytes at full cost."""
        del attempt, err
        self.retries += 1
        self.retried_mb += self._payload_mb.get(bucket, 0.0)

    # ------------------------------------------------------------- shipping
    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        if self.in_graph:
            # no ship-level faults in the plan: pure delegation (the
            # empty-plan bit-exactness contract)
            return self.inner.ship_bucket(name, chunks, shift, payload_mb)
        self._payload_mb[name] = payload_mb
        # scheduled failed attempts: the transfer never delivers; raise
        # before shipping, capped at the retry budget (beyond it the pod
        # is in round_failed_pods and the round degrades instead)
        if self.tolerate:
            for i, ev in enumerate(self._round_events):
                if ev.kind == "fail" or (
                        ev.kind == "timeout"
                        and ev.factor >= self.retry_policy.timeout_factor):
                    limit = min(ev.attempts, self.retry_policy.max_retries)
                    done = self._attempts.get(i, 0)
                    if done < limit:
                        self._attempts[i] = done + 1
                        raise TransferFailed(name, done + 1, ev.kind,
                                             pod=ev.pod)
        shipped = self.inner.ship_bucket(name, chunks, shift, payload_mb)
        for i, ev in enumerate(self._round_events):
            if ev.kind != "corrupt":
                continue
            limit = (min(ev.attempts, self.retry_policy.max_retries)
                     if self.tolerate else ev.attempts)
            done = self._attempts.get(i, 0)
            if done < limit:
                self._attempts[i] = done + 1
                return self._corrupt(shipped, ev, shift)
        return shipped

    def _corrupt(self, shipped: Sequence[ChunkPayload], ev: FaultEvent,
                 shift: int) -> Tuple[ChunkPayload, ...]:
        """A real wire bit-flip: XOR the exponent's top bit of every fp32
        scale on the corrupted receiver row of the first chunk, the kind of
        silent payload damage the per-chunk checksums exist to catch.  The
        flip lands on a copy: the shipped chunk is untouched.  The row is
        global (the sender's ring peer among every pod); on a split pod
        axis only the rank that holds it flips it."""
        first = shipped[0]
        n = self.pods.n_pods if self.pods.split else first.scales.shape[0]
        row = (ev.pod + shift) % n - self.pods.first
        if not 0 <= row < first.scales.shape[0]:
            return tuple(shipped)
        corrupted = first._replace(scales=_flipped(first.scales, row))
        return (corrupted,) + tuple(shipped[1:])

    # -------------------------------------------------------------- billing
    def _expected_s(self, total_mb: float) -> float:
        """Expected round transfer time at the current bandwidth belief:
        the base of every timeout budget and retry bill."""
        est = None
        probe = getattr(self.inner, "probe", None)
        if probe is not None:
            est = probe.estimator.bandwidth_mbps
        if est is None or est <= 0.0:
            est = self.retry_policy.assume_mbps
        return total_mb * 8.0 / est

    def on_sync(self, wire_mb: Mapping[str, float],
                step: Optional[int] = None) -> float:
        if step is not None and step != self._step:
            self.begin_round(step)
        events = self._round_events
        if not events:
            # clean round: the wrapped transport's billing, verbatim
            return self.inner.on_sync(wire_mb, step=step)
        if self.tolerate:
            # a rollback-mode crash preempts the round once: state since
            # the barrier includes the dead pod and cannot be re-stacked;
            # the launcher restores the barrier checkpoint and the crash
            # then degrades until removal
            for ev in events:
                if (ev.kind == "crash" and ev.mode == "rollback"
                        and ev.pod not in self._rolled_back
                        and ev.pod not in self._cleared):
                    self._rolled_back.add(ev.pod)
                    raise PodUnreachableError(pod=ev.pod, step=self._step)
        total = float(sum(wire_mb.values()))
        expected_s = self._expected_s(total)
        outcome = resolve_round(self.plan, self.retry_policy,
                                self._step if self._step is not None else -1,
                                expected_s)
        # bill the wrapped transport's clean draw with its probe detached:
        # the probe must see the degraded time, fed once below
        probe = getattr(self.inner, "probe", None)
        if probe is not None:
            self.inner.probe = None
        try:
            t_clean = self.inner.on_sync(wire_mb, step=step)
        finally:
            if probe is not None:
                self.inner.probe = probe
        crashed = tuple(p for p in outcome.crashed
                        if p not in self._cleared)
        t = t_clean * outcome.slowdown + outcome.extra_s
        if self.tolerate:
            if crashed:
                self.degraded_rounds += 1
        elif crashed:
            t += expected_s * NO_TOLERANCE_HANG * len(crashed)
        self.outcomes.append({
            "step": int(self._step) if self._step is not None else None,
            "expected_s": expected_s,
            "kinds": list(outcome.kinds),
            "attempts": outcome.attempts,
            "extra_s": outcome.extra_s,
            "slowdown": outcome.slowdown,
            "crashed": list(outcome.crashed),
            "t_s": t,
        })
        if probe is not None and total > 0.0 and t > 0.0:
            probe.observe_transfer(total, t)
        return t
