"""Reduction of a profiler trace to the device's timeline.

:func:`events_of` splits ``torch.profiler``'s events into device operations
(kernels, copies and sets on the card) and host spans, each ``(name, start
s, end s)`` on the profiler's one clock.  :class:`Timeline` then answers
what the per-layer metrics and the result's ``device`` and ``breakdown``
read: the seconds in which some operation ran on the device, each
operation's summed time, and the device's idle gaps, each named by the
innermost host span that was open at its middle.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, float, float]


def events_of(prof) -> Tuple[List[Event], List[Event]]:
    """(device operations, host spans) of a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        ev = (e.name, tr.start / 1e6, tr.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            # a host span's mirror on the device's timeline is no operation
            if not getattr(e, "is_user_annotation", False):
                device.append(ev)
        elif e.device_type == DeviceType.CPU:
            host.append(ev)
    return device, host


def _union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Timeline:
    def __init__(self, device: Sequence[Event], host: Sequence[Event],
                 start: float, end: float):
        self.start, self.end = start, end
        self.device = [(n, max(a, start), min(b, end)) for n, a, b in device
                       if b > start and a < end]
        self.host = list(host)
        self.busy = _union([(a, b) for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def op_seconds(self) -> Dict[str, float]:
        """Device seconds by operation, a kernel named up to its argument
        list (so a template's instances fall together)."""
        out: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            out[short(n)] += b - a
        return dict(out)

    def kernel_seconds(self, needle: str, start: float = None,
                       end: float = None) -> float:
        """Summed time of the device operations whose name holds ``needle``
        and that start in ``[start, end)`` (default: the whole window)."""
        lo = self.start if start is None else start
        hi = self.end if end is None else end
        return sum(b - a for n, a, b in self.device
                   if needle in n and lo <= a < hi)

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_by_host(self, longest: int = 1000) -> Dict[str, float]:
        """Idle seconds summed by the innermost host span open at each
        gap's middle (``"(no host span)"`` where none is), for the
        ``longest`` gaps; the rest summed under ``"(shorter gaps)"``."""
        import numpy as np

        starts = np.array([s for _, s, _ in self.host])
        ends = np.array([e for _, _, e in self.host])
        out: Dict[str, float] = defaultdict(float)
        gaps = sorted(self.gaps(), key=lambda ab: ab[0] - ab[1])
        for a, b in gaps[:longest]:
            mid = (a + b) / 2
            open_ = np.nonzero((starts <= mid) & (ends > mid))[0]
            name = ("(no host span)" if not open_.size else
                    self.host[open_[np.argmin(ends[open_] - starts[open_])]][0])
            out[name] += b - a
        rest = sum(b - a for a, b in gaps[longest:])
        if rest:
            out["(shorter gaps)"] += rest
        return dict(out)


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.rstrip()[:width]


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
