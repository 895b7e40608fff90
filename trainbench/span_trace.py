"""Device time by the program's ``ct.`` spans, attributed by launch.

:mod:`trainbench.trace` names a device operation by when it ran, and on
the card an operation runs some time after the host launched it, often
under a later span.  Here every device operation carries its launch
time: the start of the CUDA runtime or driver call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...),
which ``prof.events()`` lists as a host event with the operation's own
``id`` (their CUDA correlation id; host operators and spans count their
ids apart, so only host events named ``cu*`` are matched), or the
operation's own start where no such call was recorded.
:class:`SpanTimeline` answers, on top of :class:`trainbench.trace.Timeline`:
the device seconds launched while a named span was open (inclusive of
every span inside it, on any thread), the device seconds by the innermost
``ct.`` span open at launch, and the idle seconds by the innermost ``ct.``
span open at each gap's middle.  Launches through ``ctypes`` (the codec
kernels) are runtime calls like any other.

Spans on any thread count: autograd's backward thread launches its
kernels while the main thread waits inside ``ct.step.backward``.  The
metric readers ``trainbench/metrics/step_*_ms.py``, ``round_*_ms.py`` and
``moe_dispatch_ms.py`` read a :class:`SpanTimeline` from ``ctx
["span_timeline"]``; ``trainbench/split.py`` builds one for a traced run.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from trainbench.trace import Event, Timeline, _union

PREFIX = "ct."
NONE = "(no ct. span)"
STEP, ROUND = "trainbench.train_step", "trainbench.round"
# the host's and the card's clocks, aligned by the profiler, differ by a
# few us: a kernel on an idle card may read as starting just before its
# launch call
SKEW_S = 50e-6

# (name, start s, end s, launch s)
Launched = Tuple[str, float, float, float]


def linked_events(prof) -> Tuple[List[Launched], List[Event]]:
    """(device operations with their launch times, host events) of a
    finished ``torch.profiler``, on its one clock."""
    from torch.autograd import DeviceType

    raw, host, calls = [], [], {}
    for e in prof.events():
        tr = e.time_range
        a, b = tr.start / 1e6, tr.end / 1e6
        if e.device_type == DeviceType.CUDA:
            # a host span's mirror on the device's timeline is no operation
            if not getattr(e, "is_user_annotation", False):
                raw.append((e.name, a, b, e.id))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, a, b))
            if e.name.startswith("cu"):
                calls[e.id] = a
    return [(n, a, b, calls.get(i, a)) for n, a, b, i in raw], host


class SpanTimeline(Timeline):
    def __init__(self, device: Sequence[Launched], host: Sequence[Event],
                 start: float, end: float):
        super().__init__([d[:3] for d in device], host, start, end)
        # (launch s, device s) of each operation, clipped as the base clips
        self.launched = [(t, min(b, end) - max(a, start))
                         for _, a, b, t in device if b > start and a < end]
        self.spans = [e for e in host if e[0].startswith(PREFIX)]
        # an operation cannot start before its launch: a wrong link shows
        self.late_launches = sum(1 for _, a, b, t in device
                                 if b > start and a < end and t > a + SKEW_S)

    def count(self, name: str) -> int:
        """Host spans named ``name`` that start in the stretch."""
        return sum(1 for n, a, _ in self.host
                   if n == name and self.start <= a < self.end)

    def inclusive_s(self, name: str) -> float:
        """Device seconds launched while a span ``name`` was open."""
        spans = _union([(a, b) for n, a, b in self.spans if n == name])
        starts = [a for a, _ in spans]
        total = 0.0
        for t, s in self.launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                total += s
        return total

    def innermost(self, times: Sequence[float]) -> List[str]:
        """The shortest ``ct.`` span open at each of ``times``, on any
        thread (``NONE`` where none is)."""
        import numpy as np

        a = np.array([s[1] for s in self.spans])
        b = np.array([s[2] for s in self.spans])
        out = []
        for t in times:
            open_ = np.nonzero((a <= t) & (t < b))[0]
            out.append(self.spans[open_[np.argmin(b[open_] - a[open_])]][0]
                       if open_.size else NONE)
        return out

    def device_by_span(self) -> Dict[str, float]:
        """Device seconds by the innermost ``ct.`` span open at launch."""
        out: Dict[str, float] = defaultdict(float)
        names = self.innermost([t for t, _ in self.launched])
        for name, (_, s) in zip(names, self.launched):
            out[name] += s
        return dict(out)

    @property
    def in_spans_s(self) -> float:
        """Device seconds launched under some ``ct.`` span."""
        return sum(s for n, s in self.device_by_span().items() if n != NONE)

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost ``ct.`` span open at each gap's
        middle."""
        out: Dict[str, float] = defaultdict(float)
        gaps = self.gaps()
        for name, (a, b) in zip(self.innermost([(a + b) / 2
                                                for a, b in gaps]), gaps):
            out[name] += b - a
        return dict(out)


def per_ms(ctx: dict, names: Sequence[str], per: str) -> Optional[float]:
    """Device ms launched under any of ``names`` in the traced stretch, over
    the number of ``per`` spans in it (a step or a round); None without a
    span timeline, without a ``per`` span, or where no span of ``names``
    was recorded."""
    st = ctx.get("span_timeline")
    if st is None:
        return None
    n = st.count(per)
    if not n or not any(s[0] in names for s in st.spans):
        return None
    return 1e3 * sum(st.inclusive_s(name) for name in names) / n
