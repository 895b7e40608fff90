"""Named spans and counters inside the training step and the sync round, on
``torch.profiler``'s clock.

To read them, run a ``torch.profiler.profile`` around ``Trainer.fit`` (or
any loop of ``Trainer.train_step`` and ``Trainer.maybe_sync``) and look
for the host events whose names start with ``ct.`` in its trace: every
span is a ``record_function`` of that session, so it shares the clock of
the kernels the profiler records, and a kernel belongs to the span that
was open when it was launched (the profiler's launch link).  The
profiler keeps the spans in memory and writes them out
(``export_chrome_trace``); nothing here stores, exports or times anything
of its own.  :func:`read` returns the counters' totals.

The spans (the code each one wraps):

- ``ct.step``: ``Trainer.train_step``; inside it, for each pod,
  ``ct.step.forward`` (the loss function) and ``ct.step.backward``
  (``torch.autograd.grad``), then ``ct.step.grads`` (the pod stack and the
  clip), ``ct.step.accumulate`` (``on_step_gradients``),
  ``ct.step.optimizer`` (the update and its copy back into the state) and
  ``ct.step.metrics`` (the loss and gradient-norm stacks and the gather);
- ``ct.round``: a sync round of ``Trainer.maybe_sync``; inside it
  ``ct.round.pack`` (pack, divide, EF add), ``ct.round.encode``,
  ``ct.round.ship``, ``ct.round.decode`` and ``ct.round.apply`` (the EF
  rollover and the receiver update, with ``ct.round.norms`` inside it); a
  round without the codec runs under ``ct.round.apply`` with its own ship
  under ``ct.round.ship``;
- ``ct.moe.route``, ``ct.moe.dispatch``, ``ct.moe.experts``,
  ``ct.moe.combine``: an MoE layer's forward.

Backward kernels are launched by autograd's own thread while the main
thread waits inside ``ct.step.backward``, so by launch time they count as
backward.  Under ``remat`` a layer's forward runs again in the backward,
and its ``ct.moe.*`` spans (and counts) with it, on that thread.

The one counter, ``moe.slots.*``: an MoE layer's (token, choice) pairs
``kept`` within capacity, ``routed`` in all, and the capacity ``rows`` its
expert products run.  ``kept / rows`` is the useful share of the expert
products' rows; ``1 - kept / routed`` the drop rate.

With no profiler running, :func:`span` returns one shared no-op after a
single check of a flag and :func:`add` returns at once: the spans stay in
the code at the cost of that check.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Union

import torch
import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

PREFIX = "ct."

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_TOTALS: Dict[str, Union[float, torch.Tensor]] = {}


def enabled() -> bool:
    """Whether a profiler runs: spans and counters record only then."""
    # set by the profiler itself as a session starts and stops
    return _profiler._is_profiler_enabled


def span(name: str):
    """``ct.<name>``, a ``record_function`` while a profiler runs; else the
    shared no-op context."""
    if enabled():
        return record_function(PREFIX + name)
    return _NULL


def add(name: str, value: Union[int, float, torch.Tensor]) -> None:
    """Add ``value`` (a device tensor is added on its device, with no
    wait) to the running total ``name`` while a profiler runs."""
    if not enabled():
        return
    with _LOCK:
        _TOTALS[name] = _TOTALS.get(name, 0) + value


def read() -> Dict[str, float]:
    """Every total as a float (one wait for the device tensors)."""
    with _LOCK:
        items = list(_TOTALS.items())
    dev = [(k, v) for k, v in items if torch.is_tensor(v)]
    out = {k: float(v) for k, v in items if not torch.is_tensor(v)}
    if dev:
        at = dev[0][1].device
        vals = torch.stack([v.to(at, torch.float64).reshape(())
                            for _, v in dev]).tolist()
        out.update(zip((k for k, _ in dev), vals))
    return out


def reset() -> None:
    """Clear every total."""
    with _LOCK:
        _TOTALS.clear()
