"""Asynchronous checkpoint engine: snapshots streamed off the training step.

Counterpart of ``repro/checkpoint/async_engine.py``, with its API
contract:

- ``snapshot(tree, step)`` returns once the tree is captured; at most
  ``max_inflight`` snapshots queue before it applies backpressure.
- ``wait()`` blocks until the queue drains and re-raises any background
  failure as :class:`SnapshotError`.
- ``last_durable()`` names the newest *committed* snapshot, the recovery
  base for rollback crash handling and the migration source for live pod
  resizes.  It only ever advances after the atomic rename.
- ``restore_last(like=...)`` drains the queue, then restores the newest
  durable snapshot, falling back to older ones if an externally damaged
  directory fails its integrity check.
- Retention: after each commit the engine prunes to the ``keep`` newest
  snapshots.

A worker thread writes each snapshot with the checkpoint layer's writer
into ``step_XXXXXXXX.tmp`` and commits it with one atomic directory
rename (``step_00000042``); a crash at any point leaves only committed
snapshots and an ignorable ``.tmp`` directory, never a torn checkpoint.
Its files are byte for byte what a blocking ``checkpoint.save`` of the
same tree writes (:func:`blocking_equivalent`).

Where the reference queues its immutable device arrays, the port's
trainer updates the stacked state in place, so a queued tensor would be
overwritten by the next step.  ``snapshot`` therefore copies every tensor
leaf into a host buffer before it returns:

- on the card, on a side stream that first waits for the current one;
  the current stream then waits for the copies, so the next step's
  in-place writes queue behind them on the device and the host does not
  block.  The worker synchronizes on an event recorded after the copies
  before it reads the buffers, and every source leaf is marked as used by
  the side stream (``record_stream``), so a re-stack that frees the old
  state right after ``snapshot`` cannot hand its memory out early;
- on the CPU, by a plain copy (``x.cpu()`` of a CPU tensor is the tensor
  itself).

Leaves keep their dtype in the buffer (bf16 stays bf16; the worker's
writer upcasts it to f32, the file's format).  The buffers form a pool of
sets, one set per snapshot, grown lazily up to ``max_inflight + 1`` sets
(each queued snapshot, and the one being committed) and reused across
snapshots, so steady-state snapshotting allocates nothing; a set whose
layout no longer fits (after a pod re-stack) is dropped when a new one is
needed.  On the card a set is one block of host memory of the set's
exact size, page-locked by ``cudaHostRegister`` (PyTorch's pinned
allocator would round each block up to a power of two), so the device
copies into it run as DMA without blocking the host.  A failed
allocation, registration, stream set-up or commit raises
:class:`SnapshotError`; nothing falls back to pageable copies, a blocking
save or the CPU.

At granite-8b x2 layers and 2 pods one set is ~18 GB, and with the
default ``max_inflight=2`` the pool holds up to three.

Bound to a mesh (:meth:`AsyncCheckpointEngine.bind`, on every rank of the
world), the engine snapshots a placed tree: ``snapshot(tree, step,
parts=...)`` captures only this rank's local shards, on the side stream as
above, and posts nothing to any other rank.  The worker thread then ships each
leaf's owned pieces to the writer (the mesh's first rank) over a gloo
group of the engine's own, made at ``bind``, in queue order and key
order, so the ranks' sends pair up; the writer assembles and writes the
whole leaves and renames the directory, and broadcasts the outcome on the
same group, so that ``last_durable()`` advances on every rank only after
the writer's atomic rename.  The files equal the unplaced snapshot's.
"""
from __future__ import annotations

import os
import queue
import re
import shutil
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.sharding.rules import is_dtensor, local_part

from . import checkpoint as ckpt

Pytree = Any

STEP_PREFIX = "step_"
_STEP_RE = re.compile(rf"^{STEP_PREFIX}(\d+)$")
_STOP = object()
# byte alignment of each leaf's view inside a set's block (the block
# itself starts on the CPU allocator's 64-byte alignment)
_ALIGN = 4096


class SnapshotError(RuntimeError):
    """A snapshot failed: raised by ``snapshot()`` when the capture fails,
    and by ``wait()`` / ``snapshot()`` on the next call after a background
    commit failed, so the failure cannot pass silently."""


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{STEP_PREFIX}{step:08d}")


def list_steps(root: str) -> List[int]:
    """Steps of fully committed snapshots under ``root``, ascending.  Only
    directories holding a manifest count: a ``.tmp`` staging dir from an
    interrupted commit is invisible here."""
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, ckpt._MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def _layout(leaves) -> Tuple:
    """What a buffer set must match: each tensor leaf's shape and dtype
    (``None`` for an ``int`` leaf), and whether any lies on the card."""
    shapes = tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                   else None for x in leaves)
    cuda = any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)
    return shapes, cuda


class _HostBuffers:
    """One snapshot's host copy of every tensor leaf: views into one block
    of host memory, page-locked when the leaves lie on the card."""

    def __init__(self, layout):
        self.layout = layout
        shapes, self.cuda = layout
        offsets, total = [], 0
        for s in shapes:
            offsets.append(total)
            if s is not None:
                n = torch.Size(s[0]).numel() * s[1].itemsize
                total += -(-n // _ALIGN) * _ALIGN
        self.nbytes = total
        self.registered = False
        try:
            self.block = torch.empty(total, dtype=torch.uint8)
            if self.cuda and total:
                torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                    self.block.data_ptr(), total, 0))
                self.registered = True
        except RuntimeError as e:
            raise SnapshotError(f"host buffers of {total} bytes could not "
                                f"be allocated and page-locked: {e}") from e
        self.views = [
            None if s is None else
            self.block[off:off + torch.Size(s[0]).numel() * s[1].itemsize]
            .view(s[1]).view(s[0])
            for s, off in zip(shapes, offsets)]

    def release(self) -> None:
        """Unregister the block (the caller guarantees no copy into it is
        in flight); the memory goes with the last reference."""
        if self.registered:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
                self.block.data_ptr()))
            self.registered = False


class AsyncCheckpointEngine:
    """Background-thread snapshot engine over step-tagged directories."""

    def __init__(self, root: str, *, keep: int = 2, max_inflight: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = os.fspath(root)
        self.keep = int(keep)
        os.makedirs(self.root, exist_ok=True)
        depth = max(1, int(max_inflight))
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._error: Optional[Exception] = None
        self._durable: List[int] = list_steps(self.root)
        # donated host buffers: every set allocated, and the free ones
        self._host_bufs: List[_HostBuffers] = []
        self._free: List[_HostBuffers] = []
        self._max_sets = depth + 1
        self._pool = threading.Condition()
        self._stream = None
        self._group: Optional[ckpt.CheckpointGroup] = None
        self.committed = 0
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ckpt-engine")
        self._thread.start()

    # ------------------------------------------------------------ binding
    def bind(self, ranks: Sequence[int]) -> None:
        """Bind the engine to a mesh's ranks (global ranks, the writer
        first; ``Trainer.mesh_ranks``) before the snapshots they share: it
        makes the engine's own gloo group, which is collective over the
        world, so every rank of the world calls it, on its main thread, in
        the same order.  Drains the queue first, so that a re-bind (after a
        reconfiguration) starts on a clean group."""
        self.wait()
        self._group = ckpt.CheckpointGroup(ranks)

    # ------------------------------------------------------------ enqueue
    def snapshot(self, tree: Pytree, step: int,
                 metadata: Optional[dict] = None,
                 parts: Optional[Pytree] = None) -> None:
        """Enqueue an async snapshot of ``tree`` tagged ``step``.  Returns
        once every tensor leaf is captured into a host buffer (on the card:
        once its copy is queued on the device behind the step that made
        it); the serialize and commit happen on the worker thread.  An
        engine bound to a mesh takes a placed tree and its ``parts``
        (``Trainer.leaf_parts``) and captures the local shards; an unbound
        one refuses a DTensor leaf."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._raise_pending()
        keys, leaves = ckpt._keys(tree), T.leaves(tree)
        group = self._group
        if group is not None:
            if parts is None:
                raise ValueError("an engine bound to a mesh snapshots a "
                                 "placed tree: pass parts=")
            parts = ckpt._part_leaves(parts, len(leaves))
            leaves = [local_part(x) for x in leaves]
        elif any(is_dtensor(x) for x in leaves):
            raise TypeError("snapshot of a tree that holds a DTensor: bind "
                            "the engine to the mesh and pass parts=")
        bufs = self._acquire(_layout(leaves))
        try:
            ready = self._capture(leaves, bufs)
        except Exception:
            self._give_back(bufs)
            raise
        host = [b if b is not None else x for b, x in zip(bufs.views, leaves)]
        self._q.put((bufs, ready, (keys, host, int(step),
                                   dict(metadata or {}), parts, group)))

    def _acquire(self, layout) -> _HostBuffers:
        """A free buffer set of ``layout``: reused, newly allocated while
        the pool is below its size, or in place of a free set of another
        layout; else wait until the worker frees one (backpressure)."""
        with self._pool:
            while True:
                for i, b in enumerate(self._free):
                    if b.layout == layout:
                        return self._free.pop(i)
                if len(self._host_bufs) >= self._max_sets and self._free:
                    stale = self._free.pop(0)
                    self._host_bufs.remove(stale)
                    stale.release()
                if len(self._host_bufs) < self._max_sets:
                    bufs = _HostBuffers(layout)
                    self._host_bufs.append(bufs)
                    return bufs
                self._pool.wait()

    def _give_back(self, bufs: _HostBuffers) -> None:
        with self._pool:
            self._free.append(bufs)
            self._pool.notify_all()

    def _capture(self, leaves, bufs: _HostBuffers):
        """Copy every tensor leaf into ``bufs``; returns the event the
        copies end at (``None`` on the CPU, where they are done)."""
        pairs = [(x, b) for x, b in zip(leaves, bufs.views) if b is not None]
        if not bufs.cuda:
            for x, b in pairs:
                b.copy_(x.detach())
            return None
        try:
            device = next(x.device for x, _ in pairs if x.is_cuda)
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            side, cur = self._stream, torch.cuda.current_stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for x, b in pairs:
                    b.copy_(x.detach(), non_blocking=True)
                    if x.is_cuda:
                        x.record_stream(side)
                ready = torch.cuda.Event()
                ready.record(side)
            cur.wait_stream(side)
        except RuntimeError as e:
            raise SnapshotError(f"snapshot capture failed: {e!r}") from e
        return ready

    # ------------------------------------------------------------- worker
    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                bufs, ready, args = item
                try:
                    if ready is not None:
                        ready.synchronize()
                    self._commit_snapshot(*args)
                except Exception as e:   # noqa: BLE001 — surfaced by wait()
                    with self._lock:
                        self._error = e
                finally:
                    self._give_back(bufs)
            finally:
                self._q.task_done()

    def _commit_snapshot(self, keys, host, step: int, metadata: dict,
                         parts=None, group=None) -> None:
        shapes = ([tuple(p.shape) for p in parts] if parts is not None else
                  [tuple(x.shape) if isinstance(x, torch.Tensor) else ()
                   for x in host])
        manifest = ckpt.build_manifest(keys, host, shapes, step, metadata)
        final = step_dir(self.root, step)
        leaves = host if group is None else group.ship(host, parts)

        def write():
            tmp = final + ".tmp"
            for stale in (tmp, final):
                if os.path.isdir(stale):
                    shutil.rmtree(stale)
            os.makedirs(tmp)
            ckpt.write_files(tmp, leaves, manifest)
            os.replace(tmp, final)           # the atomic commit point

        if group is None:
            write()
        else:
            group.commit(write)
        with self._lock:
            self._durable = sorted(set(self._durable) | {step})
            self.committed += 1
        self._prune(group is None or group.is_writer)

    def _prune(self, remove: bool = True) -> None:
        with self._lock:
            drop = self._durable[:-self.keep]
            self._durable = self._durable[-self.keep:]
        if remove:
            for s in drop:
                shutil.rmtree(step_dir(self.root, s), ignore_errors=True)

    # -------------------------------------------------------------- query
    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise SnapshotError(f"background snapshot failed: {err!r}") from err

    def wait(self) -> None:
        """Block until every enqueued snapshot is committed (or failed);
        re-raise the first background failure."""
        self._q.join()
        self._raise_pending()

    def last_durable(self) -> Optional[Tuple[int, str]]:
        """(step, directory) of the newest committed snapshot, or None.
        Never names an in-flight or torn snapshot: the step list only
        advances after the atomic directory rename."""
        with self._lock:
            if not self._durable:
                return None
            s = self._durable[-1]
        return s, step_dir(self.root, s)

    def restore_last(self, like: Pytree, *,
                     pod_resize: Optional[str] = None,
                     parts: Optional[Pytree] = None) -> Tuple[Pytree, int]:
        """Drain the queue, then restore the newest durable snapshot onto
        ``like``'s devices (placed, by ``parts``: ``checkpoint.restore``).

        A snapshot this engine committed can only be damaged externally
        (disk truncation, an operator's stray rm); on a
        ``CheckpointCorruptError`` the damaged directory is skipped and the
        next-newest durable snapshot is tried."""
        self.wait()
        while True:
            with self._lock:
                if not self._durable:
                    raise FileNotFoundError(
                        f"no durable snapshot under {self.root!r}")
                s = self._durable[-1]
            try:
                return ckpt.restore(step_dir(self.root, s), like=like,
                                    pod_resize=pod_resize, parts=parts)
            except ckpt.CheckpointCorruptError:
                with self._lock:
                    if self._durable and self._durable[-1] == s:
                        self._durable.pop()

    # ------------------------------------------------------------ shutdown
    def close(self) -> None:
        """Drain the queue, stop the worker and release the host buffers.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._thread.join()
        with self._pool:
            for b in self._host_bufs:
                b.release()
            self._host_bufs, self._free = [], []
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def blocking_equivalent(tree: Pytree, step: int, directory: str,
                        metadata: Optional[dict] = None,
                        parts: Optional[Pytree] = None,
                        group: Optional[ckpt.CheckpointGroup] = None) -> str:
    """Reference semantics for one engine snapshot: the blocking
    ``checkpoint.save`` of the same tree at the same step (of a placed
    tree, ``checkpoint.save_placed`` with its ``parts`` over ``group``),
    written under ``directory`` with the engine's step-dir naming.  A
    snapshot's files equal this save's byte for byte."""
    d = step_dir(directory, step)
    if parts is None:
        ckpt.save(d, tree, step=step, metadata=metadata)
    else:
        ckpt.save_placed(d, tree, parts, group, step=step, metadata=metadata)
    return d
