"""Tree checkpointing in the reference's format: ``arrays.npz`` plus a
``manifest.json`` of keys, dtypes, shapes, step and metadata.

Counterpart of ``repro/checkpoint/checkpoint.py``.  A checkpoint that
either package writes restores in the other: the leaf keys are the
reference's spelling (NamedTuple fields ``.name``, dict keys as they are,
sequence items by index, joined by ``/``), leaf ``i`` is member ``a{i}``
of the npz, bf16 leaves are stored upcast to f32 (lossless) with
``"bfloat16"`` in the manifest, and the trainer's Python ``int`` step is
stored as the reference's 0-d int32.

Writes are atomic: both files are staged in a tmp sibling directory and
``os.replace``d into place, arrays first, manifest last.  The manifest is
the commit record: it carries the byte size and CRC32 of the arrays file
it was written against, and ``restore`` verifies them, so a crash
mid-save leaves the previous checkpoint or a mismatch that raises
:class:`CheckpointCorruptError`, never a torn restore.

At full width the state is tens of GB, so where the reference holds every
leaf and the whole file in host memory at once (and reads the file twice
more, to check it and to load it), the port moves one leaf at a time
between the device and the file, and touches each byte once.  The save
writes the archive ``np.savez`` writes (one stored zip64 member
``a{i}.npy`` a leaf, zip64 central records only where an offset or size
needs them), with the leaf's copy to the host overlapping the write of
the one before; the restore reads each member straight into its host
buffer.  Every member is dated at the zip epoch (1980-01-01 00:00), so
one tree always writes the same bytes: the size and CRC32 in two
manifests of one tree are equal (an async snapshot's and a blocking
save's), and equal to the reference's when its clock reads the epoch.
Threads checksum the data in chunks, and the file's CRC32, the same
number as the reference's, is assembled from those pieces and the few
header bytes between them.  ``restore`` takes ``device=`` where
the reference takes ``shardings=``.

A placed tree (a trainer's state on a mesh: each rank holds its pods' rows
of the pod-stacked leaves, each an in-pod DTensor) is described by a tree
of :class:`Part` (the port's ``shardings=``).  :func:`save_placed`, called
by every rank of the mesh, writes the file the unplaced save of the whole
tree writes, byte for byte: leaf by leaf, in key order, each rank ships the
pieces it owns to one writer, the mesh's first rank (over the gloo group
of a :class:`CheckpointGroup`), which assembles the whole leaf on the host
while it writes the one before and commits; every rank returns after the
commit.  ``restore(..., parts=)`` has each rank read and check the whole
file, resize the whole pod dimension (``pod_resize``), and keep only its
rows and in-pod shard of each leaf on the host before it places them.  A
plain :func:`save` of a DTensor leaf raises.
"""
from __future__ import annotations

import functools
import io
import json
import os
import shutil
import struct
import tempfile
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.sharding.rules import (contiguous_stride, is_dtensor,
                                        local_part)

Pytree = Any

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"

# bytes a thread reads or checksums at a time, and the threads
_CHUNK = 64 << 20
_THREADS = 8
# zip records as zipfile packs them: a local file header, a central
# directory entry, the zip64 end record and its locator, the end record
_LOCAL_HEADER = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END64 = struct.Struct("<4sQ2H2L4Q")
_END64_LOCATOR = struct.Struct("<4sLQL")
_END = struct.Struct("<4s4H2LH")
_ZIP64_VERSION = 45
_U32 = 0xFFFFFFFF
# what zipfile writes beside them: a central record carries zip64 fields
# past 2 GiB, the archive a zip64 end record past 2 GiB or 65535 members
_ZIP64_LIMIT = (1 << 31) - 1
_COUNT_LIMIT = (1 << 16) - 1
# every member's date and time, in DOS form: 1980-01-01 00:00:00
_DOS_DATE, _DOS_TIME = 1 << 5 | 1, 0


class CheckpointCorruptError(RuntimeError):
    """The checkpoint directory is torn: a file is missing, truncated, or
    fails the manifest's integrity record.  Callers distinguish this
    ("fall back to an older snapshot") from shape or key mismatches (a
    programming error)."""


# ------------------------------------------------------------ tree and keys


def _keys(tree: Pytree, prefix: str = "") -> List[str]:
    """Leaf keys in :func:`repro_torch.tree.leaves` order, spelled as the
    reference spells them (``.params/w``, ``.sync_state/.tier``)."""
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        kids = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [prefix]
    out: List[str] = []
    for key, sub in kids:
        out.extend(_keys(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _dtype_name(x) -> str:
    """The manifest's dtype string: numpy's name of the leaf's dtype."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return "int32"                        # the trainer's int step


def _host_leaf(x) -> np.ndarray:
    """One leaf on the host as the file stores it: bf16 upcast to f32, an
    ``int`` (the trainer's step) as a 0-d int32; a callable (a leaf the
    writer assembles from its pieces, ``CheckpointGroup.ship``) is called
    first."""
    if callable(x):
        x = x()
    if is_dtensor(x):
        raise TypeError("a checkpoint leaf is a DTensor: save a placed tree "
                        "with save_placed (Trainer.save_state), which "
                        "writes its whole value")
    if not isinstance(x, torch.Tensor):
        if not isinstance(x, int) or isinstance(x, bool):
            raise TypeError(f"a checkpoint leaf is a tensor or an int, "
                            f"got {type(x).__name__}")
        return np.asarray(x, dtype=np.int32)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


# -------------------------------------------------------------- CRC pieces


def _gf2_times(mat: Tuple[int, ...], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


@functools.lru_cache(maxsize=None)
def _zeros_op(k: int) -> Tuple[int, ...]:
    """The linear map that advances a CRC32 over ``2**k`` zero bytes, as
    32 columns (zlib's ``crc32_combine`` construction)."""
    if k < 0:                             # one zero bit
        return (0xEDB88320,) + tuple(1 << n for n in range(31))
    prev = _zeros_op(k - 1)
    # one byte is three squarings of one bit; each later power one more
    for _ in range(3 if k == 0 else 1):
        prev = tuple(_gf2_times(prev, prev[n]) for n in range(32))
    return prev


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of ``A + B`` from ``crc1 = crc32(A)``, ``crc2 = crc32(B)`` and
    ``len2 = len(B)``."""
    k = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_times(_zeros_op(k), crc1)
        len2 >>= 1
        k += 1
    return crc1 ^ crc2


def _crc_of(pieces) -> int:
    """Combine ``(crc, length)`` pieces, in file order, into one CRC32."""
    crc = 0
    for c, n in pieces:
        crc = crc32_combine(crc, c, n)
    return crc


def _members(f, zf: zipfile.ZipFile) -> List[Tuple[zipfile.ZipInfo, int]]:
    """Each member of ``zf`` in file order with the offset of its data."""
    out = []
    for info in sorted(zf.infolist(), key=lambda i: i.header_offset):
        f.seek(info.header_offset)
        head = f.read(_LOCAL_HEADER.size)
        if len(head) != _LOCAL_HEADER.size:
            raise zipfile.BadZipFile(f"member {info.filename!r} is cut off")
        fields = _LOCAL_HEADER.unpack(head)
        if fields[0] != b"PK\003\004":
            raise zipfile.BadZipFile(f"member {info.filename!r} has no "
                                     f"local header")
        out.append((info, info.header_offset + _LOCAL_HEADER.size
                    + fields[10] + fields[11]))
    return out


def _gaps(f, spans, size: int):
    """``(crc, length)`` of the bytes between member data spans (headers,
    the central directory) interleaved with the spans' own pieces."""
    pieces, pos = [], 0
    for start, n, inner in spans:
        f.seek(pos)
        gap = f.read(start - pos)
        pieces.append((zlib.crc32(gap), len(gap)))
        pieces.extend(inner)
        pos = start + n
    f.seek(pos)
    tail = f.read(size - pos)
    pieces.append((zlib.crc32(tail), len(tail)))
    return pieces


# -------------------------------------------------------------------- save


def _crc_chunks(pool, data: np.ndarray) -> List[Tuple[int, int]]:
    """``(crc, length)`` of ``data``'s bytes in ``_CHUNK`` pieces, computed
    by the pool's threads (zlib releases the interpreter lock)."""
    starts = range(0, data.nbytes, _CHUNK)
    crcs = pool.map(lambda lo: zlib.crc32(data[lo:lo + _CHUNK]), starts)
    return [(c, min(_CHUNK, data.nbytes - lo)) for c, lo in zip(crcs, starts)]


def _npy(x) -> Tuple[bytes, np.ndarray]:
    """One leaf as an ``.npy`` member: its header, and its data as bytes."""
    arr = _host_leaf(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arr))
    return head.getvalue(), arr.reshape(-1).view(np.uint8)


def _write_npz(path: str, leaves) -> Tuple[int, int]:
    """Write ``leaves`` as the stored zip64 members ``a{i}.npy`` of a new
    archive at ``path`` (the layout ``np.savez`` writes); the next leaf's
    copy to the host runs while this one is written.  Returns the file's
    size and CRC32."""
    pieces, entries = [], []

    def put(f, b: bytes) -> None:
        f.write(b)
        pieces.append((zlib.crc32(b), len(b)))

    with open(path, "wb") as f, ThreadPoolExecutor(1) as fetch, \
            ThreadPoolExecutor(_THREADS) as pool:
        nxt = fetch.submit(_npy, leaves[0]) if leaves else None
        for i in range(len(leaves)):
            head, data = nxt.result()
            nxt = (fetch.submit(_npy, leaves[i + 1])
                   if i + 1 < len(leaves) else None)
            name = f"a{i}.npy".encode()
            size = len(head) + data.nbytes
            body = [(zlib.crc32(head), len(head))] + _crc_chunks(pool, data)
            crc = _crc_of(body)
            entries.append((name, crc, size, f.tell()))
            put(f, _LOCAL_HEADER.pack(
                b"PK\003\004", _ZIP64_VERSION, 0, 0, zipfile.ZIP_STORED,
                _DOS_TIME, _DOS_DATE, crc, _U32, _U32, len(name), 20)
                + name + struct.pack("<HHQQ", 1, 16, size, size))
            f.write(head)
            f.write(data)
            pieces.extend(body)
        start = f.tell()
        for name, crc, size, offset in entries:
            big = [size, size] if size > _ZIP64_LIMIT else []
            big += [offset] if offset > _ZIP64_LIMIT else []
            extra = (struct.pack(f"<HH{len(big)}Q", 1, 8 * len(big), *big)
                     if big else b"")
            put(f, _CENTRAL.pack(
                b"PK\001\002", _ZIP64_VERSION, 3, _ZIP64_VERSION, 0, 0,
                zipfile.ZIP_STORED, _DOS_TIME, _DOS_DATE, crc,
                *([_U32] * 2 if size > _ZIP64_LIMIT else [size] * 2),
                len(name), len(extra), 0, 0, 0, 0o600 << 16,
                _U32 if offset > _ZIP64_LIMIT else offset) + name + extra)
        end64 = f.tell()
        n, cd = len(entries), end64 - start
        if n > _COUNT_LIMIT or start > _ZIP64_LIMIT or cd > _ZIP64_LIMIT:
            put(f, _END64.pack(b"PK\006\006", _END64.size - 12,
                               _ZIP64_VERSION, _ZIP64_VERSION, 0, 0, n, n,
                               cd, start)
                + _END64_LOCATOR.pack(b"PK\006\007", 0, end64, 1))
        put(f, _END.pack(b"PK\005\006", 0, 0, min(n, 0xFFFF),
                         min(n, 0xFFFF), min(cd, _U32), min(start, _U32), 0))
        return f.tell(), _crc_of(pieces)


def write_files(directory: str, leaves, manifest: dict) -> None:
    """Write ``arrays.npz`` and then ``manifest.json``, with the arrays'
    size and CRC32 as its commit record, into the existing
    ``directory``."""
    size, crc = _write_npz(os.path.join(directory, _ARRAYS), leaves)
    manifest = dict(manifest, arrays_bytes=size, arrays_crc32=crc)
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def _commit(directory: str, leaves, manifest: dict) -> None:
    """Stage arrays and manifest in a tmp sibling dir, then ``os.replace``
    into ``directory`` (arrays first, manifest last: the manifest, which
    records the arrays' size and CRC, is the commit point)."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    tmp = tempfile.mkdtemp(prefix=".ckpt-stage-", dir=parent)
    try:
        write_files(tmp, leaves, manifest)
        for name in (_ARRAYS, _MANIFEST):
            os.replace(os.path.join(tmp, name), os.path.join(directory, name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_manifest(keys, leaves, shapes, step: int,
                   metadata: Optional[dict]) -> dict:
    """The reference's manifest, from the leaves' shapes (the reference
    takes them from its host copies, which it holds all at once)."""
    return {
        "step": step,
        "keys": keys,
        "dtypes": [_dtype_name(x) for x in leaves],
        "shapes": [list(s) for s in shapes],
        "metadata": metadata or {},
    }


def save(directory: str, tree: Pytree, step: int = 0,
         metadata: Optional[dict] = None) -> None:
    """Save a whole tree; a DTensor leaf raises (:func:`save_placed`)."""
    keys, leaves = _keys(tree), T.leaves(tree)
    if any(is_dtensor(x) for x in leaves):
        raise TypeError("save of a tree that holds a DTensor: save a placed "
                        "tree with save_placed (Trainer.save_state)")
    os.makedirs(directory, exist_ok=True)
    shapes = [tuple(x.shape) if isinstance(x, torch.Tensor) else ()
              for x in leaves]
    _commit(directory, leaves,
            build_manifest(keys, leaves, shapes, step, metadata))


# ------------------------------------------------------------ placed trees


@dataclass(frozen=True)
class Part:
    """This rank's part of one leaf of a placed tree.  ``shape`` is the
    whole leaf's; ``rows`` the ``(first, count)`` rows of its leading pod
    dimension this rank holds (``None``: the leaf has no pod dimension);
    ``mesh`` and ``placements`` the in-pod ``DeviceMesh`` and placements of
    a DTensor leaf (``None``: a plain tensor or an ``int``).  ``owner``:
    whether this rank ships its piece to the writer (one rank of the
    ranks that hold a piece alike)."""

    shape: Tuple[int, ...]
    rows: Optional[Tuple[int, int]] = None
    mesh: Any = None
    placements: tuple = ()
    owner: bool = True

    def local(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(the local piece's shape, its offset in the whole leaf)."""
        shape = tuple(self.shape)
        if self.rows is not None:
            shape = (self.rows[1],) + shape[1:]
        offset = (0,) * len(shape)
        if self.mesh is not None:
            from torch.distributed.tensor._utils import \
                compute_local_shape_and_global_offset
            shape, offset = compute_local_shape_and_global_offset(
                shape, self.mesh, self.placements)
            shape, offset = tuple(shape), tuple(offset)
        if self.rows is not None:
            offset = (offset[0] + self.rows[0],) + offset[1:]
        return shape, offset


def owner_of(mesh, placements) -> bool:
    """Whether this rank owns its piece among the ranks of ``mesh`` that
    hold it alike: its coordinate is 0 on every replicated mesh axis."""
    if mesh is None:
        return True
    coord = mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, placements)
               if p.is_replicate())


def _index(offset, shape):
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


class CheckpointGroup:
    """The ranks of a placed tree's mesh (global ranks, the writer first)
    and the gloo group that carries each leaf's pieces to the writer,
    which alone touches the directory, and the writer's outcome back to
    every rank, point to point: ``group`` may hold other ranks too (a
    trainer's gloo group of the whole world, ``Trainer.io_group``).
    Without one it makes a gloo group of ``ranks``, which is collective
    over the whole world (``new_group``): every rank of the world makes
    it, in the same order."""

    def __init__(self, ranks: Sequence[int], group=None,
                 timeout: timedelta = timedelta(seconds=600)):
        import torch.distributed as dist

        self.ranks = tuple(int(r) for r in ranks)
        self.writer = self.ranks[0]
        self.rank = dist.get_rank()
        self.group = (group if group is not None else
                      dist.new_group(list(self.ranks), backend="gloo",
                                     timeout=timeout))

    @property
    def is_writer(self) -> bool:
        return self.rank == self.writer

    def ship(self, locals_: Sequence, parts: Sequence[Part]):
        """Every rank, in key order: each owned piece goes to the writer.
        On the writer, returns one callable a leaf that assembles the whole
        leaf from its pieces (to be called in key order, as the writer's
        stream does); elsewhere, ``None`` once every piece is sent."""
        import torch.distributed as dist

        mine = []
        for i, (x, part) in enumerate(zip(locals_, parts)):
            if part.owner:
                shape, offset = part.local()
                mine.append((i, offset, shape))
        if not self.is_writer:
            dist.send_object_list([mine], self.writer, group=self.group)
            for i, _, shape in mine:
                if isinstance(locals_[i], torch.Tensor) and \
                        torch.Size(shape).numel():
                    dist.send(_bytes(locals_[i].detach().cpu()),
                              self.writer, group=self.group, tag=i + 1)
            return None
        senders: Dict[int, list] = {}
        for r in self.ranks:
            got = [mine]
            if r != self.rank:
                dist.recv_object_list(got, r, group=self.group)
            for i, offset, shape in got[0]:
                senders.setdefault(i, []).append((r, offset, shape))

        def assemble(i):
            # every sender's piece is received at once, each straight into
            # the whole leaf where its slice is contiguous (a pod's rows)
            x, part = locals_[i], parts[i]
            if not isinstance(x, torch.Tensor):
                return x
            whole = torch.empty(part.shape, dtype=x.dtype)
            filled, posted, staged = 0, [], []
            for r, offset, shape in sorted(senders.get(i, [])):
                view = whole[_index(offset, shape)]
                if r == self.rank:
                    view.copy_(x.detach().cpu())
                elif view.numel():
                    piece = (view if view.is_contiguous() else
                             torch.empty(shape, dtype=x.dtype))
                    posted.append(dist.irecv(_bytes(piece), r,
                                             group=self.group, tag=i + 1))
                    if piece is not view:
                        staged.append((view, piece))
                filled += view.numel()
            for req in posted:
                req.wait()
            for view, piece in staged:
                view.copy_(piece)
            if filled != whole.numel():
                raise RuntimeError(f"leaf {i}: the owned pieces cover "
                                   f"{filled} of {whole.numel()} elements")
            return whole

        # the writer's fetch thread calls each, one leaf ahead of the write
        return [lambda i=i: assemble(i) for i in range(len(locals_))]

    def commit(self, fn: Callable[[], Any]):
        """Run ``fn`` on the writer and hand its outcome to every rank:
        its value, or on every rank a ``RuntimeError`` naming the writer's
        failure."""
        import torch.distributed as dist

        out = [None]
        if self.is_writer:
            try:
                out = [("ok", fn())]
            except Exception as e:  # noqa: BLE001 — re-raised on all ranks
                out = [("error", f"{type(e).__name__}: {e}")]
                err = e
            for r in self.ranks[1:]:
                dist.send_object_list(out, r, group=self.group)
        else:
            dist.recv_object_list(out, self.writer, group=self.group)
        kind, value = out[0]
        if kind == "error":
            if self.is_writer:
                raise err
            raise RuntimeError(f"the checkpoint writer (rank {self.writer}) "
                               f"failed: {value}")
        return value


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor's bytes, as gloo ships them."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def save_placed(directory: str, tree: Pytree, parts: Pytree,
                group: CheckpointGroup, step: int = 0,
                metadata: Optional[dict] = None) -> None:
    """Save a placed tree as :func:`save` saves its whole value, byte for
    byte.  Every rank of ``group`` calls it with its own leaves and their
    :class:`Part` tree; the writer streams the whole leaves and commits;
    every rank returns after the commit (and raises if it failed)."""
    keys, leaves = _keys(tree), T.leaves(tree)
    parts = _part_leaves(parts, len(leaves))
    for k, x, part in zip(keys, leaves, parts):
        local = local_part(x)
        want = part.local()[0] if isinstance(x, torch.Tensor) else ()
        got = tuple(local.shape) if isinstance(x, torch.Tensor) else ()
        if got != tuple(want):
            raise ValueError(f"leaf {k!r}: this rank holds {got}, its part "
                             f"says {tuple(want)} (a split state saved "
                             f"without its pod axis?)")
    fetch = group.ship([local_part(x) for x in leaves], parts)
    manifest = build_manifest(keys, leaves, [p.shape for p in parts],
                              step, metadata)

    def write():
        os.makedirs(directory, exist_ok=True)
        _commit(directory, fetch, manifest)

    group.commit(write)


def _part_leaves(parts: Pytree, n: int) -> List[Part]:
    out = T.leaves(parts)
    if len(out) != n or not all(isinstance(p, Part) for p in out):
        raise ValueError(f"a placed tree needs one Part a leaf ({n}), got "
                         f"{len(out)}")
    return out


# ----------------------------------------------------------------- restore


def load_manifest(directory: str) -> dict:
    path = os.path.join(directory, _MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {path!r} is not valid JSON "
            f"(torn write?): {e}") from e


def _read_member(f, fd: int, pool, info: zipfile.ZipInfo, off: int,
                 rows: Optional[Tuple[int, int]] = None):
    """One stored ``.npy`` member read into a new host array by the
    pool's threads -> (array, its data span's CRC pieces).  With ``rows``
    (``(first, count)`` of a C-order member's leading dimension) only those
    rows are kept: every byte is still read and checksummed, the rest
    through a scratch buffer."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"member {info.filename!r} is compressed")
    f.seek(off)
    version = np.lib.format.read_magic(f)
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(f))
    if dtype.hasobject:
        raise ValueError(f"member {info.filename!r} holds objects")
    head = f.tell() - off
    f.seek(off)
    header = f.read(head)
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if head + n != info.file_size:
        raise ValueError(f"member {info.filename!r}: {info.file_size} "
                         f"bytes for a {head} + {n} byte array")
    if rows is None or fortran or not shape:
        rows = None
        arr = np.empty(shape, dtype, order="F" if fortran else "C")
        lo_keep = 0
    else:
        arr = np.empty((rows[1],) + tuple(shape[1:]), dtype)
        lo_keep = rows[0] * (n // shape[0] if shape[0] else 0)
    flat = arr.reshape(-1, order="A").view(np.uint8)
    hi_keep = lo_keep + flat.nbytes

    def read(lo: int) -> int:
        hi = min(lo + _CHUNK, n)
        inside = lo_keep <= lo and hi <= hi_keep
        view = memoryview(flat[lo - lo_keep:hi - lo_keep] if inside
                          else np.empty(hi - lo, np.uint8))
        got = os.preadv(fd, [view], off + head + lo)
        if got != len(view):
            raise ValueError(f"member {info.filename!r} is cut off")
        if not inside:
            a, b = max(lo, lo_keep), min(hi, hi_keep)
            if a < b:
                flat[a - lo_keep:b - lo_keep] = \
                    np.frombuffer(view, np.uint8)[a - lo:b - lo]
        return zlib.crc32(view)

    starts = range(0, n, _CHUNK)
    crcs = list(pool.map(read, starts))
    pieces = [(zlib.crc32(header), head)] + [
        (c, min(_CHUNK, n - lo)) for c, lo in zip(crcs, starts)]
    return arr, pieces


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            crc = zlib.crc32(chunk, crc)
    return crc


def _load_arrays(directory: str, manifest: dict,
                 plan: Optional[Callable] = None):
    """Read and integrity-check ``arrays.npz`` against the manifest: its
    byte size, then the CRC32 of the whole file (or, for a manifest
    without the commit record, each member's zip CRC).  ``plan(key)`` ->
    ``(rows, keep)``: the rows of the member to read (``None``: all) and
    a function that makes what is kept of them (``None``: nothing), called
    as each member is read, so that one member at a time is whole on the
    host; no ``plan`` keeps every member whole."""
    apath = os.path.join(directory, _ARRAYS)
    try:
        size = os.path.getsize(apath)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"checkpoint {directory!r} has a manifest but no {_ARRAYS} "
            f"(torn write?)") from e
    want_bytes = manifest.get("arrays_bytes")
    if want_bytes is not None and size != want_bytes:
        raise CheckpointCorruptError(
            f"checkpoint {apath!r} is {size} bytes but the manifest "
            f"committed {want_bytes} (truncated or torn write)")
    keys = {f"a{i}.npy": k for i, k in enumerate(manifest["keys"])}
    try:
        with open(apath, "rb") as f, zipfile.ZipFile(f) as zf, \
                ThreadPoolExecutor(_THREADS) as pool:
            by_key, spans = {}, []
            for info, off in _members(f, zf):
                key = keys[info.filename]
                rows, keep = plan(key) if plan else (None, lambda a: a)
                arr, pieces = _read_member(f, f.fileno(), pool, info, off,
                                           rows)
                if want_bytes is None and _crc_of(pieces) != info.CRC:
                    raise zipfile.BadZipFile(
                        f"bad CRC-32 for member {info.filename!r}")
                if keep is not None:
                    by_key[key] = keep(arr)
                spans.append((off, info.file_size, pieces))
            crc = _crc_of(_gaps(f, spans, size))
            missing = set(keys.values()) - set(by_key)
            if plan is None and missing:
                raise KeyError(f"members of {sorted(missing)} missing")
    except (zipfile.BadZipFile, ValueError, KeyError, OSError,
            struct.error) as e:
        # the reference checks the CRC before it parses: a file that fails
        # it reports so, whatever part of it the damage hit
        if want_bytes is not None and \
                _file_crc(apath) != manifest.get("arrays_crc32"):
            raise CheckpointCorruptError(
                f"checkpoint {apath!r} fails its manifest CRC "
                f"(corrupted or torn write)") from e
        raise CheckpointCorruptError(
            f"checkpoint {apath!r} is unreadable (truncated or torn "
            f"write): {e}") from e
    if want_bytes is not None and crc != manifest.get("arrays_crc32"):
        raise CheckpointCorruptError(
            f"checkpoint {apath!r} fails its manifest CRC "
            f"(corrupted or torn write)")
    return by_key


def _resize_pod_dim(arr: np.ndarray, n_new: int, how: str,
                    rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Host-side pod-dimension resize, matching ``repro_torch.core.sync``'s
    transforms: grow seeds new pods with the mean replica ("mean") or copies
    of pod 0 ("clone"); shrink keeps the first ``n_new`` pods, shifted so
    their mean equals the old global mean ("mean") or plainly dropped
    ("drop" / "clone").  ``rows`` (``(first, count)`` of the new pod
    dimension) makes only those rows.  The expression runs on chunks of
    ``_RESIZE_COLS`` columns on ``_THREADS`` threads: every value depends
    on its own column alone, so the chunks give the whole array's bits."""
    n_old = arr.shape[0]
    first, count = rows if rows is not None else (0, n_new)
    if n_new == n_old:
        return arr if rows is None else arr[first:first + count]
    if n_new > n_old and how == "drop":
        raise ValueError(
            f"pod_resize='drop' cannot grow {n_old} -> {n_new} pods")
    if n_new < n_old and how != "mean":
        return arr[first:first + count]
    cols = arr.reshape(n_old, -1)
    out = np.empty((count, cols.shape[1]), arr.dtype)

    def chunk(lo: int) -> None:
        hi = min(lo + _RESIZE_COLS, cols.shape[1])
        out[:, lo:hi] = _resize_cols(cols[:, lo:hi], n_new,
                                     how)[first:first + count]

    starts = range(0, cols.shape[1], _RESIZE_COLS)
    if len(starts) == 1:
        chunk(0)
    else:
        with ThreadPoolExecutor(_THREADS) as pool:
            list(pool.map(chunk, starts))
    return out.reshape((count,) + arr.shape[1:])


# columns of the pod dimension one chunk of ``_resize_pod_dim`` resizes
_RESIZE_COLS = 1 << 18


def _resize_cols(arr: np.ndarray, n_new: int, how: str) -> np.ndarray:
    """The resize of :func:`_resize_pod_dim` on ``(n_old, columns)``: a
    grow by "mean" or "clone", a shrink by "mean"."""
    n_old = arr.shape[0]
    if n_new > n_old:
        if how == "clone":
            fill = np.broadcast_to(arr[:1], (n_new - n_old,) + arr.shape[1:])
        else:
            fill = np.broadcast_to(
                arr.astype(np.float32).mean(axis=0, keepdims=True),
                (n_new - n_old,) + arr.shape[1:]).astype(arr.dtype)
        return np.concatenate([arr, fill], axis=0)
    # the reference's expression, value for value, with fewer temporaries:
    # an f32 array is not copied to f32, and the shift is formed and
    # applied in place
    kept = arr[:n_new]
    f32 = functools.partial(np.ndarray.astype, dtype=np.float32, copy=False)
    shift = f32(arr).mean(axis=0, keepdims=True)
    shift -= f32(kept).mean(axis=0, keepdims=True)
    kept = np.add(f32(kept), shift, out=shift if n_new == 1 else None)
    return kept.astype(arr.dtype, copy=False)


def restore(directory: str, like: Pytree, device=None,
            pod_resize: Optional[str] = None,
            parts: Optional[Pytree] = None) -> Tuple[Pytree, int]:
    """Restore into the structure of ``like``; keys are matched by path, so
    the tree may be re-laid-out.  Returns (tree, step).

    Each leaf takes ``like``'s dtype and lands on ``device`` (default: the
    ``like`` leaf's device); an ``int`` leaf of ``like`` (the trainer's
    step) comes back as an ``int``.  ``pod_resize`` ("mean" | "clone" |
    "drop") restores a checkpoint written at one leading pod-dimension size
    into a tree stacked for another, with the named transform; trailing
    dimensions must still match exactly.

    ``parts`` (a :class:`Part` a leaf; the reference's ``shardings=``)
    restores placed: each leaf's whole shape is its part's, and this rank
    keeps its rows of the (resized) pod dimension and, for a DTensor part,
    its in-pod shard, cut on the host before it goes to ``device``: no
    rank holds a whole leaf on the card.

    Raises :class:`CheckpointCorruptError` when the directory's files are
    missing, truncated, or fail the manifest's size or CRC record.
    """
    if pod_resize not in (None, "mean", "clone", "drop"):
        raise ValueError(f"unknown pod_resize mode {pod_resize!r}")
    manifest = load_manifest(directory)
    keys, refs = _keys(like), T.leaves(like)
    parts = (_part_leaves(parts, len(refs)) if parts is not None
             else [None] * len(refs))
    stored = dict(zip(manifest["keys"], manifest.get("shapes") or []))
    plans = {}
    for k, ref, part in zip(keys, refs, parts):
        if k not in manifest["keys"]:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        shape = (tuple(part.shape) if part is not None else
                 tuple(ref.shape) if isinstance(ref, torch.Tensor) else ())
        plans[k] = _leaf_plan(k, tuple(stored.get(k, shape)), shape, part,
                              pod_resize)
    by_key = _load_arrays(directory, manifest,
                          lambda k: plans.get(k, (None, None)))

    out = []
    for k, ref, part in zip(keys, refs, parts):
        arr = by_key[k]
        if not isinstance(ref, torch.Tensor):
            out.append(int(arr))
            continue
        t = torch.from_numpy(arr).to(ref.dtype).to(
            device if device is not None else ref.device)
        if part is not None and part.mesh is not None:
            from torch.distributed.tensor import DTensor
            shape = (tuple(part.shape) if part.rows is None
                     else (part.rows[1],) + tuple(part.shape[1:]))
            t = DTensor.from_local(t, part.mesh, part.placements,
                                   run_check=False, shape=shape,
                                   stride=contiguous_stride(shape))
        out.append(t)
    return T.unflatten(like, out), manifest["step"]


def _leaf_plan(key: str, stored: Tuple[int, ...], shape: Tuple[int, ...],
               part: Optional[Part], pod_resize: Optional[str]):
    """How one member is read: ``(rows, keep)`` for :func:`_load_arrays`.
    A shape that differs from the file's raises here, before any read,
    unless ``pod_resize`` bridges the leading dimension."""
    resize = stored != shape
    if resize and not (pod_resize is not None and len(stored) == len(shape)
                       and len(shape) >= 1 and stored[1:] == shape[1:]):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {stored} "
                         f"vs model {shape}")
    if resize and pod_resize == "drop" and shape[0] > stored[0]:
        raise ValueError(f"pod_resize='drop' cannot grow {stored[0]} -> "
                         f"{shape[0]} pods")
    rows = part.rows if part is not None else None

    def keep(arr: np.ndarray) -> np.ndarray:
        if resize:
            arr = _resize_pod_dim(arr, shape[0], pod_resize, rows)
        if part is not None and part.mesh is not None and arr.ndim:
            local, offset = part.local()
            if rows is not None:                 # the rows are cut already
                offset = (offset[0] - rows[0],) + offset[1:]
            arr = arr[_index(offset, local)]
        if not arr.flags.c_contiguous:        # a Fortran-order member, a cut
            arr = arr.copy(order="C")
        return arr

    return (None if resize else rows), keep
