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
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

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
    ``int`` (the trainer's step) as a 0-d int32."""
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
    os.makedirs(directory, exist_ok=True)
    keys, leaves = _keys(tree), T.leaves(tree)
    shapes = [tuple(x.shape) if isinstance(x, torch.Tensor) else ()
              for x in leaves]
    _commit(directory, leaves,
            build_manifest(keys, leaves, shapes, step, metadata))


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


def _read_member(f, fd: int, pool, info: zipfile.ZipInfo, off: int):
    """One stored ``.npy`` member read into a new host array by the
    pool's threads -> (array, its data span's CRC pieces)."""
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
    arr = np.empty(shape, dtype, order="F" if fortran else "C")
    n = arr.nbytes
    if head + n != info.file_size:
        raise ValueError(f"member {info.filename!r}: {info.file_size} "
                         f"bytes for a {head} + {n} byte array")
    flat = arr.reshape(-1, order="A").view(np.uint8)

    def read(lo: int) -> int:
        view = memoryview(flat[lo:lo + _CHUNK])
        got = os.preadv(fd, [view], off + head + lo)
        if got != len(view):
            raise ValueError(f"member {info.filename!r} is cut off")
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


def _load_arrays(directory: str, manifest: dict):
    """Read and integrity-check ``arrays.npz`` against the manifest: its
    byte size, then the CRC32 of the whole file (or, for a manifest
    without the commit record, each member's zip CRC)."""
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
    try:
        with open(apath, "rb") as f, zipfile.ZipFile(f) as zf, \
                ThreadPoolExecutor(_THREADS) as pool:
            arrays, spans = {}, []
            for info, off in _members(f, zf):
                arr, pieces = _read_member(f, f.fileno(), pool, info, off)
                if want_bytes is None and _crc_of(pieces) != info.CRC:
                    raise zipfile.BadZipFile(
                        f"bad CRC-32 for member {info.filename!r}")
                arrays[info.filename] = arr
                spans.append((off, info.file_size, pieces))
            crc = _crc_of(_gaps(f, spans, size))
            by_key = {k: arrays[f"a{i}.npy"]
                      for i, k in enumerate(manifest["keys"])}
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


def _resize_pod_dim(arr: np.ndarray, n_new: int, how: str) -> np.ndarray:
    """Host-side pod-dimension resize, matching ``repro_torch.core.sync``'s
    transforms: grow seeds new pods with the mean replica ("mean") or copies
    of pod 0 ("clone"); shrink keeps the first ``n_new`` pods, shifted so
    their mean equals the old global mean ("mean") or plainly dropped
    ("drop" / "clone")."""
    n_old = arr.shape[0]
    if n_new == n_old:
        return arr
    if n_new > n_old:
        if how == "drop":
            raise ValueError(
                f"pod_resize='drop' cannot grow {n_old} -> {n_new} pods")
        if how == "clone":
            fill = np.broadcast_to(arr[:1], (n_new - n_old,) + arr.shape[1:])
        else:
            fill = np.broadcast_to(
                arr.astype(np.float32).mean(axis=0, keepdims=True),
                (n_new - n_old,) + arr.shape[1:]).astype(arr.dtype)
        return np.concatenate([arr, fill], axis=0)
    kept = arr[:n_new]
    if how == "mean":
        # the reference's expression, value for value, with fewer
        # temporaries (a state holds tens of GB): an f32 array is not
        # copied to f32, and the shift is formed and applied in place
        f32 = functools.partial(np.ndarray.astype, dtype=np.float32,
                                copy=False)
        shift = f32(arr).mean(axis=0, keepdims=True)
        shift -= f32(kept).mean(axis=0, keepdims=True)
        kept = np.add(f32(kept), shift, out=shift if n_new == 1 else None)
        kept = kept.astype(arr.dtype, copy=False)
    return kept


def restore(directory: str, like: Pytree, device=None,
            pod_resize: Optional[str] = None) -> Tuple[Pytree, int]:
    """Restore into the structure of ``like``; keys are matched by path, so
    the tree may be re-laid-out.  Returns (tree, step).

    Each leaf takes ``like``'s dtype and lands on ``device`` (default: the
    ``like`` leaf's device); an ``int`` leaf of ``like`` (the trainer's
    step) comes back as an ``int``.  ``pod_resize`` ("mean" | "clone" |
    "drop") restores a checkpoint written at one leading pod-dimension size
    into a tree stacked for another, with the named transform; trailing
    dimensions must still match exactly.

    Raises :class:`CheckpointCorruptError` when the directory's files are
    missing, truncated, or fail the manifest's size or CRC record.
    """
    if pod_resize not in (None, "mean", "clone", "drop"):
        raise ValueError(f"unknown pod_resize mode {pod_resize!r}")
    manifest = load_manifest(directory)
    by_key = _load_arrays(directory, manifest)

    out = []
    for k, ref in zip(_keys(like), T.leaves(like)):
        if k not in by_key:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        arr = by_key.pop(k)
        shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            if (pod_resize is not None and arr.ndim == len(shape)
                    and arr.ndim >= 1
                    and tuple(arr.shape[1:]) == shape[1:]):
                arr = _resize_pod_dim(arr, shape[0], pod_resize)
            else:
                raise ValueError(
                    f"shape mismatch for {k!r}: ckpt {arr.shape} "
                    f"vs model {shape}")
        if not isinstance(ref, torch.Tensor):
            out.append(int(arr))
            continue
        if not arr.flags.c_contiguous:        # a Fortran-order member
            arr = arr.copy(order="C")
        t = torch.from_numpy(arr).to(ref.dtype)
        out.append(t.to(device if device is not None else ref.device))
    return T.unflatten(like, out), manifest["step"]
