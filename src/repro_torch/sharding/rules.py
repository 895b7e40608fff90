"""Logical-axis sharding rules with divisibility fallback, as placements.

Counterpart of ``repro/sharding/rules.py``.  Model code names the logical
axes of an activation, ``shard(x, "batch", "seq", "d_model")``; a rule table
maps logical names to mesh axes, and :func:`logical_to_spec` builds a spec,
dropping every mesh axis that does not divide its dimension (6 attention
heads do not split over a 16-way ``"model"`` axis, so that dimension stays
whole).  A spec is a plain tuple with one entry per tensor dimension:
``None``, an axis name, or a tuple of names (major to minor), the
reference's ``PartitionSpec`` written out; :func:`placements_for` turns it
into one DTensor ``Placement`` per dimension of a ``DeviceMesh``.

The rules and the mesh live in a thread-local scope, :func:`axis_rules`, as
in the reference.  The reference falls back on the ambient mesh of a ``with
mesh:`` block; the port has no such fallback and reads no private
current-mesh state of torch: :func:`current_mesh` is the mesh of the
innermost :func:`axis_rules` scope, or None.  Without rules and a mesh, and
on a plain tensor, :func:`shard` returns its input: the unsharded path, and
every test on one device, runs exactly as before.  On a DTensor it
redistributes to the spec's placements on the tensor's own mesh, by axis
name: a mesh axis the tensor's mesh lacks (``"pod"``, which runs across
processes, see ``repro_torch.core.sync.PodAxis``) is skipped.

The mesh passed to the spec functions is a ``DeviceMesh``
(``mesh_dim_names``, ``shape``) or any object with the reference's
``axis_names`` and ``devices.shape``, so that a spec can be built for a mesh
no process holds, such as the production ``(2, 16, 16)``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Pytree = Any


class LA(tuple):
    """Marker leaf: the logical axis names of one tensor (a tuple that the
    tree functions here treat as a leaf, not as a container)."""

    def __new__(cls, names):
        return super().__new__(cls, tuple(names))

    @property
    def names(self):
        return tuple(self)


def is_la(x) -> bool:
    return isinstance(x, LA)


class Spec(tuple):
    """A spec: one entry per tensor dimension, ``None``, a mesh axis name
    or a tuple of names.  Equal to the plain tuple of its entries (and so
    to ``tuple(PartitionSpec)``); a leaf of the tree functions here."""


# default logical -> mesh mapping (single- and multi-pod), the reference's
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": "data",        # sequence-sharded KV cache (long_500k decode)
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "expert_ff": "data",
    "capacity": None,
    "vocab": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "fsdp": "data",             # parameter sharding axis (ZeRO-3 style)
    "pattern": None,
    "layers": None,
}


# the step kinds' tables (``repro/launch/context.py``'s): training stacks
# the state over pods (``pod_stack`` -> ``"pod"``) and shards the in-pod
# batch over ``"data"``; serving is per-pod replica, so the request batch
# shards over ``("pod", "data")`` and full KV caches their sequence over
# ``"model"``
def train_rules() -> Dict[str, Axis]:
    r = dict(DEFAULT_RULES)
    r.update({
        "pod_stack": "pod",
        "batch": "data",          # in-pod batch (the stacked dim carries pods)
        "fsdp": "data",
        "cache_seq": None,
    })
    return r


def serve_rules() -> Dict[str, Axis]:
    r = dict(DEFAULT_RULES)
    r.update({
        "batch": ("pod", "data"),
        "cache_seq": "model",
        "fsdp": "data",
    })
    return r


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[Dict[str, Axis]] = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Axis], mesh=None):
    """Install logical sharding rules (and optionally the mesh) for a
    scope; an inner scope without a mesh keeps the outer one's."""
    old = (_CTX.rules, _CTX.mesh)
    _CTX.rules = dict(rules)
    _CTX.mesh = mesh if mesh is not None else _CTX.mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = old


def current_mesh():
    """The mesh of the innermost :func:`axis_rules` scope, or None."""
    return _CTX.mesh


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def logical_to_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Axis]] = None,
                    mesh=None) -> "Spec":
    """The spec of ``shape`` from logical axis names: a tuple with one
    entry per dimension.

    A mesh axis that the mesh lacks, of size 1, or that does not divide the
    dimension is dropped; a multi-axis rule like ``("pod", "data")`` keeps
    its longest divisible prefix; a mesh axis appears at most once, and the
    first dimension that asks for it wins it."""
    rules = rules if rules is not None else (_CTX.rules or DEFAULT_RULES)
    mesh = mesh if mesh is not None else current_mesh()
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    parts: List[Axis] = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if axis is None or mesh is None:
            parts.append(None)
            continue
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        kept: List[str] = []
        size = 1
        for n in names:
            s = sizes.get(n, 1)
            if n not in used and s > 1 and dim % (size * s) == 0:
                kept.append(n)
                used.add(n)
                size *= s
        parts.append(tuple(kept) if len(kept) > 1
                     else (kept[0] if kept else None))
    return Spec(parts)


def placements_for(spec: Sequence[Axis], mesh) -> tuple:
    """One DTensor ``Placement`` per dimension of ``mesh`` (a
    ``DeviceMesh``): ``Shard(d)`` where tensor dimension ``d`` names that
    mesh axis, else ``Replicate()``.  A tensor dimension over several axes
    is ``Shard(d)`` on each, major to minor, which needs its axes in the
    mesh's order.  Spec axes the mesh lacks are skipped."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = [a for a in ((entry,) if isinstance(entry, str) else entry)
                if a in names]
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} of dimension {d} is not in "
                             f"the mesh's axis order {names}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (imported here, on first use)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Place ``x`` by logical axis names: a no-op without rules and a mesh,
    and on a plain tensor; a DTensor is redistributed to the spec's
    placements on its own mesh.  Raises on a rank mismatch, as the
    reference does."""
    mesh = current_mesh()
    if mesh is None or _CTX.rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"shard: {len(logical)} names for rank-{x.dim()} "
                         f"tensor")
    if not is_dtensor(x):
        return x
    spec = logical_to_spec(tuple(x.shape), logical)
    want = placements_for(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_dim(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x`` with dimension ``dim`` reshaped to ``sizes``.  DTensor refuses to split a dimension
    sharded over mesh axes whose size does not divide the leading factor
    (granite-8b's 8 kv heads on a 16-way ``"model"`` axis), where XLA
    reshards by itself: such a dimension is first gathered on those
    axes."""
    d = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        split = [i for i, p in enumerate(x.placements)
                 if p.is_shard() and p.dim == d]
        ways = 1
        for i in split:
            ways *= mesh.size(i)
        if sizes[0] % ways:
            want = [Replicate() if i in split else p
                    for i, p in enumerate(x.placements)]
            x = x.redistribute(mesh, want)
    return x.reshape(tuple(x.shape[:d]) + tuple(sizes)
                     + tuple(x.shape[d + 1:]))


class _GradAsForward(torch.autograd.Function):
    """Identity; the gradient is redistributed to the forward output's
    placements, so that the backward of a merge (a split) gets the layout
    the merge produced and not whatever a later product left."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def merge_dims(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with dimensions ``dim .. dim + n - 1`` reshaped into one.  On
    a DTensor the gradient is brought back to the merged layout before the
    backward splits it (:func:`split_dim`'s case, met in the backward)."""
    d = dim % x.dim()
    shape = tuple(x.shape)
    size = 1
    for s in shape[d:d + n]:
        size *= s
    y = x.reshape(shape[:d] + (size,) + shape[d + n:])
    return _GradAsForward.apply(y) if is_dtensor(y) else y


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to ``Replicate`` on every axis of its mesh, still
    a DTensor (differentiable: the gradient goes back to its placements),
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def whole_local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on this rank (gathered
    over its mesh; differentiable), a plain tensor as it is.  Where a
    computation has no sharding rule in DTensor, it runs on whole values
    between this and :func:`replicated_like`."""
    return x.full_tensor() if is_dtensor(x) else x


def replicated_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x``, a plain tensor that every rank of ``ref``'s mesh holds
    whole, as a replicated DTensor on that mesh (no communication;
    differentiable), or as it is when ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_part(x):
    """A DTensor's local tensor on this rank; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def contiguous_stride(shape: Sequence[int]) -> tuple:
    """The strides of a C-contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def local_region(fn: Callable, args: Sequence[Optional[torch.Tensor]],
                 arg_axes: Sequence[Optional[Sequence[Optional[str]]]],
                 outs: Sequence[Tuple[Sequence[Optional[str]],
                                      Sequence[int]]]):
    """``fn`` on this rank's local parts, where the computation splits
    along the sharded dimensions with no communication (attention per row
    and head, the SSD per row and head), or posts its own collectives.

    Without a DTensor among ``args`` this is ``fn(*args)``.  Otherwise each
    tensor of ``args`` is placed by the spec of its logical names
    ``arg_axes`` (a plain tensor is taken as replicated; None passes
    through), ``fn`` runs on the local tensors, and each of its outputs
    becomes a DTensor placed by ``outs``' (logical names, global shape).
    DTensor's own rules never see the ops inside, so no reshape there
    flattens two sharded dimensions and no backward views an uneven
    shard; gradients come back in the placements given here."""
    ref = next((a for a in args if is_dtensor(a)), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    local = []
    for a, names in zip(args, arg_axes):
        if a is None:
            local.append(None)
            continue
        want = placements_for(logical_to_spec(tuple(a.shape), names,
                                              mesh=mesh), mesh)
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(a.to_local())
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    placed = tuple(
        DTensor.from_local(
            r.contiguous(), mesh, placements_for(logical_to_spec(
                tuple(shape), names, mesh=mesh), mesh), run_check=False,
            shape=torch.Size(shape), stride=contiguous_stride(shape))
        for r, (names, shape) in zip(res, outs))
    return placed[0] if single else placed


def axis_group(mesh, spec_entry: Axis):
    """(the process group of a spec entry's one mesh axis, its size, this
    rank's coordinate on it), or None for an entry that shards nothing.
    An entry over several axes raises: the callers split one dimension
    over one axis."""
    if spec_entry is None:
        return None
    names = (spec_entry,) if isinstance(spec_entry, str) else spec_entry
    if len(names) != 1:
        raise NotImplementedError(f"a dimension split over {names}")
    return (mesh.get_group(names[0]), mesh.size(
        tuple(mesh.mesh_dim_names).index(names[0])),
        mesh.get_local_rank(names[0]))


def zeros(shape: Sequence[int], logical: Sequence[Optional[str]], *,
          dtype, device, like: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Zeros of ``shape``: a plain tensor, or, when ``like`` is a DTensor,
    a DTensor on its mesh placed by the spec of ``logical``, each rank
    allocating only its own part."""
    if not is_dtensor(like):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as placed_zeros

    mesh = like.device_mesh
    return placed_zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                        placements=placements_for(logical_to_spec(
                            tuple(shape), logical, mesh=mesh), mesh))


class NamedSharding:
    """A mesh and a spec, the reference's ``NamedSharding``: what
    :func:`sharding_for` returns and a placement tree holds."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Sequence[Axis]):
        self.mesh, self.spec = mesh, Spec(spec)

    def placements(self, mesh=None) -> tuple:
        """The spec's placements on ``mesh`` (default: this sharding's)."""
        return placements_for(self.spec, mesh if mesh is not None
                              else self.mesh)

    def __repr__(self):
        return f"NamedSharding(spec={self.spec})"


def sharding_for(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh=None) -> NamedSharding:
    mesh = mesh if mesh is not None else current_mesh()
    return NamedSharding(mesh, logical_to_spec(shape, logical, mesh=mesh))


# ------------------------------------------------ trees with LA leaves


def _kids(node) -> Optional[List[Any]]:
    """Children in ``repro_torch.tree``'s flatten order, None at a leaf
    (an ``LA`` or a ``Spec`` is a leaf)."""
    if isinstance(node, (LA, Spec)):
        return None
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if hasattr(node, "_fields"):
        return [getattr(node, f) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def map_la(fn: Callable, la_tree: Pytree, *rest: Pytree) -> Pytree:
    """Map ``fn(leaf, *matching)`` over the ``LA`` (or ``Spec``) leaves of
    ``la_tree``; the other trees are walked alongside and must have its
    structure (at a leaf they may hold anything: a tensor, a meta tensor,
    an int)."""
    kids = _kids(la_tree)
    if kids is None:
        return fn(la_tree, *rest)
    others = []
    for r in rest:
        rk = _kids(r)
        if rk is None or len(rk) != len(kids):
            raise ValueError(f"tree structures differ: {type(la_tree)} of "
                             f"{len(kids)} vs {type(r)}")
        others.append(rk)
    mapped = [map_la(fn, k, *(o[i] for o in others))
              for i, k in enumerate(kids)]
    if isinstance(la_tree, dict):
        return dict(zip(sorted(la_tree), mapped))
    if hasattr(la_tree, "_fields"):
        return type(la_tree)(*mapped)
    return type(la_tree)(mapped)


def spec_tree_for_params(logical_tree: Pytree, abstract_params: Pytree,
                         rules: Optional[Dict[str, Axis]] = None,
                         mesh=None) -> Pytree:
    """A tree of ``LA`` leaves and the matching tree of (meta) tensors ->
    a tree of specs, dropping non-divisible axes per leaf shape.  A leaf
    with no shape (the train state's ``step``, an int) gets ``()``."""
    return map_la(lambda names, leaf: logical_to_spec(
        tuple(getattr(leaf, "shape", ())), names.names, rules, mesh),
        logical_tree, abstract_params)


def sharding_tree_for_params(logical_tree: Pytree, abstract_params: Pytree,
                             mesh, rules: Optional[Dict[str, Axis]] = None
                             ) -> Pytree:
    specs = spec_tree_for_params(logical_tree, abstract_params, rules, mesh)
    return map_la(lambda s: NamedSharding(mesh, s), specs)
