"""Inter-pod synchronization on the pod dimension: the codec path of ASGD-GA.

Counterpart of ``repro/core/sync.py`` for the training plane's main path.
Every training-state leaf carries a leading ``pod`` dimension; the one-peer
ring send is ``torch.roll(dim=0)``.  Every ``interval`` steps an ASGD-GA
round ships the accumulated gradient to one ring peer, which applies it as a
receiver-side SGD update.  With the fused codec on
(``quantize_int8=True``, ``0 < compress_topk < 1``) the round is

  bucket -> (+ EF residual) -> top-k + quantize -> ring -> decode -> EF

where encode and decode are the CUDA kernels of ``repro_torch.kernels`` on
the card.  The round splits into :func:`prepare_codec_sync`,
:func:`ship_sync_payloads` and :func:`finish_codec_sync`, as in the
reference.

Ported so far: ``asgd`` and ``asgd_ga`` (codec and dense) with both
bucket policies (``BucketSpec.parse`` and the launcher's bucket flags
wait).  The legacy sparse-fp32 path (``compress_topk`` without the codec), ``ama``,
``sma``, ``asp``, pod resizing, retunes and the streaming and host-seam
transports are ROADMAP Queue 1 item 4 and raise ``NotImplementedError``.

Memory: at full width the f32 flat buffers are the bulk of device memory,
so the round works in place where the reference builds new arrays: it
scales the packed message in place, writes the new EF residual over the
old one, applies the receiver update to the parameters and zeroes the
gradient accumulator.  The state and parameters passed in are consumed;
the values are those of the reference's out-of-place expressions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from math import prod
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T

Pytree = Any

STRATEGIES = ("asgd", "asgd_ga", "ama", "sma", "asp")

# the codec's precision ladder, least -> most aggressive; tier 0 (fp32) is
# "codec off".  Wire bytes per kept element: int8/fp8 1+2 (u16 block-local
# index), int4 0.5+2, plus one fp32 scale per codec block
CODEC_TIERS = ("fp32", "int8", "fp8", "int4")
VALUE_DTYPES = CODEC_TIERS[1:]
_VALUE_BYTES = {"int8": 1.0, "fp8": 1.0, "int4": 0.5}

BUCKET_CLASSES = ("embed", "norm", "dense", "moe")
BUCKET_POLICIES = ("single", "layer-class")

_NOT_PORTED = ("not ported yet: see ROADMAP.md Queue 1 item 4 "
               "(core/sync.py, the rest)")


@dataclass(frozen=True)
class BucketSpec:
    """Classifies leaves into named bucket groups by parameter path (first
    matching pattern wins), then by rank: rank <= 1 per-pod tensors go to
    ``vector_bucket``, the rest to ``fallback``."""

    names: Tuple[str, ...] = BUCKET_CLASSES
    patterns: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("moe", ("moe", "expert", "router")),
        ("embed", ("embed", "emb", "vocab", "wte", "wpe", "lm_head",
                   "tok_", "token")),
        ("norm", ("norm", "ln1", "ln2", "rms", "bias", "scale")),
    )
    vector_bucket: str = "norm"
    fallback: str = "dense"

    def __post_init__(self):
        if not self.names or len(set(self.names)) != len(self.names):
            raise ValueError("bucket spec needs non-empty, unique names, "
                             f"got {self.names}")
        for name, subs in self.patterns:
            if name not in self.names:
                raise ValueError(
                    f"bucket spec pattern group {name!r} is not one of its "
                    f"names {self.names}")
            if not subs:
                raise ValueError(f"bucket spec group {name!r} has an empty "
                                 f"pattern list")
        for role, name in (("vector_bucket", self.vector_bucket),
                           ("fallback", self.fallback)):
            if name not in self.names:
                raise ValueError(
                    f"bucket spec {role} {name!r} is not one of its names "
                    f"{self.names}")

    def classify(self, path: str, inner_ndim: int) -> str:
        """Bucket name for one leaf (``inner_ndim`` excludes the pod dim)."""
        low = path.lower()
        for name, subs in self.patterns:
            if any(s in low for s in subs):
                return name
        return self.vector_bucket if inner_ndim <= 1 else self.fallback


DEFAULT_BUCKET_SPEC = BucketSpec()


@dataclass(frozen=True)
class BucketLayout:
    """Partition of one stacked tree into bucket groups, each one contiguous
    ``(n_pods, N_g)`` segment of the flat buffer."""

    names: Tuple[str, ...]
    leaf_bucket: Tuple[int, ...]    # bucket index per leaf (original order)
    leaf_sizes: Tuple[int, ...]     # per-leaf flat width (per pod)
    order: Tuple[int, ...]          # leaf indices in packing order
    sizes: Tuple[int, ...]          # per-bucket segment width N_g
    offsets: Tuple[int, ...]        # per-bucket segment start

    @property
    def leaf_offsets(self) -> Tuple[int, ...]:
        off, out = 0, [0] * len(self.order)
        for i in self.order:
            out[i] = off
            off += self.leaf_sizes[i]
        return tuple(out)


def bucket_layout(cfg: "SyncConfig", stacked_tree: Pytree,
                  spec: Optional[BucketSpec] = None) -> BucketLayout:
    """Partition ``stacked_tree`` (leading pod dim) per ``cfg.bucket_policy``
    (shape-only)."""
    spec = spec if spec is not None else cfg.bucket_spec
    flat = T.leaves_with_path(stacked_tree)
    leaf_sizes = tuple(int(prod(x.shape[1:])) for _, x in flat)
    if cfg.bucket_policy == "single":
        names = ("all",)
        leaf_bucket = (0,) * len(flat)
        order = tuple(range(len(flat)))
    else:
        names = spec.names
        leaf_bucket = tuple(names.index(spec.classify(path, x.dim() - 1))
                            for path, x in flat)
        order = tuple(sorted(range(len(flat)),
                             key=lambda i: (leaf_bucket[i], i)))
    sizes = tuple(sum(leaf_sizes[i] for i in range(len(flat))
                      if leaf_bucket[i] == g) for g in range(len(names)))
    offsets = tuple(sum(sizes[:g]) for g in range(len(names)))
    return BucketLayout(names=names, leaf_bucket=leaf_bucket,
                        leaf_sizes=leaf_sizes, order=order,
                        sizes=sizes, offsets=offsets)


def bucket_weights_of(cfg: "SyncConfig", stacked_tree: Pytree,
                      spec: Optional[BucketSpec] = None) -> Dict[str, float]:
    """Fraction of model elements per bucket group (sums to 1.0)."""
    layout = bucket_layout(cfg, stacked_tree, spec)
    total = max(1, sum(layout.sizes))
    return {n: layout.sizes[g] / total for g, n in enumerate(layout.names)}


@dataclass(frozen=True)
class BucketOverride:
    """Per-bucket codec knobs; ``None`` inherits the global value."""

    name: str
    compress_topk: Optional[float] = None
    value_dtype: Optional[str] = None
    codec_block: Optional[int] = None


@dataclass(frozen=True)
class SyncConfig:
    strategy: str = "asgd"
    interval: int = 1              # K: sync every K steps
    peer_shift: int = 1            # ring shift of the one-peer send
    compress_topk: float = 0.0     # 0/1 = dense; else fraction shipped
    ga_lr_scale: float = 1.0       # LR scale of the receiver-side update
    asp_threshold: float = 0.01
    quantize_int8: bool = False    # fused WAN codec on (value_dtype = tier)
    value_dtype: str = "int8"      # codec payload tier: int8 | fp8 | int4
    error_feedback: bool = False   # EF-SGD: re-inject the codec residual
    codec_block: int = 4096        # block-local top-k block size
    overlap_chunks: int = 1        # >1: split each bucket into chunks
    bucket_policy: str = "single"
    buckets: Tuple[BucketOverride, ...] = ()
    bucket_spec: BucketSpec = DEFAULT_BUCKET_SPEC

    def __post_init__(self):
        self._validate()

    def _validate(self) -> None:
        """Each knob gets its own precise error, as in the reference."""
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.interval < 1:
            raise ValueError("interval must be >= 1")
        if self.overlap_chunks < 1:
            raise ValueError("overlap_chunks must be >= 1")
        if self.codec_block < 128 or self.codec_block > (1 << 16):
            raise ValueError("codec_block must be in [128, 65536] (local "
                             "indices ship as u16)")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"unknown value_dtype {self.value_dtype!r}: the codec's "
                f"payload tiers are {VALUE_DTYPES} (fp32 is codec-off)")
        if self.value_dtype != "int8" and not self.quantize_int8:
            raise ValueError(
                f"value_dtype={self.value_dtype!r} is inert without the "
                f"fused codec (quantize_int8=True): the run would ship "
                f"sparse/dense fp32 while its summary claims "
                f"{self.value_dtype}")
        if self.quantize_int8:
            if self.strategy != "asgd_ga":
                raise ValueError(
                    f"the fused codec (quantize_int8=True) compresses "
                    f"shipped accumulated gradients and therefore requires "
                    f"strategy='asgd_ga', not {self.strategy!r}")
            if not 0.0 < self.compress_topk < 1.0:
                raise ValueError(
                    f"the fused codec (quantize_int8=True) needs a top-k "
                    f"fraction 0 < compress_topk < 1, got "
                    f"{self.compress_topk} — without one the run would "
                    f"train dense while its summary claims "
                    f"{self.value_dtype}/EF")
        if self.error_feedback and not self.quantize_int8:
            raise ValueError("error_feedback requires the fused codec "
                             "(quantize_int8=True): the EF residual is "
                             "defined as what encode->decode lost")
        if self.overlap_chunks > 1 and not self.uses_codec:
            raise ValueError(
                "overlap_chunks > 1 requires the fused codec "
                "(strategy='asgd_ga', 0 < compress_topk < 1, "
                "quantize_int8=True): chunk pipelining only exists on the "
                "codec path")
        if self.bucket_policy not in BUCKET_POLICIES:
            raise ValueError(
                f"unknown bucket_policy {self.bucket_policy!r}: choices are "
                f"{BUCKET_POLICIES}")
        if self.bucket_policy != "single" and not self.uses_codec:
            raise ValueError(
                "bucket_policy='layer-class' is inert without the fused "
                "codec (strategy='asgd_ga', 0 < compress_topk < 1, "
                "quantize_int8=True)")
        if self.buckets and self.bucket_policy == "single":
            raise ValueError(
                f"bucket overrides ({', '.join(o.name for o in self.buckets)}"
                f") require bucket_policy='layer-class'")
        seen = set()
        for ov in self.buckets:
            where = f"bucket {ov.name!r}: "
            if ov.name not in self.bucket_spec.names:
                raise ValueError(
                    where + f"unknown bucket group; the layer-class groups "
                    f"are {self.bucket_spec.names}")
            if ov.name in seen:
                raise ValueError(where + "duplicate override")
            seen.add(ov.name)
            if ov.compress_topk is not None and \
                    not 0.0 < ov.compress_topk < 1.0:
                raise ValueError(where + f"compress_topk must be in (0, 1), "
                                 f"got {ov.compress_topk}")
            if ov.value_dtype is not None and \
                    ov.value_dtype not in VALUE_DTYPES:
                raise ValueError(where + f"unknown value_dtype "
                                 f"{ov.value_dtype!r}")
            if ov.codec_block is not None and \
                    not 128 <= ov.codec_block <= (1 << 16):
                raise ValueError(where + f"codec_block must be in "
                                 f"[128, 65536], got {ov.codec_block}")

    # ------------------------------------------------------ bucket groups
    @property
    def bucket_names(self) -> Tuple[str, ...]:
        return (("all",) if self.bucket_policy == "single"
                else self.bucket_spec.names)

    def bucket_knobs(self, name: str) -> Tuple[float, str, int]:
        """Effective (compress_topk, value_dtype, codec_block) of a group."""
        for ov in self.buckets:
            if ov.name == name:
                return (ov.compress_topk if ov.compress_topk is not None
                        else self.compress_topk,
                        ov.value_dtype if ov.value_dtype is not None
                        else self.value_dtype,
                        ov.codec_block if ov.codec_block is not None
                        else self.codec_block)
        return self.compress_topk, self.value_dtype, self.codec_block

    def for_bucket(self, name: str) -> "SyncConfig":
        """The single-bucket config governing one group's segment."""
        frac, dtype, block = self.bucket_knobs(name)
        return _dc_replace(self, compress_topk=frac, value_dtype=dtype,
                           codec_block=block, bucket_policy="single",
                           buckets=())

    @property
    def bucket_tiers(self) -> Tuple[int, ...]:
        return tuple(self.for_bucket(n).tier for n in self.bucket_names)

    @property
    def uses_codec(self) -> bool:
        return (self.strategy == "asgd_ga" and self.quantize_int8
                and 0.0 < self.compress_topk < 1.0)

    @property
    def tier(self) -> int:
        return CODEC_TIERS.index(self.value_dtype) if self.uses_codec else 0

    def payload_mb(self, model_mb: float,
                   measured_frac: Optional[float] = None,
                   bucket_weights: Optional[Mapping[str, float]] = None
                   ) -> float:
        """Per-sync WAN payload per pod, in the reference's accounting:
        int8/fp8 cost ``0.75 * frac + 1/codec_block`` of dense fp32 and
        int4 ``0.625 * frac + 1/codec_block``."""
        if (bucket_weights is not None and self.uses_codec
                and self.bucket_policy != "single"):
            return sum(
                self.for_bucket(n).payload_mb(
                    model_mb * bucket_weights.get(n, 0.0))
                for n in self.bucket_names)
        if self.strategy == "asp":
            frac = measured_frac if measured_frac is not None else 0.3
            return model_mb * (2 * frac if frac < 1.0 else 1.0)
        if 0.0 < self.compress_topk < 1.0 and self.strategy == "asgd_ga":
            frac = self.compress_topk
            if self.quantize_int8:
                per_elem = (_VALUE_BYTES[self.value_dtype] + 2.0) / 4.0
                return model_mb * (frac * per_elem + 1.0 / self.codec_block)
            return model_mb * 2 * frac
        return model_mb


class SyncState(NamedTuple):
    ga_buffer: Pytree              # accumulated grads (ASGD-GA), pod dim
    steps_since_sync: torch.Tensor  # 0-dim int32
    significant_frac: torch.Tensor  # 0-dim f32 (ASP; 1.0 here)
    ef_residual: torch.Tensor      # (n_pods, N) f32 in bucket-grouped order
    tier: torch.Tensor             # (n_buckets,) int32 into CODEC_TIERS
    msg_norm: torch.Tensor         # (n_pods, n_buckets) L2 of the message
    resid_norm: torch.Tensor       # (n_pods, n_buckets) L2 of the residual


def init_sync_state(cfg: SyncConfig, stacked_params: Pytree) -> SyncState:
    """``stacked_params`` leaves have the leading pod dimension."""
    leaves = T.leaves(stacked_params)
    n_pods, dev = leaves[0].shape[0], leaves[0].device
    if cfg.strategy == "asgd_ga":
        buf = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=dev), stacked_params)
    elif cfg.strategy == "asgd":
        buf = T.tree_map(lambda p: torch.zeros(0, device=dev),
                         stacked_params)
    else:
        raise NotImplementedError(f"strategy {cfg.strategy!r} is "
                                  + _NOT_PORTED)
    n_ef = (sum(x.numel() for x in leaves) // n_pods
            if (cfg.uses_codec and cfg.error_feedback) else 0)
    nb = len(cfg.bucket_names)
    return SyncState(
        ga_buffer=buf,
        steps_since_sync=torch.zeros((), dtype=torch.int32, device=dev),
        significant_frac=torch.ones((), dtype=torch.float32, device=dev),
        ef_residual=torch.zeros(n_pods, n_ef, device=dev),
        tier=torch.tensor(cfg.bucket_tiers, dtype=torch.int32, device=dev),
        msg_norm=torch.zeros(n_pods, nb, device=dev),
        resid_norm=torch.zeros(n_pods, nb, device=dev))


def on_step_gradients(cfg: SyncConfig, grads: Pytree, state: SyncState
                      ) -> Tuple[Pytree, SyncState]:
    """Fresh per-pod gradients (leading pod dim) -> (gradients for the local
    optimizer update, new sync state).  ASGD-GA accumulates into the fp32
    buffer in place."""
    n_pods = T.leaves(grads)[0].shape[0]
    bump = state._replace(steps_since_sync=state.steps_since_sync + 1)
    if cfg.strategy == "asgd" and n_pods > 1:
        grads = T.tree_map(
            lambda g: g.mean(dim=0, keepdim=True).expand_as(g).contiguous(),
            grads)
        return grads, bump
    if cfg.strategy == "asgd_ga":
        T.tree_map(lambda b, g: b.add_(g.float()), state.ga_buffer, grads)
    return grads, bump


# --------------------------------------------------- bucketed WAN codec path


def _pack_stacked(tree: Pytree,
                  layout: Optional[BucketLayout] = None) -> torch.Tensor:
    """Pack a stacked tree into one contiguous (n_pods, N) f32 buffer, in
    leaf order or grouped by bucket (``layout.order``)."""
    leaves = T.leaves(tree)
    if layout is not None:
        leaves = [leaves[i] for i in layout.order]
    return torch.cat([x.reshape(x.shape[0], -1).float() for x in leaves],
                     dim=1)


def _unpack_stacked(flat: torch.Tensor, like: Pytree,
                    layout: Optional[BucketLayout] = None) -> Pytree:
    """Inverse of :func:`_pack_stacked` against a reference tree (views)."""
    leaves = T.leaves(like)
    offsets = layout.leaf_offsets if layout is not None else None
    out, off = [], 0
    for i, x in enumerate(leaves):
        size = int(prod(x.shape[1:]))
        lo = offsets[i] if offsets is not None else off
        out.append(flat[:, lo:lo + size].reshape(x.shape))
        off += size
    return T.unflatten(like, out)


def _cat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate along the flat dimension; a single part is returned as
    it is (at full width a copy would cost a whole f32 buffer)."""
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=1)


class ChunkPayload(NamedTuple):
    """One chunk's compact wire triple: quantized values (int4
    nibble-packed), u16 block-local indices, per-block fp32 scales."""

    q: torch.Tensor
    idx: torch.Tensor       # uint16 on the wire
    scales: torch.Tensor


class SyncPayloads(NamedTuple):
    """Output of :func:`prepare_codec_sync`: the dense message, its local
    reconstruction (EF), and the per-bucket wire chunks."""

    flat: torch.Tensor
    local: Optional[torch.Tensor]
    chunks: Dict[str, Tuple[ChunkPayload, ...]]


def _chunk_widths(cfg: SyncConfig, n_total: int) -> Tuple[int, ...]:
    """Per-chunk dense widths of one bucket segment, split on codec-block
    boundaries (so chunking never changes the selection)."""
    block = min(cfg.codec_block, max(1, n_total))
    nb = -(-n_total // block)
    n_chunks = max(1, min(cfg.overlap_chunks, nb))
    step = -(-nb // n_chunks) * block
    return tuple(min(step, n_total - lo) for lo in range(0, n_total, step))


def _encode_bucket(cfg: SyncConfig, flat: torch.Tensor, want_local: bool
                   ) -> Tuple[Tuple[ChunkPayload, ...],
                              Optional[torch.Tensor]]:
    """Encode one bucket segment ``(n_pods, N_g)`` into wire chunks (+ the
    local reconstruction).  Each chunk is one encode launch over all pods,
    reading the segment in place."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.wan_codec import k_per_block

    n_total = flat.shape[1]
    block = min(cfg.codec_block, max(1, n_total))
    k_block = k_per_block(block, cfg.compress_topk)
    encode, decode = kops.wan_codec_fns(block=block,
                                        value_dtype=cfg.value_dtype)
    chunks, local_parts, off = [], [], 0
    for m in _chunk_widths(cfg, n_total):
        seg = flat[:, off:off + m]
        off += m
        q, idx, scales = encode(seg, k_block)
        if want_local:
            local_parts.append(decode(q, idx, scales, m))
        chunks.append(ChunkPayload(q=q, idx=idx.to(torch.uint16),
                                   scales=scales))
    return tuple(chunks), (_cat(local_parts) if want_local else None)


def _decode_chunks(cfg: SyncConfig, chunks: Sequence[ChunkPayload],
                   widths: Sequence[int], n_total: int) -> torch.Tensor:
    """Decode a (chunk, width) list of one bucket; ``n_total`` is the width
    the bucket was encoded at (it fixes the codec block)."""
    from repro_torch.kernels import ops as kops

    block = min(cfg.codec_block, max(1, n_total))
    _, decode = kops.wan_codec_fns(block=block, value_dtype=cfg.value_dtype)
    return _cat([decode(c.q, c.idx.to(torch.int32), c.scales, m)
                 for c, m in zip(chunks, widths)])


def _decode_bucket(cfg: SyncConfig, chunks: Sequence[ChunkPayload],
                   n_total: int) -> torch.Tensor:
    return _decode_chunks(cfg, chunks, _chunk_widths(cfg, n_total), n_total)


def _roll_rows(p: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll`` over the pod dimension; u16 indices roll as their
    int16 bit pattern (PyTorch's u16 support covers copies, not every op on
    every device), which moves the same bytes."""
    if p.dtype == torch.uint16:
        return torch.roll(p.view(torch.int16), shift, dims=0).view(
            torch.uint16)
    return torch.roll(p, shift, dims=0)


class InlineRingShip:
    """The in-process transport: ring-permute each wire part over the pod
    dimension with ``torch.roll(dim=0)``."""

    in_graph = True

    def ship_bucket(self, name: str, chunks: Sequence[ChunkPayload],
                    shift: int, payload_mb: float = 0.0
                    ) -> Tuple[ChunkPayload, ...]:
        del name, payload_mb
        return tuple(ChunkPayload(*(_roll_rows(p, shift) for p in c))
                     for c in chunks)


_INLINE_RING = InlineRingShip()


def bucket_wire_mb(cfg: SyncConfig, layout: BucketLayout
                   ) -> Dict[str, float]:
    """Per-pod wire MB per non-empty bucket for one round (u16 indices,
    whatever dtype the device carries them in)."""
    return {name: cfg.for_bucket(name).payload_mb(layout.sizes[g] * 4 / 1e6)
            for g, name in enumerate(layout.names) if layout.sizes[g]}


def prepare_codec_sync(cfg: SyncConfig, state: SyncState) -> SyncPayloads:
    """Average the accumulated gradient, fold in the EF residual, pack the
    bucket-grouped buffer and encode every non-empty bucket segment."""
    denom = torch.clamp(state.steps_since_sync, min=1).float()
    layout = bucket_layout(cfg, state.ga_buffer)
    flat = _pack_stacked(state.ga_buffer, layout)
    flat.div_(denom)
    if cfg.error_feedback:
        flat.add_(state.ef_residual)
    chunks: Dict[str, Tuple[ChunkPayload, ...]] = {}
    local_parts = []
    for g, name in enumerate(layout.names):
        off, size = layout.offsets[g], layout.sizes[g]
        if size == 0:
            continue
        bchunks, local = _encode_bucket(cfg.for_bucket(name),
                                        flat[:, off:off + size],
                                        want_local=cfg.error_feedback)
        chunks[name] = bchunks
        if cfg.error_feedback:
            local_parts.append(local)
    local = None
    if cfg.error_feedback:
        local = _cat(local_parts) if local_parts else flat[:, :0]
    return SyncPayloads(flat=flat, local=local, chunks=chunks)


def ship_sync_payloads(cfg: SyncConfig,
                       chunks: Mapping[str, Tuple[ChunkPayload, ...]],
                       transport=None,
                       wire_mb: Optional[Mapping[str, float]] = None
                       ) -> Dict[str, Tuple[ChunkPayload, ...]]:
    """Ship every bucket's wire chunks to the one-peer ring.  Only the
    in-process ring (``transport=None``) is ported; billing, host-seam,
    retrying and checksumming transports are ROADMAP Queue 1 item 11."""
    if transport is not None:
        raise NotImplementedError(
            "transports other than the inline ring are not ported yet: see "
            "ROADMAP.md Queue 1 item 11")
    wire_mb = wire_mb or {}
    return {name: _INLINE_RING.ship_bucket(name, bchunks, cfg.peer_shift,
                                           wire_mb.get(name, 0.0))
            for name, bchunks in chunks.items()}


def finish_codec_sync(cfg: SyncConfig, params: Pytree, state: SyncState,
                      payloads: SyncPayloads,
                      shipped: Mapping[str, Tuple[ChunkPayload, ...]],
                      lr: float = 1.0,
                      alive: Optional[torch.Tensor] = None
                      ) -> Tuple[Pytree, SyncState]:
    """Decode the shipped chunks, apply the receiver-side SGD update and
    roll the EF residual and per-bucket telemetry into a new state.
    ``alive`` (``(n_pods,)`` 1/0) is the degraded round: see
    :func:`_finish_from_peer`."""
    layout = bucket_layout(cfg, state.ga_buffer)
    peer_parts = []
    for g, name in enumerate(layout.names):
        size = layout.sizes[g]
        if size == 0:
            peer_parts.append(payloads.flat[:, :0])
            continue
        peer_parts.append(_decode_bucket(cfg.for_bucket(name),
                                         shipped[name], size))
    peer_flat = _cat(peer_parts)
    return _finish_from_peer(cfg, params, state, payloads.flat,
                             payloads.local, peer_flat, layout, lr, alive)


def _bucket_norms(flat: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Per-pod, per-bucket L2 norms: (n_pods, n_buckets)."""
    cols = [torch.linalg.vector_norm(flat[:, off:off + size], dim=1)
            if size else flat.new_zeros(flat.shape[0])
            for off, size in zip(layout.offsets, layout.sizes)]
    return torch.stack(cols, dim=1)


def _finish_from_peer(cfg: SyncConfig, params: Pytree, state: SyncState,
                      flat: torch.Tensor, local: Optional[torch.Tensor],
                      peer_flat: torch.Tensor, layout: BucketLayout,
                      lr: float, alive: Optional[torch.Tensor]
                      ) -> Tuple[Pytree, SyncState]:
    """Alive masking, receiver SGD, EF rollover and telemetry.  A receiver
    applies the peer update iff it and its ring sender are alive; a sender
    whose message did not arrive keeps the whole message as its residual."""
    applied = delivered = None
    if alive is not None:
        alive = torch.as_tensor(alive, dtype=torch.float32,
                                device=flat.device)
        applied = alive * torch.roll(alive, cfg.peer_shift)
        delivered = alive * torch.roll(alive, -cfg.peer_shift)
        peer_flat = peer_flat * applied[:, None]
    peer = _unpack_stacked(peer_flat, state.ga_buffer, layout)
    msg_norm = _bucket_norms(flat, layout)
    new_resid, resid_norm = state.ef_residual, state.resid_norm
    if cfg.error_feedback:
        if delivered is None:
            new_resid = torch.sub(flat, local, out=state.ef_residual)
        else:
            new_resid = torch.where(delivered[:, None] > 0, flat - local,
                                    flat)
        resid_norm = _bucket_norms(new_resid, layout)
    if delivered is not None:
        msg_norm = msg_norm * delivered[:, None]
        resid_norm = resid_norm * delivered[:, None]
    params = _receiver_update(cfg, params, peer, lr)
    T.tree_map(lambda b: b.zero_(), state.ga_buffer)
    dev = flat.device
    return params, state._replace(
        steps_since_sync=torch.zeros((), dtype=torch.int32, device=dev),
        ef_residual=new_resid,
        tier=torch.tensor(cfg.bucket_tiers, dtype=torch.int32, device=dev),
        msg_norm=msg_norm, resid_norm=resid_norm)


def _receiver_update(cfg: SyncConfig, params: Pytree, peer: Pytree,
                     lr: float) -> Pytree:
    """``p - lr * ga_lr_scale * g`` in f32, cast back to the param dtype,
    written into the parameters in place."""
    dev = T.leaves(params)[0].device
    scale = torch.tensor(lr, dtype=torch.float32, device=dev) \
        * cfg.ga_lr_scale
    return T.tree_map(lambda p, g: p.copy_(p.float() - scale * g),
                      params, peer)


def apply_sync(cfg: SyncConfig, params: Pytree, state: SyncState,
               lr: float = 1.0, transport=None
               ) -> Tuple[Pytree, SyncState]:
    """One inter-pod synchronization round (paper §III.C steps 3-5)."""
    n_pods = T.leaves(params)[0].shape[0]
    dev = T.leaves(params)[0].device
    zero = state._replace(
        steps_since_sync=torch.zeros((), dtype=torch.int32, device=dev))
    if n_pods <= 1 or cfg.strategy == "asgd":
        return params, zero
    if cfg.strategy != "asgd_ga":
        raise NotImplementedError(f"strategy {cfg.strategy!r} is "
                                  + _NOT_PORTED)
    if cfg.uses_codec:
        payloads = prepare_codec_sync(cfg, state)
        wire = bucket_wire_mb(cfg, bucket_layout(cfg, state.ga_buffer))
        shipped = ship_sync_payloads(cfg, payloads.chunks, transport, wire)
        return finish_codec_sync(cfg, params, state, payloads, shipped, lr)
    if 0.0 < cfg.compress_topk < 1.0:
        raise NotImplementedError("sparse fp32 shipping without the codec "
                                  "is " + _NOT_PORTED)
    denom = torch.clamp(state.steps_since_sync, min=1).float()
    peer = T.tree_map(lambda b: torch.roll(b / denom, cfg.peer_shift, dims=0),
                      state.ga_buffer)
    params = _receiver_update(cfg, params, peer, lr)
    T.tree_map(lambda b: b.zero_(), state.ga_buffer)
    return params, zero._replace(
        tier=torch.tensor(cfg.bucket_tiers, dtype=torch.int32, device=dev))


def is_sync_step(cfg: SyncConfig, step: int) -> bool:
    """Host-loop predicate: run ``apply_sync`` after this step?"""
    if cfg.strategy == "asgd":
        return False
    return (step + 1) % cfg.interval == 0


def traffic_per_step_mb(cfg: SyncConfig, model_mb: float,
                        bucket_weights: Optional[Mapping[str, float]] = None
                        ) -> float:
    """Average inter-pod WAN traffic per training step per pod."""
    if cfg.strategy == "asgd":
        return model_mb
    return cfg.payload_mb(model_mb, bucket_weights=bucket_weights) \
        / cfg.interval
