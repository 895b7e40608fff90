"""Inter-pod synchronization on the pod dimension: the paper's strategies.

Counterpart of ``repro/core/sync.py``.  Every training-state leaf carries a
leading ``pod`` dimension; the one-peer ring send is ``torch.roll(dim=0)``.
The strategies (paper §III.C) are those of the reference:

- ``asgd``: the per-step cross-pod gradient mean (the baseline);
- ``asgd_ga``: every ``interval`` steps one pod ships its accumulated
  gradient to its ring peer, which applies it as a receiver-side SGD
  update; with the fused codec on (``quantize_int8=True``, ``0 <
  compress_topk < 1``) the round is

    bucket -> (+ EF residual) -> top-k + quantize -> ring -> decode -> EF

  split into :func:`prepare_codec_sync`, :func:`ship_sync_payloads` and
  :func:`finish_codec_sync`, as in the reference;
- ``ama``: inter-PS model averaging with the ring peer;
- ``sma``: the barrier mean over all pods;
- ``asp``: Gaia's significance-gated parameter deltas (the baseline).

Without the codec, ``0 < compress_topk < 1`` ships every leaf sparse
through :func:`_ship_ring`: block top-k per chunk of ``CHUNK`` values (the
CUDA kernel of ``kernels/csrc/topk_compress.cu`` on the card), roll,
decompress.  The pod-count transforms (:func:`grow_pods`,
:func:`shrink_pods`, :func:`resize_sync_state`) and the codec retune
(:func:`retune_sync_state`) carry the state across reconfigurations.  The
streaming re-encode (``reencode_unsent``, ``finish_codec_sync_split``) and
the transports other than the inline ring are ROADMAP Queue 1 item 11.

Memory: at full width the f32 buffers are the bulk of device memory, so a
round works in place where the reference builds new arrays, and leaf by
leaf where the reference maps a whole tree: it scales the packed message
in place, writes the new EF residual over the old one, applies the
receiver update to the parameters, zeroes the gradient accumulator and
overwrites ASP's reference buffer.  The state and parameters passed in are
consumed; the values are those of the reference's out-of-place
expressions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from math import gcd, prod
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

# keep per-selection index spaces below int32: the legacy sparse path
# ships each leaf in chunks of this many values
CHUNK = 1 << 26


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

    @classmethod
    def parse(cls, spec: str) -> "BucketSpec":
        """Build a spec from the launcher's ``--bucket-patterns`` string.

        Named presets: ``default`` (the four-class table) and
        ``moe-router`` (:data:`MOE_ROUTER_BUCKET_SPEC` — routers split out
        of the expert group).  Otherwise, semicolon-separated
        ``name=sub1|sub2`` pattern groups in precedence order, plus the
        optional directives ``vector=name`` / ``fallback=name`` (defaults:
        ``norm`` / ``dense`` if those names exist, else the last group /
        the first pattern-less group)::

            router=router;moe=moe|expert;embed=embed|vocab;norm=norm|bias;dense=

        Groups may be declared pattern-less (``dense=``) just to exist as
        a fallback target."""
        key = spec.strip().lower()
        if key in ("", "default"):
            return DEFAULT_BUCKET_SPEC
        if key == "moe-router":
            return MOE_ROUTER_BUCKET_SPEC
        names: list = []
        patterns: list = []
        vector = fallback = None
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, eq, subs = entry.partition("=")
            name = name.strip()
            if not eq:
                raise ValueError(
                    f"--bucket-patterns entry {entry!r} is not "
                    f"'name=sub1|sub2' (or 'vector=name'/'fallback=name')")
            if name == "vector":
                vector = subs.strip()
                continue
            if name == "fallback":
                fallback = subs.strip()
                continue
            if name not in names:
                names.append(name)
            pats = tuple(s.strip().lower() for s in subs.split("|")
                         if s.strip())
            if pats:
                patterns.append((name, pats))
        if not names:
            raise ValueError(f"--bucket-patterns {spec!r} defines no bucket "
                             f"groups")
        for role, target in (("vector", vector), ("fallback", fallback)):
            if target is not None and target not in names:
                # refusing (not creating) catches a typoed group name —
                # a phantom group would silently swallow every fallthrough
                # leaf while the declared group stays empty
                raise ValueError(
                    f"--bucket-patterns {role}={target!r} names an "
                    f"undeclared bucket group (declared: {tuple(names)}); "
                    f"declare it, e.g. '{target}='")
        vector = vector or ("norm" if "norm" in names else names[-1])
        # fallback default: 'dense' if declared, else the first
        # pattern-LESS group (declaring 'name=' with no patterns is the
        # documented way to create a catch-all), else the last group —
        # NEVER the first: groups are listed most-specific-first, and a
        # fallback into the most specific group would silently give every
        # unmatched dense matrix e.g. router-grade treatment
        if fallback is None:
            pattern_names = {n for n, _ in patterns}
            patternless = [n for n in names if n not in pattern_names]
            fallback = ("dense" if "dense" in names
                        else (patternless[0] if patternless else names[-1]))
        return cls(names=tuple(names), patterns=tuple(patterns),
                   vector_bucket=vector, fallback=fallback)


DEFAULT_BUCKET_SPEC = BucketSpec()

# the MoE recipe's spec: routers in their OWN group instead of riding the
# expert group.  Router gradients are dense and convergence-critical (they
# steer token routing; quantization error there mis-routes tokens), while
# expert blocks see token-routed sparsity that tolerates aggressive top-k —
# one (top-k, dtype) rung cannot serve both, which is why this table exists.
# Precedence: router patterns FIRST, so ``moe/router`` no longer falls to
# the ``moe`` group's broader patterns.
MOE_ROUTER_BUCKET_SPEC = BucketSpec(
    names=("embed", "norm", "dense", "moe", "router"),
    patterns=(
        ("router", ("router", "gating")),
        ("moe", ("moe", "expert")),
        ("embed", ("embed", "emb", "vocab", "wte", "wpe", "lm_head",
                   "tok_", "token")),
        ("norm", ("norm", "ln1", "ln2", "rms", "bias", "scale")),
    ))


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
    ga_buffer: Pytree              # accumulated grads (ASGD-GA) or the
    #                                reference params at the last sync (ASP)
    steps_since_sync: torch.Tensor  # 0-dim int32
    significant_frac: torch.Tensor  # 0-dim f32: ASP's shipped fraction
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
    elif cfg.strategy == "asp":
        # a copy, also of f32 params: the round updates params in place
        buf = T.tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                         stacked_params)
    else:
        buf = T.tree_map(lambda p: torch.zeros(0, device=dev),
                         stacked_params)
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


def bucket_chunk_mb(cfg: SyncConfig, layout: BucketLayout
                    ) -> Dict[str, Tuple[float, ...]]:
    """Per-chunk wire MB of each non-empty bucket (host-side, static): the
    streaming ship's chunk schedule, summing to :func:`bucket_wire_mb`'s
    entry up to float association."""
    out: Dict[str, Tuple[float, ...]] = {}
    for g, name in enumerate(layout.names):
        size = layout.sizes[g]
        if size == 0:
            continue
        bcfg = cfg.for_bucket(name)
        out[name] = tuple(bcfg.payload_mb(m * 4 / 1e6)
                          for m in _chunk_widths(bcfg, size))
    return out


def _ship_leaf(cfg: SyncConfig, x: torch.Tensor) -> torch.Tensor:
    """One leaf's one-peer ring send; sparse when ``0 < compress_topk < 1``:
    per pod, chunks of ``CHUNK`` values (the last zero-padded), each
    compressed to its block top-k (one kernel launch for the leaf on the
    card), rolled, decompressed and cropped back to the leaf."""
    if not 0.0 < cfg.compress_topk < 1.0:
        return torch.roll(x, cfg.peer_shift, dims=0)
    from repro_torch.kernels import ops as kops

    n_pods = x.shape[0]
    numel = int(prod(x.shape[1:]))
    chunk = min(CHUNK, numel)
    k = max(1, int(chunk * cfg.compress_topk))
    vals, idx = kops.topk_compress_chunked(x.reshape(n_pods, numel), chunk,
                                           k)
    vals = torch.roll(vals, cfg.peer_shift, dims=0)
    idx = torch.roll(idx, cfg.peer_shift, dims=0)
    dense = kops.topk_decompress(vals, idx, chunk).reshape(n_pods, -1)
    if dense.shape[1] != numel:
        dense = dense[:, :numel]
    return dense.reshape(x.shape)


def _ship_ring(cfg: SyncConfig, tree: Pytree) -> Pytree:
    """One-peer ring send of a stacked tree: roll along the pod dim, or the
    sparse top-k send of :func:`_ship_leaf`."""
    return T.tree_map(lambda x: _ship_leaf(cfg, x), tree)


def apply_sync(cfg: SyncConfig, params: Pytree, state: SyncState,
               lr: float = 1.0, transport=None
               ) -> Tuple[Pytree, SyncState]:
    """One inter-pod synchronization round (paper §III.C steps 3-5).

    ``params`` leaves have the leading pod dim and are updated in place.
    ``lr`` drives the receiver-side SGD update of ASGD-GA.  On the codec
    path the round is the three stages of the reference; only the inline
    ring ships (``transport=None``)."""
    n_pods = T.leaves(params)[0].shape[0]
    dev = T.leaves(params)[0].device
    zero = state._replace(
        steps_since_sync=torch.zeros((), dtype=torch.int32, device=dev))
    if n_pods <= 1 or cfg.strategy == "asgd":
        return params, zero
    f32 = torch.float32

    if cfg.strategy == "asgd_ga":
        if cfg.uses_codec:
            payloads = prepare_codec_sync(cfg, state)
            wire = bucket_wire_mb(cfg, bucket_layout(cfg, state.ga_buffer))
            shipped = ship_sync_payloads(cfg, payloads.chunks, transport,
                                         wire)
            return finish_codec_sync(cfg, params, state, payloads, shipped,
                                     lr)
        denom = torch.clamp(state.steps_since_sync, min=1).float()
        scale = torch.tensor(lr, dtype=f32, device=dev) * cfg.ga_lr_scale

        def ga_update(p, b):
            g = _ship_leaf(cfg, b / denom)
            p.copy_(p.float() - scale * g)
            b.zero_()
        T.tree_map(ga_update, params, state.ga_buffer)
        return params, zero._replace(
            tier=torch.tensor(cfg.bucket_tiers, dtype=torch.int32,
                              device=dev))

    if cfg.strategy == "asp":
        # Gaia-style approximate synchronous parallel: ship only the
        # parameter deltas since the last sync whose magnitude exceeds the
        # threshold relative to the reference; the rest keep accumulating
        # in the params themselves
        eps = 1e-8
        n_sig = torch.zeros((), dtype=torch.int64, device=dev)
        n_tot = 0

        def asp_update(p, r):
            nonlocal n_sig, n_tot
            delta = p.float() - r
            sig = delta.abs() > cfg.asp_threshold * (r.abs() + eps)
            n_sig = n_sig + sig.sum()
            n_tot += sig.numel()
            q = _ship_leaf(cfg, torch.where(sig, delta, 0.0))
            p.copy_(p.float() + 0.5 * q)
            r.copy_(p)
        T.tree_map(asp_update, params, state.ga_buffer)
        frac = n_sig.to(f32) / n_tot
        return params, zero._replace(significant_frac=frac)

    if cfg.strategy == "ama":
        # each leaf's peer copy is taken before that leaf is averaged; the
        # leaves are independent, so leaf by leaf equals the whole tree
        T.tree_map(lambda p: p.copy_((p.float() + _ship_leaf(cfg, p).float())
                                     * 0.5), params)
        return params, zero

    # sma: barrier global average
    T.tree_map(lambda p: p.copy_(p.float().mean(dim=0, keepdim=True)
                                 .expand(p.shape)), params)
    return params, zero


def hierarchical_average(tree: Pytree, groups: Sequence[Sequence[int]],
                         inter: str = "ama", shift: int = 1) -> Pytree:
    """Two-level averaging (paper §III.C's inter-PS model averaging across
    regions): a barrier mean within each group of pods, then the group
    means either gossip one ring step (``inter="ama"``) or take their
    global mean (``"sma"``), broadcast back to every member.  All-singleton
    groups in pod order recover flat ``ama`` and one group flat ``sma``.
    Returns a new tree."""
    groups = tuple(tuple(int(i) for i in g) for g in groups)
    if not groups or any(not g for g in groups):
        raise ValueError("groups must be non-empty and cover every pod")
    members = [i for g in groups for i in g]
    leaves = T.leaves(tree)
    if not leaves:
        return tree
    n_pods = leaves[0].shape[0]
    if sorted(members) != list(range(n_pods)):
        raise ValueError(f"groups {groups} do not partition pods "
                         f"0..{n_pods - 1}")
    n_groups = len(groups)
    if inter not in ("ama", "sma"):
        raise ValueError(f"inter level must be 'ama' or 'sma', got {inter!r}")
    if inter == "ama" and n_groups > 1 and gcd(shift, n_groups) != 1:
        raise ValueError(f"inter-ring shift {shift} must be coprime with "
                         f"the number of regions {n_groups}")
    assign = [0] * n_pods
    for gi, g in enumerate(groups):
        for i in g:
            assign[i] = gi

    def avg(p):
        dev = p.device
        x = p.float()
        m = torch.stack([x.index_select(0, torch.tensor(g, device=dev))
                         .mean(dim=0) for g in groups])
        if inter == "ama":
            m = (m + torch.roll(m, shift, dims=0)) * 0.5
        else:
            m = m.mean(dim=0, keepdim=True).expand(m.shape)
        return m.index_select(0, torch.tensor(assign, device=dev)).to(
            p.dtype)

    return T.tree_map(avg, tree)


# ------------------------------------------- pod-count-changing transforms
#
# A reconfiguration (cloud joined / left) resizes every leaf's leading pod
# dimension at a sync barrier.  Parameter-like leaves ("mean") keep the
# global mean: joiners are seeded with it, and on shrink the survivors are
# shifted so their mean equals the old one.  Accumulator-like leaves ("sum",
# the ASGD-GA buffer and the EF residual) keep the total: joiners start at
# zero, and the departed pods' values are spread evenly over the survivors.


def grow_pods(tree: Pytree, n_new: int, how: str = "mean") -> Pytree:
    """Grow the leading pod dimension to ``n_new`` (>= current): "mean"
    appends the mean replica, "clone" copies of pod 0, "zeros" zero pods.
    Leaves without the pod dimension pass through."""
    leaves = T.leaves(tree)
    if not leaves:
        return tree
    n_old = leaves[0].shape[0]
    if n_new < n_old:
        raise ValueError(f"grow_pods: {n_new} < current {n_old}")
    if n_new == n_old:
        return tree
    k = n_new - n_old

    def grow(x):
        if x.dim() == 0 or x.shape[0] != n_old:
            return x
        shape = (k,) + tuple(x.shape[1:])
        if how == "mean":
            fill = x.float().mean(dim=0, keepdim=True).expand(shape).to(
                x.dtype)
        elif how == "clone":
            fill = x[:1].expand(shape)
        elif how == "zeros":
            fill = x.new_zeros(shape)
        else:
            raise ValueError(f"grow_pods: unknown how={how!r}")
        return torch.cat([x, fill], dim=0)

    return T.tree_map(grow, tree)


def shrink_pods(tree: Pytree, keep: Sequence[int], how: str = "mean"
                ) -> Pytree:
    """Shrink the leading pod dimension to the pods in ``keep`` (ordered):
    "mean" shifts the survivors so their mean equals the old global mean,
    "sum" spreads the removed pods' values evenly over the survivors,
    "drop" discards them."""
    keep = tuple(int(i) for i in keep)
    if not keep:
        raise ValueError("shrink_pods: keep must be non-empty")
    leaves = T.leaves(tree)
    if not leaves:
        return tree
    n_old = leaves[0].shape[0]
    if any(i < 0 or i >= n_old for i in keep):
        raise ValueError(f"shrink_pods: keep {keep} out of range for {n_old}")
    if len(set(keep)) != len(keep):
        raise ValueError("shrink_pods: duplicate indices in keep")
    removed = tuple(i for i in range(n_old) if i not in keep)

    def shrink(x):
        if x.dim() == 0 or x.shape[0] != n_old:
            return x
        kept = x.index_select(0, torch.tensor(keep, device=x.device))
        if how == "drop" or not removed:
            return kept
        xf, kf = x.float(), kept.float()
        if how == "mean":
            shift = (xf.mean(dim=0, keepdim=True)
                     - kf.mean(dim=0, keepdim=True))
            return (kf + shift).to(x.dtype)
        if how == "sum":
            lost = xf.index_select(0, torch.tensor(
                removed, device=x.device)).sum(dim=0, keepdim=True)
            return (kf + lost / len(keep)).to(x.dtype)
        raise ValueError(f"shrink_pods: unknown how={how!r}")

    return T.tree_map(shrink, tree)


def resize_sync_state(cfg: SyncConfig, state: SyncState, new_params: Pytree,
                      keep: Optional[Sequence[int]] = None) -> SyncState:
    """Carry ``SyncState`` across a pod-count change (``new_params`` are
    the resized stacked params).  ASGD-GA replay-accumulates the departed
    pods' buffer and EF residual into the survivors and zero-seeds
    joiners; ASP restarts its reference from the new params; the
    bufferless strategies re-init.  The step count, ASP's fraction and the
    tiers survive; the per-bucket norms re-arm at zero."""
    n_new = T.leaves(new_params)[0].shape[0]
    dev = T.leaves(new_params)[0].device
    if cfg.strategy == "asgd_ga":
        buf = state.ga_buffer
        n_old = T.leaves(buf)[0].shape[0] if T.leaves(buf) else 0
        resid = state.ef_residual
        if keep is not None and len(keep) < n_old:
            buf = shrink_pods(buf, keep, how="sum")
            resid = shrink_pods([resid], keep, how="sum")[0]
            n_old = len(keep)
        if n_new > n_old:
            buf = grow_pods(buf, n_new, how="zeros")
            resid = grow_pods([resid], n_new, how="zeros")[0]
        nb = len(cfg.bucket_names)
        return state._replace(
            ga_buffer=buf, ef_residual=resid,
            msg_norm=torch.zeros(n_new, nb, device=dev),
            resid_norm=torch.zeros(n_new, nb, device=dev))
    fresh = init_sync_state(cfg, new_params)
    return fresh._replace(steps_since_sync=state.steps_since_sync,
                          significant_frac=state.significant_frac,
                          tier=state.tier)


def retune_sync_state(new_cfg: SyncConfig, old_cfg: SyncConfig,
                      state: SyncState, stacked_params: Pytree) -> SyncState:
    """Carry ``SyncState`` across a codec retune (same strategy and pod
    count; another tier, top-k or interval).  The EF residual lives in
    dense bucket coordinates, so it carries over; a bucket-policy change
    re-permutes it leaf by leaf into the new grouping; it is dropped when
    EF turns off and zero-seeded when EF turns on.  Per-bucket norms re-arm
    at zero when the number of buckets changes."""
    if new_cfg.strategy != old_cfg.strategy:
        raise ValueError(
            f"retune cannot change strategy ({old_cfg.strategy!r} -> "
            f"{new_cfg.strategy!r}); that is a reconfiguration "
            f"(resize_sync_state / Trainer.reconfigure)")
    leaves = T.leaves(stacked_params)
    n_pods, dev = leaves[0].shape[0], leaves[0].device
    want_ef = new_cfg.uses_codec and new_cfg.error_feedback
    had_ef = state.ef_residual.shape[1] > 0
    if want_ef and not had_ef:
        n = sum(x.numel() for x in leaves) // n_pods
        resid = torch.zeros(n_pods, n, device=dev)
    elif not want_ef:
        resid = torch.zeros(n_pods, 0, device=dev)
    else:
        resid = state.ef_residual
        old_layout = bucket_layout(old_cfg, stacked_params)
        new_layout = bucket_layout(new_cfg, stacked_params)
        if old_layout.order != new_layout.order:
            old_off = old_layout.leaf_offsets
            resid = torch.cat(
                [resid[:, old_off[i]:old_off[i] + old_layout.leaf_sizes[i]]
                 for i in new_layout.order], dim=1)
    nb_new, nb_old = len(new_cfg.bucket_names), len(old_cfg.bucket_names)
    msg_norm, resid_norm = state.msg_norm, state.resid_norm
    if nb_new != nb_old:
        msg_norm = torch.zeros(n_pods, nb_new, device=dev)
        resid_norm = torch.zeros(n_pods, nb_new, device=dev)
    return state._replace(
        ef_residual=resid,
        tier=torch.tensor(new_cfg.bucket_tiers, dtype=torch.int32,
                          device=dev),
        msg_norm=msg_norm, resid_norm=resid_norm)


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


def migration_wire_mb(stacked_params: Pytree, n_new: int) -> float:
    """WAN MB a live pod migration stages in the background: one full fp32
    per-pod replica for each pod that joins or leaves."""
    leaves = T.leaves(stacked_params)
    n_old = leaves[0].shape[0]
    per_pod_mb = sum(x.numel() * 4 for x in leaves) / n_old / 1e6
    return per_pod_mb * abs(n_new - n_old)
