"""Serving plane: prefill + cached decode, continuous batching on top.

Counterpart of ``repro/serving/engine.py``, three layers, bottom to top:

- :class:`ServingEngine`: prefill + decode primitives over the model's
  decode cache (full KV for global attention positions, a ring buffer for
  windowed ones, an O(1) recurrent state and conv ring for SSM positions).
- :class:`ContinuousEngine`: a fixed **slot pool** over one decode cache
  whose batch axis is the pool.  Each request is prefilled *solo* at its
  true length (on the card, every attention layer of that prefill runs the
  flash kernel under ``attention_impl="pallas"`` and every SSM layer the
  SSD kernel), every leaf of its cache (K/V, or SSM state and conv ring)
  is copied in place into a free slot's row, and one ``decode_step`` call
  with the ``(n_slots,)`` position vector advances every slot at its own
  position (the reference ``vmap``s a single-sequence step over slots;
  here the batch dimension is written out; under M-RoPE the vector
  becomes ``(3, n_slots, 1)``, every component the slot's position; SSM
  positions need no position; an MoE position routes each slot's token
  alone, with the capacity of one token, as the reference's per-slot
  ``vmap`` does).  Each
  row reads only its own cache row and position, so a slot's tokens are
  bit-identical whether or not another slot was inserted or evicted
  mid-flight.
- :class:`ContinuousScheduler` / :class:`BatchScheduler`: request-level
  scheduling, host-side logic copied from the reference: at most one
  prefill-insert between decode steps, or run-to-completion groups.

Host syncs are the reference's: one ``int(argmax)`` per insert and one
copy of the next tokens to the host per pool step.  The engine records the
host-clock seconds of each insert (prefill included) and each pool step
(``prefill_seconds``, ``step_seconds``); both end in those syncs.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import Arch
from repro_torch.models.registry import get_model_fns

Tree = Any


def _device_of(params: Tree) -> torch.device:
    return params["embed"]["tokens"].device


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_new)
    steps: int
    prefill_len: int


class ServingEngine:
    """Prefill + decode of one batch of equal-length prompts.

    An encoder-decoder model (``arch.module == "encdec"``) takes the
    reference's ``audio_emb`` extra: as in the reference, it goes into
    ``encdec.init_cache`` as the encoder output (whose cross K/V each
    decoder block projects once), and the prompt is fed token by token
    through ``decode_step`` (teacher forcing); the model has no one-shot
    prefill.  A model with vision placeholders (qwen2-vl) takes the
    reference's ``patch_emb`` extra ``(B, Np, D)``, which its prefill
    writes over the first ``Np`` embeddings."""

    def __init__(self, arch: Arch, params: Tree, *, cache_len: int = 1024,
                 use_smoke: bool = False):
        self.arch = arch
        self.cfg = arch.smoke if use_smoke else arch.config
        self.fns = get_model_fns(arch.module)
        self.params = params
        self.cache_len = cache_len
        self.device = _device_of(params)

    @torch.no_grad()
    def prefill(self, tokens, **extras) -> Tuple[torch.Tensor, Tree]:
        """tokens: (B, S) prompt. Returns (last-token logits, cache)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                 device=self.device)
        if self.arch.module == "encdec":
            from repro_torch.models import encdec

            enc = torch.as_tensor(extras["audio_emb"], device=self.device
                                  ).to(self.cfg.dtype("compute"))
            cache = encdec.init_cache(self.cfg, tokens.shape[0],
                                      self.cache_len, enc=enc,
                                      params=self.params)
            logits = None
            for i in range(tokens.shape[1]):   # teacher-forced prompt feed
                logits, cache = self.fns.decode_step(
                    self.params, self.cfg, tokens[:, i:i + 1], cache, i)
            return logits[:, 0], cache
        patch_emb = extras.get("patch_emb")
        if patch_emb is not None:
            patch_emb = torch.as_tensor(patch_emb, device=self.device)
        return self.fns.prefill(self.params, self.cfg, tokens,
                                self.cache_len, patch_emb=patch_emb)

    @torch.no_grad()
    def generate(self, prompt, n_new: int, *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None, **extras
                 ) -> GenerationResult:
        """Greedy (``temperature <= 0``) or sampled generation; sampling
        draws from ``generator`` (a ``torch.Generator`` on the engine's
        device; the reference takes a JAX key).  ``extras`` go to
        :meth:`prefill` (``audio_emb`` for an encoder-decoder model,
        ``patch_emb`` for a vision one)."""
        B, S = np.shape(prompt)
        logits, cache = self.prefill(prompt, **extras)
        pos = S
        out = []
        tok = self._sample(logits, temperature, generator)
        for _ in range(n_new):
            out.append(tok.cpu().numpy())
            logits, cache = self.fns.decode_step(self.params, self.cfg, tok,
                                                 cache, pos)
            pos += 1
            tok = self._sample(logits[:, 0], temperature, generator)
        return GenerationResult(tokens=np.concatenate(out, axis=1),
                                steps=n_new, prefill_len=S)

    def _sample(self, logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        logits = logits[:, : self.cfg.vocab_size]   # strip padded vocab
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator
                                 ).to(torch.int32)


# ---------------------------------------------------------------------------
# continuous batching: slot pool + per-slot decode
# ---------------------------------------------------------------------------


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,)
    max_new: int
    done: bool = False
    output: Optional[np.ndarray] = None


@dataclass
class FinishedRequest:
    """One completed generation leaving the slot pool."""

    rid: int
    tokens: np.ndarray           # (n,) generated tokens (eos included)
    reason: str                  # "max_new" | "eos"
    slot: int


@dataclass
class _Slot:
    """Host-side bookkeeping of one live slot (the cache row is the
    device-side half)."""

    rid: int
    max_new: int
    tokens: List[int] = field(default_factory=list)   # emitted so far


class ContinuousEngine:
    """Fixed slot pool with per-slot insert / evict over one decode cache.

    The cache (KV for attention positions, state and conv ring for SSM
    positions) is allocated once with batch axis ``n_slots``; a request
    occupies exactly one slot from insert to evict.  A prompt the model
    cannot prefill (for the SSM family, a length above the SSD chunk that
    is not a multiple of it, as in the reference) raises ``ValueError``
    from ``insert`` and leaves every slot as it was.  One decode step is one
    ``decode_step`` over the pool with each slot's own position, so mixed
    prompt lengths coexist without padding.

    Invariants (tested): insert never clobbers a live slot (inserting into
    an occupied slot or a full pool raises); evict frees exactly one slot;
    a slot's decoded tokens are bit-identical whether or not a concurrent
    prefill-insert happened in another slot.

    Decoding is greedy (the deterministic mode every parity test and the
    router replay rely on); sampling stays on :class:`ServingEngine`.
    """

    def __init__(self, arch: Optional[Arch], params: Tree, *,
                 n_slots: int = 4, cache_len: int = 1024,
                 use_smoke: bool = False, eos_id: Optional[int] = None,
                 cfg=None, module: Optional[str] = None):
        module = module if module is not None else arch.module
        if get_model_fns(module).prefill is None:
            raise ValueError(
                f"module {module!r} has no one-shot prefill; the slot "
                f"pool needs prefill -> insert (serve it with ServingEngine)")
        self.arch = arch
        self.module = module
        self.cfg = cfg if cfg is not None else (
            arch.smoke if use_smoke else arch.config)
        self.fns = get_model_fns(module)
        self.params = params
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.eos_id = eos_id
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.device = _device_of(params)
        self._pool = self.fns.init_cache(self.cfg, self.n_slots,
                                         self.cache_len, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._pos = np.zeros(self.n_slots, np.int32)
        self._tok = np.zeros((self.n_slots, 1), np.int32)
        self._finished: List[FinishedRequest] = []
        self.decode_steps = 0
        self.prefill_seconds: List[float] = []
        self.step_seconds: List[float] = []

    # ---------------------------------------------------------- occupancy
    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- insert
    @torch.no_grad()
    def insert(self, prompt: np.ndarray, max_new: int, *, rid: int = 0,
               slot: Optional[int] = None) -> int:
        """Prefill ``prompt`` solo and copy its cache into a free slot.

        Raises when the pool is full or the requested ``slot`` is live:
        inserting never clobbers in-flight state."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt.size + max_new > self.cache_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"cache_len ({self.cache_len})")
        if slot is None:
            free = self.free_slots
            if not free:
                raise RuntimeError("no free slot: evict (or wait for a "
                                   "finish) before inserting")
            slot = free[0]
        elif self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} is live (rid "
                               f"{self.slots[slot].rid}); insert refuses "
                               f"to clobber it")

        t0 = time.perf_counter()
        logits, cache = self.fns.prefill(
            self.params, self.cfg, self._to_device(prompt)[None],
            self.cache_len)
        for key, one in cache.items():
            for pool_leaf, leaf in zip(self._pool[key], one):
                pool_leaf[:, slot].copy_(leaf[:, 0])
        first = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        self.prefill_seconds.append(time.perf_counter() - t0)
        st = _Slot(rid=rid, max_new=int(max_new), tokens=[first])
        self.slots[slot] = st
        self._pos[slot] = prompt.size
        self._tok[slot, 0] = first
        self._maybe_finish(slot)
        return slot

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def step(self) -> List[FinishedRequest]:
        """One batched decode step across the whole pool.

        Every live slot advances one token at its own position (free slots
        compute a throwaway row into their own, unused cache row).  Slots
        reaching ``max_new`` or ``eos_id`` are evicted and returned (plus
        any insert-time finishes pending)."""
        if not self.live_slots:
            return self.take_finished()
        t0 = time.perf_counter()
        logits, self._pool = self.fns.decode_step(
            self.params, self.cfg, self._to_device(self._tok), self._pool,
            self._to_device(self._pos), moe_per_row=True)
        nxt = torch.argmax(logits[:, 0, : self.cfg.vocab_size], dim=-1)
        nxt = nxt.to(torch.int32).cpu().numpy()
        self.step_seconds.append(time.perf_counter() - t0)
        self.decode_steps += 1
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            tok = int(nxt[i])
            st.tokens.append(tok)
            self._pos[i] += 1
            self._tok[i, 0] = tok
            self._maybe_finish(i)
        return self.take_finished()

    def _maybe_finish(self, slot: int) -> None:
        st = self.slots[slot]
        if self.eos_id is not None and st.tokens[-1] == self.eos_id:
            reason = "eos"
        elif len(st.tokens) >= st.max_new:
            reason = "max_new"
        else:
            return
        self._finished.append(FinishedRequest(
            rid=st.rid, tokens=np.asarray(st.tokens, np.int32),
            reason=reason, slot=slot))
        self.evict(slot)

    def take_finished(self) -> List[FinishedRequest]:
        out, self._finished = self._finished, []
        return out

    # -------------------------------------------------------------- evict
    def evict(self, slot: int) -> None:
        """Free exactly one slot (the cache row is left in place: the next
        insert overwrites it wholesale)."""
        if self.slots[slot] is None:
            raise RuntimeError(f"slot {slot} is already free")
        self.slots[slot] = None
        self._pos[slot] = 0
        self._tok[slot, 0] = 0


# ---------------------------------------------------------------------------
# request-level scheduling
# ---------------------------------------------------------------------------


class ContinuousScheduler:
    """Continuous-batching front: decoupled prefill and decode queues.

    ``submit`` enqueues onto the *prefill* queue; the run loop admits at
    most one prefill-insert per decode step.  ``history`` records the
    interleaving (``("prefill", rid, slot)`` / ``("decode", n_live)`` /
    ``("finish", rid, reason)``)."""

    def __init__(self, engine: ContinuousEngine):
        self.engine = engine
        self.queue: deque[Request] = deque()
        self.results: Dict[int, np.ndarray] = {}
        self.history: List[Tuple] = []
        self._rid = 0

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  int(max_new)))
        return rid

    @property
    def pending(self) -> int:
        return len(self.queue)

    def _drain(self, finished: List[FinishedRequest]) -> None:
        for f in finished:
            self.results[f.rid] = f.tokens
            self.history.append(("finish", f.rid, f.reason))

    def step(self) -> bool:
        """One scheduler iteration: at most one prefill-insert, then one
        pool decode step.  Returns False when fully idle."""
        if self.queue and self.engine.free_slots:
            req = self.queue.popleft()
            slot = self.engine.insert(req.prompt, req.max_new, rid=req.rid)
            self.history.append(("prefill", req.rid, slot))
            self._drain(self.engine.take_finished())
        if self.engine.live_slots:
            self.history.append(("decode", len(self.engine.live_slots)))
            self._drain(self.engine.step())
        return bool(self.queue or self.engine.live_slots)

    def run(self) -> Dict[int, np.ndarray]:
        while self.step():
            pass
        return self.results


class BatchScheduler:
    """Run-to-completion baseline: fills a group of ``batch_size`` slots,
    decodes the whole group until every member finishes, then admits the
    next group.  Requests are prefilled solo through the same slot pool as
    :class:`ContinuousScheduler`, so batched output equals solo generation
    token for token; what it keeps is the head-of-line blocking."""

    def __init__(self, engine: ServingEngine, batch_size: int):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.queue: List[Request] = []
        self._pool = ContinuousEngine(
            engine.arch, engine.params, n_slots=self.batch_size,
            cache_len=engine.cache_len, cfg=engine.cfg)

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        rid = len(self.queue)
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  int(max_new)))
        return rid

    def run(self) -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        pending = [r for r in self.queue if not r.done]
        for i in range(0, len(pending), self.batch_size):
            group = pending[i:i + self.batch_size]
            for r in group:
                self._pool.insert(r.prompt, r.max_new, rid=r.rid)
            finished = self._pool.take_finished()
            while self._pool.live_slots:
                finished += self._pool.step()
            for f in finished:
                req = next(r for r in group if r.rid == f.rid)
                req.done = True
                req.output = f.tokens[: req.max_new]
                results[f.rid] = req.output
        return results
