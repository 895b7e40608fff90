"""Mixture-of-Experts FFN with sort-based token dispatch.

Counterpart of ``repro/models/moe.py``: ``moe_init``, ``expert_capacity``,
``moe_apply`` (one sort over the whole token set), ``moe_apply_grouped``
(sort, scatter and combine local to each batch row) and ``moe_loss``, with
the reference's arithmetic in its order.  Routing runs in f32: softmax over
the router logits, top-k, the kept probabilities renormalized; the aux
losses are the reference's ``lb_loss``, ``z_loss`` and ``router_entropy``.
Dispatch sorts the (token, choice) slots by expert id (a stable sort), ranks
each slot within its expert and drops the ranks at or above the capacity
``C`` into an overflow row; the expert products are plain batched matrix
products (``torch.bmm``), as the reference's are ``einsum``s outside any
Pallas kernel.

On a mesh (DTensor activations and parameters, under
``repro_torch.sharding.rules.axis_rules``) the reference's ``shard`` calls
place the expert buffer and the experts' output over ``"experts"`` (and the
rows over ``"batch"`` in the grouped dispatch), so that the expert products
run expert-parallel on the placed weights.  The routing, the capacity
slots and the scatter and gather around the experts run on the tokens
gathered whole on each rank (``whole_local``): DTensor has no sharding rule
for ``searchsorted``, and this index math is a few integers per token.  On
plain tensors every ``shard`` is a no-op and nothing is gathered.

Two rules the reference gets from JAX and the port spells out:

- **Ties in the router's top-k** go to the lower expert id, as
  ``jax.lax.top_k`` does: the top-k is a stable descending sort, not
  ``torch.topk`` (which promises no order among ties).
- **The combine** sums each token's K contributions in a fixed order, the
  one the reference's arithmetic has: ascending expert id for the global
  dispatch (the order of its scatter-add over expert-sorted slots), choice
  order for the grouped one.  Gathers and adds in that order replace a
  scatter-add, whose atomics on the card add in no fixed order; the result
  is deterministic on the card and rounds as the reference does.

``moe_apply(..., per_row=True)`` routes every batch row on its own, with
the capacity of one row: what the reference's serving pool computes by
``vmap``-ing a single-sequence decode over its slots, written out as a
batch dimension (``ContinuousEngine``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding.rules import (is_dtensor, replicated_like, shard,
                                        whole_local)

# f32 values drawn at once for an expert leaf before the cast to the
# parameter dtype (1 GiB): the draw of a full-width leaf never holds a
# second f32 copy of it
_DRAW_VALUES = 1 << 28


def _expert_weights(gen: torch.Generator, E: int, d_in: int, d_out: int,
                    dtype, device) -> torch.Tensor:
    """``(E, d_in, d_out)`` normal / sqrt(d_in), drawn in f32 a slice of
    experts at a time and cast into the leaf."""
    w = torch.empty(E, d_in, d_out, dtype=dtype, device=device)
    per = max(1, _DRAW_VALUES // (d_in * d_out))
    for e in range(0, E, per):
        draw = torch.randn(min(per, E - e), d_in, d_out, generator=gen,
                           dtype=torch.float32, device=device)
        w[e:e + draw.shape[0]] = draw.div_(math.sqrt(d_in))
    return w


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    pdt = cfg.dtype("param")
    return {
        "router": dense_init(gen, D, E, pdt, device),
        "wg": _expert_weights(gen, E, D, Fd, pdt, device),
        "wu": _expert_weights(gen, E, D, Fd, pdt, device),
        "wd": _expert_weights(gen, E, Fd, D, pdt, device),
    }


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity: top_k * tokens * cf / E, rounded up to a
    multiple of 8."""
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k * m.capacity_factor
                        / m.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def _route(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Router over ``x`` ``(G, T, D)`` -> (top_p ``(G, T, K)`` f32
    renormalized, top_e ``(G, T, K)`` int64, aux).  Ties go to the lower
    expert id (a stable descending sort), as ``jax.lax.top_k``'s do."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    with spans.span("moe.route"):
        logits = (x @ params["router"].to(x.dtype)).float()  # (G, T, E)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[..., :K], top_e[..., :K]
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

        n = probs.shape[0] * probs.shape[1]
        me = torch.mean(probs.reshape(n, E), dim=0)
        # chosen-expert counts are integers, exact in f32 in any order of
        # addition, as the reference's mean of one-hot sums is (a
        # scatter-add, not bincount, which waits on the device for its
        # length)
        flat = top_e.reshape(-1)
        ones = torch.ones_like(flat, dtype=torch.float32)
        ce = ones.new_zeros(E).scatter_add_(0, flat, ones) / n
        aux = {
            "lb_loss": E * torch.sum(me * ce),
            "z_loss": torch.mean(torch.square(
                torch.logsumexp(logits, dim=-1))),
            "router_entropy": -torch.mean(torch.sum(
                probs * torch.log(probs + 1e-9), dim=-1)),
        }
    return top_p, top_e, aux


def _capacity_slots(top_e: torch.Tensor, C: int, E: int) -> torch.Tensor:
    """The capacity slot of each (token, choice) of each group: ``(G, T,
    K)`` with ``e * C + rank``, or ``E * C`` (the overflow row) where the
    rank within expert ``e`` reaches ``C``.  Ranks come from a stable sort
    of the group's slots by expert id: token order, then choice order."""
    G, T, K = top_e.shape
    flat_e = top_e.reshape(G, T * K)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(T * K, device=top_e.device)[None] - first
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))
    return torch.empty_like(slot).scatter_(-1, order, slot).reshape(G, T, K)


def _experts(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its capacity rows: ``hidden`` ``(G, E,
    C, D)`` -> ``(G, E, C, D)``; the gate's SiLU in f32, as the
    reference's."""
    G, E, C, D = hidden.shape
    cdt = hidden.dtype
    hidden = shard(hidden, "batch", "experts", "capacity", "d_model")
    h = hidden.transpose(0, 1).reshape(E, G * C, D)
    g = torch.bmm(h, params["wg"].to(cdt))
    u = torch.bmm(h, params["wu"].to(cdt))
    act = F.silu(g.float()).to(cdt) * u
    out = torch.bmm(act, params["wd"].to(cdt))               # (E, G*C, D)
    out = out.reshape(E, G, C, D).transpose(0, 1)
    return shard(out, "batch", "experts", "capacity", "d_model")


def _dispatch_combine(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      top_p: torch.Tensor, top_e: torch.Tensor, C: int,
                      expert_order: bool, placed=None) -> torch.Tensor:
    """Scatter ``x`` ``(G, T, D)`` into each group's ``(E * C + 1, D)``
    buffer, run the experts and gather each token's K outputs back,
    weighted by its probabilities; the K contributions are summed in
    ascending expert id (``expert_order``) or in choice order.  ``x`` is
    plain; with ``placed`` (the DTensor input of the layer) the experts run
    on the buffer replicated on its mesh and placed by ``shard``.  While a
    profiler runs, the layer's kept, routed and capacity slots are added
    to the ``moe.slots.*`` counters (``repro_torch.spans``)."""
    G, T, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    cdt = x.dtype
    with spans.span("moe.dispatch"):
        slot = _capacity_slots(top_e, C, E)                  # (G, T, K)
        if spans.enabled():
            spans.add("moe.slots.kept", (slot < E * C).sum())
            spans.add("moe.slots.routed", G * T * K)
            spans.add("moe.slots.rows", G * E * C)
        rows = torch.arange(G, device=x.device)[:, None]
        buf = x.new_zeros(G, E * C + 1, D)
        # every (token, choice) in one scatter: kept slots are unique,
        # dropped ones all land in the overflow row
        buf[rows, slot.reshape(G, T * K)] = x[:, :, None].expand(
            G, T, K, D).reshape(G, T * K, D)
    with spans.span("moe.experts"):
        hidden = replicated_like(buf[:, :E * C].reshape(G, E, C, D), placed)
        out = whole_local(_experts(params, hidden))
    with spans.span("moe.combine"):
        out_flat = torch.cat([out.reshape(G, E * C, D),
                              x.new_zeros(G, 1, D)], dim=1)
        w = top_p.to(cdt)
        if expert_order:
            by_e = torch.argsort(top_e, dim=-1, stable=True)
            slot, w = slot.gather(-1, by_e), w.gather(-1, by_e)
        got = out_flat[rows, slot.reshape(G, T * K)].reshape(G, T, K, D)
        got = got * w[..., None]
        y = x.new_zeros(G, T, D)
        for k in range(K):      # one rounding per add, in the fixed order
            y = y + got[:, :, k]
    return y


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              per_row: bool = False) -> Tuple[torch.Tensor, dict]:
    """x ``(B, S, D)`` -> (y, aux) with aux = {lb_loss, z_loss,
    router_entropy}.  ``per_row`` routes each row alone (capacity of S
    tokens), with ``cfg.moe_dispatch``'s combine order.  A DTensor ``x``
    is routed and dispatched whole on each rank and its experts run
    placed (the module's docstring)."""
    if per_row or cfg.moe_dispatch == "grouped":
        return moe_apply_grouped(params, cfg, x, per_row=per_row)
    placed, x, router = _whole(x, params)
    B, S, D = x.shape
    xt = x.reshape(1, B * S, D)
    top_p, top_e, aux = _route(router, cfg, xt)
    y = _dispatch_combine(params, cfg, xt, top_p, top_e,
                          expert_capacity(B * S, cfg), expert_order=True,
                          placed=placed)
    return _placed_out(y.reshape(B, S, D), aux, placed)


def _whole(x: torch.Tensor, params: dict):
    """(the DTensor input or None, ``x`` whole, ``{"router": whole}``)."""
    if not is_dtensor(x):
        return None, x, params
    return x, whole_local(x), {"router": whole_local(params["router"])}


def _placed_out(y: torch.Tensor, aux: dict, placed):
    """``y`` and the aux losses back on the input's mesh, replicated, and
    ``y`` placed by rows."""
    if placed is None:
        return y, aux
    y = shard(replicated_like(y, placed), "batch", None, "d_model")
    return y, {k: replicated_like(v, placed) for k, v in aux.items()}


def moe_apply_grouped(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      per_row: bool = False) -> Tuple[torch.Tensor, dict]:
    """Group-local dispatch: sort, scatter and combine stay within each
    batch row, with capacity provisioned per S-token row; the K
    contributions are summed in choice order, as in the reference
    (``per_row``: in ``cfg.moe_dispatch``'s order)."""
    placed, x, router = _whole(x, params)
    B, S, D = x.shape
    top_p, top_e, aux = _route(router, cfg, x)
    y = _dispatch_combine(params, cfg, x, top_p, top_e,
                          expert_capacity(S, cfg),
                          expert_order=per_row
                          and cfg.moe_dispatch != "grouped",
                          placed=placed)
    return _placed_out(y, aux, placed)


def moe_loss(aux: dict, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.moe
    return (m.router_aux_weight * aux["lb_loss"]
            + m.router_z_weight * aux["z_loss"])
