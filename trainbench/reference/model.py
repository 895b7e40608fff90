"""Plain PyTorch reference of the decoder the benchmark trains.

Written from the configuration file alone: a decoder of ``n_layers``
pre-norm blocks, each GQA attention with RoPE and then a SwiGLU MLP or a
top-k mixture of experts with a capacity, over an untied embedding and
output head, trained by next-token cross-entropy plus the experts'
load-balance and router-z losses.  Everything is computed in float32 from
the parameters' stored values; TF32 is off while it runs
(:func:`no_tf32`).  It imports nothing of the program.

Conventions the wire format fixes, and which the reference therefore keeps:
the parameter tree's names and shapes (:func:`layout`; blocks stacked on a
leading layer axis), RMS norm scaled by ``1 + scale``, the rotary embedding
over the two halves of a head, logits over the vocabulary's stored rows
(``vocab_rows``, the published vocabulary padded up), an expert capacity of
``top_k * tokens * capacity_factor / experts`` rounded up to a multiple of
8 with the slots ranked in token order and the ranks past the capacity
dropped, and router ties going to the lower expert id.

``mm`` is the one matrix product every projection goes through: float32 by
default, and the control's lower precision where it is swapped (``fp8``).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, object]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# Spec's fields by the configuration file's published key; the expert (or
# MLP) width is ``moe_intermediate_size`` where the model has experts, else
# ``intermediate_size``
PUBLISHED = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
             "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
             "vocab": "vocab_size", "rope_theta": "rope_theta",
             "norm_eps": "rms_norm_eps", "num_experts": "num_experts",
             "top_k": "num_experts_per_tok",
             "router_aux_weight": "router_aux_loss_coef"}


@dataclass(frozen=True)
class Spec:
    """The model's sizes as the configuration file states them."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_rows: int
    rope_theta: float
    norm_eps: float
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.0
    router_z_weight: float = 0.0

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def from_file(cls, cfg: dict) -> "Spec":
        """From the file's published keys (:data:`PUBLISHED`), and from its
        ``port`` group the settings that only the port has: the stored
        vocabulary rows and the experts' capacity and z loss."""
        if cfg.get("tie_word_embeddings"):
            raise ValueError("the reference's output head is untied")
        sizes = {f: cfg[k] for f, k in PUBLISHED.items() if k in cfg}
        sizes["d_ff"] = cfg["moe_intermediate_size" if "num_experts" in cfg
                            else "intermediate_size"]
        port = cfg.get("port", {})
        sizes.update({k: port[k] for k in cls.__dataclass_fields__
                      if k in port})
        sizes.setdefault("vocab_rows", sizes["vocab"])
        return cls(**sizes)


def layout(spec: Spec) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """``[(path, shape)]`` of one pod's parameters, in the order the wire
    packs them (dict keys sorted at every level)."""
    L, D, F_ = spec.n_layers, spec.d_model, spec.d_ff
    H, K, Dh, V = spec.n_heads, spec.n_kv_heads, spec.head_dim, \
        spec.vocab_rows
    block = {
        ("attn", "wq"): (L, D, H * Dh), ("attn", "wk"): (L, D, K * Dh),
        ("attn", "wv"): (L, D, K * Dh), ("attn", "wo"): (L, H * Dh, D),
        ("ln1", "scale"): (L, D), ("ln2", "scale"): (L, D),
    }
    if spec.moe:
        E = spec.num_experts
        block.update({("moe", "router"): (L, D, E),
                      ("moe", "wg"): (L, E, D, F_),
                      ("moe", "wu"): (L, E, D, F_),
                      ("moe", "wd"): (L, E, F_, D)})
    else:
        block.update({("mlp", "wg"): (L, D, F_), ("mlp", "wu"): (L, D, F_),
                      ("mlp", "wd"): (L, F_, D)})
    items = [(("blocks", "pos0") + k, s) for k, s in block.items()]
    items += [(("embed", "tokens"), (V, D)), (("embed", "lm_head"), (D, V)),
              (("final_norm", "scale"), (D,))]
    return sorted(items)


def path_str(path: Tuple[str, ...]) -> str:
    """The path as the program's tree helpers spell it (``['a']['b']``)."""
    return "".join(f"[{p!r}]" for p in path)


def nest(flat: Dict[Tuple[str, ...], torch.Tensor]) -> Params:
    out: Params = {}
    for path, x in flat.items():
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = x
    return out


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32, not TF32, while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head of ``x`` ``(B, S, H, Dh)`` by the
    position times ``theta ** (-i / half)``."""
    B, S, _, Dh = x.shape
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: Params, spec: Spec, x: torch.Tensor, mm: MatMul
              ) -> torch.Tensor:
    B, S, _ = x.shape
    H, K, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = rope(mm(x, p["wq"]).reshape(B, S, H, Dh), spec.rope_theta)
    k = rope(mm(x, p["wk"]).reshape(B, S, K, Dh), spec.rope_theta)
    v = mm(x, p["wv"]).reshape(B, S, K, Dh)
    # query head h reads key/value head h // (H // K)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(Dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * Dh)
    return mm(out, p["wo"])


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, mm: MatMul) -> torch.Tensor:
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def capacity(spec: Spec, n_tokens: int) -> int:
    cap = math.ceil(n_tokens * spec.top_k * spec.capacity_factor
                    / spec.num_experts)
    return max(8, -(-cap // 8) * 8)


def moe(p: Params, spec: Spec, x: torch.Tensor, mm: MatMul
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k experts over all the pod's tokens at once -> (y, the aux
    loss).  Each expert takes at most :func:`capacity` of its (token,
    choice) slots, in token order and then choice order; a dropped slot
    adds nothing."""
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    xt = x.reshape(B * S, D)
    T = xt.shape[0]
    logits = mm(xt, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones(T * K, device=x.device))
    lb = E * torch.sum(probs.mean(0) * counts / T)
    z = torch.logsumexp(logits, -1).square().mean()
    aux = spec.router_aux_weight * lb + spec.router_z_weight * z

    C = capacity(spec, T)
    flat_e = top_e.reshape(-1)                        # token-major slots
    onehot = F.one_hot(flat_e, E)
    rank = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    kept = rank < C
    y = torch.zeros_like(xt)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    weight = top_p.reshape(-1)
    for e in range(E):
        sel = kept & (flat_e == e)
        if not bool(sel.any()):
            continue
        rows = tok[sel]
        out = swiglu(xt[rows], p["wg"][e], p["wu"][e], p["wd"][e], mm)
        y = y.index_add(0, rows, out * weight[sel][:, None])
    return y.reshape(B, S, D), aux


def loss_fn(params: Params, spec: Spec, batch: Dict[str, torch.Tensor],
            mm: MatMul = f32_mm) -> torch.Tensor:
    """Mean next-token cross-entropy over the masked positions, plus the
    experts' aux losses summed over layers.  ``params`` are one pod's,
    float32 leaves."""
    tokens = batch["tokens"].long()
    h = params["embed"]["tokens"][tokens]
    aux = torch.zeros((), device=h.device)
    blk = params["blocks"]["pos0"]
    for i in range(spec.n_layers):
        layer = {k: {n: w[i] for n, w in v.items()} for k, v in blk.items()}
        h = h + attention(layer["attn"], spec,
                          rmsnorm(h, layer["ln1"]["scale"], spec.norm_eps),
                          mm)
        hn = rmsnorm(h, layer["ln2"]["scale"], spec.norm_eps)
        if spec.moe:
            out, a = moe(layer["moe"], spec, hn, mm)
            aux = aux + a
        else:
            m = layer["mlp"]
            out = swiglu(hn, m["wg"], m["wu"], m["wd"], mm)
        h = h + out
    h = rmsnorm(h, params["final_norm"]["scale"], spec.norm_eps)
    logits = mm(h, params["embed"]["lm_head"])
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch["mask"].float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0) + aux


def grads_of(params: Dict[Tuple[str, ...], torch.Tensor], spec: Spec,
             batch: Dict[str, torch.Tensor], mm: MatMul = f32_mm
             ) -> Tuple[float, Dict[Tuple[str, ...], torch.Tensor]]:
    """(loss, gradient of every leaf) of one pod's float32 parameters."""
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in params.items()}
    loss = loss_fn(nest(leaves), spec, batch, mm)
    g = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, g))


def fp8_mm_fn() -> MatMul:
    """The control's matrix product, computed in fp8 where the program
    computes in bf16: operands and product rounded to e4m3 in the forward,
    the incoming and outgoing gradients to e5m2 in the backward (the usual
    fp8 training split), each tensor with its own scale, the products
    accumulated in float32."""
    def q(x: torch.Tensor, fmt) -> torch.Tensor:
        s = torch.finfo(fmt).max / x.detach().abs().amax().clamp(min=1e-30)
        return (x * s).to(fmt).float() / s

    fwd, bwd = torch.float8_e4m3fn, torch.float8_e5m2

    class _Fp8(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            qa, qb = q(a, fwd), q(b, fwd)
            ctx.save_for_backward(qa, qb)
            return q(torch.matmul(qa, qb), fwd)

        @staticmethod
        def backward(ctx, g):
            qa, qb = ctx.saved_tensors
            qg = q(g, bwd)
            ga = torch.matmul(qg, qb.transpose(-1, -2))
            gb = torch.matmul(qa.transpose(-1, -2), qg)
            # sum broadcast batch dims back into each operand's shape
            while ga.dim() > qa.dim():
                ga = ga.sum(0)
            while gb.dim() > qb.dim():
                gb = gb.sum(0)
            return (q(ga.sum_to_size(qa.shape), bwd),
                    q(gb.sum_to_size(qb.shape), bwd))

    return _Fp8.apply


