"""The paper's own evaluation models (Table III) in PyTorch.

Counterpart of ``repro/models/reference.py``: LeNet (MNIST), a filters/4
ResNet18 variant (CIFAR-10) and DeepFM (Frappe), as functions over
parameter dicts.  The parameter layout is the reference's, so that its
parameters convert leaf for leaf (``convert.paper_params_from_numpy``):
convolution kernels HWIO, dense weights ``(in, out)``, inputs NHWC.  The
forwards permute to PyTorch's NCHW / OIHW inside.

Convolutions pad as XLA's ``"SAME"`` does: ``(k - 1)``-ish padding split
with the smaller half first, which for a 3x3 kernel at stride 2 on an even
input is (0, 1), not the (1, 1) of ``F.conv2d(padding=1)``; so each conv
pads explicitly with ``F.pad``.  Max-pool is 2x2 VALID.  Initializers draw
from a ``torch.Generator`` (the same distributions as the reference, not
its numbers).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T

Params = Dict[str, torch.Tensor]


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x NCHW, w HWIO -> NCHW, SAME padding."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=device)


def _dense_init(gen, i: int, o: int, device) -> torch.Tensor:
    return _normal(gen, (i, o), device) / math.sqrt(i)


def _conv_init(gen, h: int, w: int, i: int, o: int, device) -> torch.Tensor:
    return _normal(gen, (h, w, i, o), device) / math.sqrt(h * w * i)


# ---------------------------------------------------------------------------
# LeNet  (paper: MNIST, gradient size ~0.4 MB)
# ---------------------------------------------------------------------------


def lenet_init(gen: torch.Generator, device="cuda") -> Params:
    return {
        "c1": _conv_init(gen, 5, 5, 1, 6, device),
        "c2": _conv_init(gen, 5, 5, 6, 16, device),
        "f1": _dense_init(gen, 7 * 7 * 16, 120, device),
        "f2": _dense_init(gen, 120, 84, device),
        "f3": _dense_init(gen, 84, 10, device),
    }


def lenet_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> logits (B, 10)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(_conv(h, p["c1"])), 2)
    h = F.max_pool2d(F.relu(_conv(h, p["c2"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC order
    h = F.relu(h @ p["f1"])
    h = F.relu(h @ p["f2"])
    return h @ p["f3"]


# ---------------------------------------------------------------------------
# ResNet18 / filters cut by 4  (paper: CIFAR-10, gradient size ~0.6 MB)
# ---------------------------------------------------------------------------

_RESNET_STAGES = (16, 32, 64, 128)  # 64..512 cut by 4


def _block_init(gen, cin: int, cout: int, device) -> Params:
    p = {"c1": _conv_init(gen, 3, 3, cin, cout, device),
         "c2": _conv_init(gen, 3, 3, cout, cout, device)}
    if cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
    return p


def resnet_init(gen: torch.Generator, device="cuda") -> Dict:
    p = {"stem": _conv_init(gen, 3, 3, 3, _RESNET_STAGES[0], device)}
    cin = _RESNET_STAGES[0]
    for s, cout in enumerate(_RESNET_STAGES):
        for b in range(2):
            p[f"s{s}b{b}"] = _block_init(gen, cin, cout, device)
            cin = cout
    p["head"] = _dense_init(gen, cin, 10, device)
    return p


def _resblock(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_conv(x, p["c1"], stride))
    h = _conv(h, p["c2"])
    if "proj" in p:
        x = _conv(x, p["proj"], stride)
    return F.relu(h + x)


def resnet_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, 10)."""
    h = F.relu(_conv(x.permute(0, 3, 1, 2), p["stem"]))
    for s in range(len(_RESNET_STAGES)):
        for b in range(2):
            h = _resblock(p[f"s{s}b{b}"], h, 2 if (b == 0 and s > 0) else 1)
    return h.mean(dim=(2, 3)) @ p["head"]


# ---------------------------------------------------------------------------
# DeepFM  (paper: Frappe CTR, gradient size ~2.4 MB)
# ---------------------------------------------------------------------------

N_FIELDS = 10
N_FEATURES = 5400   # Frappe-scale feature space
EMB_DIM = 16


def deepfm_init(gen: torch.Generator, device="cuda") -> Params:
    return {
        "emb": _normal(gen, (N_FEATURES, EMB_DIM), device) * 0.01,
        "lin": _normal(gen, (N_FEATURES,), device) * 0.01,
        "f1": _dense_init(gen, N_FIELDS * EMB_DIM, 400, device),
        "f2": _dense_init(gen, 400, 400, device),
        "f3": _dense_init(gen, 400, 1, device),
    }


def deepfm_apply(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, N_FIELDS) integer feature ids -> logit (B,).  The gathers
    are indexing, so the embedding tables get their gradients."""
    feats = feats.long()
    emb = p["emb"][feats]                          # (B, F, E)
    linear = p["lin"][feats].sum(dim=-1)           # (B,)
    # FM second order: 0.5 * ((sum e)^2 - sum e^2)
    s = emb.sum(dim=1)
    fm = 0.5 * (s.square() - emb.square().sum(dim=1)).sum(dim=-1)
    h = emb.reshape(emb.shape[0], -1)
    h = F.relu(h @ p["f1"])
    h = F.relu(h @ p["f2"])
    deep = (h @ p["f3"])[:, 0]
    return linear + fm + deep


# ---------------------------------------------------------------------------
# uniform train-task interface used by sync/scheduler experiments
# ---------------------------------------------------------------------------


def ce_loss(apply_fn: Callable) -> Callable:
    def loss(params, batch):
        logits = apply_fn(params, batch["x"])
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["y"].long()[:, None])[:, 0]
        return (logz - gold).mean()
    return loss


def bce_loss(apply_fn: Callable) -> Callable:
    def loss(params, batch):
        logit = apply_fn(params, batch["x"])
        y = batch["y"].float()
        return (logit.clamp(min=0) - logit * y
                + torch.log1p(torch.exp(-logit.abs()))).mean()
    return loss


PAPER_MODELS = {
    "lenet": dict(init=lenet_init, apply=lenet_apply,
                  loss=ce_loss(lenet_apply), input_shape=(28, 28, 1),
                  n_classes=10, grad_mb=0.4),
    "resnet": dict(init=resnet_init, apply=resnet_apply,
                   loss=ce_loss(resnet_apply), input_shape=(32, 32, 3),
                   n_classes=10, grad_mb=0.6),
    "deepfm": dict(init=deepfm_init, apply=deepfm_apply,
                   loss=bce_loss(deepfm_apply), input_shape=(N_FIELDS,),
                   n_classes=2, grad_mb=2.4),
}


def param_mb(params) -> float:
    return sum(x.numel() * x.element_size() for x in T.leaves(params)) / 1e6
