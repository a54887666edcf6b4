"""Training losses and the PSNR metric.

Port of the elementwise half of ``rho_diffusion_tpu/metrics/losses.py``
(:22-123): the nine losses the reference resolved through its "nn" registry
(torch.nn class names, mean reduction), ``resolve_loss`` and ``psnr``. The
variational-lower-bound pieces belong to GaussianDiffusion's learned
variance and are not ported yet (ROADMAP Queue 1, "the rest of
GaussianDiffusion").
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.registry import registry


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = torch.abs(pred - target)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad**2 + delta * (abs_err - quad))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    err = torch.abs(pred - target)
    return torch.mean(torch.where(err < beta, 0.5 * err**2 / beta, err - 0.5 * beta))


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Logits [N, C] against class indices [N] (integer) or class
    probabilities [N, C]."""
    logp = F.log_softmax(pred, dim=-1)
    if not torch.is_floating_point(target):
        return -torch.mean(torch.gather(logp, -1, target[..., None].long())[..., 0])
    return -torch.mean(torch.sum(target * logp, dim=-1))


def nll_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Log-probabilities [N, C] against integer class indices [N]."""
    return -torch.mean(torch.gather(pred, -1, target[..., None].long())[..., 0])


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Probabilities in [0, 1]."""
    p = torch.clamp(pred, 1e-12, 1.0 - 1e-12)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def bce_with_logits_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The numerically stable log-sigmoid form."""
    return torch.mean(
        torch.clamp(pred, min=0.0) - pred * target + torch.log1p(torch.exp(-torch.abs(pred))),
    )


def kldiv_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``pred`` log-probabilities, ``target`` probabilities ('mean' reduction)."""
    t = torch.clamp(target, min=0.0)
    elt = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-12)) - pred),
                      torch.zeros_like(t))
    return torch.mean(elt)


LOSSES = {
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "HuberLoss": huber_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "NLLLoss": nll_loss,
    "BCELoss": bce_loss,
    "BCEWithLogitsLoss": bce_with_logits_loss,
    "KLDivLoss": kldiv_loss,
}
for _name, _fn in LOSSES.items():
    registry.add("nn", _name, lambda fn=_fn: fn)


def resolve_loss(loss) -> Callable:
    """A loss name, factory or callable -> fn(pred, target) -> scalar."""
    if isinstance(loss, str):
        loss = registry.get("nn", loss)()
    elif isinstance(loss, type):
        loss = loss()
    return loss


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio with the data range taken from ``target``."""
    data_range = torch.amax(target) - torch.amin(target)
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(torch.square(data_range) / torch.clamp(mse, min=1e-20))
