"""Training losses, the PSNR metric and the variational-lower-bound pieces.

Port of ``rho_diffusion_tpu/metrics/losses.py``: the nine losses the
reference resolved through its "nn" registry (torch.nn class names, mean
reduction), ``resolve_loss`` and ``psnr`` (:22-123); and the pieces of the
VLB that learned-variance training and bits-per-dim read (:130-172):
``normal_kl``, ``approx_standard_normal_cdf`` and
``discretized_gaussian_log_likelihood``, with the same 1e-12 clamps and
+/-0.999 edge bins.
"""
from __future__ import annotations

import math
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


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))), elementwise,
    in nats. Any argument may be a Python float."""
    mean1, logvar1, mean2, logvar2 = (
        a if isinstance(a, torch.Tensor) else torch.tensor(float(a))
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + torch.square(mean1 - mean2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of the standard normal CDF (Page 1977)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x: torch.Tensor, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood, elementwise in nats, of a Gaussian discretised to
    bins of width 2/255 over [-1, 1]; the edge bins (|x| > 0.999) take the
    whole tail."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))
