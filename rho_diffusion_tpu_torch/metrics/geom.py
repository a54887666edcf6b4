"""Geometric (distributional) metrics: the debiased Sinkhorn divergence.

Port of ``rho_diffusion_tpu/metrics/geom.py:23-94``. The reference wraps
geomloss' ``SamplesLoss("sinkhorn", p=1, blur=0.01)`` to compare generated
fields with data; here, as in the JAX package, it is a log-domain Sinkhorn
with geomloss' semantics: samples are point clouds with uniform weights,
the ground cost is the Euclidean distance to the power p over p (p = 1: the
distance), the entropic blur is eps = blur^p, and the divergence is the
debiased S(a, b) = OT_eps(a, b) - (OT_eps(a, a) + OT_eps(b, b)) / 2,
clamped at 0. It runs on whatever device its inputs are on.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rho_diffusion_tpu_torch.registry import registry


def _sinkhorn_potentials(cost: torch.Tensor, eps: float, num_iters: int):
    """Symmetric log-domain Sinkhorn iterations for uniform marginals on a
    cost [N, M]; returns the potentials (f [N], g [M])."""
    n, m = cost.shape
    log_a, log_b = -math.log(n), -math.log(m)
    f = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    g = torch.zeros(m, dtype=cost.dtype, device=cost.device)
    for _ in range(num_iters):
        g = -eps * torch.logsumexp((f[:, None] - cost) / eps + log_a, dim=0)
        f = -eps * torch.logsumexp((g[None, :] - cost) / eps + log_b, dim=1)
    return f, g


def _ot_cost(x: torch.Tensor, y: torch.Tensor, eps: float, num_iters: int, p: int):
    sq = torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.clamp(sq, min=1e-20))
    cost = dist if p == 1 else dist ** p / p
    f, g = _sinkhorn_potentials(cost, eps, num_iters)
    return torch.mean(f) + torch.mean(g)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def sinkhorn_divergence(x, y, blur: float = 0.01, p: int = 1, num_iters: int = 100) -> torch.Tensor:
    """Debiased Sinkhorn divergence between the point clouds x [N, D] and
    y [M, D] (1-D inputs are clouds of scalars), uniform weights, in fp32."""
    eps = blur ** p
    x = _as_tensor(x).float()
    y = _as_tensor(y).float().to(x.device)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    ot_xy = _ot_cost(x, y, eps, num_iters, p)
    ot_xx = _ot_cost(x, x, eps, num_iters, p)
    ot_yy = _ot_cost(y, y, eps, num_iters, p)
    return torch.clamp(ot_xy - 0.5 * (ot_xx + ot_yy), min=0.0)


@registry.register_layer("WassersteinWrapper")
class WassersteinWrapper:
    """The Sinkhorn divergence between two batches of fields: each field,
    flattened, is one point of its batch's cloud (geomloss' flatten(1))."""

    def __init__(self, blur: float = 0.01, p: int = 1, num_iters: int = 100) -> None:
        self.blur = blur
        self.p = p
        self.num_iters = num_iters

    def __call__(self, pred_data, true_data) -> torch.Tensor:
        pred_data, true_data = _as_tensor(pred_data), _as_tensor(true_data)
        assert pred_data.shape == true_data.shape
        return sinkhorn_divergence(pred_data.reshape(pred_data.shape[0], -1),
                                   true_data.reshape(true_data.shape[0], -1),
                                   blur=self.blur, p=self.p, num_iters=self.num_iters)
