"""The pieces of ``rho_diffusion_tpu/diffusion/gaussian.py`` that DDPM
training uses: ``ModelMeanType``, ``min_snr_weight`` (:913-948) and
``validate_loss_weighting`` (:951-).

The GaussianDiffusionPipeline itself (coefficients, respacing, DDIM and the
solvers, VLB and learned variance) is in ROADMAP Queue 1 (DDIM/GaussianDiffusion
sampling, the rest of GaussianDiffusion).
"""
from __future__ import annotations

import enum
from typing import Any, Optional

import torch


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"
    VELOCITY = "v_prediction"


def min_snr_weight(
    alphas_cumprod: torch.Tensor, t: torch.Tensor, mean_type: ModelMeanType, gamma: float = 5.0,
) -> torch.Tensor:
    """Per-sample min-SNR-gamma loss weight (Hang et al., arXiv:2303.09556),
    so that the weighted loss equals min(SNR, gamma) times the x0-space loss:
    START_X min(SNR, gamma); EPSILON min(SNR, gamma) / SNR; VELOCITY
    min(SNR, gamma) / (SNR + 1)."""
    acp = alphas_cumprod[t]
    snr = acp / torch.clamp(1.0 - acp, min=1e-20)
    clipped = torch.clamp(snr, max=gamma)
    if mean_type == ModelMeanType.START_X:
        return clipped
    if mean_type == ModelMeanType.EPSILON:
        return clipped / snr
    if mean_type == ModelMeanType.VELOCITY:
        return clipped / (snr + 1.0)
    raise ValueError(
        f"min-SNR weighting is undefined for mean_type={mean_type}; "
        "use START_X, EPSILON or VELOCITY",
    )


def validate_loss_weighting(
    loss_weighting: Optional[str], mean_type: ModelMeanType, loss_type: Optional[Any] = None,
) -> Optional[str]:
    """Normalise and check a ``loss_weighting`` config value at construction."""
    if loss_weighting in (None, "", "none"):
        return None
    canonical = str(loss_weighting).lower().replace("-", "_")
    if canonical != "min_snr":
        raise ValueError(f"unknown loss_weighting {loss_weighting!r}; expected 'min_snr' or none")
    if mean_type not in (ModelMeanType.START_X, ModelMeanType.EPSILON, ModelMeanType.VELOCITY):
        raise ValueError(f"loss_weighting='min_snr' is undefined for mean_type={mean_type}")
    if loss_type is not None and loss_type.is_vb():
        raise ValueError(
            f"loss_weighting='min_snr' only applies to MSE loss types, not loss_type={loss_type}",
        )
    return canonical
