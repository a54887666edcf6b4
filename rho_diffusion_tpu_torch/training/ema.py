"""Exponential moving average of the model parameters.

Port of ``rho_diffusion_tpu/training/ema.py`` (:16-29): the reference's
warm-up decay, decay_eff = decay * (1 - exp(-(step + 1) / 2000)) with the
PRE-increment step, applied to the NEW parameters as
shadow <- shadow - (1 - decay_eff) * (shadow - param), in place.
"""
from __future__ import annotations

import numpy as np
import torch


def ema_decay_at(step: int, decay: float) -> float:
    """The effective decay at the pre-increment ``step``, in float32 as the
    JAX package computes it (-expm1, not 1 - exp, for the small fractions of
    the first steps)."""
    frac = np.float32(-(np.float32(step) + np.float32(1.0))) / np.float32(2000.0)
    return float(np.float32(decay) * -np.expm1(frac))


@torch.no_grad()
def ema_update(ema: dict, params: dict, step: int, decay: float) -> None:
    """One EMA step over the parameter dicts (same keys), in place."""
    keys = list(ema)
    weight = float(np.float32(1.0) - np.float32(ema_decay_at(step, decay)))
    torch._foreach_lerp_([ema[k] for k in keys], [params[k].detach() for k in keys], weight)
