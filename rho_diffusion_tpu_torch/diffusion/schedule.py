"""Noise schedules as coefficient tables.

Port of ``rho_diffusion_tpu/diffusion/schedule.py``: tables are built on the
host in float64 exactly as there, then stored as float32 tensors, so they
match the JAX package's tables bit for bit. ``NoiseSchedule.to(device)``
moves them next to the model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rho_diffusion_tpu_torch.registry import registry

__all__ = [
    "NoiseSchedule",
    "LinearSchedule",
    "CosineBetaSchedule",
    "SigmoidSchedule",
    "named_beta_schedule",
    "rescale_zero_terminal_snr",
    "schedule_from_betas",
]


@dataclass(frozen=True)
class NoiseSchedule:
    """DDPM coefficient tables, all shape [T], float32."""

    beta_t: torch.Tensor
    alpha_t: torch.Tensor
    alpha_bar_t: torch.Tensor
    sigma_t: torch.Tensor

    @property
    def num_steps(self) -> int:
        return int(self.beta_t.shape[0])

    def __len__(self) -> int:
        return self.num_steps

    @property
    def offset_alpha_bar_t(self) -> torch.Tensor:
        """alpha_bar_{t-1}, with a leading 1.0."""
        return torch.cat([torch.ones_like(self.alpha_bar_t[:1]), self.alpha_bar_t[:-1]])

    def to(self, device) -> "NoiseSchedule":
        return NoiseSchedule(
            *(getattr(self, k).to(device) for k in ("beta_t", "alpha_t", "alpha_bar_t", "sigma_t")),
        )

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))


def schedule_from_betas(beta: np.ndarray) -> NoiseSchedule:
    """Build the full coefficient table from a float64 beta array; betas
    must lie in (0, 1) (the terminal one may be exactly 1)."""
    beta = np.asarray(beta, dtype=np.float64)
    interior_ok = ((beta[:-1] > 0.0) & (beta[:-1] < 1.0)).all()
    if not (interior_ok and 0.0 < beta[-1] <= 1.0):
        raise ValueError(
            f"betas must lie in (0, 1) (terminal beta may be exactly 1 for "
            f"zero-terminal-SNR schedules); got range [{beta.min():.4g}, "
            f"{beta.max():.4g}]. With the reference's 1000/T scaling, small "
            f"num_steps needs proportionally smaller beta_1/beta_T.",
        )
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha)
    offset_alpha_bar = np.concatenate([[1.0], alpha_bar[:-1]])
    sigma = np.sqrt((1.0 - offset_alpha_bar) / (1.0 - alpha_bar) * beta)
    return NoiseSchedule(_f32(beta), _f32(alpha), _f32(alpha_bar), _f32(sigma))


@registry.register_schedule("LinearSchedule")
def LinearSchedule(
    num_steps: int,
    beta_1: float = 1.0e-3,
    beta_T: float = 0.02,
    device=None,  # accepted for reference-config compatibility; unused
    zero_terminal_snr: bool = False,
) -> NoiseSchedule:
    """Linear beta schedule, scaled by 1000/T."""
    del device
    scale = 1000.0 / num_steps
    beta = np.linspace(scale * beta_1, scale * beta_T, num_steps, dtype=np.float64)
    if zero_terminal_snr:
        beta = rescale_zero_terminal_snr(beta)
    return schedule_from_betas(beta)


@registry.register_schedule("CosineBetaSchedule")
def CosineBetaSchedule(
    num_steps: int,
    offset: float = 0.008,
    device=None,
    exact_reference: bool = False,
) -> NoiseSchedule:
    """Nichol & Dhariwal (2021) cosine schedule; ``exact_reference`` keeps
    the reference's T+1 table (with its degenerate beta_0), truncated."""
    del device
    t = np.linspace(0.0, num_steps, num_steps + 1, dtype=np.float64) / num_steps
    alpha_bar = np.cos((t + offset) / (1.0 + offset) * math.pi * 0.5) ** 2
    alpha_bar = np.clip(alpha_bar / alpha_bar[0], 0.0, 1.0)
    if exact_reference:
        prev = np.concatenate([[1.0], alpha_bar[:-1]])
        beta = np.clip(1.0 - alpha_bar / prev, 0.0001, 0.9999)
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma = np.sqrt((1.0 - prev) / (1.0 - alpha_bar) * beta)
        sigma = np.nan_to_num(sigma)
        return NoiseSchedule(
            _f32(beta[:num_steps]), _f32(1.0 - beta[:num_steps]),
            _f32(alpha_bar[:num_steps]), _f32(sigma[:num_steps]),
        )
    beta = 1.0 - alpha_bar[1:] / np.maximum(alpha_bar[:-1], 1e-12)
    beta = np.clip(beta, 0.0001, 0.9999)
    return schedule_from_betas(beta)


@registry.register_schedule("SigmoidSchedule")
def SigmoidSchedule(
    num_steps: int,
    start: float = -3.0,
    end: float = 3.0,
    tau: float = 1.0,
    device=None,
) -> NoiseSchedule:
    """Sigmoid noise schedule (Jabri et al. 2022, arXiv:2212.11972)."""
    del device

    def sig(x):
        return 1.0 / (1.0 + np.exp(-x))

    t = np.linspace(0.0, 1.0, num_steps + 1, dtype=np.float64)
    v_start, v_end = sig(start / tau), sig(end / tau)
    alpha_bar = (-sig((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    alpha_bar = np.clip(alpha_bar / alpha_bar[0], 0.0, 1.0)
    beta = 1.0 - alpha_bar[1:] / np.maximum(alpha_bar[:-1], 1e-12)
    beta = np.clip(beta, 0.0001, 0.9999)
    return schedule_from_betas(beta)


def rescale_zero_terminal_snr(beta: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (Lin et al.,
    arXiv:2305.08891 Alg. 1), in float64."""
    beta = np.asarray(beta, dtype=np.float64)
    s = np.sqrt(np.cumprod(1.0 - beta))
    s0, sT = s[0], s[-1]
    s = (s - sT) * s0 / (s0 - sT)
    abar = s**2
    alpha = abar / np.concatenate([[1.0], abar[:-1]])
    return 1.0 - alpha


def named_beta_schedule(
    name: str,
    num_steps: int,
    beta_start: float | None = None,
    beta_end: float | None = None,
    zero_terminal_snr: bool = False,
) -> NoiseSchedule:
    """Named beta schedules of the GaussianDiffusion pipeline ("linear",
    "scaled_linear", "sigmoid", "cosine"/"squaredcos_cap_v2")."""
    if (beta_start is None) != (beta_end is None):
        raise ValueError(
            "pass both beta_start and beta_end (HF semantics) or neither "
            f"(guided-diffusion defaults); got beta_start={beta_start}, "
            f"beta_end={beta_end}",
        )

    def _finish(beta: np.ndarray) -> NoiseSchedule:
        if zero_terminal_snr:
            beta = rescale_zero_terminal_snr(beta)
        return schedule_from_betas(beta)

    if name == "linear":
        if beta_start is None and beta_end is None:
            scale = 1000.0 / num_steps
            beta_start, beta_end = scale * 0.0001, scale * 0.02
        return _finish(np.linspace(beta_start, beta_end, num_steps, dtype=np.float64))
    if name == "scaled_linear":
        beta = np.linspace(
            math.sqrt(beta_start if beta_start is not None else 0.0001),
            math.sqrt(beta_end if beta_end is not None else 0.02),
            num_steps, dtype=np.float64,
        ) ** 2
        return _finish(beta)
    if name == "sigmoid":
        bs = beta_start if beta_start is not None else 0.0001
        be = beta_end if beta_end is not None else 0.02
        x = np.linspace(-6.0, 6.0, num_steps, dtype=np.float64)
        return _finish(1.0 / (1.0 + np.exp(-x)) * (be - bs) + bs)
    if name in ("cosine", "squaredcos_cap_v2"):
        def alpha_bar_fn(s):
            return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

        beta = np.array(
            [
                min(1.0 - alpha_bar_fn((i + 1) / num_steps) / alpha_bar_fn(i / num_steps), 0.999)
                for i in range(num_steps)
            ],
            dtype=np.float64,
        )
        return _finish(beta)
    raise ValueError(f"Unknown named beta schedule '{name}'")
