"""Registered ODE/SDE solvers for the Gaussian sampling loop.

Port of ``rho_diffusion_tpu/diffusion/solvers.py`` (:62-346). A solver is
built ahead of the loop against one (possibly respaced) alpha_bar grid into
a ``SolverProgram``:

* ``steps``: per-step scalars in loop order (i = M-1 .. 0), as Python
  floats. JAX builds them as float32 ``jnp`` arrays that its scan slices;
  here they are float32 torch ops on the host, read out once, so a step
  multiplies the sample by a scalar and launches no table lookup;
* ``init_mem(x)``: the multistep memory (previous x0 predictions, the last
  sample);
* ``step(x, x0, s, mem, noise) -> (x_new, mem)``: one update from the
  model's clipped (and guided) x0 prediction at the current grid point.
  ``noise`` is a standard-normal draw shaped like ``x`` for a stochastic
  program, else None.

Registered: ``dpm++``/``dpmpp`` (DPM-Solver++(2M), arXiv:2211.01095),
``sde-dpm++``/``sde-dpmpp`` (its SDE variant), ``ancestral`` (DDPM
ancestral sampling, sigma_small, through the same seam) and ``unipc``
(UniPC-p2 with B2(h), arXiv:2302.04867). They work in log-SNR space, so
the pipeline rejects them on a zero-terminal-SNR schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch


@dataclass(frozen=True)
class SolverProgram:
    """A solver compiled against one alpha_bar grid; ``stochastic`` says
    whether ``step`` consumes a noise draw."""

    steps: list  # one dict of scalars per loop step, order M-1 .. 0
    init_mem: Callable[[torch.Tensor], Any]
    step: Callable
    stochastic: bool = False


_SOLVERS: Dict[str, Callable[[torch.Tensor], SolverProgram]] = {}


def register_solver(*names: str):
    """Register a ``builder(alphas_cumprod) -> SolverProgram`` under one or
    more sampler names."""

    def deco(builder):
        for n in names:
            _SOLVERS[n] = builder
        return builder

    return deco


def is_solver(name: str) -> bool:
    return name in _SOLVERS


def solver_names() -> list[str]:
    return sorted(_SOLVERS)


def build_solver(name: str, alphas_cumprod) -> SolverProgram:
    """Build solver ``name`` on a float32 copy of ``alphas_cumprod`` (on
    the host, whatever device the table lives on)."""
    abar = torch.as_tensor(alphas_cumprod).detach().to("cpu", torch.float32)
    return _SOLVERS[name](abar)


def _loop_order(idx_tables: dict) -> list:
    """Per-step dicts in loop order M-1 .. 0 from full [M] tables."""
    M = next(iter(idx_tables.values())).shape[0]
    idx = np.arange(M - 1, -1, -1)
    cols = {k: v[idx].tolist() for k, v in idx_tables.items()}
    return [{"i": int(i), **{k: cols[k][n] for k in cols}} for n, i in enumerate(idx)]


def _lambda_tables(abar: torch.Tensor):
    """Per-transition scalars shared by the log-SNR solvers. Transition j
    is grid point j -> j-1 (j-1 = -1 is the clean endpoint: alpha 1, sigma
    0); the endpoint tables are shifted copies, so e^{-h_0} = 0 and
    ratio_0 = 0 exactly, with no infinite lambda."""
    al = torch.sqrt(abar)
    sg = torch.sqrt(1.0 - abar)
    lam = torch.log(al / sg)
    al_t = torch.cat([torch.ones((1,), dtype=abar.dtype), al[:-1]])
    sg_t = torch.cat([torch.zeros((1,), dtype=abar.dtype), sg[:-1]])
    e_mh = (al * sg_t) / (sg * al_t)
    # a finite stand-in for h_0 = +inf; each use is masked or saturates
    h = torch.log(al_t / torch.clamp(sg_t, min=1e-30)) - lam
    ratio = sg_t / sg
    gain = al_t * (1.0 - e_mh)
    return al, sg, lam, h, e_mh, ratio, gain


def _multistep_c2(h: torch.Tensor) -> torch.Tensor:
    """h_j / (2 h_{j+1}) at the interior transitions, 0 at the first and
    last (first order there)."""
    M = h.shape[0]
    c2 = torch.zeros((M,), dtype=h.dtype)
    if M > 2:
        c2[1:M - 1] = h[1:M - 1] / (2.0 * h[2:M])
    return c2


def _zeros_like(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


@register_solver("dpm++", "dpmpp")
def _build_dpmpp_2m(abar: torch.Tensor) -> SolverProgram:
    """DPM-Solver++(2M), data-prediction form:
    x_{j-1} = (sigma_{j-1}/sigma_j) x_j + alpha_{j-1} (1 - e^{-h_j}) D_j,
    D_j = x0_j + (h_j / 2 h_{j+1}) (x0_j - x0_{j+1})."""
    _, _, _, h, _, ratio, gain = _lambda_tables(abar)
    steps = _loop_order({"ratio": ratio, "gain": gain, "c2": _multistep_c2(h)})

    def step(x, x0, s, prev_x0, noise):
        d = x0 + s["c2"] * (x0 - prev_x0)
        return s["ratio"] * x + s["gain"] * d, x0

    return SolverProgram(steps=steps, init_mem=_zeros_like, step=step)


@register_solver("sde-dpm++", "sde-dpmpp")
def _build_sde_dpmpp_2m(abar: torch.Tensor) -> SolverProgram:
    """SDE-DPM-Solver++(2M):
    x_{j-1} = (sigma_{j-1}/sigma_j) e^{-h_j} x_j + alpha_{j-1} (1 - e^{-2h_j}) D_j
              + sigma_{j-1} sqrt(1 - e^{-2h_j}) z."""
    al, sg, _, h, e_mh, ratio, _ = _lambda_tables(abar)
    al_t = torch.cat([torch.ones((1,), dtype=abar.dtype), al[:-1]])
    sg_t = torch.cat([torch.zeros((1,), dtype=abar.dtype), sg[:-1]])
    e_m2h = e_mh * e_mh
    steps = _loop_order({
        "ratio": ratio * e_mh,
        "gain": al_t * (1.0 - e_m2h),
        "nscale": sg_t * torch.sqrt(torch.clamp(1.0 - e_m2h, min=0.0)),
        "c2": _multistep_c2(h),
    })

    def step(x, x0, s, prev_x0, noise):
        d = x0 + s["c2"] * (x0 - prev_x0)
        return s["ratio"] * x + s["gain"] * d + s["nscale"] * noise, x0

    return SolverProgram(steps=steps, init_mem=_zeros_like, step=step, stochastic=True)


@register_solver("ancestral")
def _build_ancestral(abar: torch.Tensor) -> SolverProgram:
    """DDPM ancestral sampling (sigma_small) in x0-prediction form:
    x_{j-1} = c1_j x0_j + c2_j x_j + sqrt(var_j) z over the grid's betas
    beta_j = 1 - abar_j / abar_{j-1}."""
    abar_prev = torch.cat([torch.ones((1,), dtype=abar.dtype), abar[:-1]])
    beta = 1.0 - abar / abar_prev
    denom = torch.clamp(1.0 - abar, min=1e-20)
    c1 = torch.sqrt(abar_prev) * beta / denom
    c2 = torch.sqrt(torch.clamp(1.0 - beta, min=0.0)) * (1.0 - abar_prev) / denom
    var = beta * (1.0 - abar_prev) / denom
    steps = _loop_order({"c1": c1, "c2": c2, "nscale": torch.sqrt(var)})

    def step(x, x0, s, mem, noise):
        return s["c1"] * x0 + s["c2"] * x + s["nscale"] * noise, mem

    return SolverProgram(steps=steps, init_mem=_zeros_like, step=step, stochastic=True)


@register_solver("unipc")
def _build_unipc_bh2_p2(abar: torch.Tensor) -> SolverProgram:
    """UniPC-p2 / B2(h), one model evaluation a step: the predictor of
    transition j -> j-1 is x = ratio_j x_j + gain_j (x0_j + rho_p_j D1),
    and the next step's fresh x0 corrects the same transition with the
    endpoint difference D1_t = x0_{j-1} - x0_j. The order-2 predictor uses
    the exact coefficient b1 = (h phi_1 / hh - 1) / h phi_1."""
    M = abar.shape[0]
    _, _, lam, h, e_mh, ratio, gain = _lambda_tables(abar)
    h_phi_1 = e_mh - 1.0
    hh = -h
    k1 = h_phi_1 / hh - 1.0
    b1 = k1 / h_phi_1
    b2 = 2.0 * (k1 / hh - 0.5) / h_phi_1
    r1 = torch.full((M,), -1.0, dtype=abar.dtype)
    if M > 1:
        r1[:M - 1] = (lam[1:] - lam[:M - 1]) / h[:M - 1]
    use2 = torch.ones((M,), dtype=torch.float32)
    use2[0] = 0.0  # first order at the last transition
    use2[M - 1] = 0.0  # no history at the first
    on = use2 > 0
    zero = torch.zeros((), dtype=abar.dtype)
    invr1 = torch.where(on, 1.0 / r1, zero)
    rho_p = use2 * b1
    # the corrector's [[1, 1], [r1, 1]] rho = [b1, b2]; first order: [0, 1/2]
    rho1 = torch.where(on, (b2 - b1) / (r1 - 1.0), zero)
    rho2 = torch.where(on, b1 - rho1, torch.full((), 0.5, dtype=abar.dtype))

    def shift_prev(a, fill=0.0):
        """The previous transition's (j+1) value at step j."""
        a = torch.as_tensor(a, dtype=abar.dtype)
        return torch.cat([a[1:], torch.full((1,), fill, dtype=abar.dtype)])

    steps = _loop_order({
        "ratio": ratio, "gain": gain, "rho_p": rho_p, "invr1": invr1,
        "c_ratio": shift_prev(ratio), "c_gain": shift_prev(gain),
        "c_rho1": shift_prev(rho1), "c_rho2": shift_prev(rho2),
        "c_invr1": shift_prev(invr1), "use_c": shift_prev(torch.ones((M,))),
    })

    def init_mem(x):
        return (x, torch.zeros_like(x), torch.zeros_like(x))

    def step(x, x0, s, mem, noise):
        last_x, m_prev, m_prevprev = mem
        if s["use_c"] > 0:  # the corrector of transition j+1 -> j
            d1pp = (m_prevprev - m_prev) * s["c_invr1"]
            d1t = x0 - m_prev
            x = s["c_ratio"] * last_x + s["c_gain"] * (
                m_prev + s["c_rho1"] * d1pp + s["c_rho2"] * d1t)
        d1 = (m_prev - x0) * s["invr1"]
        x_new = s["ratio"] * x + s["gain"] * (x0 + s["rho_p"] * d1)
        return x_new, (x, x0, m_prev)

    return SolverProgram(steps=steps, init_mem=init_mem, step=step)
