"""Optimizer and LR-schedule factories with the JAX package's names and kwargs.

Port of ``rho_diffusion_tpu/training/optimizers.py``. There each name maps to
an optax transformation; here to a ``torch.optim`` optimizer whose update is
the same arithmetic:

* AdamW: ``optax.adamw`` (bias-corrected moments, eps outside the sqrt,
  decoupled weight decay 0.01 on the old parameters) is
  ``torch.optim.AdamW``; Adam is ``torch.optim.Adam``; SGD with optional
  (Nesterov) momentum is ``torch.optim.SGD`` (optax's trace starts at zero,
  torch's buffer at the first gradient: the same first step).
* Adamax, NAdam, RAdam, RMSprop, Adagrad, Adadelta, Adafactor, Lion, LAMB
  and LARS have torch counterparts whose arithmetic differs from optax's
  (RMSprop's eps outside the sqrt, Adagrad's accumulator starting at 0,
  NAdam's momentum decay, ...) or none at all. Each is a ``torch.optim``
  subclass here (``OptaxRule``) that computes optax 0.2.6's chain for the
  kwargs the JAX factory passes, with JAX's defaults (Lion's b2 0.999 and
  weight decay 0, LAMB's eps 1e-8, Adagrad's eps 1e-10, Adafactor's
  learning rate None). Its scalar coefficients (bias corrections, RAdam's
  rectification, Adafactor's decay rate) are float32, as in JAX.

Adafactor factors the second moment of a parameter whose second-largest
dimension is at least 128 over its two largest dimensions (optax's
``_factored_dims`` on the parameter's own shape). A torch conv or linear
weight is laid out [out, in, ...] where the JAX one is [..., in, out]; where
the two dimensions tie, the port's rows are JAX's columns, which gives the
same update up to rounding (each is g / sqrt(row * col / mean)).

LR schedules are plain functions of the update count, parameterised in
epochs like torch and converted with ``steps_per_epoch``, each the formula of
the optax schedule the JAX package builds. JAX evaluates ``schedule(count)``
with count = the updates so far (0 for the first), so the port sets every
param group's lr from ``Optimizer.lr(count)`` before each ``step()``.
torch's own ``CosineAnnealingLR`` restarts its cosine after T_max; the JAX
one holds at eta_min, and so does this one.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Iterable, Optional, Union

import numpy as np
import torch

from rho_diffusion_tpu_torch.registry import registry

Schedule = Callable[[int], float]


def _adam_args(kwargs: dict) -> dict:
    return {"betas": tuple(kwargs.get("betas", (0.9, 0.999))), "eps": kwargs.get("eps", 1e-8)}


def _lr(kwargs: dict, default: float = 1e-3):
    return kwargs.get("learning_rate", kwargs.get("lr", default))


class Optimizer:
    """A torch optimizer class, its kwargs and the learning rate (a constant
    or a schedule of the update count).

    ``fused`` (set before ``make``) makes the update one fused multi-tensor
    step over every parameter (``torch.optim``'s ``fused=True``): the port's
    counterpart of ``optax.flatten``, which runs the same per-element
    arithmetic over one flat vector. Only the torch classes that have a
    fused implementation (AdamW, Adam, SGD) take it."""

    def __init__(self, cls: type, learning_rate: Union[float, Schedule], **kwargs: Any) -> None:
        self.cls = cls
        self.learning_rate = learning_rate
        self.kwargs = kwargs
        self.clip_grad_norm: Optional[float] = None
        self.fused = False

    def lr(self, count: int) -> Optional[float]:
        """The learning rate of update ``count``; None for Adafactor
        without one (its updates are not scaled)."""
        lr = self.learning_rate
        if lr is None:
            return None
        return float(lr(count) if callable(lr) else lr)

    def make(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        if not self.fused:
            return self.cls(params, lr=self.lr(0), **self.kwargs)
        if self.cls not in (torch.optim.AdamW, torch.optim.Adam, torch.optim.SGD):
            raise ValueError(f"{self.cls.__name__} has no fused update; fused takes AdamW, "
                             "Adam or SGD")
        return self.cls(params, lr=self.lr(0), fused=True, **self.kwargs)

    def set_lr(self, opt: torch.optim.Optimizer, count: int) -> float:
        lr = self.lr(count)
        for group in opt.param_groups:
            group["lr"] = lr
        return lr


@registry.register_optimizer("AdamW")
def AdamW(**kwargs) -> Optimizer:
    return Optimizer(torch.optim.AdamW, _lr(kwargs), weight_decay=kwargs.get("weight_decay", 0.01),
                     **_adam_args(kwargs))


@registry.register_optimizer("Adam")
def Adam(**kwargs) -> Optimizer:
    return Optimizer(torch.optim.Adam, _lr(kwargs), **_adam_args(kwargs))


@registry.register_optimizer("SGD")
def SGD(**kwargs) -> Optimizer:
    momentum = kwargs.get("momentum") or 0.0
    return Optimizer(torch.optim.SGD, _lr(kwargs), momentum=momentum,
                     nesterov=bool(kwargs.get("nesterov", False)) and momentum > 0)


def _f32(x) -> torch.Tensor:
    """A float32 scalar on the CPU: the dtype optax's scalar arithmetic runs in."""
    return torch.tensor(x, dtype=torch.float32)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32 (optax.tree.bias_correction's divisor)."""
    return float(1 - _f32(decay) ** count)


def _trust_ratio(u: torch.Tensor, u_norm: torch.Tensor, p_norm: torch.Tensor,
                 coefficient: float = 1.0) -> torch.Tensor:
    """optax.scale_by_trust_ratio (min_norm 0, eps 0): u scaled by
    coefficient * |p| / |u|, or left as it is where either norm is 0. The
    norms are the whole leaf's (under ZeRO-1, over all of its shards)."""
    ratio = coefficient * p_norm / u_norm
    return u * torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)


class OptaxRule(torch.optim.Optimizer):
    """A ``torch.optim`` optimizer computing an optax chain parameter by
    parameter: ``init`` fills a parameter's state on its first step,
    ``update`` returns what optax's update adds to it (the sign included),
    given the update count (1 for the first step) and the group's
    hyper-parameters. The state holds the count under "count", as optax's
    does.

    A rule with ``trust_ratio`` scales its update by norms of the whole
    leaf: ``direction`` gives the update before the scaling and ``finish``
    applies it from the leaf's norms, which ZeRO-1 sums over the leaf's
    shards (``training/sharded.py``)."""

    trust_ratio = False

    def __init__(self, params, lr: Optional[float], **defaults: Any) -> None:
        super().__init__(params, {"lr": lr, **defaults})

    def begin(self, p: torch.Tensor, group: dict) -> tuple[dict, int]:
        """``p``'s state, initialised on its first step, and this update's
        count (1 for the first)."""
        state = self.state[p]
        if not state:
            state["count"] = 0
            self.init(p, state, group)
        state["count"] += 1
        return state, state["count"]

    def init(self, p: torch.Tensor, state: dict, group: dict) -> None:
        raise NotImplementedError

    def update(self, g: torch.Tensor, p: torch.Tensor, state: dict, group: dict,
               count: int) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state, count = self.begin(p, group)
                p.add_(self.update(p.grad, p, state, group, count))
        return loss


class TrustRatioRule(OptaxRule):
    """A rule whose update is ``finish`` of ``direction`` with the leaf's
    norms |direction| and |p|."""

    trust_ratio = True

    def direction(self, g, p, state, group, count) -> torch.Tensor:
        raise NotImplementedError

    def finish(self, u, p, state, group, u_norm, p_norm) -> torch.Tensor:
        raise NotImplementedError

    def update(self, g, p, state, group, count):
        u = self.direction(g, p, state, group, count)
        return self.finish(u, p, state, group, torch.linalg.vector_norm(u),
                           torch.linalg.vector_norm(p))


def _zeros(p: torch.Tensor, state: dict, *names: str) -> None:
    for name in names:
        state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)


class OptaxAdamax(OptaxRule):
    """optax.adamax: mu / (1 - b1^t) over the infinity norm max(|g| + eps,
    b2 nu)."""

    def __init__(self, params, lr=2e-3, betas=(0.9, 0.999), eps=1e-8) -> None:
        super().__init__(params, lr, betas=tuple(betas), eps=eps)

    def init(self, p, state, group):
        _zeros(p, state, "mu", "nu")

    def update(self, g, p, state, group, count):
        b1, b2 = group["betas"]
        mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        nu = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        state["nu"] = nu
        return -group["lr"] * (mu / _bias_correction(b1, count)) / nu


class OptaxAdam(OptaxRule):
    """optax.scale_by_adam, as NAdam (``nesterov``) and LAMB use it: the
    bias-corrected moments' ratio mu_hat / (sqrt(nu_hat) + eps)."""

    nesterov = False

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, **defaults) -> None:
        super().__init__(params, lr, betas=tuple(betas), eps=eps, **defaults)

    def init(self, p, state, group):
        _zeros(p, state, "mu", "nu")

    def moments(self, g, state, group, count):
        b1, b2 = group["betas"]
        mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        if self.nesterov:
            mu_hat = (b1 * (mu / _bias_correction(b1, count + 1))
                      + (1 - b1) * (g / _bias_correction(b1, count)))
        else:
            mu_hat = mu / _bias_correction(b1, count)
        return mu_hat, nu / _bias_correction(b2, count)

    def update(self, g, p, state, group, count):
        mu_hat, nu_hat = self.moments(g, state, group, count)
        return -group["lr"] * (mu_hat / (nu_hat.sqrt() + group["eps"]))


class OptaxNAdam(OptaxAdam):
    """optax.nadam: Adam with Nesterov momentum,
    b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)."""

    nesterov = True

    def __init__(self, params, lr=2e-3, betas=(0.9, 0.999), eps=1e-8) -> None:
        super().__init__(params, lr, betas, eps)


class OptaxRAdam(OptaxAdam):
    """optax.radam: the rectified Adam step where rho_t >= ``threshold``,
    the bias-corrected first moment alone before."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, threshold=5.0) -> None:
        super().__init__(params, lr, betas, eps, threshold=threshold)

    def update(self, g, p, state, group, count):
        b2 = group["betas"][1]
        mu_hat, nu_hat = self.moments(g, state, group, count)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _f32(b2) ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        if float(ro) < group["threshold"]:
            return -group["lr"] * mu_hat
        r = float(torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                             / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
        return -group["lr"] * (r * mu_hat / (nu_hat.sqrt() + group["eps"]))


class OptaxLAMB(TrustRatioRule, OptaxAdam):
    """optax.lamb: the Adam ratio plus weight decay, scaled by the trust
    ratio |p| / |update|."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0) -> None:
        OptaxAdam.__init__(self, params, lr, betas, eps, weight_decay=weight_decay)

    def direction(self, g, p, state, group, count):
        mu_hat, nu_hat = self.moments(g, state, group, count)
        return mu_hat / (nu_hat.sqrt() + group["eps"]) + group["weight_decay"] * p

    def finish(self, u, p, state, group, u_norm, p_norm):
        return -group["lr"] * _trust_ratio(u, u_norm, p_norm)


class OptaxRMSprop(OptaxRule):
    """optax.rmsprop (not centered): g / sqrt(nu + eps), then an optional
    momentum trace of the lr-scaled step."""

    def __init__(self, params, lr=1e-2, decay=0.99, eps=1e-8, momentum=None) -> None:
        super().__init__(params, lr, decay=decay, eps=eps, momentum=momentum)

    def init(self, p, state, group):
        _zeros(p, state, "nu", *(("trace",) if group["momentum"] is not None else ()))

    def update(self, g, p, state, group, count):
        d = group["decay"]
        nu = state["nu"].mul_(d).addcmul_(g, g, value=1 - d)
        u = -group["lr"] * (g * torch.rsqrt(nu + group["eps"]))
        if group["momentum"] is None:
            return u
        return state["trace"].mul_(group["momentum"]).add_(u).clone()


class OptaxAdagrad(OptaxRule):
    """optax.adagrad: the running sum of squares starts at 0.1; the step is
    g / sqrt(sum + eps)."""

    def __init__(self, params, lr=1e-2, eps=1e-7, initial_accumulator_value=0.1) -> None:
        super().__init__(params, lr, eps=eps, initial_accumulator_value=initial_accumulator_value)

    def init(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def update(self, g, p, state, group, count):
        acc = state["sum_of_squares"].addcmul_(g, g)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
        return -group["lr"] * (inv * g)


class OptaxAdadelta(OptaxRule):
    """optax.adadelta: sqrt(e_x + eps) / sqrt(e_g + eps) g, e_x the running
    mean of the squared steps."""

    def __init__(self, params, lr=1.0, rho=0.9, eps=1e-6) -> None:
        super().__init__(params, lr, rho=rho, eps=eps)

    def init(self, p, state, group):
        _zeros(p, state, "e_g", "e_x")

    def update(self, g, p, state, group, count):
        rho, eps = group["rho"], group["eps"]
        e_g = state["e_g"].mul_(rho).addcmul_(g, g, value=1 - rho)
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        state["e_x"].mul_(rho).addcmul_(u, u, value=1 - rho)
        return -group["lr"] * u


class OptaxLion(OptaxRule):
    """optax.lion: sign((1 - b1) g + b1 mu) plus weight decay; mu tracks g
    with b2."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99), weight_decay=1e-3) -> None:
        super().__init__(params, lr, betas=tuple(betas), weight_decay=weight_decay)

    def init(self, p, state, group):
        _zeros(p, state, "mu")

    def update(self, g, p, state, group, count):
        b1, b2 = group["betas"]
        u = torch.sign((1.0 - b1) * g + b1 * state["mu"])
        state["mu"].mul_(b2).add_(g, alpha=1 - b2)
        return -group["lr"] * (u + group["weight_decay"] * p)


class OptaxLARS(TrustRatioRule):
    """optax.lars: (g + weight decay) scaled by trust_coefficient |p| / |u|,
    the lr step fed to a momentum trace."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0, momentum=0.9, trust_coefficient=0.001,
                 nesterov=False) -> None:
        super().__init__(params, lr, weight_decay=weight_decay, momentum=momentum,
                         trust_coefficient=trust_coefficient, nesterov=nesterov)

    def init(self, p, state, group):
        _zeros(p, state, "trace")

    def direction(self, g, p, state, group, count):
        return g + group["weight_decay"] * p

    def finish(self, u, p, state, group, u_norm, p_norm):
        u = -group["lr"] * _trust_ratio(u, u_norm, p_norm, group["trust_coefficient"])
        trace = state["trace"].mul_(group["momentum"]).add_(u)
        return u + group["momentum"] * trace if group["nesterov"] else trace.clone()


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[tuple[int, int]]:
    """optax's: the two largest dimensions (second-largest first), when the
    second-largest has at least ``min_dim_size_to_factor`` entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class OptaxAdafactor(OptaxRule):
    """optax.adafactor: factored (or full) second moments decayed at
    1 - (t)^-decay_rate, the update clipped to block RMS ``clipping_threshold``,
    scaled by the lr when there is one, and by the parameter's RMS (at
    least 1e-3)."""

    def __init__(self, params, lr=None, min_dim_size_to_factor=128, decay_rate=0.8,
                 decay_offset=0, clipping_threshold=1.0, multiply_by_parameter_scale=True,
                 eps=1e-30) -> None:
        super().__init__(params, lr, min_dim_size_to_factor=min_dim_size_to_factor,
                         decay_rate=decay_rate, decay_offset=decay_offset,
                         clipping_threshold=clipping_threshold,
                         multiply_by_parameter_scale=multiply_by_parameter_scale, eps=eps)

    def init(self, p, state, group):
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            _zeros(p, state, "v")
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros_like(p.select(d0, 0))
            state["v_col"] = torch.zeros_like(p.select(d1, 0))

    def update(self, g, p, state, group, count):
        decay = float(1.0 - _f32(count - group["decay_offset"]) ** -group["decay_rate"])
        g_sq = g * g + group["eps"]
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is None:
            v = state["v"].mul_(decay).add_(g_sq, alpha=1.0 - decay)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(g_sq.mean(dim=d0), alpha=1.0 - decay)
            v_col = state["v_col"].mul_(decay).add_(g_sq.mean(dim=d1), alpha=1.0 - decay)
            row_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = (g * ((v_row / row_mean) ** -0.5).unsqueeze(d0)
                 * (v_col ** -0.5).unsqueeze(d1))
        if group["clipping_threshold"] is not None:
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / group["clipping_threshold"], min=1.0)
        if group["lr"] is not None:
            u = u * group["lr"]
        if group["multiply_by_parameter_scale"]:
            rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.clamp(rms, min=1e-3)
        return -u


@registry.register_optimizer("Adamax")
def Adamax(**kwargs) -> Optimizer:
    return Optimizer(OptaxAdamax, _lr(kwargs, 2e-3), **_adam_args(kwargs))


@registry.register_optimizer("NAdam")
def NAdam(**kwargs) -> Optimizer:
    return Optimizer(OptaxNAdam, _lr(kwargs, 2e-3), **_adam_args(kwargs))


@registry.register_optimizer("RAdam")
def RAdam(**kwargs) -> Optimizer:
    return Optimizer(OptaxRAdam, _lr(kwargs), **_adam_args(kwargs))


@registry.register_optimizer("RMSprop")
def RMSprop(**kwargs) -> Optimizer:
    return Optimizer(OptaxRMSprop, _lr(kwargs, 1e-2), decay=kwargs.get("alpha", 0.99),
                     eps=kwargs.get("eps", 1e-8), momentum=kwargs.get("momentum", 0.0) or None)


@registry.register_optimizer("Adagrad")
def Adagrad(**kwargs) -> Optimizer:
    return Optimizer(OptaxAdagrad, _lr(kwargs, 1e-2), eps=kwargs.get("eps", 1e-10))


@registry.register_optimizer("Adadelta")
def Adadelta(**kwargs) -> Optimizer:
    return Optimizer(OptaxAdadelta, _lr(kwargs, 1.0), rho=kwargs.get("rho", 0.9),
                     eps=kwargs.get("eps", 1e-6))


@registry.register_optimizer("Adafactor")
def Adafactor(**kwargs) -> Optimizer:
    return Optimizer(OptaxAdafactor, _lr(kwargs, None))


@registry.register_optimizer("Lion")
def Lion(**kwargs) -> Optimizer:
    return Optimizer(OptaxLion, _lr(kwargs, 1e-4), weight_decay=kwargs.get("weight_decay", 0.0),
                     betas=_adam_args(kwargs)["betas"])


@registry.register_optimizer("LAMB")
def LAMB(**kwargs) -> Optimizer:
    return Optimizer(OptaxLAMB, _lr(kwargs), weight_decay=kwargs.get("weight_decay", 0.0),
                     **_adam_args(kwargs))


@registry.register_optimizer("LARS")
def LARS(**kwargs) -> Optimizer:
    return Optimizer(OptaxLARS, _lr(kwargs), weight_decay=kwargs.get("weight_decay", 0.0),
                     momentum=kwargs.get("momentum", 0.9))


# ---------------------------------------------------------------------------
# LR schedules (torch-named, epoch-parameterised)
# ---------------------------------------------------------------------------

def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)

    return schedule


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule (and linear_schedule, power 1)."""
    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def warmup_cosine_decay(init: float, peak: float, warmup_steps: int, decay_steps: int,
                        end: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from ``init`` to ``peak``
    over ``warmup_steps``, then cosine decay to ``end`` by ``decay_steps``."""
    warmup = _polynomial(init, peak, 1.0, warmup_steps)
    decay = _cosine(peak, decay_steps - warmup_steps, end / peak if peak else 0.0)

    def schedule(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def _staircase(init: float, steps: int, rate: float) -> Schedule:
    """optax.exponential_decay(staircase=True)."""
    def schedule(count: int) -> float:
        return init if count <= 0 else init * rate ** math.floor(count / steps)

    return schedule


@registry.register_lr_scheduler("CosineAnnealingLR")
def CosineAnnealingLR(base_lr: float, steps_per_epoch: int, T_max: int, eta_min: float = 0.0,
                      **_: Any) -> Schedule:
    """Cosine annealing over T_max epochs down to eta_min, then flat."""
    alpha = eta_min / base_lr if base_lr > 0 else 0.0
    return _cosine(base_lr, max(int(T_max * steps_per_epoch), 1), alpha)


@registry.register_lr_scheduler("StepLR")
def StepLR(base_lr: float, steps_per_epoch: int, step_size: int, gamma: float = 0.1,
           **_: Any) -> Schedule:
    return _staircase(base_lr, max(int(step_size * steps_per_epoch), 1), gamma)


@registry.register_lr_scheduler("ExponentialLR")
def ExponentialLR(base_lr: float, steps_per_epoch: int, gamma: float = 0.95,
                  **_: Any) -> Schedule:
    return _staircase(base_lr, max(int(steps_per_epoch), 1), gamma)


@registry.register_lr_scheduler("LinearLR")
def LinearLR(base_lr: float, steps_per_epoch: int, start_factor: float = 1.0 / 3.0,
             end_factor: float = 1.0, total_iters: int = 5, **_: Any) -> Schedule:
    return _polynomial(base_lr * start_factor, base_lr * end_factor, 1,
                       max(int(total_iters * steps_per_epoch), 1))


@registry.register_lr_scheduler("MultiStepLR")
def MultiStepLR(base_lr: float, steps_per_epoch: int, milestones: list, gamma: float = 0.1,
                **_: Any) -> Schedule:
    """Multiply by gamma at each milestone epoch; milestones that land on
    one step compound as gamma**count."""
    counts = Counter(int(m * steps_per_epoch) for m in milestones)

    def schedule(count: int) -> float:
        v = base_lr
        for step, n in sorted(counts.items()):
            if count >= step:
                v = v * gamma**n
        return v

    return schedule


@registry.register_lr_scheduler("ConstantLR")
def ConstantLR(base_lr: float, steps_per_epoch: int, factor: float = 1.0 / 3.0,
               total_iters: int = 5, **_: Any) -> Schedule:
    """base_lr * factor for total_iters epochs, then base_lr."""
    switch = max(int(total_iters * steps_per_epoch), 1)
    return lambda count: base_lr * factor if count < switch else base_lr


@registry.register_lr_scheduler("PolynomialLR")
def PolynomialLR(base_lr: float, steps_per_epoch: int, total_iters: int = 5, power: float = 1.0,
                 **_: Any) -> Schedule:
    return _polynomial(base_lr, 0.0, power, max(int(total_iters * steps_per_epoch), 1))


@registry.register_lr_scheduler("CosineAnnealingWarmRestarts")
def CosineAnnealingWarmRestarts(base_lr: float, steps_per_epoch: int, T_0: int, T_mult: int = 1,
                                eta_min: float = 0.0, **_: Any) -> Schedule:
    """SGDR: cosine periods of T_0, T_0*T_mult, ... epochs, restarting
    indefinitely."""
    period = max(int(T_0 * steps_per_epoch), 1)
    mult = max(int(T_mult), 1)

    def schedule(count: int) -> float:
        if mult == 1:
            t_cur, t_i = count % period, period
        else:
            n = math.floor(math.log(count / period * (mult - 1) + 1.0) / math.log(mult))
            start = period * (mult**n - 1) / (mult - 1)
            if count - start >= period * mult**n:  # rounding landed a cycle low
                n += 1
                start = period * (mult**n - 1) / (mult - 1)
            t_cur, t_i = count - start, period * mult**n
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


@registry.register_lr_scheduler("OneCycleLR")
def OneCycleLR(base_lr: float, steps_per_epoch: int, max_lr: float, total_steps: int = 0,
               epochs: int = 0, pct_start: float = 0.3, div_factor: float = 25.0,
               final_div_factor: float = 1e4, **_: Any) -> Schedule:
    """Linear warm-up to max_lr, then cosine annealing."""
    total = int(total_steps) or max(int(epochs * steps_per_epoch), 1)
    up = max(int(total * pct_start), 1)
    init = max_lr / div_factor
    final = init / final_div_factor
    warm = _polynomial(init, max_lr, 1, up)
    down = _cosine(max_lr, max(total - up, 1), final / max_lr)
    return lambda count: warm(count) if count < up else down(count - up)


def build_lr_schedule(name: Optional[str], base_lr: float, steps_per_epoch: int,
                      kwargs: Optional[dict] = None) -> Union[float, Schedule]:
    """An lr_scheduler config entry as a schedule, or the constant base_lr
    when none is configured."""
    if not name:
        return base_lr
    factory = registry.get("lr_schedulers", name)
    return factory(base_lr=base_lr, steps_per_epoch=steps_per_epoch, **(kwargs or {}))


def build_optimizer(name: Optional[str], opt_kwargs: Optional[dict] = None,
                    learning_rate: Optional[Any] = None, world_size: int = 1,
                    clip_grad_norm: Optional[float] = None) -> Optimizer:
    """The optimizer a config names. An explicit lr (or schedule) is scaled
    by sqrt(world_size), as the reference does for data-parallel training;
    an lr left to the optimizer's default is not. ``clip_grad_norm`` clips
    the gradients' global norm before the update."""
    opt_kwargs = dict(opt_kwargs or {})
    name = name or "AdamW"
    if learning_rate is not None:
        opt_kwargs["learning_rate"] = learning_rate
        opt_kwargs.pop("lr", None)
    scale = math.sqrt(world_size)
    lr = opt_kwargs.get("learning_rate", opt_kwargs.get("lr"))
    if scale != 1.0 and lr is not None:
        opt_kwargs.pop("lr", None)
        opt_kwargs["learning_rate"] = (lambda c, base=lr: base(c) * scale) if callable(lr) \
            else lr * scale
    opt = registry.get("optimizers", name)(**opt_kwargs)
    opt.clip_grad_norm = clip_grad_norm
    return opt
