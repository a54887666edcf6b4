"""Optimizer and LR-schedule factories with the JAX package's names and kwargs.

Port of ``rho_diffusion_tpu/training/optimizers.py``. There each name maps to
an optax transformation; here to a ``torch.optim`` optimizer whose update is
the same arithmetic:

* AdamW: ``optax.adamw`` (bias-corrected moments, eps outside the sqrt,
  decoupled weight decay 0.01 on the old parameters) is
  ``torch.optim.AdamW``; Adam is ``torch.optim.Adam``; SGD with optional
  (Nesterov) momentum is ``torch.optim.SGD`` (optax's trace starts at zero,
  torch's buffer at the first gradient: the same first step).
* The other names the JAX package registers (Adamax, NAdam, RAdam, RMSprop,
  Adagrad, Adadelta, Adafactor, Lion, LAMB, LARS) have torch counterparts
  whose arithmetic differs from optax's or none at all, and raise
  ``NotImplementedError``.

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

import torch

from rho_diffusion_tpu_torch.registry import registry

Schedule = Callable[[int], float]
_UNPORTED = ("is not ported: its torch counterpart does not compute optax's update "
             "(ROADMAP Queue 1, interop and training utilities)")


def _adam_args(kwargs: dict) -> dict:
    return {"betas": tuple(kwargs.get("betas", (0.9, 0.999))), "eps": kwargs.get("eps", 1e-8)}


def _lr(kwargs: dict, default: float = 1e-3):
    return kwargs.get("learning_rate", kwargs.get("lr", default))


class Optimizer:
    """A torch optimizer class, its kwargs and the learning rate (a constant
    or a schedule of the update count)."""

    def __init__(self, cls: type, learning_rate: Union[float, Schedule], **kwargs: Any) -> None:
        self.cls = cls
        self.learning_rate = learning_rate
        self.kwargs = kwargs
        self.clip_grad_norm: Optional[float] = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def make(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.cls(params, lr=self.lr(0), **self.kwargs)

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


def _unported(name: str) -> Callable[..., Optimizer]:
    def factory(**_kwargs) -> Optimizer:
        raise NotImplementedError(f"optimizer '{name}' {_UNPORTED}")

    factory.__name__ = name
    return factory


for _name in ("Adamax", "NAdam", "RAdam", "RMSprop", "Adagrad", "Adadelta", "Adafactor", "Lion",
              "LAMB", "LARS"):
    registry.add("optimizers", _name, _unported(_name))


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
