"""Training state: everything a training step mutates, in one object.

Port of ``rho_diffusion_tpu/training/state.py``. The JAX TrainState is a
pytree {step, params, opt_state, ema_params, rng} donated to a jitted step;
here it holds the live objects the step updates in place:

* ``step``: the number of updates done (the JAX ``step``, and the count the
  LR schedule is evaluated at);
* ``model``: the backbone ``nn.Module`` whose fp32 parameters are trained;
* ``optimizer``: its ``torch.optim`` optimizer;
* ``ema``: the EMA shadow of every parameter, by ``state_dict`` name, or
  None when EMA is off;
* ``generator``: the ``torch.Generator`` the step draws timesteps, noise and
  conditioning-dropout masks from (on the model's device);
* ``mesh`` and ``replicas``: set by ``parallel.mesh.replicate_state`` for
  steps over a ("data", "context") mesh: the model's replica on each other
  device of the mesh. Under ZeRO-1, FSDP or tensor parallelism
  (``training.sharded``) ``optimizer`` is a ``ShardedOptimizer``, which
  also holds the split parameters' pieces (the model then holds
  placeholders: ``full_weights`` puts the whole ones in for a while), and
  ``ema`` a ``GridEMA``. Their checkpoint payloads are gathered, so a
  checkpoint is the same with and without them.

``state_dict()`` is the checkpoint payload: the backbone weights in the
reference layout (``params``), the optimizer state, the EMA weights, the
step and the generator state, so a resumed run continues exactly.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[dict[str, torch.Tensor]]
    generator: torch.Generator
    mesh: Optional[Any] = None
    replicas: dict = field(default_factory=dict)

    def full_weights(self):
        """A context inside which ``model`` holds its whole parameters (a
        sharded state gathers them from its pieces)."""
        materialized = getattr(self.optimizer, "materialized", None)
        return materialized(self.model) if materialized else contextlib.nullcontext(self.model)

    def state_dict(self) -> dict:
        params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        full_params = getattr(self.optimizer, "full_params", None)
        if full_params:
            params.update(full_params())
        return {
            "step": int(self.step),
            "params": params,
            "opt_state": self.optimizer.state_dict(),
            "ema_params": (None if self.ema is None
                           else {k: v.detach().clone() for k, v in self.ema.items()}),
            "rng": self.generator.get_state(),
        }

    def load_state_dict(self, payload: dict) -> None:
        self.step = int(payload["step"])
        load_params = getattr(self.optimizer, "load_params", None)
        if load_params:
            load_params(payload["params"])
        else:
            self.model.load_state_dict(payload["params"], strict=True)
        self.optimizer.load_state_dict(payload["opt_state"])
        if self.ema is not None:
            if payload.get("ema_params") is None:
                raise ValueError("the checkpoint has no EMA weights but this run keeps an EMA")
            if not isinstance(self.ema, dict):  # ZeRO-1's EMA splits what it reads
                self.ema.load(payload["ema_params"])
            else:
                with torch.no_grad():
                    for k, v in self.ema.items():
                        v.copy_(payload["ema_params"][k])
        self.generator.set_state(payload["rng"])

    def load_adam_moments(self, exp_avg: dict, exp_avg_sq: dict, count: int) -> None:
        """Set an Adam/AdamW optimizer's first and second moments (by
        parameter name) and its update count, e.g. from a JAX optax state."""
        device = next(self.model.parameters()).device
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(exp_avg[name], dtype=p.dtype, device=device).clone(),
                "exp_avg_sq": torch.as_tensor(exp_avg_sq[name], dtype=p.dtype,
                                              device=device).clone(),
            }
