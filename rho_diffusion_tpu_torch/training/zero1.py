"""ZeRO-1 over the data axis of a mesh: the optimizer state and the EMA
split 1/N.

Port of ``rho_diffusion_tpu/parallel/mesh.py:144-168``
(``shard_opt_state_zero1``). In JAX the opt-state leaves carry a
``NamedSharding`` over "data" and GSPMD computes the update on the shards
and all-gathers the parameter deltas. Here, for each data rank d:

* every leaf that splits (``parallel.mesh._data_axis_placer``: the largest
  dim that divides by N, ties to the trailing one, in the JAX package's
  layout of the weight, mapped to the torch dim that holds it) has its 1/N
  slice on rank d's device: a copy of the parameter slice, the gradient's
  slice, and the optimizer state (moments) of that slice, in an optimizer
  of rank d's own, which updates it there;
* the updated slices are then copied into the parameters (the gather),
  from which every replica is refreshed;
* leaves too small to split keep one optimizer state, beside the first
  rank's parameters, and update once (JAX keeps them replicated and
  computes the same update on every device);
* the EMA (``ShardedEMA``) is split the same way: rank d's slice moves
  toward rank d's updated parameter slice.

The update of a slice is the slice of the update for the elementwise rules
(AdamW, Adam, SGD, and the optax rules but two). LAMB and LARS scale the
update by norms of the whole leaf: their slices' norms are summed over the
leaf's shards before any slice is updated. Adafactor's factored moments
read whole rows and columns of a leaf and are not split (it raises).

``state_dict`` gathers every slice into the layout of the unsharded
optimizer over the model's parameters, and ``load_state_dict`` splits it
again, so a checkpoint moves between a ZeRO-1 run and a plain one.
"""
from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from rho_diffusion_tpu_torch.ops.convolution import Conv1x1, ConvNd
from rho_diffusion_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, _data_axis_placer
from rho_diffusion_tpu_torch.training.ema import ema_decay_at
from rho_diffusion_tpu_torch.training.optimizers import OptaxAdafactor


def jax_layout_axes(module: nn.Module, name: str, param: torch.Tensor) -> tuple[int, ...]:
    """The torch dims of ``param`` (``module``'s parameter ``name``) in the
    order of the JAX package's layout of the same weight: a conv's flax
    kernel [*K, Cin, Cout] is [Cout, Cin, *K] here, a Dense kernel [in, out]
    is a linear's [out, in] or a 1x1 conv's [out, in, 1, ...]; every other
    parameter has the same layout in both."""
    if name != "weight" or param.ndim < 2:
        return tuple(range(param.ndim))
    if isinstance(module, (Conv1x1, nn.Linear)):
        return (1, 0)
    if isinstance(module, (ConvNd, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return (*range(2, param.ndim), 1, 0)
    return tuple(range(param.ndim))


def zero1_dims(model: nn.Module, mesh: Mesh) -> dict[str, Optional[int]]:
    """Per parameter name, the torch dim that ZeRO-1 splits over the data
    axis of ``mesh``, or None for a leaf that stays whole."""
    place = _data_axis_placer(mesh)
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = place(p, jax_layout_axes(m, pname, p))
    return out


def _constructor_kwargs(opt: torch.optim.Optimizer) -> dict:
    """The hyper-parameters to build another optimizer of ``opt``'s class."""
    accepted = inspect.signature(type(opt).__init__).parameters
    group = opt.param_groups[0]
    return {k: group.get(k, v) for k, v in opt.defaults.items() if k in accepted and k != "params"}


class Zero1Optimizer:
    """The optimizer of a state under ZeRO-1 (module docstring). It stands
    where a ``torch.optim`` optimizer stands: ``step``, ``param_groups``
    (whose lr the pipeline sets each step), ``state`` (gathered),
    ``state_dict`` and ``load_state_dict``."""

    def __init__(self, cls: type, kwargs: dict, model: nn.Module, mesh: Mesh) -> None:
        if issubclass(cls, OptaxAdafactor):
            raise NotImplementedError(
                "ZeRO-1 with Adafactor: its factored second moments read whole rows and columns "
                "of a leaf, which a 1/N slice does not hold",
            )
        self.mesh = mesh
        self.n = mesh.shape[DATA_AXIS]
        self.devices = [row[0] for row in mesh.devices]
        self.params = list(model.parameters())
        dims = zero1_dims(model, mesh)
        named = list(model.named_parameters())
        self.sharded = [(p, dims[k]) for k, p in named if dims[k] is not None]
        self.whole = [p for k, p in named if dims[k] is None]
        self.names = {p: k for k, p in named}
        self.shards = [[nn.Parameter(self._slice(p, dim, d).clone()) for p, dim in self.sharded]
                       for d in range(self.n)]
        self.rank_opts = [cls(s, **kwargs) for s in self.shards] if self.sharded else []
        self.whole_opt = cls(self.whole, **kwargs) if self.whole else None
        # never stepped: the unsharded optimizer whose state_dict layout this one writes
        self.template = cls(self.params, **kwargs)

    @classmethod
    def from_optimizer(cls, opt, model: nn.Module, mesh: Mesh) -> "Zero1Optimizer":
        """ZeRO-1 over ``mesh`` of ``opt`` (a plain optimizer of ``model``'s
        parameters, or a ZeRO-1 one), its state carried over."""
        if isinstance(opt, Zero1Optimizer):
            opt = opt.unsharded()
        zero = cls(type(opt), _constructor_kwargs(opt), model, mesh)
        zero._split_from(opt.state)
        return zero

    # -- slices ---------------------------------------------------------
    def _slice(self, t: torch.Tensor, dim: int, d: int) -> torch.Tensor:
        size = t.shape[dim] // self.n
        return t.detach().narrow(dim, d * size, size).to(self.devices[d])

    def _split_from(self, states: Mapping) -> None:
        """Split the per-parameter ``states`` (keyed by the model's
        parameters, unsharded) into the ranks' optimizers."""
        for d, opt in enumerate(self.rank_opts):
            opt.state.clear()
            for (p, dim), sh in zip(self.sharded, self.shards[d]):
                st = states.get(p)
                if st:
                    opt.state[sh] = {
                        k: (self._slice(v, dim, d).clone()
                            if isinstance(v, torch.Tensor) and v.shape == p.shape
                            else v.clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in st.items()}
        if self.whole_opt is not None:
            self.whole_opt.state.clear()
            for p in self.whole:
                st = states.get(p)
                if st:
                    self.whole_opt.state[p] = {
                        k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}

    def _gathered(self, p: torch.Tensor, dim: int, i: int) -> dict:
        states = [opt.state.get(self.shards[d][i]) for d, opt in enumerate(self.rank_opts)]
        if not states[0]:
            return {}
        out = {}
        for k, v in states[0].items():
            if isinstance(v, torch.Tensor) and v.shape == self.shards[0][i].shape:
                out[k] = torch.cat([s[k].to(p.device) for s in states], dim=dim)
            else:
                out[k] = v.clone() if isinstance(v, torch.Tensor) else v
        return out

    @property
    def state(self) -> dict:
        """Every parameter's optimizer state, gathered (keyed by parameter)."""
        out = {p: self._gathered(p, dim, i) for i, (p, dim) in enumerate(self.sharded)}
        if self.whole_opt is not None:
            out.update({p: self.whole_opt.state[p] for p in self.whole if p in self.whole_opt.state})
        return {p: st for p, st in out.items() if st}

    def shard_state(self, d: int) -> dict:
        """Rank ``d``'s optimizer state by parameter name (its slices)."""
        if not self.rank_opts:
            return {}
        opt = self.rank_opts[d]
        return {self.names[p]: opt.state[sh] for (p, _), sh in zip(self.sharded, self.shards[d])
                if sh in opt.state}

    @property
    def param_groups(self) -> list:
        return [g for opt in (*self.rank_opts, self.whole_opt) if opt is not None
                for g in opt.param_groups]

    # -- the update -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """Update every rank's slices from the parameters' (summed) gradients,
        then copy the updated slices into the parameters."""
        for d in range(len(self.rank_opts)):
            for (p, dim), sh in zip(self.sharded, self.shards[d]):
                sh.copy_(self._slice(p, dim, d))
                sh.grad = None if p.grad is None else self._slice(p.grad, dim, d).contiguous()
        if self.rank_opts:
            if getattr(self.rank_opts[0], "trust_ratio", False):
                self._trust_ratio_step()
            else:
                for opt in self.rank_opts:
                    opt.step()
        if self.whole_opt is not None:
            self.whole_opt.step()
        for d in range(len(self.rank_opts)):
            for (p, dim), sh in zip(self.sharded, self.shards[d]):
                size = p.shape[dim] // self.n
                p.narrow(dim, d * size, size).copy_(sh.to(p.device))
                sh.grad = None

    def _trust_ratio_step(self) -> None:
        """LAMB and LARS: each slice's update direction, then the leaf's
        norms summed over its slices, then every slice's step."""
        first = self.devices[0]
        for i in range(len(self.sharded)):
            parts = []
            for d, opt in enumerate(self.rank_opts):
                sh = self.shards[d][i]
                if sh.grad is None:
                    continue
                group = opt.param_groups[0]
                state, count = opt.begin(sh, group)
                parts.append((opt, sh, state, group, opt.direction(sh.grad, sh, state, group, count)))
            if not parts:
                continue
            u_norm = torch.sqrt(sum(torch.linalg.vector_norm(u).square().to(first)
                                    for *_, u in parts))
            p_norm = torch.sqrt(sum(torch.linalg.vector_norm(sh).square().to(first)
                                    for _, sh, *_ in parts))
            for opt, sh, state, group, u in parts:
                sh.add_(opt.finish(u, sh, state, group, u_norm.to(sh.device),
                                   p_norm.to(sh.device)))

    # -- checkpoints ----------------------------------------------------
    def unsharded(self) -> torch.optim.Optimizer:
        """The equivalent plain optimizer over the model's parameters."""
        opt = self.template
        opt.state.clear()
        for p, st in self.state.items():
            opt.state[p] = st
        lr = self.param_groups[0]["lr"]
        for g in opt.param_groups:
            g["lr"] = lr
        return opt

    def state_dict(self) -> dict:
        """The unsharded optimizer's ``state_dict``: every slice gathered."""
        sd = self.unsharded().state_dict()
        self.template.state.clear()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Load an unsharded optimizer's ``state_dict`` and split it."""
        self.template.load_state_dict(sd)
        self._split_from(self.template.state)
        lr = self.template.param_groups[0]["lr"]
        for g in self.param_groups:
            g["lr"] = lr
        self.template.state.clear()


class ShardedEMA(Mapping):
    """The EMA under ZeRO-1: rank d keeps the EMA of its slices of the leaves
    that split, on its device; the whole leaves' EMA stays beside the first
    rank's parameters. Reading a name gathers its slices; ``update`` is
    ``ema.ema_update`` slice by slice."""

    def __init__(self, ema: Mapping, zero: Zero1Optimizer) -> None:
        self.zero = zero
        self.names = [zero.names[p] for p in zero.params]
        self._dims = {zero.names[p]: dim for p, dim in zero.sharded}
        self.slices: list[dict] = [{} for _ in range(zero.n)]
        self.whole: dict = {}
        self.load(ema)

    def load(self, ema: Mapping) -> None:
        for name in self.names:
            full = ema[name].detach()
            dim = self._dims.get(name)
            if dim is None:
                self.whole[name] = full.to(self.zero.devices[0]).clone()
            else:
                for d in range(self.zero.n):
                    self.slices[d][name] = self.zero._slice(full, dim, d).clone()

    def __getitem__(self, name: str) -> torch.Tensor:
        dim = self._dims.get(name)
        if dim is None:
            return self.whole[name]
        first = self.zero.devices[0]
        return torch.cat([s[name].to(first) for s in self.slices], dim=dim)

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    @torch.no_grad()
    def update(self, step: int, decay: float) -> None:
        """One EMA step toward the updated parameters (each rank toward its
        own slices)."""
        weight = float(np.float32(1.0) - np.float32(ema_decay_at(step, decay)))
        zero = self.zero
        for d in range(len(zero.rank_opts)):
            names = [zero.names[p] for p, _ in zero.sharded]
            torch._foreach_lerp_([self.slices[d][k] for k in names],
                                 [sh.detach() for sh in zero.shards[d]], weight)
        if self.whole:
            keys = list(self.whole)
            params = {zero.names[p]: p for p in zero.whole}
            torch._foreach_lerp_([self.whole[k] for k in keys],
                                 [params[k].detach() for k in keys], weight)
