"""Where ZeRO-1 and FSDP split a leaf over the data axis of a mesh.

Port of the leaf rule of ``rho_diffusion_tpu/parallel/mesh.py:120-163``
(``_shard_dim`` and its placer): the largest dim that divides by N, ties to
the trailing one, in the JAX package's layout of the weight, mapped to the
torch dim that holds it, so that rank d holds the elements JAX's rank d
holds. ``jax_layout_axes`` maps the layouts; ``zero1_dims`` names the dim
of every parameter. The split optimizer itself, for ZeRO-1 as for FSDP and
tensor parallelism, is ``training.sharded.ShardedOptimizer``.
"""
from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from rho_diffusion_tpu_torch.ops.convolution import Conv1x1, ConvNd
from rho_diffusion_tpu_torch.parallel.mesh import Mesh, _data_axis_placer


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
