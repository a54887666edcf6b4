"""Tensor parallelism: every large weight split by output channel over the
"context" axis.

Port of ``rho_diffusion_tpu/parallel/tensor.py`` (:26-63). JAX places each
kernel with its trailing (output-channel) dim over "context" and GSPMD
partitions the convs and matmuls. Here the state's pieces are cut by
``training.sharded`` (``shard_params_for_tp``): a leaf of at least two dims
(in JAX's layout) whose trailing dim divides by the context size and is at
least ``min_dim`` has piece c, its c-th block of output channels, on
context rank c's device; the parameters, their optimizer state and the EMA
alike.

In a step the module holding such a weight runs its own forward once per
context rank (``training.sharded.column_forward``): that rank's output
channels on its device from the whole input, by the layer's own route (K5,
the direct conv, the matmul, the embedding lookup), with that rank's block
of the bias, concatenated on the last dim on the input's device. The
copies to and from the ranks' devices are autograd's, so the backward
gives each piece its gradient on its device and sums the input's gradient
over the ranks.
"""
from __future__ import annotations

from torch import nn

from rho_diffusion_tpu_torch.parallel.mesh import CONTEXT_AXIS, Mesh


def tp_spec_for(path_leaf_shape: tuple, axis: str, axis_size: int, min_dim: int) -> tuple:
    """The spec of one leaf of JAX's layout (JAX :26-33): the trailing
    (output-channel) dim over ``axis`` when it divides and is large enough,
    else () (replicated)."""
    if len(path_leaf_shape) >= 2:
        out_dim = path_leaf_shape[-1]
        if out_dim % axis_size == 0 and out_dim >= min_dim:
            return (*((None,) * (len(path_leaf_shape) - 1)), axis)
    return ()


def tp_dims(model: nn.Module, mesh: Mesh, min_dim: int = 64) -> dict:
    """Per parameter name, the torch dim TP splits over "context", or None."""
    from rho_diffusion_tpu_torch.training.zero1 import jax_layout_axes

    size = mesh.shape[CONTEXT_AXIS]
    out = {}
    for mname, module in model.named_modules():
        for attr, p in module.named_parameters(recurse=False):
            axes = jax_layout_axes(module, attr, p)
            spec = tp_spec_for(tuple(p.shape[a] for a in axes), CONTEXT_AXIS, size, min_dim)
            out[f"{mname}.{attr}" if mname else attr] = axes[-1] if spec else None
    return out


def shard_params_for_tp(state, mesh: Mesh, axis: str = CONTEXT_AXIS, min_dim: int = 64):
    """Split every large weight of ``state`` (a ``TrainState``) by output
    channel over ``axis`` (JAX :36-52): the parameters, their optimizer
    state and the EMA; whatever ZeRO-1 or FSDP sharding the state has is
    kept, composed with it. Returns the state."""
    from rho_diffusion_tpu_torch.training.sharded import shard_state, sharding_of

    if axis != CONTEXT_AXIS:
        raise ValueError(f"tensor parallelism runs over {CONTEXT_AXIS!r}, not {axis!r}")
    options = sharding_of(state)
    options["tp_min_dim"] = min_dim
    return shard_state(state, mesh, **options)


def tp_sharding_summary(state) -> dict[str, int]:
    """Count the parameters split over a mesh axis against the replicated
    ones (JAX :55-63, over the parameters of a ``TrainState``)."""
    from rho_diffusion_tpu_torch.training.sharded import ShardedOptimizer

    opt = state.optimizer
    if not isinstance(opt, ShardedOptimizer):
        return {"sharded": 0, "replicated": sum(1 for _ in state.model.parameters())}
    sharded = sum(leaf.split for leaf in opt.leaves)
    return {"sharded": sharded, "replicated": len(opt.leaves) - sharded}
