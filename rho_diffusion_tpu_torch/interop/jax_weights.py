"""Carry weights from the JAX package into the port.

The port's UNet uses the reference torch UNetv2 ``state_dict`` layout, so
JAX parameters reach it through the mapping the JAX package already ships
and tests, ``export_unet_state_dict`` (rho_diffusion_tpu/interop/
torch_weights.py). This module is the port's own copy of that mapping (pure
numpy), taking the JAX params as a nested dict of numpy arrays, plus a
loader for the JAX package's ``.npz`` weight files, whose keys are
``jax.tree_util.keystr`` paths such as ``['enc_res_0_0']['conv_in']['kernel']``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")

# model kwargs that shape the state_dict enumeration
ARCH_KEYS = (
    "dims", "model_channels", "num_res_blocks", "channel_mult",
    "attention_resolutions", "conv_resample", "resblock_updown",
    "num_heads", "num_head_channels", "num_heads_upsample",
    "use_new_attention_order",
)


def _torch_conv(kernel: np.ndarray) -> np.ndarray:
    """flax conv kernel [*K, I, O] -> torch [O, I, *K]."""
    k = np.asarray(kernel)
    spatial = list(range(k.ndim - 2))
    return np.transpose(k, (k.ndim - 1, k.ndim - 2, *spatial))


def _torch_linear(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (1, 0))


def _torch_conv1x1(kernel: np.ndarray, dims: int) -> np.ndarray:
    """flax Dense kernel [I, O] -> torch 1x1 conv_nd weight [O, I, 1*dims]."""
    k = np.asarray(kernel)
    return np.transpose(k, (1, 0)).reshape(k.shape[1], k.shape[0], *([1] * dims))


class _Out:
    """state_dict writer that refuses duplicate keys."""

    def __init__(self) -> None:
        self.sd: dict[str, np.ndarray] = {}

    def __setitem__(self, key: str, value: np.ndarray) -> None:
        if key in self.sd:
            raise ValueError(f"duplicate export key '{key}'")
        self.sd[key] = np.asarray(value)


def _export_groupnorm(out: _Out, prefix: str, p: dict) -> None:
    gn = p["GroupNorm_0"]
    out[f"{prefix}.weight"] = gn["scale"]
    out[f"{prefix}.bias"] = gn["bias"]


def _export_resblock(out: _Out, prefix: str, p: dict, dims: int) -> None:
    _export_groupnorm(out, f"{prefix}.in_layers.0", p["norm_in"])
    out[f"{prefix}.in_layers.2.weight"] = _torch_conv(p["conv_in"]["kernel"])
    out[f"{prefix}.in_layers.2.bias"] = p["conv_in"]["bias"]
    out[f"{prefix}.emb_layers.1.weight"] = _torch_linear(p["emb_proj"]["kernel"])
    out[f"{prefix}.emb_layers.1.bias"] = p["emb_proj"]["bias"]
    _export_groupnorm(out, f"{prefix}.out_layers.0", p["norm_out"])
    out[f"{prefix}.out_layers.3.weight"] = _torch_conv(p["conv_out"]["kernel"])
    out[f"{prefix}.out_layers.3.bias"] = p["conv_out"]["bias"]
    if "skip" in p:
        out[f"{prefix}.skip_connection.weight"] = _torch_conv1x1(p["skip"]["kernel"], dims)
        out[f"{prefix}.skip_connection.bias"] = p["skip"]["bias"]


def _export_attnblock(
    out: _Out, prefix: str, p: dict, num_heads: int, new_order: bool,
) -> None:
    """JAX qkv (legacy per-head [q|k|v] channel blocks) to the reference's
    1x1-conv qkv, permuted to the [3, H, D] "new order" when the
    architecture uses it. qkv/proj_out are Conv1d-shaped for every dims."""
    qkv_w = _torch_conv1x1(p["qkv"]["kernel"], 1)
    qkv_b = np.asarray(p["qkv"]["bias"])
    if new_order:
        three_c = qkv_w.shape[0]
        d = three_c // (3 * num_heads)
        perm = np.arange(three_c).reshape(num_heads, 3, d).transpose(1, 0, 2).reshape(-1)
        qkv_w = qkv_w[perm]
        qkv_b = qkv_b[perm]
    _export_groupnorm(out, f"{prefix}.norm", p["norm"])
    out[f"{prefix}.qkv.weight"] = qkv_w
    out[f"{prefix}.qkv.bias"] = qkv_b
    out[f"{prefix}.proj_out.weight"] = _torch_conv1x1(p["proj_out"]["kernel"], 1)
    out[f"{prefix}.proj_out.bias"] = p["proj_out"]["bias"]


def export_unet_state_dict(
    params: dict,
    dims: int = 2,
    model_channels: int = 64,
    num_res_blocks: int = 2,
    channel_mult=(1, 2, 4, 8),
    attention_resolutions=(16, 8),
    conv_resample: bool = True,
    resblock_updown: bool = False,
    num_heads: int = 1,
    num_head_channels: int = -1,
    num_heads_upsample: int = -1,
    use_new_attention_order: bool = False,
) -> dict[str, np.ndarray]:
    """JAX UNet ``params`` (nested dict) -> reference-layout UNetv2
    ``state_dict`` of numpy arrays, enumerating blocks as the reference's
    module lists do."""
    out = _Out()

    def heads_for(ch: int) -> int:
        return ch // num_head_channels if num_head_channels != -1 else num_heads

    def dec_heads_for(ch: int) -> int:
        if num_head_channels != -1:
            return ch // num_head_channels
        return num_heads if num_heads_upsample == -1 else num_heads_upsample

    out["time_embed.0.weight"] = _torch_linear(params["time_dense_0"]["kernel"])
    out["time_embed.0.bias"] = params["time_dense_0"]["bias"]
    out["time_embed.2.weight"] = _torch_linear(params["time_dense_1"]["kernel"])
    out["time_embed.2.bias"] = params["time_dense_1"]["bias"]

    for name, sub in params.get("cond_fn", {}).items():
        out[f"cond_fn.embedding_layers.{name[len('embedding_'):]}.weight"] = sub["embedding"]

    out["input_blocks.0.0.weight"] = _torch_conv(params["conv_in"]["kernel"])
    out["input_blocks.0.0.bias"] = params["conv_in"]["bias"]

    idx = 1
    ch = int(channel_mult[0] * model_channels)
    ds = 1
    for level, mult in enumerate(channel_mult):
        for i in range(num_res_blocks):
            ch = int(mult * model_channels)
            _export_resblock(out, f"input_blocks.{idx}.0", params[f"enc_res_{level}_{i}"], dims)
            if ds in tuple(attention_resolutions):
                _export_attnblock(
                    out, f"input_blocks.{idx}.1", params[f"enc_attn_{level}_{i}"],
                    heads_for(ch), use_new_attention_order,
                )
            idx += 1
        if level != len(channel_mult) - 1:
            if resblock_updown:
                _export_resblock(out, f"input_blocks.{idx}.0", params[f"down_{level}"], dims)
            elif conv_resample:
                op = params[f"down_{level}"]["op"]
                out[f"input_blocks.{idx}.0.op.weight"] = _torch_conv(op["kernel"])
                out[f"input_blocks.{idx}.0.op.bias"] = op["bias"]
            idx += 1
            ds *= 2

    _export_resblock(out, "middle_block.0", params["mid_res_0"], dims)
    _export_attnblock(out, "middle_block.1", params["mid_attn"], heads_for(ch),
                      use_new_attention_order)
    _export_resblock(out, "middle_block.2", params["mid_res_1"], dims)

    idx = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            ch = int(model_channels * mult)
            _export_resblock(out, f"output_blocks.{idx}.0", params[f"dec_res_{level}_{i}"], dims)
            layer = 1
            if ds in tuple(attention_resolutions):
                _export_attnblock(
                    out, f"output_blocks.{idx}.{layer}", params[f"dec_attn_{level}_{i}"],
                    dec_heads_for(ch), use_new_attention_order,
                )
                layer += 1
            if level and i == num_res_blocks:
                if resblock_updown:
                    _export_resblock(
                        out, f"output_blocks.{idx}.{layer}", params[f"up_{level}"], dims,
                    )
                elif conv_resample:
                    conv = params[f"up_{level}"]["conv"]
                    out[f"output_blocks.{idx}.{layer}.conv.weight"] = _torch_conv(conv["kernel"])
                    out[f"output_blocks.{idx}.{layer}.conv.bias"] = conv["bias"]
                ds //= 2
            idx += 1

    _export_groupnorm(out, "out.0", params["norm_out"])
    out["out.2.weight"] = _torch_conv(params["conv_out"]["kernel"])
    out["out.2.bias"] = params["conv_out"]["bias"]
    return out.sd


def load_jax_npz(path: str | Path) -> dict:
    """A JAX ``save_model_weights`` .npz as the nested params dict."""
    params: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _KEY.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: key {key!r} is not a keystr path of dict keys")
            node = params
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(data[key])
    return params


def arch_kwargs(model_kwargs: dict[str, Any]) -> dict[str, Any]:
    """The model kwargs that shape the state_dict layout."""
    return {k: v for k, v in model_kwargs.items() if k in ARCH_KEYS}


def load_state_dict_file(path: str | Path, model_kwargs: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Backbone weights from a file, as a reference-layout state_dict of
    fp32 tensors: a reference ``.pth``/``.pt`` as it is, or a JAX ``.npz``
    through ``export_unet_state_dict`` with the config's architecture."""
    path = Path(path)
    if path.suffix in (".pth", ".pt", ".bin"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if any("down_blocks." in k for k in sd):
            raise NotImplementedError(
                f"{path} is a diffusers UNet2DModel checkpoint; the port reads "
                "reference UNetv2 state_dicts only",
            )
        return {k: v.float() for k, v in sd.items()}
    if path.suffix == ".npz":
        sd = export_unet_state_dict(load_jax_npz(path), **arch_kwargs(model_kwargs))
        return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}
    raise ValueError(f"unsupported checkpoint file {path} (expected .pth, .pt or .npz)")
