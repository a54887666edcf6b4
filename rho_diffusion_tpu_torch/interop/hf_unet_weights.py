"""Carry HuggingFace ``UNet2DModel`` state_dicts into ``UNet_Diffuser``.

The port's own copy of ``rho_diffusion_tpu/interop/hf_unet_weights.py``
(:140-258) and of the ``interop/torch_weights.py`` pieces it uses, in numpy.
``transplant_hf_unet2d_state_dict`` yields the JAX package's param tree for
its ``UNet_Diffuser`` (``{"model": <UNet tree>}``, flax layouts), leaf for
leaf what the JAX function yields; ``UNetDiffuser.state_dict_from_jax``
carries that tree into the port's model. The mapping:

* ``time_embedding.linear_1/linear_2`` are ``time_dense_0/1``; HF's
  ``Timesteps(flip_sin_to_cos=True)`` emits [cos | sin] halves where the
  UNet interleaves [sin_0, cos_0, ...], so linear_1's input columns are
  permuted;
* ``down_blocks.L.resnets.I`` is ``enc_res_{L}_{I}`` (norm1, conv1,
  time_emb_proj, norm2, conv2, conv_shortcut as norm_in, conv_in,
  emb_proj, norm_out, conv_out, skip), ``down_blocks.L.attentions.I``
  ``enc_attn_{L}_{I}``: the separate q/k/v projections fused into one qkv
  with the per-head [q_h | k_h | v_h] interleave, in both diffusers
  namings (``to_q``/``to_out.0`` and the legacy ``query``/``proj_attn``);
* the down- and upsamplers' convs, the mid block, ``conv_norm_out`` and
  ``conv_out``; ``up_blocks`` run deepest level first;
* a ``model.`` prefix (the reference adapter's own state_dict) is
  stripped, and its ``cond_fn.embedding_layers.*`` tables become the tree's
  ``cond_fn``.

The number of levels, res blocks a level, attention sites and shortcuts is
read from the keys. ``strict`` raises on weights the mapping did not use.
"""
from __future__ import annotations

import re

import numpy as np


def _to_numpy(v) -> np.ndarray:
    """A torch tensor (bf16 too) or array-like as a numpy array."""
    if hasattr(v, "detach"):
        v = v.detach()
        if str(v.dtype) == "torch.bfloat16":
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv weight [O, I, *K] -> flax [*K, I, O]."""
    return np.transpose(w, (*range(2, w.ndim), 1, 0))


def _dense_from_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _dense_from_conv1x1(w: np.ndarray) -> np.ndarray:
    """torch 1x1 conv weight [O, I, 1...] -> flax Dense kernel [I, O]."""
    return np.transpose(w.reshape(w.shape[0], w.shape[1]), (1, 0))


class _SD:
    """state_dict accessor that records the keys it hands out."""

    def __init__(self, sd: dict) -> None:
        self.sd = {k: _to_numpy(v) for k, v in sd.items()}
        self.used: set[str] = set()

    def __call__(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"missing reference weight '{key}'")
        self.used.add(key)
        return self.sd[key]

    def unused(self) -> list[str]:
        return sorted(set(self.sd) - self.used)


def _gn(sd: _SD, prefix: str) -> dict:
    return {"GroupNorm_0": {"scale": sd(f"{prefix}.weight"), "bias": sd(f"{prefix}.bias")}}


def _conv(sd: _SD, prefix: str) -> dict:
    return {"kernel": _conv_kernel(sd(f"{prefix}.weight")), "bias": sd(f"{prefix}.bias")}


def _resnet(sd: _SD, prefix: str) -> dict:
    out = {
        "norm_in": _gn(sd, f"{prefix}.norm1"),
        "conv_in": _conv(sd, f"{prefix}.conv1"),
        "emb_proj": {"kernel": _dense_from_linear(sd(f"{prefix}.time_emb_proj.weight")),
                     "bias": sd(f"{prefix}.time_emb_proj.bias")},
        "norm_out": _gn(sd, f"{prefix}.norm2"),
        "conv_out": _conv(sd, f"{prefix}.conv2"),
    }
    if f"{prefix}.conv_shortcut.weight" in sd.sd:
        out["skip"] = {"kernel": _dense_from_conv1x1(sd(f"{prefix}.conv_shortcut.weight")),
                       "bias": sd(f"{prefix}.conv_shortcut.bias")}
    return out


def _attention(sd: _SD, prefix: str, head_dim: int) -> dict:
    """HF's q, k and v projections (contiguous blocks of ``head_dim``
    output channels a head) fused into one qkv whose 3C outputs are
    per-head [q_h | k_h | v_h] blocks, as the UNet's AttentionBlock splits
    them."""
    if f"{prefix}.to_q.weight" in sd.sd:  # diffusers >= 0.18 "Attention"
        names = {"q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0"}
    else:  # legacy "AttentionBlock"
        names = {"q": "query", "k": "key", "v": "value", "o": "proj_attn"}
    w = {n: sd(f"{prefix}.{names[n]}.weight") for n in "qkv"}
    b = {n: sd(f"{prefix}.{names[n]}.bias") for n in "qkv"}
    c = w["q"].shape[0]
    if c % head_dim:
        raise ValueError(f"{prefix}: {c} channels not divisible by attention_head_dim {head_dim}")
    rows_w, rows_b = [], []
    for h in range(c // head_dim):
        s = slice(h * head_dim, (h + 1) * head_dim)
        rows_w += [w[n][s] for n in "qkv"]
        rows_b += [b[n][s] for n in "qkv"]
    return {
        "norm": _gn(sd, f"{prefix}.group_norm"),
        "qkv": {"kernel": _dense_from_linear(np.concatenate(rows_w, axis=0)),
                "bias": np.concatenate(rows_b, axis=0)},
        "proj_out": {"kernel": _dense_from_linear(sd(f"{prefix}.{names['o']}.weight")),
                     "bias": sd(f"{prefix}.{names['o']}.bias")},
    }


def _count(sd: _SD, pattern: str) -> int:
    """The highest index ``pattern``'s one group matches, plus one."""
    rx = re.compile(pattern)
    found = [int(m.group(1)) for m in map(rx.match, sd.sd) if m]
    return max(found, default=-1) + 1


def _blocks(tree: dict, sd: _SD, hf: str, level: int, side: str, head_dim: int) -> None:
    """``hf``'s resnets and attentions as ``{side}_res/attn_{level}_{i}``."""
    for i in range(_count(sd, rf"{re.escape(hf)}\.resnets\.(\d+)\.")):
        tree[f"{side}_res_{level}_{i}"] = _resnet(sd, f"{hf}.resnets.{i}")
        attn = f"{hf}.attentions.{i}"
        if any(k.startswith(attn + ".") for k in sd.sd):
            tree[f"{side}_attn_{level}_{i}"] = _attention(sd, attn, head_dim)


def transplant_hf_unet2d_state_dict(state_dict: dict, attention_head_dim: int = 8,
                                    strict: bool = True) -> dict:
    """A HF ``UNet2DModel`` state_dict (torch tensors or numpy), bare or
    the reference adapter's (``model.`` prefixed, with ``cond_fn.*``), as
    the JAX ``UNet_Diffuser`` param tree ``{"model": <UNet tree>}`` of
    numpy arrays. ``attention_head_dim`` is UNet2DModel's (default 8)."""
    cond, unet_sd = {}, {}
    for k, v in state_dict.items():
        v = _to_numpy(v)
        if k.startswith("cond_fn.embedding_layers."):
            cond[f"embedding_{k.split('.')[2]}"] = {"embedding": v}
        else:
            unet_sd[k[len("model."):] if k.startswith("model.") else k] = v
    sd = _SD(unet_sd)
    n_levels = _count(sd, r"down_blocks\.(\d+)\.")
    if n_levels == 0:
        raise ValueError("no down_blocks.* keys — not a UNet2DModel state_dict")

    # our input channel 2j is sin_j (HF column half + j), 2j + 1 is cos_j (column j)
    w1 = sd("time_embedding.linear_1.weight")
    half = w1.shape[1] // 2
    perm = np.empty(w1.shape[1], dtype=np.int64)
    perm[0::2] = np.arange(half) + half
    perm[1::2] = np.arange(half)
    tree: dict = {
        "time_dense_0": {"kernel": _dense_from_linear(w1[:, perm]),
                         "bias": sd("time_embedding.linear_1.bias")},
        "time_dense_1": {"kernel": _dense_from_linear(sd("time_embedding.linear_2.weight")),
                         "bias": sd("time_embedding.linear_2.bias")},
        "conv_in": _conv(sd, "conv_in"),
        "norm_out": _gn(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    for level in range(n_levels):
        _blocks(tree, sd, f"down_blocks.{level}", level, "enc", attention_head_dim)
        down = f"down_blocks.{level}.downsamplers.0.conv"
        if f"{down}.weight" in sd.sd:
            tree[f"down_{level}"] = {"op": _conv(sd, down)}
    tree["mid_res_0"] = _resnet(sd, "mid_block.resnets.0")
    tree["mid_attn"] = _attention(sd, "mid_block.attentions.0", attention_head_dim)
    tree["mid_res_1"] = _resnet(sd, "mid_block.resnets.1")
    n_up = _count(sd, r"up_blocks\.(\d+)\.")
    for u in range(n_up):
        level = n_up - 1 - u  # up_blocks run deepest first
        _blocks(tree, sd, f"up_blocks.{u}", level, "dec", attention_head_dim)
        up = f"up_blocks.{u}.upsamplers.0.conv"
        if f"{up}.weight" in sd.sd:
            tree[f"up_{level}"] = {"conv": _conv(sd, up)}

    leftover = sd.unused()
    if strict and leftover:
        raise ValueError(f"unconsumed HF weights: {leftover[:10]}...")
    if cond:
        tree["cond_fn"] = cond
    return {"model": tree}


def load_hf_unet2d_checkpoint(path, **kwargs) -> dict:
    """A ``UNet_Diffuser``/UNet2DModel ``.pth``/``.bin`` state_dict,
    transplanted (``transplant_hf_unet2d_state_dict``'s kwargs)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return transplant_hf_unet2d_state_dict(sd, **kwargs)
