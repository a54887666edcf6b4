"""``UNet_Diffuser``: the UNet pinned to the HuggingFace ``UNet2DModel``
architecture of the reference's diffusers adapter.

Port of ``rho_diffusion_tpu/models/unet_diffusers_compat.py``. The adapter
wrapped ``diffusers.UNet2DModel`` with a fixed architecture: 2-D only, three
levels of block channels (32, 64, 64), attention on the two inner levels,
heads of ``attention_head_dim`` channels, conditioning embeddings added to
the time embedding (``class_embed_type='identity'``), ``layers_per_block =
num_res_blocks`` and one output channel. Here that is the port's UNetv2
held as ``self.model``: width 32, ``channel_mult`` (1, 2, 2), attention at
ds 2 and 4, ``num_heads`` 1 with ``num_head_channels = attention_head_dim``.
Every kwarg of the adapter is accepted; those its fixed architecture ignored
(``model_channels``, ``channel_mult``, ``attention_resolutions``,
``num_heads``, ``num_heads_upsample``, ``use_scale_shift_norm``,
``resblock_updown``, ``use_new_attention_order``, ``dropout``,
``conv_resample``, ``out_channels``) are ignored the same way.

The ``state_dict`` is the UNet's under ``model.`` (the reference torch
layout), so ``state_dict_from_jax`` carries a JAX tree ``{"model": ...}``,
and ``interop.hf_unet_weights`` a diffusers checkpoint, into it.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.registry import registry

# UNet2DModel(block_out_channels=(32, 64, 64)) is base 32 with mult (1, 2, 2);
# attention on the two inner levels is ds 2 and 4
PINNED = {"model_channels": 32, "channel_mult": (1, 2, 2), "attention_resolutions": (2, 4),
          "dims": 2}


@registry.register_model("UNet_Diffuser")
class UNetDiffuser(nn.Module):
    """The UNet with UNet2DModel's (32, 64, 64) architecture; 2-D only."""

    def __init__(
        self,
        data_shape: Sequence[int],
        in_channels: int,
        model_channels: int = 32,
        out_channels: int = 1,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (16, 8),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        dims: int = 2,
        num_classes: Optional[int] = None,
        cond_fn: Optional[nn.Module] = None,
        use_checkpoint: bool = False,
        use_fp16: bool = False,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        attention_head_dim: int = 8,
        activation: Any = "SiLU",
        dtype: Any = torch.float32,
    ) -> None:
        super().__init__()
        assert dims == 2, "UNet_Diffuser is 2D-only (reference parity)"
        self.attention_head_dim = attention_head_dim
        self.model = UNet(
            data_shape=tuple(data_shape),
            in_channels=in_channels,
            out_channels=1,  # the reference hard-coded 1
            num_res_blocks=num_res_blocks,
            num_classes=num_classes,
            cond_fn=cond_fn,
            use_checkpoint=use_checkpoint,
            use_fp16=use_fp16,
            # UNet2DModel's heads of attention_head_dim channels at every site
            num_heads=1,
            num_head_channels=attention_head_dim,
            activation=activation,
            dtype=dtype,
            **PINNED,
        )

    @staticmethod
    def state_dict_from_jax(params: dict) -> dict[str, np.ndarray]:
        """A JAX ``UNet_Diffuser`` tree ``{"model": <UNet tree>}`` as this
        model's ``state_dict``: the UNet's reference layout under
        ``model.``, with the pinned architecture and the tree's own number
        of res blocks a level (the head split does not change the layout).
        The MultiEmbeddings tables may sit beside ``model`` (where the JAX
        module keeps the cond_fn it is given) or inside it (where the HF
        transplant puts the adapter's); both become ``model.cond_fn``."""
        from rho_diffusion_tpu_torch.interop.jax_weights import export_unet_state_dict

        tree = params["model"]
        if "cond_fn" in params:
            if "cond_fn" in tree:
                raise ValueError("the tree holds cond_fn tables both beside and inside 'model'")
            tree = {**tree, "cond_fn": params["cond_fn"]}
        num_res_blocks = sum(1 for k in tree if k.startswith("enc_res_0_"))
        sd = export_unet_state_dict(tree, num_res_blocks=num_res_blocks, num_heads=1,
                                    **PINNED)
        return {f"model.{k}": v for k, v in sd.items()}

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "UNetDiffuser":
        self.model.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C_in], timesteps: [B] -> [B, H, W, 1] fp32."""
        return self.model(x, timesteps, y)
