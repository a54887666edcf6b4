"""Abstract diffusion pipeline, sampling half.

Port of the sampling side of ``rho_diffusion_tpu/diffusion/base.py``: the
registry-driven construction (backbone, cond_fn and schedule named by
strings), the model call, the sample shape and the conditions drawn from a
parameter space. The train step is not ported yet; the constructor accepts
(and ignores) the training arguments the configs pass, so one config builds
both.

The pipeline owns its device: the backbone and the schedule tables live
there, and parameters are initialised from a seeded ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.utils import (
    parameter_space_to_embeddings,
    resolve_device,
    sample_from_discrete_parameter_space,
)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Slice a [T] coefficient table at per-sample timesteps t [B], shaped
    to broadcast against a rank-``ndim`` batch."""
    return table[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


class AbstractDiffusionPipeline:
    """Construction and model-call machinery shared by diffusion pipelines."""

    def __init__(
        self,
        backbone: Union[str, type],
        backbone_kwargs: dict[str, Any],
        schedule: NoiseSchedule,
        loss_func: Any = "MSELoss",
        timesteps: Optional[int] = None,
        cond_fn: Optional[Union[str, Any]] = None,
        cond_fn_kwargs: Optional[dict] = None,
        optimizer: Optional[Any] = None,
        opt_kwargs: Optional[dict] = None,
        world_size: int = 1,
        ema_decay: float = 0.0,
        clip_grad_norm: Optional[float] = None,
        learning_rate: Optional[Any] = None,
        log_grad_norm: bool = True,
        grad_accum: int = 1,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ) -> None:
        self.device = resolve_device(device)
        self.backbone_kwargs = dict(backbone_kwargs)
        bk = dict(backbone_kwargs)
        # configs name the cond_fn inside the model kwargs; it is built only
        # when kwargs to construct it with are given (as the JAX package does)
        if isinstance(bk.get("cond_fn"), str):
            bk_cond_name = bk.pop("cond_fn")
            if cond_fn is None and cond_fn_kwargs:
                cond_fn = bk_cond_name
        cond_module = None
        if isinstance(cond_fn, str):
            if cond_fn == "ClassifierGuidance":
                raise ValueError(
                    "ClassifierGuidance cannot be used as the model's cond_fn: "
                    "it guides sampling, not conditioning.",
                )
            cond_module = registry.get("layers", cond_fn)(**(cond_fn_kwargs or {}))
        elif cond_fn is not None:
            cond_module = cond_fn
        if isinstance(backbone, str):
            backbone = registry.get("models", backbone)
        if cond_module is not None:
            bk["cond_fn"] = cond_module
        self.backbone = backbone(**bk)
        self.cond_fn = cond_module
        self.init_params(seed)

        if timesteps is not None and int(timesteps) != len(schedule):
            raise ValueError(
                f"timesteps={timesteps} disagrees with the schedule length "
                f"{len(schedule)} — pass one or the other",
            )
        self.schedule = schedule.to(self.device)
        self.timesteps = timesteps or len(schedule)

    # ------------------------------------------------------------------
    # Parameters and the model call
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """(Re-)initialise the backbone from a CPU generator seeded with
        ``seed`` (the same values on every device), then move it to the
        pipeline's device in eval mode."""
        gen = torch.Generator().manual_seed(int(seed))
        self.backbone.to("cpu").reset_parameters(gen)
        self.backbone.to(self.device).eval()

    def load_state_dict(self, state_dict: dict, strict: bool = True) -> None:
        """Load reference-layout backbone weights (strict by default)."""
        self.backbone.load_state_dict(state_dict, strict=strict)

    @torch.no_grad()
    def apply(self, x, t, y=None) -> torch.Tensor:
        return self.backbone(x, t, y)

    # ------------------------------------------------------------------
    # Sampling helpers
    # ------------------------------------------------------------------
    def condition_embedding_dim(self) -> int:
        """Width of precomputed condition embeddings: 4 x model_channels."""
        return self.backbone_kwargs.get("model_channels", 64) * 4

    def sample_shape(self, batch_size: int) -> tuple[int, ...]:
        """[B, *data_shape, C] from the backbone kwargs (channels-last)."""
        bk = self.backbone_kwargs
        data_shape = tuple(bk.get("data_shape") or bk["input_shapes"])
        channels = bk.get("in_channels", bk.get("num_channels", bk.get("out_channels", 1)))
        return (batch_size, *data_shape, channels)

    def conditions_from_parameter_space(
        self,
        parameter_space: Optional[dict],
        batch_size: int,
        random: bool = True,
        as_hash_embeddings: bool = False,
        embedding_dim: int = 256,
        seed: int = 0,
    ) -> Optional[torch.Tensor]:
        """Condition rows from a discrete parameter space: random rows, or
        the first N rows in order; as sha512 embeddings on request."""
        if parameter_space is None:
            return None
        if hasattr(parameter_space, "parameters"):
            parameter_space = parameter_space.parameters
        if as_hash_embeddings:
            embs = parameter_space_to_embeddings(parameter_space, l=embedding_dim)
            if random:
                idx = np.random.default_rng(seed).integers(0, embs.shape[0], size=batch_size)
            else:
                idx = np.arange(batch_size) % embs.shape[0]
            rows = embs[idx]
        else:
            rows = sample_from_discrete_parameter_space(
                parameter_space, batch_size, random=random, rng=np.random.default_rng(seed),
            )
        return torch.as_tensor(rows, device=self.device)

    def coerce_conditions(self, conditions, batch_size: int,
                          generator: Optional[torch.Generator] = None):
        """int -> constant vector, "auto" -> random class ids in [0, 10),
        array-likes -> a tensor on the pipeline's device."""
        if conditions is None:
            return None
        if isinstance(conditions, int):
            return torch.full((batch_size,), conditions, dtype=torch.int64, device=self.device)
        if isinstance(conditions, str) and conditions == "auto":
            return torch.randint(0, 10, (batch_size,), generator=generator, device=self.device)
        return torch.as_tensor(np.asarray(conditions) if isinstance(conditions, (list, tuple))
                               else conditions, device=self.device)
