"""JSON experiment configuration, as plain dataclasses.

Reads the same JSON files as ``rho_diffusion_tpu/config.py`` (which is built
on pydantic, absent where the port runs) with the same field names and
defaults. Unknown keys are ignored, like the JAX package's
``extra="ignore"``. ``kwargs`` of named components get the same
numeric-string coercion ("1e-4" -> 1e-4).

    {
      "experiment": str,
      "model":          {"name": str, "kwargs": {...}},
      "dataset":        {"name": str, "kwargs": {...}},
      "optimizer":      {"name": str, "kwargs": {...}},
      "lr_scheduler":   {"name": str, "kwargs": {...}},   (optional)
      "noise_schedule": {"name": str, "kwargs": {...}},
      "pipeline":       {"name": str, "kwargs": {...}},   (optional)
      "training":  {...},
      "inference": {...}
    }
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Union

from rho_diffusion_tpu_torch.utils import number_cast_dict


def _known(cls, payload: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in (payload or {}).items() if k in names}


@dataclass
class ComponentConfig:
    """A named component plus its constructor kwargs, resolved through the
    registry."""

    name: str
    kwargs: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, payload: Optional[dict]) -> Optional["ComponentConfig"]:
        if payload is None:
            return None
        out = cls(**_known(cls, payload))
        out.kwargs = number_cast_dict(out.kwargs or {})
        return out


@dataclass
class TrainingConfig:
    """Training hyperparameters (same fields and defaults as the JAX
    package's TrainingConfig)."""

    device: str = "tpu"
    np: int = 1
    loss_fn: str = "MSELoss"
    ema_decay: float = 0.0
    batch_size: int = 16
    seed: int = 0
    min_epochs: int = 1
    max_epochs: int = 1
    save_checkpoint_every_n_epochs: int = 0
    sample_every_n_epochs: int = 0
    benchmark_mode: bool = False
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    checkpoint_dir: Optional[str] = None
    log_every_n_steps: int = 50
    log_grad_norm: bool = True
    grad_accum: int = 1
    val_fraction: float = 0.0
    validate_every_n_epochs: int = 1
    mesh: Optional[dict[str, int]] = None
    tensor_parallel: bool = False
    spatial_sharding: bool = False
    tp_min_dim: int = 64
    zero1: bool = False
    fsdp: bool = False
    device_cache: bool = False
    device_cache_shard: bool = True
    loggers: list[Any] = field(default_factory=lambda: ["stdout", "jsonl"])
    sample_params: str = "ema"  # "ema" | "raw"

    def __post_init__(self) -> None:
        if self.sample_params not in ("ema", "raw"):
            raise ValueError(f"sample_params must be 'ema' or 'raw', got {self.sample_params!r}")


@dataclass
class InferenceConfig:
    """Sampling-time configuration (same fields and defaults as the JAX
    package's InferenceConfig)."""

    device: str = "tpu"
    checkpoint: Optional[str] = None
    parameter_space: Optional[dict[str, list]] = None
    cache_file: Optional[str] = None
    plot_output_file: Optional[str] = None
    seed: int = 0
    num_samples: int = 16
    sampler: str = "ddpm"
    ddim_steps: int = 0
    spacing: Optional[str] = None
    use_ema: bool = True
    guidance_scale: float = 1.0


@dataclass
class ExperimentConfig:
    """Top-level experiment config."""

    experiment: str
    model: ComponentConfig
    dataset: ComponentConfig
    noise_schedule: ComponentConfig
    optimizer: Optional[ComponentConfig] = None
    lr_scheduler: Optional[ComponentConfig] = None
    pipeline: Optional[ComponentConfig] = None
    training: TrainingConfig = field(default_factory=TrainingConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    @classmethod
    def from_dict(cls, payload: dict) -> "ExperimentConfig":
        comp = ComponentConfig.from_dict
        for key in ("experiment", "model", "dataset", "noise_schedule"):
            if key not in payload:
                raise ValueError(f"config is missing the required section '{key}'")
        return cls(
            experiment=str(payload["experiment"]),
            model=comp(payload["model"]),
            dataset=comp(payload["dataset"]),
            noise_schedule=comp(payload["noise_schedule"]),
            optimizer=comp(payload.get("optimizer")),
            lr_scheduler=comp(payload.get("lr_scheduler")),
            pipeline=comp(payload.get("pipeline")),
            training=TrainingConfig(**_known(TrainingConfig, payload.get("training"))),
            inference=InferenceConfig(**_known(InferenceConfig, payload.get("inference"))),
        )

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "ExperimentConfig":
        """Load an experiment config from a JSON file."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
