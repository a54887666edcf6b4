"""Checkpoint and resume of the full training state; the sampling weights.

Port of ``rho_diffusion_tpu/training/checkpoint.py``. The JAX package writes
orbax directories; the port writes one ``torch.save`` file per step,
``<directory>/step_<N>.pt``, holding ``TrainState.state_dict()``: the
backbone weights in the reference layout, the optimizer state, the EMA
weights, the step and the generator state.

The JAX package's orbax directories are not readable here: orbax 0.11
writes OCDBT (tensorstore's B-tree key-value store) whose array chunks are
zstd frames, and neither numpy nor the standard library decodes zstd (the
port may not import orbax or tensorstore). The way across is the
``model.npz`` the JAX trainer writes beside its checkpoints (at every
checkpoint epoch and at the end), which ``load_weights_auto`` reads; an
orbax directory given for sampling says so.

* ``CheckpointManager`` keeps the ``max_to_keep`` newest steps. A save over
  an existing step overwrites it (written to a temporary file, then renamed),
  never skips it.
* ``save_model_weights`` writes the backbone ``state_dict`` as a ``.pth``
  in the reference layout (which the JAX package's ``load_torch_checkpoint``
  reads).
* ``load_weights_auto`` reads backbone weights from a JAX ``.npz`` (through
  the config's model's carrier in ``interop.jax_weights``) or a ``.pth``
  (as it is), checked
  against the model's ``state_dict`` both ways with the JAX package's
  messages; ``load_model_weights`` the ``.npz`` alone.
* ``resolve_inference_params`` picks the sampling weights in the JAX order:
  an explicit weight file, an explicit checkpoint directory, the config's
  ``training.checkpoint_dir`` (or ``<work_dir>/checkpoints``), else the
  untrained weights with a warning; the EMA weights when
  ``inference.use_ema`` is set and the checkpoint has them.
"""
from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

from rho_diffusion_tpu_torch.training.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Numbered full-state checkpoints in one directory, with retention."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}.pt"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.iterdir():
            m = _STEP_FILE.match(p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> Path:
        """Write the state at ``step`` (default: its own), replacing any
        checkpoint of that step, and drop the oldest beyond ``max_to_keep``."""
        step = int(state.step) if step is None else int(step)
        target = self.path(step)
        fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, target)
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            self.path(old).unlink()
        return target

    def load(self, step: Optional[int] = None) -> dict:
        """The payload of ``step`` (default: the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default: the latest) into ``state``, in place."""
        state.load_state_dict(self.load(step))
        return state


def save_model_weights(model: torch.nn.Module, path: str | Path) -> None:
    """The backbone weights as a reference-layout ``.pth`` (fp32, CPU)."""
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()}, path)


_TRANSPLANT_KEYS = ("model_channels", "num_res_blocks")


def _place(template: torch.nn.Module | dict, got: dict, missing: str,
           source: str) -> dict[str, torch.Tensor]:
    """``got``'s weights under the keys of ``template`` (a model or its
    state_dict), in its dtypes; a missing key raises KeyError(``missing``
    with the key), a shape that differs ValueError."""
    if isinstance(template, torch.nn.Module):
        template = template.state_dict()
    out = {}
    for key, want in template.items():
        if key not in got:
            raise KeyError(missing.format(key=key))
        if tuple(got[key].shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for '{key}': {source} {tuple(got[key].shape)} "
                             f"vs model {tuple(want.shape)}")
        out[key] = got[key].to(want.dtype)
    return out


def load_weights_auto(template: torch.nn.Module | dict, path: str | Path,
                      model_kwargs: Optional[dict[str, Any]] = None,
                      model_name: str = "UNetv2") -> dict[str, torch.Tensor]:
    """Backbone weights from a reference ``.pth``/``.pt``/``.bin`` or a JAX
    ``.npz``, dispatched on the suffix, as a ``state_dict`` with the keys,
    shapes and dtypes of ``template`` (a model or its ``state_dict``).

    ``model_kwargs`` is the model section of the JSON config and
    ``model_name`` its model. A UNetv2 ``.pth`` needs at least its
    ``model_channels`` and ``num_res_blocks``, as the JAX package's
    transplant does; the ViT's and the SimpleUNet's ``.pth`` is the port's
    own ``state_dict``. A diffusers ``UNet2DModel`` ``.pth`` (``down_blocks.``
    keys) loads into a ``UNet_Diffuser`` model, with ``attention_head_dim``
    from ``model_kwargs`` (default 8), as the JAX package's does, and raises
    under any other model. Each is checked both ways: a weight the model
    lacks or one it cannot place raises."""
    from rho_diffusion_tpu_torch.interop.jax_weights import jax_carrier, load_state_dict_file

    path = Path(path)
    if path.suffix not in (".pth", ".pt", ".bin"):
        return load_model_weights(template, path, model_kwargs, model_name)
    got = load_state_dict_file(path, dict(model_kwargs or {}), model_name)
    # a model that carries its own JAX tree stores its own state_dict in a .pth
    if jax_carrier(model_name) is None and any(
            k not in (model_kwargs or {}) for k in _TRANSPLANT_KEYS):
        raise ValueError(
            "transplanting a torch .pth checkpoint requires the model config to specify at "
            f"least model_channels and num_res_blocks (got keys {sorted(model_kwargs or {})})",
        )
    out = _place(template, got, "transplant missing weight '{key}'", "torch checkpoint")
    extra = sorted(set(got) - set(out))
    if extra:
        raise KeyError(
            f"checkpoint has {len(extra)} weight(s) the model config cannot place (first few: "
            f"{extra[:4]}) — does the config omit a cond_fn/conditioning block the checkpoint "
            "was trained with?",
        )
    return out


def load_model_weights(template: torch.nn.Module | dict, path: str | Path,
                       model_kwargs: Optional[dict[str, Any]] = None,
                       model_name: str = "UNetv2") -> dict[str, torch.Tensor]:
    """The weights of a JAX ``save_model_weights`` ``.npz`` as a
    ``state_dict`` with the keys, shapes and dtypes of ``template``; the
    config's model (``model_name``, ``model_kwargs``) picks the carrier
    that maps the JAX tree onto the port's layout."""
    from rho_diffusion_tpu_torch.interop.jax_weights import load_state_dict_file

    got = load_state_dict_file(Path(path), dict(model_kwargs or {}), model_name)
    return _place(template, got, f"weight '{{key}}' missing from {path}", "checkpoint")


def resolve_inference_params(pipeline, config, ckpt=None, work_dir: str | Path = ".") -> list[str]:
    """Load the sampling weights into ``pipeline.backbone`` and return the
    messages to show (which weights, or a warning)."""
    messages: list[str] = []

    def from_directory(directory: Path) -> None:
        if any(p.is_dir() and p.name.isdigit() for p in directory.iterdir()):
            messages.append(
                f"WARNING: {directory} holds orbax checkpoints of the JAX package, which "
                "the port cannot read (OCDBT with zstd-compressed chunks); sampling untrained "
                "model. Pass the model.npz the JAX trainer writes beside them (-p model.npz)",
            )
            return
        manager = CheckpointManager(directory)
        step = manager.latest_step()
        if step is None:
            messages.append(f"WARNING: no checkpoints in {directory}; sampling untrained model")
            return
        payload = manager.load(step)
        use_ema = config.inference.use_ema and payload.get("ema_params") is not None
        pipeline.load_state_dict(payload["ema_params"] if use_ema else payload["params"])
        messages.append(
            f"loaded {'EMA ' if use_ema else ''}weights from checkpoint step {step} in "
            f"{directory}",
        )

    ckpt_dir = Path(config.training.checkpoint_dir or (Path(work_dir) / "checkpoints"))
    if ckpt and os.path.isfile(ckpt):
        pipeline.load_state_dict(
            load_weights_auto(pipeline.backbone, ckpt, dict(config.model.kwargs),
                              config.model.name))
        messages.append(f"loaded weights from {ckpt}")
    elif ckpt and Path(ckpt).is_dir():
        from_directory(Path(ckpt))
    elif ckpt:
        messages.append(f"WARNING: checkpoint '{ckpt}' not found; sampling untrained model")
    elif ckpt_dir.exists():
        from_directory(ckpt_dir)
    else:
        messages.append(
            "WARNING: no checkpoint given and no checkpoint_dir; sampling untrained model",
        )
    return messages
