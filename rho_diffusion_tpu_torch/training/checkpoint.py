"""Checkpoint and resume of the full training state; the sampling weights.

Port of ``rho_diffusion_tpu/training/checkpoint.py``. The JAX package writes
orbax directories; the port writes one ``torch.save`` file per step,
``<directory>/step_<N>.pt``, holding ``TrainState.state_dict()``: the
backbone weights in the reference layout, the optimizer state, the EMA
weights, the step and the generator state. The JAX package's orbax
directories are not readable here.

* ``CheckpointManager`` keeps the ``max_to_keep`` newest steps. A save over
  an existing step overwrites it (written to a temporary file, then renamed),
  never skips it.
* ``save_model_weights`` writes the backbone ``state_dict`` as a ``.pth``
  in the reference layout (which the JAX package's ``load_torch_checkpoint``
  reads).
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
from typing import Optional

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


def resolve_inference_params(pipeline, config, ckpt=None, work_dir: str | Path = ".") -> list[str]:
    """Load the sampling weights into ``pipeline.backbone`` and return the
    messages to show (which weights, or a warning)."""
    from rho_diffusion_tpu_torch.interop.jax_weights import load_state_dict_file

    messages: list[str] = []

    def from_directory(directory: Path) -> None:
        if any(p.is_dir() and p.name.isdigit() for p in directory.iterdir()):
            messages.append(
                f"WARNING: {directory} holds orbax checkpoints of the JAX package, which "
                "the port cannot read; sampling untrained model",
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
        pipeline.load_state_dict(load_state_dict_file(ckpt, dict(config.model.kwargs)))
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
