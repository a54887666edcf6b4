"""Training entry point of the PyTorch port.

    python -m rho_diffusion_tpu_torch.training CONFIG.json [-d cuda|cpu]
        [-p weights.npz|weights.pth] [-e EPOCHS] [--work-dir DIR] [--no-resume]
        [--pipeline DDPM|GaussianDiffusionPipeline|DiffusersDDPMPipeline]
        [--profile DIR]

Mirrors ``scripts/training.py``: builds the ``Trainer`` from the config,
initialises the state (backbone weights from ``-p``, else the latest
checkpoint under the work dir unless ``--no-resume``, else fresh seeded
weights) and trains. Full-state checkpoints land in
``training.checkpoint_dir`` or ``<work-dir>/checkpoints``, the backbone
weights in ``<work-dir>/model.pth``, the metrics in
``<work-dir>/metrics.jsonl``. ``--pipeline`` names the pipeline over the
config's (DDPM, GaussianDiffusionPipeline or DiffusersDDPMPipeline, with the
config's pipeline kwargs); a config that names GaussianDiffusionPipeline
(e.g. ``examples/config_learned_variance.json``) or DiffusersDDPMPipeline
(DDPMScheduler's names: ``prediction_type``, ``variance_type``,
``beta_schedule``, ...) trains it as it trains DDPM, validation included.

``--profile DIR`` traces the whole run with ``torch.profiler`` (CPU and,
on the card, CUDA activity) and writes the chrome trace into DIR when it
ends.

It runs on CUDA unless ``-d cpu`` is given (a config's "tpu" means CUDA) and
raises when CUDA is absent.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.config import (
    ComponentConfig,
    ExperimentConfig,
    apply_torch_checkpoint_schedule_fixup,
)
from rho_diffusion_tpu_torch.training.state import TrainState
from rho_diffusion_tpu_torch.training.trainer import Trainer
from rho_diffusion_tpu_torch.utils import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("json_config", type=Path)
    parser.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-p", dest="model_checkpoint_path", default=None,
                        help="backbone weights to start from: a .pth state_dict or a JAX .npz")
    parser.add_argument("-e", "--epochs", type=int, default=None)
    parser.add_argument("--pipeline", default=None,
                        help="DDPM | GaussianDiffusionPipeline | DiffusersDDPMPipeline (over "
                             "the config's pipeline)")
    parser.add_argument("--work-dir", type=Path, default=Path("."))
    parser.add_argument("--profile", default=None,
                        help="write a torch.profiler trace of the run into this directory")
    parser.add_argument("--no-resume", action="store_true")
    args = parser.parse_args(argv)

    config = ExperimentConfig.from_json(args.json_config)
    device = resolve_device(args.device or config.training.device)
    if args.pipeline:
        config.pipeline = ComponentConfig(
            args.pipeline, dict(config.pipeline.kwargs) if config.pipeline else {})
    if apply_torch_checkpoint_schedule_fixup(config, args.model_checkpoint_path):
        print("torch checkpoint + cosine schedule: using exact_reference table")
    print(f"device: {device}", flush=True)
    trainer = Trainer(config, work_dir=args.work_dir, device=device, profile_dir=args.profile)
    state = trainer.init_state(resume=not args.no_resume, weights_path=args.model_checkpoint_path)
    return trainer.fit(state, max_epochs=args.epochs)


if __name__ == "__main__":
    main()
