"""Evaluation entry point of the PyTorch port.

    python -m rho_diffusion_tpu_torch.evaluate CONFIG.json [-p WEIGHTS]
        [-d cuda|cpu] [--num-batches N] [--bpd] [--sampler S] [--steps K]
        [--work-dir DIR]

Mirrors ``scripts/evaluate.py``. It builds the dataset and the pipeline from
the config, loads the weights as the inference CLI does
(``resolve_inference_params``: a ``.pth`` or JAX ``.npz``, a checkpoint
directory of the port's trainer, else ``<work-dir>/checkpoints``), and
reports against the first ``--num-batches`` real batches (in order, at
``training.batch_size``):

* ``val_loss`` and ``val_psnr``: the means of ``validation_step``'s
  train_loss and psnr;
* ``wasserstein_gen_vs_real``: the Sinkhorn divergence (blur 0.05, 50
  iterations) between up to 8 generated fields (the first rows of the
  dataset's parameter space; ``--sampler``/``--steps`` for the
  GaussianDiffusion family) and as many rows of the first real batch, and
  ``generated_finite``;
* with ``--bpd``, for pipelines that have ``calc_bpd`` (GaussianDiffusion):
  ``total_bpd`` and ``prior_bpd``, the means over up to 4 real rows scored
  with their own labels through the whole VLB loop.

It prints the report as JSON and returns it. It runs on CUDA unless
``-d cpu`` is given (a config's "tpu" means CUDA) and raises when CUDA is
absent.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.config import ExperimentConfig, apply_torch_checkpoint_schedule_fixup
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.metrics import WassersteinWrapper
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.checkpoint import resolve_inference_params
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config
from rho_diffusion_tpu_torch.utils import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("json_config", type=Path)
    parser.add_argument("-p", dest="model_checkpoint_path", default=None)
    parser.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--num-batches", type=int, default=2)
    parser.add_argument("--bpd", action="store_true", help="bits-per-dim (slow: T model calls)")
    parser.add_argument("--sampler", default="ddim")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--work-dir", type=Path, default=Path("."))
    args = parser.parse_args(argv)

    config = ExperimentConfig.from_json(args.json_config)
    device = resolve_device(args.device or config.inference.device)
    ckpt = args.model_checkpoint_path or config.inference.checkpoint
    if apply_torch_checkpoint_schedule_fixup(config, ckpt):
        print("torch checkpoint + cosine schedule: using exact_reference table")
    dataset = registry.get("datasets", config.dataset.name)(**config.dataset.kwargs)
    pipeline = build_pipeline_from_config(config, dataset=dataset, device=device)
    state = pipeline.create_state(seed=config.inference.seed)
    for message in resolve_inference_params(pipeline, config, ckpt, args.work_dir):
        print(message)

    loader = DataLoader(dataset, batch_size=config.training.batch_size, shuffle=False,
                        seed=config.inference.seed)
    report: dict = {"config": str(args.json_config), "checkpoint": str(ckpt)}
    losses, psnrs = [], []
    real = real_labels = None
    for i, batch in enumerate(loader):
        if i >= args.num_batches:
            break
        m = pipeline.validation_step(state, batch)
        losses.append(float(m["train_loss"]))
        psnrs.append(float(m["psnr"]))
        if real is None:
            real, real_labels = batch["data"], batch.get("labels")
    if real is None:
        raise SystemExit(
            f"evaluate: the loader yielded no batches — the dataset ({len(dataset)} samples) "
            f"is smaller than training.batch_size={config.training.batch_size} (drop_last) "
            "or --num-batches is 0. Lower the batch size or pass more data.",
        )
    report["val_loss"] = float(np.mean(losses))
    report["val_psnr"] = float(np.mean(psnrs))

    # generated against real fields
    use_hash = bool(getattr(dataset, "use_emb_as_labels", False))
    space = getattr(dataset, "parameter_space", None)
    kwargs = {"sampler": args.sampler, "num_steps": args.steps} if hasattr(pipeline, "coeffs") \
        else {}
    n = min(8, real.shape[0])
    gen = pipeline.generate(
        torch.Generator(device=device).manual_seed(0), batch_size=n,
        parameter_space=space.parameters if space is not None else None,
        as_hash_embeddings=use_hash, **kwargs,
    ).float().cpu().numpy()
    w = WassersteinWrapper(blur=0.05, num_iters=50)
    report["wasserstein_gen_vs_real"] = float(w(gen, np.asarray(real[:n])))
    report["generated_finite"] = bool(np.isfinite(gen).all())

    if args.bpd and hasattr(pipeline, "calc_bpd"):
        k = min(4, n)
        # the real rows' own conditions: a class-conditional model needs
        # them, and p(x | y) with the matched y is the density to score
        out = pipeline.calc_bpd(
            torch.as_tensor(np.asarray(real[:k]), device=device),
            torch.Generator(device=device).manual_seed(1),
            conditions=(torch.as_tensor(np.asarray(real_labels[:k]), device=device)
                        if real_labels is not None else None),
        )
        report["total_bpd"] = float(out["total_bpd"].mean())
        report["prior_bpd"] = float(out["prior_bpd"].mean())

    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
