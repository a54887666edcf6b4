"""Progressive-distillation entry point of the PyTorch port: halve a trained
pipeline's sampling steps.

    python -m rho_diffusion_tpu_torch.distill CONFIG.json -p teacher.pth
        [--from 32] [--to 4] [--updates 1000] [--lr 1e-4] [--batch-size B]
        [-o student.pth] [--sample-output grid.png] [--seed 0]
        [--work-dir DIR] [-d cuda|cpu]

Mirrors ``scripts/distill.py``: loads the teacher as the inference CLI does
(``inference.build_inference_session``: a port ``.pth``, a reference UNetv2
or diffusers UNet2DModel ``.pth``, a JAX ``.npz``, or the latest checkpoint
under the work dir), cascades the halving stages 32 -> 16 -> ... -> 4
(``diffusion.distill.ProgressiveDistiller``; the data drawn from the
config's dataset, each stage's j and noise from a generator seeded with
``--seed``) and writes the student's weights with ``save_model_weights``
(a ``.pth``). Sample it with

    python -m rho_diffusion_tpu_torch.inference CONFIG.json -p student.pth \\
        --sampler ddim --steps 4 --spacing trailing

(the trailing grid is the one the student was trained on). It needs a
GaussianDiffusion-family pipeline (a coefficient table to stride) and a
dataset it can build. It runs on CUDA unless ``-d cpu`` is given and raises
when CUDA is absent.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rho_diffusion_tpu_torch.diffusion.distill import ProgressiveDistiller
from rho_diffusion_tpu_torch.inference import build_inference_session
from rho_diffusion_tpu_torch.training.checkpoint import save_model_weights
from rho_diffusion_tpu_torch.utils import resolve_device


def main(argv: Optional[Sequence[str]] = None):
    """Runs the cascade; returns (student module, per-stage losses)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("json_config", type=Path)
    parser.add_argument("-p", dest="model_checkpoint_path", type=Path, default=None)
    parser.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--from", dest="from_steps", type=int, default=32,
                        help="teacher grid size the cascade starts from (a 2^k multiple of --to)")
    parser.add_argument("--to", dest="to_steps", type=int, default=4,
                        help="student model evaluations to distill down to")
    parser.add_argument("--updates", type=int, default=1000,
                        help="optimizer updates per halving stage")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default: training.batch_size")
    parser.add_argument("-o", "--output", type=Path, default=Path("student.pth"),
                        help="student weights output (.pth, loadable through -p everywhere)")
    parser.add_argument("--sample-output", type=Path, default=None,
                        help="optionally sample the student and write a PNG grid here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--work-dir", type=Path, default=Path("."))
    args = parser.parse_args(argv)

    config = ExperimentConfig.from_json(args.json_config)
    device = resolve_device(args.device or config.training.device)
    ckpt = args.model_checkpoint_path or config.inference.checkpoint
    pipeline, dataset, messages = build_inference_session(
        config, checkpoint=ckpt, work_dir=args.work_dir, device=device)
    for m in messages:
        print(m)
    if not hasattr(pipeline, "coeffs"):
        raise SystemExit(
            f"distillation needs the GaussianDiffusion pipeline family "
            f"(a coefficient table to stride); got {type(pipeline).__name__}",
        )
    if dataset is None or not hasattr(dataset, "__getitem__"):
        raise SystemExit(
            "the configured dataset could not be constructed — distillation "
            "draws x_t from real data (config.dataset)",
        )
    batch_size = args.batch_size or config.training.batch_size
    if len(dataset) < batch_size:
        raise SystemExit(f"the dataset holds {len(dataset)} items, fewer than one batch of "
                         f"{batch_size}")

    def epochs():
        while True:  # the cascade takes stages * updates batches
            yield from prefetch_to_device(
                iter(DataLoader(dataset, batch_size=batch_size, num_workers=0)), device)

    data = epochs()
    d = ProgressiveDistiller(pipeline, opt_kwargs={"lr": args.lr})
    student, info = d.distill(
        pipeline.backbone, lambda _i: next(data), from_steps=args.from_steps,
        to_steps=args.to_steps, updates_per_stage=args.updates,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        log_fn=lambda rec: print(f"stage {rec['stage']}: loss {rec['loss_first']:.4f} -> "
                                 f"{rec['loss_last']:.4f}", flush=True),
    )
    save_model_weights(student, args.output)
    print(f"wrote {args.output} ({args.to_steps}-step student; sample with "
          f"--steps {args.to_steps} --spacing trailing)")

    if args.sample_output:
        from rho_diffusion_tpu_torch.utils import plot_tensor_images

        n = config.inference.num_samples or 8
        space = config.inference.parameter_space or getattr(dataset, "parameter_space", None)
        conds = None
        if space is not None:
            conds = pipeline.conditions_from_parameter_space(
                space, n, random=False,
                as_hash_embeddings=bool(getattr(dataset, "use_emb_as_labels", False)),
                embedding_dim=pipeline.condition_embedding_dim())
        out = d.sample(student, pipeline.sample_shape(n), n_steps=args.to_steps,
                       conditions=conds,
                       generator=torch.Generator(device=device).manual_seed(args.seed + 1))
        out = out.float().cpu().numpy()
        print(f"sampled {out.shape}, finite={np.isfinite(out).all()}")
        plot_tensor_images(out, filename=args.sample_output)
        print(f"wrote {args.sample_output}")
    return student, info


if __name__ == "__main__":
    main()
