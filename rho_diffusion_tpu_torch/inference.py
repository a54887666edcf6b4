"""Sampling / inference entry point of the PyTorch port.

    python -m rho_diffusion_tpu_torch.inference CONFIG.json [-p weights.npz|.pth]
        [-n N] [-d cuda|cpu] [-f] [--work-dir DIR] [--guidance S]
        [--sampler NAME] [--steps N] [--spacing GRID] [--quant int8]

Mirrors ``scripts/inference.py`` and the JAX package's
``build_inference_session``/``resolve_inference_params``:

* if ``inference.cache_file`` exists and ``-f`` is not given, plot straight
  from the HDF5 cache;
* otherwise build the pipeline from the config (a dataset whose file, or
  h5py, is absent gives the conditioning the parameter space its class
  declares, where it declares one: DeepGalaxyDataset's), load the weights (an
  explicit JAX ``.npz`` or reference ``.pth``, an explicit checkpoint
  directory of the port's trainer, else ``training.checkpoint_dir`` or
  ``<work-dir>/checkpoints``, with the EMA weights per ``inference.use_ema``;
  otherwise untrained, seeded params with a warning), draw conditions as
  the first N rows of ``inference.parameter_space`` (sha512 embeddings for
  hash-labelled datasets), run the reverse process on the device, and write the HDF5
  cache and the optional plot.

``--guidance`` (else ``inference.guidance_scale``) != 1 samples with
classifier-free guidance. ``--sampler``, ``--steps`` and ``--spacing``
belong to the GaussianDiffusion family; each flag wins over the config's
``inference.sampler``, ``inference.ddim_steps`` and ``inference.spacing``,
which win over the pipeline's defaults. The DDPM pipeline ignores the first
two and rejects a spacing, as the service does. ``--quant int8`` samples
with W8A8 convs and Dense sites (``ops.quant``: the int8 kernels S1-S3 on
the card), the mode set for the sampling and restored when ``main``
returns.

It runs on CUDA unless ``-d cpu`` is given (a config's "tpu" means CUDA) and
raises when CUDA is absent. The JAX package's orbax checkpoint directories
are not readable (OCDBT with zstd chunks); that case says so and names the
``model.npz`` the JAX trainer writes beside them, which ``-p`` reads.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.config import ExperimentConfig, apply_torch_checkpoint_schedule_fixup
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace
from rho_diffusion_tpu_torch.ops.quant import conv_quant
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.checkpoint import resolve_inference_params
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config
from rho_diffusion_tpu_torch.utils import resolve_device


def declared_dataset(ds_cls, kwargs: dict):
    """What sampling needs of a dataset that cannot be built (its data file,
    or h5py, absent where the model samples): the parameter space its class
    declares (DeepGalaxyDataset's, over which training built the
    conditioning) and its ``use_emb_as_labels``; None when the class
    declares no space."""
    space = getattr(ds_cls, "parameter_space", None)
    if not isinstance(space, DiscreteParameterSpace):
        return None
    param = inspect.signature(ds_cls).parameters.get("use_emb_as_labels")
    default = param.default if param is not None else False
    return SimpleNamespace(parameter_space=space,
                           use_emb_as_labels=bool(kwargs.get("use_emb_as_labels", default)))


def build_inference_session(config: ExperimentConfig, checkpoint=None, work_dir=".",
                            device=None):
    """Pipeline + dataset + weights. Returns ``(pipeline, dataset, messages)``.
    A dataset that cannot be built stands in as ``declared_dataset``'s
    parameter space, or None."""
    messages: list[str] = []
    ds_cls = registry.get("datasets", config.dataset.name)
    try:
        dataset = ds_cls(**config.dataset.kwargs)
    except Exception as e:  # e.g. an HDF5 file not present at inference time
        dataset = declared_dataset(ds_cls, config.dataset.kwargs)
        messages.append(f"dataset {config.dataset.name} not built ({type(e).__name__}: {e}); "
                        + ("conditioning on its class's parameter space" if dataset is not None
                           else "sampling without it"))
    if apply_torch_checkpoint_schedule_fixup(config, checkpoint):
        messages.append("torch checkpoint + cosine schedule: using exact_reference table")
    pipeline = build_pipeline_from_config(
        config, dataset=dataset, device=device,
        pipeline_name=config.pipeline.name if config.pipeline else "GaussianDiffusionPipeline")
    messages += resolve_inference_params(pipeline, config, checkpoint, work_dir)
    return pipeline, dataset, messages


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("json_config", type=Path)
    parser.add_argument("-p", dest="model_checkpoint_path", type=Path, default=None)
    parser.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-n", dest="n_samples", type=int, default=None)
    parser.add_argument("-f", dest="forced_overwrite", action="store_true", default=False,
                        help="overwrite an existing inference output cache file")
    parser.add_argument("--work-dir", type=Path, default=Path("."))
    parser.add_argument("--sampler", default=None, choices=["ddpm", "ddim", "dpm++", "unipc"],
                        help="GaussianDiffusion family only (over inference.sampler); the "
                             "DDPM pipeline ignores it")
    parser.add_argument("--steps", type=int, default=None,
                        help="respaced sampling steps, GaussianDiffusion family only (over "
                             "inference.ddim_steps); the DDPM pipeline ignores it")
    parser.add_argument("--spacing", default=None,
                        choices=["uniform-t", "uniform-lambda", "trailing", "karras"],
                        help="GaussianDiffusion family only; the DDPM pipeline rejects it")
    parser.add_argument("--guidance", type=float, default=None,
                        help="classifier-free guidance scale (1.0 = off; needs a model "
                             "trained with cond_dropout > 0); overrides inference.guidance_scale")
    parser.add_argument("--quant", default=None, choices=["int8"],
                        help="int8 W8A8 convs and Dense sites (inference only)")
    args = parser.parse_args(argv)

    config = ExperimentConfig.from_json(args.json_config)
    guidance = args.guidance if args.guidance is not None else config.inference.guidance_scale
    device = resolve_device(args.device or config.inference.device)
    cache_file = config.inference.cache_file
    if cache_file and os.path.isfile(cache_file) and not args.forced_overwrite:
        print(f"Found cached generated data: {cache_file}. Plotting it; use -f to regenerate.")
        if config.inference.plot_output_file:
            import h5py

            from rho_diffusion_tpu_torch.utils import plot_tensor_images

            with h5py.File(cache_file, "r") as f:
                data = np.asarray(f["data"])
            plot_tensor_images(data, filename=config.inference.plot_output_file)
        return None

    ckpt = args.model_checkpoint_path or config.inference.checkpoint
    pipeline, dataset, messages = build_inference_session(
        config, checkpoint=ckpt, work_dir=args.work_dir, device=device,
    )
    for m in messages:
        print(m)
    spacing = args.spacing or config.inference.spacing
    kwargs = {"guidance_scale": guidance}
    if hasattr(pipeline, "coeffs"):  # the GaussianDiffusion family
        kwargs.update(sampler=args.sampler or config.inference.sampler,
                      num_steps=args.steps or (config.inference.ddim_steps or None),
                      spacing=spacing)
    elif spacing is not None:
        raise ValueError(
            f"spacing={spacing!r} is a GaussianDiffusion-family respacing control; "
            "the DDPM pipeline always samples its full schedule",
        )
    use_hash = bool(getattr(dataset, "use_emb_as_labels", False)) if dataset else False
    generator = torch.Generator(device=device).manual_seed(config.inference.seed)
    with conv_quant(args.quant) if args.quant else contextlib.nullcontext():
        samples = pipeline.generate(
            generator,
            batch_size=args.n_samples or config.inference.num_samples,
            parameter_space=config.inference.parameter_space,
            random=False,
            as_hash_embeddings=use_hash,
            **kwargs,
        )
    samples = samples.float().cpu().numpy()
    print(f"generated {samples.shape}, finite={np.isfinite(samples).all()}")
    if cache_file:
        import h5py

        with h5py.File(cache_file, "w") as f:
            f["data"] = samples
        print(f"wrote {cache_file}")
    if config.inference.plot_output_file:
        from rho_diffusion_tpu_torch.utils import plot_tensor_images

        plot_tensor_images(samples, filename=config.inference.plot_output_file)
        print(f"wrote {config.inference.plot_output_file}")
    return samples


if __name__ == "__main__":
    main()
