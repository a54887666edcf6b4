"""Sampling / inference entry point of the PyTorch port.

    python -m rho_diffusion_tpu_torch.inference CONFIG.json [-p weights.npz|.pth]
        [-n N] [-d cuda|cpu] [-f] [--work-dir DIR]

Mirrors ``scripts/inference.py`` and the JAX package's
``build_inference_session``/``resolve_inference_params``:

* if ``inference.cache_file`` exists and ``-f`` is not given, plot straight
  from the HDF5 cache;
* otherwise build the pipeline from the config, load the weights (a JAX
  ``.npz`` or a reference ``.pth``; otherwise untrained, seeded params with a
  warning), draw conditions as the first N rows of
  ``inference.parameter_space`` (sha512 embeddings for hash-labelled
  datasets), run the reverse process on the device, and write the HDF5
  cache and the optional plot.

It runs on CUDA unless ``-d cpu`` is given (a config's "tpu" means CUDA) and
raises when CUDA is absent. Orbax checkpoint directories are not read yet.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

import rho_diffusion_tpu_torch  # noqa: F401  (populates the registry)
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.interop.jax_weights import load_state_dict_file
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.utils import resolve_device

PIPELINES = {"DDPM": DDPM}


def build_pipeline_from_config(config: ExperimentConfig, dataset=None, device=None,
                               pipeline_name: Optional[str] = None):
    """The pipeline a config names: schedule from the config, backbone by
    name, MultiEmbeddings over the dataset's parameter space, compute dtype
    from ``training.dtype``, params seeded from ``inference.seed``."""
    name = pipeline_name or (config.pipeline.name if config.pipeline else "GaussianDiffusionPipeline")
    if name not in PIPELINES:
        raise NotImplementedError(
            f"pipeline '{name}' is not ported yet; the port has {sorted(PIPELINES)}",
        )
    pipeline_kwargs = dict(config.pipeline.kwargs) if config.pipeline else {}
    schedule = registry.get("schedules", config.noise_schedule.name)(**config.noise_schedule.kwargs)
    model_kwargs = dict(config.model.kwargs)
    cond_fn = cond_fn_kwargs = None
    if (
        dataset is not None
        and getattr(dataset, "parameter_space", None) is not None
        and isinstance(model_kwargs.get("cond_fn"), str)
    ):
        cond_fn = model_kwargs["cond_fn"]
        cond_fn_kwargs = {
            "parameter_space": dataset.parameter_space,
            "embedding_dim": model_kwargs.get("model_channels", 64) * 4,
        }
    if "dtype" not in model_kwargs and config.training.dtype:
        model_kwargs["dtype"] = config.training.dtype
    return PIPELINES[name](
        backbone=config.model.name,
        backbone_kwargs=model_kwargs,
        schedule=schedule,
        loss_func=config.training.loss_fn,
        cond_fn=cond_fn,
        cond_fn_kwargs=cond_fn_kwargs,
        optimizer=config.optimizer.name if config.optimizer else None,
        opt_kwargs=dict(config.optimizer.kwargs) if config.optimizer else None,
        ema_decay=config.training.ema_decay,
        sample_every_n_epochs=config.training.sample_every_n_epochs,
        save_checkpoint_every_n_epochs=config.training.save_checkpoint_every_n_epochs,
        device=device,
        seed=config.inference.seed,
        **pipeline_kwargs,
    )


def resolve_inference_params(pipeline, config: ExperimentConfig, ckpt=None,
                             work_dir: str | Path = ".") -> list[str]:
    """Load the sampling weights into ``pipeline``: an explicit checkpoint
    file (.npz or .pth) when there is one, else keep the untrained params
    with a warning. Returns the messages to show."""
    ckpt_dir = Path(config.training.checkpoint_dir or (Path(work_dir) / "checkpoints"))
    if ckpt and os.path.isfile(ckpt):
        sd = load_state_dict_file(ckpt, dict(config.model.kwargs))
        pipeline.load_state_dict(sd, strict=True)
        return [f"loaded weights from {ckpt}"]
    if (ckpt and Path(ckpt).is_dir()) or (not ckpt and ckpt_dir.exists()):
        where = ckpt if ckpt else ckpt_dir
        return [
            f"WARNING: {where} is a checkpoint directory, which the port does "
            "not read yet; sampling untrained model",
        ]
    if ckpt:
        return [f"WARNING: checkpoint '{ckpt}' not found; sampling untrained model"]
    return ["WARNING: no checkpoint given and no checkpoint_dir; sampling untrained model"]


def build_inference_session(config: ExperimentConfig, checkpoint=None, work_dir=".",
                            device=None):
    """Pipeline + dataset + weights. Returns ``(pipeline, dataset, messages)``."""
    messages: list[str] = []
    ds_cls = registry.get("datasets", config.dataset.name)
    try:
        dataset = ds_cls(**config.dataset.kwargs)
    except NotImplementedError:
        raise  # a dataset path the port does not have yet
    except Exception:
        dataset = None  # e.g. an HDF5 file not present at inference time
    if (
        checkpoint and str(checkpoint).endswith((".pth", ".pt"))
        and config.noise_schedule.name == "CosineBetaSchedule"
        and "exact_reference" not in config.noise_schedule.kwargs
    ):
        config.noise_schedule.kwargs["exact_reference"] = True
        messages.append("torch checkpoint + cosine schedule: using exact_reference table")
    pipeline = build_pipeline_from_config(config, dataset=dataset, device=device)
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
    args = parser.parse_args(argv)

    config = ExperimentConfig.from_json(args.json_config)
    if config.inference.guidance_scale != 1.0:
        raise NotImplementedError("classifier-free guidance is not ported yet")
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
    use_hash = bool(getattr(dataset, "use_emb_as_labels", False)) if dataset else False
    generator = torch.Generator(device=device).manual_seed(config.inference.seed)
    samples = pipeline.generate(
        generator,
        batch_size=args.n_samples or config.inference.num_samples,
        parameter_space=config.inference.parameter_space,
        random=False,
        as_hash_embeddings=use_hash,
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
