"""The training orchestrator, on one device.

Port of ``rho_diffusion_tpu/training/trainer.py``: ``build_pipeline_from_config``
(:49-126) and ``Trainer`` (:168-581), kept:

* the loop feeds batches, built in a background thread and copied to the
  device ahead of use, into ``pipeline.training_step``; with
  ``training.device_cache`` the dataset is uploaded once and each batch is
  a gather on the device in the host loader's order (``DeviceDatasetCache``);
* exact mid-epoch resume: the data cursor is (step // steps_per_epoch,
  step % steps_per_epoch) and each epoch's permutation is a function of
  (seed, epoch), so a resumed run replays the uninterrupted batch sequence;
* epoch-end hooks: validation on a held-out split, sampling (EMA or raw
  weights per ``training.sample_params``) and checkpoints, each every N
  epochs; a final checkpoint and ``model.pth`` at the end;
* SIGTERM/SIGINT checkpoint the full state and stop (a second SIGINT
  raises);
* a non-finite loss raises ``RuntimeError``;
* ``benchmark_mode`` logs steps/s and the median step time;
* ``profile_dir`` traces the whole ``fit`` with ``torch.profiler``
  (``training.profiling.trace``) and writes the chrome trace there when it
  ends, as the JAX trainer traces it with ``jax.profiler``.

The JAX package's mesh options have no single-device meaning and raise
``NotImplementedError`` instead of being ignored: a ``mesh`` over more than
one device (so also ``device_cache_shard``'s table over a data mesh),
``tensor_parallel``, ``fsdp``, ``zero1`` and ``spatial_sharding``.
"""
from __future__ import annotations

import contextlib
import functools
import signal
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.device_cache import DeviceDatasetCache
from rho_diffusion_tpu_torch.data.loader import DataLoader, Subset, prefetch, prefetch_to_device
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_weights_auto,
    save_model_weights,
)
from rho_diffusion_tpu_torch.training.loggers import build_loggers
from rho_diffusion_tpu_torch.training.optimizers import build_lr_schedule
from rho_diffusion_tpu_torch.training.profiling import trace
from rho_diffusion_tpu_torch.training.state import TrainState
from rho_diffusion_tpu_torch.utils import resolve_device

_UNSUPPORTED = ("tensor_parallel", "fsdp", "zero1", "spatial_sharding")


def build_pipeline_from_config(
    config: ExperimentConfig,
    dataset=None,
    device=None,
    pipeline_name: Optional[str] = None,
    world_size: int = 1,
    steps_per_epoch: int = 1,
    seed: Optional[int] = None,
):
    """The pipeline a config names: the schedule, the backbone by name,
    MultiEmbeddings over the dataset's parameter space, the compute dtype
    from ``training.dtype``, the optimizer with the LR schedule evaluated
    per update (``steps_per_epoch`` converts its epochs), and parameters
    seeded with ``seed`` (default ``inference.seed``)."""
    from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
    from rho_diffusion_tpu_torch.diffusion.diffusers_compat import DiffusersDDPMPipeline
    from rho_diffusion_tpu_torch.diffusion.gaussian import GaussianDiffusionPipeline

    pipelines = {"DDPM": DDPM, "GaussianDiffusionPipeline": GaussianDiffusionPipeline,
                 "DiffusersDDPMPipeline": DiffusersDDPMPipeline}
    name = pipeline_name or (config.pipeline.name if config.pipeline else "DDPM")
    if name not in pipelines:
        raise KeyError(f"unknown pipeline '{name}'; available: {sorted(pipelines)}")
    pipeline_kwargs = dict(config.pipeline.kwargs) if config.pipeline else {}
    schedule = registry.get("schedules", config.noise_schedule.name)(**config.noise_schedule.kwargs)
    opt_kwargs = dict(config.optimizer.kwargs) if config.optimizer else {}
    learning_rate = None
    if config.lr_scheduler is not None:
        base_lr = opt_kwargs.get("lr", opt_kwargs.get("learning_rate", 1e-3))
        learning_rate = build_lr_schedule(config.lr_scheduler.name, base_lr, steps_per_epoch,
                                          config.lr_scheduler.kwargs)
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
    return pipelines[name](
        backbone=config.model.name,
        backbone_kwargs=model_kwargs,
        schedule=schedule,
        loss_func=config.training.loss_fn,
        cond_fn=cond_fn,
        cond_fn_kwargs=cond_fn_kwargs,
        optimizer=config.optimizer.name if config.optimizer else None,
        opt_kwargs=opt_kwargs,
        learning_rate=learning_rate,
        world_size=world_size,
        ema_decay=config.training.ema_decay,
        log_grad_norm=config.training.log_grad_norm,
        grad_accum=config.training.grad_accum,
        sample_every_n_epochs=config.training.sample_every_n_epochs,
        save_checkpoint_every_n_epochs=config.training.save_checkpoint_every_n_epochs,
        device=device,
        seed=config.inference.seed if seed is None else seed,
        **pipeline_kwargs,
    )


def check_single_device(config: ExperimentConfig) -> None:
    """Raise for the training options that need more than one device."""
    cfg = config.training
    mesh = cfg.mesh or {}
    if int(mesh.get("data", -1)) not in (-1, 1) or int(mesh.get("context", 1)) != 1:
        raise NotImplementedError(
            f"training.mesh {mesh} spans more than one device; the port trains on one "
            "(ROADMAP Queue 1, context-parallel training across GPUs)",
        )
    on = [name for name in _UNSUPPORTED if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"training options {on} are not ported (one device only)")


@contextlib.contextmanager
def swapped_weights(model: torch.nn.Module, weights: dict[str, torch.Tensor]):
    """Run the body with ``weights`` (by parameter name) in ``model``'s
    parameters, then put the originals back."""
    params = dict(model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


class Trainer:
    """Config-driven training loop on one device."""

    def __init__(
        self,
        config: ExperimentConfig,
        pipeline=None,
        dataset=None,
        work_dir: str | Path = ".",
        device=None,
        loggers=None,
        profile_dir: Optional[str] = None,
    ) -> None:
        check_single_device(config)
        self.profile_dir = profile_dir
        self.config = config
        self.device = resolve_device(device or config.training.device)
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        if dataset is None:
            dataset = registry.get("datasets", config.dataset.name)(**config.dataset.kwargs)
        self.dataset = dataset

        cfg = config.training
        train_ds, self.val_ds = dataset, None
        if cfg.val_fraction > 0:
            n = len(dataset)
            n_val = max(int(n * cfg.val_fraction), 1)
            perm = np.random.default_rng(cfg.seed).permutation(n)
            train_ds = Subset(dataset, perm[n_val:])
            self.val_ds = Subset(dataset, perm[:n_val])
        self.loader = DataLoader(train_ds, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed)
        self.val_loader = (
            DataLoader(self.val_ds, batch_size=cfg.batch_size, shuffle=False, seed=cfg.seed,
                       drop_last=False)
            if self.val_ds is not None and len(self.val_ds) > 0 else None
        )
        if pipeline is None:
            pipeline = build_pipeline_from_config(
                config, dataset=dataset, device=self.device,
                steps_per_epoch=max(len(self.loader), 1), seed=cfg.seed)
        self.pipeline = pipeline
        self.checkpoints = CheckpointManager(cfg.checkpoint_dir or self.work_dir / "checkpoints")
        self.loggers = build_loggers(loggers if loggers is not None else cfg.loggers,
                                     self.work_dir)
        self.step_times: list[float] = []

    def log(self, record: dict) -> None:
        for lg in self.loggers:
            lg.log(record)

    @functools.cached_property
    def device_cache(self) -> DeviceDatasetCache:
        """The training split on the device, built on first use
        (``training.device_cache``)."""
        return DeviceDatasetCache(self.loader.dataset, collate_fn=self.loader.collate_fn,
                                  device=self.device)

    # -- state ----------------------------------------------------------
    def init_state(self, resume: bool = True, weights_path: Optional[str] = None) -> TrainState:
        """A fresh state seeded with ``training.seed``; then the backbone
        weights of ``weights_path`` (a ``.pth`` or JAX ``.npz``; the EMA
        keeps the seeded weights, as in the JAX package), or the latest
        checkpoint when resuming."""
        state = self.pipeline.create_state(seed=self.config.training.seed)
        latest = self.checkpoints.latest_step()
        if weights_path:
            self.pipeline.load_state_dict(load_weights_auto(
                state.model, weights_path, dict(self.config.model.kwargs),
                self.config.model.name))
        elif resume and latest is not None:
            self.checkpoints.restore(state)
            self.log({"event": "resumed", "step": int(state.step)})
        elif latest is not None:
            self.log({"event": "stale_checkpoints", "latest_step": int(latest),
                      "warning": "starting fresh over existing checkpoints; "
                                 "consider a clean checkpoint_dir"})
        return state

    # -- epoch-end hooks ------------------------------------------------
    def maybe_sample(self, state: TrainState, epoch: int) -> None:
        every = self.config.training.sample_every_n_epochs
        if not every or (epoch + 1) % every:
            return
        from rho_diffusion_tpu_torch.utils import plot_tensor_images

        use_ema = state.ema is not None and self.config.training.sample_params != "raw"
        space = getattr(self.dataset, "parameter_space", None)
        with swapped_weights(state.model, state.ema) if use_ema else contextlib.nullcontext():
            samples = self.pipeline.generate(
                torch.Generator(device=self.device).manual_seed(epoch),
                batch_size=min(self.config.training.batch_size, 16),
                parameter_space=space.parameters if space is not None else None,
                as_hash_embeddings=bool(getattr(self.dataset, "use_emb_as_labels", False)),
            )
        out = self.work_dir / f"output_{epoch}.png"
        plot_tensor_images(samples.float().cpu().numpy(), filename=str(out))
        self.log({"event": "sampled", "epoch": epoch, "file": str(out)})

    def maybe_validate(self, state: TrainState, epoch: int) -> None:
        every = self.config.training.validate_every_n_epochs
        if self.val_loader is None or not every or (epoch + 1) % every:
            return
        losses, psnrs, weights = [], [], []
        for batch in self.val_loader:
            valid = batch.pop("valid", None)
            if valid is not None:
                # the wrap-padded rows of the short last batch are a suffix
                n = int(np.sum(valid))
                if n == 0:
                    continue
                batch = {k: v[:n] if isinstance(v, np.ndarray) else v for k, v in batch.items()}
            m = self.pipeline.validation_step(state, batch)
            losses.append(float(m["train_loss"]))
            psnrs.append(float(m["psnr"]))
            weights.append(len(batch["data"]))
        if losses:
            self.log({"event": "validation", "epoch": epoch,
                      "val_loss": float(np.average(losses, weights=weights)),
                      "val_psnr": float(np.average(psnrs, weights=weights))})

    def maybe_checkpoint(self, state: TrainState, epoch: int) -> None:
        every = self.config.training.save_checkpoint_every_n_epochs
        if not every or (epoch + 1) % every:
            return
        self.checkpoints.save(state)
        save_model_weights(state.model, self.work_dir / "model.pth")

    # -- main loop ------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None,
            max_epochs: Optional[int] = None) -> TrainState:
        """Train. Without ``max_epochs``, ``training.max_epochs`` is the
        total budget (a resumed run finishes the rest); ``max_epochs=N``
        means N further epochs from the current cursor."""
        cfg = self.config.training
        if state is None:
            state = self.init_state()
        log_every = max(cfg.log_every_n_steps, 1)
        preempted: list = []
        prev_handlers = {}

        def on_signal(signum, frame):
            if signum == signal.SIGINT and signal.SIGINT in preempted:
                signal.signal(signal.SIGINT,
                              prev_handlers.get(signal.SIGINT, signal.default_int_handler))
                raise KeyboardInterrupt
            preempted.append(signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass

        spe = max(len(self.loader), 1)
        start_epoch, skip_batches = divmod(int(state.step), spe)
        end_epoch = start_epoch + max_epochs if max_epochs is not None \
            else max(cfg.max_epochs, start_epoch)
        profiling = contextlib.ExitStack()
        try:
            if self.profile_dir:
                profiling.enter_context(trace(self.profile_dir))
            for epoch in range(start_epoch, end_epoch):
                if preempted:
                    break
                self.loader.set_epoch(epoch)
                skip = skip_batches if epoch == start_epoch else 0
                if cfg.device_cache:
                    batches = self.device_cache.batches(self.loader, skip)
                else:
                    batches = prefetch_to_device(prefetch(self.loader.iter_batches(skip)),
                                                 self.device)
                n_steps = 0
                t_step = time.perf_counter()
                for batch in batches:
                    if preempted:
                        break
                    metrics = self.pipeline.training_step(state, batch)
                    n_steps += 1
                    step = int(state.step)
                    if step % log_every == 0 or n_steps == 1:
                        loss = float(metrics["train_loss"])  # waits for the step
                        if not np.isfinite(loss):
                            raise RuntimeError(
                                f"non-finite train_loss {loss} at step {step} (epoch {epoch}) "
                                "— aborting",
                            )
                        now = time.perf_counter()
                        dt = (now - t_step) / min(n_steps, log_every)
                        t_step = now
                        rec = {"step": step, "epoch": epoch, "train_loss": loss,
                               "psnr": float(metrics["psnr"])}
                        if "grad_norm" in metrics:
                            rec["grad_norm"] = float(metrics["grad_norm"])
                        if cfg.benchmark_mode:
                            rec["step_s"] = dt
                            rec["steps_per_sec"] = 1.0 / max(dt, 1e-9)
                            self.step_times.append(dt)
                        self.log(rec)
                if preempted:
                    self.checkpoints.save(state)
                    self.log({"event": "preempted", "signal": int(preempted[0]),
                              "step": int(state.step)})
                    break
                self.maybe_validate(state, epoch)
                self.maybe_sample(state, epoch)
                self.maybe_checkpoint(state, epoch)
                if epoch + 1 >= end_epoch:
                    break
            if cfg.benchmark_mode and self.step_times:
                median = float(np.median(self.step_times))
                self.log({"event": "benchmark", "median_step_s": median,
                          "steps_per_sec": 1.0 / median})
        finally:
            profiling.close()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        self.checkpoints.save(state)
        save_model_weights(state.model, self.work_dir / "model.pth")
        for lg in self.loggers:
            lg.close()
        return state
