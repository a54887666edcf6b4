"""The training orchestrator, on one device or over a mesh.

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

The mesh (JAX :190-210, :272-276, :425-431): ``Trainer(mesh=...)`` takes a
``parallel.mesh.Mesh``; without one it builds ``training.mesh`` ("data",
"context"; data -1 takes the rest, the default when the config names no
mesh, so a run spans every card as JAX's spans every device) over every
CUDA card this process drives, or over the one CPU with ``device="cpu"``,
a sub-mesh when it asks for fewer ranks, and raises ``ValueError`` when it
asks for more. Tests and chip_smoke pass an explicit ``make_mesh(4, 2,
devices=[...] * 8)``, whose ranks may share a device. Over a mesh of more
than one rank, or with ``zero1``, ``fsdp``, ``tensor_parallel`` or
``spatial_sharding``:

* the batch must divide by the data axis (``ValueError``), the learning
  rate is scaled by sqrt(the mesh's rank count), as JAX's trainer passes
  ``mesh.devices.size`` on;
* each batch is placed on the mesh: rows over "data", and with
  ``spatial_sharding`` the 5-D ``data`` key's depth over "context" (labels
  keep plain batch sharding); ``device_cache`` with ``device_cache_shard``
  splits the table's rows over the data ranks;
* the state is replicated (``replicate_state``), or split as JAX's
  ``init_state`` splits it (JAX :272-341): ``tensor_parallel`` cuts the
  large weights by output channel over "context" (``parallel.tensor``,
  ``tp_min_dim``), ``fsdp`` the parameters, moments and EMA 1/N over
  "data", ``zero1`` the moments and EMA; a fresh FSDP run without TP or
  ``weights_path`` starts straight in its shards (``create_state_fsdp``:
  the pipeline's backbone is built on the host for FSDP and TP runs, and
  only slices reach the cards), and every step runs under ``active_mesh``;
* checkpoints gather the slices and split them on restore, so the exact
  mid-epoch resume holds and a checkpoint moves between sharded and plain
  runs.

Several processes (``parallel.mesh.initialize_distributed``, the
``training_ddp`` and ``training_multihost`` CLIs): the global mesh's data
ranks are split evenly over the processes in process order, each process
drives its own (its context groups stay inside it), the loader builds its
rows of each batch, and the step averages gradients and metrics over the
processes. Only process 0 logs and writes checkpoints; every process waits
at a barrier before one is read.

``fsdp`` and ``zero1`` together raise ``ValueError`` as in JAX. Not ported
yet (``NotImplementedError``, ROADMAP Queue 1 item 13c): ``tensor_parallel``
with ``spatial_sharding``, and ``zero1`` or ``fsdp`` over a data axis that
spans processes. ``device_cache`` over several processes raises
``ValueError`` as JAX's does.
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
from rho_diffusion_tpu_torch.parallel import runtime
from rho_diffusion_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    Mesh,
    active_mesh,
    batch_sharding,
    create_state_fsdp,
    fsdp_abstract_state,
    make_mesh,
    replicate_state,
    shard_batch,
    shard_opt_state_zero1,
    shard_state_fsdp,
)
from rho_diffusion_tpu_torch.parallel.tensor import shard_params_for_tp
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

def build_pipeline_from_config(
    config: ExperimentConfig,
    dataset=None,
    device=None,
    pipeline_name: Optional[str] = None,
    world_size: int = 1,
    steps_per_epoch: int = 1,
    seed: Optional[int] = None,
    backbone_device=None,
):
    """The pipeline a config names: the schedule, the backbone by name,
    MultiEmbeddings over the dataset's parameter space, the compute dtype
    from ``training.dtype``, the optimizer with the LR schedule evaluated
    per update (``steps_per_epoch`` converts its epochs), and parameters
    seeded with ``seed`` (default ``inference.seed``), left on
    ``backbone_device`` (default ``device``)."""
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
        backbone_device=backbone_device,
        **pipeline_kwargs,
    )


def check_mesh_options(config: ExperimentConfig) -> None:
    """JAX's rules for the mesh options, and the port's refusals: fsdp and
    zero1 exclude each other (``ValueError``); tensor parallelism under
    spatial sharding, and zero1 or fsdp over several processes, are not
    ported (``NotImplementedError``, ROADMAP Queue 1 item 13c)."""
    cfg = config.training
    if cfg.fsdp and cfg.zero1:
        raise ValueError("training.fsdp and training.zero1 are mutually exclusive: "
                         "fsdp (ZeRO-3) already shards the optimizer state")
    if cfg.tensor_parallel and cfg.spatial_sharding:
        raise NotImplementedError(
            "training.tensor_parallel with spatial_sharding: both split over the context axis, "
            "which is not ported yet (ROADMAP Queue 1 item 13c)")
    if runtime.process_count() > 1 and (cfg.zero1 or cfg.fsdp):
        raise NotImplementedError(
            "training.zero1 or fsdp over a data axis that spans processes is not ported yet "
            "(ROADMAP Queue 1 item 13c): its slices would be exchanged between processes")


def mesh_from_config(config: ExperimentConfig, device: torch.device) -> Mesh:
    """``training.mesh`` (by default data -1, context 1: every rank) over the
    CUDA cards this process drives (the one CPU when ``device`` is the CPU):
    data -1 takes the rest, a mesh of fewer ranks than devices takes the
    first ones (JAX :190-198), and one of more raises. Over several
    processes the mesh is global: its data ranks are split evenly over the
    processes in process order, and this process's part of the mesh, over
    its own devices, is returned."""
    spec = config.training.mesh or {}
    data, context = int(spec.get("data", -1)), int(spec.get("context", 1))
    devices = [device] if device.type == "cpu" else runtime.local_devices()
    procs = runtime.process_count()
    if data == -1:
        if context < 1 or (len(devices) * procs) % context:
            raise ValueError(f"{len(devices) * procs} devices not divisible by context={context}")
        data = len(devices) * procs // context
    if data % procs:
        raise ValueError(f"the mesh's {data} data ranks do not split over {procs} processes")
    ranks = data // procs * context
    if ranks < len(devices):
        devices = devices[:ranks]
    return make_mesh(data // procs, context, devices)


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
        mesh: Optional[Mesh] = None,
    ) -> None:
        check_mesh_options(config)
        self.profile_dir = profile_dir
        self.config = config
        cfg = config.training
        if mesh is None:
            mesh = mesh_from_config(config, resolve_device(device or cfg.device))
        self.mesh = mesh
        self.device = device = mesh.devices[0][0]
        self.processes = runtime.process_count()
        # the global mesh's ranks: this process's, as many in every process
        self.world_size = mesh.shape[DATA_AXIS] * mesh.shape[CONTEXT_AXIS] * self.processes
        # the mesh step: several ranks, or an option that shards one rank's state
        self.on_mesh = (self.world_size > 1 or cfg.zero1 or cfg.fsdp or cfg.tensor_parallel
                        or cfg.spatial_sharding)
        data_size = mesh.shape[DATA_AXIS] * self.processes
        if cfg.batch_size % data_size:
            raise ValueError(
                f"batch_size {cfg.batch_size} is not divisible by the {data_size}-rank data "
                f"axis. Set training.batch_size to a multiple of {data_size}, or pick a smaller "
                f'mesh via training.mesh = {{"data": N, "context": M}}.')
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        if dataset is None:
            dataset = registry.get("datasets", config.dataset.name)(**config.dataset.kwargs)
        self.dataset = dataset

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
                config, dataset=dataset, device=self.device, world_size=self.world_size,
                steps_per_epoch=max(len(self.loader), 1), seed=cfg.seed,
                backbone_device="cpu" if cfg.fsdp or cfg.tensor_parallel else None)
        self.pipeline = pipeline
        self.checkpoints = CheckpointManager(cfg.checkpoint_dir or self.work_dir / "checkpoints")
        self.loggers = build_loggers(loggers if loggers is not None else cfg.loggers,
                                     self.work_dir)
        self.step_times: list[float] = []

    def log(self, record: dict) -> None:
        if runtime.process_index() != 0:
            return
        for lg in self.loggers:
            lg.log(record)

    @property
    def data_sharding(self) -> dict:
        """The per-key placement of a batch over the mesh: the volume's depth
        over "context" with ``spatial_sharding``, rows over "data" else."""
        return {"data": batch_sharding(self.mesh, self.config.training.spatial_sharding)}

    @functools.cached_property
    def device_cache(self) -> DeviceDatasetCache:
        """The training split on the device (over a mesh: its rows 1/N on
        each data rank's device with ``device_cache_shard``), built on first
        use (``training.device_cache``)."""
        cfg = self.config.training
        if not self.on_mesh:
            return DeviceDatasetCache(self.loader.dataset, collate_fn=self.loader.collate_fn,
                                      device=self.device)
        return DeviceDatasetCache(
            self.loader.dataset, collate_fn=self.loader.collate_fn, device=self.device,
            mesh=self.mesh, per_key=self.data_sharding,
            shard_over_data=cfg.device_cache_shard and self.mesh.shape[DATA_AXIS] > 1)

    # -- state ----------------------------------------------------------
    def init_state(self, resume: bool = True, weights_path: Optional[str] = None) -> TrainState:
        """A fresh state seeded with ``training.seed``; then the backbone
        weights of ``weights_path`` (a ``.pth`` or JAX ``.npz``; the EMA
        keeps the seeded weights, as in the JAX package), or the latest
        checkpoint when resuming; then split over the mesh as JAX's
        ``init_state`` splits it (module docstring)."""
        cfg = self.config.training
        runtime.barrier()  # a checkpoint another process writes is complete
        latest = self.checkpoints.latest_step()
        resuming = resume and latest is not None
        sharded_init = cfg.fsdp and not cfg.tensor_parallel and not weights_path
        if sharded_init:
            make = fsdp_abstract_state if resuming else create_state_fsdp
            state = make(self.pipeline.create_state, cfg.seed, self.mesh)
        else:
            state = self.pipeline.create_state(seed=cfg.seed)
        if weights_path:
            self.pipeline.load_state_dict(load_weights_auto(
                state.model, weights_path, dict(self.config.model.kwargs),
                self.config.model.name))
        elif resuming:
            self.checkpoints.restore(state)
            self.log({"event": "resumed", "step": int(state.step)})
        elif latest is not None:
            self.log({"event": "stale_checkpoints", "latest_step": int(latest),
                      "warning": "starting fresh over existing checkpoints; "
                                 "consider a clean checkpoint_dir"})
        if not self.on_mesh:
            return state
        if cfg.tensor_parallel:
            shard_params_for_tp(state, self.mesh, min_dim=cfg.tp_min_dim)
        elif not cfg.fsdp:
            replicate_state(state, self.mesh)
        if cfg.fsdp and not sharded_init:
            shard_state_fsdp(state, self.mesh)
        elif cfg.zero1:
            shard_opt_state_zero1(state, self.mesh)
        return state

    def save_checkpoint(self, state: TrainState) -> None:
        """The full state's checkpoint and ``model.pth``, from process 0."""
        if runtime.process_index() != 0:
            return
        self.checkpoints.save(state)
        with state.full_weights() as model:
            save_model_weights(model, self.work_dir / "model.pth")

    # -- epoch-end hooks ------------------------------------------------
    def maybe_sample(self, state: TrainState, epoch: int) -> None:
        every = self.config.training.sample_every_n_epochs
        if not every or (epoch + 1) % every:
            return
        from rho_diffusion_tpu_torch.utils import plot_tensor_images

        use_ema = state.ema is not None and self.config.training.sample_params != "raw"
        space = getattr(self.dataset, "parameter_space", None)
        with state.full_weights(), (swapped_weights(state.model, state.ema) if use_ema
                                    else contextlib.nullcontext()):
            samples = self.pipeline.generate(
                torch.Generator(device=self.device).manual_seed(epoch),
                batch_size=min(self.config.training.batch_size, 16),
                parameter_space=space.parameters if space is not None else None,
                as_hash_embeddings=bool(getattr(self.dataset, "use_emb_as_labels", False)),
            )
        if runtime.process_index() == 0:
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
            with state.full_weights():
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
        self.save_checkpoint(state)

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
                elif self.on_mesh:
                    batches = prefetch(shard_batch(b, self.mesh, self.data_sharding)
                                       for b in self.loader.iter_batches(skip))
                else:
                    batches = prefetch_to_device(prefetch(self.loader.iter_batches(skip)),
                                                 self.device)
                n_steps = 0
                t_step = time.perf_counter()
                for batch in batches:
                    if preempted:
                        break
                    with active_mesh(self.mesh if self.on_mesh else None):
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
                    if runtime.process_index() == 0:
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
        self.save_checkpoint(state)
        for lg in self.loggers:
            lg.close()
        return state
