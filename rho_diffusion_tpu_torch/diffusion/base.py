"""Abstract diffusion pipeline: construction, the model call, sampling
helpers and the training step.

Port of ``rho_diffusion_tpu/diffusion/base.py``: the registry-driven
construction (backbone, cond_fn, schedule, loss and optimizer named by
strings), the sample shape and the conditions drawn from a parameter space,
and the training half (:167-433): ``create_state``, ``training_step`` (loss,
gradients, optional gradient accumulation and clipping, the optimizer
update, EMA, grad_norm) and ``validation_step``.

The JAX step is one pure jitted function of a donated state; here the step
updates the live ``TrainState`` in place (parameters, optimizer moments,
EMA) and returns its metrics as device tensors, so a step costs no host
synchronisation. Random draws (timesteps, noise, conditioning-dropout
masks) come from the ``torch.Generator`` in the state, in the JAX order; a
caller may inject them instead (the tests hand the port what JAX drew).

Over a mesh (a state readied by ``parallel.mesh.replicate_state``, as the
Trainer does for a mesh of more than one rank, or for ZeRO-1 or spatial
sharding) the step is JAX's step under GSPMD, run rank by rank
(``parallel.spmd``): the timesteps, noise and masks are drawn for the
global batch as on one device, each data rank's rows (and, under spatial
sharding, each context rank's depth slab of them) run forward on its
device, the loss is the mean of the ranks' equal shares, one backward over
it gives the gradients, summed over the data ranks (on one card the ranks
share the one set of parameters and their gradients add up in place; a
replica on another card adds its gradients in after the backward), and the
global grad norm, clipping, the optimizer step (ZeRO-1's split one, or the
replicated one) and the EMA follow. Under FSDP or tensor parallelism
(``training.sharded``) the split weights are gathered for the forward and
backward of each microbatch, autograd hands each piece its gradient, and
each rank's optimizer updates its pieces. Over several processes (one
process group, ``parallel.runtime``) each process drives its own data
ranks: the draws are still the global batch's, each process keeps its
rows, and after its backward the gradients and metrics are averaged over
the processes, so every process takes the same update. A sharded step
equals the one-device step at the same draws up to summation order.

Sampling goes through ``apply``, which is ``torch.no_grad`` and puts the
backbone in ``eval()``; the train step puts it in ``train()``.

The pipeline owns its device: the backbone and the schedule tables live
there, and parameters are initialised from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import copy
import inspect
from typing import Any, Optional, Union

import numpy as np
import torch

from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from rho_diffusion_tpu_torch.metrics.losses import psnr, psnr_from_parts, psnr_parts, resolve_loss
from rho_diffusion_tpu_torch.ops import quant
from rho_diffusion_tpu_torch.parallel import runtime, spmd
from rho_diffusion_tpu_torch.parallel.mesh import DATA_AXIS, Placed, batch_sharding, shard_batch
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.ema import ema_update
from rho_diffusion_tpu_torch.training.optimizers import Optimizer, build_optimizer
from rho_diffusion_tpu_torch.training.sharded import GridEMA, ShardedOptimizer
from rho_diffusion_tpu_torch.training.state import TrainState
from rho_diffusion_tpu_torch.utils import (
    parameter_space_to_embeddings,
    resolve_device,
    sample_from_discrete_parameter_space,
)


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Slice a [T] coefficient table at per-sample timesteps t [B], shaped
    to broadcast against a rank-``ndim`` batch."""
    return table[t].reshape(t.shape[0], *((1,) * (ndim - 1)))


class AbstractDiffusionPipeline:
    """Construction and model-call machinery shared by diffusion pipelines."""

    def __init__(
        self,
        backbone: Union[str, type],
        backbone_kwargs: dict[str, Any],
        schedule: NoiseSchedule,
        loss_func: Any = "MSELoss",
        timesteps: Optional[int] = None,
        cond_fn: Optional[Union[str, Any]] = None,
        cond_fn_kwargs: Optional[dict] = None,
        optimizer: Optional[Any] = None,
        opt_kwargs: Optional[dict] = None,
        world_size: int = 1,
        ema_decay: float = 0.0,
        clip_grad_norm: Optional[float] = None,
        learning_rate: Optional[Any] = None,
        log_grad_norm: bool = True,
        grad_accum: int = 1,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
        backbone_device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        # where init_params leaves the backbone: the host for a state that is
        # cut into shards there (FSDP's sharded init), else the device
        self.backbone_device = self.device if backbone_device is None \
            else resolve_device(backbone_device)
        self.backbone_kwargs = dict(backbone_kwargs)
        bk = dict(backbone_kwargs)
        # configs name the cond_fn inside the model kwargs; it is built only
        # when kwargs to construct it with are given (as the JAX package does)
        if isinstance(bk.get("cond_fn"), str):
            bk_cond_name = bk.pop("cond_fn")
            if cond_fn is None and cond_fn_kwargs:
                cond_fn = bk_cond_name
        cond_module = None
        if isinstance(cond_fn, str):
            if cond_fn == "ClassifierGuidance":
                raise ValueError(
                    "ClassifierGuidance cannot be used as the model's cond_fn: "
                    "it guides sampling, not conditioning.",
                )
            cond_module = registry.get("layers", cond_fn)(**(cond_fn_kwargs or {}))
        elif cond_fn is not None:
            cond_module = cond_fn
        if isinstance(backbone, str):
            backbone = registry.get("models", backbone)
        if cond_module is not None:
            bk["cond_fn"] = cond_module
        elif bk.get("num_classes") is not None and getattr(
                backbone, "sizes_condition_from_rows", False):
            # a backbone that sizes its condition projection from the
            # precomputed rows it is initialised on, as flax does, takes
            # their width: JAX's pipeline initialises it on rows this wide
            bk.setdefault("condition_dim", self.condition_embedding_dim())
        self.backbone = backbone(**bk)
        self.cond_fn = cond_module
        self.init_params(seed)

        if timesteps is not None and int(timesteps) != len(schedule):
            raise ValueError(
                f"timesteps={timesteps} disagrees with the schedule length "
                f"{len(schedule)} — pass one or the other",
            )
        self.schedule = schedule.to(self.device)
        self.timesteps = timesteps or len(schedule)
        self.loss_func = resolve_loss(loss_func)
        self.ema_decay = float(ema_decay or 0.0)
        self.log_grad_norm = bool(log_grad_norm)
        self.grad_accum = max(int(grad_accum), 1)
        if isinstance(optimizer, Optimizer):
            self.optimizer = optimizer
        else:
            self.optimizer = build_optimizer(optimizer, opt_kwargs,
                                             learning_rate=learning_rate,
                                             world_size=world_size,
                                             clip_grad_norm=clip_grad_norm)

    # ------------------------------------------------------------------
    # Parameters and the model call
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """(Re-)initialise the backbone from a CPU generator seeded with
        ``seed`` (the same values on every device), then move it to the
        pipeline's device (``backbone_device``) in eval mode."""
        gen = torch.Generator().manual_seed(int(seed))
        self.backbone.to("cpu").reset_parameters(gen)
        self.backbone.to(self.backbone_device).eval()

    def for_device(self, device: torch.device, backbone: torch.nn.Module):
        """This pipeline as a rank on ``device`` runs it: a shallow copy whose
        backbone is ``backbone`` (the replica there) and whose tables live
        there."""
        view = copy.copy(self)
        view.device = device
        view.backbone = backbone
        view.schedule = self.schedule.to(device)
        return view

    def load_state_dict(self, state_dict: dict, strict: bool = True) -> None:
        """Load reference-layout backbone weights (strict by default)."""
        self.backbone.load_state_dict(state_dict, strict=strict)

    def call_backbone(self, x, t, y=None, cond_mask=None) -> torch.Tensor:
        """The backbone on (x, t, y), with ``cond_mask`` only when one is
        given: only UNetv2 takes it (JAX ``apply``)."""
        if cond_mask is not None:
            return self.backbone(x, t, y, cond_mask=cond_mask)
        return self.backbone(x, t, y)

    @torch.no_grad()
    def apply(self, x, t, y=None, cond_mask=None) -> torch.Tensor:
        """The sampling-time model call: no autograd, eval mode."""
        self.backbone.eval()
        return self.call_backbone(x, t, y, cond_mask)

    def backbone_supports_cond_mask(self) -> bool:
        """True when the backbone's forward takes per-sample conditioning
        dropout (``cond_mask``), the hook classifier-free guidance and its
        training need (JAX base.py:221-232)."""
        try:
            sig = inspect.signature(type(self.backbone).forward)
        except (TypeError, ValueError):
            return False
        return "cond_mask" in sig.parameters

    def _require_cfg_backbone(self, what: str) -> None:
        if not self.backbone_supports_cond_mask():
            raise ValueError(
                f"{what} requires a backbone with per-sample conditioning dropout support "
                f"(a `cond_mask` forward kwarg); {type(self.backbone).__name__} has none. "
                "Use the UNetv2 backbone or add cond_mask handling to the model.",
            )

    def validate_cond_dropout(self, cond_dropout: float) -> float:
        """``cond_dropout`` in [0, 1), and > 0 only on a backbone that takes
        ``cond_mask`` (JAX base.py:278-283)."""
        if not 0.0 <= cond_dropout < 1.0:
            raise ValueError(f"cond_dropout must be in [0, 1), got {cond_dropout}")
        if cond_dropout > 0.0:
            self._require_cfg_backbone(f"cond_dropout={cond_dropout}")
        return float(cond_dropout)

    def guided_model_fn(self, conditions, guidance_scale):
        """Classifier-free-guided ``fn(x, t)`` (JAX base.py:243-279): out =
        uncond + s (cond - uncond), as one batched forward over [x; x] with a
        per-row conditioning mask (mask-0 rows are the null condition). The
        model should have been trained with ``cond_dropout`` > 0. Channels
        past the data's (learned-variance heads) come from the conditional
        half. A backbone without ``cond_mask`` raises ``ValueError``."""
        self._require_cfg_backbone(f"guidance_scale={guidance_scale}")
        s = float(guidance_scale)

        def guided_fn(x, t):
            b = x.shape[0]
            mask = torch.cat([torch.ones(b, device=x.device), torch.zeros(b, device=x.device)])
            out2 = self.apply(torch.cat([x, x]), torch.cat([t, t]),
                              torch.cat([conditions, conditions]), cond_mask=mask).to(x.dtype)
            cond_out, uncond_out = out2[:b], out2[b:]
            ch = x.shape[-1]
            guided = uncond_out[..., :ch] + s * (cond_out[..., :ch] - uncond_out[..., :ch])
            if cond_out.shape[-1] > ch:
                guided = torch.cat([guided, cond_out[..., ch:]], dim=-1)
            return guided

        return guided_fn

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def create_state(self, seed: int = 0) -> TrainState:
        """A fresh training state over the backbone: its optimizer, an EMA
        copy of the parameters (when ``ema_decay`` > 0) and a generator on
        the pipeline's device seeded with ``seed``."""
        model = self.backbone
        ema = None
        if self.ema_decay > 0:
            ema = {k: p.detach().clone() for k, p in model.named_parameters()}
        return TrainState(
            step=0, model=model, optimizer=self.optimizer.make(model.parameters()), ema=ema,
            generator=torch.Generator(device=self.device).manual_seed(int(seed)),
        )

    def cond_dropout_mask(self, generator, batch_size: int, labels) -> Optional[torch.Tensor]:
        """Per-row Bernoulli keep-mask (1 keeps the condition) for
        classifier-free-guidance training, or None when it is off."""
        p = getattr(self, "cond_dropout", 0.0)
        if p <= 0.0 or labels is None:
            return None
        draw = torch.rand((batch_size,), generator=generator, device=self.device)
        return (draw < 1.0 - p).float()

    def random_timesteps(self, generator, batch_size: int) -> torch.Tensor:
        """Uniform timesteps in [0, T)."""
        return torch.randint(0, self.timesteps, (batch_size,), generator=generator,
                             device=self.device)

    def training_metrics(self, data, noised, loss) -> dict[str, torch.Tensor]:
        """train_loss and PSNR(clean, noised), the reference's logged pair;
        inside a rank of a mesh step, PSNR's parts, which the step combines
        over the ranks."""
        if spmd.current_rank() is not None:
            return {"train_loss": loss, "psnr": psnr_parts(noised, data)}
        return {"train_loss": loss, "psnr": psnr(noised, data)}

    def training_draws(self, generator, shape, dtype, labels) -> dict:
        """The timesteps, noise and conditioning mask of one step over a
        batch of ``shape``, drawn from ``generator`` in the order
        ``loss_and_metrics`` draws them (the mesh step draws them for the
        global batch)."""
        raise NotImplementedError(f"{type(self).__name__} does not train over a mesh")

    def loss_and_metrics(self, batch: dict, generator=None, t=None, noise=None,
                         cond_mask=None):
        """Subclass hook: (loss, metrics) of a normalised batch on the
        device. ``t``, ``noise`` and ``cond_mask`` are drawn from
        ``generator`` unless given."""
        raise NotImplementedError

    def batch_to_device(self, batch) -> dict:
        """A batch as ``{'data', 'labels'}`` tensors on the pipeline's
        device (numpy arrays are copied, device tensors pass through)."""
        out = {}
        for key, value in normalize_batch(batch).items():
            if value is not None and not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            out[key] = None if value is None else value.to(self.device)
        return out

    def training_step(self, state: TrainState, batch, t=None, noise=None,
                      cond_mask=None) -> dict[str, torch.Tensor]:
        """One optimisation step on a batch (a dict, a (data, labels) pair
        or a bare array), in place on ``state``; returns the step's
        metrics (device scalars): the loss and PSNR (averaged over the
        ``grad_accum`` microbatches) and ``grad_norm``, the global norm of
        the gradients before clipping and the update.

        With ``grad_accum`` > 1 the batch is cut into that many sequential
        microbatches whose gradients are averaged before the one update, so
        activation memory is that of one microbatch.

        Raises while int8 quantization is on (``ops.quant``): it is an
        inference-only mode, as in JAX's ``make_train_step``."""
        refusal = quant.training_refusal()
        if refusal is not None:
            raise RuntimeError(refusal)
        if state.mesh is not None:
            return self._mesh_training_step(state, batch, t, noise, cond_mask)
        batch = self.batch_to_device(batch)
        model = state.model
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        accum = self.grad_accum
        n = batch["data"].shape[0]
        if n % accum:
            raise ValueError(f"batch size {n} is not divisible by grad_accum={accum}")
        size = n // accum
        totals: dict = {}
        for i in range(accum):
            rows = slice(i * size, (i + 1) * size)

            def cut(v):
                return None if v is None else v[rows]

            loss, metrics = self.loss_and_metrics(
                {k: cut(v) for k, v in batch.items()}, generator=state.generator,
                t=cut(t), noise=cut(noise), cond_mask=cut(cond_mask))
            (loss / accum if accum > 1 else loss).backward()
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v.detach()
        metrics = {k: v / accum for k, v in totals.items()} if accum > 1 else totals
        return self._update(state, params, metrics)

    def _update(self, state: TrainState, params: list, metrics: dict) -> dict:
        """The step after the backward: missing gradients as zeros, the
        global grad norm and clipping, the optimizer step, the EMA."""
        model = state.model
        for p in params:
            # a parameter the loss does not reach (the cond_fn under precomputed
            # hash-embedding labels) has a zero gradient in JAX, and AdamW still
            # applies its weight decay to it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        clip = self.optimizer.clip_grad_norm
        if self.log_grad_norm or clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if clip:
                # optax.clip_by_global_norm: g * clip / norm when norm >= clip
                torch._foreach_mul_(grads, torch.where(norm < clip, 1.0, clip / norm))
            if self.log_grad_norm:
                metrics["grad_norm"] = norm
        self.optimizer.set_lr(state.optimizer, state.step)
        state.optimizer.step()
        if state.ema is not None:
            if isinstance(state.ema, GridEMA):  # sharded: rank by rank
                state.ema.update(state.step, self.ema_decay)
            else:
                ema_update(state.ema, dict(model.named_parameters()), state.step, self.ema_decay)
        state.step += 1
        return metrics

    def _mesh_training_step(self, state: TrainState, batch, t=None, noise=None,
                            cond_mask=None) -> dict[str, torch.Tensor]:
        """``training_step`` over ``state.mesh`` (module docstring). ``batch``
        is placed (``parallel.mesh.shard_batch``; the sharding of "data" says
        whether its depth is split), or a host batch, placed over "data"."""
        mesh = state.mesh
        if not (isinstance(batch, dict) and isinstance(batch.get("data"), Placed)):
            host = {k: v if v is None or isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v)) for k, v in normalize_batch(batch).items()}
            batch = shard_batch(host, mesh)
        data, labels = batch["data"], batch.get("labels")
        spatial = data.sharding.spatial
        model = state.model
        if spatial:
            if not getattr(model, "supports_spatial_sharding", False):
                raise NotImplementedError(f"spatial sharding of {type(model).__name__}: only the "
                                          "UNetv2 backbone splits its volume over context ranks")
            if getattr(model, "use_checkpoint", False):
                raise NotImplementedError(
                    "use_checkpoint under spatial sharding: the recomputation inside the "
                    "backward would exchange halos with ranks that are no longer running")
        sharded = isinstance(state.optimizer, ShardedOptimizer)
        if spatial and sharded and state.optimizer.tensor_parallel:
            raise NotImplementedError(
                "tensor parallelism under spatial sharding: both split over the context axis "
                "(ROADMAP Queue 1 item 13c)")
        n_data, accum = mesh.shape[DATA_AXIS], self.grad_accum
        if data.shape[0] % (n_data * accum):
            raise ValueError(f"batch size {data.shape[0]} does not split over the {n_data} data "
                             f"ranks and grad_accum={accum}")
        # the draws are the global batch's; over several processes this one
        # holds the rows runtime.process_rows gives it
        rows_here = runtime.process_rows(data.shape[0])
        n_global = data.shape[0] * runtime.process_count()
        if t is None or noise is None or (cond_mask is None and getattr(self, "cond_dropout", 0.0)
                                          > 0.0 and labels is not None):
            drawn = self.training_draws(state.generator, (n_global, *data.shape[1:]), data.dtype,
                                        labels)
            t = drawn["t"] if t is None else t
            noise = drawn["noise"] if noise is None else noise
            cond_mask = drawn["cond_mask"] if cond_mask is None else cond_mask
        if runtime.process_count() > 1:
            t, noise = t[rows_here], noise[rows_here]
            cond_mask = None if cond_mask is None else cond_mask[rows_here]
        rows_sharding = batch_sharding(mesh)
        t = rows_sharding.place(t)
        noise = data.sharding.place(noise)
        cond_mask = None if cond_mask is None else rows_sharding.place(cond_mask)

        first = mesh.devices[0][0]
        params = (state.optimizer.trained_params() if sharded
                  else [p for p in model.parameters() if p.requires_grad])
        with torch.no_grad():
            for replica in state.replicas.values():
                for r, p in zip(replica.parameters(), model.parameters()):
                    r.copy_(p)
                    r.grad = None
        for m in (model, *state.replicas.values()):
            m.train()
        for p in params:
            p.grad = None
        views = {dev: self.for_device(dev, replica) for dev, replica in state.replicas.items()}
        size = data.shape[0] // n_data // accum
        totals: dict = {}
        psnr_parts: list = []
        for i in range(accum):
            rows = slice(i * size, (i + 1) * size)

            def rank_step(rank, rows=rows):
                def cut(placed):
                    return None if placed is None else placed.piece(rank.data, rank.context)[rows]

                return views.get(rank.device, self).loss_and_metrics(
                    {"data": cut(data), "labels": cut(labels)},
                    t=cut(t), noise=cut(noise), cond_mask=cut(cond_mask))

            with state.optimizer.gathered(state) if sharded else contextlib.nullcontext():
                ranks = [r for row in spmd.run_ranks(mesh, rank_step, spatial) for r in row]
                loss = sum(r[0].to(first) for r in ranks) / len(ranks)
                (loss / accum if accum > 1 else loss).backward()
            metrics = {"train_loss": loss.detach()}
            for key in ranks[0][1]:
                values = [r[1][key].detach().to(first) for r in ranks]
                if key == "psnr":
                    psnr_parts.append(torch.stack(values))
                    metrics[key] = psnr_from_parts(values)
                elif key != "train_loss":
                    metrics[key] = sum(values) / len(values)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v
        with torch.no_grad():
            for replica in state.replicas.values():  # the gradient sum over the cards
                for p, r in zip(model.parameters(), replica.parameters()):
                    if r.grad is not None:
                        p.grad = r.grad.to(first) if p.grad is None else p.grad + r.grad.to(first)
        metrics = {k: v / accum for k, v in totals.items()} if accum > 1 else totals
        if runtime.process_count() > 1:
            self._sync_processes(params, metrics, psnr_parts)
        return self._update(state, params, metrics)

    @staticmethod
    @torch.no_grad()
    def _sync_processes(params: list, metrics: dict, psnr_parts: list) -> None:
        """Over several processes: the gradients averaged (each process's are
        those of its ranks' mean loss, and every process holds as many
        ranks), the metrics averaged, PSNR from every process's parts; every
        process then takes the same update."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        runtime.all_reduce_([p.grad for p in params], average=True)
        keys = [k for k in metrics if k != "psnr"]
        values = [metrics[k].reshape(1).float() for k in keys]
        runtime.all_reduce_(values, average=True)
        for k, v in zip(keys, values):
            metrics[k] = v.reshape(()).to(metrics[k].dtype)
        if "psnr" in metrics:
            parts = runtime.all_gather_cat(torch.cat(psnr_parts))
            metrics["psnr"] = psnr_from_parts(list(parts.to(metrics["psnr"].device)))

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch, generator=None) -> dict:
        """The training loss and metrics without an update, in eval mode.
        The draws come from ``generator``, by default one seeded from the
        state's own seed plus one, so the training stream is untouched."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                state.generator.initial_seed() + 1)
        state.model.eval()
        _, metrics = self.loss_and_metrics(self.batch_to_device(batch), generator=generator)
        return metrics

    # ------------------------------------------------------------------
    # Sampling helpers
    # ------------------------------------------------------------------
    def condition_embedding_dim(self) -> int:
        """Width of precomputed condition embeddings: 4 x model_channels."""
        return self.backbone_kwargs.get("model_channels", 64) * 4

    def sample_shape(self, batch_size: int) -> tuple[int, ...]:
        """[B, *data_shape, C] from the backbone kwargs (channels-last)."""
        bk = self.backbone_kwargs
        data_shape = tuple(bk.get("data_shape") or bk["input_shapes"])
        channels = bk.get("in_channels", bk.get("num_channels", bk.get("out_channels", 1)))
        return (batch_size, *data_shape, channels)

    def conditions_from_parameter_space(
        self,
        parameter_space: Optional[dict],
        batch_size: int,
        random: bool = True,
        as_hash_embeddings: bool = False,
        embedding_dim: int = 256,
        seed: int = 0,
    ) -> Optional[torch.Tensor]:
        """Condition rows from a discrete parameter space: random rows, or
        the first N rows in order; as sha512 embeddings on request."""
        if parameter_space is None:
            return None
        if hasattr(parameter_space, "parameters"):
            parameter_space = parameter_space.parameters
        if as_hash_embeddings:
            embs = parameter_space_to_embeddings(parameter_space, l=embedding_dim)
            if random:
                idx = np.random.default_rng(seed).integers(0, embs.shape[0], size=batch_size)
            else:
                idx = np.arange(batch_size) % embs.shape[0]
            rows = embs[idx]
        else:
            rows = sample_from_discrete_parameter_space(
                parameter_space, batch_size, random=random, rng=np.random.default_rng(seed),
            )
        return torch.as_tensor(rows, device=self.device)

    def coerce_conditions(self, conditions, batch_size: int,
                          generator: Optional[torch.Generator] = None):
        """int -> constant vector, "auto" -> random class ids in [0, 10),
        array-likes -> a tensor on the pipeline's device."""
        if conditions is None:
            return None
        if isinstance(conditions, int):
            return torch.full((batch_size,), conditions, dtype=torch.int64, device=self.device)
        if isinstance(conditions, str) and conditions == "auto":
            return torch.randint(0, 10, (batch_size,), generator=generator, device=self.device)
        return torch.as_tensor(np.asarray(conditions) if isinstance(conditions, (list, tuple))
                               else conditions, device=self.device)


def normalize_batch(batch) -> dict:
    """Coerce the supported batch containers into {'data', 'labels'}."""
    if isinstance(batch, dict):
        return {"data": batch["data"], "labels": batch.get("labels")}
    if isinstance(batch, (list, tuple)):
        if len(batch) == 2:
            return {"data": batch[0], "labels": batch[1]}
        return {"data": batch[0], "labels": None}
    return {"data": batch, "labels": None}
