"""What the 3-D Y_lm quality harnesses share: the model, the data, the
matched conditions, the exact fields, the training loop and the scorer.

The JAX package's eight 3-D harnesses (``benchmarks/sampler_quality.py``,
``ema_ablation.py``, ``demo_min_snr.py``, ``demo_cfg.py``, ``sh_holdout.py``,
``demo_distill.py``, ``vit_ab.py``, ``demo64.py``) each repeat one setup:

* the conditional 16^3 UNetv2 (``BACKBONE``: width 64, mult (1, 2, 4),
  attention at ds 8 and 4 with 4 heads, scale-shift norm, bf16) on
  ``SphericalHarmonicDataset(max_l=5)`` fields, LinearSchedule(1000), AdamW,
  EMA 0.9999, parameters from seed 777;
* the first ``BATCH`` physical (l, m) pairs (|m| <= l, l < 5) as matched
  conditions: their sha512 rows at ``4 * MC`` (the dataset's own labels)
  and their exact fields ``compute_spherical_harmonic`` on the dataset's
  grid;
* the scorer: matched-condition MSE (numpy) and the mean Sinkhorn
  divergence (``metrics.WassersteinWrapper``) of a generated batch against
  those fields, and the same of a Gaussian-noise batch as the baseline;
* sampling with the EMA weights from seed 5.

Here they are written once. Draws come from ``torch.Generator``s seeded as
the JAX scripts seed their keys (777 for the parameters, 5 for sampling, 0
for the noise baseline); JAX and torch draw different streams, so the
port's numbers are its own.

Every harness runs as ``python -m rho_diffusion_tpu_torch.benchmarks.<name>
[-d cuda|cpu] [--work-dir DIR]`` (CUDA unless ``-d cpu``; without CUDA it
raises) and writes its report as JSON under the work dir (default
``build/<name>``), never into ``docs/demo/``. Each report carries the
JAX script's keys plus ``device`` (the card's nvidia-smi name and power
limit) and ``train_steps_per_s``.

Two knobs every harness reads, beside its JAX script's own:

* ``<PREFIX>_SMOKE=1`` (the harness's knob prefix, as ``LV_SMOKE``) cuts it
  to CPU size (``SMOKE_CUT``): 4^3 fields, one level of one res block with
  attention at ds 1 (64 tokens of head dim 64), fp32, a 20-step schedule
  and a few steps of training; the width stays 64, since the dataset's
  sha512 labels are 256 wide and the UNet adds them to its 4 x
  model_channels time embedding;
* ``YLM_MAX_STEPS=N`` caps every sampler's step count at N (rows and keys
  name the steps that ran); unset, every count is the JAX script's.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks._timing import device_line, parse_device
from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rho_diffusion_tpu_torch.data.synthetic import (
    SphericalHarmonicDataset,
    compute_spherical_harmonic,
)
from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline, LinearSchedule
from rho_diffusion_tpu_torch.metrics import WassersteinWrapper
from rho_diffusion_tpu_torch.utils import calculate_sha512_embedding

REPO = Path(__file__).resolve().parents[2]
MC = 64
MAX_L = 5
INIT_SEED = 777
SAMPLE_SEED = 5
NOISE_SEED = 0
# sampler_quality.py:50-55 (the eight scripts' backbone_kwargs, at GRID^3)
BACKBONE = dict(dims=3, in_channels=1, out_channels=1, model_channels=MC, num_res_blocks=2,
                channel_mult=(1, 2, 4), attention_resolutions=[8, 4], num_heads=4,
                num_classes=20, use_scale_shift_norm=True, dtype="bfloat16")
SMOKE_CUT = dict(num_res_blocks=1, channel_mult=(1,), attention_resolutions=[1], num_heads=1,
                 dtype="float32")
SMOKE_GRID = 4
SMOKE_SCHEDULE = dict(num_steps=20, beta_1=2e-4, beta_T=1e-2)


def knob(name: str, default):
    """An environment knob, typed as its default."""
    return type(default)(os.environ.get(name, default))


def is_smoke(prefix: str) -> bool:
    return os.environ.get(f"{prefix}_SMOKE") == "1"


def max_steps(n: int) -> int:
    """``n`` capped at ``YLM_MAX_STEPS`` when it is set."""
    cap = os.environ.get("YLM_MAX_STEPS")
    return min(int(n), int(cap)) if cap else int(n)


def backbone_kwargs(grid: int, smoke: bool = False, **over) -> dict:
    """The harnesses' UNetv2 at grid^3 (the CPU cut under ``smoke``)."""
    kw = dict(data_shape=(grid,) * 3, **BACKBONE)
    if smoke:
        kw.update(SMOKE_CUT)
    kw.update(over)
    return kw


def schedule(smoke: bool = False):
    return LinearSchedule(**SMOKE_SCHEDULE) if smoke else LinearSchedule(1000)


def physical_pairs(n: Optional[int] = None, max_l: int = MAX_L) -> list:
    """The (l, m) pairs the dataset emits (|m| <= l), in the scripts'
    order; the first ``n`` of them."""
    pairs = [(l, m) for l in range(max_l) for m in range(-l, l + 1)]  # noqa: E741
    return pairs if n is None else pairs[:n]


def condition_rows(pairs: Sequence, width: int = 4 * MC) -> np.ndarray:
    """The sha512 rows of ``{"l", "m"}`` at ``width``: the dataset's labels."""
    return np.stack([calculate_sha512_embedding({"l": l, "m": m}, l=width) for l, m in pairs])


def exact_fields(dset, pairs: Sequence) -> np.ndarray:
    """The true fields [N, g, g, g, 1] (fp32) of ``pairs`` on the dataset's
    grid."""
    grid = {k: dset.grid_kwargs[k] for k in ("x", "y", "z")}
    return np.stack([compute_spherical_harmonic(**grid, m=m, l=l)[1].astype(np.float32)[..., None]
                     for l, m in pairs])


def dataset(grid: int, length: int, **kwargs) -> SphericalHarmonicDataset:
    return SphericalHarmonicDataset(max_l=MAX_L, grid_el=grid, length=length, **kwargs)


def noise_like(shape, seed: int = NOISE_SEED) -> np.ndarray:
    """The noise baseline's batch: standard normal from a seeded generator."""
    return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(seed)).numpy()


class Scorer:
    """Matched-condition MSE and the Sinkhorn divergence against ``real``."""

    def __init__(self, real: np.ndarray) -> None:
        self.real = np.asarray(real, np.float32)
        self.w = WassersteinWrapper()

    def mse(self, samples) -> float:
        return float(np.mean((as_numpy(samples) - self.real) ** 2))

    def per_pair_mse(self, samples) -> np.ndarray:
        return np.mean((as_numpy(samples) - self.real) ** 2, axis=tuple(range(1, self.real.ndim)))

    def sinkhorn(self, samples) -> float:
        return float(np.mean(self.w(as_numpy(samples), self.real).numpy()))

    def __call__(self, samples) -> dict:
        samples = as_numpy(samples)
        return {"matched_mse": self.mse(samples), "sinkhorn": self.sinkhorn(samples),
                "finite": bool(np.isfinite(samples).all())}

    def noise(self) -> dict:
        noise = noise_like(self.real.shape)
        return {"matched_mse": self.mse(noise), "sinkhorn": self.sinkhorn(noise)}


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(pipe, state, loader: DataLoader, steps: int, log_every: int = 0, tag: str = "",
          extra: Sequence[str] = ()) -> dict:
    """``steps`` training steps over ``loader``'s batches (copied to the
    pipeline's device ahead of use). Every ``log_every`` steps and at the
    last, the loss (and the metrics named in ``extra``, falling back to the
    loss) is read, printed with the steps/s so far, and kept in ``curve``.
    Returns the curve, the last loss, the wall seconds and steps/s."""
    device = pipe.device
    curve, metrics, done = [], None, 0
    t0 = time.perf_counter()
    for i, b in enumerate(prefetch_to_device(iter(loader), device)):
        if i >= steps:
            break
        metrics = pipe.training_step(state, b)
        done = i + 1
        if log_every and (i % log_every == 0 or i == steps - 1):
            rec = {"step": i, "loss": float(metrics["train_loss"])}
            rec.update({k: float(metrics.get(k, metrics["train_loss"])) for k in extra})
            curve.append(rec)
            print(f"{tag}step {i} " + " ".join(f"{k} {v:.4f}" for k, v in rec.items()
                                                if k != "step")
                  + f" ({done / (time.perf_counter() - t0):.2f} steps/s)", flush=True)
    sync(device)
    wall = time.perf_counter() - t0
    return {"curve": curve, "final_loss": None if metrics is None else
            float(metrics["train_loss"]), "wall_s": wall, "steps": done,
            "steps_per_s": done / wall if wall > 0 else None}


def train_for_wall(pipe, state, loader: DataLoader, wall: float) -> dict:
    """Training steps until ``wall`` seconds have passed, timed from the end
    of the first step (which builds and loads the kernels, as JAX's first
    step compiles), cycling ``loader``'s epochs. The clock is read every
    step (JAX reads it every 200 steps, its sync point), so a budget of a
    few seconds stops in time; the host enqueues at most a step or so
    ahead of the device."""
    device = pipe.device
    steps, metrics, t_start = 0, None, None
    while True:
        for b in prefetch_to_device(iter(loader), device):
            metrics = pipe.training_step(state, b)
            if t_start is None:
                float(metrics["train_loss"])  # block on the first step
                t_start = time.perf_counter()
                continue
            steps += 1
            if time.perf_counter() - t_start > wall:
                break
        else:
            loader.set_epoch(loader.epoch + 1)
            continue
        break
    loss = float(metrics["train_loss"])
    elapsed = time.perf_counter() - t_start
    return {"steps": steps, "wall_s": elapsed, "steps_per_s": steps / elapsed,
            "final_loss": loss}


def ema_weights(state) -> dict:
    """The EMA weights by parameter name (the raw ones without EMA)."""
    if state.ema is not None:
        return state.ema
    return {k: p.detach() for k, p in state.model.named_parameters()}


def full_state_dict(module: torch.nn.Module, weights: dict) -> dict:
    """``module``'s state_dict with its parameters replaced by ``weights``."""
    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    sd.update({k: v.detach().clone() for k, v in weights.items()})
    return sd


def sampling_pipeline(backbone: str, kwargs: dict, weights: dict, device, smoke: bool = False,
                      **pipe_kwargs) -> GaussianDiffusionPipeline:
    """The scripts' sampler pipeline (epsilon, fixed_large, LinearSchedule
    over the training schedule's length) carrying ``weights``."""
    pipe = GaussianDiffusionPipeline(
        backbone=backbone, backbone_kwargs=kwargs, schedule=schedule(smoke),
        model_mean_type="epsilon", model_var_type="fixed_large", optimizer="AdamW",
        device=device, **pipe_kwargs)
    pipe.load_state_dict(full_state_dict(pipe.backbone, weights))
    return pipe


def sample(pipe, n: int, conds, seed: int = SAMPLE_SEED, **kwargs) -> torch.Tensor:
    """One ``reverse_process`` of ``n`` rows from a generator seeded with
    ``seed`` on the pipeline's device."""
    conds = None if conds is None else torch.as_tensor(np.asarray(conds), device=pipe.device)
    return pipe.reverse_process(pipe.sample_shape(n), conds,
                                generator=torch.Generator(device=pipe.device).manual_seed(seed),
                                **kwargs)


def timed(fn, device) -> tuple:
    """(fn's result, its wall seconds), the device synchronised around it."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def parse(name: str, doc: str, argv=None, **extra):
    """The harnesses' ``-d cuda|cpu`` and ``--work-dir`` (default
    ``build/<name>``), and ``extra`` arguments as ``parse_device`` takes
    them; prints and returns the device line too."""
    args = parse_device(doc, argv, **{"--work-dir": {"type": Path,
                                                     "default": REPO / "build" / name}},
                        **extra)
    args.device_line = device_line(args.device)
    print(args.device_line, flush=True)
    return args


def write_report(work_dir: Path, filename: str, report: dict) -> dict:
    """``report`` as JSON at ``work_dir/filename``; returns it as written
    (a JSON round trip: tuples become lists)."""
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    out = work_dir / filename
    text = json.dumps(report, indent=2)
    out.write_text(text)
    print(f"wrote {out}", flush=True)
    return json.loads(text)
