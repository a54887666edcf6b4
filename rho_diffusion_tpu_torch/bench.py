"""Benchmark entry of the PyTorch port: training steps/s on the flagship
workload, or the wall-clock of a DDIM-50 sample.

    python -m rho_diffusion_tpu_torch.bench [-d cuda|cpu]

The port's counterpart of the root ``bench.py``: the same workload
(UNetv2 dims=3, model_channels 64, channel_mult (1, 2, 4, 8), 32^3,
LinearSchedule(1000), batch 32; ``examples/config_spherical_harmonics.json``),
the same ``BENCH_*`` environment knobs and the same one JSON line on stdout:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": 1.0}

under the same metric names (``train_steps_per_sec_per_chip_3d_unet_32cubed_b32``
by default, ``ddim50_sample_wall_clock_32cubed_b8`` with ``BENCH_MODE=sample``,
``..._smoke`` names with ``BENCH_SMOKE=1``). ``vs_baseline`` is 1.0: the
``BENCH_r*.json`` records are the TPU's, and no TPU number is a baseline
for the card. Diagnostics go to stderr, with the card's nvidia-smi name and
power limit.

Modes (``BENCH_MODE``):

* ``train`` (default): the DDPM flagship's training step on a fixed random
  batch, best of ``BENCH_WINDOWS`` (3) windows of ``BENCH_STEPS`` (10)
  steps after ``BENCH_WARMUP`` (3), each window closed by
  ``torch.cuda.synchronize``;
* ``sample``: a GaussianDiffusionPipeline (epsilon, fixed_large) sampling
  ``BENCH_SAMPLER`` ('ddim') over ``BENCH_DDIM_STEPS`` (50) respaced steps
  at batch min(BENCH_BATCH, 8) with zero conditions, the mean of 3 runs
  after one warm-up, each closed by ``torch.cuda.synchronize`` (stderr
  lists each run's wall clock and its thread's CPU time);
* ``realdata``: the training step on ``SphericalHarmonicDataset`` batches
  through the port's DataLoader threads and device prefetch, or, with
  ``BENCH_DEVICE_CACHE=1``, from the dataset uploaded once to the device,
  each batch a gather there (``DeviceDatasetCache``; stderr gives the
  table's bytes).

Other knobs: ``BENCH_BATCH``, ``BENCH_GRID``, ``BENCH_DTYPE``
(bfloat16|float32), ``BENCH_DIMS`` (3, 2 or 1), ``BENCH_ACCUM``,
``BENCH_NO_EMA``, ``BENCH_NO_GRADNORM``, ``BENCH_REMAT=1`` (the UNet's
``use_checkpoint``: ResBlocks and AttentionBlocks recomputed in the
backward, the 64^3 memory recipe). ``BENCH_MODEL=vit`` trains the
VisionTransformer at the root bench.py's widths (32^3, patch 8, embedding
256, hidden 512, depth 8, 16 heads; the smoke: patch 4, 64, 128, depth 2, 4
heads) in the train and realdata modes, under the metric
``train_steps_per_sec_per_chip_3d_vit_32cubed_b32``; its sample mode exits
with the root bench.py's message. ``BENCH_FLAT_OPT=1`` makes the AdamW
update one fused multi-tensor step over every parameter (``fused=True``
through ``training/optimizers.py``'s ``Optimizer``), the port's counterpart
of the root bench.py's ``optax.flatten``: the same per-element arithmetic
over all parameters at once (stderr prints ``flat_opt=``).

It runs on CUDA unless ``-d cpu`` is given (for the smoke sizes), and
raises when CUDA is absent.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks._timing import device_line, parse_device


def _env(name: str, default):
    return type(default)(os.environ.get(name, default))


def _grid_name(grid: int, dims: int) -> str:
    return f"{grid}" + {3: "cubed", 2: "sq", 1: ""}[dims]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settings() -> dict:
    """The workload the ``BENCH_*`` variables select, as the root
    ``bench.py`` reads them."""
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    s = {
        "smoke": smoke, "mode": os.environ.get("BENCH_MODE", "train"),
        "steps": _env("BENCH_STEPS", 10), "warmup": _env("BENCH_WARMUP", 3),
        "batch": _env("BENCH_BATCH", 8 if smoke else 32),
        "grid": _env("BENCH_GRID", 8 if smoke else 32),
        "dtype": os.environ.get("BENCH_DTYPE", "bfloat16"), "mc": 16 if smoke else 64,
        "dims": _env("BENCH_DIMS", 3), "num_classes": 20,
        "remat": os.environ.get("BENCH_REMAT") == "1",
    }
    if smoke and s["mode"] == "realdata":
        # the dataset's sha512 labels are 256 wide and condition the model
        # directly, so its embedding (4 * model_channels) must match
        s["mc"] = 64
    s["model"] = os.environ.get("BENCH_MODEL", "unet")
    s["flat_opt"] = os.environ.get("BENCH_FLAT_OPT") == "1"
    if s["dims"] == 2:  # examples/config_deep_galaxy.json: 128^2, mc 32, T 500, batch 64
        s.update(grid=_env("BENCH_GRID", 16 if smoke else 128),
                 batch=_env("BENCH_BATCH", 8 if smoke else 64), mc=16 if smoke else 32,
                 num_classes=25)
    elif s["dims"] == 1:  # 1-D density profiles
        s.update(grid=_env("BENCH_GRID", 64 if smoke else 1024),
                 batch=_env("BENCH_BATCH", 8 if smoke else 64))
    if s["model"] == "vit":  # the root bench.py's ViT (:200-216)
        s["backbone"] = "VisionTransformer"
        s["backbone_kwargs"] = dict(
            patch_size=4 if smoke else 8, input_shapes=(s["grid"],) * s["dims"],
            num_channels=1, embedding_dim=64 if smoke else 256,
            hidden_dim=128 if smoke else 512, transformer_depth=2 if smoke else 8,
            num_heads=4 if smoke else 16, dropout=0.0, dtype=s["dtype"])
        return s
    s["backbone"] = "UNetv2"
    s["backbone_kwargs"] = dict(
        data_shape=(s["grid"],) * s["dims"], dims=s["dims"], in_channels=1, out_channels=1,
        model_channels=s["mc"], num_res_blocks=2,
        channel_mult=(1, 2) if smoke else (1, 2, 4, 8), attention_resolutions=[16, 8],
        num_heads=4, num_classes=s["num_classes"], use_scale_shift_norm=True,
        use_checkpoint=s["remat"], dtype=s["dtype"])
    return s


def sampling_pipeline(s: dict, device):
    """The sample mode's pipeline: epsilon and fixed_large over
    LinearSchedule(1000) (100 for the smoke), parameters seeded with 0."""
    from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline, LinearSchedule

    return GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=s["backbone_kwargs"],
        schedule=LinearSchedule(100 if s["smoke"] else 1000), model_mean_type="epsilon",
        model_var_type="fixed_large", optimizer="AdamW", device=device, seed=0)


def bench_sampling(s: dict, device) -> dict:
    steps = _env("BENCH_DDIM_STEPS", 10 if s["smoke"] else 50)
    sampler = os.environ.get("BENCH_SAMPLER", "ddim")
    pipe = sampling_pipeline(s, device)
    n = min(s["batch"], 8)
    conds = torch.zeros((n, 4 * s["mc"]), device=device)
    shape = pipe.sample_shape(n)

    def sample(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return pipe.reverse_process(shape, conds, sampler=sampler, num_steps=steps,
                                    generator=gen)

    out = sample(1)
    _sync(device)
    # each sample timed on its own: its wall clock, and the CPU time of this
    # thread, which issues every launch (a wall above it is time the thread
    # spent off the CPU)
    walls, cpus = [], []
    for i in range(3):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = sample(i)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        cpus.append(time.thread_time() - c0)
    wall = sum(walls) / len(walls)
    finite = bool(torch.isfinite(out).all())
    print(f"{device_line(device)} dtype={s['dtype']} n={n} grid={s['grid']} "
          f"ddim_steps={steps} sampler={sampler} finite={finite} "
          f"sample_s={json.dumps(walls)} thread_cpu_s={json.dumps(cpus)}", file=sys.stderr)
    return {"metric": f"{sampler}{steps}_sample_wall_clock_{_grid_name(s['grid'], s['dims'])}"
                      f"_b{n}",
            "value": round(wall, 4), "unit": "seconds", "vs_baseline": 1.0}


def training_pipeline(s: dict, device):
    from rho_diffusion_tpu_torch.diffusion import DDPM, LinearSchedule

    pipe = DDPM(
        backbone=s["backbone"], backbone_kwargs=s["backbone_kwargs"],
        schedule=LinearSchedule(500 if s["dims"] == 2 else 1000), optimizer="AdamW",
        opt_kwargs={"lr": 1e-4},
        ema_decay=0.0 if os.environ.get("BENCH_NO_EMA") == "1" else 0.9999,
        log_grad_norm=os.environ.get("BENCH_NO_GRADNORM") != "1",
        grad_accum=_env("BENCH_ACCUM", 1), device=device, seed=0)
    pipe.optimizer.fused = s["flat_opt"]
    return pipe


def bench_realdata(s: dict, pipe, state, device) -> dict:
    from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset

    steps, warmup, batch = s["steps"], s["warmup"], s["batch"]
    dset = SphericalHarmonicDataset(max_l=5, grid_el=s["grid"],
                                    length=max(batch * (steps + warmup + 2), 256))
    loader = DataLoader(dset, batch_size=batch, num_workers=4)
    cache = None
    if os.environ.get("BENCH_DEVICE_CACHE") == "1":
        from rho_diffusion_tpu_torch.data.device_cache import DeviceDatasetCache

        cache = DeviceDatasetCache(dset, device=device)

    def run(n):
        metrics = None
        it = cache.batches(loader) if cache is not None else prefetch_to_device(iter(loader),
                                                                                 device)
        for i, b in enumerate(it):
            if i >= n:
                break
            metrics = pipe.training_step(state, b)
        _sync(device)
        return metrics

    t0 = time.perf_counter()
    run(max(warmup, 1))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = run(steps)
    elapsed = time.perf_counter() - t0
    print(f"{device_line(device)} mode=realdata batch={batch} grid={s['grid']} "
          f"device_cache_bytes={cache.nbytes if cache is not None else 0} "
          f"warmup={compile_s:.1f}s elapsed={elapsed:.2f}s "
          f"loss={float(metrics['train_loss']):.4f}", file=sys.stderr)
    return {"metric": "train_steps_per_sec_per_chip_3d_unet_realdata",
            "value": round(steps / elapsed, 4), "unit": "steps/sec/chip", "vs_baseline": 1.0}


def bench_training(s: dict, device) -> dict:
    pipe = training_pipeline(s, device)
    state = pipe.create_state(777)
    if s["mode"] == "realdata":
        return bench_realdata(s, pipe, state, device)
    steps, batch, dims, grid = s["steps"], s["batch"], s["dims"], s["grid"]
    rng = np.random.default_rng(0)
    data = rng.uniform(0.0, 1.0, (batch, *(grid,) * dims, 1)).astype(np.float32)
    labels = rng.uniform(0.0, 1.0, (batch, 4 * s["mc"])).astype(np.float32)
    batch_dict = {"data": torch.from_numpy(data).to(device),
                  "labels": torch.from_numpy(labels).to(device)}
    t0 = time.perf_counter()
    for _ in range(max(s["warmup"], 1)):
        metrics = pipe.training_step(state, batch_dict)
    _sync(device)
    warmup_s = time.perf_counter() - t0
    # best of BENCH_WINDOWS windows: host jitter only ever slows one down
    elapsed = float("inf")
    windows = max(_env("BENCH_WINDOWS", 3), 1)
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = pipe.training_step(state, batch_dict)
        _sync(device)
        elapsed = min(elapsed, time.perf_counter() - t0)
    value = steps / elapsed
    loss = float(metrics["train_loss"])
    metric = (f"train_steps_per_sec_per_chip_{dims}d_{s['model']}_{_grid_name(grid, dims)}"
              f"_b{batch}"
              if not s["smoke"] else "train_steps_per_sec_per_chip_smoke")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print(f"{device_line(device)} chips=1 dtype={s['dtype']} batch={batch} grid={grid} "
          f"remat={s['remat']} flat_opt={s['flat_opt']} warmup={warmup_s:.1f}s elapsed={elapsed:.2f}s loss={loss:.4f} "
          f"finite={np.isfinite(loss)} peak_bytes={peak} "
          f"steps_run={max(s['warmup'], 1) + windows * steps}", file=sys.stderr)
    return {"metric": metric, "value": round(value, 4), "unit": "steps/sec/chip",
            "vs_baseline": 1.0}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    device = parse_device(__doc__.splitlines()[0], argv).device
    s = settings()
    if s["mode"] not in ("train", "sample", "realdata"):
        raise ValueError(f"BENCH_MODE={s['mode']!r}; expected train, sample or realdata")
    if s["mode"] == "sample" and s["model"] != "unet":
        raise SystemExit("BENCH_MODE=sample supports BENCH_MODEL=unet only")
    result = bench_sampling(s, device) if s["mode"] == "sample" else bench_training(s, device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
