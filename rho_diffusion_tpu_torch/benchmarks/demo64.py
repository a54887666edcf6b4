"""64^3 training and sampling of the flagship UNet on Y_lm fields.

The port's counterpart of ``benchmarks/demo64.py``. It trains the flagship
3-D UNet (width 64, mult (1, 2, 4, 8), attention at ds 16 and 8: 4 heads
of 128 over 64 x 8 x 8 = 4096 tokens) as a conditional DDPM on on-the-fly
64^3 Y_lm fields for DEMO_STEPS steps at batch DEMO_BATCH without
recomputation (``use_checkpoint=False``), then DDIM-50 samples the first
BATCH physical (l, m) pairs from the EMA weights, and records the loss
curve (every 50 steps), the Sinkhorn divergence of the condition-matched
samples against the true fields beside a noise baseline, the allocator's
peak, and plots of the samples and of the true fields
(``utils.plot_tensor_images``, where matplotlib is installed). Should
training not fit, it prints the allocator's peak and raises:
recomputation is not switched on here.

    python -m rho_diffusion_tpu_torch.benchmarks.demo64 [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_GRID`` (64), ``DEMO_BATCH`` (8), ``DEMO_STEPS`` (600; 2 with
``DEMO_SMOKE=1``), and ``_ylm``'s ``DEMO_SMOKE`` and ``YLM_MAX_STEPS``
(over the DDIM's 50 steps; the report's ``sample_steps`` names the steps
that ran). Writes ``<work-dir>/demo64_metrics.json``,
``demo64_samples.png`` and ``demo64_real.png``.
"""
from __future__ import annotations

import importlib.util
import sys

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import DDPM
from rho_diffusion_tpu_torch.utils import plot_tensor_images

NAME = "demo64"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "steps", "condition_pairs_lm", "losses", "train_wall_s",
               "ddim50_sample_wall_s", "sinkhorn_generated_vs_real",
               "sinkhorn_noise_baseline", "finite")
DDIM_STEPS = 50
FLAGSHIP = dict(channel_mult=(1, 2, 4, 8), attention_resolutions=[16, 8], use_checkpoint=False)


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    return {"smoke": smoke, "grid": _ylm.knob("DEMO_GRID", _ylm.SMOKE_GRID if smoke else 64),
            "batch": _ylm.knob("DEMO_BATCH", 8),
            "steps": _ylm.knob("DEMO_STEPS", 2 if smoke else 600)}


def backbone_kwargs(grid: int, smoke: bool) -> dict:
    kwargs = _ylm.backbone_kwargs(grid, **FLAGSHIP)
    if smoke:
        kwargs.update(_ylm.SMOKE_CUT)
    return kwargs


def peak_bytes(device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch, steps = args.device, s["grid"], s["batch"], s["steps"]
    kwargs = backbone_kwargs(grid, s["smoke"])
    pipe = DDPM(backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
                optimizer="AdamW", opt_kwargs={"lr": 1e-4}, ema_decay=0.9999, device=device,
                seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(grid, max(batch * (steps + 8), 256))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        trained = _ylm.train(pipe, state, DataLoader(dset, batch_size=batch, num_workers=4),
                             steps, log_every=50)
    except torch.cuda.OutOfMemoryError:
        print(f"out of memory training {grid}^3 at batch {batch} without recomputation: "
              f"allocator peak {peak_bytes(device)} bytes of "
              f"{torch.cuda.get_device_properties(device).total_memory}", file=sys.stderr,
              flush=True)
        raise
    train_peak = peak_bytes(device)

    # DDIM-50 from the EMA weights on the first BATCH physical (l, m) pairs,
    # as the sha512 rows the training labels are
    sampler = _ylm.sampling_pipeline("UNetv2", kwargs, _ylm.ema_weights(state), device,
                                     smoke=s["smoke"])
    del state
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs)
    n = _ylm.max_steps(DDIM_STEPS)
    samples, sample_wall = _ylm.timed(
        lambda: _ylm.sample(sampler, batch, conds, sampler="ddim", num_steps=n), device)
    samples = _ylm.as_numpy(samples)
    finite = bool(np.isfinite(samples).all())
    print(f"sampled {samples.shape} in {sample_wall:.1f}s finite={finite}", flush=True)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))
    div = scorer.sinkhorn(samples)
    div_noise = scorer.noise()["sinkhorn"]
    print(f"sinkhorn generated-vs-real {div:.3f} (noise baseline {div_noise:.3f})", flush=True)

    work = args.work_dir
    work.mkdir(parents=True, exist_ok=True)
    if importlib.util.find_spec("matplotlib") is None:
        plots = "not written: matplotlib is not installed"
    else:
        plots = [str(work / "demo64_samples.png"), str(work / "demo64_real.png")]
        plot_tensor_images(samples, filename=plots[0])
        plot_tensor_images(scorer.real, filename=plots[1])
    report = {
        "grid": grid, "batch": batch, "steps": steps,
        "condition_pairs_lm": pairs,
        "losses": [{"step": r["step"], "loss": r["loss"]} for r in trained["curve"]],
        "train_wall_s": round(trained["wall_s"], 1),
        "ddim50_sample_wall_s": round(sample_wall, 1),
        "sinkhorn_generated_vs_real": div,
        "sinkhorn_noise_baseline": div_noise,
        "finite": finite,
        "sample_steps": n, "use_checkpoint": kwargs["use_checkpoint"], "plots": plots,
        "train_peak_bytes": train_peak, "peak_bytes": peak_bytes(device),
        "device": args.device_line, "train_steps_per_s": trained["steps_per_s"],
    }
    return _ylm.write_report(work, f"{NAME}_metrics.json", report)


if __name__ == "__main__":
    main()
