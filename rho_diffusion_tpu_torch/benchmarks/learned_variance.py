"""Learned-variance (hybrid objective) training and bits-per-dim.

The port's counterpart of ``benchmarks/learned_variance.py``. It trains two
16^3 Y_lm models at the same budget through the config and ``Trainer``:

* **hybrid**: ``examples/config_learned_variance.json``, LEARNED_RANGE
  variance and RESCALED_MSE (the Nichol-Dhariwal hybrid, arXiv:2102.09672),
  out_channels 2;
* **fixed**: the same config with FIXED_SMALL variance and MSE,
  out_channels 1;

then evaluates both through the evaluate CLI with ``--bpd``
(``rho_diffusion_tpu_torch.evaluate.main``, on each run's EMA weights:
validation loss and PSNR, the generated-against-real Sinkhorn divergence,
and the whole T-step VLB on real rows), and scores full-T ancestral
samples of both against the true fields with the Sinkhorn divergence
(ancestral sampling is where a learned variance acts; DDIM ignores it).

    python -m rho_diffusion_tpu_torch.benchmarks.learned_variance [-d cuda|cpu]
        [--work-dir DIR]

``LV_EPOCHS`` sets the epochs (default 40, 2 with ``LV_SMOKE=1``).
``LV_SMOKE=1`` cuts the run to CPU size: 4^3 fields, one resolution level
of one res block, no attention, a 20-step schedule, 8 items at batch 4,
fp32; the width stays 64, since the dataset's sha512 labels are 256 wide
and the UNet adds them to its 4 x model_channels time embedding. The
report is written to ``<work-dir>/learned_variance_bpd.json`` (default
work dir ``build/learned_variance``) and returned by ``main``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from rho_diffusion_tpu_torch import evaluate
from rho_diffusion_tpu_torch.benchmarks._timing import device_line, parse_device
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.synthetic import compute_spherical_harmonic
from rho_diffusion_tpu_torch.metrics import WassersteinWrapper
from rho_diffusion_tpu_torch.training.trainer import Trainer, swapped_weights
from rho_diffusion_tpu_torch.utils import calculate_sha512_embedding

REPO = Path(__file__).resolve().parents[2]
CONFIG = REPO / "examples" / "config_learned_variance.json"
ANCESTRAL_BATCH = 8


def variant_config(name: str, epochs: int, smoke: bool) -> dict:
    """The config of one twin, with the run's epochs and cuts."""
    cfg = json.loads(CONFIG.read_text())
    cfg["training"]["max_epochs"] = epochs
    cfg["training"]["loggers"] = ["jsonl"]
    if cfg.get("lr_scheduler"):
        cfg["lr_scheduler"]["kwargs"]["T_max"] = epochs
    if name == "fixed":
        cfg["model"]["kwargs"]["out_channels"] = 1
        cfg["pipeline"]["kwargs"].update(model_var_type="fixed_small", loss_type="mse")
    if smoke:
        cfg["model"]["kwargs"].update(data_shape=[4, 4, 4], num_res_blocks=1, channel_mult=[1],
                                      attention_resolutions=[], num_heads=1)
        cfg["dataset"]["kwargs"].update(grid_el=4, length=8)
        cfg["noise_schedule"]["kwargs"].update(num_steps=20, beta_1=2e-4, beta_T=1e-2)
        cfg["training"].update(dtype="float32", batch_size=4)
    return cfg


def main(argv=None) -> dict:
    args = parse_device(__doc__, argv, **{"--work-dir": {"type": Path,
                                                         "default": REPO / "build" /
                                                         "learned_variance"}})
    smoke = bool(int(os.environ.get("LV_SMOKE", "0")))
    epochs = int(os.environ.get("LV_EPOCHS", "2" if smoke else "40"))
    device = args.device
    print(device_line(device), flush=True)
    report: dict = {"epochs": epochs, "smoke": smoke, "device": device_line(device),
                    "variants": {}}
    runs = {}
    for name in ("hybrid", "fixed"):
        cfg = variant_config(name, epochs, smoke)
        work = args.work_dir / name
        work.mkdir(parents=True, exist_ok=True)
        (work / "config.json").write_text(json.dumps(cfg, indent=2))
        trainer = Trainer(ExperimentConfig.from_dict(cfg), work_dir=work, device=device)
        t0 = time.perf_counter()
        state = trainer.fit(trainer.init_state(resume=False))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        print(f"{name}: trained {epochs} epochs in {wall:.1f} s", flush=True)
        runs[name] = (cfg, trainer, state)
        report["variants"][name] = {"train_wall_s": wall, "steps": int(state.step)}

    # the evaluate CLI with --bpd on each run's EMA weights (its checkpoints)
    for name in runs:
        work = args.work_dir / name
        argv_eval = [str(work / "config.json"), "-p", str(work / "checkpoints"), "-d",
                     device.type, "--bpd", "--num-batches", "2"]
        print("evaluate", " ".join(argv_eval), flush=True)
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            cli = evaluate.main(argv_eval)
        report["variants"][name].update(evaluate_cli=cli,
                                        evaluate_wall_s=time.perf_counter() - t0)

    # full-T ancestral samples of the first (l, m) pairs against their fields
    w = WassersteinWrapper()
    for name, (cfg, trainer, state) in runs.items():
        pipe, dset = trainer.pipeline, trainer.dataset
        emb = 4 * cfg["model"]["kwargs"]["model_channels"]
        pairs = [(l, m) for l in range(dset.max_l) for m in range(-l, l + 1)]
        pairs = pairs[:ANCESTRAL_BATCH]
        conds = torch.as_tensor(np.stack([calculate_sha512_embedding({"l": l, "m": m}, l=emb)
                                          for l, m in pairs]), device=device)
        grid = {k: dset.grid_kwargs[k] for k in ("x", "y", "z")}
        real = np.stack([compute_spherical_harmonic(**grid, m=m, l=l)[1][..., None]
                         for l, m in pairs]).astype(np.float32)
        weights = state.ema if state.ema is not None else dict(state.model.named_parameters())
        with swapped_weights(state.model, weights):
            gen = pipe.reverse_process((len(pairs), *real.shape[1:]), conds, sampler="ddpm",
                                       generator=torch.Generator(device=device).manual_seed(5))
        gen = gen.float().cpu().numpy()
        sink = float(w(gen, real))
        report["variants"][name].update(ancestral_sinkhorn_vs_real=sink,
                                        ancestral_finite=bool(np.isfinite(gen).all()))
        print(f"{name}: ancestral sinkhorn {sink:.4f}", flush=True)

    out = args.work_dir / "learned_variance_bpd.json"
    out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
