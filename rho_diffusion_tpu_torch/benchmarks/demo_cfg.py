"""Classifier-free guidance quality on the Y_lm harness.

The port's counterpart of ``benchmarks/demo_cfg.py``. It trains the
conditional 3-D Y_lm GaussianDiffusion pipeline (epsilon, fixed_large,
AdamW at 2e-4, EMA 0.9999) with ``cond_dropout`` (so the one network also
learns the null condition), then DDIM-samples the same (l, m) conditions
from its EMA weights at several guidance scales and scores each by
matched-condition MSE and the Sinkhorn divergence against the true fields
(Ho & Salimans, arXiv:2207.12598). A guided sample runs the conditional
and the unconditional halves as one batched 2B forward, so expect about
twice a plain sample's model cost; scale 1.0 is the plain sampler.

    python -m rho_diffusion_tpu_torch.benchmarks.demo_cfg [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_GRID`` (16), ``DEMO_BATCH`` (16), ``DEMO_STEPS`` (1200; 2
with ``DEMO_SMOKE=1``), ``DEMO_SCALES`` ("1.0,1.5,2.0,4.0"),
``DEMO_DROPOUT`` (0.1), and ``_ylm``'s ``DEMO_SMOKE`` and
``YLM_MAX_STEPS`` (over the DDIM's 50 steps). Writes
``<work-dir>/demo_cfg_metrics.json``.
"""
from __future__ import annotations

import os

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline
from rho_diffusion_tpu_torch.training.trainer import swapped_weights

NAME = "demo_cfg"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "steps", "cond_dropout", "condition_pairs_lm", "losses",
               "train_wall_s", "per_scale", "noise_baseline")
DDIM_STEPS = 50


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    return {"smoke": smoke, "grid": _ylm.knob("DEMO_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("DEMO_BATCH", 16),
            "steps": _ylm.knob("DEMO_STEPS", 2 if smoke else 1200),
            "dropout": _ylm.knob("DEMO_DROPOUT", 0.1),
            "scales": [float(x) for x in
                       os.environ.get("DEMO_SCALES", "1.0,1.5,2.0,4.0").split(",")]}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch = args.device, s["grid"], s["batch"]
    kwargs = _ylm.backbone_kwargs(grid, s["smoke"])
    pipe = GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
        model_mean_type="epsilon", model_var_type="fixed_large", optimizer="AdamW",
        opt_kwargs={"lr": 2e-4}, ema_decay=0.9999, cond_dropout=s["dropout"], device=device,
        seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(grid, max(batch * (s["steps"] + 8), 256))
    trained = _ylm.train(pipe, state, DataLoader(dset, batch_size=batch, num_workers=4),
                         s["steps"], log_every=100)

    # matched conditions: the first BATCH physical (l, m) pairs, as the
    # sha512 rows the training labels are
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))
    n = _ylm.max_steps(DDIM_STEPS)
    results = []
    with swapped_weights(pipe.backbone, _ylm.ema_weights(state)):
        for scale in s["scales"]:
            samples, wall = _ylm.timed(lambda: _ylm.sample(
                pipe, batch, conds, sampler="ddim", num_steps=n,
                guidance_scale=None if scale == 1.0 else scale), device)
            q = scorer(samples)
            results.append({"guidance_scale": scale, "matched_mse": q["matched_mse"],
                            "sinkhorn": q["sinkhorn"], "sample_wall_s": round(wall, 2),
                            "finite": q["finite"]})
            print(f"scale {scale}: matched MSE {q['matched_mse']:.5f} "
                  f"sinkhorn {q['sinkhorn']:.3f} ({wall:.1f}s)", flush=True)
    report = {
        "grid": grid, "batch": batch, "steps": s["steps"],
        "cond_dropout": s["dropout"],
        "condition_pairs_lm": pairs,
        "losses": [{"step": r["step"], "loss": r["loss"]} for r in trained["curve"]],
        "train_wall_s": round(trained["wall_s"], 1),
        "per_scale": results, "noise_baseline": scorer.noise(),
        "ddim_steps": n, "device": args.device_line,
        "train_steps_per_s": trained["steps_per_s"],
    }
    return _ylm.write_report(args.work_dir, f"{NAME}_metrics.json", report)


if __name__ == "__main__":
    main()
