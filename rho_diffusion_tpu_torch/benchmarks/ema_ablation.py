"""EMA on/off ablation on the 16^3 Y_lm harness.

The port's counterpart of ``benchmarks/ema_ablation.py``. One training run
of ``_ylm``'s conditional DDPM keeps both parameter sets (raw, and the EMA
at 0.9999 that sampling uses), so sampling each isolates the EMA effect:
same data order, same initialisation, same trajectory. Each set is sampled
by DDIM-50 and DDPM-1000 from seeds 5, 6 and 7 and scored by
matched-condition MSE and the Sinkhorn divergence against the true fields.
It also prints the mean and largest relative distance of the EMA from the
raw weights over the parameters.

    python -m rho_diffusion_tpu_torch.benchmarks.ema_ablation [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``EMA_GRID`` (16), ``EMA_BATCH`` (8), ``EMA_STEPS`` (3000; 2 with
``EMA_SMOKE=1``), and ``_ylm``'s ``EMA_SMOKE`` and ``YLM_MAX_STEPS``.
Writes ``<work-dir>/ema_ablation.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import DDPM

NAME = "ema_ablation"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "steps", "ema_decay", "rows")
EMA_DECAY = 0.9999
SAMPLERS = (("ddim", 50), ("ddpm", 1000))
SEEDS = (5, 6, 7)


def settings() -> dict:
    smoke = _ylm.is_smoke("EMA")
    return {"smoke": smoke, "grid": _ylm.knob("EMA_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("EMA_BATCH", 8),
            "steps": _ylm.knob("EMA_STEPS", 2 if smoke else 3000)}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch, steps = args.device, s["grid"], s["batch"], s["steps"]
    kwargs = _ylm.backbone_kwargs(grid, s["smoke"])
    pipe = DDPM(backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
                optimizer="AdamW", opt_kwargs={"lr": 1e-4}, ema_decay=EMA_DECAY, device=device,
                seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(grid, batch * (steps + 8), cache_fields=True)
    trained = _ylm.train(pipe, state, DataLoader(dset, batch_size=batch, num_workers=2), steps)
    print(f"trained {steps} steps in {trained['wall_s']:.0f}s "
          f"(final loss {trained['final_loss']:.4f})", flush=True)

    raw = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    ema = _ylm.ema_weights(state)
    rel = [float(torch.linalg.vector_norm(ema[k].float() - p.float())
                 / (torch.linalg.vector_norm(p.float()) + 1e-9)) for k, p in raw.items()]
    print(f"mean rel |ema-raw| {np.mean(rel):.5f}  max {np.max(rel):.5f}", flush=True)

    sampler_pipe = _ylm.sampling_pipeline("UNetv2", kwargs, raw, device, smoke=s["smoke"])
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))
    report = {"grid": grid, "steps": steps, "ema_decay": EMA_DECAY, "rows": {},
              "device": args.device_line, "train_steps_per_s": trained["steps_per_s"]}
    for tag, weights in (("raw", raw), ("ema", ema)):
        sampler_pipe.load_state_dict(_ylm.full_state_dict(sampler_pipe.backbone, weights))
        rows = {}
        for sampler, nfe in SAMPLERS:
            nfe = _ylm.max_steps(nfe)
            # 3 seeds a row: trajectories of slightly different weights
            # decorrelate, so one draw would confound seed and EMA
            scores = [scorer(_ylm.sample(sampler_pipe, batch, conds, seed=seed,
                                         sampler=sampler, num_steps=nfe)) for seed in SEEDS]
            mses = [q["matched_mse"] for q in scores]
            rows[f"{sampler}_{nfe}"] = {
                "matched_mse": float(np.mean(mses)),
                "matched_mse_per_seed": [round(m, 4) for m in mses],
                "sinkhorn": float(np.mean([q["sinkhorn"] for q in scores])),
                "finite": all(q["finite"] for q in scores),
            }
            print(f"  {tag} {sampler}-{nfe}: {rows[f'{sampler}_{nfe}']}", flush=True)
        report["rows"][tag] = rows
    return _ylm.write_report(args.work_dir, f"{NAME}.json", report)


if __name__ == "__main__":
    main()
