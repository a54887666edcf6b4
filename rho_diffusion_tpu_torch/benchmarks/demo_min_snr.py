"""min-SNR-gamma loss weighting against the plain MSE on the Y_lm harness.

The port's counterpart of ``benchmarks/demo_min_snr.py``. It trains two
identical conditional 3-D Y_lm GaussianDiffusion pipelines (epsilon,
fixed_large, AdamW at 2e-4, EMA 0.9999) from the same initialisation
(seed 777) on the same data order (one loader thread each, from the
dataset's seeded stream) for the same budget: one with the unweighted MSE,
one with ``loss_weighting='min_snr'`` (Hang et al., arXiv:2303.09556) at
gamma DEMO_GAMMA. Then it samples the same (l, m) conditions from each
arm's EMA weights and scores them by matched-condition MSE and the
Sinkhorn divergence against the true fields. The curve keeps the loss and
the unweighted MSE every 100 steps.

    python -m rho_diffusion_tpu_torch.benchmarks.demo_min_snr [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_GRID`` (16), ``DEMO_BATCH`` (16), ``DEMO_STEPS`` (1000; 2
with ``DEMO_SMOKE=1``), ``DEMO_GAMMA`` (5.0), ``DEMO_SAMPLER`` (ddim),
``DEMO_NUM_STEPS`` (50), and ``_ylm``'s ``DEMO_SMOKE`` and
``YLM_MAX_STEPS``. Writes ``<work-dir>/demo_min_snr_metrics.json``.
"""
from __future__ import annotations

import os

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline
from rho_diffusion_tpu_torch.training.trainer import swapped_weights

NAME = "demo_min_snr"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "steps", "gamma", "sampler", "arms", "noise_baseline")
ARMS = (None, "min_snr")


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    return {"smoke": smoke, "grid": _ylm.knob("DEMO_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("DEMO_BATCH", 16),
            "steps": _ylm.knob("DEMO_STEPS", 2 if smoke else 1000),
            "gamma": _ylm.knob("DEMO_GAMMA", 5.0),
            "sampler": os.environ.get("DEMO_SAMPLER", "ddim"),
            "num_steps": _ylm.max_steps(_ylm.knob("DEMO_NUM_STEPS", 50))}


def train_one(s: dict, loss_weighting, device):
    kwargs = _ylm.backbone_kwargs(s["grid"], s["smoke"])
    pipe = GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
        model_mean_type="epsilon", model_var_type="fixed_large", optimizer="AdamW",
        opt_kwargs={"lr": 2e-4}, ema_decay=0.9999, loss_weighting=loss_weighting,
        min_snr_gamma=s["gamma"], device=device, seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(s["grid"], max(s["batch"] * (s["steps"] + 8), 256))
    # one thread: the arms' "same data order" needs a single-threaded draw
    # from the dataset's stream
    loader = DataLoader(dset, batch_size=s["batch"], num_workers=0)
    # 'mse' is the unweighted per-target MSE in both arms: the comparable one
    trained = _ylm.train(pipe, state, loader, s["steps"], log_every=100,
                         tag=f"[{loss_weighting or 'unweighted'}] ", extra=("mse",))
    return pipe, state, dset, trained


def evaluate(s: dict, pipe, state, dset) -> tuple[dict, _ylm.Scorer]:
    pairs = _ylm.physical_pairs(s["batch"])
    conds = _ylm.condition_rows(pairs)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))
    with swapped_weights(pipe.backbone, _ylm.ema_weights(state)):
        samples, wall = _ylm.timed(lambda: _ylm.sample(
            pipe, s["batch"], conds, sampler=s["sampler"], num_steps=s["num_steps"]),
            pipe.device)
    q = scorer(samples)
    return {"matched_mse": q["matched_mse"], "sinkhorn": q["sinkhorn"],
            "sample_wall_s": round(wall, 2), "finite": q["finite"]}, scorer


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    report = {"grid": s["grid"], "batch": s["batch"], "steps": s["steps"], "gamma": s["gamma"],
              "sampler": f"{s['sampler']}-{s['num_steps']}", "arms": {},
              "device": args.device_line, "train_steps_per_s": {}}
    scorer = None
    for arm in ARMS:
        pipe, state, dset, trained = train_one(s, arm, args.device)
        metrics, scorer = evaluate(s, pipe, state, dset)
        key = arm or "unweighted"
        report["arms"][key] = {"train_wall_s": round(trained["wall_s"], 1),
                               "curve": trained["curve"], **metrics}
        report["train_steps_per_s"][key] = trained["steps_per_s"]
        print(f"== {key}: matched MSE {metrics['matched_mse']:.5f} "
              f"sinkhorn {metrics['sinkhorn']:.3f}", flush=True)
        del pipe, state
    report["noise_baseline"] = scorer.noise()
    return _ylm.write_report(args.work_dir, f"{NAME}_metrics.json", report)


if __name__ == "__main__":
    main()
