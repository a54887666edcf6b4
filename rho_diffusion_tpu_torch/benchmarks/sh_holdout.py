"""Held-out (l, m) pairs on the Y_lm harness: compositional generalisation.

The port's counterpart of ``benchmarks/sh_holdout.py``. The pairs (3, -2)
and (4, 1) are left out of the training draw (the dataset's
``exclude_pairs``) while every single l and m value still appears in other
pairs. The conditional DDPM of ``_ylm`` is trained on raw (l, m) rows
through a learned conditioner, once with ``MultiEmbeddings`` (per-dimension
embeddings summed, so a held-out pair's row is a sum of trained rows) and
once with ``FourierConditioning`` (an MLP over smooth features); each then
samples all 25 valid pairs (DDIM-50 from its EMA weights, BATCH rows at a
time from seeds 5, 6, ...) scored by matched-condition MSE on the trained
and the held-out pairs, and the Sinkhorn divergence over all of them.

    python -m rho_diffusion_tpu_torch.benchmarks.sh_holdout [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``SH_GRID`` (16), ``SH_BATCH`` (8), ``SH_STEPS`` (3000; 2 with
``SH_SMOKE=1``), and ``_ylm``'s ``SH_SMOKE`` and ``YLM_MAX_STEPS`` (over
the DDIM's 50 steps). Writes ``<work-dir>/sh_holdout_metrics.json``.
"""
from __future__ import annotations

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import DDPM
from rho_diffusion_tpu_torch.models import FourierConditioning, MultiEmbeddings

NAME = "sh_holdout"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "steps", "held_out_pairs", "conds", "noise_matched_mse")
HOLDOUT = [(3, -2), (4, 1)]
CONDS = {"embed": MultiEmbeddings, "fourier": FourierConditioning}
DDIM_STEPS = 50


def settings() -> dict:
    smoke = _ylm.is_smoke("SH")
    return {"smoke": smoke, "grid": _ylm.knob("SH_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("SH_BATCH", 8),
            "steps": _ylm.knob("SH_STEPS", 2 if smoke else 3000)}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch, steps = args.device, s["grid"], s["batch"], s["steps"]
    kwargs = _ylm.backbone_kwargs(grid, s["smoke"])
    dset = _ylm.dataset(grid, batch * (steps + 8), cache_fields=True, use_emb_as_labels=False,
                        exclude_pairs=HOLDOUT)
    all_pairs = _ylm.physical_pairs()  # the 25 valid pairs
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, all_pairs))
    labels = np.asarray(all_pairs, np.float32)
    held = np.array([p in HOLDOUT for p in all_pairs])
    n = _ylm.max_steps(DDIM_STEPS)

    report = {"grid": grid, "steps": steps, "held_out_pairs": HOLDOUT, "conds": {},
              "ddim_steps": n, "device": args.device_line, "train_steps_per_s": {}}
    for cond_name, cond_cls in CONDS.items():
        def cond():
            return cond_cls(parameter_space=dset.parameter_space, embedding_dim=4 * _ylm.MC)

        pipe = DDPM(backbone="UNetv2", backbone_kwargs=kwargs, cond_fn=cond(),
                    schedule=_ylm.schedule(s["smoke"]), optimizer="AdamW",
                    opt_kwargs={"lr": 1e-4}, ema_decay=0.9999, device=device,
                    seed=_ylm.INIT_SEED)
        state = pipe.create_state(_ylm.INIT_SEED)
        trained = _ylm.train(pipe, state, DataLoader(dset, batch_size=batch, num_workers=2),
                             steps)
        report["train_steps_per_s"][cond_name] = trained["steps_per_s"]
        print(f"{cond_name}: {steps} steps in {trained['wall_s']:.0f}s "
              f"(loss {trained['final_loss']:.4f})", flush=True)
        # the sampler's own conditioner of the same class, carrying the EMA weights
        sampler_pipe = _ylm.sampling_pipeline("UNetv2", kwargs, _ylm.ema_weights(state), device,
                                              smoke=s["smoke"], cond_fn=cond())
        gen = np.concatenate([
            _ylm.as_numpy(_ylm.sample(sampler_pipe, len(labels[lo:lo + batch]),
                                      labels[lo:lo + batch], seed=_ylm.SAMPLE_SEED + lo,
                                      sampler="ddim", num_steps=n))
            for lo in range(0, len(all_pairs), batch)
        ])[:len(all_pairs)]
        per_pair = scorer.per_pair_mse(gen)
        row = {
            "matched_mse_trained": float(per_pair[~held].mean()),
            "matched_mse_holdout": float(per_pair[held].mean()),
            "holdout_pair_mse": {str(p): float(per_pair[i])
                                 for i, p in enumerate(all_pairs) if held[i]},
            "sinkhorn_all": scorer.sinkhorn(gen),
            "finite": bool(np.isfinite(gen).all()),
        }
        report["conds"][cond_name] = row
        print(f"  {cond_name}: trained {row['matched_mse_trained']:.4f}  "
              f"holdout {row['matched_mse_holdout']:.4f}", flush=True)
        del pipe, state, sampler_pipe

    report["noise_matched_mse"] = scorer.noise()["matched_mse"]
    return _ylm.write_report(args.work_dir, f"{NAME}_metrics.json", report)


if __name__ == "__main__":
    main()
