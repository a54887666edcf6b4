"""Sampler quality against cost on a trained model.

The port's counterpart of ``benchmarks/sampler_quality.py``. It trains the
conditional 3-D DDPM of ``_ylm`` on on-the-fly Y_lm fields (QUAL_GRID^3,
default 16^3), then samples the condition-matched batch with each sampler x
step count of a row list and reports the Sinkhorn divergence against the
true fields and each sample's wall clock (the second of two runs: the
first builds and loads the kernels, and under int8 quantises the weights).

    python -m rho_diffusion_tpu_torch.benchmarks.sampler_quality [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``QUAL_GRID`` (16), ``QUAL_BATCH`` (8), ``QUAL_STEPS`` (3000; 2 with
``QUAL_SMOKE=1``), ``SQ_ROWS`` (unset: the default rows, with ``dpm++``-10
and ``ddim``-50 under ``--quant int8``, i.e. ``ops.quant.conv_quant``;
``unipc``, ``stochastic`` or ``karras``: the JAX script's focused lists),
and ``_ylm``'s ``QUAL_SMOKE`` and ``YLM_MAX_STEPS``. Writes
``<work-dir>/sampler_quality.json`` (``sampler_quality_<SQ_ROWS>.json``
with a row list named).
"""
from __future__ import annotations

import contextlib
import os

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import DDPM
from rho_diffusion_tpu_torch.ops.quant import conv_quant

NAME = "sampler_quality"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "train_steps", "final_train_loss", "condition_pairs_lm",
               "sinkhorn_noise_baseline", "rows")
# (sampler, steps, quant, spacing) per row, by SQ_ROWS (None: the default)
ROWS = {
    None: [("dpm++", 5, None, None), ("dpm++", 10, None, None), ("dpm++", 15, None, None),
           ("ddim", 10, None, None), ("ddim", 25, None, None), ("ddim", 50, None, None),
           ("ddim", 100, None, None), ("ddpm", 1000, None, None),
           ("dpm++", 10, "int8", None), ("ddim", 50, "int8", None)],
    # the UniPC-p2 corrector against DPM-Solver++(2M) at equal NFE
    "unipc": [("unipc", 5, None, None), ("dpm++", 5, None, None), ("unipc", 10, None, None),
              ("dpm++", 10, None, None), ("unipc", 15, None, None), ("dpm++", 15, None, None),
              ("ddim", 50, None, None)],
    # the stochastic solvers against their deterministic twins, and the
    # ancestral samplers they generalise
    "stochastic": [("sde-dpm++", 10, None, None), ("dpm++", 10, None, None),
                   ("sde-dpm++", 15, None, None), ("dpm++", 15, None, None),
                   ("ancestral", 50, None, None), ("ddim", 50, None, None),
                   ("ddpm", 1000, None, None)],
    # the Karras rho=7 grid against the uniform-t default at equal cost
    "karras": [("ddim", 10, None, None), ("ddim", 10, None, "karras"),
               ("ddim", 25, None, None), ("ddim", 25, None, "karras"),
               ("ddim", 50, None, None), ("ddim", 50, None, "karras")],
}


def settings() -> dict:
    smoke = _ylm.is_smoke("QUAL")
    return {"smoke": smoke, "grid": _ylm.knob("QUAL_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("QUAL_BATCH", 8),
            "steps": _ylm.knob("QUAL_STEPS", 2 if smoke else 3000),
            "rows": os.environ.get("SQ_ROWS") or None}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    if s["rows"] not in ROWS:
        raise ValueError(f"SQ_ROWS={s['rows']!r}; expected one of unipc, stochastic, karras")
    device, grid, batch, steps = args.device, s["grid"], s["batch"], s["steps"]
    kwargs = _ylm.backbone_kwargs(grid, s["smoke"])
    pipe = DDPM(backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
                optimizer="AdamW", opt_kwargs={"lr": 1e-4}, ema_decay=0.9999, device=device,
                seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(grid, max(batch * (steps + 8), 256), cache_fields=True)
    loader = DataLoader(dset, batch_size=batch, num_workers=4)
    trained = _ylm.train(pipe, state, loader, steps, log_every=500)
    final_loss = trained["curve"][-1]["loss"] if trained["curve"] else None

    sampler_pipe = _ylm.sampling_pipeline("UNetv2", kwargs, _ylm.ema_weights(state), device,
                                          smoke=s["smoke"])
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))

    def run(sampler: str, num_steps: int, quant=None, spacing=None) -> dict:
        """One row: the same weights sampled by ``sampler`` over
        ``num_steps`` (capped by YLM_MAX_STEPS), through the int8 convs
        under quant='int8', on the respacing grid ``spacing``."""
        n = _ylm.max_steps(num_steps)
        with conv_quant(quant) if quant else contextlib.nullcontext():
            def fn():
                return _ylm.sample(sampler_pipe, batch, conds, sampler=sampler, num_steps=n,
                                   spacing=spacing)

            fn()  # the kernels' first launches, and under int8 the weights' quantisation
            samples, wall = _ylm.timed(fn, device)
        row = {"sampler": sampler, "steps": n, "wall_s": round(wall, 3),
               "sinkhorn_vs_real": round(scorer.sinkhorn(samples), 2),
               "finite": bool(samples.isfinite().all())}
        if quant:
            row["quant"] = quant
        if spacing:
            row["spacing"] = spacing
        print(row, flush=True)
        return row

    rows = [run(*r) for r in ROWS[s["rows"]]]
    out = {
        "grid": grid, "batch": batch, "train_steps": steps,
        "final_train_loss": final_loss,
        "condition_pairs_lm": pairs,
        "sinkhorn_noise_baseline": round(scorer.noise()["sinkhorn"], 2),
        "rows": rows,
        "device": args.device_line, "train_steps_per_s": trained["steps_per_s"],
    }
    name = f"{NAME}_{s['rows']}.json" if s["rows"] else f"{NAME}.json"
    return _ylm.write_report(args.work_dir, name, out)


if __name__ == "__main__":
    main()
