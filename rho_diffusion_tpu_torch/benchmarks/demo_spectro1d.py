"""Spectroscopy-1D quality: the 1-D UNet trained on rigid-rotor spectra,
its samples scored against the corpus.

The port's counterpart of ``benchmarks/demo_spectro1d.py``. It trains
``examples/config_spectroscopy.json`` (UNetv2, 1-D, width 32,
unconditional) at grid DEMO_GRID on DEMO_MOLECULES ``spectro_synth`` rotors
with a fixed linewidth of 80 (so each spectrum is a function of its rotor)
through the config-driven ``Trainer``, then samples as many spectra from
the EMA weights (chunks of BATCH, chunk i from seed 2000 + i) and scores:

* the nearest-neighbour MSE of each sample against the corpus, and the same
  of a noise batch (|N(0, 1)|, seed 0);
* the Sinkhorn divergence against the corpus, beside the noise batch's;
* the comb statistics (``metrics.peak_stats``): the fraction of samples
  with at least 3 peaks at regularity below 0.25, the median regularity of
  samples and corpus, the baseline (< 0.02) and negative (< -0.05)
  fractions of the samples' bins;
* an overlay PNG of 6 samples on their nearest spectra, where matplotlib
  is installed.

Recipes (``DEMO_RECIPE``): ``reference`` (the default: epsilon DDPM,
sampled with its full-T ancestral loop) and ``zero_snr`` (trailing
DDIM-100).

    python -m rho_diffusion_tpu_torch.benchmarks.demo_spectro1d [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_EPOCHS`` (800; 4 with ``DEMO_SMOKE=1``), ``DEMO_BATCH`` (16),
``DEMO_MOLECULES`` (64; 8), ``DEMO_GRID`` (1024; 256), ``DEMO_RECIPE``
(reference), ``DEMO_SMOKE``, ``DEMO_WORKDIR`` (the trainer's directory,
default ``<work-dir>/<recipe>``; ``spectro_rescore`` resumes its
checkpoint), and ``_corpus``'s ``CORPUS_MAX_STEPS``.
Writes ``<work-dir>/demo_spectro1d_<recipe>_metrics.json`` and
``demo_spectro1d_<recipe>.png``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.metrics import peak_stats

NAME = "demo_spectro1d"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("recipe", "epochs", "molecules", "grid", "train_wall_s", "sample_wall_s",
               "nn_mse", "sinkhorn", "noise_baseline", "comb_fraction",
               "comb_regularity_median_gen", "comb_regularity_median_real",
               "baseline_fraction_below_0.02", "negative_fraction", "smoke")
LINEWIDTH = 80.0  # fixed: spectra are deterministic, so the NN-MSE means something
DDIM_STEPS = 100
SAMPLE_SEED = 2000
CORPUS_SEED = 0


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    return {"smoke": smoke, "epochs": _ylm.knob("DEMO_EPOCHS", 4 if smoke else 800),
            "batch": _ylm.knob("DEMO_BATCH", 16),
            "molecules": _ylm.knob("DEMO_MOLECULES", 8 if smoke else 64),
            "grid": _ylm.knob("DEMO_GRID", 256 if smoke else 1024),
            "recipe": os.environ.get("DEMO_RECIPE", "reference"),
            "workdir": os.environ.get("DEMO_WORKDIR")}


def config(s: dict):
    cfg = _corpus.harness_config(_corpus.SPECTRO_CONFIG, s["epochs"], s["batch"])
    cfg.dataset.kwargs.update(grid_size=s["grid"], linewidth=LINEWIDTH)
    cfg.model.kwargs["data_shape"] = [s["grid"]]
    _corpus.apply_recipe(cfg, s["recipe"])
    if s["smoke"]:
        _corpus.smoke_cut(cfg)
    return cfg


def nn_distances(gen: np.ndarray, real: np.ndarray) -> np.ndarray:
    """[N_gen, N_real] mean squared distances of [N, G, 1] spectra."""
    return ((gen[:, None, :, 0] - real[None, :, :, 0]) ** 2).mean(-1)


def overlay(gen: np.ndarray, real: np.ndarray, nn_idx: np.ndarray, path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = min(6, len(gen))
    fig, axes = plt.subplots(k, 1, figsize=(10, 2 * k), sharex=True)
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(gen[i, :, 0], lw=0.8, label="generated")
        ax.plot(real[nn_idx[i], :, 0], lw=0.8, alpha=0.6, label="nearest real")
        ax.set_ylim(-0.2, 1.1)
        if i == 0:
            ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    work = Path(s["workdir"] or args.work_dir / s["recipe"])
    how = _corpus.route()
    spec = {"n_molecules": s["molecules"], "seed": CORPUS_SEED}
    cfg = config(s)
    dset = _corpus.spectra_dataset(cfg.dataset.kwargs, spec, work / _corpus.SPECTRA_H5, how)
    _corpus.save_corpus(work, "spectra", spec, how)
    real = np.stack([dset[i]["spectrum"] for i in range(len(dset))])  # [N, G, 1]
    trainer, state, train_wall, steps_per_s = _corpus.train(cfg, dset, work, args.device)
    pipe = trainer.pipeline
    n = real.shape[0]
    steps = _corpus.max_steps(DDIM_STEPS if s["recipe"] == "zero_snr" else len(pipe.schedule))
    gen, sample_wall = _corpus.sample_rows(
        pipe, _ylm.ema_weights(state), n, s["batch"], lambda lo, i: SAMPLE_SEED + i, "ddim",
        steps, full_chunks=True)

    d2 = nn_distances(gen, real)
    nn_idx = d2.argmin(1)
    nn_mse = float(d2[np.arange(n), nn_idx].mean())
    scorer = _ylm.Scorer(real)
    sinkhorn = scorer.sinkhorn(gen)
    noise = np.abs(_ylm.noise_like(real.shape))
    noise_nn = float(nn_distances(noise, real).min(1).mean())
    noise_sink = scorer.sinkhorn(noise)
    gen_stats = [peak_stats(g[:, 0]) for g in gen]
    reg = np.asarray([r for _, r in gen_stats if np.isfinite(r)])
    reg_real = np.asarray([r for _, r in (peak_stats(x[:, 0]) for x in real) if np.isfinite(r)])
    combs = float(np.mean([(c >= 3 and np.isfinite(r) and r < 0.25) for c, r in gen_stats]))
    print(f"NN-MSE {nn_mse:.5f} (noise {noise_nn:.4f})  sinkhorn {sinkhorn:.3f} "
          f"(noise {noise_sink:.3f})  combs {combs:.2f}  regularity "
          f"{np.median(reg) if reg.size else float('nan'):.3f} "
          f"(real {np.median(reg_real) if reg_real.size else float('nan'):.3f})", flush=True)

    plots = _corpus.plots_missing()
    if plots is None:
        plots = str(args.work_dir / f"{NAME}_{s['recipe']}.png")
        Path(plots).parent.mkdir(parents=True, exist_ok=True)
        overlay(gen, real, nn_idx, Path(plots))
    report = {
        "recipe": s["recipe"], "epochs": s["epochs"], "molecules": int(n), "grid": s["grid"],
        "train_wall_s": round(train_wall, 1), "sample_wall_s": round(sample_wall, 1),
        "nn_mse": nn_mse, "sinkhorn": sinkhorn,
        "noise_baseline": {"nn_mse": noise_nn, "sinkhorn": noise_sink},
        "comb_fraction": combs,
        "comb_regularity_median_gen": float(np.median(reg)) if reg.size else None,
        "comb_regularity_median_real": float(np.median(reg_real)) if reg_real.size else None,
        "baseline_fraction_below_0.02": float((gen[..., 0] < 0.02).mean()),
        "negative_fraction": float((gen[..., 0] < -0.05).mean()),
        "smoke": bool(s["smoke"]),
        "sampler": _corpus.sampler_name(pipe, "ddim", steps),
        "finite": bool(np.isfinite(gen).all()), "plots": plots, "trainer_dir": str(work),
        "device": args.device_line, "train_steps_per_s": steps_per_s, "corpus_route": how,
    }
    return _ylm.write_report(args.work_dir, f"{NAME}_{s['recipe']}_metrics.json", report)


if __name__ == "__main__":
    main()
