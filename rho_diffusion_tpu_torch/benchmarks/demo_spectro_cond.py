"""Condition-generalizing Spectroscopy-1D: the 1-D UNet conditioned on each
rotor's physics row, 8 of 64 rotors held out.

The port's counterpart of ``benchmarks/demo_spectro_cond.py``. It trains
``examples/config_spectroscopy.json`` conditioned on the (B, T, D, n_lines)
row of each rotor (``num_classes`` = the rotor count, a conditioner over
the corpus's parameter space; GaussianDiffusion, epsilon, fixed_small) on
all rotors but ``HOLDOUT`` (every 8th from the 6th), with a fixed
linewidth of 80 so each spectrum is a function of its row; then it samples
every rotor from its row alone (DDIM-100 from the EMA weights, chunks of
16, each from seed 3000 + its first row) and scores, for the trained and
the held-out rotors, the matched MSE against the rotor's own spectrum
beside the MSE to the nearest trained spectrum (``interpolates``: matched
below nearest-trained) and the comb statistics; plus the Sinkhorn
divergence over all rotors and a noise batch's MSE (|N(0, 1)|, seed 0).

Two conditioners (``SPECTRO_COND``): ``fourier`` (FourierConditioning) and
``embed`` (MultiEmbeddings).

    python -m rho_diffusion_tpu_torch.benchmarks.demo_spectro_cond [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``SPECTRO_COND`` (fourier), ``SPECTRO_EPOCHS`` (1200; 2 with
``SPECTRO_SMOKE=1``: the JAX cut at 16 rotors, grid 256, DDIM-10),
``SPECTRO_WORKDIR`` (the trainer's directory, default ``<work-dir>/<cond>``),
``SPECTRO_CORPUS_DIR`` (where the HDF5 corpus is written, default the
trainer's directory), and ``_corpus``'s ``CORPUS_MAX_STEPS``. Writes ``<work-dir>/demo_spectro_cond_<cond>_metrics.json``
and ``demo_spectro_cond_<cond>.png``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.config import ComponentConfig
from rho_diffusion_tpu_torch.metrics import comb_metrics

NAME = "demo_spectro_cond"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("cond", "epochs", "molecules", "held_out", "grid", "train_wall_s",
               "sample_wall_s", "noise_mse", "partitions", "sinkhorn_all")
BATCH = 16
LINEWIDTH = 80.0
SAMPLE_SEED = 3000
CORPUS_SEED = 0
CONDITIONERS = {"fourier": "FourierConditioning", "embed": "MultiEmbeddings"}


def settings() -> dict:
    smoke = os.environ.get("SPECTRO_SMOKE", "0") == "1"
    cond = os.environ.get("SPECTRO_COND", "fourier")
    if cond not in CONDITIONERS:
        raise ValueError(f"SPECTRO_COND must be one of {sorted(CONDITIONERS)}, got {cond!r}")
    n_mol = 16 if smoke else 64
    holdout = list(range(5, n_mol, 8))
    return {"smoke": smoke, "cond": cond,
            "epochs": _ylm.knob("SPECTRO_EPOCHS", 2 if smoke else 1200),
            "molecules": n_mol, "grid": 256 if smoke else 1024, "holdout": holdout,
            "train_idx": [i for i in range(n_mol) if i not in holdout],
            "workdir": os.environ.get("SPECTRO_WORKDIR"),
            "corpus_dir": os.environ.get("SPECTRO_CORPUS_DIR")}


def config(s: dict):
    cfg = _corpus.harness_config(_corpus.SPECTRO_CONFIG, s["epochs"], BATCH)
    cfg.dataset.kwargs.update(grid_size=s["grid"], linewidth=LINEWIDTH, indices=s["train_idx"])
    cfg.model.kwargs.update(data_shape=[s["grid"]], num_classes=s["molecules"],
                            cond_fn=CONDITIONERS[s["cond"]])
    cfg.pipeline = ComponentConfig(name="GaussianDiffusionPipeline",
                                   kwargs={"model_mean_type": "epsilon",
                                           "model_var_type": "fixed_small"})
    if s["smoke"]:
        _corpus.smoke_cut(cfg)
    return cfg


def overlay(gen: np.ndarray, real: np.ndarray, holdout: list, path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = min(6, len(holdout))
    fig, axes = plt.subplots(k, 1, figsize=(10, 2 * k), sharex=True)
    for ax, i in zip(np.atleast_1d(axes), holdout[:k]):
        ax.plot(gen[i, :, 0], lw=0.8, label=f"generated (held-out mol {i})")
        ax.plot(real[i, :, 0], lw=0.8, alpha=0.6, label="ground truth")
        ax.set_ylim(-0.2, 1.1)
        ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    work = Path(s["workdir"] or args.work_dir / s["cond"])
    h5 = Path(s["corpus_dir"] or work) / _corpus.SPECTRA_H5
    how = _corpus.route()
    spec = {"n_molecules": s["molecules"], "seed": CORPUS_SEED}
    cfg = config(s)
    dset = _corpus.spectra_dataset(cfg.dataset.kwargs, spec, h5, how)
    _corpus.save_corpus(work, "spectra", spec, how)
    assert len(dset) == len(s["train_idx"])
    print(f"train: {len(dset)} molecules (cond={s['cond']}); held out: {s['holdout']}",
          flush=True)
    trainer, state, train_wall, steps_per_s = _corpus.train(cfg, dset, work, args.device)
    pipe = trainer.pipeline

    full_kwargs = {k: v for k, v in cfg.dataset.kwargs.items() if k != "indices"}
    full = _corpus.spectra_dataset(full_kwargs, spec, h5, how)
    items = [full[i] for i in range(s["molecules"])]
    real = np.stack([it["spectrum"] for it in items])  # [N, G, 1]
    labels = np.stack([it["params"] for it in items])  # [N, 4]
    steps = _corpus.max_steps(10 if s["smoke"] else 100)
    gen, sample_wall = _corpus.sample_rows(
        pipe, _ylm.ema_weights(state), s["molecules"], BATCH, lambda lo, k: SAMPLE_SEED + lo,
        "ddim", steps, labels=labels)

    per_mol_mse = np.mean((gen - real) ** 2, axis=(1, 2))
    train_mask = np.isin(np.arange(s["molecules"]), s["train_idx"])
    # nearest-trained distance: does a held-out rotor interpolate or replay?
    real_trained = real[train_mask][:, :, 0]
    nn_trained = ((gen[:, None, :, 0] - real_trained[None, :, :]) ** 2).mean(-1).min(1)
    noise = np.abs(_ylm.noise_like(real.shape))
    report = {
        "cond": s["cond"], "epochs": s["epochs"], "molecules": s["molecules"],
        "held_out": s["holdout"], "grid": s["grid"], "train_wall_s": round(train_wall, 1),
        "sample_wall_s": round(sample_wall, 1),
        "noise_mse": float(np.mean((noise - real) ** 2)), "partitions": {},
    }
    for name, mask in (("trained", train_mask), ("holdout", ~train_mask)):
        matched = float(per_mol_mse[mask].mean())
        nn_t = float(nn_trained[mask].mean())
        report["partitions"][name] = {
            "rows": int(mask.sum()), "matched_mse": matched, "nn_trained_mse": nn_t,
            "interpolates": bool(matched < nn_t),
            "comb": comb_metrics(gen[mask][..., 0], real[mask][..., 0])}
        print(f"  {name}: matched {matched:.5f}  nn-trained {nn_t:.5f}  comb "
              f"{report['partitions'][name]['comb']['comb_fraction']:.3f}", flush=True)
    report["sinkhorn_all"] = _ylm.Scorer(real).sinkhorn(gen)

    plots = _corpus.plots_missing()
    if plots is None:
        plots = str(args.work_dir / f"{NAME}_{s['cond']}.png")
        Path(plots).parent.mkdir(parents=True, exist_ok=True)
        overlay(gen, real, s["holdout"], Path(plots))
    report.update({"sampler": f"ddim-{steps}", "finite": bool(np.isfinite(gen).all()),
                   "plots": plots, "trainer_dir": str(work), "device": args.device_line,
                   "train_steps_per_s": steps_per_s, "corpus_route": how})
    return _ylm.write_report(args.work_dir, f"{NAME}_{s['cond']}_metrics.json", report)


if __name__ == "__main__":
    main()
