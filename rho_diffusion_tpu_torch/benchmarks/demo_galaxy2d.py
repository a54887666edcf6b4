"""DeepGalaxy-2D conditional quality: the 2-D UNet trained on the synthetic
galaxy-merger corpus, scored by matched against time-shifted MSE.

The port's counterpart of ``benchmarks/demo_galaxy2d.py``. It trains
``examples/config_deep_galaxy.json`` (UNetv2, 2-D 128^2, width 32,
MultiEmbeddings over the raw (s, m, t, c) rows) on the ``galaxy_synth``
corpus (s 0.25, 0.5, 1; m 1; cameras 0 and 1; 512^2 frames; the config
reads camera 0 and t 400..520) through the config-driven ``Trainer``, then
samples every frame's condition row from the EMA weights (chunks of BATCH
from seeds 1000 + the chunk's first row) and scores:

* matched-condition MSE against each frame's render, its per-condition
  maximum, and the mismatched baseline (each sample against the frame 5
  times later, cyclic within its s group); ``conditioning_separates`` is
  matched < 0.5 x mismatched;
* the Sinkhorn divergence of the samples against the frames, and the same
  of a noise batch (seed 0);
* a PNG grid of real and generated frames over (s, t), where matplotlib is
  installed.

Two recipes (``DEMO_RECIPE``): ``reference`` runs the config as it is
(epsilon DDPM, sampled with its full-T ancestral loop) and ``zero_snr``
(the default) swaps in zero-terminal SNR, v-prediction and trailing
DDIM-100 (``_corpus.zero_snr``).

    python -m rho_diffusion_tpu_torch.benchmarks.demo_galaxy2d [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_RECIPE`` (zero_snr), ``DEMO_EPOCHS`` (1400; 4 with
``DEMO_SMOKE=1``), ``DEMO_BATCH`` (25), ``DEMO_SMOKE`` (the JAX cut, 128^2
frames), ``DEMO_CAMERAS`` (e.g. "0,1": the cameras the config reads; the
tag gains ``_cam01``), ``DEMO_WORKDIR`` (the trainer's directory, default
``<work-dir>/<tag>``), and ``_corpus``'s ``CORPUS_MAX_STEPS``. Writes
``<work-dir>/demo_galaxy2d_<tag>_metrics.json`` and
``demo_galaxy2d_<tag>_grid.png``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.utils import plot_image_grid

NAME = "demo_galaxy2d"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("epochs", "batch", "frames", "train_wall_s", "sample_wall_s", "matched_mse",
               "mismatched_mse", "per_condition_mse_max", "sinkhorn", "noise_baseline",
               "conditioning_separates", "smoke", "recipe")
DDIM_STEPS = 100
SAMPLE_SEED = 1000
MISMATCH_ROLL = 5  # frames (25 Myr) within an s group


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    recipe = os.environ.get("DEMO_RECIPE", "zero_snr")
    cameras = os.environ.get("DEMO_CAMERAS")
    return {"smoke": smoke, "epochs": _ylm.knob("DEMO_EPOCHS", 4 if smoke else 1400),
            "batch": _ylm.knob("DEMO_BATCH", 25), "recipe": recipe, "cameras": cameras,
            "tag": recipe + ("_cam" + cameras.replace(",", "") if cameras else ""),
            "workdir": os.environ.get("DEMO_WORKDIR")}


def corpus(smoke: bool) -> dict:
    """The corpus the JAX script writes (demo_galaxy2d.py:82-88)."""
    return {"s_values": [0.25, 0.5, 1.0], "m_values": [1.0], "cameras": [0, 1],
            "size": 128 if smoke else 512}


def config(s: dict):
    cfg = _corpus.harness_config(_corpus.GALAXY_CONFIG, s["epochs"], s["batch"])
    if s["cameras"]:
        cfg.dataset.kwargs["camera_pos"] = [int(c) for c in s["cameras"].split(",")]
    _corpus.apply_recipe(cfg, s["recipe"])
    if s["smoke"]:
        _corpus.smoke_cut(cfg)
    return cfg


def mismatch_index(labels: np.ndarray) -> np.ndarray:
    """Each row's frame 5 later (cyclic) among the rows of its s value."""
    idx = np.arange(len(labels))
    for s_val in np.unique(labels[:, 0]):
        rows = np.where(labels[:, 0] == s_val)[0]
        idx[rows] = np.roll(rows, MISMATCH_ROLL)
    return idx


def grid_tiles(real: np.ndarray, gen: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Rows real then generated for each s; 7 evenly spaced t a row."""
    t_vals = np.unique(labels[:, 2])
    t_show = t_vals[:: max(len(t_vals) // 7, 1)][:7]
    rows = []
    for s_val in np.unique(labels[:, 0]):
        for src in (real, gen):
            rows.append(np.stack([src[int(np.where((labels[:, 0] == s_val)
                                                   & (labels[:, 2] == t))[0][0])]
                                  for t in t_show]))
    return np.concatenate(rows), len(t_show)


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    work = Path(s["workdir"] or args.work_dir / s["tag"])
    how = _corpus.route()
    spec = corpus(s["smoke"])
    cfg = config(s)
    print(f"rendering synthetic DeepGalaxy corpus ({how}) ...", flush=True)
    dset = _corpus.galaxy_dataset(cfg.dataset.kwargs, spec, work / _corpus.GALAXY_H5, how)
    _corpus.save_corpus(work, "galaxy", spec, how)
    print(f"dataset: {len(dset)} frames, space {dset.loaded_parameter_space.parameters}",
          flush=True)
    trainer, state, train_wall, steps_per_s = _corpus.train(cfg, dset, work, args.device)
    pipe = trainer.pipeline

    # ground truth and condition rows as the training data pipeline made them
    real = np.stack([dset[i][0] for i in range(len(dset))])
    labels = np.stack([dset[i][1] for i in range(len(dset))])
    order = np.lexsort((labels[:, 2], labels[:, 0]))  # by (s, t)
    real, labels = real[order], labels[order]
    n = real.shape[0]
    steps = _corpus.max_steps(DDIM_STEPS if s["recipe"] == "zero_snr" else len(pipe.schedule))
    gen, sample_wall = _corpus.sample_rows(
        pipe, _ylm.ema_weights(state), n, s["batch"], lambda lo, k: SAMPLE_SEED + lo, "ddim",
        steps, labels=labels)

    matched = float(np.mean((gen - real) ** 2))
    per_cond = np.mean((gen - real) ** 2, axis=(1, 2, 3))
    mismatched = float(np.mean((gen - real[mismatch_index(labels)]) ** 2))
    scorer = _ylm.Scorer(real)
    sinkhorn = scorer.sinkhorn(gen)
    noise = scorer.noise()
    print(f"matched MSE {matched:.5f}  mismatched {mismatched:.5f}  sinkhorn {sinkhorn:.4f}  "
          f"(noise: {noise['matched_mse']:.3f}/{noise['sinkhorn']:.3f})", flush=True)

    plots = _corpus.plots_missing()
    if plots is None:
        tiles, ncols = grid_tiles(real, gen, labels)
        plots = str(args.work_dir / f"{NAME}_{s['tag']}_grid.png")
        Path(plots).parent.mkdir(parents=True, exist_ok=True)
        plot_image_grid(tiles, ncols=ncols, filename=plots)
    report = {
        "epochs": s["epochs"], "batch": s["batch"], "frames": int(n),
        "train_wall_s": round(train_wall, 1), "sample_wall_s": round(sample_wall, 1),
        "matched_mse": matched, "mismatched_mse": mismatched,
        "per_condition_mse_max": float(per_cond.max()), "sinkhorn": sinkhorn,
        "noise_baseline": {"mse": noise["matched_mse"], "sinkhorn": noise["sinkhorn"]},
        "conditioning_separates": bool(matched < 0.5 * mismatched),
        "smoke": bool(s["smoke"]), "recipe": s["tag"],
        "sampler": _corpus.sampler_name(pipe, "ddim", steps),
        "finite": bool(np.isfinite(gen).all()), "plots": plots, "trainer_dir": str(work),
        "device": args.device_line, "train_steps_per_s": steps_per_s, "corpus_route": how,
    }
    return _ylm.write_report(args.work_dir, f"{NAME}_{s['tag']}_metrics.json", report)


if __name__ == "__main__":
    main()
