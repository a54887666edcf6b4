"""Held-out-condition generalization on the 4-axis DeepGalaxy corpus.

The port's counterpart of ``benchmarks/demo_generalization.py``. The corpus
is the full grid of 3 size ratios x 3 mass ratios x 25 merger times
(400..520 Myr by 5) x 4 cameras = 900 frames, each a deterministic render
of its condition row. Training (``examples/config_deep_galaxy.json`` with
the zero-SNR recipe) holds out 5 interior times (410, 435, 460, 485, 510)
and camera 3: 540 frames. Then every one of the 900 rows is sampled from
the EMA weights (trailing DDIM-100 in chunks of GEN_BATCH, each from seed
1000 + its first row) and scored against its render, per partition
(trained, held-out t, held-out camera, both): matched MSE, its 90th
percentile, the MSE against the frame 25 Myr later (cyclic within the
row's (s, m, c)), their ratio and the Sinkhorn divergence over at most 180
rows; and on the trained rows the per-axis separation (each sample against
the frame with one of s, m, t, c stepped to the next trained value). The
per-stack max normalisation runs before the held-out frames are dropped,
so a held-out frame is the same in the training and the evaluation sets.

Two conditioners (``GEN_COND``): ``fourier`` (FourierConditioning, smooth
in the raw values) and ``embed`` (the config's MultiEmbeddings: a held-out
value keeps its untrained row).

    python -m rho_diffusion_tpu_torch.benchmarks.demo_generalization
        [-d cuda|cpu] [--work-dir DIR]

Knobs: ``GEN_COND`` (fourier), ``GEN_EPOCHS`` (500; 2 with
``GEN_SMOKE=1``), ``GEN_BATCH`` (30), ``GEN_SMOKE`` (the JAX cut: 128^2
frames, one (s, m) block of 100 rows evaluated, DDIM-10, the t axis only),
``GEN_WORKDIR`` (the trainer's directory, default ``<work-dir>/<cond>``),
``GEN_CORPUS_DIR`` (where the HDF5 corpus is written, default
``<work-dir>``), and ``_corpus``'s ``CORPUS_MAX_STEPS``. Writes
``<work-dir>/demo_generalization_galaxy_<cond>_metrics.json`` and
``..._grid.png``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.utils import plot_image_grid

NAME = "demo_generalization"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("cond", "epochs", "batch", "frames_train", "frames_eval", "held_out_t",
               "held_out_camera", "train_wall_s", "sample_wall_s", "noise_mse", "partitions",
               "per_axis_separation_trained", "matched_mse_trained")
S_VALUES = (0.25, 0.5, 1.0)
M_VALUES = (0.5, 1.0, 1.5)
CAMERAS = (0, 1, 2, 3)
T_VALUES = np.arange(400.0, 521.0, 5.0)  # 25 values
HOLD_T = [410.0, 435.0, 460.0, 485.0, 510.0]  # interior: interpolation
TRAIN_CAMS = [0, 1, 2]
HOLD_CAM = 3  # extrapolation
SAMPLE_SEED = 1000
T_SHIFT = 5  # t values (25 Myr) for the mismatched baseline
SINKHORN_ROWS = 180
NOISE_ROWS = 64
CONDITIONERS = {"fourier": "FourierConditioning", "embed": "MultiEmbeddings"}


def settings() -> dict:
    smoke = os.environ.get("GEN_SMOKE", "0") == "1"
    cond = os.environ.get("GEN_COND", "fourier")
    if cond not in CONDITIONERS:
        raise ValueError(f"GEN_COND must be one of {sorted(CONDITIONERS)}, got {cond!r}")
    return {"smoke": smoke, "cond": cond,
            "epochs": _ylm.knob("GEN_EPOCHS", 2 if smoke else 500),
            "batch": _ylm.knob("GEN_BATCH", 30),
            "workdir": os.environ.get("GEN_WORKDIR"),
            "corpus_dir": os.environ.get("GEN_CORPUS_DIR")}


def corpus(smoke: bool) -> dict:
    return {"s_values": list(S_VALUES), "m_values": list(M_VALUES), "cameras": list(CAMERAS),
            "t_values": [float(t) for t in T_VALUES], "size": 128 if smoke else 512}


def config(s: dict):
    cfg = _corpus.harness_config(_corpus.GALAXY_CONFIG, s["epochs"], s["batch"])
    cfg.dataset.kwargs.update(camera_pos=TRAIN_CAMS, t_lim=[400, 520], t_exclude=HOLD_T)
    _corpus.zero_snr(cfg)
    cfg.model.kwargs["cond_fn"] = CONDITIONERS[s["cond"]]
    if s["smoke"]:
        _corpus.smoke_cut(cfg)
    return cfg


def eval_kwargs() -> dict:
    """The evaluation set: every camera and t, the same normalisation."""
    return {"use_emb_as_labels": False, "dset_name_pattern": "s_*",
            "camera_pos": list(CAMERAS), "t_lim": [400, 520]}


class Partners:
    """The script's ``partner``: the row of a label with one axis stepped
    ``delta`` values on (cyclic) among ``values``."""

    def __init__(self, labels: np.ndarray) -> None:
        self.row_of = {tuple(np.round(lab, 4)): i for i, lab in enumerate(labels)}

    def __call__(self, lab, axis: int, values, delta: int = 1) -> int:
        lab2 = lab.copy()
        vals = list(values)
        j = vals.index(lab[axis]) if lab[axis] in vals else 0
        lab2[axis] = vals[(j + delta) % len(vals)]
        return self.row_of[tuple(np.round(lab2, 4))]


def partitions(labels: np.ndarray) -> dict:
    is_hold_t = np.isin(labels[:, 2], HOLD_T)
    is_hold_c = labels[:, 3] == HOLD_CAM
    return {"trained": ~is_hold_t & ~is_hold_c,
            "holdout_t_interpolation": is_hold_t & ~is_hold_c,
            "holdout_camera_extrapolation": ~is_hold_t & is_hold_c,
            "holdout_both": is_hold_t & is_hold_c}


def mismatch_index(labels: np.ndarray) -> np.ndarray:
    partner = Partners(labels)
    return np.array([partner(lab, 2, [float(t) for t in T_VALUES], delta=T_SHIFT)
                     for lab in labels])


def axis_specs(smoke: bool) -> dict:
    """Per axis: (label column, the trained values, step); the t axis alone
    under the smoke cut (one (s, m) block)."""
    specs = {"s": (0, list(S_VALUES), 1), "m": (1, list(M_VALUES), 1),
             "t": (2, [float(t) for t in T_VALUES if t not in HOLD_T], 1),
             "c": (3, [float(c) for c in TRAIN_CAMS], 1)}
    return {"t": specs["t"]} if smoke else specs


def axis_partners(labels: np.ndarray, rows: np.ndarray, smoke: bool) -> dict:
    partner = Partners(labels)
    return {name: np.array([partner(labels[i], axis, values, delta) for i in rows])
            for name, (axis, values, delta) in axis_specs(smoke).items()}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    work = Path(s["workdir"] or args.work_dir / s["cond"])
    h5 = Path(s["corpus_dir"] or args.work_dir) / _corpus.GALAXY_H5
    how = _corpus.route()
    spec = corpus(s["smoke"])
    cfg = config(s)
    print(f"rendering 4-axis DeepGalaxy corpus (900 frames, {how}) ...", flush=True)
    dset = _corpus.galaxy_dataset(cfg.dataset.kwargs, spec, h5, how)
    _corpus.save_corpus(work, "galaxy", spec, how)
    print(f"train set: {len(dset)} frames (cond={s['cond']}); held out: t={HOLD_T} and "
          f"camera {HOLD_CAM}", flush=True)
    if not s["smoke"]:
        assert len(dset) == (len(S_VALUES) * len(M_VALUES) * (len(T_VALUES) - len(HOLD_T))
                             * len(TRAIN_CAMS)), len(dset)
    trainer, state, train_wall, steps_per_s = _corpus.train(cfg, dset, work, args.device)
    pipe = trainer.pipeline

    eval_dset = _corpus.galaxy_dataset(eval_kwargs(), spec, h5, how)
    real = np.stack([eval_dset[i][0] for i in range(len(eval_dset))])
    labels = np.stack([eval_dset[i][1] for i in range(len(eval_dset))])
    if s["smoke"]:  # one (s, m) block (100 rows)
        keep = (labels[:, 0] == 0.5) & (labels[:, 1] == 1.0)
        real, labels = real[keep], labels[keep]
    n = real.shape[0]
    print(f"eval grid: {n} condition rows", flush=True)
    steps = _corpus.max_steps(10 if s["smoke"] else 100)
    gen, sample_wall = _corpus.sample_rows(
        pipe, _ylm.ema_weights(state), n, s["batch"], lambda lo, k: SAMPLE_SEED + lo, "ddim",
        steps, labels=labels)
    print(f"sampled {n} frames in {sample_wall:.1f}s", flush=True)

    per_row_mse = np.mean((gen - real) ** 2, axis=(1, 2, 3))
    mismatched_all = np.mean((gen - real[mismatch_index(labels)]) ** 2, axis=(1, 2, 3))
    noise = _ylm.noise_like(real[:NOISE_ROWS].shape)
    report = {
        "cond": s["cond"], "epochs": s["epochs"], "batch": s["batch"],
        "frames_train": int(len(dset)), "frames_eval": int(n), "held_out_t": HOLD_T,
        "held_out_camera": HOLD_CAM, "train_wall_s": round(train_wall, 1),
        "sample_wall_s": round(sample_wall, 1),
        "noise_mse": float(np.mean((noise - real[:NOISE_ROWS]) ** 2)), "partitions": {},
    }
    parts = partitions(labels)
    for name, mask in parts.items():
        if not mask.any():
            continue
        sub = np.where(mask)[0][:SINKHORN_ROWS]
        matched = float(per_row_mse[mask].mean())
        report["partitions"][name] = {
            "rows": int(mask.sum()), "matched_mse": matched,
            "matched_mse_p90": float(np.quantile(per_row_mse[mask], 0.9)),
            "mismatched_t_shift_mse": float(mismatched_all[mask].mean()),
            "separation_x": float(mismatched_all[mask].mean() / max(matched, 1e-12)),
            "sinkhorn": _ylm.Scorer(real[sub]).sinkhorn(gen[sub]),
        }
        print(f"  {name}: {report['partitions'][name]}", flush=True)
    trained_rows = np.where(parts["trained"])[0]
    matched_trained = float(per_row_mse[trained_rows].mean())
    axis_table = {}
    for ax_name, idx in axis_partners(labels, trained_rows, s["smoke"]).items():
        shifted = float(np.mean((gen[trained_rows] - real[idx]) ** 2))
        axis_table[ax_name] = {"shifted_mse": shifted,
                               "separation_x": shifted / max(matched_trained, 1e-12)}
        print(f"  axis {ax_name}: shifted {shifted:.5f} "
              f"({axis_table[ax_name]['separation_x']:.1f}x matched)", flush=True)
    report["per_axis_separation_trained"] = axis_table
    report["matched_mse_trained"] = matched_trained

    plots = _corpus.plots_missing()
    show = np.where((labels[:, 0] == 0.5) & (labels[:, 1] == 1.0) & (labels[:, 3] == 1))[0]
    if plots is None and len(show):
        show = show[np.argsort(labels[show, 2])]
        show_c = np.where((labels[:, 0] == 0.5) & (labels[:, 1] == 1.0)
                          & (labels[:, 3] == HOLD_CAM))[0]
        show_c = show_c[np.argsort(labels[show_c, 2])][::4][:7]
        plots = str(args.work_dir / f"{NAME}_galaxy_{s['cond']}_grid.png")
        Path(plots).parent.mkdir(parents=True, exist_ok=True)
        plot_image_grid(np.concatenate([real[show], gen[show], real[show_c], gen[show_c]]),
                        ncols=len(show), filename=plots)
    report.update({"sampler": f"ddim-{steps}", "finite": bool(np.isfinite(gen).all()),
                   "plots": plots, "trainer_dir": str(work), "device": args.device_line,
                   "train_steps_per_s": steps_per_s, "corpus_route": how})
    return _ylm.write_report(args.work_dir, f"{NAME}_galaxy_{s['cond']}_metrics.json", report)


if __name__ == "__main__":
    main()
