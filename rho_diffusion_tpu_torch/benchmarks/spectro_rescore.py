"""Rescore trained Spectroscopy-1D weights through six samplers.

The port's counterpart of ``benchmarks/spectro_rescore.py``, eval-only. It
takes the EMA weights of a ``demo_spectro1d`` run (the reference recipe,
epsilon) and samples its corpus's count of spectra (chunks of 16, chunk i
from seed 2000 + i) with the training pipeline's own full-T ancestral loop
(DDPM), then through GaussianDiffusion (epsilon, fixed_small, the run's
schedule) with DDIM-100, DDIM-50, dpm++-10, UniPC-10 and sde-dpm++-10, and
scores each by the comb statistics (``metrics.comb_metrics``), the
nearest-neighbour MSE and the Sinkhorn divergence against the corpus.

JAX restores the run's Orbax state in a CPU subprocess and exports its EMA
weights; Orbax stays unreadable here. Instead the port resumes the run's
own ``Trainer`` checkpoint in RESCORE_WORKDIR in process (``init_state``,
with the config the run saved beside it), or takes ``-p`` a ``.pth`` or a
JAX ``model.npz`` (then at the config's widths, grid 1024). The report
names the step it restored (JAX writes the saved run's 14400). The corpus
is rebuilt from the run's molecule count and seed (its ``corpus.json``) on
this host's route.

    python -m rho_diffusion_tpu_torch.benchmarks.spectro_rescore [-d cuda|cpu]
        [--work-dir DIR] [-p WEIGHTS]

Knob: ``RESCORE_WORKDIR`` (default ``build/demo_spectro1d/reference``, the
reference run's directory under ``demo_spectro1d``'s default work dir), and
``_corpus``'s ``CORPUS_MAX_STEPS`` (rows named by the steps that ran; rows
that a cap makes the same are run once). Writes
``<work-dir>/spectro_rescore_metrics.json``.
"""
from __future__ import annotations

import copy
import os
from pathlib import Path

import numpy as np

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.config import ComponentConfig, ExperimentConfig
from rho_diffusion_tpu_torch.metrics import comb_metrics
from rho_diffusion_tpu_torch.training.checkpoint import load_weights_auto
from rho_diffusion_tpu_torch.training.trainer import Trainer, build_pipeline_from_config

NAME = "spectro_rescore"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("restored_step", "molecules", "grid", "samplers")
GRID = 1024
BATCH = 16
EPOCHS = 3600  # the saved run's budget in the JAX script (T_max of its cosine schedule)
SAMPLE_SEED = 2000
SPECTRA_CORPUS = {"n_molecules": 64, "seed": 0}
ANCESTRAL = ("ancestral_fullT", "ancestral", None)
ROWS = (("ddim_100", "ddim", 100), ("ddim_50", "ddim", 50), ("dpm++_10", "dpm++", 10),
        ("unipc_10", "unipc", 10), ("sde-dpm++_10", "sde-dpm++", 10))


def settings() -> dict:
    return {"workdir": Path(os.environ.get(
        "RESCORE_WORKDIR", _ylm.REPO / "build" / "demo_spectro1d" / "reference"))}


def saved_config(work: Path) -> ExperimentConfig:
    """The config the run trained with (its ``config.json``), else JAX's
    rebuild of the saved run's: the example config at grid 1024."""
    if (work / _corpus.CONFIG_FILE).exists():
        config = ExperimentConfig.from_json(work / _corpus.CONFIG_FILE)
    else:
        config = _corpus.harness_config(_corpus.SPECTRO_CONFIG, EPOCHS, BATCH)
        config.dataset.kwargs.update(grid_size=GRID, linewidth=80.0)
        config.model.kwargs["data_shape"] = [GRID]
    if config.pipeline is not None and config.pipeline.name != "DDPM":
        raise ValueError(f"the run in {work} trained a {config.pipeline.name} "
                         f"({config.pipeline.kwargs}); the rescore reads the reference "
                         "recipe's epsilon DDPM")
    return config


def restored_weights(config, dset, work: Path, weights, device) -> tuple:
    """(EMA-else-raw weights by name, the step restored): ``weights`` loaded
    into a fresh state, or the latest checkpoint in ``work`` resumed."""
    trainer = Trainer(config, dataset=dset, work_dir=work, device=device, loggers=[])
    if weights:
        state = trainer.pipeline.create_state(seed=config.training.seed)
        trainer.pipeline.load_state_dict(load_weights_auto(
            state.model, weights, dict(config.model.kwargs), config.model.name))
        return {k: p.detach() for k, p in state.model.named_parameters()}, None
    if trainer.checkpoints.latest_step() is None:
        raise FileNotFoundError(
            f"no saved run in {work} (no checkpoints/step_*.pt): run demo_spectro1d with its "
            "reference recipe into it, or pass -p WEIGHTS")
    state = trainer.init_state(resume=True)
    return _ylm.ema_weights(state), int(state.step)


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv, **{"-p": {"dest": "weights", "default": None}})
    work = settings()["workdir"]
    if not args.weights and not (work / _corpus.CONFIG_FILE).exists():
        raise FileNotFoundError(
            f"saved run not found at {work}: run demo_spectro1d with its reference recipe "
            "into it (RESCORE_WORKDIR), or pass -p WEIGHTS")
    config = saved_config(work)
    how = _corpus.route()
    spec = (_corpus.load_corpus(work, "spectra") if (work / _corpus.CORPUS_FILE).exists()
            else SPECTRA_CORPUS)
    dset = _corpus.spectra_dataset(config.dataset.kwargs, spec, work / _corpus.SPECTRA_H5, how)
    weights, step = restored_weights(config, dset, work, args.weights, args.device)
    print(f"loaded EMA weights (step {step})", flush=True)
    grid = config.model.kwargs["data_shape"][0]
    n = len(dset)
    real = np.stack([dset[i]["spectrum"] for i in range(n)])  # [N, G, 1]
    ddpm = build_pipeline_from_config(config, dataset=dset, device=args.device)
    gauss_config = copy.deepcopy(config)
    gauss_config.pipeline = ComponentConfig(
        name="GaussianDiffusionPipeline",
        kwargs={"model_mean_type": "epsilon", "model_var_type": "fixed_small"})
    gauss = build_pipeline_from_config(gauss_config, dataset=dset, device=args.device)
    scorer = _ylm.Scorer(real)

    results = {}
    for tag, sampler, steps in (ANCESTRAL, *ROWS):
        pipe = ddpm if steps is None else gauss
        ran = _corpus.max_steps(len(ddpm.schedule) if steps is None else steps)
        if ran != (steps or len(ddpm.schedule)):
            tag = f"{tag.split('_')[0]}_{ran}"
        if tag in results:  # a cap made it the same as a row already run
            continue
        gen, wall = _corpus.sample_rows(pipe, weights, n, BATCH,
                                        lambda lo, i: SAMPLE_SEED + i, sampler, ran,
                                        full_chunks=True)
        d2 = ((gen[:, None, :, 0] - real[None, :, :, 0]) ** 2).mean(-1)
        m = comb_metrics(gen[..., 0], real[..., 0])
        m.update(nfe=ran, nn_mse=float(d2.min(1).mean()), sinkhorn=scorer.sinkhorn(gen),
                 sample_wall_s=round(wall, 1), finite=bool(np.isfinite(gen).all()))
        results[tag] = m
        print(f"  {tag}: comb {m['comb_fraction']:.3f} (real ceiling "
              f"{m['comb_fraction_real']:.3f})  NN-MSE {m['nn_mse']:.5f}  "
              f"sinkhorn {m['sinkhorn']:.3f}  [{wall:.0f}s]", flush=True)
    report = {"restored_step": step, "molecules": int(n), "grid": grid, "samplers": results,
              "weights": str(args.weights) if args.weights else str(work / "checkpoints"),
              "device": args.device_line, "train_steps_per_s": None, "corpus_route": how}
    return _ylm.write_report(args.work_dir, f"{NAME}_metrics.json", report)


if __name__ == "__main__":
    main()
