"""Why the reference DeepGalaxy recipe fails at sampling: the DC probe.

The port's counterpart of ``benchmarks/galaxy_dc_probe.py``. It loads the
weights a ``DEMO_RECIPE=reference`` run of ``demo_galaxy2d`` trained (the
port's ``model.pth`` in that run's directory, or ``-p`` a ``.pth`` or a JAX
``model.npz``, through ``load_weights_auto``) into JAX's probe pipeline
(GaussianDiffusion over LinearSchedule(500), epsilon, fixed_small,
MultiEmbeddings at 4 x model_channels, the config's UNet in bf16) and, on
the first 25 frames of that run's corpus, prints the epsilon MSE and the
implied x0 MSE at t in (10, 100, 250, 400, 480, 499), each from its own
noise draw (a generator seeded 7 + t); the error on x0 grows as 1/abar.
JAX prints the table only; the port also writes it as
``<work-dir>/galaxy_dc_probe.json`` (``per_t``: abar, eps_mse, x0_mse by t,
beside the frame count and the data's mean and std).

    python -m rho_diffusion_tpu_torch.benchmarks.galaxy_dc_probe [-d cuda|cpu]
        [--work-dir DIR] [-p WEIGHTS]

Knob: ``GALAXY_WORKDIR`` (the reference run's trainer directory, default
``build/demo_galaxy2d/reference``, where ``demo_galaxy2d`` with its default
work dir puts it); the corpus is rebuilt from the ``corpus.json`` it left
there, on this host's route (``_corpus.route``).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from rho_diffusion_tpu_torch.benchmarks import _corpus, _ylm
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline, LinearSchedule
from rho_diffusion_tpu_torch.training.checkpoint import load_weights_auto

NAME = "galaxy_dc_probe"
# the JAX script prints its table and writes no report
REPORT_KEYS = ()
PROBE_T = (10, 100, 250, 400, 480, 499)
NOISE_SEED = 7
MAX_FRAMES = 25
# the dataset the JAX script reads (galaxy_dc_probe.py:47-51)
PROBE_DATASET = {"use_emb_as_labels": False, "dset_name_pattern": "s_*", "camera_pos": [0],
                 "t_lim": [400, 520]}


def settings() -> dict:
    return {"workdir": Path(os.environ.get(
        "GALAXY_WORKDIR", _ylm.REPO / "build" / "demo_galaxy2d" / "reference"))}


def probe_pipeline(model_kwargs: dict, dset, device,
                   dtype: str = "bfloat16") -> GaussianDiffusionPipeline:
    """JAX's probe pipeline around the config's UNet (galaxy_dc_probe.py:52-62)."""
    mk = dict(model_kwargs, dtype=dtype)
    mk.pop("cond_fn", None)
    return GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=mk, schedule=LinearSchedule(500),
        model_mean_type="epsilon", model_var_type="fixed_small", optimizer="AdamW",
        cond_fn="MultiEmbeddings",
        cond_fn_kwargs={"parameter_space": dset.parameter_space,
                        "embedding_dim": 4 * mk["model_channels"]},
        device=device)


def seeded_noise(t: int, shape, device) -> torch.Tensor:
    """t's draw: a generator seeded 7 + t (JAX folds t into key 7)."""
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(
        NOISE_SEED + t), device=device)


@torch.no_grad()
def probe(pipe, x0: torch.Tensor, labels: torch.Tensor, noise=seeded_noise) -> dict:
    """{t: {abar, eps_mse, x0_mse}} over PROBE_T, with ``noise(t, shape,
    device)`` as t's epsilon; x_t and x0's estimate in fp32 with the fp64
    abar's roots rounded to fp32, as JAX computes them, the model's epsilon
    cast to fp32."""
    abar = pipe.coeffs.alphas_cumprod.double().cpu().numpy()
    dev = x0.device
    out = {}
    for t in PROBE_T:
        ab = float(abar[t])
        a, b = float(np.float32(np.sqrt(ab))), float(np.float32(np.sqrt(1 - ab)))
        eps = noise(t, x0.shape, dev)
        x_t = a * x0 + b * eps
        eps_hat = pipe.apply(x_t, torch.full((x0.shape[0],), t, dtype=torch.int64,
                                             device=dev), labels).float()
        err = float(torch.mean((eps_hat - eps) ** 2))
        x0_pred = (x_t - b * eps_hat) / a
        x0err = float(torch.mean((x0_pred - x0) ** 2))
        out[str(t)] = {"abar": ab, "eps_mse": err, "x0_mse": x0err}
        print(f"t={t:3d} abar={ab:.2e} eps-MSE {err:.5f} -> implied x0-MSE {x0err:.4f} "
              f"(amplification 1/abar = {1 / ab:.0f}x)", flush=True)
    return out


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv, **{"-p": {"dest": "weights", "default": None}})
    s = settings()
    work = s["workdir"]
    weights = Path(args.weights) if args.weights else work / "model.pth"
    if not weights.exists():
        raise FileNotFoundError(
            f"no trained weights at {weights}: run demo_galaxy2d with DEMO_RECIPE=reference "
            f"into {work}, or pass -p WEIGHTS")
    cfg = ExperimentConfig.from_json(_corpus.GALAXY_CONFIG)
    if (work / _corpus.CONFIG_FILE).exists():  # the run's own widths (a smoke cut)
        cfg = ExperimentConfig.from_json(work / _corpus.CONFIG_FILE)
    how = _corpus.route()
    dset = _corpus.galaxy_dataset(PROBE_DATASET, _corpus.load_corpus(work, "galaxy"),
                                  work / _corpus.GALAXY_H5, how)
    pipe = probe_pipeline(cfg.model.kwargs, dset, args.device)
    pipe.load_state_dict(load_weights_auto(pipe.backbone, weights, dict(cfg.model.kwargs),
                                           cfg.model.name))
    n = min(len(dset), MAX_FRAMES)
    x0 = torch.as_tensor(np.stack([dset[i][0] for i in range(n)]), device=pipe.device)
    labels = torch.as_tensor(np.stack([dset[i][1] for i in range(n)]), device=pipe.device)
    mean, std = float(x0.mean()), float(x0.std())
    print(f"frames: {n}, data mean {mean:+.3f} (the DC the probe is about), std {std:.3f}",
          flush=True)
    per_t = probe(pipe, x0, labels)
    report = {"frames": n, "data_mean": mean, "data_std": std, "per_t": per_t,
              "weights": str(weights),
              "finite": bool(all(np.isfinite(list(v.values())).all() for v in per_t.values())),
              "device": args.device_line, "train_steps_per_s": None, "corpus_route": how}
    return _ylm.write_report(args.work_dir, f"{NAME}.json", report)


if __name__ == "__main__":
    main()
