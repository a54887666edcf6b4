"""The data slice end to end against the JAX package, on the CPU.

* A small 2-D model (config_deep_galaxy.json cut to 16^2, width 32: the
  MultiEmbeddings condition over DeepGalaxyDataset's class-level parameter
  space) and a small 1-D model (config_spectroscopy.json cut to 64 points),
  each built by each package's ``build_pipeline_from_config``, trained on a
  batch from the port's DeepGalaxyDataset / SpectroscopyDataset over a tiny
  synthetic file: two training steps, each from JAX's state (carried over
  after one JAX step, so the moments are not zero), held against JAX's
  ``train_step`` on the same batch, noise and timesteps at the tolerances
  of tests/test_torch_training.py; and the fp32
  forward of each within relative MSE 1e-9 of JAX's.
* The three configs this slice opens (DeepGalaxy, Spectroscopy, and the
  quality config with ``training.device_cache: true``) build a Trainer at
  full width.
* The inference CLI on the DeepGalaxy config without its data file
  conditions on the dataset class's parameter space: the same samples as
  with the file.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.config import ExperimentConfig as JaxExperimentConfig
from rho_diffusion_tpu.data.deep_galaxy import DeepGalaxyDataset as JaxDeepGalaxy
from rho_diffusion_tpu.data.spectroscopy import SpectroscopyDataset as JaxSpectroscopy
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build_pipeline
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data import DeepGalaxyDataset, SpectroscopyDataset
from rho_diffusion_tpu_torch.data.deep_galaxy import center_crop, downscale_2x
from rho_diffusion_tpu_torch.data.galaxy_synth import write_deep_galaxy_h5
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.data.spectro_synth import write_rotor_spectra_h5
from rho_diffusion_tpu_torch.interop.jax_weights import (
    arch_kwargs,
    export_train_state,
    export_unet_state_dict,
    load_train_state,
)
from rho_diffusion_tpu_torch.training.checkpoint import save_model_weights
from rho_diffusion_tpu_torch.training.trainer import Trainer, build_pipeline_from_config
from test_torch_training import (
    LR,
    SCHEDULE,
    adam_moments,
    assert_params_close,
    assert_tree_close,
    nu_hat,
    step_draws,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(model_channels=32, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
             dtype="float32")
CORPUS = dict(s_values=(0.5, 1.0), m_values=(1.0,), cameras=(0,),
              t_values=np.arange(400.0, 440.0, 5.0), size=64)


def transform16(img: np.ndarray) -> np.ndarray:
    """DeepGalaxy's transform at 1/8 scale: a center crop of 32, halved to
    16^2, scaled to [-1, 1], channels-last."""
    img = downscale_2x(center_crop(img, 32), 2)
    return (img.astype(np.float32) * 2.0 - 1.0)[..., None]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    return {"galaxy": write_deep_galaxy_h5(str(tmp / "g.h5"), **CORPUS),
            "spectra": write_rotor_spectra_h5(str(tmp / "s.h5"), n_molecules=12, seed=1)}


def cut_config(which: str, files: dict) -> dict:
    """The shipped config at CPU size (SMALL, fp32, LR and SCHEDULE's step
    count of tests/test_torch_training.py), its dataset on the tiny file."""
    name = {"galaxy": "config_deep_galaxy.json", "spectra": "config_spectroscopy.json"}[which]
    cfg = json.loads((ROOT / "examples" / name).read_text())
    shape = [16, 16] if which == "galaxy" else [64]
    cfg["model"]["kwargs"].update(SMALL, data_shape=shape)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = SCHEDULE["num_steps"]
    cfg["optimizer"]["kwargs"]["lr"] = LR
    cfg["training"].update(dtype="float32", batch_size=4)
    if which == "galaxy":
        cfg["dataset"]["kwargs"].update(path=files["galaxy"], t_lim=[400, 430])
    else:
        # lines ~300 wide on the 64-point grid (spaced ~490): no spectrum is empty
        cfg["dataset"]["kwargs"].update(h5_path=files["spectra"], grid_size=64, linewidth=300.0)
    return cfg


def datasets(which: str, cfg: dict):
    """(port dataset, JAX dataset) on the same file."""
    kwargs = dict(cfg["dataset"]["kwargs"])
    if which == "galaxy":
        return (DeepGalaxyDataset(transform=transform16, **kwargs),
                JaxDeepGalaxy(transform=transform16, **kwargs))
    return SpectroscopyDataset(**kwargs), JaxSpectroscopy(**kwargs)


def pipelines(which: str, files: dict):
    """The cut config's pipelines, built by each package from its config,
    with JAX's initial weights plus N(0, 0.05^2) (no zero-initialised
    layer) carried over to the port; and the port's dataset."""
    cfg = cut_config(which, files)
    ds, jds = datasets(which, cfg)
    jcfg = JaxExperimentConfig.model_validate(json.loads(json.dumps(cfg)))
    jcfg.model.kwargs["dtype"] = jnp.float32
    jpipe = jax_build_pipeline(jcfg, dataset=jds)
    tpipe = build_pipeline_from_config(ExperimentConfig.from_dict(json.loads(json.dumps(cfg))),
                                       dataset=ds, device="cpu")
    params = jpipe.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    return cfg, ds, jpipe, params, tpipe


@pytest.mark.parametrize("which", ["galaxy", "spectra"], ids=["deep_galaxy-2d", "spectroscopy-1d"])
def test_training_steps_match_jax(files, which):
    cfg, ds, jpipe, params, tpipe = pipelines(which, files)
    if which == "galaxy":
        assert tpipe.cond_fn is not None and jpipe.cond_fn is not None
    batches = list(DataLoader(ds, batch_size=4, shuffle=True, seed=0, num_workers=0))
    assert len(batches) >= 3 and batches[0]["data"].shape[1:] == (
        (16, 16, 1) if which == "galaxy" else (64, 1))
    step = jpipe.make_train_step(donate=False)
    js = jpipe.create_state(jax.random.PRNGKey(1), params=params)
    js, _ = step(js, batches[0])  # one JAX step: nonzero moments and count
    ts = tpipe.create_state(seed=0)
    kwargs = cfg["model"]["kwargs"]
    # each step from JAX's state: a parameter whose gradient sits at the two
    # frameworks' rounding noise at one step (an embedding row that only
    # starts to be drawn) takes a sign-like Adam update there, which a later
    # step's moments no longer mark as noise-bound
    for b in batches[1:3]:
        load_train_state(ts, export_train_state(jax.device_get(js), kwargs))
        inject = step_draws(js, b["data"].shape)
        js, want = step(js, b)
        got = tpipe.training_step(ts, b, **inject)
        np.testing.assert_allclose(float(got["train_loss"]), float(want["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
        ex = export_train_state(jax.device_get(js), kwargs)
        # the MultiEmbeddings rows no batch has drawn yet have had exactly
        # zero gradients (v_hat exactly 0): their update is the weight decay
        # alone, so they take the tight bound and are not counted among the
        # noise-bound entries (at most 1%)
        v_hat = {k: np.where((v == 0) & k.startswith("cond_fn.embedding_layers."), np.inf, v)
                 for k, v in nu_hat(ex).items()}
        assert ts.step == ex["step"]
        assert_params_close(ts.model.state_dict(),
                            {k: v.numpy() for k, v in ex["params"].items()}, v_hat, steps=1)
        moments = adam_moments(ts)
        for key in ("exp_avg", "exp_avg_sq"):
            assert_tree_close(moments[key], {k: v.numpy() for k, v in ex[key].items()}, 1e-4,
                              key)
        assert_params_close(ts.ema, {k: v.numpy() for k, v in ex["ema_params"].items()},
                            v_hat, steps=1)
    assert ts.step == 3


@pytest.mark.parametrize("which", ["galaxy", "spectra"], ids=["deep_galaxy-2d", "spectroscopy-1d"])
def test_forward_matches_jax(files, which):
    cfg, ds, jpipe, params, tpipe = pipelines(which, files)
    sd = export_unet_state_dict(params, **arch_kwargs(cfg["model"]["kwargs"]))
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    batch = next(iter(DataLoader(ds, batch_size=4, shuffle=False, num_workers=0)))
    x = batch["data"]
    t = np.asarray([0, 7, 23, 49], np.int32)
    y = batch["labels"] if which == "galaxy" else None
    with torch.no_grad():
        got = tpipe.apply(torch.from_numpy(x), torch.from_numpy(t).long(),
                          None if y is None else torch.from_numpy(y)).numpy()
    want = np.asarray(jpipe.apply(params, jnp.asarray(x), jnp.asarray(t),
                                  None if y is None else jnp.asarray(y)))
    assert got.shape == want.shape == x.shape
    rel = float(np.mean((got.astype(np.float64) - want) ** 2) / np.mean(want.astype(np.float64) ** 2))
    assert rel <= 1e-9, rel


def test_shipped_configs_build_a_trainer(tmp_path, files):
    """At full width: DeepGalaxy (2-D 128^2, its dataset on a synthetic
    file), Spectroscopy (1-D, 4096 points) and the quality config, whose
    ``training.device_cache`` is true (its cache is built at the first fit,
    not here)."""
    built = {}
    for name, update in (
            ("config_deep_galaxy.json", {"path": files["galaxy"]}),
            ("config_spectroscopy.json", {"h5_path": files["spectra"]}),
            ("config_spherical_harmonics_quality.json", {})):
        cfg = json.loads((ROOT / "examples" / name).read_text())
        cfg["dataset"]["kwargs"].update(update)
        trainer = Trainer(ExperimentConfig.from_dict(cfg), work_dir=tmp_path / name, device="cpu")
        built[name] = trainer
        unet = trainer.pipeline.backbone
        assert list(unet.data_shape) == cfg["model"]["kwargs"]["data_shape"]
        assert unet.model_channels == cfg["model"]["kwargs"]["model_channels"]
        assert trainer.loader.batch_size == cfg["training"]["batch_size"]
        assert "device_cache" not in trainer.__dict__
    assert built["config_deep_galaxy.json"].pipeline.cond_fn is not None
    assert built["config_deep_galaxy.json"].dataset[0][0].shape == (128, 128, 1)
    assert built["config_spectroscopy.json"].dataset[0]["spectrum"].shape == (4096, 1)
    assert built["config_spherical_harmonics_quality.json"].config.training.device_cache


def test_inference_without_the_data_file_uses_the_class_space(tmp_path, files, capsys):
    """The inference CLI on the DeepGalaxy config when its HDF5 file is
    absent: the MultiEmbeddings condition is built over the parameter space
    DeepGalaxyDataset declares on its class, which is the one training
    used, so the samples equal those drawn with the file present."""
    cfg = cut_config("galaxy", files)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = 25
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None,
                            parameter_space={"s": [0.5, 1], "m": [1], "t": [400], "c": [0]})
    ds = DeepGalaxyDataset(**cfg["dataset"]["kwargs"])
    pipe = build_pipeline_from_config(ExperimentConfig.from_dict(json.loads(json.dumps(cfg))),
                                      dataset=ds, device="cpu")
    weights = tmp_path / "model.pth"
    save_model_weights(pipe.backbone, weights)
    out = {}
    for present in (True, False):
        if not present:
            cfg["dataset"]["kwargs"]["path"] = str(tmp_path / "absent.h5")
        path = tmp_path / f"config_{present}.json"
        path.write_text(json.dumps(cfg))
        out[present] = inference.main([str(path), "-p", str(weights), "-n", "2", "-d", "cpu",
                                       "--work-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "not built" in printed and "its class's parameter space" in printed
    assert out[True].shape == (2, 16, 16, 1) and np.isfinite(out[True]).all()
    np.testing.assert_array_equal(out[True], out[False])
