"""The 2-D/1-D quality harnesses' corpora and sampling paths
(``rho_diffusion_tpu_torch/benchmarks/_corpus.py`` and the harnesses' own
pieces) against the JAX package, on the CPU.

* The in-memory corpora: ``GalaxyFrames`` (explicit t values, several
  cameras and mass ratios, ``t_exclude``) and ``RotorSpectra`` (``indices``,
  ``parameter_space``) bitwise equal to the port's datasets on the port
  writer's file and to the JAX package's datasets on the JAX writer's file;
  a held-out frame is the same in the training and the evaluation
  selections.
* The slice as a whole: each harness's config (the port's own edits, at a
  small cut with one attention level) built into a pipeline by each
  package's ``build_pipeline_from_config``; JAX's parameter tree carried in
  by ``export_unet_state_dict`` (conditioner included); x_T and every
  step's noise injected into both (``test_torch_gaussian_sampling.Injected``);
  the port's ``_corpus.draw`` against JAX's ``reverse_process``: the 2-D
  zero-SNR v-prediction trailing DDIM under both conditioners, the 1-D DDPM
  ancestral loop over the 20-step smoke schedule, the 1-D conditional
  epsilon DDIM. Held at relative MSE < 1e-9 and 1e-4 absolute (the sampling
  tests' bar). ``galaxy_dc_probe``'s per-t epsilon MSE on fixed draws
  against the JAX script's arithmetic within 1e-6 relative.
* ``_corpus.ddpm_respaced`` at every timestep is DDPM's own loop, and at
  fewer runs the respaced chain's steps.
"""
import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.config import ExperimentConfig as JaxConfig
from rho_diffusion_tpu.data.deep_galaxy import DeepGalaxyDataset as JaxGalaxy
from rho_diffusion_tpu.data.galaxy_synth import write_deep_galaxy_h5 as jax_write_galaxy
from rho_diffusion_tpu.data.spectro_synth import write_rotor_spectra_h5 as jax_write_spectra
from rho_diffusion_tpu.data.spectroscopy import SpectroscopyDataset as JaxSpectra
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build
from rho_diffusion_tpu_torch.benchmarks import (
    _corpus,
    demo_galaxy2d,
    demo_generalization,
    demo_spectro1d,
    demo_spectro_cond,
    galaxy_dc_probe,
)
from rho_diffusion_tpu_torch.data.deep_galaxy import DeepGalaxyDataset
from rho_diffusion_tpu_torch.data.galaxy_synth import write_deep_galaxy_h5
from rho_diffusion_tpu_torch.data.spectro_synth import write_rotor_spectra_h5
from rho_diffusion_tpu_torch.data.spectroscopy import SpectroscopyDataset
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config
from test_torch_gaussian_sampling import Injected, jit_backbone
from test_torch_quality_harnesses import rel_mse

torch.set_num_threads(1)


def assert_galaxy_items_equal(got, want) -> None:
    assert len(got) == len(want)
    for i in range(len(want)):
        (gx, gy), (wx, wy) = got[i], want[i]
        assert gx.dtype == np.asarray(wx).dtype and gy.dtype == np.asarray(wy).dtype
        np.testing.assert_array_equal(gx, np.asarray(wx))
        np.testing.assert_array_equal(gy, np.asarray(wy))


GALAXY_CASES = {
    "config": (dict(s_values=(0.25, 1.0), m_values=(1.0,), cameras=(0, 1), size=48),
               {"use_emb_as_labels": False, "camera_pos": [0], "t_lim": [400, 520]}),
    "grid-holdout": (dict(s_values=(0.5, 1.0), m_values=(0.5, 1.5), cameras=(0, 1, 3),
                          t_values=[400.0, 405.0, 410.0, 415.0, 420.0], size=32),
                     {"use_emb_as_labels": False, "camera_pos": [0, 3],
                      "t_lim": [400, 420], "t_exclude": [405.0, 415.0]}),
    "pattern": (dict(s_values=(0.25, 0.5), m_values=(1.0, 1.5), cameras=(2,),
                     t_values=[300.0, 350.0, 650.0], size=32),
                {"use_emb_as_labels": False, "dset_name_pattern": "s_0.5_*",
                 "camera_pos": "2"}),
}


@pytest.mark.parametrize("case", list(GALAXY_CASES))
def test_galaxy_frames_are_both_packages_datasets_items(case, tmp_path):
    corpus, kwargs = GALAXY_CASES[case]
    _corpus.clear_cache()
    frames = _corpus.GalaxyFrames(kwargs, **corpus)
    port = DeepGalaxyDataset(**{**kwargs, "path": write_deep_galaxy_h5(
        str(tmp_path / "port.h5"), **corpus)})
    jax_ds = JaxGalaxy(**{**kwargs, "path": jax_write_galaxy(str(tmp_path / "jax.h5"),
                                                             **corpus)})
    assert_galaxy_items_equal(frames, port)
    assert_galaxy_items_equal(frames, jax_ds)
    assert frames.parameter_space is DeepGalaxyDataset.parameter_space
    assert frames.loaded_parameter_space.parameters == port.loaded_parameter_space.parameters
    # rendered once: a second selection reuses the stacks
    again = _corpus.GalaxyFrames(kwargs, **corpus)
    assert all(a[0] is b[0] for a, b in zip(again.stacks, frames.stacks))


def test_held_out_frames_are_the_evaluation_sets_frames():
    """``t_exclude`` drops frames after the per-stack normalisation, so each
    kept frame equals the same row of a selection without it."""
    corpus, kwargs = GALAXY_CASES["grid-holdout"]
    held = _corpus.GalaxyFrames(kwargs, **corpus)
    full = _corpus.GalaxyFrames({k: v for k, v in kwargs.items() if k != "t_exclude"}, **corpus)
    rows = {tuple(full[i][1]): i for i in range(len(full))}
    assert len(held) == len(full) * 3 // 5
    for i in range(len(held)):
        np.testing.assert_array_equal(held[i][0], full[rows[tuple(held[i][1])]][0])


@pytest.mark.parametrize("indices", [None, [0, 3, 4]])
def test_rotor_spectra_are_both_packages_datasets_items(indices, tmp_path):
    kwargs = {"grid_size": 512, "linewidth": 80.0, **({"indices": indices} if indices else {})}
    spectra = _corpus.RotorSpectra(kwargs, n_molecules=6, seed=3)
    port = SpectroscopyDataset(**{**kwargs, "h5_path": write_rotor_spectra_h5(
        str(tmp_path / "p.h5"), 6, seed=3)})
    jax_ds = JaxSpectra(**{**kwargs, "h5_path": jax_write_spectra(str(tmp_path / "j.h5"), 6,
                                                                  seed=3)})
    assert len(spectra) == len(port) == len(jax_ds) == (len(indices) if indices else 6)
    for i in range(len(port)):
        got, a, b = spectra[i], port[i], jax_ds[i]
        assert set(got) == set(a) == set(b)
        for k in got:
            np.testing.assert_array_equal(got[k], a[k])
            np.testing.assert_array_equal(got[k], np.asarray(b[k]))
    assert spectra.parameter_space.parameters == port.parameter_space.parameters == \
        jax_ds.parameter_space.parameters


def test_route_follows_h5py(monkeypatch):
    assert _corpus.route() == "hdf5"  # h5py is installed here
    monkeypatch.setattr(_corpus.importlib.util, "find_spec",
                        lambda name: None if name == "h5py" else importlib.util.find_spec(name))
    assert _corpus.route() == "memory"


# ---------------------------------------------------------------------------
# The slice as a whole

SMALL_2D = dict(data_shape=[32, 32], attention_resolutions=[8], num_heads=1)
SMALL_1D = dict(data_shape=[64], attention_resolutions=[8], num_heads=1)


def pipelines(cfg, dataset, seed: int = 11):
    """(port pipeline, JAX pipeline, JAX params) from one port config, JAX's
    tree (perturbed, so the zero-initialised output convs act) carried in."""
    jcfg = JaxConfig.model_validate(json.loads(json.dumps(cfg.to_dict())))
    jcfg.model.kwargs["dtype"] = jnp.float32
    jpipe = jax_build(jcfg, dataset=dataset)
    params = jpipe.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    jit_backbone(jpipe)
    tcfg = copy.deepcopy(cfg)
    tcfg.model.kwargs["dtype"] = "float32"
    tpipe = build_pipeline_from_config(tcfg, dataset=dataset, device="cpu")
    sd = export_unet_state_dict(params, **arch_kwargs(cfg.model.kwargs))
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return tpipe, jpipe, params


def hold(got, want, x_T) -> None:
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want - x_T).max() > 0.1, "the model must move the sample"
    assert rel_mse(got, want) < 1e-9, rel_mse(got, want)
    np.testing.assert_allclose(got, want, atol=1e-4)


def run_both(monkeypatch, pair, shape, conds, sampler: str, steps: int, ddpm: bool = False):
    tpipe, jpipe, params = pair
    with monkeypatch.context() as m:
        inj = Injected(m, shape)
        got = _corpus.draw(
            tpipe, shape[0], None if conds is None else torch.from_numpy(conds),
            torch.Generator().manual_seed(0), sampler, steps).numpy()
        jc = None if conds is None else jnp.asarray(conds)
        with jax.disable_jit():
            want = (jpipe.reverse_process(params, jnp.asarray(0, jnp.int32), shape, jc)
                    ["denoised"] if ddpm else
                    jpipe.reverse_process(params, jnp.asarray(0, jnp.int32), shape, jc,
                                          sampler=sampler, num_steps=steps))
    return got, np.asarray(want), inj


def galaxy_rows(n: int) -> np.ndarray:
    space = DeepGalaxyDataset.parameter_space
    rng = np.random.default_rng(5)
    return np.stack([[rng.choice(space[k]) for k in "smtc"] for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("cond", ["fourier", "embed"])
def test_galaxy_zero_snr_trailing_ddim_matches_jax(cond, monkeypatch):
    """demo_galaxy2d's zero_snr recipe (and demo_generalization's config with
    its conditioner) sampled as the harnesses sample, against JAX."""
    monkeypatch.setenv("GEN_COND", cond)
    monkeypatch.setenv("GEN_SMOKE", "1")
    cfg = demo_generalization.config(demo_generalization.settings())
    cfg.model.kwargs.update(SMALL_2D)
    holder = type("D", (), {"parameter_space": DeepGalaxyDataset.parameter_space})()
    pair = pipelines(cfg, holder)
    assert type(pair[0].cond_fn).__name__ == demo_generalization.CONDITIONERS[cond]
    assert pair[0].model_mean_type.name == "VELOCITY"
    shape = (3, 32, 32, 1)
    got, want, inj = run_both(monkeypatch, pair, shape, galaxy_rows(3), "ddim", 5)
    hold(got, want, inj.batch[0])
    # demo_galaxy2d's own zero_snr config builds the same pipeline type
    monkeypatch.setenv("DEMO_SMOKE", "1")
    g2d = demo_galaxy2d.config(demo_galaxy2d.settings())
    assert g2d.pipeline.kwargs == cfg.pipeline.kwargs
    assert g2d.noise_schedule.kwargs == cfg.noise_schedule.kwargs


def test_spectro_ddpm_ancestral_matches_jax(monkeypatch):
    """demo_spectro1d's reference recipe: DDPM's full-T ancestral loop over
    the 20-step smoke schedule."""
    monkeypatch.setenv("DEMO_SMOKE", "1")
    cfg = demo_spectro1d.config(demo_spectro1d.settings())
    cfg.model.kwargs.update(SMALL_1D)
    cfg.dataset.kwargs["grid_size"] = 64
    pair = pipelines(cfg, None)
    t = len(pair[0].schedule)
    assert t == 20 and type(pair[0]).__name__ == "DDPM"
    shape = (4, 64, 1)
    got, want, inj = run_both(monkeypatch, pair, shape, None, "ancestral", t, ddpm=True)
    assert inj.port_draws == 1 + t - 2  # x_T, then a draw a step but the last two
    hold(got, want, inj.batch[0])


@pytest.mark.parametrize("cond", ["fourier", "embed"])
def test_spectro_conditional_epsilon_ddim_matches_jax(cond, monkeypatch, tmp_path):
    monkeypatch.setenv("SPECTRO_COND", cond)
    monkeypatch.setenv("SPECTRO_SMOKE", "1")
    s = demo_spectro_cond.settings()
    cfg = demo_spectro_cond.config(s)
    cfg.model.kwargs.update(SMALL_1D)
    spectra = _corpus.RotorSpectra({"grid_size": 64}, n_molecules=s["molecules"], seed=0)
    pair = pipelines(cfg, spectra)
    assert pair[0].model_mean_type.name == "EPSILON"
    labels = np.stack([spectra[i]["params"] for i in (1, 5, 9)])
    got, want, inj = run_both(monkeypatch, pair, (3, 64, 1), labels, "ddim", 6)
    hold(got, want, inj.batch[0])


def test_dc_probe_eps_mse_matches_the_jax_scripts_arithmetic():
    cfg = demo_galaxy2d.config({**demo_galaxy2d.settings(), "recipe": "reference",
                                "smoke": True})
    mk = {**cfg.model.kwargs, **SMALL_2D}
    space_holder = type("D", (), {"parameter_space": DeepGalaxyDataset.parameter_space})()
    tpipe = galaxy_dc_probe.probe_pipeline(mk, space_holder, "cpu", dtype="float32")
    from rho_diffusion_tpu.diffusion import GaussianDiffusionPipeline, LinearSchedule

    jmk = {k: v for k, v in mk.items() if k != "cond_fn"}
    jmk["dtype"] = jnp.float32
    jpipe = GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=jmk, schedule=LinearSchedule(500),
        model_mean_type="epsilon", model_var_type="fixed_small", optimizer="AdamW",
        cond_fn="MultiEmbeddings",
        cond_fn_kwargs={"parameter_space": DeepGalaxyDataset.parameter_space,
                        "embedding_dim": 4 * mk["model_channels"]})
    params = jpipe.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    sd = export_unet_state_dict(params, **arch_kwargs(mk))
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    x0 = rng.uniform(-1, -0.5, size=(3, 32, 32, 1)).astype(np.float32)
    labels = galaxy_rows(3)
    draws = {t: rng.normal(size=x0.shape).astype(np.float32) for t in galaxy_dc_probe.PROBE_T}
    got = galaxy_dc_probe.probe(tpipe, torch.from_numpy(x0), torch.from_numpy(labels),
                                noise=lambda t, shape, device: torch.from_numpy(draws[t]))
    # the JAX script's loop (galaxy_dc_probe.py:79-90) on the same draws
    abar = np.asarray(jpipe.coeffs.alphas_cumprod, np.float64)
    mf = jpipe._model_fn(params, jnp.asarray(labels))
    for t in galaxy_dc_probe.PROBE_T:
        ab = abar[t]
        eps = jnp.asarray(draws[t])
        x_t = np.sqrt(ab) * jnp.asarray(x0) + np.sqrt(1 - ab) * eps
        eps_hat = mf(x_t, jnp.full((3,), t, jnp.int32)).astype(jnp.float32)
        err = float(jnp.mean((eps_hat - eps) ** 2))
        x0err = float(jnp.mean(((x_t - np.sqrt(1 - ab) * eps_hat) / np.sqrt(ab) - x0) ** 2))
        row = got[str(t)]
        assert row["abar"] == ab
        np.testing.assert_allclose(row["eps_mse"], err, rtol=1e-6)
        np.testing.assert_allclose(row["x0_mse"], x0err, rtol=1e-5)


def test_ddpm_respaced_is_ddpms_loop_at_every_timestep():
    cfg = demo_spectro1d.config({**demo_spectro1d.settings(), "smoke": True, "grid": 64,
                                 "recipe": "reference"})
    cfg.training.dtype = "float32"
    pipe = build_pipeline_from_config(cfg, device="cpu")
    shape = (2, 64, 1)
    full = pipe.reverse_process(shape, None, generator=torch.Generator().manual_seed(4))
    got = _corpus.ddpm_respaced(pipe, shape, None, torch.Generator().manual_seed(4), 20)
    np.testing.assert_allclose(got.numpy(), full["denoised"].numpy(), atol=1e-5)
    assert torch.equal(_corpus.draw(pipe, 2, None, torch.Generator().manual_seed(4),
                                    "ancestral", 20), full["denoised"])
    # capped: the respaced chain, one model call a step but the first
    calls = []
    real_apply = pipe.apply
    pipe.apply = lambda x, t, y=None: calls.append(int(t[0])) or real_apply(x, t, y)
    capped = _corpus.draw(pipe, 2, None, torch.Generator().manual_seed(4), "ancestral", 5)
    assert calls == [16, 12, 8, 4] and torch.isfinite(capped).all()
    assert _corpus.sampler_name(pipe, "ddim", 5) == "ddpm-5"


RENDER_CHILD = r"""
import numpy as np
from rho_diffusion_tpu_torch.benchmarks import _corpus
jobs = [(0.5, 1.0, 1, 400.0), (1.0, 1.5, 3, 455.0), (0.25, 0.5, 0, 650.0)]
here = _corpus.render_frames(jobs, 24)
_corpus.PROCESS_PIXELS, _corpus.RENDER_WORKERS = 1, 2
forked = _corpus.render_frames(jobs, 24)
assert len(here) == len(forked) == 3
assert all(np.array_equal(a, b) for a, b in zip(here, forked))
print("same")
"""


def test_worker_processes_render_the_same_frames():
    """A corpus past ``PROCESS_PIXELS`` renders in forked processes, frame
    for frame the in-process render (in a child interpreter: this one has
    JAX's threads, which a fork must not copy)."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", RENDER_CHILD], capture_output=True, text=True,
                       timeout=300, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)))
    assert r.returncode == 0 and r.stdout.split() == ["same"], r.stderr[-2000:]
