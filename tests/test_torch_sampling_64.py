"""The port's DDPM on the 64^3 config against the JAX package's, on the CPU.

``examples/config_spherical_harmonics_64.json`` (UNetv2 with 4 heads,
``MultiEmbeddings`` conditioning over the dataset's parameter space, the
DDPM pipeline) built by each package's own ``build_pipeline_from_config``,
with the same weights carried across by ``export_unet_state_dict``,
``MultiEmbeddings`` labels from the config's parameter space, and x_T and
every step's noise injected into both sides. Cut to run on a CPU: the
config's kwargs at model_channels 16 on a 16^3 grid (its attention at
ds = 8 then sees 16 x 2 x 2 = 64 tokens), fp32, and the schedule the other
DDPM parity tests sample (8 steps, betas 1e-4 to 5e-3 before the 1000/T
scaling).

The config's own betas (1e-3 to 2e-2, times 1000/T) are held step by step
instead. Cut to 21 steps (the fewest that keep every beta below 1) they
reach 0.95, and a free-running sample amplifies whatever the two
frameworks' models differ by on one call. The trace below (``walk`` with
``free``) shows it on the CPU: from the same x_t the two eps agree to
4.8e-12 to 6.3e-12 in relative MSE at every t (fp32 rounding of a deep
conv net in another order), one reverse step from the same x_t, eps and
noise to within 6.5e-12, while the two free-running samples part further
over the steps, to 1.4e-7 after 20 steps (3.7e-8 after 24 at 25 steps). Built at float64, both UNets still compute parts in fp32 (in
the port: the timestep and label embeddings, GroupNorm and the attention
softmax); the per-call gap falls to 1.4e-12 to 2.5e-12 and the samples
part to 2.1e-8. The free-running gap is the per-call gap carried through
the schedule, not a fault that appears at large beta, so the test holds
each step on the port's own trajectory.

Also the inference CLI on the same cut config: its ``inference.sampler``
"ddim" and ``ddim_steps`` do not apply to a DDPM pipeline and are ignored,
as the JAX CLI ignores them.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rho_diffusion_tpu.config import ExperimentConfig as JaxExperimentConfig
from rho_diffusion_tpu.diffusion.ddpm import ddpm_reverse_step as jax_reverse_step
from rho_diffusion_tpu.data.synthetic import SphericalHarmonicDataset as JaxSphericalHarmonics
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build_pipeline
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config
from test_torch_guided_sampling import injected_noise

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "examples" / "config_spherical_harmonics_64.json"
GRID, WIDTH, STEPS = 16, 16, 8
SCHEDULE = dict(num_steps=STEPS, beta_1=1e-4, beta_T=5e-3)


CONFIG_STEPS = 21  # the fewest steps that keep the config's 1000/T-scaled betas below 1


def cut_config(schedule: dict = SCHEDULE) -> dict:
    """The 64^3 config at CPU size, fp32, with ``schedule``'s settings over
    its noise schedule's; every other setting as it is."""
    cfg = json.loads(CONFIG.read_text())
    cfg["model"]["kwargs"].update(model_channels=WIDTH, data_shape=[GRID] * 3)
    cfg["dataset"]["kwargs"]["grid_el"] = GRID
    cfg["noise_schedule"]["kwargs"].update(schedule)
    cfg["training"]["dtype"] = "float32"
    return cfg


def pipelines(schedule: dict = SCHEDULE, float64: bool = False):
    """The JAX and port pipelines of the cut config with the same
    (perturbed, nonzero) weights, conditioning included; with ``float64``
    both UNets are built and weighted at float64 (JAX's under
    ``jax.enable_x64``, which the caller enters)."""
    cfg = cut_config(schedule)
    jcfg = JaxExperimentConfig.model_validate(cfg)
    tcfg = ExperimentConfig.from_dict(json.loads(json.dumps(cfg)))
    if float64:
        jcfg.model.kwargs["dtype"], tcfg.model.kwargs["dtype"] = jnp.float64, torch.float64
    jpipe = jax_build_pipeline(jcfg, dataset=JaxSphericalHarmonics(**jcfg.dataset.kwargs))
    dataset = SphericalHarmonicDataset(**tcfg.dataset.kwargs)
    tpipe = build_pipeline_from_config(tcfg, dataset=dataset, device="cpu")
    params = jpipe.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    sd = export_unet_state_dict(params, **arch_kwargs(cfg["model"]["kwargs"]))
    dtype = torch.float64 if float64 else torch.float32
    tpipe.backbone.to(dtype)
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)).to(dtype) for k, v in sd.items()})
    if float64:
        params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)
    return cfg, jpipe, params, tpipe


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def walk(steps: int, float64: bool = False, free: bool = False) -> list:
    """The reverse process at the config's betas cut to ``steps`` steps,
    x_T and every step's noise from one seeded table, on the port's
    trajectory. Per step t: ``eps`` and ``step``, the relative MSE between
    the JAX model's eps and the JAX reverse step's x_{t-1} and the port's,
    from the same x_t and noise; with ``free``, also ``free``, between the
    JAX package's own trajectory and the port's after the step."""
    cfg, jpipe, params, tpipe = pipelines(dict(num_steps=steps), float64)
    np.testing.assert_array_equal(tpipe.schedule.beta_t.numpy(), np.asarray(jpipe.schedule.beta_t))
    y = tpipe.conditions_from_parameter_space(cfg["inference"]["parameter_space"], 2,
                                              random=False)
    jy = jnp.asarray(y.numpy())
    table = np.random.default_rng(7).normal(size=(steps, *tpipe.sample_shape(2)))
    table = table if float64 else table.astype(np.float32)
    x = torch.from_numpy(table[0])
    xj = jnp.asarray(table[0])
    rows = []
    for i, t in enumerate(range(steps - 1, 0, -1)):
        z = table[1 + i] if t > 1 else np.zeros_like(table[0])
        tt = torch.full((2,), t, dtype=torch.int64)
        jt = jnp.asarray(tt.numpy(), jnp.int32)
        with torch.no_grad():
            eps = tpipe.apply(x, tt, y).to(x.dtype)
        x_next = ddpm_reverse_step(tpipe.schedule, x, eps, tt, torch.from_numpy(z),
                                   noise_factor=tpipe.noise_factor, clip=tpipe.clip_denoised)
        j_eps = jpipe.apply(params, jnp.asarray(x.numpy()), jt, jy).astype(x.numpy().dtype)
        j_next = jax_reverse_step(jpipe.schedule, jnp.asarray(x.numpy()), j_eps, jt,
                                  jnp.asarray(z), noise_factor=jpipe.noise_factor,
                                  clip=jpipe.clip_denoised)
        row = {"t": t, "eps": rel_mse(eps, j_eps), "step": rel_mse(x_next, j_next)}
        if free:
            xj = jax_reverse_step(jpipe.schedule, xj, jpipe.apply(params, xj, jt, jy).astype(xj.dtype),
                                  jt, jnp.asarray(z), noise_factor=jpipe.noise_factor,
                                  clip=jpipe.clip_denoised)
            row["free"] = rel_mse(x_next, xj)
        rows.append(row)
        x = x_next
    return rows


def test_ddpm_on_the_64_config_matches_jax_with_injected_noise(monkeypatch):
    cfg, jpipe, params, tpipe = pipelines()
    assert isinstance(tpipe, DDPM) and tpipe.cond_fn is not None
    assert any(k.startswith("cond_fn.embedding_layers.") for k in tpipe.backbone.state_dict())
    space = cfg["inference"]["parameter_space"]
    kw = dict(batch_size=2, parameter_space=space, random=False, as_hash_embeddings=False)
    rows = tpipe.conditions_from_parameter_space(space, 2, random=False)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(
        jpipe.conditions_from_parameter_space(space, 2, random=False)))
    assert rows.shape == (2, 2)  # raw (l, m) rows: the MultiEmbeddings labels
    shape = tpipe.sample_shape(2)
    assert shape == (2, GRID, GRID, GRID, 1)
    table = np.random.default_rng(7).normal(size=(STEPS, *shape)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    with monkeypatch.context() as m:
        injected_noise(m, table, gen)
        got = tpipe.generate(gen, **kw).numpy()
        want = np.asarray(jpipe.generate(params, jnp.asarray(0, jnp.int32), **kw))
    assert np.abs(want - table[0]).max() > 1e-2, "the model must move the sample"
    assert np.mean((got - want) ** 2) / np.mean(want ** 2) < 1e-9


def test_each_step_at_the_configs_own_betas_matches_jax():
    """The reverse process at the config's betas, cut to 21 steps (beta up
    to 0.95), one step at a time on the port's trajectory: from the same
    x_t, the JAX model's eps and the JAX reverse step (same noise z) agree
    with the port's at every t within the 1e-9 bar."""
    assert cut_config(dict(num_steps=CONFIG_STEPS))["noise_schedule"]["kwargs"]["beta_T"] == 0.02
    rows = walk(CONFIG_STEPS)
    assert [r["t"] for r in rows] == list(range(CONFIG_STEPS - 1, 0, -1))
    for row in rows:
        assert row["eps"] < 1e-9 and row["step"] < 1e-9, row


def test_inference_cli_samples_the_64_config(tmp_path):
    """The CLI on the cut config: a DDPM sample of the config's shape; the
    config's "ddim" sampler and ddim_steps stay in it and are ignored."""
    cfg = cut_config()
    assert cfg["inference"]["sampler"] == "ddim" and cfg["inference"]["ddim_steps"] == 50
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = inference.main([str(path), "-d", "cpu", "-n", "2", "-f", "--work-dir", str(tmp_path)])
    assert out.shape == (2, GRID, GRID, GRID, 1) and np.isfinite(out).all()


if __name__ == "__main__":
    # The trace behind the module docstring's numbers, one line a step:
    #   PYTHONPATH=. python tests/test_torch_sampling_64.py [steps] [--float64]
    import sys

    n = int(next((a for a in sys.argv[1:] if a.isdigit()), CONFIG_STEPS))
    wide = "--float64" in sys.argv
    with jax.enable_x64(wide):
        for r in walk(n, float64=wide, free=True):
            print(json.dumps(r))
