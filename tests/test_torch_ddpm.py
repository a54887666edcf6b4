"""The port's DDPM sampling path against the JAX package's, on the CPU.

Schedules, hash embeddings, the reverse step and a whole reverse process of
a cut-down flagship (3-D UNetv2 with sha512 conditions) from a shared x_T
with noise_factor=0, plus the config reader over every example config.
Noise and x_T are made with numpy and handed to both sides.
"""
import glob
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu import utils as jax_utils
from rho_diffusion_tpu.config import ExperimentConfig as JaxExperimentConfig
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu.diffusion.ddpm import ddpm_reverse_step as jax_reverse_step
from rho_diffusion_tpu.diffusion.ddpm import q_sample as jax_q_sample
from rho_diffusion_tpu_torch import utils
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step, q_sample
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

SCHEDULES = {
    "linear-1000": ("LinearSchedule", (1000, 1e-3, 0.02), {}),
    "linear-50": ("LinearSchedule", (50,), {}),
    "linear-ztsnr": ("LinearSchedule", (100,), {"zero_terminal_snr": True}),
    "cosine": ("CosineBetaSchedule", (100,), {}),
    "cosine-exact": ("CosineBetaSchedule", (100,), {"exact_reference": True}),
    "sigmoid": ("SigmoidSchedule", (100,), {}),
}
TABLES = ("beta_t", "alpha_t", "alpha_bar_t", "sigma_t", "offset_alpha_bar_t")


def assert_tables_equal(got, want):
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_tables_match_exactly(case):
    name, args, kwargs = SCHEDULES[case]
    assert_tables_equal(getattr(schedule, name)(*args, **kwargs),
                        getattr(jax_schedule, name)(*args, **kwargs))


@pytest.mark.parametrize("name", ["linear", "scaled_linear", "sigmoid", "cosine"])
def test_named_beta_schedules_match_exactly(name):
    assert_tables_equal(schedule.named_beta_schedule(name, 200),
                        jax_schedule.named_beta_schedule(name, 200))


def test_schedule_rejects_betas_above_one():
    with pytest.raises(ValueError, match="betas"):
        schedule.LinearSchedule(10)


@pytest.mark.parametrize("length", [128, 256, 512])
def test_sha512_embeddings_bit_exact(length):
    for d in ({"l": 0, "m": 0}, {"m": -3, "l": 4}, {"z": 0.25, "a": "x"}):
        got = utils.calculate_sha512_embedding(d, l=length)
        want = jax_utils.calculate_sha512_embedding(d, l=length)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    space = {"l": [0, 1, 2, 3, 4], "m": [-4, -3, -2, -1, 0, 1, 2, 3, 4]}
    np.testing.assert_array_equal(utils.parameter_space_to_embeddings(space, l=length),
                                  jax_utils.parameter_space_to_embeddings(space, l=length))


def test_parameter_space_sampling_matches():
    space = {"a": [0.5, 1.0, 2.0], "b": [1, 2]}
    for random in (False, True):
        got = utils.sample_from_discrete_parameter_space(
            space, 9, random=random, rng=np.random.default_rng(3))
        want = jax_utils.sample_from_discrete_parameter_space(
            space, 9, random=random, rng=np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
    cfg = {"lr": "1e-4", "n": "32", "nested": {"x": ["2", "b"]}}
    assert utils.number_cast_dict(cfg) == jax_utils.number_cast_dict(cfg)


def test_q_sample_and_reverse_step_match_jax():
    sch_t, sch_j = schedule.LinearSchedule(1000), jax_schedule.LinearSchedule(1000)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(4, 3, 5, 1)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    z = rng.normal(size=x.shape).astype(np.float32)
    tt = np.array([999, 500, 1, 0], np.int64)
    got = q_sample(sch_t, torch.from_numpy(x), torch.from_numpy(tt), torch.from_numpy(eps))
    want = jax_q_sample(sch_j, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for clip in (True, False):
        got = ddpm_reverse_step(sch_t, torch.from_numpy(x), torch.from_numpy(eps),
                                torch.from_numpy(tt), torch.from_numpy(z), clip=clip)
        want = jax_reverse_step(sch_j, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(tt),
                                jnp.asarray(z), clip=clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


SMALL_FLAGSHIP = dict(
    dims=3, data_shape=[4, 8, 8], in_channels=1, out_channels=1, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
    num_classes=20, use_scale_shift_norm=True,
)
SPACE = {"l": [0, 1, 2], "m": [-1, 0, 1]}


def pipelines(noise_factor=0.0, steps=8):
    """The JAX and port DDPMs of a cut-down flagship with the same
    (perturbed, nonzero) weights."""
    kw = dict(SMALL_FLAGSHIP)
    sch = dict(num_steps=steps, beta_1=1e-4, beta_T=5e-3)
    jpipe = JaxDDPM("UNetv2", kw, jax_schedule.LinearSchedule(**sch), noise_factor=noise_factor)
    params = jpipe.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    tpipe = DDPM("UNetv2", kw, schedule.LinearSchedule(**sch), noise_factor=noise_factor,
                 device="cpu")
    sd = export_unet_state_dict(params, **arch_kwargs(kw))
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return jpipe, params, tpipe


def test_conditions_from_parameter_space_match():
    jpipe, _, tpipe = pipelines()
    for hash_emb in (True, False):
        for random in (False, True):
            kw = dict(random=random, as_hash_embeddings=hash_emb,
                      embedding_dim=tpipe.condition_embedding_dim())
            got = tpipe.conditions_from_parameter_space(SPACE, 5, **kw).numpy()
            want = np.asarray(jpipe.conditions_from_parameter_space(SPACE, 5, **kw))
            np.testing.assert_array_equal(got, want)
    assert tpipe.sample_shape(3) == jpipe.sample_shape(3) == (3, 4, 8, 8, 1)


def test_reverse_process_matches_jax_from_shared_x_T():
    """The whole slice: sha512 conditions -> 3-D UNet (plain conv3d and
    attention on the CPU) -> 8 DDPM steps with the clamp, noise_factor=0 so
    the two frameworks' noise streams drop out; frame buffer included."""
    jpipe, params, tpipe = pipelines()
    cond = tpipe.conditions_from_parameter_space(
        SPACE, 2, random=False, as_hash_embeddings=True,
        embedding_dim=tpipe.condition_embedding_dim())
    x_T = np.random.default_rng(1).normal(size=(2, 4, 8, 8, 1)).astype(np.float32)
    shape = x_T.shape
    want = jax.jit(lambda p, c, x: jpipe.reverse_process(
        p, jax.random.PRNGKey(0), shape, c, t_checkpoints=[0, 1, 2], x_T=x))(
        params, jnp.asarray(cond.numpy()), jnp.asarray(x_T))
    got = tpipe.reverse_process(shape, cond, t_checkpoints=[0, 1, 2], x_T=torch.from_numpy(x_T))
    w = np.asarray(want["denoised"])
    assert np.abs(w - x_T).max() > 1e-2, "the model must move the sample"
    # fp32 on both sides: the UNet bar (relative MSE < 1e-9) on the final
    # field and the frames; each step scales the model's rounding by up to
    # beta_t / sqrt(alpha_t (1 - abar_t)) ~ 1.6 at this 8-step schedule, so
    # single elements may drift to ~1e-5: atol 1e-4
    for g, ww in ((got["denoised"].numpy(), w),
                  (got["buffer"].numpy(), np.asarray(want["buffer"]))):
        assert np.mean((g - ww) ** 2) / np.mean(ww ** 2) < 1e-9
        np.testing.assert_allclose(g, ww, atol=1e-4)


def test_ddpm_rejects_zero_terminal_snr():
    with pytest.raises(ValueError, match="zero-terminal-SNR"):
        DDPM("UNetv2", SMALL_FLAGSHIP, schedule.LinearSchedule(100, zero_terminal_snr=True),
             device="cpu")


def _jsonable(v):
    return json.loads(json.dumps(v, default=str))


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "examples" / "*.json"))),
                         ids=lambda p: Path(p).stem)
def test_config_reads_examples_like_jax(path):
    got = ExperimentConfig.from_json(path).to_dict()
    want = JaxExperimentConfig.from_json(path).model_dump()
    assert got["experiment"] == want["experiment"]
    for section in ("model", "dataset", "noise_schedule", "optimizer", "lr_scheduler", "pipeline"):
        assert _jsonable(got[section]) == _jsonable(want[section]), section
    for section in ("training", "inference"):
        assert set(got[section]) == set(want[section]), section
        assert _jsonable(got[section]) == _jsonable(want[section]), section
