"""Guided DDPM through the port's sampling entry points, on the CPU.

``DDPM.generate`` with classifier-free guidance against the JAX package's,
with x_T and every step's noise injected into both sides (the two
frameworks draw different random streams), and the inference CLI's
sampling flags: ``--guidance`` over the config's scale, ``--sampler`` and
``--steps`` ignored by DDPM, ``--spacing`` refused by it, and ``--quant
int8`` sampling with the int8 convs and Dense sites (and restoring the mode).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rho_diffusion_tpu.diffusion.sampling_rng as jax_sampling_rng
from chip_smoke import Int8Sites, random_state_dict
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion import ddpm as ddpm_mod
from rho_diffusion_tpu_torch.ops import quant
from test_torch_ddpm import SPACE, pipelines

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


def injected_noise(monkeypatch, table: np.ndarray, generator: torch.Generator):
    """Make both pipelines draw x_T = table[0] and step t's noise
    table[T - t].

    The port draws with ``torch.randn(..., generator=generator)``: x_T,
    then the noise of steps T-1 .. 2 (step 1 adds none). The JAX package
    draws x_T with ``jax.random.normal`` and each step's noise inside its
    ``lax.scan`` with ``normal_like(z_key)``, ``key, z_key = split(key)``.
    Its keys become step counters: ``split(k) = (k + 1, k + 1000)`` from
    rng 0 gives the scan's i-th step (t = T-1-i) z_key 2000 + i, which
    indexes table[1 + i]."""
    port_draws = iter(table)
    real_randn = torch.randn

    def randn(*args, generator=None, **kwargs):
        if generator is not gen_ref:
            return real_randn(*args, generator=generator, **kwargs)
        return torch.from_numpy(next(port_draws).copy())

    gen_ref = generator
    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(jax.random, "split", lambda k: (k + 1, k + 1000))
    monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32:
                        jnp.asarray(table[0], dtype))
    monkeypatch.setattr(jax_sampling_rng, "normal_like", lambda k, shape, dtype=jnp.float32:
                        jnp.asarray(table)[k - 1999].astype(dtype))


@pytest.mark.parametrize("guidance", [2.5, 1.0])
def test_guided_generate_matches_jax_with_injected_noise(monkeypatch, guidance):
    """generate -> p_sample -> the reverse process over 8 steps with
    noise_factor 0.8: conditions from the parameter space (sha512 rows),
    guided when the scale is not 1; fp32 on both sides at the UNet's bar."""
    jpipe, params, tpipe = pipelines(noise_factor=0.8, steps=STEPS)
    shape = tpipe.sample_shape(2)
    table = np.random.default_rng(5).normal(size=(STEPS, *shape)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    kw = dict(batch_size=2, parameter_space=SPACE, random=False, as_hash_embeddings=True,
              guidance_scale=guidance)
    with monkeypatch.context() as m:
        injected_noise(m, table, gen)
        got = tpipe.generate(gen, **kw).numpy()
        want = np.asarray(jpipe.generate(params, jnp.asarray(0, jnp.int32), **kw))
    assert np.abs(want - table[0]).max() > 1e-2, "the model must move the sample"
    assert np.mean((got - want) ** 2) / np.mean(want ** 2) < 1e-9
    np.testing.assert_allclose(got, want, atol=1e-4)
    if guidance != 1.0:  # guidance changes the sample
        with monkeypatch.context() as m:
            injected_noise(m, table, gen)
            plain = tpipe.generate(gen, **{**kw, "guidance_scale": None}).numpy()
        assert np.abs(plain - got).max() > 1e-3


def small_config(tmp_path, **inference_over) -> Path:
    """config_smoke.json with its output cache in tmp_path."""
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["inference"]["cache_file"] = str(tmp_path / "out.h5")
    cfg["inference"]["plot_output_file"] = None
    cfg["inference"].update(inference_over)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def cli(path, tmp_path, *flags):
    return inference.main([str(path), "-d", "cpu", "-n", "2", "-f", "--work-dir", str(tmp_path),
                           *flags])


def test_inference_cli_guidance_flag_overrides_the_config(tmp_path, monkeypatch):
    """--guidance reaches generate over inference.guidance_scale; without
    it the config's scale does; --sampler and --steps leave DDPM as it is."""
    seen = []
    real = ddpm_mod.DDPM.generate

    def generate(self, *args, **kwargs):
        seen.append(kwargs.get("guidance_scale"))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ddpm_mod.DDPM, "generate", generate)
    path = small_config(tmp_path, guidance_scale=2.0)
    base = cli(path, tmp_path)
    flagged = cli(path, tmp_path, "--guidance", "3.0", "--sampler", "ddim", "--steps", "5")
    assert seen == [2.0, 3.0]
    assert base.shape == flagged.shape and np.isfinite(flagged).all()
    assert cli(path, tmp_path, "--guidance", "1.0").shape == base.shape
    assert seen[-1] == 1.0


def test_inference_cli_rejects_spacing_and_quant_for_ddpm(tmp_path):
    path = small_config(tmp_path)
    with pytest.raises(ValueError, match="spacing"):
        cli(path, tmp_path, "--spacing", "trailing")
    with pytest.raises(ValueError, match="spacing"):
        cli(small_config(tmp_path, spacing="karras"), tmp_path)
    with pytest.raises(SystemExit):  # an unknown sampler is an argparse error
        cli(path, tmp_path, "--sampler", "euler")
    with pytest.raises(SystemExit):  # int8 is the one quantization mode
        cli(path, tmp_path, "--quant", "int4")


def test_inference_cli_quant_int8_samples_on_config_smoke(tmp_path):
    """--quant int8 on config_smoke.json (width 64): every conv but the
    input conv and the head, and every Dense site, runs int8; the samples
    are finite, differ from the float ones, and the mode is off again after
    main returns."""
    path = small_config(tmp_path)
    pipe, _, _ = inference.build_inference_session(ExperimentConfig.from_json(path),
                                                   work_dir=tmp_path, device="cpu")
    weights = tmp_path / "seeded.pth"  # nonzero heads, so the int8 convs reach the sample
    torch.save(random_state_dict(pipe.backbone, 1), weights)
    with Int8Sites() as sites:
        got = cli(path, tmp_path, "--quant", "int8", "-p", str(weights))
    counts = sites.kinds()
    assert quant.get_conv_quant() == "off"
    assert np.isfinite(got).all() and got.shape == (2, 8, 8, 8, 1)
    # each of the 19 forwards of a 20-step schedule: the input conv and the
    # head float, the rest int8
    assert counts["conv_float"] == 2 * 19 and counts["conv_int8"] > 10 * 19
    assert counts["dense_int8"] >= 3 * 19 and not counts.get("dense_float")
    assert np.abs(got - cli(path, tmp_path, "-p", str(weights))).max() > 1e-4


def test_quality_config_samples_guided_under_the_port(tmp_path):
    """examples/config_spherical_harmonics_quality.json (DDPM, guidance 2.0)
    reaches guided sampling: its pipeline, widths and guidance, cut to 8^3,
    two levels and 25 steps so it runs on the CPU."""
    cfg = json.loads((ROOT / "examples" / "config_spherical_harmonics_quality.json").read_text())
    assert cfg["pipeline"]["name"] == "DDPM" and cfg["inference"]["guidance_scale"] == 2.0
    cfg["model"]["kwargs"].update(data_shape=[8, 8, 8], channel_mult=[1, 2], num_res_blocks=1,
                                  attention_resolutions=[4])
    cfg["dataset"]["kwargs"].update(grid_el=8, length=4)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = 25  # >= 21 keeps the scaled betas < 1
    cfg["inference"].update(cache_file=str(tmp_path / "q.h5"), plot_output_file=None)
    path = tmp_path / "quality.json"
    path.write_text(json.dumps(cfg))
    out = cli(path, tmp_path)
    assert out.shape[0] == 2 and np.isfinite(out).all()
