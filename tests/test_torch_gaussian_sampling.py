"""The port's Gaussian sampling end to end against the JAX package's, on the
CPU.

A cut-down UNetv2 (3-D, 8^3, two levels, attention at the second,
learned-range variance, sha512-width conditions) carries the same seeded
weights on both sides (the port's state_dict, transplanted into JAX's
params). ``sample_loop`` over a 20-step schedule respaced to 6:

* 'ddim' at eta 0, 'dpm++' and 'unipc' from a shared x_T;
* 'ddpm', 'ddim' at eta 0.5, 'ancestral' and 'sde-dpm++' with x_T and every
  step's noise injected into both frameworks (they draw different random
  streams), batch-wide and with per-row keys, so the order of the draws and
  the per-row tags (x_T at the respaced count, DDPM/DDIM at the respaced t,
  the solvers at the original timestep) are held too;
* classifier-free guidance, ``t_checkpoints`` and ``progressive``;
* the zero-terminal-SNR checks and the spacing defaults;
* the inference CLI on ``examples/config_learned_variance.json`` (its
  pipeline, schedule and sampler; the UNet cut to 8^3 and the sampler to 4
  respaced steps) against JAX's ``generate`` with the noise injected;
* the service with ``sampler``/``num_steps``/``eta``/``spacing``: a row is
  bitwise the same alone and co-batched; DDPM still refuses ``spacing``.

JAX runs eagerly (``jax.disable_jit``), its UNet call jitted once and
shared through a module-scoped fixture. The bar is relative MSE < 1e-9 in
fp32.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_state_dict
from rho_diffusion_tpu.config import ExperimentConfig as JaxExperimentConfig
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.sampling_rng import per_sample_keys as jax_row_keys
from rho_diffusion_tpu.interop.torch_weights import transplant_unet_state_dict
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.sampling_rng import per_sample_keys
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs
from rho_diffusion_tpu_torch.serve import build_server
from rho_diffusion_tpu_torch.serving import SamplingService

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

KW = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=2, model_channels=16,
          num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
          num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=20, beta_1=1e-4, beta_T=5e-3)  # scaled by 1000/20: 0.005 .. 0.25
TYPES = dict(model_mean_type="epsilon", model_var_type="learned_range")
STEPS = 6
SHAPE = (2, 8, 8, 8, 1)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def jax_params(state_dict: dict, model_kwargs: dict) -> dict:
    """The port's state_dict as JAX params."""
    kw = {k: v for k, v in arch_kwargs(model_kwargs).items() if k != "dims"}
    return transplant_unet_state_dict({k: v.numpy() for k, v in state_dict.items()}, **kw)


def jit_backbone(jpipe) -> None:
    """Compile the JAX pipeline's UNet call once; the sampler around it
    runs eagerly (under ``jax.disable_jit``), so each sampler costs no new
    compile of the network."""
    net = jpipe.backbone

    @jax.jit
    def run(params, x, t, y, mask):
        if mask is None:
            return net.apply({"params": params}, x, t, y, False)
        return net.apply({"params": params}, x, t, y, False, cond_mask=mask)

    def apply(params, x, t, y=None, train=False, cond_mask=None):
        with jax.disable_jit(False):
            return run(params, x, t, y, cond_mask)

    jpipe.apply = apply


@pytest.fixture(scope="module")
def pair():
    """(port pipeline, JAX pipeline, JAX params) with the same weights."""
    tpipe = tg.GaussianDiffusionPipeline("UNetv2", KW, schedule.LinearSchedule(**SCHEDULE),
                                         device="cpu", **TYPES)
    sd = random_state_dict(tpipe.backbone, 0)
    tpipe.load_state_dict(sd)
    jpipe = jg.GaussianDiffusionPipeline("UNetv2", KW, jax_schedule.LinearSchedule(**SCHEDULE),
                                         **TYPES)
    jit_backbone(jpipe)
    return tpipe, jpipe, jax_params(sd, KW)


def conditions(n: int = 2, width: int = 64, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, width)).astype(np.float32)


class Injected:
    """x_T and every step's noise from numpy tables, handed to both
    frameworks.

    Batch-wide, the port draws ``torch.randn(shape, generator=...)``: x_T,
    then one draw per stochastic step. JAX splits ``init, scan = split(rng)``
    and ``key, sub = split(key)`` per step; with ``split(k) = (k + 1,
    k + 1000)`` its keys count: x_T is drawn at a key below 1000 and step i
    at ``first_sub + i`` (2000 from rng 0). Both read ``batch[0]`` for x_T and
    ``batch[1 + i]`` for step i.

    Per row, both ask for each row's stream at a tag (``keys_at_step``);
    here the tag indexes ``rows``, so the two frameworks agree only if they
    draw at the same tags."""

    def __init__(self, monkeypatch, shape, first_sub: int = 2000, seed: int = 5,
                 tags: int = 21, per_row: bool = False):
        rng = np.random.default_rng(seed)
        self.batch = rng.normal(size=(tags + 1, *shape)).astype(np.float32)
        self.rows = rng.normal(size=(tags, *shape)).astype(np.float32)
        self.port_draws = 0
        shape = tuple(shape)
        real_randn = torch.randn
        draws = iter(self.batch)

        def randn(*size, generator=None, **kwargs):
            dims = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
            if generator is None or dims != shape:
                return real_randn(*size, generator=generator, **kwargs)
            self.port_draws += 1
            return torch.from_numpy(next(draws).copy())

        batch, rows = jnp.asarray(self.batch), jnp.asarray(self.rows)

        def batch_index(k):
            return jnp.where(k < 1000, 0, k - first_sub + 1)

        def jax_normal_like(r, shape_, dtype=jnp.float32):
            return (rows[r] if per_row else batch[batch_index(r)]).astype(dtype)

        monkeypatch.setattr(torch, "randn", randn)
        monkeypatch.setattr(tg, "keys_at_step", lambda keys, t: int(t))
        monkeypatch.setattr(tg, "normal_like", lambda tag, shape_, device, dtype=torch.float32:
                            torch.from_numpy(self.rows[tag]).to(dtype))
        monkeypatch.setattr(jax.random, "split", lambda k: (k + 1, k + 1000))
        monkeypatch.setattr(jax.random, "normal", lambda k, shape_, dtype=jnp.float32:
                            batch[batch_index(k)].astype(dtype))
        monkeypatch.setattr(jg, "keys_at_step", lambda keys, t: t)
        monkeypatch.setattr(jg, "normal_like", jax_normal_like)


def run_both(pair, sampler, per_row=False, x_T=None, conds=None, injected=False, **kw):
    tpipe, jpipe, params = pair
    c = conditions() if conds is None else conds
    opts = dict(sampler=sampler, num_steps=STEPS, **kw)
    port_kw = {"row_keys": per_sample_keys(3, SHAPE[0])} if per_row else {
        "generator": torch.Generator().manual_seed(0)}
    got = tpipe.reverse_process(SHAPE, torch.from_numpy(c), x_T=None if x_T is None
                                else torch.from_numpy(x_T), **port_kw, **opts)
    # an injected batch-wide run counts keys from 0 (see Injected)
    rng = (jax_row_keys(3, SHAPE[0]) if per_row else
           jnp.asarray(0, jnp.int32) if injected else jax.random.PRNGKey(0))
    with jax.disable_jit():
        want = jpipe.reverse_process(params, rng, SHAPE, jnp.asarray(c),
                                     x_T=None if x_T is None else jnp.asarray(x_T), **opts)
    return got, want


def assert_close(got, want):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert rel_mse(g, w) < 1e-9
    np.testing.assert_allclose(g, w, atol=1e-4)


X_T = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++", "unipc"])
def test_deterministic_samplers_match_from_shared_x_T(pair, sampler):
    got, want = run_both(pair, sampler, x_T=X_T)
    assert np.abs(np.asarray(want) - X_T).max() > 0.1, "the model must move the sample"
    assert_close(got, want)


@pytest.mark.parametrize("per_row", [False, True], ids=["batch", "per_row"])
@pytest.mark.parametrize("sampler,eta", [("ddpm", 0.0), ("ddim", 0.5), ("ancestral", 0.0),
                                         ("sde-dpm++", 0.0)],
                         ids=["ddpm", "ddim-eta0.5", "ancestral", "sde-dpm++"])
def test_stochastic_samplers_match_with_injected_noise(pair, monkeypatch, sampler, eta, per_row):
    with monkeypatch.context() as m:
        inj = Injected(m, SHAPE, per_row=per_row)
        got, want = run_both(pair, sampler, per_row=per_row, eta=eta, injected=True)
        if not per_row:  # x_T and one draw per step
            assert inj.port_draws == STEPS + 1
    assert_close(got, want)
    # the noise matters: another table gives another sample
    with monkeypatch.context() as m:
        Injected(m, SHAPE, per_row=per_row, seed=6)
        other, _ = run_both(pair, sampler, per_row=per_row, eta=eta, injected=True)
    assert np.abs(other.numpy() - got.numpy()).max() > 1e-3


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_classifier_free_guidance_matches(pair, sampler):
    got, want = run_both(pair, sampler, x_T=X_T, guidance_scale=2.5)
    assert_close(got, want)
    plain, _ = run_both(pair, sampler, x_T=X_T)
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-3


@pytest.mark.parametrize("sampler", ["ddim", "unipc"])
def test_t_checkpoints_and_progressive_match(pair, sampler):
    """Checkpoints are original timesteps snapped to the respaced grid (a
    value off the grid still fills its frame); progressive returns every
    step; the two exclude each other."""
    (got, got_buf), (want, want_buf) = run_both(pair, sampler, x_T=X_T,
                                                t_checkpoints=[0, 7, 19, 12])
    assert got_buf.shape == (4, *SHAPE)
    assert_close(got, want)
    assert_close(got_buf, want_buf)
    assert (got_buf.abs().reshape(4, -1).amax(dim=1) > 0).all()
    np.testing.assert_array_equal(got_buf[0].numpy(), got.numpy())
    (got, frames), (want, want_frames) = run_both(pair, sampler, x_T=X_T, progressive=True)
    assert frames.shape == (STEPS, *SHAPE)
    assert_close(frames, want_frames)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pair[0].reverse_process(SHAPE, sampler=sampler, num_steps=STEPS, progressive=True,
                                t_checkpoints=[3])
    with pytest.raises(ValueError, match="unknown sampler"):
        pair[0].reverse_process(SHAPE, sampler="euler", num_steps=STEPS)


# ---------------------------------------------------------------------------
# Construction and sampling checks
# ---------------------------------------------------------------------------

TINY = dict(dims=1, data_shape=[8], in_channels=1, out_channels=1, model_channels=8,
            num_res_blocks=1, channel_mult=[1], attention_resolutions=[])


def both(sched, **kw):
    """The construction of both packages' pipelines: (port, jax) or the
    errors they raise."""
    out = []
    for cls, mod, extra in ((tg.GaussianDiffusionPipeline, schedule, {"device": "cpu"}),
                            (jg.GaussianDiffusionPipeline, jax_schedule, {})):
        try:
            out.append(cls("UNetv2", TINY, mod.LinearSchedule(**sched), **extra, **kw))
        except ValueError as exc:
            out.append(exc)
    return out


ZTSNR = dict(num_steps=100, zero_terminal_snr=True)


PLAIN = dict(num_steps=100)


@pytest.mark.parametrize("sched,kw", [
    (ZTSNR, dict(model_mean_type="epsilon")),
    (ZTSNR, dict(model_mean_type="v_prediction", loss_weighting="min_snr")),
    (PLAIN, dict(model_mean_type="epsilon", loss_weighting="max_snr")),
    (PLAIN, dict(model_mean_type="previous_x", loss_weighting="min_snr")),
    (PLAIN, dict(model_mean_type="v_prediction", loss_type="kl", loss_weighting="min_snr")),
    (PLAIN, dict(cond_dropout=1.0)),
], ids=["ztsnr-epsilon", "ztsnr-min-snr", "unknown-weighting", "previous-x-min-snr",
        "kl-min-snr", "cond-dropout-1"])
def test_construction_errors_match_jax(sched, kw):
    got, want = both(sched, **kw)
    assert isinstance(want, ValueError) and isinstance(got, ValueError), (got, want)
    assert str(got)[:40] == str(want)[:40]


def test_zero_snr_sampling_checks_and_spacing_defaults(monkeypatch):
    """Solvers and DDIM classifier guidance raise on a zero-terminal-SNR
    schedule; respacing defaults to 'trailing' there, to 'uniform-lambda'
    for the solvers and 'uniform-t' otherwise (the timestep maps each
    package's sample_loop receives are the same)."""
    tz, jz = both(ZTSNR, model_mean_type="v_prediction")
    tn, jn = both(PLAIN)
    for sampler, kw in (("dpm++", {}), ("ddim", {"cond_grad_fn": lambda x, t: x})):
        with pytest.raises(ValueError) as want:
            jz.reverse_process(None, None, (1, 8, 1), sampler=sampler, num_steps=5, **kw)
        with pytest.raises(ValueError) as got:
            tz.reverse_process((1, 8, 1), sampler=sampler, num_steps=5, **kw)
        assert str(got.value) == str(want.value)
    seen = []
    monkeypatch.setattr(tg, "sample_loop", lambda c, *a, **k: seen.append(c.timestep_map.tolist()))
    monkeypatch.setattr(jg, "sample_loop",
                        lambda c, *a, **k: seen.append(np.asarray(c.timestep_map).tolist()))
    for tp, jp, sampler in ((tz, jz, "ddim"), (tn, jn, "dpm++"), (tn, jn, "ddpm"),
                            (tn, jn, "unipc")):
        tp.reverse_process((1, 8, 1), sampler=sampler, num_steps=7)
        jp.reverse_process(None, None, (1, 8, 1), sampler=sampler, num_steps=7)
        assert seen[-2] == seen[-1] and len(seen[-1]) == 7
    assert seen[0][-1] == 99  # trailing anchors at T-1
    assert seen[4] != seen[2]  # uniform-lambda is not uniform-t


def test_training_half_raises():
    """The training half is ported (held against JAX in
    tests/test_torch_gaussian_training.py and tests/test_torch_inpaint_encode.py);
    what still raises is what JAX refuses: inpainting with a multistep
    solver or fewer than one resampling round."""
    pipe, jpipe = both(PLAIN)
    loss, metrics = pipe.loss_and_metrics({"data": torch.zeros(1, 8, 1)},
                                          generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and set(metrics) == {"train_loss", "psnr", "mse"}
    known = np.zeros((1, 8, 1), np.float32)
    for kw in (dict(sampler="dpm++"), dict(sampler="unipc"), dict(resample_steps=0)):
        with pytest.raises(ValueError) as got:
            pipe.inpaint(torch.from_numpy(known), torch.ones(1), num_steps=3, **kw)
        with pytest.raises(ValueError) as want:
            jpipe.inpaint(None, jax.random.PRNGKey(0), jnp.asarray(known), jnp.ones(1),
                          num_steps=3, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The inference CLI on config_learned_variance.json
# ---------------------------------------------------------------------------

CLI_STEPS = 4
# model_channels 32: sha512 rows are at least 128 wide, the time embedding's
# width 4 x model_channels
CLI_CUTS = dict(data_shape=[8, 8, 8], model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                attention_resolutions=[2], num_heads=2)
# the config's model is class-conditional (num_classes 20) but it names no
# inference.parameter_space, so both packages' CLIs would stop at the UNet's
# "class-conditional model requires y"; the flagship's (l, m) grid supplies
# the condition rows (sha512 embeddings, as its dataset's labels are)
LV_SPACE = {"l": [0, 1, 2, 3, 4], "m": [-4, -3, -2, -1, 0, 1, 2, 3, 4]}


def test_inference_cli_learned_variance_matches_jax_generate(tmp_path, monkeypatch):
    """The config's GaussianDiffusion pipeline (epsilon, learned_range, its
    1000-step linear schedule) and sampler ('ddpm'), with --steps 4 (so
    respaced on uniform-t): CLI flags over the config, then generate.
    The UNet is cut to 8^3 and two levels so it runs on the CPU, in fp32; JAX's
    ``generate`` on the same weights and the same injected noise."""
    cfg = json.loads((ROOT / "examples" / "config_learned_variance.json").read_text())
    cfg["model"]["kwargs"].update(CLI_CUTS)
    cfg["dataset"]["kwargs"].update(grid_el=8, length=4)
    cfg["training"]["dtype"] = "float32"  # the parity bar is fp32's (the config: bf16)
    cfg["inference"].update(cache_file=str(tmp_path / "lv.h5"), plot_output_file=None,
                            parameter_space=LV_SPACE)
    path = tmp_path / "lv.json"
    path.write_text(json.dumps(cfg))
    model_kwargs = cfg["model"]["kwargs"]
    n = 2
    shape = (n, 8, 8, 8, 1)
    probe = tg.GaussianDiffusionPipeline("UNetv2", model_kwargs, schedule.LinearSchedule(100),
                                         device="cpu")
    sd = random_state_dict(probe.backbone, 4)
    pth = tmp_path / "lv.pth"
    torch.save(sd, pth)

    jconfig = JaxExperimentConfig.from_json(path)
    jpipe = jax_build(jconfig)
    jit_backbone(jpipe)
    params = jax_params(sd, model_kwargs)
    with monkeypatch.context() as m:
        inj = Injected(m, shape)
        got = inference.main([str(path), "-p", str(pth), "-d", "cpu", "-n", str(n), "-f",
                              "--steps", str(CLI_STEPS), "--work-dir", str(tmp_path)])
        assert inj.port_draws == CLI_STEPS + 1
        with jax.disable_jit():
            want = np.asarray(jpipe.generate(params, jnp.asarray(0, jnp.int32), batch_size=n,
                                             parameter_space=LV_SPACE, as_hash_embeddings=True,
                                             sampler=cfg["inference"]["sampler"],
                                             num_steps=CLI_STEPS))
    assert isinstance(jpipe, jg.GaussianDiffusionPipeline)
    assert jpipe.model_var_type == jg.ModelVarType.LEARNED_RANGE
    assert got.shape == shape and (tmp_path / "lv.h5").exists()
    assert np.abs(want - inj.batch[0]).max() > 0.1, "the model must move the sample"
    assert_close(got, want)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

def test_gaussian_service_rows_alone_and_cobatched_are_bitwise_equal(pair):
    """sampler/num_steps/eta/spacing reach the per-bucket sampler; a row
    alone and co-batched are bitwise equal on the CPU, and equal the
    pipeline's own reverse process with the row's keys."""
    tpipe = pair[0]
    c = conditions(3, seed=7)
    with SamplingService(tpipe, sampler="ddim", num_steps=5, eta=0.5, spacing="trailing",
                         cond_dim=64, batch_buckets=(1, 4), max_delay_s=0.05) as svc:
        stats = svc.stats()
        assert (stats["sampler"], stats["num_steps"], stats["spacing"]) == ("ddim", 5, "trailing")
        alone = svc.generate(c[:1], seed=9).samples
        futures = [svc.submit(c[:1], seed=9), svc.submit(c[1:], seed=10)]
        co = futures[0].result()
        futures[1].result()
    assert co.bucket == 4
    np.testing.assert_array_equal(co.samples, alone)
    direct = tpipe.reverse_process((1, *SHAPE[1:]), torch.from_numpy(c[:1]), sampler="ddim",
                                   num_steps=5, eta=0.5, spacing="trailing",
                                   row_keys=per_sample_keys(9, 1)).numpy()
    np.testing.assert_array_equal(alone, direct)
    other = tpipe.reverse_process((1, *SHAPE[1:]), torch.from_numpy(c[:1]), sampler="ddim",
                                  num_steps=5, eta=0.5, row_keys=per_sample_keys(9, 1)).numpy()
    assert np.abs(other - alone).max() > 1e-4  # the spacing reached the sampler


def lv_config(tmp_path, **inference_over) -> Path:
    cfg = json.loads((ROOT / "examples" / "config_learned_variance.json").read_text())
    cfg["model"]["kwargs"].update(CLI_CUTS)
    cfg["dataset"]["kwargs"].update(grid_el=8, length=4)
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None,
                            parameter_space=LV_SPACE, **inference_over)
    path = tmp_path / "lv.json"
    path.write_text(json.dumps(cfg))
    return path


def test_service_from_config_and_serve_flags(tmp_path):
    """from_config reads inference.sampler/ddim_steps/spacing; the serve
    CLI's --sampler, --steps and --spacing win over them; DDPM still
    refuses a spacing and ignores the sampler and steps."""
    path = lv_config(tmp_path, sampler="dpm++", ddim_steps=3, spacing="karras")
    with SamplingService.from_config(path, log=lambda m: None, device="cpu",
                                     batch_buckets=(1,)) as svc:
        assert (svc.sampler, svc.num_steps, svc.spacing, svc.eta) == ("dpm++", 3, "karras", 0.0)
        assert svc.cond_dim == 128  # hash-embedding rows, 4 x model_channels
        out = svc.generate(conditions(1, width=128), seed=1).samples
        assert out.shape == (1, 8, 8, 8, 1) and np.isfinite(out).all()
    logs: list = []
    server, svc = build_server([str(path), "-d", "cpu", "--port", "0", "--buckets", "1",
                                "--sampler", "ddim", "--steps", "2", "--spacing", "trailing"],
                               log=logs.append)
    server.server_close()
    try:
        assert (svc.sampler, svc.num_steps, svc.spacing) == ("ddim", 2, "trailing")
        assert "sampler=ddim, steps=2" in logs[-1]
    finally:
        svc.close()
    pipe = DDPM("UNetv2", TINY, schedule.LinearSchedule(25), device="cpu")
    with pytest.raises(ValueError, match="spacing"):
        SamplingService(pipe, spacing="trailing")
    with SamplingService(pipe, sampler="dpm++", num_steps=3, batch_buckets=(1,)) as svc:
        out = svc.generate(n=1, seed=0).samples
        np.testing.assert_array_equal(
            out, pipe.reverse_process((1, 8, 1), row_keys=per_sample_keys(0, 1))["denoised"])
