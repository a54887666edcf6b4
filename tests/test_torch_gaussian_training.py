"""GaussianDiffusion's training half in the port against the JAX package's,
on the CPU.

* The VLB pieces (``normal_kl``, ``approx_standard_normal_cdf``,
  ``discretized_gaussian_log_likelihood``, the edge bins included) on the
  same numpy arrays.
* ``vb_terms_bpd`` for every mean type x variance type at t = 0 (the
  decoder NLL), 1, 10 and 19, from a fixed model output, with clipping off
  (the default) and on.
* ``training_losses`` for every mean type x {fixed_small, fixed_large,
  learned, learned_range} x {mse, rescaled_mse, kl, rescaled_kl} through a
  small 3-D UNet (width 8, 8^3, attention, class-conditional, seeded weights
  carried to JAX by ``transplant_unet_state_dict``), with min-SNR weights,
  and on a zero-terminal-SNR table with v and x0 prediction.
* ``GaussianDiffusionPipeline.loss_and_metrics`` with the timesteps, the
  noise and the conditioning mask handed to both (JAX's draws patched), and
  the hybrid loss's parameter gradients against ``jax.grad`` (relative L2
  over all gradients <= 1e-5); the ``vb`` term alone moves only the
  variance half of the output.
* ``calc_bpd_loop`` (every step's noise injected into both) and
  ``prior_bpd``.

Per-sample losses and bits per dimension are held at rtol 1e-5, atol 1e-6,
in fp32. The schedule is the 20-step linear one of the sampling tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_state_dict
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.interop.torch_weights import transplant_unet_state_dict
from rho_diffusion_tpu.metrics import losses as jl
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.metrics import losses as tl

torch.set_num_threads(1)

KW = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=2, model_channels=8,
          num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
          num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=20, beta_1=1e-4, beta_T=5e-3)
ZTSNR = dict(num_steps=20, zero_terminal_snr=True)
SHAPE = (4, 8, 8, 8, 1)
T_INJ = np.array([0, 1, 10, 19])
# the pipeline calls its UNet itself, whose random weights put t = 0's
# decoder bins deep in the tails (see model_fns): t = 0 is held on the
# functional path
T_PIPE = np.array([1, 5, 10, 19])
RTOL, ATOL = 1e-5, 1e-6
MEANS = ["previous_x", "start_x", "epsilon", "v_prediction"]
VARS = ["fixed_small", "fixed_large", "learned", "learned_range"]
LOSSES = ["mse", "rescaled_mse", "kl", "rescaled_kl"]


def learned(var: str) -> bool:
    return var in ("learned", "learned_range")


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def jax_params(state_dict: dict, model_kwargs: dict) -> dict:
    kw = {k: v for k, v in arch_kwargs(model_kwargs).items() if k != "dims"}
    return transplant_unet_state_dict({k: v.numpy() for k, v in state_dict.items()}, **kw)


def jit_backbone(jpipe) -> None:
    """The JAX pipeline's UNet call compiled once; the loss math around it
    runs op by op."""
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


def make_pair(out_channels: int, sched=SCHEDULE, **kwargs):
    """(port pipeline, JAX pipeline, JAX params) with the same weights."""
    kw = {**KW, "out_channels": out_channels}
    tpipe = tg.GaussianDiffusionPipeline("UNetv2", kw, schedule.LinearSchedule(**sched),
                                         device="cpu", **kwargs)
    sd = random_state_dict(tpipe.backbone, out_channels)
    tpipe.load_state_dict(sd)
    jpipe = jg.GaussianDiffusionPipeline("UNetv2", kw, jax_schedule.LinearSchedule(**sched),
                                         **kwargs)
    jit_backbone(jpipe)
    return tpipe, jpipe, jax_params(sd, kw)


@pytest.fixture(scope="module")
def nets():
    """The UNets by output channels (1: fixed variance, 2: learned)."""
    return {c: make_pair(c) for c in (1, 2)}


def inputs(seed: int = 0, n: int = SHAPE[0]):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, size=(n, *SHAPE[1:])).astype(np.float32)
    x0[0, 0, 0, :2, 0] = (-1.0, 1.0)  # the decoder's edge bins
    noise = rng.normal(size=(n, *SHAPE[1:])).astype(np.float32)
    y = rng.normal(size=(n, 4 * KW["model_channels"])).astype(np.float32)
    return x0, noise, y


def model_fns(pair, y, x0=None, mean=None, coeffs=None):
    """The UNet's call in each framework. Given the clean batch ``x0`` and
    a mean type, the mean half of the output becomes that mean type's true
    target at (x_t, t) plus 0.05 times the UNet's (the variance half stays
    the UNet's): a model this far from the truth keeps the t = 0 decoder's
    bins out of its Gaussian's tails, where the log of a difference of two
    fp32 CDFs differs between any two implementations, as a random-weight
    UNet's would not."""
    tpipe, jpipe, params = pair
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    c = coeffs or tpipe.coeffs
    tabs = {k: getattr(c, k).numpy() for k in ("alphas_cumprod", "posterior_mean_coef1",
                                               "posterior_mean_coef2")}

    def near(xp, out, x, t):
        if x0 is None:
            return out
        ch = x.shape[-1]

        def at(name):
            return xp.asarray(tabs[name])[t].reshape(-1, *(1,) * (x.ndim - 1))

        a, x0_ = at("alphas_cumprod"), xp.asarray(x0)
        eps = (x - xp.sqrt(a) * x0_) / xp.sqrt(1.0 - a)
        target = {"epsilon": eps, "start_x": x0_,
                  "v_prediction": xp.sqrt(a) * eps - xp.sqrt(1.0 - a) * x0_,
                  "previous_x": at("posterior_mean_coef1") * x0_
                  + at("posterior_mean_coef2") * x}[mean]
        return xp.concatenate([target + 0.05 * out[..., :ch], out[..., ch:]], -1)

    def port(x, t):
        return near(torch, tpipe.backbone(x, t, yt).to(x.dtype), x, t)

    def jax_fn(x, t):
        return near(jnp, jpipe.apply(params, x, t, yj), x, t)

    return port, jax_fn


# ---------------------------------------------------------------------------
# The VLB pieces
# ---------------------------------------------------------------------------

def test_vlb_pieces_match_jax():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.normal(size=(3, 64)).astype(np.float32) for _ in range(4))
    t = [torch.from_numpy(v) for v in (a, b, c, d)]
    close(tl.normal_kl(*t), jl.normal_kl(a, b, c, d), what="normal_kl")
    close(tl.normal_kl(t[0], t[1], 0.0, 0.0), jl.normal_kl(a, b, 0.0, 0.0), what="against N(0,1)")
    z = np.linspace(-6, 6, 97).astype(np.float32)
    close(tl.approx_standard_normal_cdf(torch.from_numpy(z)), jl.approx_standard_normal_cdf(z),
          what="cdf")
    # x on the 1/127.5 grid of [-1, 1], both edge bins included, scales
    # from narrow (a bin's width) to wide, means within two scales of x (a
    # bin far out in a narrow Gaussian's tail is a difference of two CDFs
    # within rounding of each other: ill-conditioned in fp32 in either
    # framework)
    x = (np.round(rng.uniform(-1, 1, size=(4, 256)) * 127.5) / 127.5).astype(np.float32)
    x[:, :2] = (-1.0, 1.0)
    scales = np.geomspace(3e-3, 1.0, 256)[None].repeat(4, 0)
    means = (x + scales * np.clip(rng.normal(size=x.shape), -2, 2)).astype(np.float32)
    log_scales = np.log(scales).astype(np.float32)
    got = tl.discretized_gaussian_log_likelihood(*map(torch.from_numpy, (x, means, log_scales)))
    want = np.asarray(jl.discretized_gaussian_log_likelihood(x, means, log_scales))
    # log(cdf(+) - cdf(-)) of two fp32 CDFs: a few units of roundoff u of
    # each CDF (the frameworks' tanh differ in the last bits) become
    # u / delta in the log, delta the bin's mass (float64 here)
    delta = np.exp(np.asarray(jl.discretized_gaussian_log_likelihood(
        x.astype(np.float64), means.astype(np.float64), log_scales.astype(np.float64))))
    err = np.abs(got.numpy() - want)
    assert (err <= RTOL * np.abs(want) + 8 * 2.0 ** -24 / delta).all(), float(err.max())
    # a far-off mean reaches the 1e-12 floors of every branch
    far = tl.discretized_gaussian_log_likelihood(
        torch.tensor([-1.0, 0.0, 1.0]), torch.tensor([5.0, 5.0, -5.0]), torch.tensor([-5.0] * 3))
    close(far, jl.discretized_gaussian_log_likelihood(
        np.float32([-1, 0, 1]), np.float32([5, 5, -5]), np.float32([-5] * 3)), what="floors")
    np.testing.assert_allclose(far.numpy(), np.log(1e-12), rtol=1e-6)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("mean", MEANS)
def test_vb_terms_bpd_matches_jax(mean, var, clip):
    """From a fixed model output, at t = 0 (the decoder NLL), 1, 10 and 19:
    the mean half is the true target of the mean type plus N(0, 0.02^2)
    (a model far off would put the decoder's bins deep in its tails, where
    a log of a difference of two CDFs is ill-conditioned in fp32), the
    variance half uniform in [-1, 1]."""
    tc = tg.coefficients_from_schedule(schedule.LinearSchedule(**SCHEDULE))
    jc = jg.coefficients_from_schedule(jax_schedule.LinearSchedule(**SCHEDULE))
    x0, noise, _ = inputs(2)
    rng = np.random.default_rng(3)
    t = torch.from_numpy(T_INJ)
    x0_t, noise_t = torch.from_numpy(x0), torch.from_numpy(noise)
    x_t = tg.q_sample(tc, x0_t, t, noise_t)
    target = {"epsilon": noise_t, "start_x": x0_t,
              "v_prediction": tg.velocity_target(tc, x0_t, t, noise_t),
              "previous_x": tg.q_posterior_mean_variance(tc, x0_t, x_t, t)[0]}[mean].numpy()
    out = (target + 0.02 * rng.normal(size=target.shape)).astype(np.float32)
    if learned(var):
        out = np.concatenate([out, rng.uniform(-1, 1, size=out.shape).astype(np.float32)], -1)
    got = tg.vb_terms_bpd(tc, lambda *_: torch.from_numpy(out), x0_t, x_t, t,
                          tg.ModelMeanType(mean), tg.ModelVarType(var), clip_denoised=clip)
    want = jg.vb_terms_bpd(jc, lambda *_: jnp.asarray(out), jnp.asarray(x0),
                           jnp.asarray(x_t.numpy()), jnp.asarray(T_INJ, jnp.int32),
                           jg.ModelMeanType(mean), jg.ModelVarType(var), clip_denoised=clip)
    close(got["output"], want["output"], what="output")
    close(got["pred_xstart"], want["pred_xstart"], rtol=1e-5, atol=1e-5, what="pred_xstart")
    assert (got["output"].numpy() > 0).all()


# ---------------------------------------------------------------------------
# training_losses through the UNet
# ---------------------------------------------------------------------------

def losses_both(pair, coeffs, mean, var, loss, weight=None, seed=4, t=T_INJ):
    tc, jc = coeffs
    x0, noise, y = inputs(seed)
    port_fn, jax_fn = model_fns(pair, y, x0, mean, tc)
    with torch.no_grad():
        got = tg.training_losses(tc, port_fn, torch.from_numpy(x0), torch.from_numpy(t),
                                 torch.from_numpy(noise), tg.ModelMeanType(mean),
                                 tg.ModelVarType(var), tg.LossType(loss),
                                 mse_weight=None if weight is None else weight[0])
    want = jg.training_losses(jc, jax_fn, jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                              jnp.asarray(noise), jg.ModelMeanType(mean), jg.ModelVarType(var),
                              jg.LossType(loss), mse_weight=None if weight is None else weight[1])
    return got, want


def assert_terms_close(got, want):
    assert set(got) == set(want)
    for key in got:
        if key == "x_t":
            close(got[key], want[key], atol=1e-6, what=key)
        else:
            close(got[key], want[key], what=key)


@pytest.fixture(scope="module")
def tables():
    return (tg.coefficients_from_schedule(schedule.LinearSchedule(**SCHEDULE)),
            jg.coefficients_from_schedule(jax_schedule.LinearSchedule(**SCHEDULE)))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("mean", MEANS)
def test_training_losses_match_jax(nets, tables, mean, var, loss):
    got, want = losses_both(nets[2 if learned(var) else 1], tables, mean, var, loss)
    assert_terms_close(got, want)
    if learned(var) and not tg.LossType(loss).is_vb():
        assert (got["vb"] > 0).all()
        close(got["loss"], got["mse"] + got["vb"], what="mse + vb")


@pytest.mark.parametrize("mean", ["start_x", "epsilon", "v_prediction"])
def test_min_snr_weighted_losses_match_jax(nets, tables, mean):
    tc, jc = tables
    w_t = tg.min_snr_weight(tc.alphas_cumprod, torch.from_numpy(T_INJ), tg.ModelMeanType(mean))
    w_j = jg.min_snr_weight(jc.alphas_cumprod, jnp.asarray(T_INJ), jg.ModelMeanType(mean))
    close(w_t, w_j, what="weight")
    got, want = losses_both(nets[2], tables, mean, "learned_range", "rescaled_mse",
                            weight=(w_t, w_j))
    assert_terms_close(got, want)
    close(got["loss"], got["mse"] * w_t + got["vb"], what="weighted")


@pytest.mark.parametrize("loss", ["mse", "rescaled_mse", "kl"])
@pytest.mark.parametrize("var", ["fixed_small", "fixed_large", "learned_range"])
@pytest.mark.parametrize("mean", ["start_x", "v_prediction"])
def test_zero_terminal_snr_losses_match_jax(nets, mean, var, loss):
    """alpha_bar(T-1) = 0: t = 19 is pure noise."""
    coeffs = (tg.coefficients_from_schedule(schedule.LinearSchedule(**ZTSNR)),
              jg.coefficients_from_schedule(jax_schedule.LinearSchedule(**ZTSNR)))
    assert float(coeffs[0].alphas_cumprod[-1]) == 0.0
    got, want = losses_both(nets[2 if learned(var) else 1], coeffs, mean, var, loss)
    assert_terms_close(got, want)


# ---------------------------------------------------------------------------
# The pipeline's loss, its gradients, and the frozen mean
# ---------------------------------------------------------------------------

def patch_jax_draws(monkeypatch, jpipe, t, noise, mask=None):
    """JAX's loss_and_metrics draws its timesteps, noise and mask; hand it
    the port's."""
    monkeypatch.setattr(jpipe, "random_timesteps", lambda rng, b: jnp.asarray(t, jnp.int32))
    monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    monkeypatch.setattr(jpipe, "cond_dropout_mask", lambda rng, b, labels:
                        None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("kwargs", [
    dict(model_mean_type="epsilon", model_var_type="learned_range", loss_type="rescaled_mse"),
    dict(model_mean_type="v_prediction", model_var_type="learned", loss_type="mse",
         loss_weighting="min_snr", cond_dropout=0.5),
    dict(model_mean_type="start_x", model_var_type="fixed_large", loss_type="rescaled_kl"),
], ids=["hybrid", "v-min-snr-dropout", "rescaled-kl"])
def test_loss_and_metrics_matches_jax(monkeypatch, kwargs):
    out_ch = 2 if learned(kwargs["model_var_type"]) else 1
    tpipe, jpipe, params = make_pair(out_ch, **kwargs)
    x0, noise, y = inputs(5)
    mask = np.float32([1, 0, 1, 1]) if kwargs.get("cond_dropout") else None
    batch = {"data": torch.from_numpy(x0), "labels": torch.from_numpy(y)}
    loss, metrics = tpipe.loss_and_metrics(
        batch, t=torch.from_numpy(T_PIPE), noise=torch.from_numpy(noise),
        cond_mask=None if mask is None else torch.from_numpy(mask))
    patch_jax_draws(monkeypatch, jpipe, T_PIPE, noise, mask)
    want_loss, want = jpipe.loss_and_metrics(params, {"data": jnp.asarray(x0),
                                                      "labels": jnp.asarray(y)},
                                             jax.random.PRNGKey(0))
    close(loss, want_loss, what="loss")
    assert set(metrics) == set(want)
    for key in metrics:
        close(metrics[key], want[key], rtol=1e-5 if key != "psnr" else 1e-6, what=key)
    if mask is not None:  # the mask reached the model: every row kept differs
        other, _ = tpipe.loss_and_metrics(batch, t=torch.from_numpy(T_PIPE),
                                          noise=torch.from_numpy(noise),
                                          cond_mask=torch.ones(4))
        assert abs(float(other.detach()) - float(loss.detach())) > 1e-6


def test_loss_and_metrics_draws_t_noise_mask_in_order():
    """Without injected draws: t, then the noise, then the mask, from the
    generator."""
    tpipe, _, _ = make_pair(2, model_mean_type="epsilon", model_var_type="learned_range",
                            loss_type="rescaled_mse", cond_dropout=0.5)
    x0, _, y = inputs(6)
    batch = {"data": torch.from_numpy(x0), "labels": torch.from_numpy(y)}
    gen = torch.Generator().manual_seed(3)
    loss, _ = tpipe.loss_and_metrics(batch, generator=gen)
    gen = torch.Generator().manual_seed(3)
    t = tpipe.random_timesteps(gen, 4)
    noise = torch.randn(x0.shape, generator=gen)
    mask = tpipe.cond_dropout_mask(gen, 4, batch["labels"])
    again, _ = tpipe.loss_and_metrics(batch, t=t, noise=noise, cond_mask=mask)
    assert float(loss) == float(again)


def test_hybrid_gradients_match_jax_grad(monkeypatch):
    """The learned-range hybrid loss (rescaled_mse): every parameter
    gradient of the port's backward against ``jax.grad`` of JAX's
    ``loss_and_metrics``, exported to the port's names."""
    kwargs = dict(model_mean_type="epsilon", model_var_type="learned_range",
                  loss_type="rescaled_mse")
    tpipe, jpipe, params = make_pair(2, **kwargs)
    x0, noise, y = inputs(7)
    tpipe.backbone.train()
    loss, _ = tpipe.loss_and_metrics({"data": torch.from_numpy(x0), "labels": torch.from_numpy(y)},
                                     t=torch.from_numpy(T_PIPE), noise=torch.from_numpy(noise))
    loss.backward()
    got = {n: p.grad.numpy() for n, p in tpipe.backbone.named_parameters()}
    patch_jax_draws(monkeypatch, jpipe, T_PIPE, noise)
    batch = {"data": jnp.asarray(x0), "labels": jnp.asarray(y)}
    grads = jax.grad(lambda p: jpipe.loss_and_metrics(p, batch, jax.random.PRNGKey(0))[0])(params)
    want = export_unet_state_dict(jax.device_get(grads), **arch_kwargs(KW))
    assert set(want) <= set(got)
    num = sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
    den = sum(float(np.sum(np.asarray(w) ** 2)) for w in want.values())
    assert den > 0 and np.sqrt(num / den) <= 1e-5, np.sqrt(num / den)


def test_vb_term_leaves_the_mean_half_untouched(tables):
    """The ``vb`` term alone: zero gradient through the mean half of the
    output (JAX's stop_gradient, the port's detach), a nonzero one through
    the variance half; the MSE term alone reaches only the mean half."""
    tc, _ = tables
    x0, noise, _ = inputs(8)
    out = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, size=(*SHAPE[:-1], 2)).astype(np.float32)).requires_grad_()
    terms = tg.training_losses(tc, lambda *_: out, torch.from_numpy(x0),
                               torch.from_numpy(T_INJ), torch.from_numpy(noise),
                               tg.ModelMeanType.EPSILON, tg.ModelVarType.LEARNED_RANGE,
                               tg.LossType.RESCALED_MSE)
    (g_vb,) = torch.autograd.grad(terms["vb"].sum(), out, retain_graph=True)
    assert not g_vb[..., 0].any() and g_vb[..., 1].abs().sum() > 0
    (g_mse,) = torch.autograd.grad(terms["mse"].sum(), out)
    assert not g_mse[..., 1].any() and g_mse[..., 0].abs().sum() > 0


# ---------------------------------------------------------------------------
# Bits per dimension
# ---------------------------------------------------------------------------

def test_prior_bpd_matches_jax(tables):
    tc, jc = tables
    x0, _, _ = inputs(10)
    close(tg.prior_bpd(tc, torch.from_numpy(x0)), jg.prior_bpd(jc, jnp.asarray(x0)))


@pytest.mark.parametrize("var,mean", [("learned_range", "epsilon"), ("fixed_small", "start_x")])
def test_calc_bpd_loop_matches_jax(nets, monkeypatch, var, mean):
    """Every step's noise from one table: the port's i-th generator draw,
    JAX's i-th split key (``split(k) = (k + 1, k + 1000)`` from key 0: step
    i draws at 1000 + i)."""
    pair = nets[2 if learned(var) else 1]
    tpipe, jpipe, params = pair
    x0, _, y = inputs(11, n=2)
    T = len(tpipe.schedule)
    table = np.random.default_rng(12).normal(size=(T, *x0.shape)).astype(np.float32)
    port_fn, jax_fn = model_fns(pair, y[:2], x0, mean)
    real_randn = torch.randn
    draws = iter(table)

    def randn(*size, generator=None, **kwargs):
        if generator is None:
            return real_randn(*size, **kwargs)
        return torch.from_numpy(next(draws).copy())

    tc = tpipe.coeffs
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", randn)
        got = tg.calc_bpd_loop(tc, port_fn, torch.from_numpy(x0), torch.Generator(),
                               tg.ModelMeanType(mean), tg.ModelVarType(var))
    tab = jnp.asarray(table)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", lambda k: (k + 1, k + 1000))
        m.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32:
                  tab[k - 1000].astype(dtype))
        with jax.disable_jit():
            want = jg.calc_bpd_loop(jpipe.coeffs, jax_fn, jnp.asarray(x0),
                                    jnp.asarray(0, jnp.int32), jg.ModelMeanType(mean),
                                    jg.ModelVarType(var))
    assert set(got) == set(want)
    assert got["vb"].shape == (2, T)
    for key in ("total_bpd", "prior_bpd", "vb"):
        close(got[key], want[key], what=key)
    for key in ("xstart_mse", "mse"):
        close(got[key], want[key], rtol=1e-4, atol=1e-6, what=key)
    np.testing.assert_allclose(got["total_bpd"].numpy(),
                               (got["vb"].sum(1) + got["prior_bpd"]).numpy(), rtol=1e-6)


def test_pipeline_calc_bpd_reads_the_conditions(nets):
    """``calc_bpd`` on the pipeline: the conditions reach the model, and a
    generator makes it repeatable."""
    tpipe = nets[2][0]
    x0, _, y = inputs(13, n=2)
    a = tpipe.calc_bpd(torch.from_numpy(x0), torch.Generator().manual_seed(1),
                       conditions=torch.from_numpy(y))
    b = tpipe.calc_bpd(torch.from_numpy(x0), torch.Generator().manual_seed(1),
                       conditions=torch.from_numpy(y))
    c = tpipe.calc_bpd(torch.from_numpy(x0), torch.Generator().manual_seed(1),
                       conditions=torch.from_numpy(y[::-1].copy()))
    assert torch.equal(a["total_bpd"], b["total_bpd"])
    assert not torch.equal(a["vb"], c["vb"])
    assert torch.isfinite(a["total_bpd"]).all() and (a["total_bpd"] > 0).all()
