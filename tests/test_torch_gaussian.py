"""The port's Gaussian diffusion math against the JAX package's, on the CPU.

Every coefficient table and ``timestep_map`` (linear, cosine and sigmoid
schedules, named schedules, zero terminal SNR), ``respace`` under all four
spacings at several (T, n) and composed with an earlier respacing, the
q/posterior/predict math, ``dynamic_threshold``, ``p_mean_variance`` for
every mean type x variance type with clipping on and off, the classifier
conditioning, and one DDPM and one DDIM step. Inputs are numpy arrays
handed to both sides; model outputs are
fixed arrays, so no network runs here. The bar is relative MSE < 1e-9 in
fp32; the tables are bitwise equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule

torch.set_num_threads(1)

SCHEDULES = {
    "linear-1000": ("LinearSchedule", (1000,), {}),
    "linear-50": ("LinearSchedule", (50,), {}),
    "linear-ztsnr": ("LinearSchedule", (100,), {"zero_terminal_snr": True}),
    "cosine-100": ("CosineBetaSchedule", (100,), {}),
    "sigmoid-100": ("SigmoidSchedule", (100,), {}),
}
TABLES = [f.name for f in tg.GaussianCoefficients.__dataclass_fields__.values()]


def coeffs(case):
    name, args, kwargs = SCHEDULES[case]
    return (tg.coefficients_from_schedule(getattr(schedule, name)(*args, **kwargs)),
            jg.coefficients_from_schedule(getattr(jax_schedule, name)(*args, **kwargs)))


def assert_tables_equal(got, want):
    assert got.num_timesteps == want.num_timesteps
    for name in TABLES:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == (np.int64 if name == "timestep_map" else np.float32), name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-30))


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_coefficient_tables_match_exactly(case):
    assert_tables_equal(*coeffs(case))


@pytest.mark.parametrize("name", ["linear", "scaled_linear", "sigmoid", "cosine"])
def test_named_schedule_coefficients_match_exactly(name):
    assert_tables_equal(tg.coefficients_from_schedule(schedule.named_beta_schedule(name, 200)),
                        jg.coefficients_from_schedule(jax_schedule.named_beta_schedule(name, 200)))


def test_one_step_table_borrows_beta_0():
    assert_tables_equal(tg.coefficients_from_betas(np.array([0.3])),
                        jg.coefficients_from_betas(np.array([0.3])))


RESPACINGS = [("linear-1000", n) for n in (1, 2, 10, 50, 999)] + \
             [("cosine-100", n) for n in (7, 25)] + [("sigmoid-100", 8), ("linear-50", 13)]


@pytest.mark.parametrize("spacing", ["uniform-t", "uniform-lambda", "trailing", "karras"])
@pytest.mark.parametrize("case,n", RESPACINGS, ids=lambda v: str(v))
def test_respace_matches_exactly(case, n, spacing):
    """Respacing reads the float32 alphas_cumprod back into float64 (as
    JAX does), so the respaced betas and every later table are bitwise
    JAX's."""
    got, want = coeffs(case)
    try:
        want_r = jg.respace(want, n, spacing)
    except ValueError as exc:  # a grid that cannot stride to n points
        with pytest.raises(ValueError, match=str(exc)[:20]):
            tg.respace(got, n, spacing)
        return
    assert_tables_equal(tg.respace(got, n, spacing), want_r)


def test_respace_composes_timestep_map():
    """A respaced table respaced again maps back to original timesteps."""
    got, want = coeffs("linear-1000")
    got2 = tg.respace_subset(tg.respace(got, 40, "trailing"), np.arange(1, 40, 2))
    want2 = jg.respace_subset(jg.respace(want, 40, "trailing"), np.arange(1, 40, 2))
    assert_tables_equal(got2, want2)
    assert got2.timestep_map[-1] == 999


@pytest.mark.parametrize("spacing", ["uniform-lambda", "karras"])
def test_zero_snr_spacings_raise_like_jax(spacing):
    got, want = coeffs("linear-ztsnr")
    with pytest.raises(ValueError, match="zero-terminal-SNR"):
        jg.respace(want, 10, spacing)
    with pytest.raises(ValueError, match="zero-terminal-SNR"):
        tg.respace(got, 10, spacing)
    assert_tables_equal(tg.respace(got, 10, "trailing"), jg.respace(want, 10, "trailing"))
    with pytest.raises(ValueError, match="spacing"):
        tg.respace(got, 10, "linear")


# ---------------------------------------------------------------------------
# The sampling math, from fixed inputs
# ---------------------------------------------------------------------------

SHAPE = (3, 4, 5, 6, 1)


def inputs(seed: int, channels: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    out = (1.5 * rng.normal(size=(*SHAPE[:-1], channels))).astype(np.float32)
    return x, out


def respaced_pair():
    got, want = coeffs("linear-1000")
    return tg.respace(got, 12, "uniform-t"), jg.respace(want, 12, "uniform-t")


T_ROWS = np.array([11, 5, 0])


def test_q_and_predict_math_match():
    c_t, c_j = respaced_pair()
    x, eps = inputs(1)
    x0 = np.clip(inputs(2)[0], -1, 1)
    tt, tj = torch.from_numpy(T_ROWS), jnp.asarray(T_ROWS)
    xt, x0t, epst = map(torch.from_numpy, (x, x0, eps))
    pairs = [
        (tg.q_sample(c_t, x0t, tt, epst), jg.q_sample(c_j, x0, tj, eps)),
        (tg.predict_xstart_from_eps(c_t, xt, tt, epst), jg.predict_xstart_from_eps(c_j, x, tj, eps)),
        (tg.predict_xstart_from_xprev(c_t, xt, tt, epst),
         jg.predict_xstart_from_xprev(c_j, x, tj, eps)),
        (tg.predict_xstart_from_v(c_t, xt, tt, epst), jg.predict_xstart_from_v(c_j, x, tj, eps)),
        (tg.predict_eps_from_xstart(c_t, xt, tt, x0t), jg.predict_eps_from_xstart(c_j, x, tj, x0)),
        *zip(tg.q_mean_variance(c_t, x0t, tt), jg.q_mean_variance(c_j, x0, tj)),
        *zip(tg.q_posterior_mean_variance(c_t, x0t, xt, tt),
             jg.q_posterior_mean_variance(c_j, x0, x, tj)),
    ]
    for i, (g, w) in enumerate(pairs):
        assert rel_mse(g.numpy(), w) < 1e-12, i
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(w), g.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("percentile", [0.9, 0.5, 0.995])
def test_dynamic_threshold_matches(percentile):
    x = 3.0 * inputs(3)[0]
    x[1] *= 0.1  # a row whose quantile is below 1 (s clamps to 1)
    got = tg.dynamic_threshold(torch.from_numpy(x), percentile).numpy()
    want = np.asarray(jg.dynamic_threshold(jnp.asarray(x), percentile))
    assert rel_mse(got, want) < 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1], x[1])


def fixed_model(out: np.ndarray, tmap_seen: list):
    """Both frameworks' model_fn: a fixed output scaled by the (original)
    timestep it is called with, which it also records."""
    def port_fn(x, t):
        tmap_seen.append(("port", t.tolist()))
        scale = 1.0 + t.to(torch.float32).reshape(-1, *((1,) * (x.ndim - 1))) / 1000.0
        return torch.from_numpy(out) * scale

    def jax_fn(x, t):
        tmap_seen.append(("jax", np.asarray(t).tolist()))
        scale = 1.0 + jnp.asarray(t, jnp.float32).reshape(-1, *((1,) * (x.ndim - 1))) / 1000.0
        return jnp.asarray(out) * scale

    return port_fn, jax_fn


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("var_type", list(tg.ModelVarType), ids=lambda v: v.value)
@pytest.mark.parametrize("mean_type", list(tg.ModelMeanType), ids=lambda m: m.value)
def test_p_mean_variance_matches(mean_type, var_type, clip):
    """All 16 mean x variance combinations, from a fixed model output, on
    a respaced table: the model sees timestep_map[t], the tables t."""
    c_t, c_j = respaced_pair()
    learned = var_type in (tg.ModelVarType.LEARNED, tg.ModelVarType.LEARNED_RANGE)
    x, out = inputs(4, channels=2 if learned else 1)
    if learned:  # the variance half in [-1, 1] (learned_range's interpolation frac)
        out[..., 1:] = np.tanh(out[..., 1:])
    seen: list = []
    port_fn, jax_fn = fixed_model(out, seen)
    got = tg.p_mean_variance(c_t, port_fn, torch.from_numpy(x), torch.from_numpy(T_ROWS),
                             mean_type, var_type, clip_denoised=clip)
    want = jg.p_mean_variance(c_j, jax_fn, jnp.asarray(x), jnp.asarray(T_ROWS),
                              jg.ModelMeanType(mean_type.value), jg.ModelVarType(var_type.value),
                              clip_denoised=clip)
    assert seen[0][1] == seen[1][1] == c_t.timestep_map[T_ROWS].tolist()
    assert set(got) == set(want)
    for key in got:
        g = got[key].numpy()
        w = np.broadcast_to(np.asarray(want[key]), g.shape)
        assert rel_mse(g, w) < 1e-9, key
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=key)


def test_classifier_conditioning_and_steps_match(monkeypatch):
    """condition_mean, condition_score, one ancestral and one DDIM (eta 0.5)
    step with the same noise, on the respaced table."""
    c_t, c_j = respaced_pair()
    x, out = inputs(5)
    noise = inputs(6)[0]
    grad = 0.3 * inputs(7)[0]
    tt, tj = torch.from_numpy(T_ROWS), jnp.asarray(T_ROWS)
    port_fn, jax_fn = fixed_model(out, [])
    mt, vt = tg.ModelMeanType.EPSILON, tg.ModelVarType.FIXED_LARGE
    jmt, jvt = jg.ModelMeanType.EPSILON, jg.ModelVarType.FIXED_LARGE

    def port_grad(x_, t_):
        return torch.from_numpy(grad) * (1.0 + t_.to(torch.float32).reshape(-1, 1, 1, 1, 1))

    def jax_grad(x_, t_):
        return jnp.asarray(grad) * (1.0 + jnp.asarray(t_, jnp.float32).reshape(-1, 1, 1, 1, 1))

    xt = torch.from_numpy(x)
    out_t = tg.p_mean_variance(c_t, port_fn, xt, tt, mt, vt)
    out_j = jg.p_mean_variance(c_j, jax_fn, jnp.asarray(x), tj, jmt, jvt)
    pairs = [(tg.condition_mean(c_t, port_grad, out_t, xt, tt),
              jg.condition_mean(c_j, jax_grad, out_j, jnp.asarray(x), tj))]
    st, sj = (tg.condition_score(c_t, port_grad, out_t, xt, tt),
              jg.condition_score(c_j, jax_grad, out_j, jnp.asarray(x), tj))
    pairs += [(st["mean"], sj["mean"]), (st["pred_xstart"], sj["pred_xstart"])]
    monkeypatch.setattr(jg, "normal_like", lambda rng, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    for grad_fn in (None, (port_grad, jax_grad)):
        kw_t = {"cond_grad_fn": grad_fn[0]} if grad_fn else {}
        kw_j = {"cond_grad_fn": grad_fn[1]} if grad_fn else {}
        pairs.append((tg.p_sample_step(c_t, port_fn, xt, tt, torch.from_numpy(noise), mt, vt,
                                       **kw_t)[0],
                      jg.p_sample_step(c_j, jax_fn, jnp.asarray(x), tj, None, jmt, jvt, **kw_j)[0]))
        pairs.append((tg.ddim_sample_step(c_t, port_fn, xt, tt, torch.from_numpy(noise), mt, vt,
                                          eta=0.5, **kw_t)[0],
                       jg.ddim_sample_step(c_j, jax_fn, jnp.asarray(x), tj, None, jmt, jvt,
                                           eta=0.5, **kw_j)[0]))
    # eta 0 draws no noise: the same step as JAX's, whose noise is multiplied by 0
    pairs.append((tg.ddim_sample_step(c_t, port_fn, xt, tt, None, mt, vt)[0],
                  jg.ddim_sample_step(c_j, jax_fn, jnp.asarray(x), tj, None, jmt, jvt)[0]))
    for i, (g, w) in enumerate(pairs):
        assert rel_mse(g.numpy(), w) < 1e-9, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=str(i))
    # the row at t = 0 takes no noise: DDIM at eta 0.5 and at eta 0 agree there
    np.testing.assert_array_equal(pairs[4][0][2].numpy(), pairs[-1][0][2].numpy())
