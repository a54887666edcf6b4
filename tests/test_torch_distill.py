"""The port's progressive distillation against the JAX package's, on the CPU.

A small GaussianDiffusion pipeline (2-D UNetv2, width 8, 8x8, epsilon
prediction, fixed_small) in each framework with the same seeded weights
(``transplant_unet_state_dict``):

* ``distill_grid``, ``distilled_coefficients`` and ``nested_grids`` equal
  JAX's (grids exactly, tables bitwise);
* with the oracle teacher (it predicts the true noise) the target is the
  true x0 at every student index (JAX's
  ``test_oracle_teacher_target_is_true_x0``, atol 5e-4);
* ``distill_targets`` on the same weights, x_t and j equals JAX's, and one
  stage's loss and every parameter gradient equal ``jax.grad`` of the JAX
  loss (``make_stage_step``'s loss_fn, from JAX's own pieces) with the same
  j and noise: relative MSE < 1e-9;
* a stage's learning rate is optax's ``warmup_cosine_decay_schedule``
  (within 1e-7 of the peak: optax computes in float32);
* a cascade 8 -> 4 -> 2 of 3 updates a stage from the same teacher, with
  the same j, noise and batches (JAX's jitted stage steps run with its
  draws patched), ends within a relative L2 of 1e-5 of JAX's student
  params (1.3e-6 met), and its updates (student minus teacher) within 1e-4
  (5.8e-5 met): torch's AdamW and optax's adamw order their float32
  arithmetic differently. The parameters whose first-update gradient is
  rounding noise in JAX (under 1e-6 of the whole gradient's norm) are held
  apart, since Adam scales such noise to steps of the learning rate of
  either sign: the test asserts that they are the attention key biases
  (softmax does not see them) and that the port's gradient there is noise
  too;
* ``sample`` from the same x_T equals JAX's ``sample`` (rel MSE < 1e-9);
* the validation messages are JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import random_state_dict
from rho_diffusion_tpu.diffusion import distill as jd
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.interop.torch_weights import transplant_unet_state_dict
from rho_diffusion_tpu_torch.diffusion import distill as td
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict

torch.set_num_threads(2)
# width 64: GroupNorm32's groups hold two channels, so no conv bias or
# embedding projection has a gradient that is zero but for rounding (one
# channel a group annihilates them, and Adam turns such noise into full steps)
KW = dict(dims=2, data_shape=[8, 8], in_channels=1, out_channels=1, model_channels=64,
          num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
          use_scale_shift_norm=True)
SCHED = dict(num_steps=100, beta_1=2e-4, beta_T=2e-2)
PIPE = dict(model_mean_type="epsilon", model_var_type="fixed_small")
SHAPE = (4, 8, 8, 1)
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2",
          "timestep_map")


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


@pytest.fixture(scope="module")
def pair():
    """(port pipeline, JAX pipeline, JAX params) with the same weights."""
    tpipe = tg.GaussianDiffusionPipeline("UNetv2", dict(KW), schedule.LinearSchedule(**SCHED),
                                         device="cpu", **PIPE)
    sd = random_state_dict(tpipe.backbone, 11)
    tpipe.load_state_dict(sd)
    jpipe = jg.GaussianDiffusionPipeline("UNetv2", dict(KW),
                                         jax_schedule.LinearSchedule(**SCHED), **PIPE)
    kw = {k: v for k, v in arch_kwargs(KW).items() if k != "dims"}
    params = transplant_unet_state_dict({k: v.numpy() for k, v in sd.items()}, **kw)
    return tpipe, jpipe, params


def data(seed: int, n: int = SHAPE[0]) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, *SHAPE[1:])).astype(np.float32)


def test_grids_and_tables_equal_jax(pair):
    tpipe, jpipe, _ = pair
    for total, n in [(1000, 64), (1000, 8), (100, 20), (64, 64)]:
        g = td.distill_grid(total, n)
        np.testing.assert_array_equal(g, jd.distill_grid(total, n))
        assert g[-1] == total - 1 and len(g) == n
        np.testing.assert_array_equal(g[1::2], td.distill_grid(total, n // 2))
    got = [td.distilled_coefficients(tpipe.coeffs, 8), *td.nested_grids(tpipe.coeffs, 16)]
    want = [jd.distilled_coefficients(jpipe.coeffs, 8), *jd.nested_grids(jpipe.coeffs, 16)]
    for g, w in zip(got, want):
        for field in TABLES:
            np.testing.assert_array_equal(getattr(g, field).numpy(),
                                          np.asarray(getattr(w, field)), err_msg=field)


def test_oracle_teacher_target_is_true_x0():
    c = tg.coefficients_from_schedule(schedule.LinearSchedule(100, 2e-4, 2e-2))
    c_t, c_s = td.nested_grids(c, 16)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (8, 5, 5, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(8, 5, 5, 1)).astype(np.float32))
    acp = c.alphas_cumprod

    def oracle(x, t_orig):
        a = torch.sqrt(acp[t_orig]).reshape(-1, 1, 1, 1)
        s = torch.sqrt(1.0 - acp[t_orig]).reshape(-1, 1, 1, 1)
        return (x - a * x0) / s

    for j_val in (0, 3, 7):
        j = torch.full((8,), j_val, dtype=torch.int64)
        x_t = tg.q_sample(c_s, x0, j, eps)
        target = td.distill_targets(c_t, c_s, oracle, x_t, j, tg.ModelMeanType.EPSILON,
                                    tg.ModelVarType.FIXED_SMALL, clip_denoised=False)
        np.testing.assert_allclose(target.numpy(), x0.numpy(), atol=5e-4)


def jax_stage_loss(jpipe, params, teacher, x0, j, noise, n_teacher):
    """JAX's ``make_stage_step`` loss_fn with the draws given."""
    c_t, c_s = jd.nested_grids(jpipe.coeffs, n_teacher)
    x_t = jg.q_sample(c_s, x0, j, noise)
    target = jd.distill_targets(c_t, c_s, jpipe._model_fn(jax.lax.stop_gradient(teacher), None),
                                x_t, j, jpipe.model_mean_type, jpipe.model_var_type,
                                clip_denoised=False,
                                thresholding_percentile=jpipe.thresholding_percentile)
    out = jg.p_mean_variance(c_s, jpipe._model_fn(params, None, train=True), x_t, j,
                             jpipe.model_mean_type, jpipe.model_var_type, clip_denoised=False)
    w = jd.truncated_snr_weight(c_s, j, x0.ndim)
    return jnp.mean(w * (out["pred_xstart"] - target) ** 2), (x_t, target)


def test_targets_loss_and_gradients_match_jax(pair):
    tpipe, jpipe, params = pair
    x0 = data(1)
    rng = np.random.default_rng(2)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    j = np.array([0, 1, 2, 3])
    n_teacher = 8
    d = td.ProgressiveDistiller(tpipe)
    student = td.copy.deepcopy(tpipe.backbone)
    loss = d.stage_loss(student, tpipe.backbone, {"data": torch.from_numpy(x0)}, n_teacher,
                        j=torch.from_numpy(j), noise=torch.from_numpy(noise))
    loss.backward()
    (want_loss, (x_t, want_target)), grads = jax.value_and_grad(
        lambda p: jax_stage_loss(jpipe, p, params, jnp.asarray(x0), jnp.asarray(j),
                                 jnp.asarray(noise), n_teacher), has_aux=True)(params)
    c_t, c_s = td.nested_grids(tpipe.coeffs, n_teacher)
    target = td.distill_targets(c_t, c_s, td._model_fn(tpipe.backbone.eval(), None),
                                torch.from_numpy(np.asarray(x_t)), torch.from_numpy(j),
                                tpipe.model_mean_type, tpipe.model_var_type)
    assert rel_mse(target.numpy(), want_target) < 1e-9
    assert rel_mse(loss.detach().numpy(), want_loss) < 1e-9
    want = export_unet_state_dict(jax.device_get(grads), **arch_kwargs(KW))
    got = {k: p.grad.numpy() for k, p in student.named_parameters()}
    assert set(got) == set(want)
    flat = [np.concatenate([np.ravel(m[k]) for k in sorted(want)]) for m in (got, want)]
    assert rel_mse(*flat) < 1e-9
    assert all(p.grad is None for p in tpipe.backbone.parameters())


@pytest.mark.parametrize("updates", [3, 30])
def test_stage_learning_rate_is_optax(pair, updates):
    lr = 1e-3
    d = td.ProgressiveDistiller(pair[0], opt_kwargs={"lr": lr})
    warm = max(1, min(100, updates // 10))
    want = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr, warmup_steps=warm,
                                              decay_steps=max(updates, warm + 1),
                                              end_value=0.1 * lr)
    got = d.learning_rate(updates)
    for i in range(updates + 3):
        assert abs(got(i) - float(want(i))) <= 1e-7 * lr, i
    assert td.ProgressiveDistiller(pair[0], lr_schedule="constant").learning_rate(5) == 1e-4


def test_two_stage_cascade_matches_jax(pair, monkeypatch):
    tpipe, jpipe, params = pair
    updates, lr = 3, 1e-3
    batches = [data(10 + i) for i in range(2)]
    rng = np.random.default_rng(20)
    draws = {n: [(rng.integers(0, n // 2, SHAPE[0]), rng.normal(size=SHAPE).astype(np.float32))
                 for _ in range(updates)] for n in (8, 4)}

    d = td.ProgressiveDistiller(tpipe, opt_kwargs={"lr": lr})
    student, info = d.distill(
        tpipe.backbone, lambda i: {"data": torch.from_numpy(batches[i % 2])}, from_steps=8,
        to_steps=2, updates_per_stage=updates,
        draws=lambda n, i: tuple(torch.from_numpy(np.asarray(a)) for a in draws[n][i]))
    assert list(info) == ["8->4", "4->2"] and all(len(v) == updates for v in info.values())

    # JAX's own jitted stage steps, distill_stage's loop, its draws patched:
    # the integer key 10 i splits into (10 i + 1, 10 i + 1000), the update's
    # j and noise (the teacher's DDIM steps draw from a real key, times 0)
    jdist = jd.ProgressiveDistiller(jpipe, opt_kwargs={"lr": lr})
    teacher, losses = params, {}
    split, normal = jax.random.split, jax.random.normal
    for n in (8, 4):
        jtab = jnp.asarray(np.stack([a for a, _ in draws[n]]), jnp.int32)
        ntab = jnp.asarray(np.stack([b for _, b in draws[n]]))
        monkeypatch.setattr(jax.random, "split",
                            lambda k, *a: (k + 1, k + 1000) if jnp.ndim(k) == 0 else split(k, *a))
        monkeypatch.setattr(jax.random, "randint",
                            lambda k, shape, lo, hi, jtab=jtab: jtab[k // 10])
        monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32,
                            ntab=ntab: ntab[(k - 1000) // 10].astype(dtype)
                            if jnp.ndim(k) == 0 else normal(k, shape, dtype))
        step = jdist.make_stage_step(n, updates)
        p, opt_state = teacher, jdist._get_tx(updates).init(teacher)
        losses[n] = []
        for i in range(updates):
            p, opt_state, loss = step(p, opt_state, teacher, {"data": jnp.asarray(batches[i % 2])},
                                      jnp.int32(10 * i))
            losses[n].append(float(loss))
        teacher = p
        monkeypatch.undo()
    np.testing.assert_allclose(info["8->4"], losses[8], rtol=1e-5)
    np.testing.assert_allclose(info["4->2"], losses[4], rtol=1e-4)
    want = export_unet_state_dict(jax.device_get(teacher), **arch_kwargs(KW))
    start = {k: v.numpy() for k, v in tpipe.backbone.state_dict().items()}
    got = {k: v.numpy() for k, v in student.state_dict().items()}

    def segments(m) -> dict:
        """Each parameter as a vector, the fused qkv biases split into their
        per-head q, k and v parts: {(name, part): vector}."""
        out = {}
        for k in sorted(want):
            v = np.ravel(m[k]).astype(np.float64)
            parts = np.split(v, 3 * KW["num_heads"]) if k.endswith("qkv.bias") else [v]
            out.update({(k, i): part for i, part in enumerate(parts)})
        return out

    # the segments held apart: those whose first-update gradient in JAX is
    # rounding noise (norm under 1e-6 of the whole gradient's), which Adam
    # scales to full steps of either sign. They must be the attention key
    # biases, which softmax does not see, and the port's gradient on them
    # must be noise too
    x0, (j0, noise0) = batches[0], draws[8][0]
    (_, _), jgrad = jax.value_and_grad(
        lambda p: jax_stage_loss(jpipe, p, params, jnp.asarray(x0), jnp.asarray(j0),
                                 jnp.asarray(noise0), 8), has_aux=True)(params)
    first = td.copy.deepcopy(tpipe.backbone)
    d.stage_loss(first, tpipe.backbone, {"data": torch.from_numpy(x0)}, 8,
                 j=torch.from_numpy(np.asarray(j0)), noise=torch.from_numpy(noise0)).backward()
    tgrad = {k: p.grad.numpy() for k, p in first.named_parameters()}
    noise_parts = set()
    for grads in (export_unet_state_dict(jax.device_get(jgrad), **arch_kwargs(KW)), tgrad):
        segs = segments(grads)
        total = np.linalg.norm(np.concatenate(list(segs.values())))
        small = {key for key, g in segs.items() if np.linalg.norm(g) < 1e-6 * total}
        noise_parts = noise_parts or small
        assert small == noise_parts
    assert noise_parts == {(k, i) for k, i in segments(want)
                           if k.endswith("qkv.bias") and i % 3 == 1}

    def flat(m, noise=False):
        """The params as one vector: the noise-gradient segments dropped
        (or alone)."""
        return np.concatenate([v for key, v in segments(m).items()
                               if (key in noise_parts) == noise])

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel_l2(flat(got), flat(want)) <= 1e-5
    assert rel_l2(flat(got) - flat(start), flat(want) - flat(start)) <= 1e-4
    assert np.linalg.norm(flat(got) - flat(start)) > 1e-3 * np.linalg.norm(flat(start))
    # the noise segments: each update moves them by at most the learning
    # rate and the weight decay, whatever their sign
    assert np.abs(flat(got, True) - flat(want, True)).max() <= 2 * 2 * updates * lr


def test_sample_matches_jax(pair, monkeypatch):
    tpipe, jpipe, params = pair
    x_T = np.random.default_rng(30).normal(size=SHAPE).astype(np.float32)
    got = td.ProgressiveDistiller(tpipe).sample(tpipe.backbone, SHAPE, 4,
                                                x_T=torch.from_numpy(x_T))
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape, dtype=jnp.float32: jnp.asarray(x_T, dtype))
    want = jd.ProgressiveDistiller(jpipe).sample(params, jax.random.PRNGKey(0), SHAPE, 4)
    assert np.isfinite(got.numpy()).all()
    assert rel_mse(got.numpy(), want) < 1e-9
    gen = torch.Generator().manual_seed(3)
    drawn = td.ProgressiveDistiller(tpipe).sample(tpipe.backbone, SHAPE, 4, generator=gen)
    again = td.ProgressiveDistiller(tpipe).sample(
        tpipe.backbone, SHAPE, 4, x_T=torch.randn(SHAPE, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(drawn, again)


def test_validation_messages_are_jax(pair):
    tpipe, jpipe, params = pair
    c = tg.coefficients_from_schedule(schedule.LinearSchedule(100))
    jc = jg.coefficients_from_schedule(jax_schedule.LinearSchedule(100))
    cases = [
        (lambda m, cc: m.nested_grids(cc, 7), "n_teacher must be even and >= 2, got 7"),
        (lambda m, cc: m.nested_grids(cc, 200), r"n_teacher=200 exceeds the table \(100\)"),
        (lambda m, cc: m.distill_grid(10, 20), "cannot stride 10 timesteps to 20 distinct"),
        (lambda m, cc: m.ProgressiveDistiller(None, loss_weight="l1"),
         "loss_weight must be 'truncated_snr' or 'one', got 'l1'"),
        (lambda m, cc: m.ProgressiveDistiller(None, lr_schedule="step"),
         "lr_schedule must be 'warmup_cosine' or 'constant', got 'step'"),
        (lambda m, cc: m._cycler([]), "batches is empty"),
    ]
    for fn, msg in cases:
        for module, coeffs in ((td, c), (jd, jc)):
            with pytest.raises(ValueError, match=msg):
                fn(module, coeffs)
    for distiller, teacher in ((td.ProgressiveDistiller(tpipe), tpipe.backbone),
                               (jd.ProgressiveDistiller(jpipe), params)):
        with pytest.raises(ValueError, match="from_steps=12 must be a 2\\^k multiple of "
                                             "to_steps=4"):
            distiller.distill(teacher, [None], 12, 4, 1, *(
                [] if distiller.__module__.startswith("rho_diffusion_tpu_torch")
                else [jax.random.PRNGKey(0)]))
        with pytest.raises(ValueError, match="updates must be >= 1, got 0"):
            distiller.distill_stage(teacher, [None], 8, 0, *(
                [] if distiller.__module__.startswith("rho_diffusion_tpu_torch")
                else [jax.random.PRNGKey(0)]))
