"""RePaint inpainting and DDIM encoding in the port against the JAX
package's, on the CPU.

A small 3-D UNet (width 8, 8^3, attention, learned-range variance,
class-conditional; seeded weights carried to JAX) under a 20-step schedule
respaced to 6. ``GaussianDiffusionPipeline.inpaint`` ('ddpm' with
``resample_steps`` 1 and 2, 'ddim' at eta 0 and 0.5) runs in both
frameworks with every draw injected from numpy tables:

* batch-wide, the port draws x_T, then for each step t and round u the
  step's noise (none for DDIM at eta 0), the known region's and, for
  u < U - 1, the re-noise; JAX splits its key four ways a round, and its
  patched ``split``/``normal`` map each key to the same table entry;
* per row, both fold the tags (t, u, d) into the row keys, d = 0 for the
  known region, 1 for the step, 2 for the re-noise, and x_T at tag M; the
  patched folds encode the tags into a table index.

Also: the known region of the output is ``known`` exactly; a full mask
returns ``known``; a row's result under per-row keys does not depend on its
batch; 'dpm++' and ``resample_steps`` 0 are refused. ``encode`` (respaced
on 'uniform-t', and on the full schedule) and ``encode_loop`` against
JAX's. Fields agree to relative MSE
< 1e-9 in fp32. JAX runs op by op (``jax.disable_jit``), its UNet jitted.
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
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.sampling_rng import per_sample_keys
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs

torch.set_num_threads(1)

KW = dict(dims=3, data_shape=[8, 8, 8], in_channels=1, out_channels=2, model_channels=8,
          num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
          num_classes=20, use_scale_shift_norm=True)
SCHEDULE = dict(num_steps=20, beta_1=1e-4, beta_T=5e-3)
TYPES = dict(model_mean_type="epsilon", model_var_type="learned_range")
STEPS = 6
SHAPE = (2, 8, 8, 8, 1)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def assert_close(got, want):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert rel_mse(g, w) < 1e-9, rel_mse(g, w)


@pytest.fixture(scope="module")
def pair():
    tpipe = tg.GaussianDiffusionPipeline("UNetv2", KW, schedule.LinearSchedule(**SCHEDULE),
                                         device="cpu", **TYPES)
    sd = random_state_dict(tpipe.backbone, 0)
    tpipe.load_state_dict(sd)
    jpipe = jg.GaussianDiffusionPipeline("UNetv2", KW, jax_schedule.LinearSchedule(**SCHEDULE),
                                         **TYPES)
    net = jpipe.backbone

    @jax.jit
    def run(params, x, t, y):
        return net.apply({"params": params}, x, t, y, False)

    def apply(params, x, t, y=None, train=False, cond_mask=None):
        with jax.disable_jit(False):
            return run(params, x, t, y)

    jpipe.apply = apply
    kw = {k: v for k, v in arch_kwargs(KW).items() if k != "dims"}
    params = transplant_unet_state_dict({k: v.numpy() for k, v in sd.items()}, **kw)
    return tpipe, jpipe, params


def problem(seed: int = 0, n: int = SHAPE[0]):
    """A known field, a half-volume mask (the first 4 of 8 depth planes
    kept) and condition rows."""
    rng = np.random.default_rng(seed)
    known = rng.uniform(-1, 1, size=(n, *SHAPE[1:])).astype(np.float32)
    mask = np.zeros((1, 8, 1, 1, 1), np.float32)
    mask[:, :4] = 1.0
    conds = rng.normal(size=(n, 4 * KW["model_channels"])).astype(np.float32)
    return known, mask, conds


class Draws:
    """Numpy tables of every draw, handed to both frameworks (see the
    module docstring)."""

    def __init__(self, monkeypatch, sampler, eta, U, per_row, seed=5):
        M = STEPS
        rng = np.random.default_rng(seed)
        R = M * U
        self.x_T = rng.normal(size=SHAPE).astype(np.float32)
        # [role, round]: role 0 the known region, 1 the step, 2 the re-noise
        self.rounds = rng.normal(size=(3, R, *SHAPE)).astype(np.float32)
        self.tags = rng.normal(size=(8 * (8 * (M + 1) + U + 1) + 4, *SHAPE)).astype(np.float32)
        self.tags[M + 1] = self.x_T
        stochastic = sampler == "ddpm" or eta != 0.0
        order = [self.x_T]
        for r in range(R):
            u = r % U
            order += ([self.rounds[1, r]] if stochastic else []) + [self.rounds[0, r]] + \
                ([self.rounds[2, r]] if u < U - 1 else [])
        self.port_order, self.port_draws = order, 0
        real_randn = torch.randn

        def randn(*size, generator=None, **kwargs):
            if generator is None:
                return real_randn(*size, **kwargs)
            self.port_draws += 1
            return torch.from_numpy(order[self.port_draws - 1].copy())

        rounds, tags, x_T = jnp.asarray(self.rounds), jnp.asarray(self.tags), jnp.asarray(self.x_T)

        def split(k, num=2):
            if num == 2:  # init, scan = split(rng): x_T's key is 7
                return k + 7, k + 1000
            return k + 1000, k + 1, k + 2, k + 3  # key, known, step, renoise

        def jax_normal_like(k, shape, dtype=jnp.float32):
            if per_row:
                return tags[k].astype(dtype)
            return rounds[(k % 1000 + 2) % 3, k // 1000 - 1].astype(dtype)

        monkeypatch.setattr(torch, "randn", randn)
        monkeypatch.setattr(tg, "keys_at_step", lambda keys, t: [keys[0] * 8 + int(t) + 1]
                            * len(keys))
        monkeypatch.setattr(tg, "normal_like", lambda keys, shape, device, dtype=torch.float32:
                            torch.from_numpy(self.tags[keys[0]].copy()).to(dtype))
        monkeypatch.setattr(jax.random, "split", split)
        monkeypatch.setattr(jax.random, "normal", lambda k, shape, dtype=jnp.float32:
                            x_T.astype(dtype))
        monkeypatch.setattr(jg, "is_per_sample_keys", lambda r: per_row)
        monkeypatch.setattr(jg, "keys_at_step", lambda k, t: k * 8 + t + 1)
        monkeypatch.setattr(jg, "normal_like", jax_normal_like)


def inpaint_both(pair, sampler, eta, U, per_row, known, mask, conds):
    tpipe, jpipe, params = pair
    opts = dict(sampler=sampler, eta=eta, num_steps=STEPS, resample_steps=U)
    port_kw = {"row_keys": [0] * SHAPE[0]} if per_row else {"generator": torch.Generator()}
    got = tpipe.inpaint(torch.from_numpy(known), torch.from_numpy(mask), torch.from_numpy(conds),
                        **port_kw, **opts)
    with jax.disable_jit():
        want = jpipe.inpaint(params, jnp.asarray(0, jnp.int32), jnp.asarray(known),
                             jnp.asarray(mask), jnp.asarray(conds), **opts)
    return got, want


@pytest.mark.parametrize("per_row", [False, True], ids=["batch", "per_row"])
@pytest.mark.parametrize("sampler,eta,U", [("ddpm", 0.0, 1), ("ddpm", 0.0, 2), ("ddim", 0.0, 2),
                                           ("ddim", 0.5, 1)],
                         ids=["ddpm-U1", "ddpm-U2", "ddim-U2", "ddim-eta0.5"])
def test_inpaint_matches_jax_with_injected_draws(pair, monkeypatch, sampler, eta, U, per_row):
    known, mask, conds = problem()
    with monkeypatch.context() as m:
        draws = Draws(m, sampler, eta, U, per_row)
        got, want = inpaint_both(pair, sampler, eta, U, per_row, known, mask, conds)
        if not per_row:
            assert draws.port_draws == len(draws.port_order)
    assert_close(got, want)
    full = np.broadcast_to(mask, known.shape).astype(bool)
    assert np.array_equal(got.numpy()[full], known[full]), "the known region is exact"
    gen = got.numpy()[~full]
    assert np.abs(gen - known[~full]).max() > 0.1, "the unknown region is generated"
    # the draws matter: another table gives another field
    with monkeypatch.context() as m:
        Draws(m, sampler, eta, U, per_row, seed=6)
        other, _ = inpaint_both(pair, sampler, eta, U, per_row, known, mask, conds)
    assert np.abs(other.numpy()[~full] - gen).max() > 1e-3


def test_full_mask_returns_known_and_refusals(pair):
    tpipe = pair[0]
    known, _, conds = problem(1)
    out = tpipe.inpaint(torch.from_numpy(known), torch.ones(1), torch.from_numpy(conds),
                        num_steps=STEPS, resample_steps=2, generator=torch.Generator())
    assert torch.equal(out, torch.from_numpy(known))
    for kw, match in ((dict(sampler="dpm++"), "inpainting supports"),
                      (dict(resample_steps=0), "resample_steps")):
        with pytest.raises(ValueError, match=match):
            tpipe.inpaint(torch.from_numpy(known), torch.ones(1), torch.from_numpy(conds),
                          num_steps=STEPS, **kw)
        with pytest.raises(ValueError, match=match):
            pair[1].inpaint(pair[2], jax.random.PRNGKey(0), jnp.asarray(known), jnp.ones(1),
                            jnp.asarray(conds), num_steps=STEPS, **kw)


def test_rows_are_independent_under_per_row_keys(pair):
    """Row 0 of a request alone and beside another row (another field,
    another condition) is the same sample; another seed gives another."""
    tpipe = pair[0]
    known, mask, conds = problem(2)
    keys = per_sample_keys(11, 2)
    opts = dict(num_steps=STEPS, resample_steps=2)
    both = tpipe.inpaint(torch.from_numpy(known), torch.from_numpy(mask),
                         torch.from_numpy(conds), row_keys=keys, **opts)
    alone = tpipe.inpaint(torch.from_numpy(known[:1]), torch.from_numpy(mask),
                          torch.from_numpy(conds[:1]), row_keys=keys[:1], **opts)
    assert rel_mse(alone.numpy(), both[:1].numpy()) < 1e-9
    other = tpipe.inpaint(torch.from_numpy(known[:1]), torch.from_numpy(mask),
                          torch.from_numpy(conds[:1]), row_keys=per_sample_keys(12, 1), **opts)
    assert np.abs(other.numpy() - alone.numpy()).max() > 1e-3


@pytest.mark.parametrize("num_steps", [STEPS, None], ids=["respaced", "full"])
def test_encode_matches_jax(pair, num_steps):
    """DDIM latents (no noise, no clipping) against JAX's."""
    tpipe, jpipe, params = pair
    known, _, conds = problem(3)
    got = tpipe.encode(torch.from_numpy(known), torch.from_numpy(conds), num_steps=num_steps)
    with jax.disable_jit():
        want = jpipe.encode(params, jnp.asarray(known), jnp.asarray(conds), num_steps=num_steps)
    assert_close(got, want)
    assert np.abs(got.numpy() - known).max() > 0.1


def test_encode_loop_matches_jax_on_tables(pair):
    """``encode_loop`` itself on the full tables of a fixed-variance model
    function (a fixed output), against JAX's."""
    tpipe, jpipe, _ = pair
    known, _, _ = problem(4)
    out = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    got = tg.encode_loop(tpipe.coeffs, lambda x, t: torch.from_numpy(out) + 0.1 * x,
                         torch.from_numpy(known), tg.ModelMeanType.EPSILON,
                         tg.ModelVarType.FIXED_SMALL)
    with jax.disable_jit():
        want = jg.encode_loop(jpipe.coeffs, lambda x, t: jnp.asarray(out) + 0.1 * x,
                              jnp.asarray(known), jg.ModelMeanType.EPSILON,
                              jg.ModelVarType.FIXED_SMALL)
    assert_close(got, want)
