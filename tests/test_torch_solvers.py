"""The port's solver registry and programs against the JAX package's, on
the CPU.

Each registered solver's per-step tables (float32 ops on the float32
alpha_bar grid, as JAX builds them) on respaced linear, cosine and
sigmoid grids, down to one and two steps, and one whole program run: the
same x0 predictions and noise handed to both programs' ``step`` over every
step. The bar is relative MSE < 1e-9 in fp32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion import solvers as jax_solvers
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion import solvers

torch.set_num_threads(1)

NAMES = ["dpm++", "dpmpp", "sde-dpm++", "sde-dpmpp", "ancestral", "unipc"]
GRIDS = {
    "linear-1000-10": ("LinearSchedule", 1000, 10, "uniform-lambda"),
    "linear-1000-50-t": ("LinearSchedule", 1000, 50, "uniform-t"),
    "cosine-100-7": ("CosineBetaSchedule", 100, 7, "karras"),
    "sigmoid-100-8": ("SigmoidSchedule", 100, 8, "trailing"),
    "linear-100-2": ("LinearSchedule", 100, 2, "uniform-lambda"),
    "linear-100-1": ("LinearSchedule", 100, 1, "uniform-t"),
}


def grid(case):
    name, T, n, spacing = GRIDS[case]
    return (tg.respace(tg.coefficients_from_schedule(getattr(schedule, name)(T)), n, spacing),
            jg.respace(jg.coefficients_from_schedule(getattr(jax_schedule, name)(T)), n, spacing))


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-30))


def test_registry_matches_jax():
    assert solvers.solver_names() == jax_solvers.solver_names()
    for name in NAMES + ["ddim", "ddpm", "euler"]:
        assert solvers.is_solver(name) == jax_solvers.is_solver(name), name

    @solvers.register_solver("test-identity", "test-id")
    def _identity(abar):
        return solvers.SolverProgram(
            steps=[{"i": i} for i in range(abar.shape[0] - 1, -1, -1)],
            init_mem=lambda x: None, step=lambda x, x0, s, mem, noise: (x0, mem))

    try:
        assert solvers.is_solver("test-identity") and solvers.is_solver("test-id")
        prog = solvers.build_solver("test-id", torch.tensor([0.9, 0.5]))
        assert [s["i"] for s in prog.steps] == [1, 0] and not prog.stochastic
    finally:
        for n in ("test-identity", "test-id"):
            solvers._SOLVERS.pop(n)


@pytest.mark.parametrize("case", sorted(GRIDS))
@pytest.mark.parametrize("name", NAMES)
def test_solver_tables_match(name, case):
    c_t, c_j = grid(case)
    got = solvers.build_solver(name, c_t.alphas_cumprod)
    want = jax_solvers.build_solver(name, c_j.alphas_cumprod)
    assert got.stochastic == want.stochastic
    assert [s["i"] for s in got.steps] == np.asarray(want.xs["i"]).tolist()
    assert set(got.steps[0]) == set(want.xs)
    # unipc's corrector coefficients are differences of nearly equal float32
    # terms at small log-SNR steps (b2 = 2 (k1/hh - 1/2) / h phi_1, with
    # k1/hh -> 1/2 - h/6): one ulp of torch's log against XLA's moves them
    # by ~ulp/h^2 (JAX's own c_rho1 there jitters by 1e-3 from one step to
    # the next). On the 50-step uniform-t grid (h down to ~0.02) this case
    # states its bar: relative MSE < 1e-6, elementwise 3e-3
    fine = name == "unipc" and case == "linear-1000-50-t"
    bar, rtol = (1e-6, 3e-3) if fine else (1e-9, 1e-4)
    for key in want.xs:
        g = np.array([s[key] for s in got.steps], np.float64)
        w = np.asarray(want.xs[key], np.float64)
        assert np.isfinite(g).all() and rel_mse(g, w) < bar, key
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", ["linear-1000-10", "cosine-100-7", "linear-100-2"])
@pytest.mark.parametrize("name", ["dpm++", "sde-dpm++", "ancestral", "unipc"])
def test_solver_program_run_matches(name, case):
    """Every step of the program from the same x0 predictions and noise:
    the multistep memories and the final sample."""
    c_t, c_j = grid(case)
    got = solvers.build_solver(name, c_t.alphas_cumprod)
    want = jax_solvers.build_solver(name, c_j.alphas_cumprod)
    M = c_t.num_timesteps
    rng = np.random.default_rng(3)
    shape = (2, 3, 4, 1)
    x_T = rng.normal(size=shape).astype(np.float32)
    x0s = np.clip(rng.normal(size=(M, *shape)), -1, 1).astype(np.float32)
    noise = rng.normal(size=(M, *shape)).astype(np.float32)
    x_t, mem_t = torch.from_numpy(x_T), got.init_mem(torch.from_numpy(x_T))
    x_j, mem_j = jnp.asarray(x_T), want.init_mem(jnp.asarray(x_T))
    for n in range(M):
        z_t = torch.from_numpy(noise[n]) if got.stochastic else None
        x_t, mem_t = got.step(x_t, torch.from_numpy(x0s[n]), got.steps[n], mem_t, z_t)
        s_j = {k: v[n] for k, v in want.xs.items()}
        x_j, mem_j = want.step(x_j, jnp.asarray(x0s[n]), s_j, mem_j, jnp.asarray(noise[n]))
        assert rel_mse(x_t.numpy(), x_j) < 1e-9, n
    for g, w in zip(torch.utils._pytree.tree_leaves(mem_t),
                    [np.asarray(v) for v in __import__("jax").tree_util.tree_leaves(mem_j)]):
        assert rel_mse(g.numpy(), w) < 1e-9
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-5)
    # the last transition lands on the x0 prediction for the solvers whose
    # final step is first order onto clean data
    if name in ("dpm++", "sde-dpm++"):
        np.testing.assert_allclose(x_t.numpy(), x0s[-1], atol=1e-6)
