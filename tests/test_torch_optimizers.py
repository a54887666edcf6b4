"""The port's ten optax optimizers against optax itself, on the CPU.

Adamax, NAdam, RAdam, RMSprop, Adagrad, Adadelta, Adafactor, Lion, LAMB and
LARS, each built by its registry name with the JAX package's
``build_optimizer`` (optax 0.2.6) and the port's, over the same parameters
(a 128x256 matrix, which Adafactor factors, a 3x3x3x64x64 conv kernel and a
bias vector, made with numpy from a seed), the same five gradients and one
LR schedule (``CosineAnnealingLR`` over 10 updates, built by each
package's ``build_lr_schedule``; Adafactor also without a learning rate, its
JAX default). The bar: each parameter's relative L2 distance from optax's
after five steps at most 1e-5, where the steps moved the parameters by at
least 1e-3 relative (so a wrong update of 1 % of its size would miss it).
Each base learning rate is chosen to move them so: LARS's trust ratio
scales its step by 1e-3, so it takes lr 1.

Then the optimizers' own state: a ``state_dict`` round trip through
``torch.save`` (``weights_only``, as the port's checkpoints load), a run
resumed from it equal bitwise to an uninterrupted one, and a training run on
a tiny UNet checkpointed by the port's CheckpointManager and resumed.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rho_diffusion_tpu.training.optimizers import build_lr_schedule as jax_build_lr_schedule
from rho_diffusion_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.schedule import LinearSchedule
from rho_diffusion_tpu_torch.registry import registry
from rho_diffusion_tpu_torch.training.checkpoint import CheckpointManager
from rho_diffusion_tpu_torch.training.optimizers import build_lr_schedule, build_optimizer

torch.set_num_threads(1)

SHAPES = {"w": (128, 256), "k": (3, 3, 3, 64, 64), "b": (64,)}
STEPS = 5
BAR = 1e-5
MOVED = 1e-3
LR = {"Adamax": 1e-3, "NAdam": 1e-3, "RAdam": 1e-3, "RMSprop": 1e-3, "Adagrad": 1e-2,
      "Adadelta": 1.0, "Adafactor": 1e-2, "Lion": 1e-3, "LAMB": 1e-3, "LARS": 1.0}
SCHEDULE = ("CosineAnnealingLR", {"T_max": 5})
STEPS_PER_EPOCH = 2
CASES = sorted(LR) + ["Adafactor-no-lr"]


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def optimizers(case):
    """(the optax transformation, the port's Optimizer) for a case."""
    name = case.split("-")[0]
    if case.endswith("no-lr"):
        return jax_build_optimizer(name, {}), build_optimizer(name, {})
    kwargs = {"lr": LR[name]}
    sched, sched_kw = SCHEDULE
    return (jax_build_optimizer(name, dict(kwargs), learning_rate=jax_build_lr_schedule(
                sched, LR[name], STEPS_PER_EPOCH, sched_kw)),
            build_optimizer(name, dict(kwargs), learning_rate=build_lr_schedule(
                sched, LR[name], STEPS_PER_EPOCH, sched_kw)))


def run_optax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
    return {k: np.asarray(v) for k, v in p.items()}


def port_params(params):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}


def run_port(opt, tparams, grads, torch_opt=None, start=0):
    torch_opt = torch_opt or opt.make(list(tparams.values()))
    for i, g in enumerate(grads, start):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.set_lr(torch_opt, i)
        torch_opt.step()
    return torch_opt


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_every_jax_optimizer_name_is_registered():
    import rho_diffusion_tpu.training.optimizers  # noqa: F401  (fills the JAX registry)
    from rho_diffusion_tpu.registry import registry as jax_registry

    names = set(jax_registry.mapping["optimizers"])
    assert names == set(registry.mapping["optimizers"]) == set(LR) | {"AdamW", "Adam", "SGD"}
    for name in LR:
        assert build_optimizer(name, {}).cls.__module__.endswith("training.optimizers"), name


@pytest.mark.parametrize("case", CASES)
def test_optimizer_matches_optax(case):
    params, grads = inputs()
    tx, opt = optimizers(case)
    want = run_optax(tx, params, grads)
    tparams = port_params(params)
    run_port(opt, tparams, grads)
    for k in SHAPES:
        assert rel_l2(want[k], params[k]) >= MOVED, (k, "the steps barely moved it")
        assert rel_l2(tparams[k].detach().numpy(), want[k]) <= BAR, k


def test_adafactor_factors_the_matrix_only():
    params, grads = inputs()
    _, opt = optimizers("Adafactor")
    tparams = port_params(params)
    torch_opt = run_port(opt, tparams, grads[:1])
    state = {k: torch_opt.state[p] for k, p in tparams.items()}
    # optax: v_row drops the largest dimension (256), v_col the second-largest (128)
    assert state["w"]["v_row"].shape == (128,) and state["w"]["v_col"].shape == (256,)
    assert "v" not in state["w"]
    # the conv kernel's second-largest dimension (64) is below 128: full moments
    assert state["k"]["v"].shape == SHAPES["k"] and state["b"]["v"].shape == SHAPES["b"]


@pytest.mark.parametrize("case", CASES)
def test_state_dict_round_trip_resumes_exactly(case):
    params, grads = inputs(1)
    _, opt = optimizers(case)
    whole = port_params(params)
    run_port(opt, whole, grads)

    first = port_params(params)
    torch_opt = run_port(opt, first, grads[:2])
    buf = io.BytesIO()
    torch.save({"opt": torch_opt.state_dict(),
                "params": {k: p.detach().clone() for k, p in first.items()}}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    resumed = {k: torch.nn.Parameter(v) for k, v in saved["params"].items()}
    fresh = opt.make(list(resumed.values()))
    fresh.load_state_dict(saved["opt"])
    assert fresh.state_dict()["param_groups"] == torch_opt.state_dict()["param_groups"]
    run_port(opt, resumed, grads[2:], torch_opt=fresh, start=2)
    for k in SHAPES:
        assert torch.equal(resumed[k], whole[k]), k


def tiny_pipeline(name):
    kw = dict(data_shape=(8, 8), dims=2, in_channels=1, out_channels=1, model_channels=8,
              num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=[], num_heads=1)
    return DDPM("UNetv2", kw, LinearSchedule(50), optimizer=name, opt_kwargs={"lr": 1e-3},
                ema_decay=0.9, device="cpu", seed=0)


@pytest.mark.parametrize("name", sorted(LR))
def test_training_checkpoint_resumes_exactly(tmp_path, name):
    """Three steps straight against two, a checkpoint, a fresh state
    restored from it and the third step: bitwise the same weights, EMA and
    optimizer state."""
    rng = np.random.default_rng(3)
    batches = [{"data": torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32))}
               for _ in range(3)]
    pipe = tiny_pipeline(name)  # each pipeline holds its own backbone, seeded alike
    straight = pipe.create_state(seed=5)
    for b in batches:
        pipe.training_step(straight, b)

    first = tiny_pipeline(name)
    state = first.create_state(seed=5)
    for b in batches[:2]:
        first.training_step(state, b)
    manager = CheckpointManager(tmp_path / "ckpt")
    manager.save(state)
    again = tiny_pipeline(name)
    restored = again.create_state(seed=99)
    manager.restore(restored)
    again.training_step(restored, batches[2])
    assert restored.step == straight.step == 3
    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              restored.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in straight.ema:
        assert torch.equal(straight.ema[k], restored.ema[k]), k
